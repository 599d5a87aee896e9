"""Where each process's share of the batch and of the ZeRO state lies,
from the data-parallel part of ``src/repro/launch/sharding.py``.

The reference states placements as ``PartitionSpec``s for XLA; here each
process holds its own tensors, so the same rules are row ranges:

  * ``batch_rows`` / ``shard_batch`` -- ``batch_spec``: dim 0 of the global
    batch splits evenly over the batch axes (pod, data) when it divides;
    otherwise every process takes the whole batch (the reference's
    replicated spec).  0-dim entries (the fault plan's ``grad_scale``) are
    every process's.
  * ``zero_state_rows`` -- ``zero_state_specs`` / ``zero_tree_shardings``:
    every bucket stack of a ZeRO state (padded to a multiple of the shard
    count at init) splits its dim 0 over the DP axes; everything else is
    replicated (``train/step.shard_train_state`` keeps those rows).

The name-based tensor-parallel rules (``param_spec``, ``tree_shardings``)
and ``cache_spec`` wait for tensor parallelism (ROADMAP queue 1 item 11,
second half).
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.launch.mesh import axes_size, batch_axes


def batch_rows(n: int, mesh) -> Tuple[int, int]:
    """(start, stop) of this process's rows of a global batch of ``n``."""
    axes = batch_axes(mesh)
    total = axes_size(mesh, axes)
    if not axes or n % total or n < total:
        return 0, n
    per = n // total
    idx = mesh.axes(axes).index
    return idx * per, (idx + 1) * per


def shard_batch(batch, mesh):
    """This process's rows of every entry of a global batch dict."""
    out = {}
    for k, v in batch.items():
        if torch.is_tensor(v) and v.dim() > 0:
            lo, hi = batch_rows(v.shape[0], mesh)
            out[k] = v[lo:hi]
        else:
            out[k] = v
    return out


def zero_state_rows(state, axes) -> List[Tuple[int, int]]:
    """(start, stop) of this process's rows of each padded bucket stack of
    a ZeRO ``TrainState`` (its stacks padded to a multiple of the axes'
    extent at init): ``zero_state_specs``' split of dim 0 over the axes."""
    out = []
    for bst in state.opt_state.buckets:
        rows = bst.projector.shape[0]
        if rows % axes.size:
            raise ValueError(f"a bucket stack of {rows} rows does not split over "
                             f"{axes.size} shards")
        per = rows // axes.size
        out.append((axes.index * per, (axes.index + 1) * per))
    return out
