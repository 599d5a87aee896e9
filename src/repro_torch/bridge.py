"""Carry weights and optimizer state between the JAX package and the
port, through numpy.

Both packages keep one parameter layout: nested dicts with the same leaf
names and shapes, including the scan-stacked ``(L, ...)`` block leaves.
So a JAX tree turned into numpy (``jax.tree.map(np.asarray, params)``),
or the ``.npy`` leaves of a JAX checkpoint, map name for name onto the
port's params, and back.  ``opt_state_from_numpy`` and
``opt_state_to_numpy`` do the same for the low-rank optimizer's state.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.core import buckets as buckets_lib
from repro_torch.core import inner as inner_lib
from repro_torch.core import lowrank as lowrank_lib
from repro_torch.device import DeviceLike, resolve_device

Tree = Dict[str, Any]


def params_from_numpy(tree: Tree, device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Nested dict of numpy arrays -> the same dict of tensors on ``device``,
    dtypes kept (bit-exact)."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        a = np.array(x, copy=True)
        if a.dtype.name == "bfloat16":  # numpy has no bf16: carry the bits
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
        return torch.from_numpy(a).to(dev)

    return conv(tree)


def params_to_numpy(params: Dict[str, Any]) -> Tree:
    """Nested dict of tensors -> the same dict of numpy arrays, bit-exact
    except that bf16 leaves widen (exactly) to f32: numpy has no bf16."""

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()

    return conv(params)


def _inner_from(name: str, jinner, t):
    """A per-leaf inner state of the port from one with the same field
    names (a JAX state read out as numpy, or ``opt_state_to_numpy``'s).
    An inner with no fused layout (Adafactor) is carried field for field."""
    if name == "adafactor":
        return inner_lib.AdafactorState(*(t(getattr(jinner, f))
                                          for f in inner_lib.AdafactorState._fields))
    fm = inner_lib.fused_moments(name, jinner)
    return inner_lib.fused_state(name, *(None if x is None else t(x) for x in fm))


def opt_state_from_numpy(
    optimizer: "lowrank_lib.LowRankOptimizer", state: Any, device: DeviceLike = "cuda"
) -> "lowrank_lib.LowRankOptState":
    """A JAX ``LowRankOptState`` read out as numpy
    (``jax.tree_util.tree_map(np.asarray, state)``), or the port's own from
    ``opt_state_to_numpy`` -> the port's state for ``optimizer`` (built on
    the same params and config), bit for bit.

    Carried: ``step``; every per-leaf ``LeafState`` that holds data (the
    inner state of full-rank leaves, and projector and inner state of
    low-rank leaves on the reference engine); each bucket's stacked
    ``BucketState``.  Inner states keep their dtypes: f32 moments,
    adam_mini's per-row v, adam8bit's uint8 codes and f32 scales.  The JAX
    state's ``key`` does not drive the port's draws (the port draws with
    torch): the new state gets a fresh ``TorchDraws`` from the config's
    seed, which a caller may replace.  A checkpoint carries the draw
    source by one rule instead (``TorchDraws.key`` / ``from_key``, ROADMAP
    queue 3)."""
    dev = resolve_device(device)
    cfg = optimizer.config

    def t(x):
        return torch.from_numpy(np.array(x, copy=True)).to(dev)

    # JAX's per-leaf states sit in a dict tree (a sorted-key walk puts them
    # in flat order); opt_state_to_numpy's are a flat list already
    jax_leaves: List[Any] = (list(state.leaves) if isinstance(state.leaves, list)
                             else lowrank_lib.tree_leaves(state.leaves))
    if len(jax_leaves) != len(optimizer.specs):
        raise ValueError(
            f"state has {len(jax_leaves)} leaves, the optimizer {len(optimizer.specs)}"
        )
    bucketed = optimizer.state_layout.plan.bucketed if optimizer.state_layout else ()
    leaves = []
    for i, jl in enumerate(jax_leaves):
        if i in bucketed:
            leaves.append(lowrank_lib.LeafState(
                projector=torch.zeros((), dtype=torch.float32, device=dev), inner=None))
            continue
        leaves.append(lowrank_lib.LeafState(
            projector=t(jl.projector), inner=_inner_from(cfg.inner, jl.inner, t)))
    bucket_states = tuple(
        buckets_lib.BucketState(*(None if x is None else t(x) for x in b))
        for b in state.buckets
    )
    if optimizer.state_layout is not None and len(bucket_states) != len(
        optimizer.state_layout.plan.buckets
    ):
        raise ValueError("the state's buckets do not match the optimizer's plan")
    return lowrank_lib.LowRankOptState(
        step=int(np.asarray(state.step)),
        draws=lowrank_lib.TorchDraws(cfg.seed, dev),
        leaves=leaves,
        buckets=bucket_states,
    )


def opt_state_to_numpy(state: "lowrank_lib.LowRankOptState") -> "lowrank_lib.LowRankOptState":
    """The inverse of ``opt_state_from_numpy``: the port's state with every
    tensor as a numpy array, dtypes kept (uint8 codes included); per-leaf
    states stay a flat list, the draw source is dropped (None)."""

    def n(x):
        return None if x is None else x.detach().cpu().numpy()

    leaves = [
        lowrank_lib.LeafState(
            projector=n(leaf.projector),
            inner=None if leaf.inner is None else type(leaf.inner)(*map(n, leaf.inner)),
        )
        for leaf in state.leaves
    ]
    buckets = tuple(buckets_lib.BucketState(*map(n, b)) for b in state.buckets)
    return lowrank_lib.LowRankOptState(step=state.step, draws=None, leaves=leaves,
                                       buckets=buckets)
