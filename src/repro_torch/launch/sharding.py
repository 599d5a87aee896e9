"""Where each process's share of the params, the batch and the ZeRO state
lies, from ``src/repro/launch/sharding.py``.

The reference states placements as ``PartitionSpec``s for XLA; here each
process holds its own tensors, so the same rules are blocks and row
ranges:

  * ``param_spec`` -- the name-based rules (``_RULES``, ``RULE_OVERRIDES``,
    ``_guard``, the ``experts`` rule, the replicated ``router_w``), as a
    tuple of axis names or None per dim (the ``PartitionSpec``'s entries).
    ``tp_splits`` reads from it the dim each leaf splits over ``model``,
    ``param_splits`` the pair (``data`` dim, ``model`` dim) the standard
    step's FSDP cuts (``train/step.py``: every dense and MoE leaf the rules
    put on ``data``, gathered where it is used); ``shard_params`` cuts this
    process's blocks over both axes and ``gather_params`` joins them
    again.  The compressed steps keep params whole over ``data``, and
    ``pod`` splits nothing.

  * ``batch_rows`` / ``shard_batch`` -- ``batch_spec``: dim 0 of the global
    batch splits evenly over the batch axes (pod, data) when it divides;
    otherwise every process takes the whole batch (the reference's
    replicated spec).  0-dim entries (the fault plan's ``grad_scale``) are
    every process's.
  * ``zero_state_rows`` -- ``zero_state_specs`` / ``zero_tree_shardings``:
    every bucket stack of a ZeRO state (padded to a multiple of the shard
    count at init) splits its dim 0 over the DP axes; everything else is
    replicated (``train/step.shard_train_state`` keeps those rows).

``cache_spec`` waits: neither package's serving launcher takes a mesh.
``tree_shardings`` has no counterpart: there is no SPMD partitioner to
hand placements to.
"""
from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core.lowrank import flatten_with_path, tree_leaves, tree_unflatten
from repro_torch.launch.mesh import axes_size, batch_axes

# (regex on path, (second_to_last_axis, last_axis)) in priority order.
_RULES: Tuple[Tuple[str, Tuple[Optional[str], Optional[str]]], ...] = (
    (r"embed", ("model", "data")),  # (vocab, d)
    (r"lm_head", ("data", "model")),  # (d, vocab)
    (r"(o_proj|down_proj|out_proj|cross_o_proj)", ("model", "data")),
    (
        r"(q_proj|k_proj|v_proj|gate_proj|up_proj|in_proj|cross_[qkv]_proj"
        r"|patch_in_proj)",
        ("data", "model"),
    ),
)

# Minimum per-shard extent: no dim is split below it (narrow leaves such as
# a few KV heads stay whole).
MIN_SHARD_EXTENT = 64

# Experiment overrides: {regex: (ax_m2, ax_m1)} checked before _RULES.
RULE_OVERRIDES: dict = {}

Spec = Tuple[Optional[str], ...]


def _guard(dim: int, axis: Optional[str], mesh) -> Optional[str]:
    if axis is None or axis not in mesh.axis_names:
        return None
    n = mesh.shape[axis]
    if dim % n != 0 or dim // n < MIN_SHARD_EXTENT:
        return None
    return axis


def param_spec(path: str, shape: Tuple[int, ...], mesh) -> Spec:
    """The reference's ``param_spec`` (``sharding.py:67-99``): per dim of a
    leaf of global ``shape``, the mesh axis it is split over, or None; ()
    for a replicated leaf.  ``mesh`` needs ``.shape`` (a dict) and
    ``.axis_names``."""
    if len(shape) < 2:
        return ()
    low = path.lower()
    for pat, axes in RULE_OVERRIDES.items():
        if re.search(pat, low):
            a2 = _guard(shape[-2], axes[0], mesh)
            a1 = _guard(shape[-1], axes[1], mesh)
            return tuple([None] * (len(shape) - 2) + [a2, a1])
    if "experts" in low and len(shape) >= 3:
        # (L, E, d, ff): experts over ``model``, the expert d_ff on ``data``;
        # E is a stack dim, so divisibility is the only guard
        def _div(dim, axis):
            n = mesh.shape.get(axis, 0)
            return axis if n and dim % n == 0 and dim >= n else None

        e_ax = _div(shape[-3], "model")
        if "down_proj" in low:
            ff_ax = _div(shape[-2], "data")
            return tuple([None] * (len(shape) - 3) + [e_ax, ff_ax, None])
        ff_ax = _div(shape[-1], "data")
        return tuple([None] * (len(shape) - 3) + [e_ax, None, ff_ax])
    if "router_w" in low:
        return ()  # replicated: every rank routes identically (EP dispatch)
    for pat, (ax_m2, ax_m1) in _RULES:
        if re.search(pat, low):
            a2 = _guard(shape[-2], ax_m2, mesh)
            a1 = _guard(shape[-1], ax_m1, mesh)
            return tuple([None] * (len(shape) - 2) + [a2, a1])
    return ()  # norms, biases, conv, ssm vectors: replicated


def model_dim(spec: Spec, ndim: int, axis: str = "model") -> Optional[int]:
    """The (non-negative) dim a spec splits over ``axis``, or None."""
    for i, a in enumerate(spec):
        if a == axis:
            return ndim - len(spec) + i
    return None


# Per leaf, the dims of its global shape split over ``data`` and over
# ``model`` (None: whole along that axis).
Splits = Tuple[Optional[int], Optional[int]]


def leaf_splits(path: str, shape: Tuple[int, ...], mesh, fsdp: bool = True) -> Splits:
    """(``data`` dim, ``model`` dim) of one leaf: each only where its
    axis has an extent above 1, the ``data`` one only with ``fsdp``."""
    spec = param_spec(path, shape, mesh)
    ddim = model_dim(spec, len(shape), "data") if fsdp and mesh.shape.get("data", 1) > 1 \
        else None
    mdim = model_dim(spec, len(shape)) if mesh.shape.get("model", 1) > 1 else None
    return ddim, mdim


def param_splits(tree, mesh, fsdp: bool = True) -> List[Splits]:
    """``leaf_splits`` of every leaf of a tree of global shapes, in flat
    order."""
    return [leaf_splits(path, tuple(leaf.shape), mesh, fsdp)
            for path, leaf in flatten_with_path(tree)]


def tp_splits(tree, mesh) -> List[Optional[int]]:
    """Per leaf of a tree of global shapes (tensors, or anything with a
    ``.shape``), in flat order: the dim split over ``model``, or None
    (every leaf None without a ``model`` extent above 1)."""
    tp = mesh.shape.get("model", 1) if mesh is not None else 1
    out = []
    for path, leaf in flatten_with_path(tree):
        shape = tuple(leaf.shape)
        out.append(model_dim(param_spec(path, shape, mesh), len(shape)) if tp > 1 else None)
    return out


def local_block(x: torch.Tensor, dim: Optional[int], index: int, size: int) -> torch.Tensor:
    """Block ``index`` of ``size`` along ``dim`` (x itself for None), in
    storage of its own."""
    if dim is None or size == 1:
        return x
    n = x.shape[dim] // size
    return x.narrow(dim, index * n, n).clone()


def _pair(split) -> Splits:
    """A ``tp_splits`` entry (the ``model`` dim) or a ``param_splits`` pair
    as a pair."""
    return split if isinstance(split, tuple) else (None, split)


def block_of(x: torch.Tensor, split, mesh) -> torch.Tensor:
    """This process's block of one global leaf: its ``data`` block along
    the first dim of ``split``, its ``model`` block along the second."""
    ddim, mdim = _pair(split)
    dax, max_ = mesh.data_axes(), mesh.model_axes()
    return local_block(local_block(x, ddim, dax.index, dax.size), mdim, max_.index, max_.size)


def shard_params(tree, mesh, splits: Optional[Sequence] = None):
    """This process's blocks of a tree of global params; ``splits`` are
    ``tp_splits`` (its ``model`` blocks, the default) or ``param_splits``
    (its blocks over both axes)."""
    splits = tp_splits(tree, mesh) if splits is None else splits
    return tree_unflatten(tree, [block_of(x, d, mesh) for x, d in zip(tree_leaves(tree), splits)])


def gather_leaf(x: torch.Tensor, split, mesh) -> torch.Tensor:
    """One global leaf from every process's block (``block_of``'s
    inverse): gathered over ``model``, then over ``data``."""
    ddim, mdim = _pair(split)
    if mdim is not None:
        x = mesh.model_axes().all_gather(x, dim=mdim)
    if ddim is not None:
        x = mesh.data_axes().all_gather(x, dim=ddim)
    return x


def gather_params(tree, mesh, splits: Sequence):
    """The global params from every process's blocks (``shard_params``'
    inverse; ``splits`` from the global shapes)."""
    return tree_unflatten(tree, [gather_leaf(x, split, mesh)
                                 for x, split in zip(tree_leaves(tree), splits)])


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
