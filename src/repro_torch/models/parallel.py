"""Tensor parallelism's and FSDP's collectives inside the model, made
explicit.

This module has no counterpart in the JAX package, as
``launch/mesh.shard_map_compat`` has none here: under GSPMD, XLA inserts
these collectives itself wherever a sharded param meets a replicated
activation.  The port runs one process per block of the params
(``launch/sharding.shard_params``), so the model's tensor-parallel layers
(``layers.apply_mlp``, ``layers.chunked_cross_entropy``,
``transformer.embed_tokens`` / ``attn_sublayer``, ``moe.apply_moe_ep``)
call them by hand, Megatron's way:

  * ``copy_to_model`` -- identity forward, all-reduce backward: where a
    replicated tensor (an activation, or a whole param) enters a
    computation that differs per process, each process's gradient is a
    part, and the parts sum to the gradient;
  * ``reduce_from_model`` -- all-reduce forward, identity backward: where
    the processes' partial sums become one replicated tensor;
  * ``gather_from_model`` -- all-gather along a dim forward, this
    process's block of the gradient backward: a split param used whole in
    a replicated computation (a split that does not fall on head
    boundaries).

Every collective goes through the ``model`` axis of the mesh
(``launch/mesh.DPAxes``), so ``COMM`` counts it under ``<kind>@model``.
The axis is set for the length of a step's forward and backward by
``use(axes)`` (``train/step.py``); ``model_axes()`` is None outside it or
with a ``model`` extent of 1, and the layers then run as on one process.

FSDP over ``data`` (``use(axes, data=DataShards(...))``: the standard
step at a ``data`` extent above 1) holds each leaf the rules put on
``data`` as this process's block of it:

  * ``gather_from_data`` -- all-gather along a dim forward, reduce-scatter
    of the summed gradient backward (the reference's "bwd: reduce-scatter",
    ``src/repro/models/moe.py:167``): the block used whole, its gradient
    this process's block of the sum over ``data``;
  * ``gather_layer`` / ``gather_leaf`` -- every split leaf of one layer's
    params (``transformer.forward_hidden`` calls it inside the block's
    recomputed region, so a layer's whole weights live only while it
    runs, and the recomputation gathers them again), or one named leaf
    (``embed``, ``lm_head``), gathered so; the identity without FSDP.

These count under ``<kind>@data``.
"""
from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple

import torch

# the ``model`` axis and the FSDP shards of the running step (``use``).
# Module-wide, not per thread: on the card the autograd engine runs
# backward (and the blocks' recomputation in it) on its own device
# thread, which must see what the step set.
_ACTIVE = [None]
_DATA = [None]


class DataShards(NamedTuple):
    """FSDP of a step: the ``data`` axis (a ``DPAxes``) and, per leaf path
    of the params tree (``lowrank.flatten_with_path``'s), the dim of it
    split over that axis, counted from the end (a stacked block leaf's
    dim is the same in each layer's view)."""

    axes: object
    dims: Dict[str, int]


@contextlib.contextmanager
def use(axes, data=None):
    """Run the model under ``axes`` (a ``DPAxes`` over ``model``; None: no
    tensor parallelism) and ``data`` (``DataShards``; None: no FSDP).  The
    layers' autograd functions keep the axes they were called with, so a
    backward run inside the block (block recomputation included) reduces
    over the same group."""
    prev = _ACTIVE[0], _DATA[0]
    _ACTIVE[0], _DATA[0] = axes, data
    try:
        yield
    finally:
        _ACTIVE[0], _DATA[0] = prev


def active_axes():
    """The axes ``use`` set (None outside it), whatever their extent."""
    return _ACTIVE[0]


def model_axes():
    """The ``model`` axis of the running step when its extent is above 1,
    else None."""
    ax = _ACTIVE[0]
    return ax if ax is not None and ax.size > 1 else None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axes.all_reduce_(g.contiguous().clone()), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        return axes.all_reduce_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, dim):
        ctx.axes, ctx.dim, ctx.n = axes, dim, x.shape[dim]
        return axes.all_gather(x, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.axes.index * ctx.n, ctx.n).contiguous(), None, None


class _GatherData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, dim):
        ctx.axes, ctx.dim = axes, dim
        return axes.all_gather(x, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.axes.reduce_scatter(g, dim=ctx.dim), None, None


def gather_from_data(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """``x`` (this process's block along ``dim``) gathered over ``axes``;
    backward, this process's block of the gradient summed over them."""
    return x if axes is None or axes.size == 1 else _GatherData.apply(x, axes, dim % x.dim())


def gather_leaf(x: torch.Tensor, path: str) -> torch.Tensor:
    """The leaf at ``path`` (``"['embed']"``) whole over ``data`` when the
    running step holds a block of it, else ``x``."""
    shards = _DATA[0]
    if shards is None or path not in shards.dims:
        return x
    return gather_from_data(x, shards.axes, shards.dims[path])


def gather_layer(p: Dict, prefix: str = "['blocks']") -> Dict:
    """One layer's params (a view of the stacked block leaves under
    ``prefix``) with every leaf the running step splits over ``data``
    gathered whole; ``p`` itself without FSDP."""
    if _DATA[0] is None:
        return p
    return {k: gather_layer(v, f"{prefix}[{k!r}]") if isinstance(v, dict)
            else gather_leaf(v, f"{prefix}[{k!r}]") for k, v in p.items()}


def copy_to_model(x: torch.Tensor, axes) -> torch.Tensor:
    return x if axes is None else _Copy.apply(x, axes)


def reduce_from_model(x: torch.Tensor, axes) -> torch.Tensor:
    return x if axes is None else _Reduce.apply(x, axes)


def gather_from_model(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    return x if axes is None else _Gather.apply(x, axes, dim % x.dim())


def max_over_model(x: torch.Tensor, axes) -> torch.Tensor:
    """The elementwise largest over the processes, without a gradient (a
    softmax's shift)."""
    x = x.detach().contiguous().clone()
    return x if axes is None else axes.all_reduce_(x, op="max")


def splits_over_model(n: int, tp: int) -> bool:
    """Whether ``launch/sharding``'s guard splits a dim of ``n`` over a
    ``model`` extent of ``tp`` (the shape counts' test of a leaf)."""
    from repro_torch.launch.sharding import MIN_SHARD_EXTENT

    return n % tp == 0 and n // tp >= MIN_SHARD_EXTENT
