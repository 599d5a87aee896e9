"""Tensor parallelism's collectives inside the model, made explicit.

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
"""
from __future__ import annotations

import contextlib

import torch

# the ``model`` axis of the running step (``use``).  Module-wide, not per
# thread: on the card the autograd engine runs backward (and the blocks'
# recomputation in it) on its own device thread, which must see the axis
# the step set.
_ACTIVE = [None]


@contextlib.contextmanager
def use(axes):
    """Run the model under ``axes`` (a ``DPAxes`` over ``model``; None: no
    tensor parallelism).  The layers' autograd functions keep the axes
    they were called with, so a backward run inside the block (block
    recomputation included) reduces over the same group."""
    prev = _ACTIVE[0]
    _ACTIVE[0] = axes
    try:
        yield
    finally:
        _ACTIVE[0] = prev


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

