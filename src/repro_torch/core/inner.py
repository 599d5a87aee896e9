"""Inner stateful optimizers that run inside the low-rank subspace, from
``src/repro/core/inner.py``: ``(init, update)`` pairs on one tensor (the
projected gradient R of a low-rank leaf, or the raw gradient of a
full-rank leaf).  ``update`` returns an ascent direction; the wrapper
applies sign, learning rate and the GaLore ``alpha``.  ``step`` is
1-indexed (the first update sees step=1) for bias correction.

Adam, momentum SGD, Adam-mini and 8-bit Adam each have a fused update on
the bucketed engine (kernels/lowrank_update).  Adafactor has none, in
either package: its factored state stays per leaf, and the bucketed
engine runs it on the per-leaf loop.

Under tensor parallelism and FSDP the per-leaf loop hands each inner this
process's block of its tensor and a ``Cut`` (``init(x, cut)``,
``update(g, state, step, cut)``): the axes that cut its dims and its
global shape.  Adam and MSGD are elementwise and ignore it.  Every
reduction the others make over a cut dim sums the local partial sums over
the cutting axes and divides by the global count: Adam-mini's row means,
Adafactor's row and column statistics, the mean of its row statistic and
the RMS of its update; 8-bit Adam's chunks keep the whole row's
(``kernels/lowrank_update/quantize.py``: ``offset``, ``straddle_max``).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.lowrank_update import quantize as qz
from repro_torch.kernels.lowrank_update.ref import bias_corrections


class Cut(NamedTuple):
    """How processes cut the tensor an inner gets: (dim, axes) of each axis
    that cuts a dim (``launch/mesh.DPAxes``; dims non-negative) and the
    tensor's global shape."""

    dims: Tuple[Tuple[int, Any], ...]
    shape: Tuple[int, ...]

    def axis(self, dim: int):
        """The axes that cut ``dim`` (negative counts from the end), or None."""
        dim %= len(self.shape)
        return next((ax for d, ax in self.dims if d == dim), None)

    def start(self, dim: int) -> int:
        """The global index of this process's first element along ``dim``."""
        ax = self.axis(dim)
        return 0 if ax is None else ax.index * (self.shape[dim] // ax.size)


def _cut_of(cut: Optional[Cut], dim: int):
    return None if cut is None else cut.axis(dim)


def _mean(x: torch.Tensor, dim: int, cut: Optional[Cut]) -> torch.Tensor:
    """This process's block of the mean over ``dim`` of the global tensor
    whose block ``x`` is: its partial sums summed over the axes that cut
    ``dim``, over the global count."""
    ax = _cut_of(cut, dim)
    if ax is None:
        return torch.mean(x, dim=dim)
    return ax.all_reduce_(torch.sum(x, dim=dim)) / cut.shape[dim]


def _mean_all(x: torch.Tensor, cut: Optional[Cut]) -> torch.Tensor:
    """The mean of every element of the global tensor ``x``."""
    if cut is None or not cut.dims:
        return torch.mean(x)
    total = torch.sum(x).reshape(1)
    for _, ax in cut.dims:
        ax.all_reduce_(total)
    return total[0] / float(np.prod(cut.shape))


def _qcut(cut: Optional[Cut]):
    """(offset, reduce) of the 8-bit chunks of a tensor whose last dim may
    be cut (``quantize.py``)."""
    ax = _cut_of(cut, -1)
    if ax is None:
        return 0, None
    start, n_total = cut.start(-1), cut.shape[-1]
    return start % qz.QBLOCK, lambda am: qz.straddle_max(am, start, n_total, ax)


class InnerOptimizer(NamedTuple):
    name: str
    # init(x, cut=None), update(g, state, step, cut=None): ``Cut`` above
    init: Callable[..., Any]
    update: Callable[..., Tuple[torch.Tensor, Any]]
    # Whether the bucketed engine has a fused update for this inner
    # (kernels/lowrank_update).
    fused_eligible: bool = False


class AdamState(NamedTuple):
    m: torch.Tensor
    v: torch.Tensor


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> InnerOptimizer:
    def init(x, cut=None):
        return AdamState(
            m=torch.zeros(x.shape, dtype=torch.float32, device=x.device),
            v=torch.zeros(x.shape, dtype=torch.float32, device=x.device),
        )

    def update(g, state, step, cut=None):
        g = g.float()
        m = b1 * state.m + (1.0 - b1) * g
        v = b2 * state.v + (1.0 - b2) * g * g
        bc1, bc2 = bias_corrections(b1, b2, step)
        direction = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        return direction, AdamState(m=m, v=v)

    return InnerOptimizer("adam", init, update, fused_eligible=True)


class MSGDState(NamedTuple):
    m: torch.Tensor


def msgd(b1: float = 0.9) -> InnerOptimizer:
    """M_t = (1-b1) M_{t-1} + b1 G_t  (the paper/GoLore's convention)."""

    def init(x, cut=None):
        return MSGDState(m=torch.zeros(x.shape, dtype=torch.float32, device=x.device))

    def update(g, state, step, cut=None):
        del step
        m = (1.0 - b1) * state.m + b1 * g.float()
        return m, MSGDState(m=m)

    return InnerOptimizer("msgd", init, update, fused_eligible=True)


class AdafactorState(NamedTuple):
    m: torch.Tensor  # first moment (the paper runs Adafactor with b1 = 0.9)
    vr: torch.Tensor  # row statistic (..., rows) of a 2-D+ leaf, else (1,)
    vc: torch.Tensor  # column statistic (..., cols), else (1,)
    v: torch.Tensor  # unfactored second moment of a 0/1-D leaf, else (1,)


# ATen's f32 pow takes its vector path for 32 elements and more (two AVX512
# registers a loop iteration) and a scalar tail below that: the vector path
# equals XLA's on steps 1..200000, the tail is 1 ulp off on 50 of 20000.
_POW_LANES = 32


def adafactor_beta2(step: int, decay_pow: float = 0.8) -> float:
    """Adafactor's beta2(t) = 1 - t^-decay_pow in f32, as the JAX package
    computes it from the step (``inner.py:134-135``), on the host: a Python
    float64 power would differ from it by ulps."""
    t = torch.full((_POW_LANES,), float(step), dtype=torch.float32)
    return float((1.0 - t ** (-decay_pow))[0])


def adafactor(
    b1: float = 0.9,
    decay_pow: float = 0.8,
    eps1: float = 1e-30,
    clip_threshold: float = 1.0,
) -> InnerOptimizer:
    """Shazeer-Stern Adafactor with beta2(t) = 1 - t^-decay_pow: factored
    row and column second moments over the last two axes (an unfactored one
    below 2-D), the update clipped by its RMS over the whole leaf, then a
    first moment.  The ``1e-38`` guards are f32 subnormals, kept as such
    (PyTorch flushes none on the CPU or the card)."""

    def init(x, cut=None):
        def z(shape):
            return torch.zeros(tuple(shape), dtype=torch.float32, device=x.device)

        if x.dim() >= 2:
            vr, vc, v = z(x.shape[:-1]), z(x.shape[:-2] + x.shape[-1:]), z((1,))
        else:
            vr, vc, v = z((1,)), z((1,)), z(x.shape)
        return AdafactorState(m=z(x.shape), vr=vr, vc=vc, v=v)

    def update(g, state, step, cut=None):
        g = g.float()
        b2t = adafactor_beta2(step, decay_pow)
        c2t = float(np.float32(1.0) - np.float32(b2t))  # 1 - b2t in f32
        g2 = g * g + eps1
        if g.dim() >= 2:
            vr = b2t * state.vr + c2t * _mean(g2, -1, cut)
            vc = b2t * state.vc + c2t * _mean(g2, -2, cut)
            # V-hat = outer(vr, vc) / mean(vr): the rank-1 reconstruction;
            # vr runs along g's rows, so the axes that cut those cut it
            vr_cut = None if cut is None else Cut(
                tuple((len(cut.shape) - 2, ax) for ax in (cut.axis(-2),) if ax is not None),
                tuple(cut.shape[:-1]))
            denom = _mean(vr, -1, vr_cut)[..., None]
            vhat = vr[..., :, None] * vc[..., None, :] / (denom[..., None] + 1e-38)
            u = g / (torch.sqrt(vhat) + 1e-38)
            v = state.v
        else:
            v = b2t * state.v + c2t * g2
            u = g / (torch.sqrt(v) + 1e-38)
            vr, vc = state.vr, state.vc
        # update clipping by RMS (Shazeer-Stern eq. 5), one scalar per leaf
        rms = torch.sqrt(_mean_all(u * u, cut) + 1e-38)
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        m = b1 * state.m + (1.0 - b1) * u
        return m, AdafactorState(m=m, vr=vr, vc=vc, v=v)

    return InnerOptimizer("adafactor", init, update)


class AdamMiniState(NamedTuple):
    m: torch.Tensor
    v: torch.Tensor  # one f32 per row of the last axis (per tensor below 2-D)


def adam_mini(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8) -> InnerOptimizer:
    """Adam-mini: one second moment per row (the r basis rows of a projected
    gradient, the output rows of a full-rank 2-D leaf)."""

    def init(x, cut=None):
        v_shape = tuple(x.shape[:-1]) if x.dim() >= 2 else (1,)
        return AdamMiniState(
            m=torch.zeros(x.shape, dtype=torch.float32, device=x.device),
            v=torch.zeros(v_shape, dtype=torch.float32, device=x.device),
        )

    def update(g, state, step, cut=None):
        g = g.float()
        m = b1 * state.m + (1.0 - b1) * g
        if g.dim() >= 2:
            v = b2 * state.v + (1.0 - b2) * _mean(g * g, -1, cut)
            vb = v[..., None]
        else:
            v = b2 * state.v + (1.0 - b2) * torch.mean(g * g)
            vb = v
        bc1, bc2 = bias_corrections(b1, b2, step)
        direction = (m / bc1) / (torch.sqrt(vb / bc2) + eps)
        return direction, AdamMiniState(m=m, v=v)

    return InnerOptimizer("adam_mini", init, update, fused_eligible=True)


class Adam8bitState(NamedTuple):
    m_codes: torch.Tensor  # uint8 of the moment's shape
    m_scale: torch.Tensor  # f32, shape[:-1] + (ceil(last / 256),)
    v_codes: torch.Tensor
    v_scale: torch.Tensor


def adam8bit(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> InnerOptimizer:
    """Adam with blockwise 8-bit moments (kernels/lowrank_update/quantize.py)."""

    def init(x, cut=None):
        off, _ = _qcut(cut)
        z = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        mc, ms = qz.quantize_blockwise(z, signed=True, offset=off)
        vc, vs = qz.quantize_blockwise(z, signed=False, offset=off)
        return Adam8bitState(m_codes=mc, m_scale=ms, v_codes=vc, v_scale=vs)

    def update(g, state, step, cut=None):
        off, reduce = _qcut(cut)
        g = g.float()
        m = qz.dequantize_blockwise(state.m_codes, state.m_scale, True, off)
        v = qz.dequantize_blockwise(state.v_codes, state.v_scale, False, off)
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g * g
        bc1, bc2 = bias_corrections(b1, b2, step)
        direction = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        am = av = None
        if reduce is not None:
            am, av = reduce(qz.chunk_absmax(m, off)), reduce(qz.chunk_absmax(v, off))
        mc, ms = qz.quantize_blockwise(m, signed=True, offset=off, absmax=am)
        vc, vs = qz.quantize_blockwise(v, signed=False, offset=off, absmax=av)
        return direction, Adam8bitState(m_codes=mc, m_scale=ms, v_codes=vc, v_scale=vs)

    return InnerOptimizer("adam8bit", init, update, fused_eligible=True)


# ---------------------------------------------------------------------------
# Fused (bucket-native) state plumbing
# ---------------------------------------------------------------------------
#
# Which buffers each fused inner keeps in the bucket stacks, and how its
# per-leaf state is rebuilt from them.  ``FusedMoments`` is the four-buffer
# view: for adam8bit ``m``/``v`` hold the codes and ``m_scale``/``v_scale``
# the scales; the scales are None for the other inners.

_FUSED_SECOND_MOMENT = {"adam": True, "msgd": False, "adam_mini": True, "adam8bit": True}


class FusedMoments(NamedTuple):
    m: torch.Tensor
    v: Optional[torch.Tensor] = None
    m_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


def fused_has_second_moment(name: str) -> bool:
    if name not in _FUSED_SECOND_MOMENT:
        raise ValueError(f"{name!r} has no fused (bucket-native) state layout")
    return _FUSED_SECOND_MOMENT[name]


def fused_quantized(name: str) -> bool:
    """Whether the fused layout stores codes and scales instead of f32."""
    fused_has_second_moment(name)  # raises for an inner with no fused layout
    return name == "adam8bit"


def fused_state(name: str, m: torch.Tensor, v: Optional[torch.Tensor] = None,
                m_scale: Optional[torch.Tensor] = None,
                v_scale: Optional[torch.Tensor] = None):
    """Per-leaf inner state from canonical moment buffers."""
    if name == "adam":
        return AdamState(m=m, v=v)
    if name == "msgd":
        return MSGDState(m=m)
    if name == "adam_mini":
        return AdamMiniState(m=m, v=v)
    if name == "adam8bit":
        return Adam8bitState(m_codes=m, m_scale=m_scale, v_codes=v, v_scale=v_scale)
    raise ValueError(f"{name!r} has no fused (bucket-native) state layout")


def fused_moments(name: str, state) -> FusedMoments:
    """Canonical moment buffers of a per-leaf inner state (any object with
    the state's field names, a JAX state read out as numpy included)."""
    if name in ("adam", "adam_mini"):
        return FusedMoments(m=state.m, v=state.v)
    if name == "msgd":
        return FusedMoments(m=state.m)
    if name == "adam8bit":
        return FusedMoments(m=state.m_codes, v=state.v_codes,
                            m_scale=state.m_scale, v_scale=state.v_scale)
    raise ValueError(f"{name!r} has no fused (bucket-native) state layout")


_FACTORIES = {"adam": adam, "msgd": msgd, "adafactor": adafactor,
              "adam_mini": adam_mini, "adam8bit": adam8bit}


def make_inner(name: str, **kwargs: Any) -> InnerOptimizer:
    if name not in _FACTORIES:
        raise ValueError(f"unknown inner optimizer {name!r}; have {list(_FACTORIES)}")
    return _FACTORIES[name](**kwargs)
