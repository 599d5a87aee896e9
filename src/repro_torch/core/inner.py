"""Inner stateful optimizers that run inside the low-rank subspace, from
``src/repro/core/inner.py``: ``(init, update)`` pairs on one tensor (the
projected gradient R of a low-rank leaf, or the raw gradient of a
full-rank leaf).  ``update`` returns an ascent direction; the wrapper
applies sign, learning rate and the GaLore ``alpha``.  ``step`` is
1-indexed (the first update sees step=1) for bias correction.

Ported: Adam, momentum SGD, Adam-mini and 8-bit Adam, each with a fused
update on the bucketed engine (kernels/lowrank_update).  Adafactor comes
with a later slice (ROADMAP queue 1 item 7).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.lowrank_update.quantize import dequantize_blockwise, quantize_blockwise
from repro_torch.kernels.lowrank_update.ref import bias_corrections


class InnerOptimizer(NamedTuple):
    name: str
    init: Callable[[torch.Tensor], Any]
    update: Callable[[torch.Tensor, Any, int], Tuple[torch.Tensor, Any]]
    # Whether the bucketed engine has a fused update for this inner
    # (kernels/lowrank_update).
    fused_eligible: bool = False


class AdamState(NamedTuple):
    m: torch.Tensor
    v: torch.Tensor


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> InnerOptimizer:
    def init(x):
        return AdamState(
            m=torch.zeros(x.shape, dtype=torch.float32, device=x.device),
            v=torch.zeros(x.shape, dtype=torch.float32, device=x.device),
        )

    def update(g, state, step):
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

    def init(x):
        return MSGDState(m=torch.zeros(x.shape, dtype=torch.float32, device=x.device))

    def update(g, state, step):
        del step
        m = (1.0 - b1) * state.m + b1 * g.float()
        return m, MSGDState(m=m)

    return InnerOptimizer("msgd", init, update, fused_eligible=True)


class AdamMiniState(NamedTuple):
    m: torch.Tensor
    v: torch.Tensor  # one f32 per row of the last axis (per tensor below 2-D)


def adam_mini(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8) -> InnerOptimizer:
    """Adam-mini: one second moment per row (the r basis rows of a projected
    gradient, the output rows of a full-rank 2-D leaf)."""

    def init(x):
        v_shape = tuple(x.shape[:-1]) if x.dim() >= 2 else (1,)
        return AdamMiniState(
            m=torch.zeros(x.shape, dtype=torch.float32, device=x.device),
            v=torch.zeros(v_shape, dtype=torch.float32, device=x.device),
        )

    def update(g, state, step):
        g = g.float()
        m = b1 * state.m + (1.0 - b1) * g
        if g.dim() >= 2:
            v = b2 * state.v + (1.0 - b2) * torch.mean(g * g, dim=-1)
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

    def init(x):
        z = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        mc, ms = quantize_blockwise(z, signed=True)
        vc, vs = quantize_blockwise(z, signed=False)
        return Adam8bitState(m_codes=mc, m_scale=ms, v_codes=vc, v_scale=vs)

    def update(g, state, step):
        g = g.float()
        m = dequantize_blockwise(state.m_codes, state.m_scale, True)
        v = dequantize_blockwise(state.v_codes, state.v_scale, False)
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g * g
        bc1, bc2 = bias_corrections(b1, b2, step)
        direction = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        mc, ms = quantize_blockwise(m, signed=True)
        vc, vs = quantize_blockwise(v, signed=False)
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


_FACTORIES = {"adam": adam, "msgd": msgd, "adam_mini": adam_mini, "adam8bit": adam8bit}
_LATER = ("adafactor",)


def make_inner(name: str, **kwargs: Any) -> InnerOptimizer:
    if name in _LATER:
        raise NotImplementedError(
            f"inner optimizer {name!r} is not yet ported to repro_torch (it comes "
            "with a later slice, ROADMAP queue 1 item 7); ported: "
            f"{list(_FACTORIES)}"
        )
    if name not in _FACTORIES:
        raise ValueError(f"unknown inner optimizer {name!r}; have {list(_FACTORIES)}")
    return _FACTORIES[name](**kwargs)
