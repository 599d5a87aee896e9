"""Inner stateful optimizers that run inside the low-rank subspace, from
``src/repro/core/inner.py``: ``(init, update)`` pairs on one tensor (the
projected gradient R of a low-rank leaf, or the raw gradient of a
full-rank leaf).  ``update`` returns an ascent direction; the wrapper
applies sign, learning rate and the GaLore ``alpha``.  ``step`` is
1-indexed (the first update sees step=1) for bias correction.

Adam and momentum SGD are ported.  Adafactor, Adam-mini and 8-bit Adam
come with the remaining-inners slice (ROADMAP queue 1 item 7).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

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


# ---------------------------------------------------------------------------
# Fused (bucket-native) state plumbing
# ---------------------------------------------------------------------------

_FUSED_SECOND_MOMENT = {"adam": True, "msgd": False}


def fused_has_second_moment(name: str) -> bool:
    if name not in _FUSED_SECOND_MOMENT:
        raise ValueError(f"{name!r} has no fused (bucket-native) state layout")
    return _FUSED_SECOND_MOMENT[name]


def fused_state(name: str, m: torch.Tensor, v: Optional[torch.Tensor] = None):
    """Per-leaf inner state from canonical moment buffers."""
    if name == "adam":
        return AdamState(m=m, v=v)
    if name == "msgd":
        return MSGDState(m=m)
    raise ValueError(f"{name!r} has no fused (bucket-native) state layout")


_FACTORIES = {"adam": adam, "msgd": msgd}
_LATER = ("adafactor", "adam_mini", "adam8bit")


def make_inner(name: str, **kwargs: Any) -> InnerOptimizer:
    if name in _LATER:
        raise NotImplementedError(
            f"inner optimizer {name!r} is not yet ported to repro_torch (it comes "
            "with the remaining-inners slice, ROADMAP queue 1 item 7); ported: "
            f"{list(_FACTORIES)}"
        )
    if name not in _FACTORIES:
        raise ValueError(f"unknown inner optimizer {name!r}; have {list(_FACTORIES)}")
    return _FACTORIES[name](**kwargs)
