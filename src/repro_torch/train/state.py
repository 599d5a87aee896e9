"""Train state, from ``src/repro/train/state.py``.  The checkpoint layout
converters come with the checkpoint slice (ROADMAP queue 1)."""
from __future__ import annotations

from typing import Any, NamedTuple

from repro_torch.core.lowrank import LowRankOptState


class TrainState(NamedTuple):
    params: Any  # nested dict of tensors
    opt_state: LowRankOptState

    @property
    def step(self) -> int:
        return self.opt_state.step
