"""Train state and its layout conversion at the checkpoint boundary, from
``src/repro/train/state.py``.

Checkpoints hold the canonical per-leaf optimizer-state layout: a run whose
state is bucket-native (``engine="bucketed"`` with a fused inner and no
Fira) converts on save and load, so a checkpoint written under one engine resumes under
the other, and under the JAX package.  The conversion moves data only
(8-bit codes and scales, Adam-mini's per-row v included), so nothing is
requantized; a ZeRO state's pad rows are dropped.  The shard-parallel
format of a ZeRO run records ``bucket_canonical_rows`` instead.
"""
from __future__ import annotations

from typing import Any, NamedTuple

from repro_torch.core import lowrank as lowrank_lib
from repro_torch.core.lowrank import LowRankOptState


class TrainState(NamedTuple):
    params: Any  # nested dict of tensors
    opt_state: LowRankOptState

    @property
    def step(self) -> int:
        return self.opt_state.step


def canonical_train_state(optimizer: lowrank_lib.LowRankOptimizer,
                          state: TrainState) -> TrainState:
    """Storage layout -> the per-leaf layout checkpoints hold."""
    return TrainState(state.params, lowrank_lib.canonical_opt_state(optimizer, state.opt_state))


def storage_train_state(optimizer: lowrank_lib.LowRankOptimizer,
                        state: TrainState) -> TrainState:
    """Per-leaf checkpoint layout -> the optimizer's storage layout."""
    return TrainState(state.params, lowrank_lib.storage_opt_state(optimizer, state.opt_state))


def checkpoint_converters(optimizer: lowrank_lib.LowRankOptimizer):
    """(canonicalize, localize) for ``CheckpointManager``, or (None, None)
    when the optimizer already stores the canonical per-leaf layout."""
    if optimizer.state_layout is None:
        return None, None
    return (
        lambda ts: canonical_train_state(optimizer, ts),
        lambda ts: storage_train_state(optimizer, ts),
    )


def bucket_canonical_rows(optimizer: lowrank_lib.LowRankOptimizer):
    """{bucket index: canonical (unpadded) row count}, which a shard-parallel
    checkpoint records so that a load strips the writer's pad rows before
    it pads again for its own shard count; None for per-leaf optimizers,
    which have no stacks to shard."""
    layout = optimizer.state_layout
    if layout is None:
        return None
    return {i: b.batch for i, b in enumerate(layout.plan.buckets)}
