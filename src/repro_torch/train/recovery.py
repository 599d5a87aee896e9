"""The recovery policy of the training loop, from
``src/repro/train/recovery.py`` (DESIGN.md §2.9): skip-step and
rollback-and-resample.

  * **skip-step** -- a bad microbatch (non-finite gradients) must not
    poison the moments: ``optimizer.update(skip_nonfinite=True)`` checks
    the raw gradients and, on a bad step, hands params and optimizer state
    back unchanged and counts the step as skipped.
  * **rollback-and-resample** -- sustained divergence (a streak of bad
    steps: non-finite losses, skipped updates, or with ``loss_spike_factor``
    losses above that factor times the median of recent good ones) means
    the trajectory is bad, not the batch.  The loop reloads the newest
    checkpoint that verifies and moves the draw source to another stream
    (``resample_opt_state``), so the next refresh of sara, golore or grass
    draws another subspace instead of replaying the divergence; dominant's
    top-k is a function of the gradient alone and draws the same one.
    After ``max_rollbacks`` the loop aborts with ``FloatingPointError``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

from repro_torch.core.lowrank import LowRankOptState


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """How the train loop degrades instead of aborting.

    ``skip_nonfinite_updates``: gate every update on the gradients being
    finite.  ``max_bad_steps``: consecutive bad steps that trigger a
    rollback.  ``loss_spike_factor``: > 0 makes ``loss > factor *
    median(recent good losses)`` a bad step too; ``loss_window`` is the
    median's window.  ``max_rollbacks``: the budget before the loop aborts.
    ``rollback_backoff_s``: the sleep before the first rollback, doubled
    for each next one (0: none).  ``resample_on_rollback``: move the draw
    source on reload.  ``stale_worker_action``: what a newly stale
    heartbeat escalates to -- ``log`` (a history record), ``rollback``
    (``RollbackNeeded``) or ``abort``."""

    STALE_ACTIONS = ("log", "rollback", "abort")

    skip_nonfinite_updates: bool = True
    max_bad_steps: int = 3
    loss_spike_factor: float = 0.0
    loss_window: int = 32
    max_rollbacks: int = 3
    rollback_backoff_s: float = 0.0
    resample_on_rollback: bool = True
    stale_worker_action: str = "log"

    def __post_init__(self):
        if self.stale_worker_action not in self.STALE_ACTIONS:
            raise ValueError(f"stale_worker_action {self.stale_worker_action!r} not in "
                             f"{self.STALE_ACTIONS}")

    def backoff_s(self, attempt: int) -> float:
        """Sleep before rollback ``attempt`` (1-indexed), doubling."""
        if self.rollback_backoff_s <= 0:
            return 0.0
        return self.rollback_backoff_s * (2.0 ** (attempt - 1))


class RollbackNeeded(Exception):
    """Raised by the divergence detector where the loop fetches metrics;
    the loop catches it and rolls back."""

    def __init__(self, step: int, reason: str):
        super().__init__(f"step {step}: {reason}")
        self.step = step
        self.reason = reason


class DivergenceDetector:
    """Streak detector over the fetched loss stream.  A step is bad when
    the cross-process verdict says so, its loss is non-finite, its update
    was skipped, or (``loss_spike_factor > 0``, at least ``_MIN_WINDOW``
    good losses seen) its loss exceeds the factor times their median; only
    good losses enter the window, so a spike cannot raise the median that
    would hide it.  ``max_bad_steps`` bad steps in a row raise
    ``RollbackNeeded``."""

    _MIN_WINDOW = 5  # spike detection needs a meaningful median

    def __init__(self, policy: RecoveryPolicy):
        self.policy = policy
        self.streak = 0
        self._window: List[float] = []

    def observe(self, step: int, loss: float, skipped: bool = False,
                verdict: bool = False) -> None:
        """Feed one step; raises ``RollbackNeeded`` when the streak trips.
        ``verdict`` is ``metrics["bad_step"]``, the step's own bad-step
        flag, summed across the processes by the data-parallel step
        (``train/step.py``), so every process rolls back together."""
        if verdict:
            bad, why = True, "cross-process bad-step verdict"
        elif not math.isfinite(loss):
            bad, why = True, "non-finite loss"
        elif skipped:
            bad, why = True, "update skipped (non-finite grads)"
        elif (self.policy.loss_spike_factor > 0 and len(self._window) >= self._MIN_WINDOW
              and loss > self.policy.loss_spike_factor * self._median()):
            bad, why = True, (f"loss spike {loss:.4g} > {self.policy.loss_spike_factor:g} x "
                              f"median {self._median():.4g}")
        else:
            bad, why = False, ""
            self._window.append(loss)
            if len(self._window) > self.policy.loss_window:
                self._window.pop(0)
        if bad:
            self.streak += 1
            if self.streak >= self.policy.max_bad_steps:
                raise RollbackNeeded(step, f"{why} ({self.streak} consecutive bad steps)")
        else:
            self.streak = 0

    def _median(self) -> float:
        s = sorted(self._window)
        return s[len(s) // 2]

    def reset(self) -> None:
        """After a rollback: the streak belonged to the abandoned
        trajectory; the window of good losses predates it and stays."""
        self.streak = 0


def resample_opt_state(opt_state: LowRankOptState, attempt: int) -> LowRankOptState:
    """The state with its draw source moved to rollback ``attempt``'s
    stream (``TorchDraws.resample``; JAX folds ``0x5EED + attempt`` into
    its key).  Every later refresh draws from the new stream: sara's Gumbel
    top-k, golore's basis and grass's rows change, dominant's projector does
    not (``projectors.refresh_is_stochastic``)."""
    return opt_state._replace(draws=opt_state.draws.resample(attempt))
