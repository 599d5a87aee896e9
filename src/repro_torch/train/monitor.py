"""Step monitoring, from ``src/repro/train/monitor.py``: ``StepMonitor``,
the per-step wall-time window with straggler flags, the NaN/Inf loss
sentinel and the counters every history record carries.  The heartbeat
registry, the collective watchdog and the spectrum logger come with
fault tolerance and rank schedules (ROADMAP queue 1 items 9, 10).
"""
from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, Optional


class StepMonitor:
    def __init__(
        self,
        straggler_factor: float = 3.0,
        window: int = 50,
        max_bad_losses: int = 5,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.straggler_factor = straggler_factor
        self.window = window
        self.max_bad_losses = max_bad_losses
        self._clock = clock
        self._times: List[float] = []
        self._t_start: Optional[float] = None
        self.stragglers: List[int] = []
        self.bad_loss_count = 0
        self.step_count = 0
        # recovery counters, surfaced in every history record: the port's
        # loop keeps ``save_retries`` and ``save_failures``; skips and
        # rollbacks stay 0 until recovery is ported
        self.skip_steps = 0
        self.rollbacks = 0
        self.save_retries = 0
        self.save_failures = 0

    def start_step(self) -> None:
        self._t_start = self._clock()

    def end_step(self, step: int, loss: Optional[float] = None) -> Dict[str, float]:
        """Close the step's wall-time window.  ``loss`` may be left out when
        the caller fetches metrics later and feeds ``note_loss`` then."""
        dt = self._clock() - (self._t_start or self._clock())
        self._times.append(dt)
        if len(self._times) > self.window:
            self._times.pop(0)
        self.step_count += 1
        med = sorted(self._times)[len(self._times) // 2]
        is_straggler = len(self._times) >= 5 and dt > self.straggler_factor * med
        if is_straggler:
            self.stragglers.append(step)
        if loss is not None:
            self.note_loss(step, loss)
        return {
            "step_time_s": dt,
            "median_step_time_s": med,
            "straggler": float(is_straggler),
        }

    def note_loss(self, step: int, loss: float, raise_on_streak: bool = True) -> bool:
        """NaN/Inf sentinel: more than ``max_bad_losses`` non-finite losses
        in a row abort the run (a finite loss resets the count, whether
        losses arrive per step or in deferred batches).  With
        ``raise_on_streak=False`` it returns the tripped flag instead."""
        if not math.isfinite(loss):
            self.bad_loss_count += 1
            if self.bad_loss_count > self.max_bad_losses:
                if raise_on_streak:
                    raise FloatingPointError(
                        f"{self.bad_loss_count} non-finite losses; aborting "
                        f"(last at step {step})"
                    )
                return True
        else:
            self.bad_loss_count = 0
        return False

    def counters(self) -> Dict[str, float]:
        """The recovery counters, merged into every history record."""
        return {
            "skip_steps": float(self.skip_steps),
            "rollbacks": float(self.rollbacks),
            "save_retries": float(self.save_retries),
            "save_failures": float(self.save_failures),
        }
