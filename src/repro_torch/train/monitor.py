"""Runtime health monitoring, from ``src/repro/train/monitor.py``:

  * ``StepMonitor`` -- the per-step wall-time window with straggler flags,
    the NaN/Inf loss sentinel and the recovery counters every history
    record carries.
  * ``HeartbeatRegistry`` -- worker liveness: ``check(step)`` returns the
    workers that newly went stale, records the first stale step of each,
    and feeds the loop's stale-worker action (log, rollback or abort).
  * ``CollectiveWatchdog`` -- bounds the wall time of a dispatched step:
    ``guard`` arms a timer, waits for the step's result on the card, and
    records a firing when that took longer than ``timeout_s`` (from the
    timer thread if the wait hangs).
  * ``SpectrumLogger`` -- at each refresh, the singular spectrum of the
    update of one probe leaf per refresh group, and its effective rank:
    the adaptive rank schedule's input.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core import metrics as metrics_lib
from repro_torch.core.lowrank import tree_leaves


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
        # recovery counters (train/recovery.py), kept by the train loop and
        # surfaced in every history record
        self.skip_steps = 0  # updates gated out (non-finite grads)
        self.rollbacks = 0  # checkpoint rollbacks performed
        self.save_retries = 0  # checkpoint write attempts retried
        self.save_failures = 0  # saves abandoned after their retries

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


class HeartbeatRegistry:
    def __init__(self, timeout_s: float = 60.0, clock: Callable[[], float] = time.monotonic):
        self.timeout_s = timeout_s
        self._clock = clock
        self._last: Dict[str, float] = {}
        # workers flagged stale now (each stale episode escalates once), and
        # the step each worker was first seen stale at (kept for the record)
        self._flagged: set = set()
        self.first_stale: Dict[str, int] = {}

    def beat(self, worker: str) -> None:
        self._last[worker] = self._clock()
        self._flagged.discard(worker)  # a beat ends the stale episode

    def stale(self) -> List[str]:
        now = self._clock()
        return [w for w, t in self._last.items() if now - t > self.timeout_s]

    def check(self, step: int) -> List[str]:
        """The workers that went stale since the last check; each one's
        first stale step goes to ``first_stale``."""
        newly = [w for w in self.stale() if w not in self._flagged]
        for w in newly:
            self._flagged.add(w)
            self.first_stale.setdefault(w, step)
        return newly

    def healthy(self) -> bool:
        return not self.stale()


def _result_device(result) -> Optional[torch.device]:
    """The device of the first tensor in a nested result, or None."""
    if isinstance(result, torch.Tensor):
        return result.device
    if isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (list, tuple)):
        for x in result:
            dev = _result_device(x)
            if dev is not None:
                return dev
    return None


class CollectiveWatchdog:
    """Bounds the wall time of a train step's dispatched work.

    Kernels launch asynchronously: a hung collective shows as a result that
    never becomes ready.  ``guard`` arms a timer, waits for ``result`` on
    its card (``_block``), and cancels; past ``timeout_s`` the firing goes
    to ``fired`` and ``on_timeout(step, elapsed_s)`` runs -- from the timer
    thread when the wait hangs, so the signal escapes all the same.  It
    syncs every guarded call, so it is opt-in.  ``_block`` may be replaced
    in tests."""

    def __init__(self, timeout_s: float = 60.0,
                 on_timeout: Optional[Callable[[int, float], None]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_s = timeout_s
        self.on_timeout = on_timeout
        self._clock = clock
        self.fired: List[Tuple[int, float]] = []  # (step, elapsed_s)

    def _block(self, result) -> None:
        """Wait until the card has finished the work ``result`` came from:
        its stream is synchronized (the CPU's results are ready already)."""
        dev = _result_device(result)
        if dev is not None and dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()

    def guard(self, step: int, result):
        """Wait until ``result`` is ready, escalating past ``timeout_s``."""
        timed_out = threading.Event()

        def _fire():
            timed_out.set()
            if self.on_timeout is not None:
                self.on_timeout(step, self.timeout_s)

        timer = threading.Timer(self.timeout_s, _fire)
        timer.daemon = True
        timer.start()
        t0 = self._clock()
        try:
            self._block(result)
        finally:
            timer.cancel()
        elapsed = self._clock() - t0
        if elapsed > self.timeout_s and not timed_out.is_set():
            # slow but finished (or a fake clock): escalate here
            if self.on_timeout is not None:
                self.on_timeout(step, elapsed)
            timed_out.set()
        if timed_out.is_set():
            self.fired.append((step, elapsed))
        return result


class SpectrumLogger:
    """The refresh-cadence spectrum probe of the low-rank update.

    One probe leaf per refresh group: the low-rank leaf with the largest
    clamped rank (first in flat order on a tie), as the reference picks it.
    The loop calls ``capture_before`` with the params entering a refresh
    step and ``observe`` with the params it returns; the record is the
    normalized singular spectrum of the probe's update and its effective
    rank (mean over stacked slices).  The port's steps return new tensors
    and never write their inputs, so ``capture_before`` keeps a reference
    to the old probe leaf where it lies, on the card, instead of the
    reference's host copy: the old leaf (and, where it is a view of a
    bucket's W' stack, that stack) stays allocated through the refresh
    step.  ``effective_rank_for(group)`` is the adaptive schedule's
    reading.  ``gather(leaf index, block)`` (a process holding blocks of the
    leaves) joins the probe leaf before it is read, on every process."""

    def __init__(self, specs, gather=None) -> None:
        self.gather = gather
        self.probe: Dict[int, Tuple[int, str]] = {}
        best: Dict[int, int] = {}
        for idx, spec in enumerate(specs):
            if not spec.lowrank:
                continue
            if spec.group not in best or spec.rank > best[spec.group]:
                best[spec.group] = spec.rank
                self.probe[spec.group] = (idx, spec.path)
        self._before: Dict[int, Any] = {}
        self._latest: Dict[int, float] = {}
        self.history: List[Dict[str, Any]] = []

    def _leaf(self, params, group: int):
        i = self.probe[group][0]
        x = tree_leaves(params)[i]
        return x if self.gather is None else self.gather(i, x)

    def capture_before(self, params, group: int) -> None:
        """Keep the probe leaf of the params entering a refresh step."""
        if group in self.probe:
            self._before[group] = self._leaf(params, group)

    def observe(self, params, step: int, group: int) -> Optional[Dict[str, Any]]:
        """The spectrum of the refresh step's update of the probe leaf."""
        if group not in self.probe or group not in self._before:
            return None
        before = self._before.pop(group)
        spectrum = metrics_lib.update_singular_spectrum(before, self._leaf(params, group))
        del before
        eff = float(torch.mean(metrics_lib.effective_rank(spectrum)))
        top = float(torch.max(spectrum))
        self._latest[group] = eff
        rec = {"event": "spectrum", "step": float(step), "group": float(group),
               "effective_rank": eff, "top_singular_value": top,
               "path": self.probe[group][1]}
        self.history.append(rec)
        return rec

    def effective_rank_for(self, group: int) -> Optional[float]:
        return self._latest.get(group)
