"""The training loop, from ``src/repro/train/loop.py``: checkpoint and
resume, preemption, the step monitor, the staggered projector-refresh
cadence, deferred metric fetch and subspace tracking.

  * **Resume.**  When ``train_cfg.checkpoint_dir`` holds checkpoints, the
    loop restores the newest one that verifies, prints the directory, the
    step and any newer checkpoint it skipped, and goes on from its step.
    Batches are pure functions of the step and the optimizer's draw source
    is in the checkpoint (``.opt_state.key``, ``TorchDraws.key``), so a
    resumed run replays the uninterrupted run's batches and draws.
  * **Checkpoints.**  A save after every ``checkpoint_every`` steps, of
    the state at ``step + 1``, in the canonical per-leaf layout
    (``train/state.checkpoint_converters``).  With
    ``async_checkpoint=True`` (the default) it snapshots the whole state to
    host memory and writes on a background thread; with False it streams
    leaf by leaf and blocks, holding one leaf on the host.  The on-card
    smoke test uses the blocking save (``chip_smoke.py``, phase resume).
  * **Preemption.**  SIGTERM or SIGINT (handlers installed on the main
    thread only) finish the current step, save at ``step + 1`` (blocking)
    and end the run with ``final_step = step + 1``.
  * **Deferred fetch.**  A step's metrics stay on the device until a
    refresh, checkpoint, preemption, log or final step drains them, so a
    hot step does not wait for the card to report its loss.  ``losses``
    and ``history`` come out as with a fetch per step; only the moment the
    NaN sentinel (``StepMonitor.note_loss``) can abort moves.
  * **Refresh cadence.**  Group g refreshes at steps where
    step % (tau / groups) == 0, cycling groups; every other step is a hot
    step.

Recovery (rollback, skip-step), faults, heartbeats, the rank-elastic
engine and the spectrum logger come with ROADMAP queue 1 items 9 and 10.
"""
from __future__ import annotations

import dataclasses
import signal
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core import lowrank as lowrank_lib
from repro_torch.core import metrics as metrics_lib
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import state as state_lib
from repro_torch.train.monitor import StepMonitor
from repro_torch.train.state import TrainState


@dataclasses.dataclass
class TrainResult:
    state: TrainState
    history: List[Dict[str, Any]]
    final_step: int
    losses: List[float]
    # ``OverlapTracker`` with ``track_subspace=True``
    subspace: Optional[metrics_lib.OverlapTracker] = None
    # the run's manager: ``last_save`` / ``last_load`` hold bytes and seconds
    checkpoints: Optional[ckpt_lib.CheckpointManager] = None


class _PreemptionGuard:
    """SIGTERM/SIGINT -> finish the current step, checkpoint, stop."""

    _SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self, enable: bool):
        self.requested = False
        self._prev: Dict[int, Any] = {}
        if enable:
            for sig in self._SIGNALS:
                try:
                    self._prev[sig] = signal.signal(sig, self._handler)
                except ValueError:
                    break  # not on the main thread: neither is installed

    def _handler(self, signum, frame):
        self.requested = True

    def restore(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)


def train_loop(
    model,
    optimizer: lowrank_lib.LowRankOptimizer,
    data,
    train_cfg: TrainConfig,
    step_fns: Dict[str, Callable],
    *,
    state: Optional[TrainState] = None,
    log_every: int = 50,
    eval_fn: Optional[Callable[[TrainState, int], Dict[str, float]]] = None,
    track_subspace: bool = False,
    handle_signals: bool = True,
    batch_hook: Optional[Callable] = None,
) -> TrainResult:
    """Run to ``train_cfg.total_steps`` from ``state`` (or from fresh params
    made by ``model.init`` with ``train_cfg.seed``, on the model's device),
    or from the newest checkpoint in ``train_cfg.checkpoint_dir``, which
    wins over both.  ``data.batch_at(step)`` gives each step's batch and
    ``batch_hook(batch)`` may replace it; ``eval_fn(state, step)`` adds its
    dict to each history record."""
    tau = max(optimizer.config.tau, 1)
    groups = max(optimizer.config.refresh_groups, 1)
    sub_tau = max(tau // groups, 1)
    canonicalize, localize = state_lib.checkpoint_converters(optimizer)
    manager = ckpt_lib.CheckpointManager(
        train_cfg.checkpoint_dir, keep=train_cfg.keep_checkpoints,
        canonicalize=canonicalize, localize=localize,
    )
    monitor = StepMonitor()
    tracker = metrics_lib.OverlapTracker() if track_subspace else None

    if state is None:
        gen = torch.Generator(device=model.device).manual_seed(train_cfg.seed)
        params = model.init(gen)
        state = TrainState(params, optimizer.init(params))
        del params  # the state owns them: the first step's output replaces them
    start_step = 0
    if ckpt_lib.checkpoint_dirs(train_cfg.checkpoint_dir):
        state, start_step = manager.load_latest(state)
        # said on every restore: the default directory is shared with the
        # JAX package, whose checkpoints this loop reads too
        skipped = "".join(f"; skipped step {s}: {err}" for s, err in manager.fallbacks)
        print(f"[train] resumed from {train_cfg.checkpoint_dir} at step {start_step}{skipped}",
              flush=True)
    history: List[Dict[str, Any]] = []
    losses: List[float] = []

    def save(cur_state: TrainState, s: int, blocking: bool) -> None:
        try:
            manager.save(cur_state, s, blocking=blocking)
        except Exception:
            monitor.save_failures += 1
            raise
        finally:
            monitor.save_retries = manager.retries_performed

    # (step, metrics on the device, health) of the steps not yet fetched
    pending: List = []

    def flush(cur_state: TrainState, swallow_aborts: bool = False) -> None:
        # entry by entry, so an abort mid-flush neither repeats nor drops a
        # fetched loss; the final flush must not mask an exception in flight
        while pending:
            s, m, health = pending.pop(0)
            loss = float(m["loss"])
            losses.append(loss)
            try:
                monitor.note_loss(s, loss)
            except FloatingPointError:
                if not swallow_aborts:
                    raise
            if s % log_every == 0 or s == train_cfg.total_steps - 1:
                rec = {
                    "step": float(s),
                    "loss": loss,
                    "grad_norm": float(m.get("grad_norm", np.nan)),
                    "update_norm": float(m.get("update_norm", np.nan)),
                    "skipped": 0.0,
                    **{k: float(v) for k, v in health.items()},
                    **monitor.counters(),
                }
                if eval_fn is not None:
                    # a log step flushes itself at once, so eval_fn sees the
                    # state of the step it reports
                    rec.update(eval_fn(cur_state, s))
                history.append(rec)

    guard = _PreemptionGuard(handle_signals)
    step = start_step
    final_step = train_cfg.total_steps
    try:
        while step < train_cfg.total_steps:
            batch = data.batch_at(step)
            if batch_hook is not None:
                batch = batch_hook(batch)
            monitor.start_step()
            is_refresh = step % sub_tau == 0
            if is_refresh:
                group = (step // sub_tau) % groups
                state, m = step_fns["refresh_step"](state, batch, group=group)
            else:
                state, m = step_fns["step"](state, batch)
            del batch
            pending.append((step, m, monitor.end_step(step)))
            if tracker is not None and is_refresh:
                tracker.observe(metrics_lib.collect_projectors(
                    state.opt_state, optimizer.specs, layout=optimizer.state_layout))
            checkpoint_due = (train_cfg.checkpoint_every > 0
                              and (step + 1) % train_cfg.checkpoint_every == 0)
            if (is_refresh or checkpoint_due or guard.requested
                    or step % log_every == 0 or step == train_cfg.total_steps - 1):
                flush(state)
            if checkpoint_due:
                save(state, step + 1, blocking=not train_cfg.async_checkpoint)
            if guard.requested:
                save(state, step + 1, blocking=True)
                final_step = step + 1
                break
            step += 1
    finally:
        flush(state, swallow_aborts=True)
        try:
            manager.wait()
        except Exception:
            monitor.save_failures += 1
            raise
        finally:
            monitor.save_retries = manager.retries_performed
            guard.restore()
    return TrainResult(state=state, history=history, final_step=final_step, losses=losses,
                       subspace=tracker, checkpoints=manager)
