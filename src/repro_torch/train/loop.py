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
  * **Recovery** (``recovery=``, a ``RecoveryPolicy``).  Non-finite
    gradients are gated out inside the step (skip-step: build the steps
    with ``make_train_step(..., recovery=)``); sustained divergence, seen
    where metrics are fetched by the ``DivergenceDetector``, rolls back:
    the newest checkpoint that verifies is reloaded, the draw source moves
    to the attempt's stream (``resample_opt_state``), ``losses`` and
    ``history`` are cut back to the checkpoint's step and the loop goes on
    from there; past ``max_rollbacks`` it aborts with ``FloatingPointError``.
    With recovery on and an empty directory, the first step's state is
    pinned as a checkpoint (save ordinal 0) before the first step, so a
    rollback always has a target; failed saves are counted (and recorded
    as ``save_failed`` events) instead of ending the run.
  * **Faults** (``fault_plan=``, ``train/faults.py``): the plan's hooks run
    at the same points as in the reference, its ``CheckpointIO`` under the
    manager; ``ProcessKilled`` goes through uncaught.
  * **Heartbeats** (``heartbeats=``): the loop beats as ``worker_name``
    every step, and each newly stale worker is recorded and escalated per
    ``RecoveryPolicy.stale_worker_action`` (log, rollback or abort).
  * **Rank schedules.**  When the optimizer carries a ``rank_schedule``
    and the step functions can ``rebuild``, every refresh evaluates the
    schedule after the metric flush and before the save; a rank change is
    a re-bucket event: rebuild the optimizer at the new rank, migrate the
    live state (``core/rank_schedule.migrate_opt_state``), rebuild the
    steps, rebind the manager, and record ``{"event": "rebucket"}``.  The
    rebind waits for a save in flight; a failure of that save is counted
    under recovery, as at every other wait (the reference's loop lets it
    end the run there: ROADMAP queue 3).
    Checkpoints carry the rank in the manifest's ``meta``, and a restore
    rebuilds the optimizer at the checkpoint's rank before it loads.
  * **Spectrum** (``TrainConfig.log_spectrum``, or an adaptive schedule):
    the ``SpectrumLogger`` reads each refresh's update of one probe leaf
    per group; its records go to the history with ``log_spectrum``.
  * **Data parallel** (steps made with ``make_train_step(mesh=...)``):
    every process runs the loop on the global batches, and the steps'
    summed verdicts keep their decisions the same.  A ZeRO run
    (``state_shards > 1``) writes the shard-parallel format unless
    ``TrainConfig.sharded_checkpoint`` is False: each process its block of
    rows (``checkpoint.local_shard_ids``), the bucket rows recorded
    (``state.bucket_canonical_rows``, rebound at a re-bucket).  A fresh
    state takes the step's layout (``fns["place_state"]``); a replicated
    state is written by rank 0 alone; the processes meet at a barrier
    before they list the directory and before a rollback's load.
  * **Tensor parallel and FSDP** (a mesh with ``model`` above 1, or the
    standard step at ``data`` above 1): the state holds this process's
    blocks; a save gathers the global state on every
    process (``fns["gather_state"]``) and the first process writes JAX's
    canonical per-leaf format (a compressed step's ZeRO state: the
    shard-parallel format, each writer of ``checkpoint.local_shard_ids``
    its block of the gathered stacks' rows), and a load reads the global
    state and cuts it (``fns["place_state"]``), so a tensor-parallel
    checkpoint resumes on one process and in JAX, and a one-process
    checkpoint resumes under tensor parallelism or FSDP at any ``data``
    extent.  The spectrum logger
    reads the probe leaf gathered (``launch/sharding.gather_leaf``) and
    ``track_subspace`` the gathered projectors
    (``core/lowrank.tp_global_projectors``), so every process records one
    process's values and the adaptive schedule proposes the same rank on
    every process; a re-bucket gathers the global state, migrates it,
    rebuilds the global optimizer and its steps at the new rank and places
    the state again (the rebuilt steps cut the optimizer anew).
  * **A lost process.**  An exception out of a step (a collective whose
    peer died raises on gloo; NCCL aborts under
    ``TORCH_NCCL_ASYNC_ERROR_HANDLING``) leaves the loop with a note naming
    the step, so each surviving process of a world ends with the step it
    was in; running the world again resumes from the newest checkpoint
    that verifies.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import RankSchedule, TrainConfig
from repro_torch.core import lowrank as lowrank_lib
from repro_torch.core import metrics as metrics_lib
from repro_torch.core import rank_schedule as rank_schedule_lib
from repro_torch.launch.mesh import barrier
from repro_torch.launch.sharding import gather_leaf
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import recovery as recovery_lib
from repro_torch.train import state as state_lib
from repro_torch.train.monitor import HeartbeatRegistry, SpectrumLogger, StepMonitor
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
    # the optimizer the run ended with (a re-bucketed one after a rank change)
    optimizer: Optional[lowrank_lib.LowRankOptimizer] = None


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
    recovery: Optional[recovery_lib.RecoveryPolicy] = None,
    fault_plan=None,  # Optional[repro_torch.train.faults.FaultPlan]
    heartbeats: Optional[HeartbeatRegistry] = None,
    worker_name: str = "worker0",
) -> TrainResult:
    """Run to ``train_cfg.total_steps`` from ``state`` (or from fresh params
    made by ``model.init`` with ``train_cfg.seed``, on the model's device),
    or from the newest checkpoint in ``train_cfg.checkpoint_dir``, which
    wins over both.  ``data.batch_at(step)`` gives each step's batch and
    ``batch_hook(batch)`` may replace it; ``eval_fn(state, step)`` adds its
    dict to each history record.  ``recovery``, ``fault_plan``,
    ``heartbeats`` and ``worker_name`` as in the module docstring."""
    tau = max(optimizer.config.tau, 1)
    groups = max(optimizer.config.refresh_groups, 1)
    sub_tau = max(tau // groups, 1)
    canonicalize, localize = state_lib.checkpoint_converters(optimizer)
    mesh = step_fns.get("mesh")
    zero_axes = step_fns.get("zero_axes")  # this process holds a block of rows
    tp = bool(step_fns.get("tp"))  # this process holds blocks of the leaves
    layout = optimizer.state_layout
    shard_spec = None
    if tp:
        # from the gathered state: the canonical format, or, for a ZeRO
        # state of the compressed step, each writer its block of rows of the
        # full padded stacks
        if (train_cfg.sharded_checkpoint and not step_fns.get("fsdp")
                and layout is not None and layout.shards > 1):
            shard_spec = ckpt_lib.ShardSpec(num_shards=layout.shards,
                                            shard_ids=ckpt_lib.local_shard_ids(layout.shards))
    elif train_cfg.sharded_checkpoint and layout is not None and layout.shards > 1:
        shard_spec = ckpt_lib.ShardSpec(
            num_shards=layout.shards, shard_ids=ckpt_lib.local_shard_ids(layout.shards),
            holds=zero_axes.index if zero_axes is not None else None)
    elif zero_axes is not None:
        raise ValueError("a ZeRO step whose processes hold their own rows writes the "
                         "shard-parallel format: TrainConfig.sharded_checkpoint=True")
    manager = ckpt_lib.CheckpointManager(
        train_cfg.checkpoint_dir, keep=train_cfg.keep_checkpoints,
        canonicalize=canonicalize, localize=localize,
        io=fault_plan.checkpoint_io() if fault_plan is not None else None,
        shard_spec=shard_spec, canonical_rows=state_lib.bucket_canonical_rows(optimizer),
        writer=mesh is None or not mesh.distributed or mesh.rank == 0,
    )
    monitor = StepMonitor()
    tracker = metrics_lib.OverlapTracker() if track_subspace else None
    detector = recovery_lib.DivergenceDetector(recovery) if recovery is not None else None

    # The rank schedule is live when the optimizer carries one and the step
    # functions can rebuild themselves at a new bucket geometry.
    rank_sched: Optional[RankSchedule] = None
    if optimizer.config.rank_schedule and "rebuild" in step_fns:
        rank_sched = RankSchedule.parse(optimizer.config.rank_schedule)
    spectrum: Optional[SpectrumLogger] = None
    if train_cfg.log_spectrum or (rank_sched is not None and rank_sched.kind == "adaptive"):
        # the adaptive policy reads the probe, so it turns the logger on
        spectrum = SpectrumLogger(optimizer.specs, gather=(
            lambda i, x: gather_leaf(x, step_fns["splits"][i], mesh)) if tp else None)

    def ckpt_meta() -> Optional[Dict[str, Any]]:
        """The rank(s) the state's bucket geometry was built at, for the
        manifest of a scheduled run."""
        if rank_sched is None:
            return None
        r, gr = lowrank_lib.current_ranks(optimizer)
        return {"rank": int(r), "group_ranks": [int(g) for g in gr]}

    def adopt(new_opt: lowrank_lib.LowRankOptimizer) -> None:
        """Swap in an optimizer rebuilt at a new rank: its steps, its
        checkpoint converters, the manager rebound to them."""
        nonlocal optimizer, step_fns, canonicalize, localize
        optimizer = new_opt
        step_fns = step_fns["rebuild"](new_opt)
        canonicalize, localize = state_lib.checkpoint_converters(new_opt)
        manager.rebind(canonicalize, localize,
                       canonical_rows=state_lib.bucket_canonical_rows(new_opt))

    def place(st: TrainState) -> TrainState:
        fn = step_fns.get("place_state")
        return fn(st) if fn is not None else st

    def load_one(skel: TrainState, ck: int) -> TrainState:
        """One checkpoint into ``skel``; a canonical one into a state that
        holds a block of rows loads the full stacks first, and a
        tensor-parallel state loads the global state first."""
        if tp:
            return place(manager.load(step_fns["gather_state"](skel), step=ck))
        if zero_axes is not None and "sharded" not in ckpt_lib.checkpoint_format(
                train_cfg.checkpoint_dir, ck):
            full = TrainState(skel.params, optimizer.init(skel.params)._replace(
                draws=skel.opt_state.draws))
            return place(manager.load(full, step=ck))
        return manager.load(skel, step=ck)

    def restore_latest(skel: TrainState):
        """The newest checkpoint that loads -> (state, step).  Under a
        schedule the walk reads each candidate's ``meta`` and rebuilds the
        optimizer at its rank(s) before loading (``load`` wants exact
        shapes); a candidate that fails to read falls through to the next
        older one, as ``load_latest`` walks."""
        first_err: Optional[BaseException] = None
        for ck in reversed(ckpt_lib.checkpoint_dirs(train_cfg.checkpoint_dir)):
            try:
                if rank_sched is None:
                    return load_one(skel, ck), ck
                meta = ckpt_lib.checkpoint_meta(train_cfg.checkpoint_dir, ck)
                rank_now, groups_now = lowrank_lib.current_ranks(optimizer)
                want_rank = int(meta.get("rank", rank_now))
                want_groups = tuple(int(g) for g in meta.get("group_ranks", ())) or groups_now
                if (want_rank, want_groups) != (rank_now, groups_now):
                    # the global params: a tensor-parallel skeleton holds blocks
                    glob = step_fns["gather_state"](skel).params if tp else skel.params
                    if len(set(want_groups)) > 1:
                        new_opt = lowrank_lib.rebuild_at_rank(optimizer, glob,
                                                              group_ranks=want_groups)
                    else:
                        new_opt = lowrank_lib.rebuild_at_rank(optimizer, glob,
                                                              rank=want_rank)
                    adopt(new_opt)
                    # a skeleton at the new geometry, keeping the caller's
                    # kind of draw source
                    skel = place(TrainState(glob, optimizer.init(glob)._replace(
                        draws=skel.opt_state.draws)))
                return load_one(skel, ck), ck
            except (OSError, ValueError, KeyError) as e:
                if first_err is None:
                    first_err = e
                manager.fallbacks.append((ck, repr(e)))
        if first_err is not None:
            raise first_err
        raise FileNotFoundError(f"no loadable checkpoint under {train_cfg.checkpoint_dir!r}")

    if state is None:
        gen = torch.Generator(device=model.device).manual_seed(train_cfg.seed)
        params = model.init(gen)
        state = place(TrainState(params, optimizer.init(params)))
        del params  # the state owns them: the first step's output replaces them
    start_step = 0
    # every process lists the directory before any of them writes to it
    found = ckpt_lib.checkpoint_dirs(train_cfg.checkpoint_dir)
    barrier(mesh)
    if found:
        state, start_step = restore_latest(state)
        # said on every restore: the default directory is shared with the
        # JAX package, whose checkpoints this loop reads too
        skipped = "".join(f"; skipped step {s}: {err}" for s, err in manager.fallbacks)
        print(f"[train] resumed from {train_cfg.checkpoint_dir} at step {start_step}{skipped}",
              flush=True)
    history: List[Dict[str, Any]] = []
    losses: List[float] = []
    loss_base = start_step  # losses[i] is the loss of step loss_base + i

    def drain_save_error() -> None:
        """Surface (or, under recovery, count) a failed background save."""
        try:
            manager.wait()
        except Exception as e:
            monitor.save_failures += 1
            if recovery is None:
                raise
            history.append({"event": "save_failed", "error": repr(e),
                            "rollbacks": float(monitor.rollbacks)})
        finally:
            monitor.save_retries = manager.retries_performed

    def safe_save(cur_state: TrainState, s: int, blocking: bool) -> None:
        drain_save_error()  # an old failure must not eat this save
        if tp:
            cur_state = step_fns["gather_state"](cur_state)  # on every process
        try:
            manager.save(cur_state, s, blocking=blocking, meta=ckpt_meta())
        except Exception as e:
            monitor.save_failures += 1
            if recovery is None:
                raise
            history.append({"event": "save_failed", "step": float(s), "error": repr(e)})
        finally:
            monitor.save_retries = manager.retries_performed

    # a rollback needs a target: pin the first step's state (save ordinal 0)
    if recovery is not None and not found:
        safe_save(state, start_step, blocking=True)

    # (step, metrics on the device, health) of the steps not yet fetched
    pending: List = []

    def flush(cur_state: TrainState, swallow_aborts: bool = False) -> None:
        # entry by entry, so an abort or a rollback mid-flush neither
        # repeats nor drops a fetched loss; the final flush must not mask an
        # exception in flight
        while pending:
            s, m, health = pending.pop(0)
            loss = float(m["loss"])
            skipped = float(m["skipped"]) if "skipped" in m else 0.0
            verdict = float(m["bad_step"]) >= 1.0 if "bad_step" in m else False
            losses.append(loss)
            if skipped >= 1.0:
                monitor.skip_steps += 1
            if detector is None:
                try:
                    monitor.note_loss(s, loss)
                except FloatingPointError:
                    if not swallow_aborts:
                        raise
            else:
                # recovery owns the abort: the sentinel keeps its count, the
                # detector raises RollbackNeeded
                monitor.note_loss(s, loss, raise_on_streak=False)
                try:
                    detector.observe(s, loss, skipped=skipped >= 1.0, verdict=verdict)
                except recovery_lib.RollbackNeeded:
                    if not swallow_aborts:
                        raise
            if s % log_every == 0 or s == train_cfg.total_steps - 1:
                rec = {
                    "step": float(s),
                    "loss": loss,
                    "grad_norm": float(m.get("grad_norm", np.nan)),
                    "update_norm": float(m.get("update_norm", np.nan)),
                    "skipped": skipped,
                    **{k: float(v) for k, v in health.items()},
                    **monitor.counters(),
                }
                if heartbeats is not None:
                    rec["stale_workers"] = float(len(heartbeats.stale()))
                if eval_fn is not None:
                    # a log step flushes itself at once, so eval_fn sees the
                    # state of the step it reports
                    rec.update(eval_fn(cur_state, s))
                history.append(rec)

    def maybe_rebucket(cur_state: TrainState, s: int, group: int) -> TrainState:
        """The schedule at a refresh boundary; on a rank change, the
        re-bucket event (module docstring)."""
        rank_from, groups_from = lowrank_lib.current_ranks(optimizer)
        new_rank = new_group_ranks = None
        if rank_sched.kind == "adaptive":
            eff = spectrum.effective_rank_for(group) if spectrum is not None else None
            if eff is None:
                return cur_state
            g = group % len(groups_from)
            prop = rank_schedule_lib.propose_adaptive_rank(rank_sched, groups_from[g], eff)
            if prop == groups_from[g]:
                return cur_state
            new_group_ranks = groups_from[:g] + (prop,) + groups_from[g + 1:]
        else:
            r = rank_schedule_lib.scheduled_rank(rank_sched, s, total_steps=train_cfg.total_steps,
                                                 current=rank_from)
            if r == rank_from:
                return cur_state
            new_rank = r
        # the manager's rebind waits for a save in flight, whose failure
        # must be counted under recovery, as at every other wait
        drain_save_error()
        old_opt = optimizer
        # the global state (under tensor parallelism or FSDP, gathered on
        # every process), whose params the rebuilt optimizer is made for
        full = step_fns["gather_state"](cur_state) if "gather_state" in step_fns else cur_state
        new_opt = lowrank_lib.rebuild_at_rank(old_opt, full.params, rank=new_rank,
                                              group_ranks=new_group_ranks)
        migrated = rank_schedule_lib.migrate_opt_state(old_opt, new_opt, full.opt_state)
        params = full.params if tp else cur_state.params
        del full
        adopt(new_opt)
        rank_to, _ = lowrank_lib.current_ranks(new_opt)
        history.append({"event": "rebucket", "step": float(s), "rank_from": float(rank_from),
                        "rank_to": float(rank_to)})
        return place(TrainState(params, migrated))

    guard = _PreemptionGuard(handle_signals)
    step = start_step
    final_step = train_cfg.total_steps
    # the newest checkpoint known to load (restored or pinned at the start):
    # named when the rollback budget runs out
    last_verified = start_step
    stale_action = recovery.stale_worker_action if recovery is not None else "log"
    try:
        while step < train_cfg.total_steps:
            try:
                if fault_plan is not None:
                    fault_plan.maybe_kill(step)  # injected process loss
                batch = data.batch_at(step)
                if batch_hook is not None:
                    batch = batch_hook(batch)
                if fault_plan is not None:
                    batch = fault_plan.batch_hook(batch, step)
                if heartbeats is not None:
                    heartbeats.beat(worker_name)
                    # every step: each newly stale worker is recorded with
                    # its first stale step and escalated per the policy
                    for w in heartbeats.check(step):
                        history.append({"event": "stale_worker", "worker": w,
                                        "step": float(step),
                                        "first_stale_step": float(heartbeats.first_stale[w]),
                                        "action": stale_action})
                        if stale_action == "abort":
                            raise RuntimeError(f"worker {w!r} heartbeat stale at step "
                                               f"{step}; aborting per policy")
                        if stale_action == "rollback":
                            raise recovery_lib.RollbackNeeded(step, f"stale worker {w!r}")
                monitor.start_step()
                if fault_plan is not None:
                    dt = fault_plan.sleep_s(step)
                    if dt > 0:
                        time.sleep(dt)  # straggler injection
                is_refresh = step % sub_tau == 0
                if is_refresh:
                    group = (step // sub_tau) % groups
                    if spectrum is not None:
                        spectrum.capture_before(state.params, group)
                    state, m = step_fns["refresh_step"](state, batch, group=group)
                else:
                    state, m = step_fns["step"](state, batch)
                del batch
                if fault_plan is not None:
                    m = fault_plan.loss_hook(step, m)
                pending.append((step, m, monitor.end_step(step)))
                if spectrum is not None and is_refresh:
                    rec = spectrum.observe(state.params, step, group)
                    if rec is not None and train_cfg.log_spectrum:
                        history.append(rec)
                if tracker is not None and is_refresh:
                    if tp:
                        tracker.observe(lowrank_lib.tp_global_projectors(
                            step_fns["optimizer"], state.opt_state))
                    else:
                        tracker.observe(metrics_lib.collect_projectors(
                            state.opt_state, optimizer.specs, layout=optimizer.state_layout))
                if fault_plan is not None and fault_plan.preempt(step):
                    guard.requested = True  # as if SIGTERM had come
                checkpoint_due = (train_cfg.checkpoint_every > 0
                                  and (step + 1) % train_cfg.checkpoint_every == 0)
                if (is_refresh or checkpoint_due or guard.requested
                        or step % log_every == 0 or step == train_cfg.total_steps - 1):
                    flush(state)
                if rank_sched is not None and is_refresh:
                    state = maybe_rebucket(state, step, group)
                if checkpoint_due:
                    safe_save(state, step + 1, blocking=not train_cfg.async_checkpoint)
                if guard.requested:
                    safe_save(state, step + 1, blocking=True)
                    final_step = step + 1
                    break
                step += 1
            except recovery_lib.RollbackNeeded as rb:
                attempt = monitor.rollbacks + 1
                if attempt > recovery.max_rollbacks:
                    raise FloatingPointError(
                        f"divergence persists after {recovery.max_rollbacks} rollbacks ({rb}); "
                        f"last verified step {last_verified}") from rb
                monitor.rollbacks = attempt
                backoff = recovery.backoff_s(attempt)
                if backoff > 0:
                    time.sleep(backoff)
                drain_save_error()  # never race a save in flight
                barrier(mesh)  # every process's save has landed
                state, ck_step = restore_latest(state)
                last_verified = ck_step
                if recovery.resample_on_rollback:
                    # the next refresh of sara, golore or grass draws another
                    # subspace instead of replaying the diverged one
                    state = TrainState(state.params,
                                       recovery_lib.resample_opt_state(state.opt_state, attempt))
                # cut the host records back to the checkpoint's step
                if ck_step <= loss_base:
                    losses.clear()
                    loss_base = ck_step
                else:
                    del losses[ck_step - loss_base:]
                history[:] = [r for r in history if r.get("step", -1.0) < ck_step]
                pending.clear()
                detector.reset()
                monitor.bad_loss_count = 0
                history.append({"event": "rollback", "step": float(ck_step),
                                "from_step": float(rb.step), "attempt": float(attempt),
                                "reason": rb.reason})
                step = ck_step
            except Exception as e:
                # a dead peer's collective, a failed kernel: say where
                e.add_note(f"[train] step {step} failed ({type(e).__name__}); a restart "
                           f"resumes from the newest checkpoint that verifies")
                raise
    finally:
        try:
            flush(state, swallow_aborts=True)
            drain_save_error()
        finally:
            guard.restore()
    return TrainResult(state=state, history=history, final_step=final_step, losses=losses,
                       subspace=tracker, checkpoints=manager, optimizer=optimizer)
