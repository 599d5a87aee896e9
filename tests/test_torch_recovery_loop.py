"""The fault matrix of tests/test_faults_and_recovery.py through both
packages' training loops with the same ``FaultPlan``, on the CPU: no fault,
non-finite gradients (skip-step), a non-finite loss streak (rollback and
resample, the budget running out), corrupt checkpoints (the rollback's and
the restart's fallback), write errors (retried, lost, lost in the
background), preemption and resume, a slow step with heartbeats, and an
injected process loss followed by a restart from the last committed
checkpoint.  (The zero-sharded lockstep case needs a world of processes:
``test_torch_distributed.py`` and ``test_torch_multihost.py`` run it.)

Each case checks the same ``fired`` list, the same recovery events and
counters, losses to 1e-6 and the final params within
``test_torch_resume.py::HOT_LOOP_TOL``.  The runs train ``grass-adam``
(``get_config("llama3-8b", smoke=True)`` in f32, rank 8, seq 16, batch 2,
tau 4: refreshes at steps 0 and 4, 8 steps): grass's refresh is a
Gumbel-top-k row selection, stochastic as the resample needs, with no
factorization whose LAPACK rounding would part the packages at each
refresh.  The paper's method, ``galore-sara-adam``, takes the rollback
case too: its SVD parts the packages by a few 1e-6 over the run (ROADMAP
queue 3), so its losses and params are held to ``REFRESH_TOL``, and its
fired list, events and counters exactly.  The port takes JAX's draws
(``JaxDraws``), whose ``resample`` applies JAX's fold-in, so both draw
the same subspace after a rollback.

One case is the port's alone: a background save that fails while a
re-bucket waits for it is counted under recovery, where the reference's
loop ends the run (ROADMAP queue 3).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.configs.registry import get_config as jax_get_config
from repro.core import make_optimizer as jax_make_optimizer
from repro.data.synthetic import SyntheticDataConfig, SyntheticDataset
from repro.models import build_model as jax_build_model
from repro.train.faults import FaultPlan as JaxFaultPlan
from repro.train.faults import FaultSpec as JaxFaultSpec
from repro.train.loop import train_loop as jax_train_loop
from repro.train.monitor import HeartbeatRegistry as JaxHeartbeats
from repro.train.recovery import RecoveryPolicy as JaxPolicy
from repro.train.state import TrainState as JaxTrainState
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch import bridge
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import make_optimizer
from repro_torch.models import build_model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.faults import FaultPlan, FaultSpec, ProcessKilled
from repro_torch.train.loop import train_loop
from repro_torch.train.monitor import HeartbeatRegistry
from repro_torch.train.recovery import RecoveryPolicy
from repro_torch.train.state import TrainState
from repro_torch.train.step import make_train_step
from test_torch_optim_kernels import JaxDraws
from test_torch_resume import _assert_step_close
from test_torch_train import REFRESH_TOL, _SharedData

# One intra-op thread: the test workers share the host's cores, and the
# port's results do not depend on the thread count (core/svd.py).
torch.set_num_threads(1)

STEPS = 8
KW = dict(rank=8, tau=4, lr=2e-3, engine="bucketed", svd_backend="randomized",
          momentum_carry="reproject")
COUNTERS = ("skip_steps", "rollbacks", "save_retries", "save_failures")


class GrassDraws(JaxDraws):
    default_method = "grass"


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jcfg = jax_get_config("llama3-8b", smoke=True).with_(dtype=jnp.float32)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    data = SyntheticDataset(SyntheticDataConfig(vocab_size=jcfg.vocab_size, seq_len=16,
                                                global_batch=2))
    batches = [data.batch_at(i) for i in range(STEPS)]
    tmodel = build_model(get_config("llama3-8b", smoke=True).with_(dtype=torch.float32),
                         device="cpu")
    tparams = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    setup = dict(jmodel=jmodel, jparams=jparams, batches=batches, tmodel=tmodel,
                 tparams=tparams, clean=[], base=tmp_path_factory.mktemp("clean"))
    _method(setup, "grass")
    return setup


def _method(setup, method):
    """Both packages' ``{method}-adam`` optimizers and steps, built once per
    module: ``(jax optimizer, jax steps, port optimizer, port steps by
    recovery on/off)``."""
    if method not in setup:
        name = f"{method}-adam" if method == "grass" else f"galore-{method}-adam"
        jopt = jax_make_optimizer(name, setup["jparams"], **KW)
        topt = make_optimizer(name, setup["tparams"], **KW)
        setup[method] = (
            jopt, jax_make_train_step(setup["jmodel"], jopt, donate=False, recovery=JaxPolicy()),
            topt, {rec: make_train_step(setup["tmodel"], topt,
                                        recovery=RecoveryPolicy() if rec else None)
                   for rec in (True, False)})
    return setup[method]


class _JaxData:
    def __init__(self, batches):
        self.batches = batches

    def batch_at(self, step):
        return self.batches[step]


def _tcs(tmp_path, name, **kw):
    kw.setdefault("total_steps", STEPS)
    kw.setdefault("checkpoint_every", 0)
    kw.setdefault("async_checkpoint", False)
    kw.setdefault("keep_checkpoints", 5)
    jtc = JaxTrainConfig(lr=2e-3, checkpoint_dir=str(tmp_path / f"{name}_jax"), **kw)
    ttc = TrainConfig(checkpoint_dir=str(tmp_path / f"{name}_port"), **kw)
    return jtc, ttc


def _jax_run(setup, jtc, *, specs=None, policy=None, method="grass", **kw):
    """JAX's loop under ``RecoveryPolicy(**policy)`` (one compiled step, so
    every JAX run here recovers)."""
    plan = JaxFaultPlan([JaxFaultSpec(**s) for s in specs]) if specs is not None else None
    jopt, jfns = _method(setup, method)[:2]
    res = jax_train_loop(
        setup["jmodel"], jopt, _JaxData(setup["batches"]), jtc, jfns,
        state=JaxTrainState(setup["jparams"], jopt.init(setup["jparams"])),
        log_every=1, handle_signals=False, recovery=JaxPolicy(**(policy or {})),
        fault_plan=plan, **kw)
    return res, plan


def _port_run(setup, ttc, *, specs=None, recovery=True, policy=None, method="grass", **kw):
    plan = FaultPlan([FaultSpec(**s) for s in specs]) if specs is not None else None
    tparams = setup["tparams"]
    topt, tfns = _method(setup, method)[2:]
    key = jax.random.PRNGKey(0)  # the optimizer's seed: JAX's fresh key
    draws = GrassDraws(key) if method == "grass" else JaxDraws(key)
    state = TrainState(tparams, topt.init(tparams)._replace(draws=draws))
    res = train_loop(setup["tmodel"], topt, _SharedData(setup["batches"]), ttc,
                     tfns[recovery], state=state, log_every=1, handle_signals=False,
                     recovery=RecoveryPolicy(**(policy or {})) if recovery else None,
                     fault_plan=plan, **kw)
    return res, plan


def _clean(setup):
    """The fault-free recovery run of each package (an empty plan), once
    per module: ``(jax result, port result)``."""
    if not setup["clean"]:
        jtc, ttc = _tcs(setup["base"], "clean")
        setup["clean"].extend([_jax_run(setup, jtc, specs=[])[0],
                               _port_run(setup, ttc, specs=[])[0]])
    return setup["clean"]


def _events(res):
    """The recovery events, without their error texts (exception reprs)."""
    return [{k: v for k, v in r.items() if k != "error"} for r in res.history if "event" in r]


def _last(res):
    return [r for r in res.history if "skip_steps" in r][-1]


def _assert_same(jres, tres, jplan=None, tplan=None, counters=True, kind="hot"):
    """Same fired list, events, counters and final step; losses to 1e-6
    and final params within HOT_LOOP_TOL (``kind="refresh"``: both to
    REFRESH_TOL)."""
    if jplan is not None:
        assert tplan.fired == jplan.fired
    assert _events(tres) == _events(jres)
    if counters:
        assert [_last(tres)[c] for c in COUNTERS] == [_last(jres)[c] for c in COUNTERS]
    assert tres.final_step == jres.final_step
    assert len(tres.losses) == len(jres.losses)
    tol = dict(rtol=1e-6) if kind == "hot" else REFRESH_TOL
    np.testing.assert_allclose(tres.losses, jres.losses, **tol)
    jp = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jres.state.params), "cpu")
    _assert_step_close(tres.state.params, jp, kind)
    assert tres.state.step == int(jres.state.opt_state.step)


# ---------------------------------------------------------------------------
# no fault; non-finite gradients
# ---------------------------------------------------------------------------


def test_no_fault_is_quiet_and_matches_jax(setup, tmp_path):
    jres, tres = _clean(setup)
    _assert_same(jres, tres)
    assert _events(tres) == [] and [_last(tres)[c] for c in COUNTERS] == [0.0] * 4
    # the gate changes nothing: the port's gated good step is its ungated
    # step, so even the run without recovery is bit-identical (JAX's
    # compiled gate agrees only to rounding)
    assert _port_run(setup, _tcs(tmp_path, "plain")[1], recovery=False)[0].losses == tres.losses


def test_nonfinite_grads_skip_the_update(setup, tmp_path):
    specs = [dict(kind="nan_grads", step=3), dict(kind="inf_grads", step=5)]
    jtc, ttc = _tcs(tmp_path, "skip")
    jres, jplan = _jax_run(setup, jtc, specs=specs)
    tres, tplan = _port_run(setup, ttc, specs=specs)
    _assert_same(jres, tres, jplan, tplan)
    assert tplan.fired == [("nan_grads", 3), ("inf_grads", 5)]
    assert np.isfinite(tres.losses).all()
    assert _last(tres)["skip_steps"] == 2.0 and _last(tres)["rollbacks"] == 0.0
    assert tres.state.step == STEPS - 2  # the optimizer step stalls on a skip
    skipped = [r["step"] for r in tres.history if r.get("skipped") == 1.0]
    assert skipped == [3.0, 5.0]
    # the skipped step is a true no-op on everything before it
    clean = _clean(setup)[1]
    assert tres.losses[:4] == clean.losses[:4]
    assert tres.losses[4:] != clean.losses[4:]


# ---------------------------------------------------------------------------
# non-finite loss streak: rollback and resample
# ---------------------------------------------------------------------------

NAN_STREAK = [dict(kind="nan_loss", step=s) for s in (5, 6, 7)]


def test_nan_loss_streak_rolls_back_and_resamples(setup, tmp_path):
    jtc, ttc = _tcs(tmp_path, "roll", checkpoint_every=4)
    jres, jplan = _jax_run(setup, jtc, specs=NAN_STREAK)
    tres, tplan = _port_run(setup, ttc, specs=NAN_STREAK)
    _assert_same(jres, tres, jplan, tplan)
    (ev,) = [r for r in tres.history if r.get("event") == "rollback"]
    # checkpoints at 0 (pinned) and 4; the streak trips at step 7 -> 4
    assert (ev["step"], ev["from_step"], ev["attempt"]) == (4.0, 7.0, 1.0)
    assert len(tres.losses) == STEPS and np.isfinite(tres.losses).all()
    assert _last(tres)["rollbacks"] == 1.0
    # the replayed step 4 refreshes from the resampled source: the prefix
    # is the clean run's, and the trajectory then leaves it
    clean = _clean(setup)[1]
    assert tres.losses[:5] == clean.losses[:5]
    assert tres.losses[5:] != clean.losses[5:]


def test_sara_nan_loss_streak_rolls_back_and_resamples(setup, tmp_path):
    """The paper's method through the same rollback: the replayed step-4
    refresh draws from JAX's resampled key in both packages, and leaves the
    subspace the run without resample replays."""
    jtc, ttc = _tcs(tmp_path, "sara_roll", checkpoint_every=4)
    jres, jplan = _jax_run(setup, jtc, specs=NAN_STREAK, method="sara")
    tres, tplan = _port_run(setup, ttc, specs=NAN_STREAK, method="sara")
    _assert_same(jres, tres, jplan, tplan, kind="refresh")
    assert tplan.fired == [("nan_loss", s) for s in (5, 6, 7)]
    (ev,) = [r for r in tres.history if r.get("event") == "rollback"]
    assert (ev["step"], ev["from_step"], ev["attempt"]) == (4.0, 7.0, 1.0)
    assert [_last(tres)[c] for c in COUNTERS] == [0.0, 1.0, 0.0, 0.0]
    assert len(tres.losses) == STEPS and np.isfinite(tres.losses).all()
    _, tnr = _tcs(tmp_path, "sara_replay", checkpoint_every=4)
    replay, _ = _port_run(setup, tnr, specs=NAN_STREAK, method="sara",
                          policy=dict(resample_on_rollback=False))
    assert tres.losses[:5] == replay.losses[:5]
    assert tres.losses[5:] != replay.losses[5:]


def test_rollback_budget_exhausted_aborts(setup, tmp_path):
    specs = [dict(kind="nan_loss", step=s, times=2) for s in (2, 3, 4)]
    jtc, ttc = _tcs(tmp_path, "budget")
    msgs = []
    for run, tc in ((_jax_run, jtc), (_port_run, ttc)):
        with pytest.raises(FloatingPointError, match="rollback") as e:
            run(setup, tc, specs=specs, policy=dict(max_rollbacks=1))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# corrupt checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["ckpt_corrupt_leaf", "ckpt_truncate_manifest"])
def test_rollback_falls_back_past_corrupt_checkpoint(setup, tmp_path, kind):
    # save ordinal 2 is the step-4 checkpoint (0: the pin, 1: step 2)
    specs = [dict(kind=kind, save_index=2)] + [dict(kind="nan_loss", step=s) for s in (4, 5)]
    jtc, ttc = _tcs(tmp_path, f"fb_{kind}", checkpoint_every=2)
    pol = dict(max_bad_steps=2)
    jres, jplan = _jax_run(setup, jtc, specs=specs, policy=pol)
    tres, tplan = _port_run(setup, ttc, specs=specs, policy=pol)
    _assert_same(jres, tres, jplan, tplan)
    assert (kind, 2) in tplan.fired and ("nan_loss", 5) in tplan.fired
    (ev,) = [r for r in tres.history if r.get("event") == "rollback"]
    assert ev["step"] == 2.0  # step 4's checkpoint does not verify
    assert len(tres.losses) == STEPS and np.isfinite(tres.losses).all()
    assert ckpt.verify_checkpoint(ttc.checkpoint_dir, 4)  # re-saved on the replay


def test_resume_from_corrupt_newest_checkpoint(setup, tmp_path):
    """A restart walks past a corrupt newest checkpoint, and the resumed
    trajectory is the uninterrupted one, in both packages."""
    jtc, ttc = _tcs(tmp_path, "boot", checkpoint_every=4)
    out = []
    for run, tc in ((_jax_run, jtc), (_port_run, ttc)):
        first, _ = run(setup, tc)
        cdir = os.path.join(tc.checkpoint_dir, "step_00000008")
        victim = sorted(f for f in os.listdir(cdir) if f.endswith(".npy"))[0]
        with open(os.path.join(cdir, victim), "r+b") as f:
            f.seek(64)
            f.write(b"\xff" * 16)
        again, _ = run(setup, tc)  # 8 is corrupt -> resumes at 4
        assert again.losses == first.losses[4:]
        out.append(again)
    np.testing.assert_allclose(out[1].losses, out[0].losses, rtol=1e-6)


# ---------------------------------------------------------------------------
# checkpoint write failures
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("times,async_ckpt", [(1, False), (10, False), (10, True)])
def test_save_write_errors(setup, tmp_path, times, async_ckpt):
    """Retried once (times=1), or lost past the retries (times=10), also on
    the background thread: counted, never an abort; later saves land."""
    specs = [dict(kind="ckpt_write_error", save_index=1, times=times)]
    jtc, ttc = _tcs(tmp_path, f"save_{times}_{async_ckpt}", checkpoint_every=4,
                    async_checkpoint=async_ckpt)
    jres, jplan = _jax_run(setup, jtc, specs=specs)
    tres, tplan = _port_run(setup, ttc, specs=specs)
    # a background write's retries land in the counters whenever its thread
    # gets to them: the async case compares events, not counters
    _assert_same(jres, tres, jplan, tplan, counters=not async_ckpt)
    last = _last(tres)
    lost = times > 1
    if not async_ckpt:
        assert last["save_retries"] >= 1.0 and (last["save_failures"] >= 1.0) == lost
    assert bool([r for r in tres.history if r.get("event") == "save_failed"]) == lost
    assert os.path.isdir(os.path.join(ttc.checkpoint_dir, "step_00000004")) != lost
    assert ckpt.verify_checkpoint(ttc.checkpoint_dir, 8)


# ---------------------------------------------------------------------------
# preemption, a slow step and heartbeats, a lost process
# ---------------------------------------------------------------------------


def test_preemption_checkpoint_and_resume(setup, tmp_path):
    jclean = _clean(setup)[0]
    specs = [dict(kind="preempt", step=6)]
    jtc, ttc = _tcs(tmp_path, "pre", checkpoint_every=4)
    j1, jplan = _jax_run(setup, jtc, specs=specs)
    t1, tplan = _port_run(setup, ttc, specs=specs)
    assert t1.final_step == j1.final_step == 7 and tplan.fired == jplan.fired == [("preempt", 6)]
    assert ckpt.latest_step(ttc.checkpoint_dir) == 7
    t2, _ = _port_run(setup, ttc)  # resumes to the end
    j2, _ = _jax_run(setup, jtc)
    _assert_same(j2, t2)
    np.testing.assert_allclose(t1.losses + t2.losses, jclean.losses, rtol=1e-6)


def test_slow_step_and_heartbeat(setup, tmp_path):
    specs = [dict(kind="slow_step", step=3, value=0.2)]
    jtc, ttc = _tcs(tmp_path, "slow", total_steps=4)
    jhb, thb = JaxHeartbeats(timeout_s=60.0), HeartbeatRegistry(timeout_s=60.0)
    jres, jplan = _jax_run(setup, jtc, specs=specs, heartbeats=jhb, worker_name="w0")
    tres, tplan = _port_run(setup, ttc, specs=specs, heartbeats=thb, worker_name="w0")
    _assert_same(jres, tres, jplan, tplan)
    assert tplan.fired == [("slow_step", 3)] and thb.stale() == [] == jhb.stale()
    assert _last(tres)["stale_workers"] == 0.0
    rec3 = [r for r in tres.history if r.get("step") == 3.0 and "event" not in r][0]
    assert rec3["step_time_s"] >= 0.2


def test_stale_heartbeat_escalates_per_policy(setup, tmp_path):
    """A worker that stops beating escalates once per stale episode: a
    record under ``log``, a rollback under ``rollback``, an abort under
    ``abort`` -- in both packages, on a fake clock of 3 s a step."""
    for action in ("log", "rollback", "abort"):
        outs = []
        tcs = _tcs(tmp_path, f"stale_{action}", total_steps=4)
        for run, lib, tc in ((_jax_run, JaxHeartbeats, tcs[0]),
                             (_port_run, HeartbeatRegistry, tcs[1])):
            t = [0.0]
            hb = lib(timeout_s=5.0, clock=lambda t=t: t[0])
            hb.beat("w1")  # a second worker, beating once

            def hook(batch, t=t):
                t[0] += 3.0
                return batch

            try:
                res, _ = run(setup, tc, heartbeats=hb, batch_hook=hook,
                             policy=dict(stale_worker_action=action))
                outs.append(res)
            except RuntimeError as e:
                outs.append(str(e))
            assert hb.first_stale == {"w1": 1}
        if action == "abort":
            assert outs[0] == outs[1] and "aborting per policy" in outs[1]
            continue
        _assert_same(outs[0], outs[1])
        evs = _events(outs[1])
        if action == "log":
            assert [r["event"] for r in evs] == ["stale_worker"]
        else:  # the stale record belongs to the abandoned steps, as in JAX
            assert [(r["event"], r["reason"]) for r in evs] == [("rollback", "stale worker 'w1'")]


def test_process_killed_then_restart_resumes_from_last_commit(setup, tmp_path):
    """``ProcessKilled`` goes through the loop uncaught; a restart in the
    same process resumes from the last committed checkpoint and replays
    the uninterrupted run bit for bit (and meets JAX's)."""
    jclean, tclean = _clean(setup)
    _, ttc = _tcs(tmp_path, "kill", checkpoint_every=4)
    with pytest.raises(ProcessKilled, match="step 6"):
        _port_run(setup, ttc, specs=[dict(kind="kill_process", step=6)])
    assert ckpt.checkpoint_dirs(ttc.checkpoint_dir) == [0, 4]
    again, _ = _port_run(setup, ttc)
    assert again.checkpoints.last_load["step"] == 4
    assert again.losses == tclean.losses[4:]
    np.testing.assert_allclose(again.losses, jclean.losses[4:], rtol=1e-6)


def test_save_failure_in_flight_at_a_rebucket_is_counted(setup, tmp_path):
    """A background save that fails while a re-bucket waits for it (the
    save of step 4, in flight when the step-4 refresh halves the rank) is
    a ``save_failed`` event under recovery, not the end of the run; the
    run is the fault-free one's, bit for bit."""
    opt = make_optimizer("grass-adam", setup["tparams"], **dict(KW, rank=16, rank_schedule="step:16:8"))
    policy = RecoveryPolicy()
    fns = make_train_step(setup["tmodel"], opt, recovery=policy)
    runs = []
    for name, specs in (("fault", [dict(kind="ckpt_write_error", save_index=1, times=10)]),
                        ("none", [])):
        _, ttc = _tcs(tmp_path, f"rebucket_{name}", checkpoint_every=4, async_checkpoint=True)
        plan = FaultPlan([FaultSpec(**s) for s in specs])
        state = TrainState(setup["tparams"], opt.init(setup["tparams"]))
        runs.append(train_loop(setup["tmodel"], opt, _SharedData(setup["batches"]), ttc, fns,
                               state=state, log_every=1, handle_signals=False,
                               recovery=policy, fault_plan=plan))
        if specs:
            assert plan.fired == [("ckpt_write_error", 1)] * 3  # the save and its 2 retries
    bad, good = runs
    rebucket = [(4.0, 16.0, 8.0)]
    for res in runs:
        assert [(r["step"], r["rank_from"], r["rank_to"]) for r in res.history
                if r.get("event") == "rebucket"] == rebucket
    assert [r["event"] for r in bad.history if "event" in r] == ["save_failed", "rebucket"]
    assert _last(bad)["save_failures"] == 1.0 and _last(good)["save_failures"] == 0.0
    assert bad.final_step == good.final_step == STEPS and bad.losses == good.losses
    assert ckpt.checkpoint_dirs(bad.checkpoints.base_dir) == [0, 8]
    for (_, a), (_, b) in zip(ckpt.tree_items(bad.state), ckpt.tree_items(good.state)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
