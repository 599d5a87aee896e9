"""The port's fault injection (``src/repro_torch/train/faults.py``) against
the JAX package's, on the CPU: ``FaultSpec`` validation and ``FaultPlan``'s
hooks on the same scripts (same ``fired`` log, same injected batches,
losses, sleeps, preemptions and kills), ``FaultyCheckpointIO`` corrupting
the same leaf file at the same offset with the same bytes (and truncating
the same manifest) for the same seed, on the same state written by both
packages (``get_config("llama3-8b", smoke=True)`` in f32, a fresh
``galore-sara-adam`` state carried across with ``bridge``), write errors
retried alike, and the shard kinds acting alike on the shard-parallel
format (the same shard file deleted or corrupted, the same manifest made
divergent).  Also the monitor's heartbeats and
watchdog on the same fake-clock scripts as JAX's, and the step's watchdog
hook."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.core import make_optimizer as jax_make_optimizer
from repro.models import build_model as jax_build_model
from repro.train import checkpoint as jax_ckpt
from repro.train import faults as jax_faults
from repro.train.state import TrainState as JaxTrainState
from repro_torch import bridge
from repro_torch.core import make_optimizer
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import faults
from repro_torch.train.state import TrainState

# One intra-op thread: the test workers share the host's cores, and the
# port's results do not depend on the thread count (core/svd.py).
torch.set_num_threads(1)

# ---------------------------------------------------------------------------
# specs and plans
# ---------------------------------------------------------------------------


def test_kinds_and_spec_validation_match_jax():
    assert faults.STEP_KINDS == jax_faults.STEP_KINDS
    assert faults.CKPT_KINDS == jax_faults.CKPT_KINDS
    assert faults.KINDS == jax_faults.KINDS
    bad = [dict(kind="meteor", step=1), dict(kind="nan_grads"), dict(kind="preempt", step=-2),
           dict(kind="ckpt_write_error"), dict(kind="ckpt_corrupt_leaf", step=3)]
    for kw in bad:
        for lib in (faults, jax_faults):
            with pytest.raises(ValueError):
                lib.FaultSpec(**kw)
    good = [dict(kind=k, step=2) for k in faults.STEP_KINDS] + [
        dict(kind=k, save_index=1, times=2) for k in faults.CKPT_KINDS]
    for kw in good:
        assert faults.FaultSpec(**kw) == faults.FaultSpec(**kw)
        a, b = faults.FaultSpec(**kw), jax_faults.FaultSpec(**kw)
        assert [getattr(a, f) for f in ("kind", "step", "save_index", "times")] == \
               [getattr(b, f) for f in ("kind", "step", "save_index", "times")]


SPECS = [
    dict(kind="nan_grads", step=1), dict(kind="inf_grads", step=2),
    dict(kind="inf_grads", step=1),  # both armed at step 1: nan wins, inf waits
    dict(kind="nan_loss", step=3, times=2), dict(kind="loss_spike", step=3, value=4.0),
    dict(kind="slow_step", step=4, value=0.25), dict(kind="preempt", step=5),
    dict(kind="kill_process", step=6),
]
# the loop's hook order, per step, twice over (budgets run out on the replay)
SCRIPT = [s for _ in range(2) for s in range(8)]


def _drive(lib):
    plan = lib.FaultPlan([lib.FaultSpec(**kw) for kw in SPECS], seed=5)
    out = []
    for step in SCRIPT:
        try:
            plan.maybe_kill(step)
            killed = False
        except lib.ProcessKilled:
            killed = True
        batch = plan.batch_hook({"tokens": np.zeros((2, 4), np.int32)}, step)
        scale = batch.get("grad_scale")
        m = plan.loss_hook(step, {"loss": np.float32(2.0)})
        out.append((step, killed, None if scale is None else str(scale), str(m["loss"]),
                    plan.sleep_s(step), plan.preempt(step)))
    return out, plan.fired


def test_plan_hooks_and_fired_log_match_jax():
    got, fired = _drive(faults)
    want, jfired = _drive(jax_faults)
    assert got == want and fired == jfired
    assert ("nan_grads", 1) in fired and ("kill_process", 6) in fired
    with pytest.raises(TypeError, match="dict batch"):
        faults.FaultPlan([faults.FaultSpec("nan_grads", step=0)]).batch_hook((1, 2), 0)


@pytest.mark.parametrize("kind", ["ckpt_missing_shard", "ckpt_corrupt_shard",
                                  "ckpt_divergent_manifest"])
def test_shard_kinds_are_accepted_and_raise_when_armed(kind, tmp_path):
    """Armed, each shard kind acts as JAX's on the shard-parallel format:
    the same shard file deleted or corrupted (same offset, same bytes) at
    the commit, the same shard manifest made divergent at its write."""
    for name, io in (("port", faults.FaultPlan([faults.FaultSpec(kind, save_index=0)])
                      .checkpoint_io()),
                     ("jax", jax_faults.FaultPlan([jax_faults.FaultSpec(kind, save_index=0)])
                      .checkpoint_io())):
        tmp = tmp_path / name / "step_00000001.tmp"
        tmp.mkdir(parents=True)
        data = np.random.default_rng(1).standard_normal(64).astype(np.float32)
        for f in ("a.s00000_of_00002.npy", "a.s00001_of_00002.npy", "b.npy"):
            np.save(tmp / f, data)
        io.begin(0, 0)
        for k in range(2):
            io.write_manifest(str(tmp / f"manifest.shard{k:05d}.json"),
                              {"step": 1, "num_shards": 2, "shard": k, "leaves": {}})
        io.commit(str(tmp), str(tmp_path / name / "step_00000001"))
        assert io.plan.fired == [(kind, 0)]
    port, jax_dir = tmp_path / "port" / "step_00000001", tmp_path / "jax" / "step_00000001"
    assert sorted(os.listdir(port)) == sorted(os.listdir(jax_dir))
    assert len(os.listdir(port)) == (4 if kind == "ckpt_missing_shard" else 5)
    for f in os.listdir(port):
        assert (port / f).read_bytes() == (jax_dir / f).read_bytes(), f


# ---------------------------------------------------------------------------
# checkpoint faults on the same state, written by both packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def states():
    jcfg = jax_get_config("llama3-8b", smoke=True).with_(dtype=jnp.float32)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    kw = dict(rank=8, svd_backend="randomized")
    jopt = jax_make_optimizer("galore-sara-adam", jparams, **kw)
    jstate = JaxTrainState(jparams, jopt.init(jparams))
    tparams = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    topt = make_optimizer("galore-sara-adam", tparams, **kw)
    tstate = TrainState(tparams, bridge.opt_state_from_numpy(
        topt, jax.tree_util.tree_map(np.asarray, jstate.opt_state), "cpu"))
    return jstate, tstate


def _save_both(states, tmp_path, specs, steps=(1,), seed=3):
    """Each package saves the state at ``steps`` through its faulty I/O;
    returns the two directories and the two plans."""
    jstate, tstate = states
    jplan = jax_faults.FaultPlan([jax_faults.FaultSpec(**kw) for kw in specs], seed=seed)
    tplan = faults.FaultPlan([faults.FaultSpec(**kw) for kw in specs], seed=seed)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jmgr = jax_ckpt.CheckpointManager(jdir, keep=5, io=jplan.checkpoint_io(),
                                      retry_backoff_s=0.0)
    tmgr = ckpt.CheckpointManager(tdir, keep=5, io=tplan.checkpoint_io(), retry_backoff_s=0.0)
    for s in steps:
        jmgr.save(jstate, s, blocking=True)
        tmgr.save(tstate, s, blocking=True)
    return jdir, tdir, jplan, tplan, jmgr, tmgr


def _files(cdir):
    return {f: open(os.path.join(cdir, f), "rb").read() for f in sorted(os.listdir(cdir))}


@pytest.mark.parametrize("seed", [3, 11])
def test_corrupt_leaf_hits_the_same_file_offset_and_bytes(states, tmp_path, seed):
    clean_j, clean_t, *_ = _save_both(states, tmp_path / "clean", [], steps=(1, 2))
    jdir, tdir, jplan, tplan, *_ = _save_both(
        states, tmp_path / "bad", [dict(kind="ckpt_corrupt_leaf", save_index=1)], steps=(1, 2),
        seed=seed)
    assert tplan.fired == jplan.fired == [("ckpt_corrupt_leaf", 1)]
    for step in (1, 2):
        sub = f"step_{step:08d}"
        tfiles, jfiles = _files(os.path.join(tdir, sub)), _files(os.path.join(jdir, sub))
        assert tfiles == jfiles  # the same bytes after the same corruption
        clean = _files(os.path.join(clean_t, sub))
        assert clean == _files(os.path.join(clean_j, sub))
        changed = [f for f in clean if clean[f] != tfiles[f]]
        assert len(changed) == (1 if step == 2 else 0), changed
        assert ckpt.verify_checkpoint(tdir, step) == (step == 1)
        assert jax_ckpt.verify_checkpoint(jdir, step) == (step == 1)


def test_truncated_manifest_and_write_errors_match_jax(states, tmp_path):
    specs = [dict(kind="ckpt_truncate_manifest", save_index=0),
             dict(kind="ckpt_write_error", save_index=1, times=2)]
    jdir, tdir, jplan, tplan, jmgr, tmgr = _save_both(states, tmp_path, specs, steps=(1, 2))
    assert tplan.fired == jplan.fired
    assert tplan.fired[0] == ("ckpt_truncate_manifest", 0) and len(tplan.fired) == 3
    assert tmgr.retries_performed == jmgr.retries_performed == 2
    for step, ok in ((1, False), (2, True)):
        sub = f"step_{step:08d}"
        assert _files(os.path.join(tdir, sub)) == _files(os.path.join(jdir, sub))
        assert ckpt.verify_checkpoint(tdir, step) == ok
    # the port's loader walks past the truncated manifest to nothing older
    with pytest.raises((OSError, ValueError, KeyError)):
        tmgr.load(states[1], step=1)
    # a budget past the retries fails the save, in both packages
    jdir, tdir, jplan, tplan, jmgr, tmgr = _save_both(
        states, tmp_path / "fail", [], steps=())
    for mgr, lib, state in ((tmgr, faults, states[1]), (jmgr, jax_faults, states[0])):
        mgr.io = lib.FaultPlan([lib.FaultSpec("ckpt_write_error", save_index=0,
                                              times=10)]).checkpoint_io()
        with pytest.raises(Exception, match="injected write error"):
            mgr.save(state, 1, blocking=True)


# ---------------------------------------------------------------------------
# heartbeats and the watchdog: the same scripts through both packages
# ---------------------------------------------------------------------------


def _heartbeat_script(lib):
    t = [0.0]
    hb = lib.HeartbeatRegistry(timeout_s=5.0, clock=lambda: t[0])
    out = []
    for step, (dt, beats) in enumerate([(0, "ab"), (3, "a"), (3, "a"), (1, ""), (4, "ab"),
                                        (6, ""), (1, "b"), (9, "a")]):
        t[0] += dt
        for w in beats:
            hb.beat(w)
        out.append((hb.check(step), sorted(hb.stale()), hb.healthy()))
    return out, hb.first_stale


def _watchdog_script(lib):
    t = [0.0]
    seen = []
    wd = lib.CollectiveWatchdog(timeout_s=2.0, on_timeout=lambda s, dt: seen.append((s, dt)),
                                clock=lambda: t[0])

    def block(result):
        t[0] += result  # the fake card takes ``result`` seconds

    wd._block = block
    for step, secs in enumerate((0.5, 3.0, 1.9, 7.5)):
        assert wd.guard(step, secs) == secs
    return wd.fired, seen


def test_heartbeats_and_watchdog_match_jax():
    from repro.train import monitor as jax_monitor
    from repro_torch.train import monitor

    assert _heartbeat_script(monitor) == _heartbeat_script(jax_monitor)
    assert _watchdog_script(monitor) == _watchdog_script(jax_monitor)
    # a wait that hangs past the timeout escalates from the timer thread
    import threading
    import time

    release, seen = threading.Event(), []
    wd = monitor.CollectiveWatchdog(timeout_s=0.05, on_timeout=lambda s, dt: (seen.append(s),
                                                                              release.set()))
    wd._block = lambda result: release.wait(5.0)
    t0 = time.monotonic()
    wd.guard(7, None)
    assert seen == [7] and wd.fired[0][0] == 7 and time.monotonic() - t0 < 4.0
    # on the CPU a result is ready as it comes: no firing
    wd = monitor.CollectiveWatchdog(timeout_s=60.0)
    assert wd.guard(0, ({"w": torch.zeros(2)}, {"loss": torch.ones(())})) is not None
    assert wd.fired == []


def test_step_watchdog_guards_each_call():
    """``make_train_step(watchdog=)`` guards each step's result, each step
    kind counting its own calls, as JAX's jitted steps do."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import SyntheticDataConfig, SyntheticDataset
    from repro_torch.models import build_model
    from repro_torch.train.monitor import CollectiveWatchdog
    from repro_torch.train.step import make_train_step

    class Recording(CollectiveWatchdog):
        def __init__(self):
            super().__init__(timeout_s=60.0)
            self.calls = []

        def guard(self, step, result):
            self.calls.append(step)
            return super().guard(step, result)

    wd = Recording()
    cfg = get_config("llama3-8b", smoke=True).with_(dtype=torch.float32)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    opt = make_optimizer("galore-sara-adam", params, rank=8)
    fns = make_train_step(model, opt, watchdog=wd)
    state = TrainState(params, opt.init(params))
    batch = SyntheticDataset(SyntheticDataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                                 global_batch=2), device="cpu").batch_at(0)
    state, _ = fns["refresh_step"](state, batch)
    for _ in range(2):
        state, _ = fns["step"](state, batch)
    assert wd.calls == [0, 0, 1] and fns["watchdog"] is wd
    assert fns["rebuild"](opt)["watchdog"] is wd
