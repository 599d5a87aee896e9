"""The port's multi-process fault harness: a real process loss in a spawned
gloo world, the restart from the newest verified shard-parallel checkpoint,
a lockstep rollback, and an elastic resume at another shard count.  It
mirrors ``tests/test_multihost_recovery.py::
test_fault_matrix_and_elastic_resume_on_8_devices`` step for step, with its
setup: the smoke llama in f32 at 2 layers, seq 32, global batch 8,
``galore-sara-adam`` at rank 8, tau 4, lr 1e-3 on the bucketed engine with
the randomized SVD, the compressed ``"flat"`` step with ZeRO state over
``data``, checkpoints every 4 steps, 16 steps.

The world is (2, 2) (data, model): four processes, ZeRO state at 2
shards, resumed at 1.  JAX's test runs (4, 2) -> (2, 4) on 8 forced host
devices; eight processes would take this file past its time budget on the
suite's shared cores, and JAX's own test fails on this tree's jax
(ROADMAP queue 3), so the world is held to JAX's single-process run:

  * **Phase 1.**  ``slow_step`` at 5, ``ckpt_corrupt_shard`` on the step-8
    save (save ordinal 2: ordinal 0 is the pinned step-0 checkpoint) and
    ``kill_process`` at step 9 on rank 3 only.  Rank 3 leaves ``train_loop``
    with ``ProcessKilled``; ranks 0-2 fail in their next collective, each
    with a note naming step 9, and all exit non-zero within ``EXIT_BAR_S``
    of rank 3's death -- well inside the 60-s group timeout.  The fired
    sets, joined over the ranks, are JAX's; checkpoint 8 fails
    verification and checkpoint 4 passes.
  * **Phase 2.**  The same world again resumes at step 4 (walking past the
    corrupt step 8); NaN gradients at steps 10-12 on rank 1 only make every
    process skip (the summed verdict), and the third skip rolls every rank
    back once, with the reason "cross-process bad-step verdict".  The run
    ends at step 16 in the shard-parallel format, and the watchdog fired
    nothing.
  * **Phase 3.**  One process loads step 16 at 1 shard: the canonical state
    is bit-equal to a load of the replicated save rank 0 wrote from its
    gathered final state, and one compressed step on the reshaped (1, 1)
    mesh has a finite loss.
  * **Against JAX.**  The world starts from JAX's params on JAX's batches
    with JAX's draws for the first refresh (``FirstDraws``), so its losses
    before the first fault (steps 0-4) equal JAX's single-process run to
    ``LOSS_TOL``, ``test_torch_distributed.py``'s loss bar.

The launcher: two ``launch/train.py`` processes on a ``file://`` store
with the heartbeat flags finish and print the stale-worker count.

Rules of the spawned worlds, as ``test_torch_distributed.py``'s: a
``file://`` store under the test's temporary directory, one intra-op
thread per process, a 60-s timeout on the process group.  The processes
are started one by one (not ``mp.spawn``, which kills the others when one
fails: here one must die and the others must see it).  This module
imports JAX only inside the parent's fixture, so the processes do not.
"""
import json
import os
import subprocess
import sys
import time
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import bridge
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import make_optimizer
from repro_torch.core.lowrank import TorchDraws, state_tensors, tree_leaves
from repro_torch.core.projectors import LeafDraws
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import build_model
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import state as state_lib
from repro_torch.train.faults import FaultPlan, FaultSpec, ProcessKilled
from repro_torch.train.loop import train_loop
from repro_torch.train.monitor import CollectiveWatchdog
from repro_torch.train.recovery import RecoveryPolicy
from repro_torch.train.state import TrainState
from repro_torch.train.step import make_train_step

# One intra-op thread: the test workers share the host's cores, and the
# port's results do not depend on the thread count (core/svd.py).
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOMETRY = (2, 2)  # (data, model)
WORLD = GEOMETRY[0] * GEOMETRY[1]
SHARDS, NEW_SHARDS = GEOMETRY[0], 1
KILLED, NAN_RANK = WORLD - 1, 1
STEPS, EVERY, SEQ, BATCH, LAYERS = 16, 4, 32, 8, 2
OPT_KW = dict(rank=8, tau=4, lr=1e-3, svd_backend="randomized", engine="bucketed")
TIMEOUT = timedelta(seconds=60)
WORLD_TIMEOUT_S = 240  # a world that runs past this failed (its ranks are killed)
EXIT_BAR_S = 20.0  # the survivors end this soon after the killed rank
LOSS_TOL = 1e-4  # test_torch_distributed.ROLLBACK_LOSS_TOL
JAX_FIRED_1 = {("slow_step", 5), ("ckpt_corrupt_shard", 2), ("kill_process", 9)}


# ---------------------------------------------------------------------------
# the processes' side
# ---------------------------------------------------------------------------


class FirstDraws(TorchDraws):
    """JAX's draws for the first refresh (the parent's, in ``recorded``), the
    port's own after it.  The world's losses up to its second refresh are
    then JAX's, and the source keeps ``TorchDraws``' two-word key, so the
    checkpoints carry it."""

    recorded: dict = {}

    def split(self):
        return FirstDraws(self.seed, self.device, self.refreshes + 1)

    def resample(self, attempt):
        t = super().resample(attempt)
        return FirstDraws(t.seed, t.device, t.refreshes)

    def leaf(self, leaf_idx, batch_shape, shapes, device=None):
        if self.refreshes == 1 and leaf_idx in self.recorded:
            return LeafDraws(*(None if x is None else torch.from_numpy(x)
                               for x in self.recorded[leaf_idx]))
        return super().leaf(leaf_idx, batch_shape, shapes, device)


class RecordedData:
    """JAX's batches, step by step."""

    def __init__(self, batches):
        self.batches = batches

    def batch_at(self, step):
        return {k: torch.from_numpy(v) for k, v in self.batches[step].items()}


def _cfg():
    return get_config("llama3-8b", smoke=True).with_(dtype=torch.float32, n_layers=LAYERS)


def _setup(base):
    """The model, JAX's params, JAX's batches, and the global optimizer."""
    ref = torch.load(os.path.join(base, "jax.pt"), weights_only=False)
    FirstDraws.recorded = ref["draws"]
    model = build_model(_cfg(), device="cpu")
    params = bridge.params_from_numpy(ref["params"], "cpu")
    opt = make_optimizer("galore-sara-adam", params, state_sharding="zero",
                         state_shards=SHARDS, **OPT_KW)
    return model, params, RecordedData(ref["batches"]), opt


def _copy(tree):
    return {k: _copy(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _fresh(opt, params):
    """A fresh state on a copy of ``params``, drawing through ``FirstDraws``."""
    st = opt.init(params)
    d = st.draws
    return TrainState(_copy(params), st._replace(draws=FirstDraws(d.seed, d.device,
                                                                  d.refreshes)))


def _recording(fns, losses):
    """The step functions, each call's loss appended to ``losses``."""
    out = dict(fns)
    for name in ("step", "refresh_step"):
        def run(*a, _fn=fns[name], **k):
            st, m = _fn(*a, **k)
            losses.append(float(m["loss"]))
            return st, m
        out[name] = run
    return out


def _phase1(rank, model, params, data, opt, fns, wd, base, rec):
    # the lockstep verdict: a NaN in one process's share is every process's
    st = fns["place_state"](_fresh(opt, params))
    _, m1 = fns["step"](st, data.batch_at(0))
    bad = data.batch_at(0)
    if rank == NAN_RANK:
        bad["grad_scale"] = np.float32("nan")
    st = fns["place_state"](_fresh(opt, params))
    _, m2 = fns["step"](st, bad)
    rec["verdict"] = (float(m1["bad_step"]), float(m2["bad_step"]))
    tc = TrainConfig(total_steps=STEPS, checkpoint_every=EVERY,
                     async_checkpoint=False, checkpoint_dir=os.path.join(base, "ck"))
    plan = FaultPlan([FaultSpec("slow_step", step=5, value=0.3),
                      FaultSpec("ckpt_corrupt_shard", save_index=2)]  # the step-8 save
                     + ([FaultSpec("kill_process", step=9)] if rank == KILLED else []))
    rec["plan"] = plan
    rec["losses"] = []
    train_loop(model, opt, data, tc, _recording(fns, rec["losses"]),
               state=fns["place_state"](_fresh(opt, params)), log_every=1,
               handle_signals=False, recovery=RecoveryPolicy(), fault_plan=plan)


def _phase2(rank, model, params, data, opt, fns, wd, base, rec):
    ckdir = os.path.join(base, "ck")
    tc = TrainConfig(total_steps=STEPS, checkpoint_every=EVERY,
                     async_checkpoint=False, checkpoint_dir=ckdir)
    plan = FaultPlan([FaultSpec("nan_grads", step=s) for s in (10, 11, 12)]
                     if rank == NAN_RANK else [])
    res = train_loop(model, opt, data, tc, fns, state=fns["place_state"](_fresh(opt, params)),
                     log_every=1, handle_signals=False, recovery=RecoveryPolicy(),
                     fault_plan=plan)
    # the other writers leave the loop before the coordinator commits
    mesh_lib.barrier(fns["mesh"])
    rec.update(final_step=res.final_step, losses=res.losses,
               first_step=min(r["step"] for r in res.history if "loss" in r),
               rollbacks=[r for r in res.history if r.get("event") == "rollback"],
               skips=[r["skip_steps"] for r in res.history if "skip_steps" in r][-1],
               latest=ckpt_lib.latest_step(ckdir), watchdog=list(wd.fired),
               fallbacks=list(res.checkpoints.fallbacks))
    with open(os.path.join(ckdir, "step_00000016", "manifest.json")) as f:
        rec["format"] = json.load(f)["format"]
    full = fns["gather_state"](res.state)  # every process joins the gather
    if rank == 0:
        canon, loc = state_lib.checkpoint_converters(opt)
        ckpt_lib.CheckpointManager(os.path.join(base, "replicated"), canonicalize=canon,
                                   localize=loc).save(full, STEPS)
    mesh_lib.barrier(fns["mesh"])


def _rank_main(rank, store, base, phase):
    """One process of the world.  It saves what it saw, then leaves with
    ``os._exit``: 0 when the phase ran to its end, 3 on ``ProcessKilled``,
    1 on any other exception (teardown of a broken group is skipped)."""
    torch.set_num_threads(1)
    rec = {"rank": rank, "t0": time.time()}
    code = 0
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", world_size=WORLD,
                                rank=rank, timeout=TIMEOUT)
        model, params, data, opt = _setup(base)
        mesh = mesh_lib.make_mesh(GEOMETRY)
        wd = CollectiveWatchdog(timeout_s=3600.0)
        fns = make_train_step(model, opt, mesh=mesh, compressed="flat",
                              recovery=RecoveryPolicy(), watchdog=wd)
        (_phase1 if phase == 1 else _phase2)(rank, model, params, data, opt, fns, wd, base,
                                             rec)
    except ProcessKilled as e:
        code, rec["error"] = 3, e
    except Exception as e:  # noqa: BLE001 -- what a survivor saw is the result
        code, rec["error"] = 1, e
    rec["t_end"] = time.time()
    if "plan" in rec:
        rec["fired"] = list(rec.pop("plan").fired)
    if "error" in rec:
        e = rec.pop("error")
        rec["error"] = (type(e).__name__, str(e), list(getattr(e, "__notes__", [])))
    torch.save(rec, os.path.join(base, f"phase{phase}_rank{rank}.pt"))
    if code == 0:
        dist.destroy_process_group()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def _start_world(base, phase):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, os.path.join(base, f"store{phase}"),
                                                  base, phase)) for r in range(WORLD)]
    for p in procs:
        p.start()

    def finish():
        deadline = time.time() + WORLD_TIMEOUT_S
        for p in procs:
            p.join(max(deadline - time.time(), 0.0))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        recs = [torch.load(os.path.join(base, f"phase{phase}_rank{r}.pt"), weights_only=False)
                for r in range(WORLD) if os.path.exists(os.path.join(base, f"phase{phase}_rank{r}.pt"))]
        return {"codes": [p.exitcode for p in procs], "hung": hung, "ranks": recs}
    return finish


# ---------------------------------------------------------------------------
# the parent's side
# ---------------------------------------------------------------------------


def _jax_inputs(base):
    """JAX's params, 17 batches and first-refresh draws, for the world;
    returns the pieces the parent's JAX run needs."""
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import get_config as jax_get_config
    from repro.core import make_optimizer as jax_make_optimizer
    from repro.data.synthetic import SyntheticDataConfig as JaxDataConfig
    from repro.data.synthetic import SyntheticDataset as JaxDataset
    from repro.models import build_model as jax_build_model
    from repro_torch.core import buckets as buckets_lib
    from test_torch_optim_kernels import JaxDraws

    jcfg = jax_get_config("llama3-8b", smoke=True).with_(dtype=jnp.float32, n_layers=LAYERS)
    jmodel = jax_build_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    jdata = JaxDataset(JaxDataConfig(vocab_size=jcfg.vocab_size, seq_len=SEQ,
                                     global_batch=BATCH))
    batches = [{k: np.asarray(v) for k, v in jdata.batch_at(i).items()}
               for i in range(STEPS + 1)]
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    tparams = bridge.params_from_numpy(np_params, "cpu")
    topt = make_optimizer("galore-sara-adam", tparams, **OPT_KW)
    jd = JaxDraws(jax_make_optimizer("galore-sara-adam", jparams, **OPT_KW)
                  .init(jparams).key).split()
    pcfg = topt.config.projector_config()
    draws = {}
    for bk in topt.bucket_plan.buckets:
        for e in bk.entries:
            ld = buckets_lib.entry_draws(jd, e, topt.state_layout.templates[e.leaf_idx], bk,
                                         pcfg, "cpu")
            draws[e.leaf_idx] = tuple(None if x is None else x.numpy() for x in ld)
    torch.save({"params": np_params, "batches": batches, "draws": draws},
               os.path.join(base, "jax.pt"))
    return jmodel, jparams, jdata


def _jax_losses(jmodel, jparams, jdata, n):
    """JAX's single-process losses of steps 0..n-1 (refresh at 0 and 4)."""
    from repro.core import make_optimizer as jax_make_optimizer
    from repro.train.state import TrainState as JaxTrainState
    from repro.train.step import make_train_step as jax_make_train_step

    jopt = jax_make_optimizer("galore-sara-adam", jparams, state_sharding="zero",
                              state_shards=SHARDS, **OPT_KW)
    fns = jax_make_train_step(jmodel, jopt, donate=False)
    st = JaxTrainState(jparams, jopt.init(jparams))
    out = []
    for s in range(n):
        if s % OPT_KW["tau"] == 0:
            st, m = fns["jit_refresh_step"](st, jdata.batch_at(s), group=0)
        else:
            st, m = fns["jit_step"](st, jdata.batch_at(s))
        out.append(float(m["loss"]))
    return out


@pytest.fixture(scope="module")
def fault_world(tmp_path_factory):
    """Phase 1 (with JAX's run beside it), phase 2, then phase 3 here."""
    base = str(tmp_path_factory.mktemp("multihost"))
    jmodel, jparams, jdata = _jax_inputs(base)
    t0 = time.time()
    finish1 = _start_world(base, 1)
    jax_losses = _jax_losses(jmodel, jparams, jdata, 5)
    p1 = finish1()
    verified = {s: ckpt_lib.verify_checkpoint(os.path.join(base, "ck"), s) for s in (4, 8)}
    t1 = time.time()
    p2 = _start_world(base, 2)()
    t2 = time.time()
    p3 = _phase3(base)
    return dict(p1=p1, p2=p2, p3=p3, verified=verified, jax_losses=jax_losses,
                seconds=(t1 - t0, t2 - t1, time.time() - t2))


def _phase3(base):
    """Step 16 at the other shard count, against the replicated save, then
    one compressed step on the (1, 1) mesh."""
    model, params, data, _ = _setup(base)
    opt = make_optimizer("galore-sara-adam", params, state_sharding="zero",
                         state_shards=NEW_SHARDS, **OPT_KW)
    skel = _fresh(opt, params)
    got, step = ckpt_lib.CheckpointManager(
        os.path.join(base, "ck"), canonical_rows=state_lib.bucket_canonical_rows(opt),
    ).load_latest(skel)
    canon, loc = state_lib.checkpoint_converters(opt)
    ref, _ = ckpt_lib.CheckpointManager(os.path.join(base, "replicated"), canonicalize=canon,
                                        localize=loc).load_latest(skel)
    ca = state_tensors(state_lib.canonical_train_state(opt, got).opt_state) \
        + tree_leaves(got.params)
    cb = state_tensors(state_lib.canonical_train_state(opt, ref).opt_state) \
        + tree_leaves(ref.params)
    fns = make_train_step(model, opt, mesh=mesh_lib.single_device_mesh(), compressed="flat")
    _, m = fns["step"](fns["place_state"](got), data.batch_at(STEPS))
    return {"step": step, "n": (len(ca), len(cb)),
            "equal": len(ca) == len(cb) and all(torch.equal(a, b) for a, b in zip(ca, cb)),
            "keys": (got.opt_state.draws.key().tolist(), ref.opt_state.draws.key().tolist()),
            "loss": float(m["loss"])}


def test_a_killed_rank_ends_every_process_of_its_world(fault_world):
    """Rank 3 dies at step 9 with ``ProcessKilled``; the others fail in
    their next collective, naming step 9, and none waits for the group
    timeout: every process exits non-zero within ``EXIT_BAR_S`` of rank
    3's end."""
    p1 = fault_world["p1"]
    assert p1["hung"] == [], p1
    codes = p1["codes"]
    assert codes[KILLED] == 3 and all(c == 1 for r, c in enumerate(codes) if r != KILLED), codes
    by = {r["rank"]: r for r in p1["ranks"]}
    assert sorted(by) == list(range(WORLD))
    assert by[KILLED]["error"][0] == "ProcessKilled"
    t_kill = by[KILLED]["t_end"]
    for r, rec in by.items():
        assert any("step 9 failed" in n for n in rec["error"][2]), (r, rec["error"])
        assert rec["t_end"] - t_kill <= EXIT_BAR_S, (r, rec["t_end"] - t_kill)
        # every process ran steps 0-8 (and rank 3 no step 9)
        assert len(rec["losses"]) >= 9
        assert rec["verdict"] == (0.0, 1.0)


def test_fired_faults_and_the_corrupt_checkpoint(fault_world):
    """The fired sets, joined over the ranks, are JAX's: the straggler on
    every rank, the corrupt shard on the coordinator (the manager's commit
    runs there), the kill on rank 3.  Checkpoint 8 fails verification,
    checkpoint 4 passes."""
    by = {r["rank"]: set(r["fired"]) for r in fault_world["p1"]["ranks"]}
    assert set().union(*by.values()) == JAX_FIRED_1
    assert by[0] == {("slow_step", 5), ("ckpt_corrupt_shard", 2)}
    assert by[KILLED] == {("slow_step", 5), ("kill_process", 9)}
    assert all(by[r] == {("slow_step", 5)} for r in range(1, KILLED))
    assert fault_world["verified"] == {4: True, 8: False}


def test_losses_before_the_first_fault_equal_jax(fault_world):
    """Steps 0-4 (the straggler comes at 5) from JAX's params, batches and
    first-refresh draws: every rank's losses within ``LOSS_TOL`` of JAX's
    single-process run, and the ranks' losses equal to each other."""
    want = fault_world["jax_losses"]
    ranks = fault_world["p1"]["ranks"]
    for rec in ranks:
        got = rec["losses"][:5]
        assert max(abs(a - b) for a, b in zip(got, want)) <= LOSS_TOL, (got, want)
        assert got == ranks[0]["losses"][:5]


def test_restart_resumes_past_the_corrupt_checkpoint_with_one_lockstep_rollback(fault_world):
    """The restarted world resumes at step 4, every rank rolls back once on
    the summed verdict, and the run ends at 16 in the sharded format with
    the watchdog silent."""
    p2 = fault_world["p2"]
    assert p2["hung"] == [] and p2["codes"] == [0] * WORLD, p2
    losses = [r["losses"] for r in p2["ranks"]]
    for rec in p2["ranks"]:
        assert rec["final_step"] == STEPS and rec["first_step"] == 4.0
        assert [s for s, _ in rec["fallbacks"]] == [8]
        assert len(rec["rollbacks"]) == 1, rec["rollbacks"]
        assert "cross-process bad-step verdict" in rec["rollbacks"][0]["reason"]
        assert rec["skips"] == 3.0
        assert rec["latest"] == STEPS and rec["format"] == "sharded"
        assert rec["watchdog"] == []
        assert rec["losses"] == losses[0] and all(np.isfinite(x) for x in rec["losses"][-3:])


def test_elastic_resume_at_another_shard_count_is_bit_equal(fault_world):
    """Step 16 loaded at 1 shard equals the replicated save of the world's
    gathered state bit for bit (params, projectors, moments, draw key), and
    a compressed step on the (1, 1) mesh has a finite loss."""
    p3 = fault_world["p3"]
    assert p3["step"] == STEPS and p3["equal"], p3
    assert p3["keys"][0] == p3["keys"][1]
    assert np.isfinite(p3["loss"])


def test_world_fits_its_time_budget(fault_world):
    """Each phase well inside the world's timeout (the file's budget)."""
    assert all(s < WORLD_TIMEOUT_S / 2 for s in fault_world["seconds"]), fault_world["seconds"]


def test_launcher_heartbeat_flags_in_a_world(tmp_path):
    """Two launchers on a ``file://`` store with ``--heartbeat-timeout`` and
    ``--stale-action``: both finish, print the same losses and the
    stale-worker count."""
    store = tmp_path / "store"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "llama3-8b", "--smoke",
           "--device", "cpu", "--steps", "3", "--tau", "2", "--rank", "8", "--engine",
           "bucketed", "--svd-backend", "randomized", "--mesh", "2,1", "--compressed-dp",
           "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2", "--shape", "train_4k",
           "--coordinator", f"file://{store}", "--num-processes", "2",
           "--heartbeat-timeout", "30", "--stale-action", "abort"]
    procs = [subprocess.Popen(cmd + ["--process-id", str(i)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for i in range(2)]
    outs = [p.communicate(timeout=180) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        assert "stale workers: 0" in out, out
    done = [next(ln for ln in out.splitlines() if ln.startswith("[train] done:"))
            for out, _ in outs]
    assert done[0] == done[1]
