"""The port's data-parallel training (``src/repro_torch``: ``launch/mesh.py``,
``launch/sharding.py``, ``train/step.py`` with ``mesh=`` and
``compressed=``, ZeRO state, the loop's shard-parallel checkpoints) in
spawned worlds of 2 and 4 processes on the CPU (gloo), held against the
port's single-process step on the same global batch.

The JAX package's distributed steps cannot be the oracle: they fail on
this tree's jax (``tests/test_distributed.py``, ROADMAP queue 3).  Its
single-process ZeRO layout and checkpoints are held bit for bit in
``test_torch_sharded_checkpoint.py``; here the port's multi-process runs
are held to its single-process step, which the other port tests hold to
JAX's.

Every world runs once per module (``worlds``): the smoke llama at f32,
rank 8, tau 4, seq 32, global batch 4, the randomized SVD, as JAX's
``zsetup``.  World 4 runs compressed ``flat`` on a (4, 1) mesh and ``pod``
on a (2, 2, 1) pod x data mesh, with replicated and ZeRO state, for
``galore-sara-adam`` and ``galore-sara-adam8bit``; the uncompressed step;
a NaN in one process's share; a 2-step loop that writes a shard-parallel
checkpoint and, from the same state, a replicated one.  World 2 runs
``flat`` (both states, both inners, and the reference engine), resumes
each of world 4's checkpoints at 2 shards, and trains 8 steps under the
recovery policy through a skipped step and a rollback.

Rules of the spawned worlds: a ``file://`` store under the test's
temporary directory (no TCP port: several test workers run at once), one
intra-op thread per process, and a 60-s timeout on the process group, so
a hung collective fails the test instead of holding the suite.  This file
imports no JAX (the spawned processes import it).

Tolerances, each the port's existing bar:
  * ``REFRESH_TOL`` (5e-5 abs on params) for a trajectory through a
    refresh: the reduced gradient is the same sum in another order, and
    the randomized SVD and Adam's first step amplify the last bits
    (``test_torch_train.py``);
  * ``HOT_LOOP_TOL`` for one hot step from the same state: 1e-6 abs on
    all but 1e-4 of each leaf's elements, those within 1e-4
    (``test_torch_resume.py``);
  * 8-bit codes at most 1 apart (ROADMAP's +-1);
  * ``ZERO_TOL`` (1e-6 abs, the bar of JAX's own ZeRO-against-replicated
    case, ``test_distributed.py``) for ZeRO against replicated state in
    one world: gloo's reduce-scatter sums the processes' R stacks in
    another order than its all-reduce (measured: 7.5e-9 apart);
  * ``ROLLBACK_LOSS_TOL`` (1e-4 abs) on the losses of an 8-step run
    through a skip and a rollback against the single-process run's (the
    detector reads the losses; measured 3e-5 apart);
  * bit-equal where the arithmetic is the same: the processes' params
    against each other, the collectives' bytes against ``dp_comm_model``,
    and the resumes from the two checkpoint formats.
"""
import os
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import buckets as buckets_lib
from repro_torch.core import make_optimizer
from repro_torch.core.lowrank import canonical_opt_state, state_tensors, tree_leaves
from repro_torch.data.synthetic import SyntheticDataConfig, SyntheticDataset
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as shd
from repro_torch.models import build_model
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import state as state_lib
from repro_torch.train.faults import FaultPlan, FaultSpec
from repro_torch.train.loop import train_loop
from repro_torch.train.recovery import RecoveryPolicy
from repro_torch.train.state import TrainState
from repro_torch.train.step import make_train_step

# One intra-op thread: the test workers share the host's cores, and the
# port's results do not depend on the thread count (core/svd.py).
torch.set_num_threads(1)

REFRESH_TOL = 5e-5
HOT_LOOP_TOL = dict(atol=1e-6, share=1e-4, cap=1e-4)
ZERO_TOL = 1e-6
ROLLBACK_LOSS_TOL = 1e-4
CODE_STEP = 1
OPT_KW = dict(rank=8, tau=4, lr=2e-3, engine="bucketed", svd_backend="randomized")
INNERS = ("galore-sara-adam", "galore-sara-adam8bit")
SEQ, BATCH, STEPS = 32, 4, 3  # refresh, hot, hot
TIMEOUT = timedelta(seconds=60)


# ---------------------------------------------------------------------------
# the processes' side
# ---------------------------------------------------------------------------


def _setup():
    cfg = get_config("llama3-8b", smoke=True).with_(dtype=torch.float32)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    data = SyntheticDataset(SyntheticDataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                                global_batch=BATCH), device="cpu")
    return model, params, data


def _copy(tree):
    return {k: _copy(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _optimizer(params, inner, zero_shards=0, **kw):
    z = dict(state_sharding="zero", state_shards=zero_shards) if zero_shards else {}
    return make_optimizer(inner, params, **dict(OPT_KW, **kw), **z)


def _full_state(fns, state):
    """The state with every process's rows (canonical layout), for the
    checks: the same on every process."""
    return fns["gather_state"](state)


def _case(model, params, data, mesh, case, ref_dir):
    """One case of a world: 3 steps from the seed's params, each process's
    params and bytes per step, then one hot step from the single-process
    run's state after step 1."""
    names = ("pod",) if case["compressed"] == "pod" else mesh_lib.batch_axes(mesh)
    shards = mesh_lib.axes_size(mesh, names) if case["zero"] else 0
    opt = _optimizer(params, case["inner"], shards, **case.get("opt_kw", {}))
    fns = make_train_step(model, opt, mesh=mesh, compressed=case["compressed"])
    state = fns["place_state"](TrainState(_copy(params), opt.init(params)))
    out = {"params": [], "comm": [], "rows": [tuple(b.projector.shape[0] for b in
                                                    state.opt_state.buckets)]}
    for s in range(STEPS):
        mesh_lib.comm_reset()
        fn = fns["refresh_step"] if s == 0 else fns["step"]
        state, m = fn(state, data.batch_at(s))
        out["comm"].append(mesh_lib.comm_snapshot())
        out["params"].append([p.clone() for p in tree_leaves(state.params)])
        out.setdefault("loss", []).append(float(m["loss"]))
    full = _full_state(fns, state)
    out["canonical"] = canonical_opt_state(opt, full.opt_state)
    # a hot step from the single-process state after step 1
    ref_state = torch.load(os.path.join(ref_dir, _ref_file(case)), weights_only=False)
    opt_ref = _optimizer(params, case["inner"], **case.get("opt_kw", {}))
    st = TrainState(ref_state["params"], state_lib.storage_train_state(
        opt, TrainState(ref_state["params"], canonical_opt_state(
            opt_ref, ref_state["opt_state"]))).opt_state)
    st, _ = fns["step"](fns["place_state"](st), data.batch_at(2))
    out["hot_from_ref"] = [p.clone() for p in tree_leaves(st.params)]
    return out


def _ref_file(case) -> str:
    """The single-process state after step 1 of a case's optimizer."""
    return f"{case['inner']}_{case.get('opt_kw', {}).get('engine', 'bucketed')}_1.pt"


def _nan_case(model, params, data, mesh):
    """A NaN in process 1's share of a hot step of ZeRO ``flat``: every
    process skips, its state unchanged."""
    n = mesh.size
    opt = _optimizer(params, "galore-sara-adam", n)
    fns = make_train_step(model, opt, mesh=mesh, compressed="flat",
                          recovery=RecoveryPolicy(rollback_backoff_s=0.0))
    state = fns["place_state"](TrainState(_copy(params), opt.init(params)))
    state, _ = fns["refresh_step"](state, data.batch_at(0))
    batch = dict(data.batch_at(1))
    if mesh.rank == 1:
        batch["grad_scale"] = np.float32("nan")
    new, m = fns["step"](state, batch)
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(new.params) + [x for b in new.opt_state.buckets for x in b if x is not None],
        tree_leaves(state.params) + [x for b in state.opt_state.buckets
                                     for x in b if x is not None]))
    return {"skipped": float(m["skipped"]), "bad_step": float(m["bad_step"]),
            "unchanged": same and new.opt_state.step == state.opt_state.step}


def _loop_case(model, params, data, mesh, base, total, resume_from=None):
    """``train_loop`` of ZeRO ``flat`` adam (tau 2): 2 steps saving a
    shard-parallel checkpoint at step 2 under ``base/sharded`` and, from
    the final state, a replicated one under ``base/replicated``; or, with
    ``resume_from``, a resume from that directory to ``total`` steps."""
    opt = _optimizer(params, "galore-sara-adam", mesh.size, tau=2)
    fns = make_train_step(model, opt, mesh=mesh, compressed="flat")
    if resume_from is not None:
        ck = os.path.join(base, f"resume_{resume_from}")
        if mesh.rank == 0:
            import shutil
            shutil.copytree(os.path.join(base, resume_from), ck)
        mesh_lib.barrier(mesh)
        tc = TrainConfig(total_steps=total, checkpoint_every=0, checkpoint_dir=ck,
                         async_checkpoint=False)
        res = train_loop(model, opt, data, tc, fns, log_every=1, handle_signals=False)
        full = _full_state(fns, res.state)
        return {"params": [p.clone() for p in tree_leaves(full.params)],
                "canonical": canonical_opt_state(opt, full.opt_state),
                "losses": res.losses, "rows": [b.projector.shape[0]
                                               for b in res.state.opt_state.buckets]}
    tc = TrainConfig(total_steps=total, checkpoint_every=total, keep_checkpoints=2,
                     checkpoint_dir=os.path.join(base, "sharded"), async_checkpoint=False)
    res = train_loop(model, opt, data, tc, fns, log_every=1, handle_signals=False)
    full = _full_state(fns, res.state)
    if mesh.rank == 0:
        canon, loc = state_lib.checkpoint_converters(opt)
        ckpt_lib.CheckpointManager(os.path.join(base, "replicated"), canonicalize=canon,
                                   localize=loc).save(full, total)
    mesh_lib.barrier(mesh)
    return {"losses": res.losses}


def _rollback_case(model, params, data, mesh, base):
    """``train_loop`` of ZeRO ``flat`` adam (tau 2) under the recovery
    policy with a fault plan: a NaN gradient at step 1 (skipped), NaN
    losses at steps 4-6 (a rollback to the step-6 checkpoint, written
    shard-parallel and in the background every 2 steps).  ``mesh`` None:
    the single-process run it is held to."""
    n = mesh.size if mesh is not None else 0
    opt = _optimizer(params, "galore-sara-adam", n, tau=2)
    policy = RecoveryPolicy(rollback_backoff_s=0.0)
    fns = make_train_step(model, opt, mesh=mesh, compressed="flat" if mesh else "",
                          recovery=policy)
    plan = FaultPlan([FaultSpec("nan_grads", step=1)]
                     + [FaultSpec("nan_loss", step=s) for s in (4, 5, 6)])
    tc = TrainConfig(total_steps=8, checkpoint_every=2, checkpoint_dir=base)
    res = train_loop(model, opt, data, tc, fns, log_every=1, handle_signals=False,
                     recovery=policy, fault_plan=plan)
    return {"losses": res.losses, "params": [p.clone() for p in tree_leaves(res.state.params)],
            "events": [(r["event"], r.get("step")) for r in res.history if "event" in r],
            "skips": [r["skip_steps"] for r in res.history if "skip_steps" in r][-1]}


def _world(rank, world, store, out_dir, ref_dir, plan):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world,
                            rank=rank, timeout=TIMEOUT)
    try:
        model, params, data = _setup()
        out = {}
        meshes = {}
        for name, case in plan["cases"].items():
            key = (tuple(case["mesh"]), tuple(case["axes"]))
            if key not in meshes:
                meshes[key] = mesh_lib.make_mesh(*key)
            out[name] = _case(model, params, data, meshes[key], case, ref_dir)
        flat = mesh_lib.make_mesh((world, 1))
        if plan.get("nan"):
            out["nan"] = _nan_case(model, params, data, flat)
        if plan.get("loop"):
            out["loop"] = _loop_case(model, params, data, flat, plan["loop"]["base"],
                                     plan["loop"]["total"], plan["loop"].get("resume_from"))
        if plan.get("rollback"):
            out["rollback"] = _rollback_case(model, params, data, flat, plan["rollback"])
        if plan.get("resume"):
            for src in ("sharded", "replicated"):
                out[f"resume_{src}"] = _loop_case(model, params, data, flat,
                                                  plan["resume"]["base"],
                                                  plan["resume"]["total"], resume_from=src)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn(world, tmp, ref_dir, plan):
    out_dir = tmp / f"world{world}"
    out_dir.mkdir()
    mp.spawn(_world, args=(world, str(tmp / f"store{world}"), str(out_dir), ref_dir, plan),
             nprocs=world, join=True)
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(world)]


# ---------------------------------------------------------------------------
# the parent's side
# ---------------------------------------------------------------------------


def _cases(world):
    out = {}
    for inner in INNERS:
        for zero in (False, True):
            tag = f"{inner.split('-')[-1]}_{'zero' if zero else 'repl'}"
            out[f"flat_{tag}"] = dict(mesh=(world, 1), axes=("data", "model"),
                                      compressed="flat", inner=inner, zero=zero)
            if world == 4:
                out[f"pod_{tag}"] = dict(mesh=(2, 2, 1), axes=("pod", "data", "model"),
                                         compressed="pod", inner=inner, zero=zero)
    if world == 4:
        out["standard_adam"] = dict(mesh=(4, 1), axes=("data", "model"), compressed="",
                                    inner="galore-sara-adam", zero=False)
    else:
        out["flat_adam_reference"] = dict(mesh=(2, 1), axes=("data", "model"),
                                          compressed="flat", inner="galore-sara-adam",
                                          zero=False, opt_kw=dict(engine="reference"))
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The single-process trajectories, then world 4, then world 2 (which
    resumes world 4's checkpoints)."""
    tmp = tmp_path_factory.mktemp("dp")
    model, params, data = _setup()
    ref = {}
    ref_dir = tmp / "ref"
    ref_dir.mkdir()
    for inner in INNERS + ("galore-sara-adam:reference",):
        name, _, engine = inner.partition(":")
        opt = _optimizer(params, name, **({"engine": engine} if engine else {}))
        fns = make_train_step(model, opt)
        state = TrainState(_copy(params), opt.init(params))
        traj = []
        for s in range(STEPS):
            fn = fns["refresh_step"] if s == 0 else fns["step"]
            state, _ = fn(state, data.batch_at(s))
            traj.append((state, [p.clone() for p in tree_leaves(state.params)]))
            if s == 1:
                case = dict(inner=name, opt_kw={"engine": engine} if engine else {})
                torch.save({"params": state.params, "opt_state": state.opt_state},
                           ref_dir / _ref_file(case))
        ref[inner] = dict(traj=traj, opt=opt)
    w4 = _spawn(4, tmp, str(ref_dir), {"cases": _cases(4), "nan": True,
                                        "loop": {"base": str(tmp / "ck"), "total": 2}})
    w2 = _spawn(2, tmp, str(ref_dir), {"cases": _cases(2), "nan": True,
                                        "resume": {"base": str(tmp / "ck"), "total": 4},
                                        "rollback": str(tmp / "rollback")})
    single_rollback = _rollback_case(model, params, data, None, str(tmp / "rollback1"))
    return dict(ref=ref, params=params, w4=w4, w2=w2, cases={4: _cases(4), 2: _cases(2)},
                single_rollback=single_rollback)


def _max_err(got, want):
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


def _hot_loop_ok(got, want):
    for a, b in zip(got, want):
        err = (a - b).abs()
        off = float((err > HOT_LOOP_TOL["atol"]).float().mean())
        assert off <= HOT_LOOP_TOL["share"] and float(err.max()) <= HOT_LOOP_TOL["cap"], \
            (off, float(err.max()))


def _codes(state):
    return [(st.inner.m_codes, st.inner.v_codes) for st in state.leaves
            if hasattr(st.inner, "m_codes")]


@pytest.mark.parametrize("world,case", [(4, c) for c in _cases(4)] + [(2, c) for c in _cases(2)])
def test_dp_world_agrees_with_the_single_process_step(worlds, world, case):
    """Params after each step against the single-process step on the same
    global batch (REFRESH_TOL: the trajectory starts with a refresh), one
    hot step from the single-process state (HOT_LOOP_TOL), and the
    processes' params bit-equal to each other."""
    ranks = worlds[f"w{world}"]
    spec = worlds["cases"][world][case]
    key = spec["inner"] + (":reference" if spec.get("opt_kw") else "")
    ref = worlds["ref"][key]
    for s in range(STEPS):
        got = ranks[0][case]["params"][s]
        err = _max_err(got, ref["traj"][s][1])
        assert err <= REFRESH_TOL, (case, s, err)
        for r in ranks[1:]:
            assert all(torch.equal(a, b) for a, b in zip(r[case]["params"][s], got)), (case, r)
    if "hot_from_ref" in ranks[0][case]:
        _hot_loop_ok(ranks[0][case]["hot_from_ref"], ref["traj"][2][1])
    if "adam8bit" in spec["inner"]:
        for (gm, gv), (wm, wv) in zip(_codes(ranks[0][case]["canonical"]),
                                      _codes(canonical_opt_state(
                                          ref["opt"], ref["traj"][2][0].opt_state))):
            for g, w in ((gm, wm), (gv, wv)):
                assert int((g.int() - w.int()).abs().max()) <= CODE_STEP


@pytest.mark.parametrize("world", [4, 2])
def test_zero_state_holds_its_rows_and_matches_replicated(worlds, world):
    """A ZeRO run's processes hold 1/shards of each padded stack, and its
    params equal the replicated run's in the same world to ZERO_TOL."""
    ranks = worlds[f"w{world}"]
    for case, spec in worlds["cases"][world].items():
        if not spec["zero"]:
            continue
        twin = case.replace("zero", "repl")
        rows_zero, rows_repl = ranks[0][case]["rows"][0], ranks[0][twin]["rows"][0]
        shards = 2 if spec["compressed"] == "pod" else world
        assert all(z == buckets_lib.zero_padded_batch(r, shards) // shards
                   for z, r in zip(rows_zero, rows_repl)), (case, rows_zero, rows_repl)
        for s in range(STEPS):
            assert _max_err(ranks[0][case]["params"][s],
                            ranks[0][twin]["params"][s]) <= ZERO_TOL, (case, s)


@pytest.mark.parametrize("world", [4, 2])
def test_collective_bytes_equal_dp_comm_model(worlds, world):
    """The bytes the step hands its collectives per hot and per refresh step
    equal ``dp_comm_model``'s, schedule by schedule."""
    params = worlds["params"]
    for case, spec in worlds["cases"][world].items():
        if spec.get("opt_kw"):
            continue
        pod = spec["compressed"] == "pod"
        shards = (2 if pod else world) if spec["zero"] else 1
        opt = _optimizer(params, spec["inner"], shards if spec["zero"] else 0)
        model = buckets_lib.dp_comm_model(opt.bucket_plan, tree_leaves(params),
                                          state_shards=shards, inner=opt.config.inner,
                                          axis_sizes={"pod": 2, "data": 2} if pod else None)
        refresh, hot = worlds[f"w{world}"][0][case]["comm"][0], \
            worlds[f"w{world}"][0][case]["comm"][1]

        def total(c, axes=None):
            at = f"@{axes}" if axes else ""
            return sum(c.get(k + at, 0) for k in ("all_reduce", "reduce_scatter", "all_gather"))

        if not spec["compressed"]:
            assert total(hot) == total(refresh) == model["standard"]["bytes"]
        elif pod:
            # the data axis reduces full-rank, only the compressed stacks cross pods
            assert total(hot, "data") == model["pod_mode_hot"]["intra_pod_bytes"]
            want_hot = model["zero_hot" if spec["zero"] else "compressed_hot"]["bytes"]
            assert total(hot, "pod") == want_hot, case
            want_ref = model["zero_refresh" if spec["zero"] else "compressed_refresh"]["bytes"]
            assert total(refresh, "pod") == want_ref, case
        else:
            key = "zero" if spec["zero"] else "compressed"
            assert total(hot) == model[f"{key}_hot"]["bytes"], case
            assert total(refresh) == model[f"{key}_refresh"]["bytes"], case
            if spec["zero"]:
                assert hot["reduce_scatter"] == model["zero_hot"]["reduce_scatter_bytes"]
                assert hot["all_gather"] == model["zero_hot"]["all_gather_bytes"]


@pytest.mark.parametrize("world", [4, 2])
def test_nan_in_one_share_makes_every_process_skip(worlds, world):
    for r in worlds[f"w{world}"]:
        assert r["nan"] == {"skipped": 1.0, "bad_step": 1.0, "unchanged": True}


def test_rollback_is_taken_by_every_process(worlds):
    """A skip and a NaN-loss streak under the recovery policy: every
    process of world 2 skips the same step and rolls back to the same
    checkpoint as the single-process run, with its losses (within
    ROLLBACK_LOSS_TOL), and all hold the same params bit for bit.  The
    params themselves are not held to the single-process run's: over five
    SARA refreshes (tau 2, a replayed stretch) the reduction's last bits
    move a near-tie of the Gumbel top-k (measured: 3.9e-3 apart, one
    column's step, while every loss agreed to 3e-5)."""
    one = worlds["single_rollback"]
    got = [r["rollback"] for r in worlds["w2"]]
    assert one["events"] == [("rollback", 6.0)] and one["skips"] == 1.0
    for r in got:
        assert r["events"] == one["events"] and r["skips"] == one["skips"]
        assert len(r["losses"]) == len(one["losses"])
        for a, b in zip(r["losses"], one["losses"]):
            assert (np.isnan(a) and np.isnan(b)) or abs(a - b) <= ROLLBACK_LOSS_TOL, (a, b)
        assert all(torch.equal(a, b) for a, b in zip(r["params"], got[0]["params"]))


def test_resume_at_2_from_4_sharded_equals_replicated_save(worlds):
    """World 4 saved at step 2 in both formats; world 2 resumes each to step
    4: the runs go on bit-identical, and every process of world 2 holds the
    2-shard rows."""
    for r in worlds["w2"]:
        a, b = r["resume_sharded"], r["resume_replicated"]
        assert a["losses"] == b["losses"] and len(a["losses"]) == 2
        assert all(torch.equal(x, y) for x, y in zip(a["params"], b["params"]))
        ca, cb = state_tensors(a["canonical"]), state_tensors(b["canonical"])
        assert len(ca) == len(cb) and all(torch.equal(x, y) for x, y in zip(ca, cb))
    plan = _optimizer(worlds["params"], "galore-sara-adam").bucket_plan
    assert worlds["w2"][0]["resume_sharded"]["rows"] == [
        buckets_lib.zero_padded_batch(b.batch, 2) // 2 for b in plan.buckets]


def test_mesh_and_batch_rows():
    """The mesh's errors, and the batch rows and ZeRO rows of one process."""
    with pytest.raises(ValueError, match="2 places for 1 processes"):
        mesh_lib.make_mesh((1, 2))
    with pytest.raises(ValueError, match="places for 1 processes"):
        mesh_lib.make_mesh((2, 1))
    m = mesh_lib.Mesh(("pod", "data", "model"), (2, 2, 1), rank=3)
    assert m.coords == {"pod": 1, "data": 1, "model": 0}
    assert m.axes(("data", "pod")).index == 3 and m.axes(("pod",)).index == 1
    assert shd.batch_rows(8, m) == (6, 8) and shd.batch_rows(3, m) == (0, 3)
    single = mesh_lib.single_device_mesh()
    assert not single.distributed and shd.batch_rows(4, single) == (0, 4)
