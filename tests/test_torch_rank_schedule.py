"""The port's rank schedules against the JAX package's, on the CPU (the
cases of tests/test_rank_schedule.py but its two modeled-bytes ones, which
wait for the modeled accounting, ROADMAP queue 1 item 12):

* schedule evaluation -- parsing, ``scheduled_rank`` over a grid of specs,
  steps and current ranks, the adaptive proposal, the trajectory -- equal
  to JAX's exactly;
* the bucket plan's rank clamp and its refusal of a rank below 1;
* ``migrate_opt_state`` for each inner (adam, msgd, adam_mini, adam8bit,
  adafactor) and each carry, from the same state (JAX's, carried across
  with ``bridge``), equal to JAX's migration bit for bit (8-bit codes and
  scales included); shrink slices, grow zero-pads, reset re-initializes;
* hot steps after a migration bit-identical to a static engine at the new
  rank;
* checkpoints across a rank change: the manifest's ``meta``, a restore
  into a fresh optimizer at the checkpoint's rank, and each package reading
  the other's;
* the loop: re-bucket events, a resume across the rank boundary in the
  port bit for bit, and from a checkpoint written by each package into the
  other's loop;
* ``SpectrumLogger``'s effective rank.

Small params (``_params``: a left and a right stacked leaf and a norm)
made from a numpy seed; the loop cases run ``get_config("llama3-8b",
smoke=True)`` in f32.
"""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RankSchedule as JaxRankSchedule
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.configs.registry import get_config as jax_get_config
from repro.core import lowrank as jax_lowrank
from repro.core import make_optimizer as jax_make_optimizer
from repro.core import rank_schedule as jax_rs
from repro.data.synthetic import SyntheticDataConfig, SyntheticDataset
from repro.models import build_model as jax_build_model
from repro.train.checkpoint import CheckpointManager as JaxManager
from repro.train.checkpoint import checkpoint_meta as jax_checkpoint_meta
from repro.train.loop import train_loop as jax_train_loop
from repro.train.monitor import SpectrumLogger as JaxSpectrumLogger
from repro.train.state import TrainState as JaxTrainState
from repro.train.state import checkpoint_converters as jax_converters
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch import bridge
from repro_torch.configs.base import RankSchedule, TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import buckets as buckets_lib
from repro_torch.core import lowrank as lowrank_lib
from repro_torch.core import make_optimizer
from repro_torch.core import rank_schedule as rs_lib
from repro_torch.models import build_model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.faults import FaultPlan, FaultSpec
from repro_torch.train.loop import train_loop
from repro_torch.train.monitor import SpectrumLogger
from repro_torch.train.state import TrainState, checkpoint_converters
from repro_torch.train.step import make_train_step
from test_torch_resume import _assert_step_close
from test_torch_train import _SharedData

# One intra-op thread: the test workers share the host's cores, and the
# port's results do not depend on the thread count (core/svd.py).
torch.set_num_threads(1)

# ---------------------------------------------------------------------------
# schedule evaluation
# ---------------------------------------------------------------------------

SPECS = ["constant:64", "step:128:32@1", "step:512:256", "linear:128:32@0.5", "cosine:128:32@0.5",
         "cosine:96:8", "linear:40:36", "step:100:3@0.7", "adaptive:64:16"]
OVERRIDES = [{}, dict(granularity=16), dict(hysteresis=24), dict(granularity=1, hysteresis=1),
             dict(total_steps=300)]


@pytest.mark.parametrize("ov", range(len(OVERRIDES)))
def test_schedule_evaluation_equals_jax(ov):
    kw = OVERRIDES[ov]
    for spec in SPECS:
        mine, ref = RankSchedule.parse(spec, **kw), JaxRankSchedule.parse(spec, **kw)
        assert dataclass_fields(mine) == dataclass_fields(ref)
        assert mine.spec() == ref.spec() and RankSchedule.parse(mine.spec(), **kw) == mine
        assert (mine.effective_floor, mine.effective_hysteresis) == (
            ref.effective_floor, ref.effective_hysteresis)
        for total in (1000, 7):
            for step in (-3, 0, 1, 3, 99, 250, 499, 500, 501, 999, 1000, 5000):
                for current in (None, 8, 32, 64, 120, 128):
                    got = rs_lib.scheduled_rank(mine, step, total_steps=total, current=current)
                    assert got == jax_rs.scheduled_rank(ref, step, total_steps=total,
                                                        current=current), (spec, step, current)
            for sub_tau in (1, 3, 50):
                assert rs_lib.rank_trajectory(mine, total_steps=total, sub_tau=sub_tau) == \
                    jax_rs.rank_trajectory(ref, total_steps=total, sub_tau=sub_tau)
        for current in (None, 16, 40, 64):
            for eff in (float("nan"), float("inf"), -1.0, 0.0, 1.0, 12.7, 31.9, 40.0, 1e6):
                assert rs_lib.propose_adaptive_rank(mine, current, eff) == \
                    jax_rs.propose_adaptive_rank(ref, current, eff)


def dataclass_fields(x):
    return [(f, getattr(x, f)) for f in ("kind", "start", "floor", "decay_fraction",
                                          "total_steps", "granularity", "hysteresis", "margin")]


def test_schedule_errors_match_jax():
    for bad in ("warp:128", "cosine:32:128", "", "linear:x", "cosine:8:4@2", "a:1:2:3",
                "step:8@x"):
        for parse in (RankSchedule.parse, JaxRankSchedule.parse):
            with pytest.raises(ValueError):
                parse(bad)
    for lib, cls in ((rs_lib, RankSchedule), (jax_rs, JaxRankSchedule)):
        with pytest.raises(ValueError, match="horizon"):
            lib.scheduled_rank(cls.parse("cosine:128:32"), 10)
        with pytest.raises(ValueError):
            lib.rank_trajectory(cls.parse("constant:8"), total_steps=0)
    for fn in (rs_lib.scheduled_state_model, rs_lib.rebucket_cost_model):
        with pytest.raises(NotImplementedError, match="item 12"):
            fn()


# ---------------------------------------------------------------------------
# small params, both packages
# ---------------------------------------------------------------------------


def _params():
    rng = np.random.default_rng(3)
    return {"blocks": {"q_proj": (rng.standard_normal((2, 32, 64)) * 0.02).astype(np.float32),
                       "down_proj": (rng.standard_normal((2, 96, 32)) * 0.02).astype(np.float32)},
            "norm": np.ones((32,), np.float32)}


def _grads(params, seed):
    rng = np.random.default_rng(100 + seed)
    return jax.tree_util.tree_map(
        lambda p: (rng.standard_normal(p.shape) * 0.01).astype(np.float32), params)


def _t(tree):
    return bridge.params_from_numpy(tree, "cpu")


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


NAMES = {"adam": "galore-sara-adam", "msgd": "galore-sara-msgd",
         "adam_mini": "galore-sara-adam-mini", "adam8bit": "galore-sara-adam8bit",
         "adafactor": "galore-sara-adafactor"}


def _kw(rank=8, engine="bucketed", carry="reproject", **kw):
    return dict(rank=rank, lr=1e-2, alpha=0.5, min_dim=8, momentum_carry=carry, engine=engine,
                svd_backend="randomized", **kw)


def _jax_warm(inner, **kw):
    """JAX's state after 3 steps (refreshes at 0 and 2) on the small params."""
    p = _params()
    jopt = jax_make_optimizer(NAMES[inner], _j(p), **_kw(**kw))
    jp, st = _j(p), jopt.init(_j(p))
    for s in range(3):
        jp, st, _ = jopt.update(_j(_grads(p, s)), st, jp, refresh=(s % 2 == 0), apply=True)
    return jopt, jp, st


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _canon_leaves(items):
    """The canonical state's arrays in flat order (step and key dropped)."""
    return [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x) for x in items]


def _port_canon(opt, state):
    canon = lowrank_lib.canonical_opt_state(opt, state)
    return _canon_leaves([x for _, x in ckpt.tree_items(canon)][2:])


def _jax_canon(opt, state):
    canon = jax_lowrank.canonical_opt_state(opt, state)
    return _canon_leaves(jax.tree_util.tree_leaves(canon.leaves))


def _assert_arrays_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)


def test_bucket_plan_clamps_rank_and_rejects_zero():
    p = _params()
    opt = make_optimizer("galore-sara-adam", _t(p), **_kw(rank=64))
    jopt = jax_make_optimizer("galore-sara-adam", _j(p), **_kw(rank=64))
    assert [(b.d, b.n, b.rank) for b in opt.bucket_plan.buckets] == \
        [(b.d, b.n, b.rank) for b in jopt.bucket_plan.buckets]
    assert all(b.rank <= 32 for b in opt.bucket_plan.buckets)
    bad = [s._replace(rank=0) if s.lowrank else s for s in opt.specs]
    with pytest.raises(ValueError, match="rank"):
        buckets_lib.build_bucket_plan(bad, lowrank_lib.tree_leaves(_t(p)))
    # plan_at_rank is the plan a rebuilt optimizer holds, and the
    # schedule's plans are JAX's, weight for weight
    small = lowrank_lib.rebuild_at_rank(opt, _t(p), rank=4)
    assert rs_lib.plan_at_rank(opt.config, _t(p), 4) == small.bucket_plan
    sched = "cosine:32:8@0.5"
    plans = rs_lib.schedule_rank_plans(opt.config, _t(p), RankSchedule.parse(sched),
                                       total_steps=100, sub_tau=10)
    jplans = jax_rs.schedule_rank_plans(jopt.config, _j(p), JaxRankSchedule.parse(sched),
                                        total_steps=100, sub_tau=10)
    assert [w for w, _ in plans] == [w for w, _ in jplans] and len(plans) > 2
    for (_, a), (_, b) in zip(plans, jplans):
        assert [(x.d, x.n, x.rank, x.side, [tuple(e) for e in x.entries]) for x in a.buckets] \
            == [(x.d, x.n, x.rank, x.side, [tuple(e) for e in x.entries]) for x in b.buckets]
    assert lowrank_lib.current_ranks(small) == (4, (4,))
    g = lowrank_lib.rebuild_at_rank(opt, _t(p), group_ranks=(12,))
    assert lowrank_lib.current_ranks(g) == (12, (12,)) == jax_lowrank.current_ranks(
        jax_lowrank.rebuild_at_rank(jopt, _j(p), group_ranks=(12,)))
    with pytest.raises(ValueError):
        lowrank_lib.rebuild_at_rank(opt, _t(p))


# ---------------------------------------------------------------------------
# migration against JAX's, bit for bit
# ---------------------------------------------------------------------------

CASES = [(inner, "reproject") for inner in NAMES] + [("adam", "reset"), ("adam8bit", "reset"),
                                                     ("msgd", "keep")]


@pytest.mark.parametrize("inner,carry", CASES)
def test_migrate_matches_jax_bit_for_bit(inner, carry):
    jopt, jp, jst = _jax_warm(inner, carry=carry)
    p = _params()
    topt = make_optimizer(NAMES[inner], _t(p), **_kw(carry=carry))
    tst = bridge.opt_state_from_numpy(topt, _numpy(jst), "cpu")
    _assert_arrays_equal(_port_canon(topt, tst), _jax_canon(jopt, jst))
    tp = _t(_numpy(jp))
    for r_small in (4, 3):  # 3: not a multiple of anything
        jsmall = jax_lowrank.rebuild_at_rank(jopt, jp, rank=r_small)
        tsmall = lowrank_lib.rebuild_at_rank(topt, tp, rank=r_small)
        js2 = jax_rs.migrate_opt_state(jopt, jsmall, jst)
        ts2 = rs_lib.migrate_opt_state(topt, tsmall, tst)
        assert ts2.step == int(js2.step) and ts2.draws is tst.draws
        _assert_arrays_equal(_port_canon(tsmall, ts2), _jax_canon(jsmall, js2))
        # and back up: zero-padded projectors, zero-extended moments or codes
        jbig = jax_lowrank.rebuild_at_rank(jsmall, jp, rank=8)
        tbig = lowrank_lib.rebuild_at_rank(tsmall, tp, rank=8)
        js3 = jax_rs.migrate_opt_state(jsmall, jbig, js2)
        ts3 = rs_lib.migrate_opt_state(tsmall, tbig, ts2)
        _assert_arrays_equal(_port_canon(tbig, ts3), _jax_canon(jbig, js3))
    # the rules themselves, on the port's side
    before = {s.path: st for s, st in zip(topt.specs, lowrank_lib.canonical_opt_state(
        topt, tst).leaves) if s.lowrank}
    small = lowrank_lib.rebuild_at_rank(topt, tp, rank=4)
    after = lowrank_lib.canonical_opt_state(small, rs_lib.migrate_opt_state(topt, small, tst))
    for spec, st in zip(small.specs, after.leaves):
        if not spec.lowrank:
            continue
        old = before[spec.path]
        assert torch.equal(st.projector, old.projector[..., :4])
        ax = -2 if spec.side == "left" else -1
        if carry == "reset":
            fresh = small.config.make_inner().init(torch.zeros(
                old.inner[0].narrow(ax, 0, 4).shape))
            assert all(torch.equal(a, b) for a, b in zip(st.inner, fresh))
        elif inner == "adam8bit":
            for name in ("m_codes", "v_codes"):
                assert torch.equal(getattr(st.inner, name),
                                   getattr(old.inner, name).narrow(ax, 0, 4))
        elif inner in ("adam", "msgd"):
            for a, b in zip(st.inner, old.inner):
                assert torch.equal(a, b.narrow(ax, 0, 4))


@pytest.mark.parametrize("inner", ["adam", "adam8bit", "adam_mini"])
def test_hot_steps_after_migration_match_static_engine(inner):
    """The rebuilt optimizer is the static one at the new rank: its hot
    steps from the migrated state are bit-identical."""
    p = _params()
    topt = make_optimizer(NAMES[inner], _t(p), **_kw())
    tp, st = _t(p), topt.init(_t(p))
    for s in range(3):
        tp, st, _ = topt.update(_t(_grads(p, s)), st, tp, refresh=(s % 2 == 0), apply=True)
    small = lowrank_lib.rebuild_at_rank(topt, tp, rank=4)
    st_small = rs_lib.migrate_opt_state(topt, small, st)
    assert st_small.step == st.step == 3
    static = make_optimizer(NAMES[inner], _t(p), **_kw(rank=4))
    st_static = lowrank_lib.storage_opt_state(
        static, lowrank_lib.canonical_opt_state(small, st_small))
    pa, sa, pb, sb = tp, st_small, tp, st_static
    for s in range(3):
        g = _t(_grads(p, 50 + s))
        pa, sa, _ = small.update(g, sa, pa, refresh=False, apply=True)
        pb, sb, _ = static.update(g, sb, pb, refresh=False, apply=True)
    for (_, a), (_, b) in zip(ckpt.tree_items(TrainState(pa, sa)),
                              ckpt.tree_items(TrainState(pb, sb))):
        assert np.array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# checkpoints across a rank change, both ways
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["bucketed", "reference"])
@pytest.mark.parametrize("inner", ["adam", "adam8bit", "adam_mini"])
def test_checkpoint_across_a_rank_change_reads_both_ways(tmp_path, inner, engine):
    """JAX's warm rank-8 state migrated to rank 4 by each package; each
    saves with the rank in ``meta``; a fresh optimizer at ``meta``'s rank
    of the other package restores it bit for bit."""
    jopt, jp, jst = _jax_warm(inner, engine=engine)
    p = _params()
    topt = make_optimizer(NAMES[inner], _t(p), **_kw(engine=engine))
    tst = bridge.opt_state_from_numpy(topt, _numpy(jst), "cpu")
    tst = tst._replace(draws=lowrank_lib.TorchDraws.from_key(np.asarray(jst.key), "cpu"))
    tp = _t(_numpy(jp))
    jsmall = jax_lowrank.rebuild_at_rank(jopt, jp, rank=4)
    tsmall = lowrank_lib.rebuild_at_rank(topt, tp, rank=4)
    js2 = jax_rs.migrate_opt_state(jopt, jsmall, jst)
    ts2 = rs_lib.migrate_opt_state(topt, tsmall, tst)
    r, gr = lowrank_lib.current_ranks(tsmall)
    meta = {"rank": r, "group_ranks": list(gr)}
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    JaxManager(jdir, canonicalize=jax_converters(jsmall)[0]).save(
        JaxTrainState(jp, js2), 3, meta=meta)
    ckpt.CheckpointManager(tdir, canonicalize=checkpoint_converters(tsmall)[0]).save(
        TrainState(tp, ts2), 3, meta=meta)
    for d in (jdir, tdir):
        assert ckpt.checkpoint_meta(d, 3) == jax_checkpoint_meta(d, 3) == meta
    with open(os.path.join(jdir, "step_00000003", "manifest.json"), "rb") as f:
        jman = f.read()
    with open(os.path.join(tdir, "step_00000003", "manifest.json"), "rb") as f:
        assert f.read() == jman  # the same manifest, byte for byte
    # a fresh port optimizer at the checkpoint's rank reads JAX's, and JAX's the port's
    fresh = make_optimizer(NAMES[inner], _t(p), **_kw(rank=meta["rank"], engine=engine))
    can, loc = checkpoint_converters(fresh)
    got = ckpt.CheckpointManager(jdir, canonicalize=can, localize=loc).load(
        TrainState(_t(p), fresh.init(_t(p))), step=3)
    _assert_arrays_equal(_port_canon(fresh, got.opt_state), _port_canon(tsmall, ts2))
    jfresh = jax_make_optimizer(NAMES[inner], _j(p), **_kw(rank=meta["rank"], engine=engine))
    jcan, jloc = jax_converters(jfresh)
    jgot = JaxManager(tdir, canonicalize=jcan, localize=jloc).load(
        JaxTrainState(_j(p), jfresh.init(_j(p))), step=3)
    _assert_arrays_equal(_jax_canon(jfresh, jgot.opt_state), _jax_canon(jsmall, js2))


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

LOOP_STEPS = 8
# tau 2: refreshes at 0, 2, 4, 6; "step:16:8" over 8 steps halves at step 4
LOOP_KW = dict(rank=16, tau=2, lr=0.01, engine="bucketed", svd_backend="randomized",
               momentum_carry="reproject", rank_schedule="step:16:8")


@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_get_config("llama3-8b", smoke=True).with_(dtype=jnp.float32)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    data = SyntheticDataset(SyntheticDataConfig(vocab_size=jcfg.vocab_size, seq_len=16,
                                                global_batch=2))
    batches = [data.batch_at(i) for i in range(LOOP_STEPS)]
    tmodel = build_model(get_config("llama3-8b", smoke=True).with_(dtype=torch.float32),
                         device="cpu")
    tparams = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return dict(jmodel=jmodel, jparams=jparams, batches=batches, tmodel=tmodel, tparams=tparams)


def _port_loop(smoke, ckpt_dir, total=LOOP_STEPS, every=0, **kw):
    opt = make_optimizer("galore-sara-adam", smoke["tparams"], **LOOP_KW)
    tc = TrainConfig(total_steps=total, checkpoint_every=every, checkpoint_dir=ckpt_dir,
                     async_checkpoint=False, keep_checkpoints=10,
                     log_spectrum=kw.pop("log_spectrum", False))
    state = TrainState(smoke["tparams"], opt.init(smoke["tparams"]))
    return train_loop(smoke["tmodel"], opt, _SharedData(smoke["batches"]), tc,
                      make_train_step(smoke["tmodel"], opt, train_cfg=tc), state=state,
                      log_every=1, handle_signals=False, **kw)


class _JaxData:
    def __init__(self, batches):
        self.batches = batches

    def batch_at(self, step):
        return self.batches[step]


def _jax_loop(smoke, ckpt_dir, total=LOOP_STEPS, every=0):
    jopt = jax_make_optimizer("galore-sara-adam", smoke["jparams"], **LOOP_KW)
    tc = JaxTrainConfig(total_steps=total, checkpoint_every=every, checkpoint_dir=ckpt_dir,
                        async_checkpoint=False, keep_checkpoints=10)
    return jax_train_loop(smoke["jmodel"], jopt, _JaxData(smoke["batches"]), tc,
                          jax_make_train_step(smoke["jmodel"], jopt, train_cfg=tc, donate=False),
                          state=JaxTrainState(smoke["jparams"], jopt.init(smoke["jparams"])),
                          log_every=1, handle_signals=False)


def _rebuckets(res):
    return [(r["step"], r["rank_from"], r["rank_to"]) for r in res.history
            if r.get("event") == "rebucket"]


def test_loop_rebuckets_and_resumes_across_the_rank_boundary(smoke, tmp_path):
    full = _port_loop(smoke, str(tmp_path / "a"), every=1, log_spectrum=True)
    assert _rebuckets(full) == [(4.0, 16.0, 8.0)]
    assert [b.rank for b in full.optimizer.bucket_plan.buckets] == [8, 8, 8]
    assert [r["step"] for r in full.history if r.get("event") == "spectrum"] == [0., 2., 4., 6.]
    # the manifests carry the rank each checkpoint's geometry was built at
    metas = {s: ckpt.checkpoint_meta(str(tmp_path / "a"), s)["rank"] for s in (4, 5, 8)}
    assert metas == {4: 16, 5: 8, 8: 8}
    # preempted after the re-bucket, resumed by a fresh optimizer at rank 16
    part = str(tmp_path / "b")
    first = _port_loop(smoke, part, every=2, fault_plan=FaultPlan([FaultSpec("preempt", step=4)]))
    assert first.final_step == 5 and _rebuckets(first) == [(4.0, 16.0, 8.0)]
    rest = _port_loop(smoke, part)
    assert rest.checkpoints.last_load["step"] == 5
    assert rest.losses == full.losses[5:] and _rebuckets(rest) == []
    for (_, a), (_, b) in zip(ckpt.tree_items(rest.state), ckpt.tree_items(full.state)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_constant_schedule_is_the_static_run(smoke, tmp_path):
    opt_kw = dict(LOOP_KW, rank_schedule="constant:16")
    runs = []
    for kw in (opt_kw, {k: v for k, v in opt_kw.items() if k != "rank_schedule"}):
        opt = make_optimizer("galore-sara-adam", smoke["tparams"], **kw)
        tc = TrainConfig(total_steps=4, checkpoint_every=0,
                         checkpoint_dir=str(tmp_path / str(len(runs))))
        runs.append(train_loop(smoke["tmodel"], opt, _SharedData(smoke["batches"]), tc,
                               make_train_step(smoke["tmodel"], opt, train_cfg=tc),
                               state=TrainState(smoke["tparams"], opt.init(smoke["tparams"])),
                               log_every=1, handle_signals=False))
    assert _rebuckets(runs[0]) == [] and runs[0].losses == runs[1].losses


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_loop_resumes_across_the_rank_boundary_from_either_package(smoke, tmp_path, writer):
    """One package trains 6 steps (re-bucketing 16 -> 8 at step 4) and
    checkpoints every step; the other resumes from its step-5 checkpoint
    with a fresh optimizer at the schedule's start rank, rebuilds at rank 8
    from the manifest, and its hot step 5 meets the writer's own
    (``HOT_LOOP_TOL``)."""
    wdir = str(tmp_path / "writer")
    if writer == "jax":
        wres = _jax_loop(smoke, wdir, total=6, every=1)
        want = bridge.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, wres.state.params), "cpu")
    else:
        wres = _port_loop(smoke, wdir, total=6, every=1)
        want = wres.state.params
    assert jax_checkpoint_meta(wdir, 5) == {"rank": 8, "group_ranks": [8]}
    assert [(r["step"], r["rank_to"]) for r in wres.history if r.get("event") == "rebucket"] \
        == [(4.0, 8.0)]
    rdir = str(tmp_path / "reader")
    os.makedirs(rdir)
    shutil.copytree(os.path.join(wdir, "step_00000005"), os.path.join(rdir, "step_00000005"))
    if writer == "jax":
        res = _port_loop(smoke, rdir, total=6)
        assert [b.rank for b in res.optimizer.bucket_plan.buckets] == [8, 8, 8]
        got = res.state.params
    else:
        res = _jax_loop(smoke, rdir, total=6)
        got = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, res.state.params),
                                       "cpu")
    np.testing.assert_allclose(res.losses, wres.losses[5:], rtol=1e-6)
    _assert_step_close(got, want, "hot")
    with open(os.path.join(rdir, "step_00000005", "manifest.json")) as f:
        assert json.load(f)["meta"]["rank"] == 8


# ---------------------------------------------------------------------------
# the spectrum probe
# ---------------------------------------------------------------------------


def test_spectrum_logger_measures_effective_rank():
    p = _params()
    opt = make_optimizer("galore-sara-adam", _t(p), **_kw())
    logger = SpectrumLogger(opt.specs)
    assert list(logger.probe) == [0]
    params = _t(p)
    logger.capture_before(params, 0)
    idx, _ = logger.probe[0]
    leaves = lowrank_lib.tree_leaves(params)
    probe = leaves[idx]
    u = torch.ones(tuple(probe.shape[:-1]) + (1,))
    v = torch.ones((1, probe.shape[-1]))
    after = lowrank_lib.tree_unflatten(params, [x + 0.1 * (u @ v) if i == idx else x
                                                for i, x in enumerate(leaves)])
    rec = logger.observe(after, step=0, group=0)
    assert rec is not None and rec["effective_rank"] == pytest.approx(1.0, abs=0.2)
    assert logger.effective_rank_for(0) == rec["effective_rank"]
    assert logger.observe(after, step=1, group=0) is None  # no capture, no reading
    # JAX's logger picks the same probe and reads the same effective rank
    jopt = jax_make_optimizer("galore-sara-adam", _j(p), **_kw())
    jlog = JaxSpectrumLogger(jopt.specs)
    assert jlog.probe == logger.probe
    jlog.capture_before(_j(p), 0)
    jrec = jlog.observe(_j(jax.tree_util.tree_map(np.asarray, bridge.params_to_numpy(after))),
                        step=0, group=0)
    np.testing.assert_allclose(rec["effective_rank"], jrec["effective_rank"], rtol=1e-5)
    np.testing.assert_allclose(rec["top_singular_value"], jrec["top_singular_value"], rtol=1e-6)
