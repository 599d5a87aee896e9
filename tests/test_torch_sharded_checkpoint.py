"""The port's ZeRO layout and shard-parallel checkpoints against the JAX
package's, on the CPU in one process (``tests/test_multihost_recovery.py``'s
``zsetup``: the smoke llama at f32, ``galore-sara-adam`` bucketed with the
randomized SVD, rank 8, tau 4, seq 32, global batch 4, ``state_sharding=
"zero"`` at 2, 4 and 8 shards, 3 steps: a refresh and 2 hot).

  * The port's single-process ZeRO run (4 shards) follows JAX's
    trajectory from JAX's params, batches and draws (``JaxDraws``) within
    ``REFRESH_TOL``, with JAX's padded stack shapes.
  * The ``zero_*`` helpers, ``init_bucket_states``, ``bucket_canonical_rows``,
    ``modeled_state_bytes``, ``sharded_ckpt_model`` and ``dp_comm_model``
    equal JAX's, bit for bit, on the same inputs.
  * JAX's step-3 state carried to the port (``bridge``, its key kept):
    the port's 4-writer sharded save has JAX's manifests (but for the
    ``meta`` that JAX's merge overwrites, ROADMAP queue 3) and JAX's bytes
    in every file; JAX's ``CheckpointManager`` reads it at 2 and 8 shards
    and the port reads JAX's, both bit-equal.
  * The manager's sharded cases as JAX's: a corrupt or missing shard
    walked past, a divergent manifest refused and retried, the commit
    barrier's timeout and two disjoint writers.
  * Each error JAX raises in this slice, the port raises too.

Tolerances: ``REFRESH_TOL`` (5e-5 abs on params, ``test_torch_train.py``:
torch's and jaxlib's LAPACK differ in the small singular vectors, which
SARA samples); everything else is bit-equal.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.core import buckets as jax_buckets
from repro.core import lowrank as jax_lowrank
from repro.core import make_optimizer as jax_make_optimizer
from repro.data.synthetic import SyntheticDataConfig, SyntheticDataset
from repro.launch.mesh import make_mesh as jax_make_mesh
from repro.models import build_model as jax_build_model
from repro.train import checkpoint as jax_ckpt
from repro.train import state as jax_state
from repro.train.state import TrainState as JaxTrainState
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.core import buckets
from repro_torch.core import lowrank
from repro_torch.core import make_optimizer
from repro_torch.core.lowrank import tree_leaves
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import build_model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import state as state_lib
from repro_torch.train.faults import FaultPlan, FaultSpec
from repro_torch.train.state import TrainState
from repro_torch.train.step import make_train_step
from test_torch_optim_kernels import JaxDraws

# One intra-op thread: the test workers share the host's cores, and the
# port's results do not depend on the thread count (core/svd.py).
torch.set_num_threads(1)

REFRESH_TOL = dict(atol=5e-5, rtol=0)
KW = dict(rank=8, tau=4, lr=2e-3, engine="bucketed", svd_backend="randomized")
SHARDS = (2, 4, 8)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


@pytest.fixture(scope="module")
def zsetup():
    jcfg = jax_get_config("llama3-8b", smoke=True).with_(dtype=jnp.float32)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    data = SyntheticDataset(SyntheticDataConfig(vocab_size=jcfg.vocab_size, seq_len=32,
                                                global_batch=4))
    batches = [data.batch_at(i) for i in range(3)]
    jopts = {s: jax_make_optimizer("galore-sara-adam", jparams, state_sharding="zero",
                                   state_shards=s, **KW) for s in SHARDS}
    jfns = jax_make_train_step(jmodel, jopts[4], donate=False)
    jstate = JaxTrainState(jparams, jopts[4].init(jparams))
    jstate, _ = jfns["jit_refresh_step"](jstate, batches[0], group=0)
    for b in batches[1:]:
        jstate, _ = jfns["jit_step"](jstate, b)
    tcfg = get_config("llama3-8b", smoke=True).with_(dtype=torch.float32)
    tparams = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    topts = {s: make_optimizer("galore-sara-adam", tparams, state_sharding="zero",
                               state_shards=s, **KW) for s in SHARDS}
    # JAX's state carried to the port, its key kept as the draw source's
    tstate = TrainState(
        bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jstate.params), "cpu"),
        bridge.opt_state_from_numpy(topts[4], jax.tree_util.tree_map(
            np.asarray, jstate.opt_state), "cpu")._replace(
            draws=JaxDraws(jnp.asarray(np.asarray(jstate.opt_state.key)))))
    return dict(jmodel=jmodel, jparams=jparams, batches=batches, jopts=jopts, jstate=jstate,
                tmodel=build_model(tcfg, device="cpu"), tparams=tparams, topts=topts,
                tstate=tstate)


def _tbatch(b):
    return {k: _t(v) for k, v in b.items()}


def test_zero_trajectory_follows_jax(zsetup):
    """The port's single-process ZeRO step at 4 shards, refresh + 2 hot,
    from JAX's params, batches and draws: JAX's padded shapes, zero pad
    rows, params within REFRESH_TOL."""
    z = zsetup
    opt = z["topts"][4]
    fns = make_train_step(z["tmodel"], opt)
    state = TrainState(z["tparams"], opt.init(z["tparams"])._replace(
        draws=JaxDraws(jax.random.PRNGKey(0))))
    state, _ = fns["refresh_step"](state, _tbatch(z["batches"][0]), group=0)
    for b in z["batches"][1:]:
        state, _ = fns["step"](state, _tbatch(b))
    assert state.opt_state.step == int(z["jstate"].opt_state.step) == 3
    for bucket, tb, jb in zip(opt.bucket_plan.buckets, state.opt_state.buckets,
                              z["jstate"].opt_state.buckets):
        for x, y in zip(tb, jb):
            if x is None:
                assert y is None
                continue
            assert tuple(x.shape) == tuple(y.shape)
            assert not bool(x[bucket.batch:].any()) and not np.asarray(y)[bucket.batch:].any()
    jl = [np.asarray(x) for x in jax.tree_util.tree_leaves(z["jstate"].params)]
    for a, b in zip(tree_leaves(state.params), jl):
        np.testing.assert_allclose(_np(a), b, **REFRESH_TOL)


@pytest.mark.parametrize("shards", SHARDS)
def test_zero_layout_and_helpers_equal_jax(zsetup, shards):
    """On the same numbers: the layout, ``init_bucket_states``, the pad and
    unpad of states and of gradient stacks, each shard's rows of the state
    and of the W stacks, and the scatter of full stacks to leaves."""
    z = zsetup
    jopt, topt = z["jopts"][shards], z["topts"][shards]
    jl, tl = jopt.state_layout, topt.state_layout
    assert tl.shards == jl.shards == shards
    assert [(b.d, b.n, b.rank, b.batch) for b in tl.plan.buckets] == \
        [(b.d, b.n, b.rank, b.batch) for b in jl.plan.buckets]
    for b in range(1, 20):
        assert buckets.zero_padded_batch(b, shards) == jax_buckets.zero_padded_batch(b, shards)

    def eq(tstates, jstates):
        for tb, jb in zip(tstates, jstates):
            for x, y in zip(tb, jb):
                assert (x is None) == (y is None)
                if x is not None:
                    assert x.dtype == _t(y).dtype
                    np.testing.assert_array_equal(_np(x), np.asarray(y))

    eq(buckets.init_bucket_states(tl, "cpu"), jax_buckets.init_bucket_states(jl))
    # a real state, unpadded (the canonical stacks of JAX's step-3 state)
    canon = jax_lowrank.canonical_opt_state(z["jopts"][4], z["jstate"].opt_state)
    jfull = jax_lowrank.storage_opt_state(jopt, canon).buckets
    junp = jax_buckets.zero_unpad_states(jl, jfull)
    tunp = tuple(buckets.BucketState(*(None if x is None else _t(x) for x in b)) for b in junp)
    tfull = buckets.zero_pad_states(tl, tunp)
    eq(tfull, jfull)
    eq(buckets.zero_unpad_states(tl, tfull), junp)
    rng = np.random.default_rng(shards)
    stacks = [rng.standard_normal((b.batch, b.rank, b.n)).astype(np.float32)
              for b in jl.plan.buckets]
    for x, y in zip(buckets.zero_pad_grad_stacks(tl, [_t(s) for s in stacks]),
                    jax_buckets.zero_pad_grad_stacks(jl, [jnp.asarray(s) for s in stacks])):
        np.testing.assert_array_equal(_np(x), np.asarray(y))
    jflat = jax.tree_util.tree_leaves(z["jstate"].params)
    tflat = [_t(x) for x in jflat]
    for k in range(shards):
        eq(buckets.zero_local_states(tl, tfull, k),
           jax_buckets.zero_local_states(jl, jfull, jnp.int32(k)))
        for x, y in zip(buckets.zero_local_param_stacks(tl, tflat, k),
                        jax_buckets.zero_local_param_stacks(jl, jflat, jnp.int32(k))):
            np.testing.assert_array_equal(_np(x), np.asarray(y))
    wst = [jax_buckets._gather(b, jflat) for b in jl.plan.buckets]
    got = buckets.zero_scatter_outputs(tl.plan, [_t(w) for w in wst], tflat)
    want = jax_buckets.zero_scatter_outputs(jl.plan, wst, jflat)
    assert sorted(got) == sorted(want)
    for i in got:
        np.testing.assert_array_equal(_np(got[i]), np.asarray(want[i]))


@pytest.mark.parametrize("inner", ["adam", "msgd", "adam-mini", "adam8bit"])
def test_canonical_rows_and_host_models_equal_jax(zsetup, inner):
    z = zsetup
    name = f"galore-sara-{inner}"
    for shards in (1,) + SHARDS:
        zk = dict(state_sharding="zero", state_shards=shards) if shards > 1 else {}
        jopt = jax_make_optimizer(name, z["jparams"], **KW, **zk)
        topt = make_optimizer(name, z["tparams"], **KW, **zk)
        assert state_lib.bucket_canonical_rows(topt) == jax_state.bucket_canonical_rows(jopt)
        tin, jin = topt.config.inner, jopt.config.inner
        assert buckets.modeled_state_bytes(topt.bucket_plan, tin, shards) == \
            jax_buckets.modeled_state_bytes(jopt.bucket_plan, jin, shards)
        assert buckets.sharded_ckpt_model(topt.bucket_plan, tin, shards) == \
            jax_buckets.sharded_ckpt_model(jopt.bucket_plan, jin, shards)
        tflat = tree_leaves(z["tparams"])
        jflat = jax.tree_util.tree_leaves(z["jparams"])
        for axes in (None, {"pod": 2, "data": 4}):
            got = buckets.dp_comm_model(
                topt.bucket_plan, tflat, axis_sizes=axes, state_shards=shards, inner=tin,
                rank_plans=[(0.25, topt.bucket_plan), (0.75, topt.bucket_plan)])
            want = jax_buckets.dp_comm_model(
                jopt.bucket_plan, jflat, axis_sizes=axes, state_shards=shards, inner=jin,
                rank_plans=[(0.25, jopt.bucket_plan), (0.75, jopt.bucket_plan)])
            assert got == want
    assert state_lib.bucket_canonical_rows(
        make_optimizer(name, z["tparams"], rank=8)) is None  # reference engine


def _spec(n, **kw):
    return ckpt.ShardSpec(num_shards=n, shard_ids=tuple(range(n)), **kw)


def _tmgr(path, opt, shard_spec=None, **kw):
    canon, loc = state_lib.checkpoint_converters(opt)
    return ckpt.CheckpointManager(str(path), canonicalize=canon, localize=loc,
                                  shard_spec=shard_spec,
                                  canonical_rows=state_lib.bucket_canonical_rows(opt), **kw)


def _jmgr(path, opt, shard_spec=None):
    canon, loc = jax_state.checkpoint_converters(opt)
    return jax_ckpt.CheckpointManager(
        str(path), canonicalize=canon, localize=loc, shard_spec=shard_spec,
        canonical_rows=jax_state.bucket_canonical_rows(opt))


def _port_items(state):
    return [(p, _np(x) if isinstance(x, torch.Tensor) else np.asarray(x))
            for p, x in ckpt.tree_items(state)]


def test_sharded_checkpoints_cross_the_packages(zsetup, tmp_path):
    """JAX's step-3 state written with 4 emulated writers by both packages:
    the same manifests and the same bytes in every file; each package reads
    the other's at 2 and 8 shards, bit-equal to its own canonical state."""
    z = zsetup
    tdir, jdir = tmp_path / "port", tmp_path / "jax"
    _tmgr(tdir, z["topts"][4], _spec(4)).save(z["tstate"], 7)
    _jmgr(jdir, z["jopts"][4], jax_ckpt.ShardSpec(num_shards=4, shard_ids=(0, 1, 2, 3))
          ).save(z["jstate"], 7)
    td, jd = tdir / "step_00000007", jdir / "step_00000007"
    assert sorted(os.listdir(td)) == sorted(os.listdir(jd))
    for name in os.listdir(jd):
        a, b = (td / name).read_bytes(), (jd / name).read_bytes()
        if name == "manifest.json":
            # JAX's merge rebinds ``meta`` to the geometry of the last
            # sharded leaf (src/repro/train/checkpoint.py:568), so its
            # manifest carries that as ``meta`` (ROADMAP queue 3); the
            # port writes the caller's (none here)
            ma, mb = json.loads(a), json.loads(b)
            assert "meta" not in ma and set(mb.pop("meta")) == {
                "rows_per_shard", "padded_rows", "canonical_rows", "dtype"}
            assert ma == mb
        elif name.endswith(".json"):
            assert json.loads(a) == json.loads(b), name
        else:
            assert a == b, name
    assert ckpt.verify_checkpoint(str(tdir), 7) and jax_ckpt.verify_checkpoint(str(tdir), 7)
    canon_t = _port_items(state_lib.canonical_train_state(z["topts"][4], z["tstate"]))
    for m in (2, 8):
        # JAX reads the port's
        jskel = JaxTrainState(z["jparams"], z["jopts"][m].init(z["jparams"]))
        got, stp = _jmgr(tdir, z["jopts"][m]).load_latest(jskel)
        assert stp == 7
        want = jax_state.canonical_train_state(z["jopts"][4], z["jstate"])
        gl = jax.tree_util.tree_leaves(jax_state.canonical_train_state(z["jopts"][m], got))
        for x, y in zip(gl, jax.tree_util.tree_leaves(want), strict=True):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        # the port reads JAX's
        tskel = TrainState(z["tparams"], z["topts"][m].init(z["tparams"])._replace(
            draws=JaxDraws(jax.random.PRNGKey(0))))
        got_t, stp = _tmgr(jdir, z["topts"][m]).load_latest(tskel)
        assert stp == 7
        assert [tuple(b.projector.shape)[0] for b in got_t.opt_state.buckets] == [
            buckets.zero_padded_batch(b.batch, m) for b in z["topts"][m].bucket_plan.buckets]
        items = _port_items(state_lib.canonical_train_state(z["topts"][m], got_t))
        assert [p for p, _ in items] == [p for p, _ in canon_t]
        for (p, x), (_, y) in zip(items, canon_t):
            assert x.dtype == y.dtype, p
            np.testing.assert_array_equal(x, y, err_msg=p)


def test_sharded_save_roundtrip_and_manifest(zsetup, tmp_path):
    """The port's own format: the manifest's geometry, the replicated
    section without stacks, a bit-equal storage-layout round trip."""
    z = zsetup
    mgr = _tmgr(tmp_path / "rt", z["topts"][4], _spec(4))
    mgr.save(z["tstate"], 7)
    man = json.loads((tmp_path / "rt" / "step_00000007" / "manifest.json").read_text())
    assert man["format"] == "sharded" and man["num_shards"] == 4 and man["sharded"]
    for path, ent in man["sharded"].items():
        assert ckpt._SHARDED_LEAF_RE.search(path)
        assert len(ent["shards"]) == 4 and ent["rows_per_shard"] * 4 == ent["padded_rows"]
        assert 0 < ent["canonical_rows"] <= ent["padded_rows"]
        assert all(ckpt._SHARD_FILE_RE.search(s["file"]) for s in ent["shards"])
    assert any(".params" in p for p in man["leaves"])
    assert not any(ckpt._SHARDED_LEAF_RE.search(p) for p in man["leaves"])
    skel = TrainState(z["tparams"], z["topts"][4].init(z["tparams"])._replace(
        draws=JaxDraws(jax.random.PRNGKey(0))))
    got, stp = mgr.load_latest(skel)
    assert stp == 7
    for (p, x), (_, y) in zip(_port_items(got), _port_items(z["tstate"]), strict=True):
        np.testing.assert_array_equal(x, y, err_msg=p)
    # a process that holds one block of rows loads that block
    held = ckpt.CheckpointManager(str(tmp_path / "rt"), shard_spec=ckpt.ShardSpec(
        2, (1,), holds=1), canonical_rows=state_lib.bucket_canonical_rows(z["topts"][2]))
    full = z["topts"][2].init(z["tparams"])
    half = tuple(buckets.BucketState(*(None if x is None else x[x.shape[0] // 2:]
                                       for x in b)) for b in full.buckets)
    got2 = held.load(TrainState(z["tparams"], full._replace(
        buckets=half, draws=JaxDraws(jax.random.PRNGKey(0)))))
    want2 = lowrank.storage_opt_state(z["topts"][2], lowrank.canonical_opt_state(
        z["topts"][4], z["tstate"].opt_state))
    for gb, wb in zip(got2.opt_state.buckets, want2.buckets):
        for x, y in zip(gb, wb):
            if x is not None:
                assert torch.equal(x, y[y.shape[0] // 2:])


def test_missing_or_corrupt_shard_walked_past(zsetup, tmp_path):
    z = zsetup
    for kind in ("ckpt_missing_shard", "ckpt_corrupt_shard"):
        plan = FaultPlan([FaultSpec(kind, save_index=1)])
        d = tmp_path / kind
        mgr = _tmgr(d, z["topts"][4], _spec(4), io=plan.checkpoint_io())
        mgr.save(z["tstate"], 5)
        mgr.save(z["tstate"], 10)  # ordinal 1: sabotaged after the commit
        assert plan.fired == [(kind, 1)]
        assert ckpt.verify_checkpoint(str(d), 5) and not ckpt.verify_checkpoint(str(d), 10)
        skel = TrainState(z["tparams"], z["topts"][4].init(z["tparams"])._replace(
            draws=JaxDraws(jax.random.PRNGKey(0))))
        got, stp = mgr.load_latest(skel)
        assert stp == 5 and mgr.fallbacks and mgr.fallbacks[-1][0] == 10
        for (p, x), (_, y) in zip(_port_items(got), _port_items(z["tstate"])):
            np.testing.assert_array_equal(x, y, err_msg=p)


def test_divergent_manifest_refused_and_retried(zsetup, tmp_path):
    z = zsetup
    plan = FaultPlan([FaultSpec("ckpt_divergent_manifest", save_index=0)])
    mgr = _tmgr(tmp_path / "div", z["topts"][4], _spec(4), io=plan.checkpoint_io(),
                retry_backoff_s=0.0)
    mgr.save(z["tstate"], 3)
    assert plan.fired == [("ckpt_divergent_manifest", 0)] and mgr.retries_performed == 1
    assert ckpt.verify_checkpoint(str(tmp_path / "div"), 3)
    plan2 = FaultPlan([FaultSpec("ckpt_divergent_manifest", save_index=0)])
    mgr2 = _tmgr(tmp_path / "div2", z["topts"][4], _spec(4), io=plan2.checkpoint_io(),
                 save_retries=0)
    with pytest.raises(RuntimeError, match="divergent shard manifest"):
        mgr2.save(z["tstate"], 3)
    assert ckpt.checkpoint_dirs(str(tmp_path / "div2")) == []


def test_commit_barrier_timeout_and_disjoint_writers(zsetup, tmp_path):
    z = zsetup
    st2 = TrainState(z["tparams"], z["topts"][2].init(z["tparams"]))
    mgr0 = _tmgr(tmp_path / "bar", z["topts"][2], ckpt.ShardSpec(
        2, (0,), commit_timeout_s=0.2, poll_interval_s=0.01), save_retries=0)
    with pytest.raises(RuntimeError, match="commit barrier timed out"):
        mgr0.save(st2, 4)
    assert ckpt.checkpoint_dirs(str(tmp_path / "bar")) == []
    mgr1 = _tmgr(tmp_path / "bar2", z["topts"][2], ckpt.ShardSpec(2, (1,)))
    mgr_c = _tmgr(tmp_path / "bar2", z["topts"][2], ckpt.ShardSpec(2, (0,),
                                                                   commit_timeout_s=5.0))
    mgr1.save(st2, 4)
    assert ckpt.latest_step(str(tmp_path / "bar2")) is None
    mgr_c.save(st2, 4)
    assert ckpt.verify_checkpoint(str(tmp_path / "bar2"), 4)
    got, stp = mgr_c.load_latest(TrainState(z["tparams"], z["topts"][2].init(z["tparams"])))
    assert stp == 4
    for (p, x), (_, y) in zip(_port_items(got), _port_items(st2)):
        np.testing.assert_array_equal(x, y, err_msg=p)
    assert ckpt.local_shard_ids(4) == (0, 1, 2, 3) == jax_ckpt.local_shard_ids(4)
    assert _spec(4).is_coordinator and not ckpt.ShardSpec(4, (2,)).is_coordinator


def _errors(z):
    """(what, JAX's call, the port's call): each must raise the same type."""
    jp, tp = z["jparams"], z["tparams"]
    jopt, topt = z["jopts"][4], z["topts"][4]
    jmesh = jax_make_mesh((1, 1))
    tmesh = mesh_lib.single_device_mesh()
    jref = jax_make_optimizer("galore-sara-adam", jp, rank=8)
    tref = make_optimizer("galore-sara-adam", tp, rank=8)
    jb = jax_make_optimizer("galore-sara-adam", jp, **KW)
    tb = make_optimizer("galore-sara-adam", tp, **KW)
    js, ts = jb.init(jp), tb.init(tp)
    jsg = jax_lowrank.stack_grads(jb, jp)
    tsg = lowrank.stack_grads(tb, tp)
    return [
        ("unknown compressed mode",
         lambda: jax_make_train_step(z["jmodel"], jb, mesh=jmesh, compressed="pods"),
         lambda: make_train_step(z["tmodel"], tb, mesh=tmesh, compressed="pods")),
        ("needs a mesh",
         lambda: jax_make_train_step(z["jmodel"], jb, compressed="flat"),
         lambda: make_train_step(z["tmodel"], tb, compressed="flat")),
        ("needs a pod axis",
         lambda: jax_make_train_step(z["jmodel"], jb, mesh=jmesh, compressed="pod"),
         lambda: make_train_step(z["tmodel"], tb, mesh=tmesh, compressed="pod")),
        ("state_shards",
         lambda: jax_make_train_step(z["jmodel"], jopt, mesh=jmesh, compressed="flat"),
         lambda: make_train_step(z["tmodel"], topt, mesh=tmesh, compressed="flat")),
        ("unknown state_sharding",
         lambda: jax_make_optimizer("galore-sara-adam", jp, state_sharding="zeros", **KW),
         lambda: make_optimizer("galore-sara-adam", tp, state_sharding="zeros", **KW)),
        ("state_shards must be >= 1",
         lambda: jax_make_optimizer("galore-sara-adam", jp, state_sharding="zero",
                                    state_shards=0, **KW),
         lambda: make_optimizer("galore-sara-adam", tp, state_sharding="zero",
                                state_shards=0, **KW)),
        ("bucket-native state",
         lambda: jax_make_optimizer("galore-sara-adam", jp, rank=8, state_sharding="zero",
                                    state_shards=2),
         lambda: make_optimizer("galore-sara-adam", tp, rank=8, state_sharding="zero",
                                state_shards=2)),
        ("projected gradients cannot drive a refresh",
         lambda: jb.update(jp, js, jp, refresh=True, projected=True),
         lambda: tb.update(tp, ts, tp, refresh=True, projected=True)),
        ("StackedGrads need a bucket-native",
         lambda: jref.update(jsg, jref.init(jp), jp, refresh=True),
         lambda: tref.update(tsg, tref.init(tp), tp, refresh=True)),
        ("StackedGrads hold R-space stacks",
         lambda: jb.update(jsg, js, jp, refresh=False),
         lambda: tb.update(tsg, ts, tp, refresh=False)),
        ("StackedGrads shape mismatch",
         lambda: jb.update(jsg._replace(rest=jsg.rest[1:]), js, jp, refresh=True),
         lambda: tb.update(tsg._replace(rest=tsg.rest[1:]), ts, tp, refresh=True)),
        ("shard_axes is only meaningful",
         lambda: jb.update(jsg, js, jp, refresh=True, shard_axes=("data",)),
         lambda: tb.update(tsg, ts, tp, refresh=True, shard_axes=tmesh.axes(("data",)))),
        ("shard-local updates take StackedGrads",
         lambda: jopt.update(jp, jopt.init(jp), jp, refresh=True, shard_axes=("data",)),
         lambda: topt.update(tp, topt.init(tp), tp, refresh=True,
                             shard_axes=tmesh.axes(("data",)))),
        ("needs a bucket-native optimizer",
         lambda: jax_lowrank.stack_grads(jref, jp),
         lambda: lowrank.stack_grads(tref, tp)),
        ("shards must be >= 1",
         lambda: jax_buckets.build_state_layout(jb.bucket_plan, [], jax.tree_util.tree_leaves(
             jp), inner_name="adam", projector_dtype=jnp.float32, shards=0),
         lambda: buckets.build_state_layout(tb.bucket_plan, [], tree_leaves(tp),
                                            inner_name="adam", shards=0)),
    ]


def test_errors_match_jax(zsetup):
    for what, jcall, tcall in _errors(zsetup):
        with pytest.raises(Exception) as je:
            jcall()
        with pytest.raises(Exception) as te:
            tcall()
        assert je.type is te.type, (what, je.value, te.value)
        assert what in str(je.value) and what in str(te.value), (what, je.value, te.value)
