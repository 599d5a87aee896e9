"""The port's checkpoints (``src/repro_torch/train/checkpoint.py``) against
the JAX package's format, on the CPU.

* The format: for each inner x engine on ``get_config("llama3-8b",
  smoke=True)``, one state (a hot update by JAX, carried to the port
  with ``bridge``) written by both packages gives the same
  manifest keys, shapes, dtypes and file names, and the same bytes in
  every file except ``.opt_state.key``; each package reads the other's.
* The manager's cases of ``tests/test_checkpoint_and_data.py`` (roundtrip,
  retention, corruption, partial writes, async save, shape and leaf
  mismatches, fallback, crashes mid-write, retries, the retention guard),
  with a small fault-injecting ``CheckpointIO`` of this file's own.
* Train -> serve: ``load_params_latest`` into a bf16 skeleton equals JAX's
  bit for bit, and ``launch/serve.py --ckpt`` serves the bridged params'
  tokens.
"""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.core import make_optimizer as jax_make_optimizer
from repro.models import build_model as jax_build_model
from repro.train import checkpoint as jax_ckpt
from repro.train.state import TrainState as JaxTrainState
from repro.train.state import checkpoint_converters as jax_converters
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.core import make_optimizer
from repro_torch.core.lowrank import TorchDraws, flatten_with_path, tree_leaves
from repro_torch.models import build_model
from repro_torch.serve.engine import ContinuousEngine
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.state import TrainState, checkpoint_converters

# One intra-op thread: the test workers share the host's cores, and the
# port's results do not depend on the thread count (core/svd.py).
torch.set_num_threads(1)

INNERS = ["adam", "msgd", "adam-mini", "adam8bit"]
ENGINES = ["reference", "bucketed"]
OPT_KW = dict(rank=8, svd_backend="randomized", grad_clip_norm=1.0)


def _torch_tree(tree):
    return bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")


@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_get_config("llama3-8b", smoke=True).with_(dtype=jnp.float32)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32) * 0.01), jparams)
    return dict(jparams=jparams, grads=grads)


def _states(smoke, inner, engine):
    """One state in both packages: JAX's after a hot update (nonzero
    moments, 8-bit codes and scales), and the port's carried from it (its
    draw source fresh, TorchDraws(0)).  Refreshed states cross between the
    packages in ``test_torch_resume.py``."""
    name = f"galore-sara-{inner}"
    jopt = jax_make_optimizer(name, smoke["jparams"], engine=engine, **OPT_KW)
    hot = jax.jit(lambda g, st, p: jopt.update(g, st, p, refresh=False, apply=True))
    params, st, _ = hot(smoke["grads"], jopt.init(smoke["jparams"]), smoke["jparams"])
    jstate = JaxTrainState(params, st)
    tparams = _torch_tree(params)
    topt = make_optimizer(name, tparams, engine=engine, **OPT_KW)
    tstate = TrainState(tparams, bridge.opt_state_from_numpy(
        topt, jax.tree_util.tree_map(np.asarray, st), "cpu"))
    return jopt, jstate, topt, tstate


def _manifest(base, step):
    with open(os.path.join(base, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def _assert_states_equal(a, b, skip=()):
    """Two port states bit for bit, leaf by leaf, through the checkpoint's
    own walk (so step and draw source are compared as their leaves)."""
    ia, ib = ckpt.tree_items(a), ckpt.tree_items(b)
    assert [p for p, _ in ia] == [p for p, _ in ib]
    for (path, x), (_, y) in zip(ia, ib):
        if path in skip:
            continue
        x, y = (torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor) else v
                for v in (x, y))
        assert x.dtype == y.dtype and torch.equal(x, y), path


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("inner", INNERS)
def test_format_matches_jax_and_reads_both_ways(smoke, tmp_path, inner, engine):
    jopt, jstate, topt, tstate = _states(smoke, inner, engine)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jcan, jloc = jax_converters(jopt)
    jax_ckpt.CheckpointManager(jdir, canonicalize=jcan, localize=jloc).save(jstate, 2)
    tcan, tloc = checkpoint_converters(topt)
    ckpt.CheckpointManager(tdir, canonicalize=tcan, localize=tloc).save(tstate, 2)
    jm, tm = _manifest(jdir, 2), _manifest(tdir, 2)
    assert tm["step"] == jm["step"] == 2
    assert list(tm["leaves"]) == list(jm["leaves"])  # keys, in JAX's order
    assert ".opt_state.key" in tm["leaves"]
    assert not any(".buckets" in k for k in tm["leaves"])  # canonical layout
    for path, je in jm["leaves"].items():
        te = tm["leaves"][path]
        for field in ("file", "shape", "dtype"):
            assert te[field] == je[field], (path, field)
        if path == ".opt_state.key":
            continue
        assert te["sha256"] == je["sha256"], path
        with open(os.path.join(jdir, "step_00000002", je["file"]), "rb") as f1, \
                open(os.path.join(tdir, "step_00000002", te["file"]), "rb") as f2:
            assert f1.read() == f2.read(), path
    # the port reads JAX's checkpoint: the same state, the key by the rule
    loaded = ckpt.CheckpointManager(jdir, canonicalize=tcan, localize=tloc).load(
        TrainState(tstate.params, topt.init(tstate.params)))
    assert bool(loaded.opt_state.buckets) == (topt.state_layout is not None)
    _assert_states_equal(loaded, tstate, skip=(".opt_state.key",))
    jkey = np.asarray(jstate.opt_state.key)
    assert loaded.opt_state.draws.key().tolist() == jkey.tolist()
    # and JAX reads the port's: the same state, the key [refreshes, seed]
    jloaded = jax_ckpt.CheckpointManager(tdir, canonicalize=jcan, localize=jloc).load(jstate)
    jl = jax.tree_util.tree_flatten_with_path(jloaded)[0]
    jw = dict(jax.tree_util.tree_flatten_with_path(jstate)[0])
    for p, x in jl:
        want = jw[p]
        if jax.tree_util.keystr(p) == ".opt_state.key":
            assert np.asarray(x).tolist() == [0, 0]  # TorchDraws(0): fresh
            continue
        np.testing.assert_array_equal(np.asarray(x), np.asarray(want),
                                      err_msg=jax.tree_util.keystr(p))


def test_draw_key_rule_round_trips_and_reads_jax_fresh_keys():
    d = TorchDraws(7, "cpu", refreshes=3)
    assert d.key().dtype == np.uint32 and d.key().tolist() == [3, 7]
    back = TorchDraws.from_key(d.key(), "cpu")
    assert (back.seed, back.refreshes) == (7, 3)
    # JAX's fresh key for a seed is the port's fresh source for it
    fresh = TorchDraws.from_key(np.asarray(jax.random.PRNGKey(5)), "cpu")
    assert (fresh.seed, fresh.refreshes) == (5, 0)
    # a key after refreshes reads as some (seed, refreshes) and writes back
    k = np.asarray(jax.random.split(jax.random.PRNGKey(5))[0])
    assert TorchDraws.from_key(k, "cpu").key().tolist() == k.tolist()
    with pytest.raises(ValueError):
        TorchDraws(2**32, "cpu").key()
    with pytest.raises(ValueError):
        TorchDraws.from_key(np.zeros(3, np.uint32), "cpu")


def test_bf16_leaf_is_refused(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path / "ck"), save_retries=0)
    with pytest.raises(RuntimeError, match="bf16"):
        mgr.save({"w": torch.ones(3, dtype=torch.bfloat16)}, 1)
    assert ckpt.latest_step(str(tmp_path / "ck")) is None


# ---------------------------------------------------------------------------
# the manager's cases, as tests/test_checkpoint_and_data.py
# ---------------------------------------------------------------------------


@pytest.fixture()
def tmp_ckpt(tmp_path):
    return str(tmp_path / "ckpt")


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((8, 16), generator=g), "b": torch.zeros((16,))},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _zeros_like(tree):
    return {k: _zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}


def _assert_trees_equal(a, b):
    ia, ib = ckpt.tree_items(a), ckpt.tree_items(b)
    assert [p for p, _ in ia] == [p for p, _ in ib]
    for (path, x), (_, y) in zip(ia, ib):
        assert x.dtype == y.dtype and torch.equal(x, y), path


class FaultyIO(ckpt.CheckpointIO):
    """Write errors on chosen save ordinals (raised before any byte lands,
    ``times`` attempts in all) and post-commit corruption of one leaf."""

    def __init__(self, write_errors=None, corrupt_ordinal=None):
        self.write_errors = dict(write_errors or {})  # ordinal -> attempts to fail
        self.corrupt_ordinal = corrupt_ordinal
        self._ordinal = -1

    def begin(self, save_ordinal, attempt):
        self._ordinal = save_ordinal

    def save_leaf(self, fpath, arr):
        if self.write_errors.get(self._ordinal, 0) > 0:
            self.write_errors[self._ordinal] -= 1
            raise IOError(f"injected write error (save #{self._ordinal})")
        super().save_leaf(fpath, arr)

    def commit(self, tmp, final):
        super().commit(tmp, final)
        if self._ordinal == self.corrupt_ordinal:
            _corrupt_leaf(os.path.dirname(final), int(os.path.basename(final)[5:]))


def _corrupt_leaf(base, step):
    cdir = os.path.join(base, f"step_{step:08d}")
    victim = sorted(f for f in os.listdir(cdir) if f.endswith(".npy"))[0]
    with open(os.path.join(cdir, victim), "r+b") as f:
        f.seek(100)
        f.write(b"\xde\xad\xbe\xef")


def test_roundtrip(tmp_ckpt):
    st = _state()
    mgr = ckpt.CheckpointManager(tmp_ckpt, keep=2)
    mgr.save(st, 10)
    _assert_trees_equal(mgr.load(_zeros_like(st)), st)
    assert mgr.last_load["step"] == 10 and mgr.last_save["bytes"] == 8 * 16 * 4 + 16 * 4 + 4


def test_retention(tmp_ckpt):
    mgr = ckpt.CheckpointManager(tmp_ckpt, keep=2)
    for s in (10, 20, 30, 40):
        mgr.save(_state(), s)
    assert ckpt.latest_step(tmp_ckpt) == 40
    assert sorted(os.listdir(tmp_ckpt)) == ["step_00000030", "step_00000040"]


def test_corruption_detected(tmp_ckpt):
    mgr = ckpt.CheckpointManager(tmp_ckpt, keep=2)
    st = _state()
    mgr.save(st, 10)
    _corrupt_leaf(tmp_ckpt, 10)
    with pytest.raises(IOError):
        mgr.load(_zeros_like(st))


def test_partial_write_is_not_loadable(tmp_ckpt):
    mgr = ckpt.CheckpointManager(tmp_ckpt, keep=2)
    mgr.save(_state(), 10)
    os.makedirs(os.path.join(tmp_ckpt, "step_00000020.tmp"))
    assert ckpt.latest_step(tmp_ckpt) == 10


def test_async_save(tmp_ckpt):
    mgr = ckpt.CheckpointManager(tmp_ckpt, keep=2)
    st = _state()
    w0 = st["params"]["w"].clone()
    mgr.save(st, 10, blocking=False)
    st["params"]["w"].add_(1.0)  # the snapshot was taken before save returned
    mgr.wait()
    assert ckpt.latest_step(tmp_ckpt) == 10
    assert torch.equal(mgr.load(_zeros_like(st))["params"]["w"], w0)


def test_shape_mismatch_rejected(tmp_ckpt):
    mgr = ckpt.CheckpointManager(tmp_ckpt, keep=2)
    mgr.save(_state(), 10)
    bad = {"params": {"w": torch.zeros((4, 4)), "b": torch.zeros((16,))},
           "step": torch.zeros((), dtype=torch.int32)}
    with pytest.raises(ValueError):
        mgr.load(bad)


def test_missing_leaf_rejected(tmp_ckpt):
    mgr = ckpt.CheckpointManager(tmp_ckpt, keep=2)
    mgr.save(_state(), 10)
    bigger = dict(_state())
    bigger["extra"] = torch.zeros((3,))
    with pytest.raises(KeyError):
        mgr.load(bigger)


def test_load_latest_falls_back_past_corruption(tmp_ckpt):
    mgr = ckpt.CheckpointManager(tmp_ckpt, keep=3)
    st10 = _state(seed=1)
    mgr.save(st10, 10)
    mgr.save(_state(seed=2), 20)
    _corrupt_leaf(tmp_ckpt, 20)
    out, step = mgr.load_latest(_zeros_like(st10))
    assert step == 10
    _assert_trees_equal(out, st10)
    assert mgr.fallbacks and mgr.fallbacks[0][0] == 20


def test_load_latest_reraises_when_nothing_valid(tmp_ckpt):
    mgr = ckpt.CheckpointManager(tmp_ckpt, keep=3)
    st = _state()
    mgr.save(st, 10)
    _corrupt_leaf(tmp_ckpt, 10)
    with pytest.raises(IOError):
        mgr.load_latest(_zeros_like(st))


def test_crash_between_manifest_and_rename(tmp_ckpt):
    mgr = ckpt.CheckpointManager(tmp_ckpt, keep=3)
    st = _state()
    mgr.save(st, 10)
    shutil.copytree(os.path.join(tmp_ckpt, "step_00000010"),
                    os.path.join(tmp_ckpt, "step_00000020.tmp"))
    assert ckpt.latest_step(tmp_ckpt) == 10
    assert mgr.load_latest(_zeros_like(st))[1] == 10
    mgr.save(_state(seed=5), 20)  # the stale .tmp must not block the real save
    assert ckpt.latest_step(tmp_ckpt) == 20
    assert ckpt.verify_checkpoint(tmp_ckpt, 20)


def test_crash_between_leaf_writes(tmp_ckpt):
    mgr = ckpt.CheckpointManager(tmp_ckpt, keep=3)
    st = _state(seed=3)
    mgr.save(st, 10)
    tdir = os.path.join(tmp_ckpt, "step_00000020.tmp")
    os.makedirs(tdir)
    np.save(os.path.join(tdir, "partial.npy"), np.zeros(4))
    out, step = mgr.load_latest(_zeros_like(st))
    assert step == 10
    _assert_trees_equal(out, st)


def test_save_retries_transient_write_error(tmp_ckpt):
    mgr = ckpt.CheckpointManager(tmp_ckpt, keep=2, io=FaultyIO({0: 1}), retry_backoff_s=0.0)
    mgr.save(_state(), 10)  # the first attempt fails, the retry succeeds
    assert mgr.retries_performed == 1
    assert ckpt.verify_checkpoint(tmp_ckpt, 10)


def test_save_failure_surfaces_after_retry_budget(tmp_ckpt):
    mgr = ckpt.CheckpointManager(tmp_ckpt, keep=2, io=FaultyIO({0: 9}), save_retries=2,
                                 retry_backoff_s=0.0)
    with pytest.raises(RuntimeError, match="checkpoint failed"):
        mgr.save(_state(), 10)
    assert mgr.retries_performed == 2
    assert ckpt.latest_step(tmp_ckpt) is None


def test_async_save_failure_surfaces_on_next_save(tmp_ckpt):
    mgr = ckpt.CheckpointManager(tmp_ckpt, keep=2, io=FaultyIO({0: 9}), save_retries=1,
                                 retry_backoff_s=0.0)
    mgr.save(_state(), 10, blocking=False)
    with pytest.raises(RuntimeError, match="checkpoint failed"):
        mgr.save(_state(), 20)
    mgr.save(_state(), 30)  # the error was surfaced once; the manager goes on
    assert ckpt.checkpoint_dirs(tmp_ckpt) == [30]


def test_retention_never_deletes_newest_verified(tmp_ckpt):
    mgr = ckpt.CheckpointManager(tmp_ckpt, keep=1, io=FaultyIO(corrupt_ordinal=1))
    st10 = _state(seed=1)
    mgr.save(st10, 10)
    mgr.save(_state(seed=2), 20)  # committed, then corrupted before retention
    assert sorted(os.listdir(tmp_ckpt)) == ["step_00000010", "step_00000020"]
    assert not ckpt.verify_checkpoint(tmp_ckpt, 20)
    assert mgr.load_latest(_zeros_like(st10))[1] == 10


def test_sharded_checkpoint_raises_not_silently(tmp_ckpt):
    """A manifest of the sharded format is read as one, as JAX's manager
    reads it (here one with no stacks: every leaf replicated); one that
    lacks a leaf raises, as in the canonical format."""
    mgr = ckpt.CheckpointManager(tmp_ckpt)
    st = _state()
    mgr.save(st, 10)
    mpath = os.path.join(tmp_ckpt, "step_00000010", "manifest.json")
    with open(mpath) as f:
        man = json.load(f)
    man.update(format="sharded", num_shards=1, sharded={})
    with open(mpath, "w") as f:
        json.dump(man, f)
    assert ckpt.checkpoint_format(tmp_ckpt, 10) == "sharded"
    _assert_trees_equal(mgr.load(_zeros_like(st)), st)
    man["leaves"].pop(next(iter(man["leaves"])))
    with open(mpath, "w") as f:
        json.dump(man, f)
    with pytest.raises(KeyError, match="missing leaf"):
        mgr.load(_zeros_like(st))


# ---------------------------------------------------------------------------
# train -> serve
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_ckpt_dir(smoke, tmp_path_factory):
    """A JAX-written checkpoint of the smoke model (bucketed adam) at step 2."""
    base = str(tmp_path_factory.mktemp("jaxckpt") / "ck")
    jopt, jstate, _, _ = _states(smoke, "adam", "bucketed")
    can, loc = jax_converters(jopt)
    jax_ckpt.CheckpointManager(base, canonicalize=can, localize=loc).save(jstate, 2)
    return base, jstate


def test_load_params_latest_into_bf16_matches_jax(jax_ckpt_dir):
    base, jstate = jax_ckpt_dir
    jlike = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jstate.params)
    jparams, jstep = jax_ckpt.load_params_latest(base, jlike)
    tlike = jax.tree_util.tree_map(lambda x: x.to(torch.bfloat16), _torch_tree(jstate.params))
    tparams, tstep = ckpt.load_params_latest(base, tlike)
    assert tstep == jstep == 2
    jflat = dict((jax.tree_util.keystr(p), x) for p, x in
                 jax.tree_util.tree_flatten_with_path(jparams)[0])
    for path, x in flatten_with_path(tparams):
        assert x.dtype == torch.bfloat16
        want = np.asarray(jflat[path]).view(np.uint16)
        np.testing.assert_array_equal(x.view(torch.int16).numpy().view(np.uint16), want,
                                      err_msg=path)
    # the rounding is not a truncation: some leaf rounds up somewhere
    f32 = _torch_tree(jstate.params)
    trunc = [(x.view(torch.int32) >> 16).to(torch.int16) for x in tree_leaves(f32)]
    assert any(not torch.equal(t, x.view(torch.int16))
               for t, x in zip(trunc, tree_leaves(tparams)))


def test_load_params_latest_walks_past_a_corrupt_newest(jax_ckpt_dir, tmp_path):
    base, jstate = jax_ckpt_dir
    work = str(tmp_path / "ck")
    shutil.copytree(base, work)
    shutil.copytree(os.path.join(work, "step_00000002"), os.path.join(work, "step_00000005"))
    with open(os.path.join(work, "step_00000005", "_params_embed.npy"), "r+b") as f:
        f.seek(200)
        f.write(b"\x00\x01\x02\x03")
    like = _torch_tree(jstate.params)
    _, step = ckpt.load_params_latest(work, like)
    assert step == 2
    with pytest.raises(FileNotFoundError):
        ckpt.load_params_latest(str(tmp_path / "none"), like)


def test_serve_launcher_ckpt_serves_the_bridged_params(jax_ckpt_dir, capsys):
    from repro_torch.launch import serve as launch_serve

    base, jstate = jax_ckpt_dir
    args = dict(prompt_len=12, new_tokens=4, requests=3, max_slots=2, page_size=8, seed=0)
    launch_serve.main(["--smoke", "--device", "cpu", "--continuous", "--ckpt", base,
                       "--prompt-len", "12", "--new-tokens", "4", "--requests", "3",
                       "--max-slots", "2", "--page-size", "8"])
    out = capsys.readouterr().out
    assert f"restored params from {base} step 2" in out
    served = json.loads(out.strip().splitlines()[-1])
    # the launcher's own requests, on the bridged params
    cfg = get_config("llama3-8b", smoke=True).with_(dtype=torch.float32)
    eng = ContinuousEngine(
        build_model(cfg, device="cpu"), _torch_tree(jstate.params),
        max_slots=args["max_slots"], page_size=args["page_size"],
        max_seq_len=args["prompt_len"] + args["new_tokens"] + args["page_size"])
    rng = np.random.default_rng(args["seed"] + 1)
    for i in range(args["requests"]):
        eng.submit(rng.integers(0, cfg.vocab_size, (args["prompt_len"],)), args["new_tokens"],
                   arrival=i)
    results = eng.run()
    assert served == results[min(results)].tokens.tolist()
    # and not the seeded random weights' tokens
    launch_serve.main(["--smoke", "--device", "cpu", "--continuous",
                       "--prompt-len", "12", "--new-tokens", "4", "--requests", "3",
                       "--max-slots", "2", "--page-size", "8"])
    fresh = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert fresh != served
