"""Checkpoints of the paper's baselines between the port and the JAX
package, on the CPU, in the canonical per-leaf format
(``src/repro_torch/train/checkpoint.py``): Adafactor's per-leaf state
(manifest keys ``.inner.m``, ``.inner.vr``, ``.inner.vc``, ``.inner.v``,
with the (1,) placeholders), Fira's per-leaf Adam state, and the
bucket-native states of online_pca, golore and grass, converted to and
from the canonical layout on the bucketed engine.

For each optimizer one state -- JAX's after a refresh and a hot update,
carried to the port with ``bridge`` -- is written by both packages: the
same manifest keys, shapes, dtypes and file names, the same bytes in every
file but ``.opt_state.key``; each package reads the other's.  Then the run
resumes: the port's next hot step from JAX's checkpoint meets JAX's from
its own state, fed the same gradients, to 1e-6.
"""
import jax
import numpy as np
import pytest

from repro.core import make_optimizer as jax_make_optimizer
from repro.train import checkpoint as jax_ckpt
from repro.train.state import TrainState as JaxTrainState
from repro.train.state import checkpoint_converters as jax_converters
from repro_torch import bridge
from repro_torch.core import make_optimizer
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.state import TrainState, checkpoint_converters
from test_torch_checkpoint import (  # noqa: F401  (smoke is a fixture)
    _assert_states_equal,
    _manifest,
    _torch_tree,
    smoke,
)

OPT_KW = dict(rank=8, svd_backend="randomized", grad_clip_norm=1.0, engine="bucketed")
NAMES = ["galore-sara-adafactor", "fira-sara-adam", "online-pca-adam", "golore-adam",
         "grass-adam"]
HOT_TOL = dict(atol=1e-6, rtol=0)


def _states(smoke, name):
    jopt = jax_make_optimizer(name, smoke["jparams"], **OPT_KW)
    g = smoke["grads"]
    params, st, _ = jopt.update(g, jopt.init(smoke["jparams"]), smoke["jparams"],
                                refresh=True, apply=True)
    params, st, _ = jopt.update(g, st, params, refresh=False, apply=True)
    jstate = JaxTrainState(params, st)
    tparams = _torch_tree(params)
    topt = make_optimizer(name, tparams, **OPT_KW)
    tstate = TrainState(tparams, bridge.opt_state_from_numpy(
        topt, jax.tree_util.tree_map(np.asarray, st), "cpu"))
    return jopt, jstate, topt, tstate


@pytest.mark.parametrize("name", NAMES)
def test_baseline_checkpoints_cross_packages_and_resume(smoke, tmp_path, name):
    jopt, jstate, topt, tstate = _states(smoke, name)
    bucket_native = name in ("online-pca-adam", "golore-adam", "grass-adam")
    assert (topt.state_layout is not None) == bucket_native
    assert (jopt.state_layout is not None) == bucket_native
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jcan, jloc = jax_converters(jopt)
    jax_ckpt.CheckpointManager(jdir, canonicalize=jcan, localize=jloc).save(jstate, 2)
    tcan, tloc = checkpoint_converters(topt)
    ckpt.CheckpointManager(tdir, canonicalize=tcan, localize=tloc).save(tstate, 2)
    jm, tm = _manifest(jdir, 2), _manifest(tdir, 2)
    assert list(tm["leaves"]) == list(jm["leaves"])  # keys, in JAX's order
    assert not any(".buckets" in k for k in tm["leaves"])  # canonical layout
    if name.endswith("adafactor"):
        q = ".opt_state.leaves['blocks']['q_proj'].inner"
        assert [tm["leaves"][f"{q}.{f}"]["shape"] for f in ("m", "vr", "vc", "v")] == \
            [jm["leaves"][f"{q}.{f}"]["shape"] for f in ("m", "vr", "vc", "v")]
        assert tm["leaves"][f"{q}.v"]["shape"] == [1]
        assert tm["leaves"][".opt_state.leaves['final_norm'].inner.vr"]["shape"] == [1]
    for path, je in jm["leaves"].items():
        te = tm["leaves"][path]
        for field in ("file", "shape", "dtype"):
            assert te[field] == je[field], (path, field)
        if path != ".opt_state.key":
            assert te["sha256"] == je["sha256"], path
    # the port reads JAX's checkpoint, and JAX reads the port's
    loaded = ckpt.CheckpointManager(jdir, canonicalize=tcan, localize=tloc).load(
        TrainState(tstate.params, topt.init(tstate.params)))
    assert bool(loaded.opt_state.buckets) == bucket_native
    _assert_states_equal(loaded, tstate, skip=(".opt_state.key",))
    jloaded = jax_ckpt.CheckpointManager(tdir, canonicalize=jcan, localize=jloc).load(jstate)
    for (p, x), (_, want) in zip(jax.tree_util.tree_flatten_with_path(jloaded)[0],
                                 jax.tree_util.tree_flatten_with_path(jstate)[0]):
        if jax.tree_util.keystr(p) != ".opt_state.key":
            np.testing.assert_array_equal(np.asarray(x), np.asarray(want),
                                          err_msg=jax.tree_util.keystr(p))
    # resume: the next hot step from the loaded state meets JAX's
    g = smoke["grads"]
    jp, _, _ = jopt.update(g, jstate.opt_state, jstate.params, refresh=False, apply=True)
    tp, _, _ = topt.update(_torch_tree(g), loaded.opt_state, loaded.params, refresh=False,
                           apply=True)
    ja = jax.tree_util.tree_flatten_with_path(jp)[0]
    tb = ckpt.tree_items(tp)
    for (path, a), (_, b) in zip(ja, tb):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), err_msg=jax.tree_util.keystr(path),
                                   **HOT_TOL)
