"""Every optimizer of the port under tensor parallelism and FSDP
(``core/lowrank.tensor_parallel_optimizer`` on any config, the per-leaf
loop on blocks, ``core/inner.py``'s ``Cut``, ``core/buckets.py``'s cut
rows of Adam-mini and 8-bit Adam, the projectors' split refresh), in
spawned gloo worlds (1, 2), (2, 1) and (2, 2) on the CPU
(``tp_worlds.inners_case``; ``tp_worlds.py`` imports no JAX, so the
spawned processes do not).  The eight optimizers of
``tp_worlds.INNER_RUNS``: ``galore-sara-adam-mini`` and
``galore-sara-adam8bit`` (bucketed, cut rows), ``golore-adam``,
``grass-adam`` and ``online-pca-adam`` (bucketed, their refresh on cut
stacks), ``fira-sara-adam`` and ``galore-sara-adafactor`` (the per-leaf
loop) and ``galore-sara-adam`` on the reference engine.  The model: the
smoke llama at f32 with d 128, 4 heads over 2 KV heads and d_ff 384, 1
layer (``tp_worlds.INNERS_MODEL``: at a model extent of 2 the mlp's
192-column blocks end inside 8-bit chunk 0 and cut Adam-mini's rows;
at a data extent of 2 every weight and embed's 128 columns split); rank
8, tau 4, seq 32, global batch 4, the randomized SVD; 3 steps (a refresh,
2 hot).

Bars, each the port's existing one:
  * against the single-process step, from the same state on the world's
    own reduced gradients: ``HOT_LOOP_TOL`` after a hot step (the same
    sums in other orders) and ``REFRESH_TOL`` after a refresh step
    (``test_torch_tensor_parallel.py``); 8-bit codes at most one step
    apart (ROADMAP's +-1);
  * the trajectory from the seed's params: the step-0 loss within
    ``LOSS_TOL``, the params after each step within ``REFRESH_TOL`` on
    all but ``TRAJ_SHARE`` of each leaf's elements and none past one
    step's largest move, lr: full-rank Adam turns the ~1e-8 gradient of a
    token seen once into an O(lr) direction whose sign follows the
    reduction order (``test_torch_family_parallel.py``), and 8-bit Adam
    moves a code by one step on a small second moment
    (``test_torch_inners_train.py``); the processes' params bit-equal;
  * against JAX's single-device step on JAX's params, batch, gradients
    and draws, in the (2, 2) world: ``GRAD_TOL`` on the loss and the
    gradients, ``REFRESH_TOL`` after a refresh, ``HOT_LOOP_TOL`` after a
    hot step from JAX's post-refresh state, 8-bit codes within one step.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.core import make_optimizer as jax_make_optimizer
from repro.data.synthetic import SyntheticDataConfig as JaxDataConfig
from repro.data.synthetic import SyntheticDataset as JaxDataset
from repro.models import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.core import projectors as proj_lib
from repro_torch.core.lowrank import canonical_opt_state, tree_leaves, tree_unflatten
from repro_torch.train.state import TrainState
from repro_torch.train.step import make_train_step
from test_torch_optim_kernels import JaxDraws

import tp_worlds as W

# One intra-op thread: the test workers share the host's cores, and the
# port's results do not depend on the thread count (core/svd.py).
torch.set_num_threads(1)

REFRESH_TOL = 5e-5
HOT_LOOP_TOL = 1e-6
LOSS_TOL = 1e-5
GRAD_TOL = dict(atol=1e-6, rtol=1e-5)
TRAJ_SHARE = 5e-3
# the canonical state after one hot step from one state, against one
# process's: the moments carry the reduced gradient's last bits
STATE_TOL = dict(atol=1e-6, rtol=1e-4)
CODE_STEP = 1
WORLD_TIMEOUT_S = 240
WORLDS = {"w12": (1, 2), "w21": (2, 1), "w22": (2, 2)}
RUNS = list(W.INNER_RUNS)
# the per-leaf loop under TP on the compressed step (its R summed over
# model in ``project_grads``, then reduced over data)
FLAT_RUNS = ["reference", "adafactor"]
JAX_KW = dict(lr=0.01, grad_clip_norm=1.0, tau=200)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _max_err(got, want):
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


def _codes(state):
    return [(st.inner.m_codes, st.inner.v_codes) for st in state.leaves
            if hasattr(st.inner, "m_codes")]


def _state_within(got_state, want_state):
    """Two canonical states leaf by leaf: every f32 tensor (projectors,
    moments, Adam-mini's and Adafactor's row and column statistics, 8-bit
    scales) within ``STATE_TOL``, 8-bit codes within one step."""
    for a, b in zip(got_state.leaves, want_state.leaves):
        pairs = [(a.projector, b.projector)]
        if a.inner is not None:
            pairs += list(zip(a.inner, b.inner))
        for x, y in pairs:
            assert x.shape == y.shape and x.dtype == y.dtype
            if x.dtype == torch.uint8:
                assert int((x.int() - y.int()).abs().max()) <= CODE_STEP
            else:
                torch.testing.assert_close(x, y, **STATE_TOL)


def _codes_within(got_state, want_state):
    pairs = _codes(got_state)
    assert len(pairs) == len(_codes(want_state))
    for (gm, gv), (wm, wv) in zip(pairs, _codes(want_state)):
        for g, w in ((gm, wm), (gv, wv)):
            assert int((g.int() - w.int()).abs().max()) <= CODE_STEP


def _ref_runs(ref_dir):
    """Each optimizer's single-process trajectory from the seed's params,
    its state after step 1 on disk (``inner_<run>_1.pt``)."""
    model, params, data = W.inners_setup()
    out = {}
    for run in RUNS:
        opt = W.inner_optimizer(params, run)
        fns = make_train_step(model, opt)
        state = TrainState(W.copy(params), opt.init(params))
        traj, losses = [], []
        for s in range(W.STEPS):
            state, m = (fns["refresh_step"] if s == 0 else fns["step"])(state, data.batch_at(s))
            traj.append(tree_leaves(state.params))
            losses.append(float(m["loss"]))
            if s == 1:
                torch.save({"params": state.params, "opt_state": state.opt_state},
                           os.path.join(ref_dir, f"inner_{run}_1.pt"))
                state1 = state
        out[run] = {"opt": opt, "traj": traj, "losses": losses, "state1": state1}
    return out


def _jax_refs(ref_dir):
    """JAX's single-device step of each optimizer on JAX's params: the loss
    and gradients, a refresh (its draws recorded for the processes) and a
    hot step; its inputs to ``jax_<run>.pt``."""
    jcfg = jax_get_config("llama3-8b", smoke=True).with_(dtype=jnp.float32, **W.INNERS_MODEL)
    jmodel = jax_build_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    data = JaxDataset(JaxDataConfig(vocab_size=jcfg.vocab_size, seq_len=W.SEQ,
                                    global_batch=W.BATCH))
    batches = [data.batch_at(i) for i in range(2)]
    vg = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))
    (l0, _), g0 = vg(jparams, batches[0])
    _, g1 = vg(jparams, batches[1])
    n = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    tparams = bridge.params_from_numpy(n(jparams), "cpu")
    out = {}
    for run in RUNS:
        name, extra = W.INNER_RUNS[run]
        kw = dict(W.OPT_KW, **extra, **JAX_KW)
        jopt = jax_make_optimizer(name, jparams, **kw)
        js0 = jax.jit(jopt.init)(jparams)
        update = jax.jit(jopt.update, static_argnames=("refresh", "apply"))
        jp1, js1, jaux1 = update(g0, js0, jparams, refresh=True, apply=True)
        jp2, js2, jaux2 = update(g1, js1, jp1, refresh=False, apply=True)
        # the refresh's draws, per low-rank leaf at its global shape
        topt = W.inner_optimizer(tparams, run, **JAX_KW)
        pcfg = topt.config.projector_config()
        jd = JaxDraws(js0.key, method=topt.config.method).split()
        draws = {}
        for i, (spec, like) in enumerate(zip(topt.specs, topt.likes)):
            if spec.lowrank:
                shape = tuple(like.shape)
                ld = jd.leaf(i, shape[:-2], proj_lib.draw_shapes(
                    min(shape[-2:]), max(shape[-2:]), pcfg, spec.rank), "cpu")
                draws[i] = tuple(None if x is None else _np(x) for x in ld)
        torch.save({"params": n(jparams), "batch": {k: np.asarray(v)
                                                   for k, v in batches[0].items()},
                    "grads0": n(g0), "grads1": n(g1), "draws": draws, "state1": n(js1),
                    "params1": n(jp1)}, os.path.join(ref_dir, f"jax_{run}.pt"))
        out[run] = {"loss": float(l0), "grads": n(g0), "params1": n(jp1), "params2": n(jp2),
                    "state2": canonical_opt_state(topt, bridge.opt_state_from_numpy(
                        topt, n(js2), "cpu")),
                    "aux1": [float(jaux1.grad_norm), float(jaux1.update_norm),
                             float(jaux1.mean_refresh_overlap)],
                    "aux2": [float(jaux2.grad_norm), float(jaux2.update_norm)]}
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The single-process runs first (the worlds read their states), then
    the three worlds at once while this process makes JAX's references; the
    (2, 2) world runs JAX's cases last, once they are written."""
    tmp = tmp_path_factory.mktemp("inners")
    ref_dir = tmp / "ref"
    ref_dir.mkdir()
    refs = _ref_runs(str(ref_dir))
    case = {"i": dict(kind="inners", runs=RUNS)}
    waits = {k: W.spawn(tmp, str(ref_dir), {"mesh": WORLDS[k], "cases": case}, WORLD_TIMEOUT_S)
             for k in ("w12", "w21")}
    waits["w22"] = W.spawn(tmp, str(ref_dir), {"mesh": WORLDS["w22"], "cases": dict(
        case, flat=dict(kind="inners", runs=FLAT_RUNS, compressed="flat"),
        j=dict(kind="inners_jax", runs=RUNS))}, WORLD_TIMEOUT_S)
    jref = _jax_refs(str(ref_dir))
    (ref_dir / "jax_ready").touch()
    return dict(refs=refs, jref=jref, runs={k: wait() for k, wait in waits.items()})


def _traj_ok(got, want, lr):
    for a, b in zip(got, want):
        err = (a - b).abs()
        assert float((err > REFRESH_TOL).float().mean()) <= TRAJ_SHARE, float(err.max())
        assert float(err.max()) <= lr


@pytest.mark.parametrize("world,run", [(w, r) for w in WORLDS for r in RUNS])
def test_inner_world_matches_the_single_process_step(worlds, world, run):
    """The step-0 loss, the trajectory's params (``_traj_ok``), the
    processes' params bit-equal, the step taken (FSDP where ``data`` is
    above 1), and from the single-process state after step 1 on the
    world's reduced gradients: the hot step at HOT_LOOP_TOL, its gathered
    canonical state (every inner's, ``_state_within``), the refresh step
    at REFRESH_TOL."""
    ranks = [r["i"][run] for r in worlds["runs"][world]]
    ref = worlds["refs"][run]
    got = ranks[0]
    assert got["fsdp"] == (WORLDS[world][0] > 1)
    assert abs(got["losses"][0] - ref["losses"][0]) <= LOSS_TOL
    for s in range(W.STEPS):
        _traj_ok(got["params"][s], ref["traj"][s], W.OPT_KW["lr"])
        for r in ranks[1:]:
            assert all(torch.equal(a, b) for a, b in zip(r["params"][s], got["params"][s]))
    opt, st1 = ref["opt"], ref["state1"]
    grads = tree_unflatten(st1.params, got["grads"])
    hot, hs, _ = opt.update(grads, st1.opt_state, st1.params, refresh=False, apply=True)
    assert _max_err(got["hot"], tree_leaves(hot)) <= HOT_LOOP_TOL
    fresh, _, _ = opt.update(grads, st1.opt_state, st1.params, refresh=True, apply=True)
    assert _max_err(got["refresh"], tree_leaves(fresh)) <= REFRESH_TOL
    _state_within(got["hot_state"], canonical_opt_state(opt, hs))


@pytest.mark.parametrize("run", RUNS)
def test_inner_world_matches_jax_single_device_step(worlds, run):
    """JAX's params, batch, gradients and draws in the (2, 2) world: the
    mean of the processes' losses and the reduced gradients (GRAD_TOL),
    the params after a refresh (REFRESH_TOL) and after a hot step from
    JAX's post-refresh state (HOT_LOOP_TOL, 8-bit codes within one step),
    the norms."""
    j, ranks = worlds["jref"][run], [r["j"][run] for r in worlds["runs"]["w22"]]
    got = ranks[0]
    np.testing.assert_allclose(np.mean([r["loss"] for r in ranks]), j["loss"], **GRAD_TOL)
    for a, b in zip(got["grads"], jax.tree_util.tree_leaves(j["grads"])):
        np.testing.assert_allclose(_np(a), b, **GRAD_TOL)
    for a, b in zip(got["params1"], jax.tree_util.tree_leaves(j["params1"])):
        np.testing.assert_allclose(_np(a), b, atol=REFRESH_TOL, rtol=0)
    for a, b in zip(got["params2"], jax.tree_util.tree_leaves(j["params2"])):
        np.testing.assert_allclose(_np(a), b, atol=HOT_LOOP_TOL, rtol=0)
    if "adam8bit" in W.INNER_RUNS[run][0]:
        _codes_within(got["state2"], j["state2"])
    np.testing.assert_allclose(got["aux1"], j["aux1"], rtol=1e-5)
    np.testing.assert_allclose(got["aux2"], j["aux2"], rtol=1e-5)


@pytest.mark.parametrize("run", FLAT_RUNS)
def test_per_leaf_loop_on_the_compressed_tp_step(worlds, run):
    """The per-leaf loop (the reference engine, Adafactor) on the (2, 2)
    world's compressed step (``compressed="flat"``: the projected R of a
    leaf whose d ``model`` cuts is summed over it before the reduction over
    data): the step-0 loss, the trajectory (``_traj_ok``) and the processes'
    params bit-equal, as the standard step's."""
    ranks = [r["flat"][run] for r in worlds["runs"]["w22"]]
    ref = worlds["refs"][run]
    got = ranks[0]
    assert abs(got["losses"][0] - ref["losses"][0]) <= LOSS_TOL
    for s in range(W.STEPS):
        _traj_ok(got["params"][s], ref["traj"][s], W.OPT_KW["lr"])
        for r in ranks[1:]:
            assert all(torch.equal(a, b) for a, b in zip(r["params"][s], got["params"][s]))
