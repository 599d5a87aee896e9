"""The paper's baselines in the port against the JAX package's, on the CPU:
Adafactor (``core/inner.py``), Fira's residual path and the projectors
golore, grass, online_pca and identity inside the optimizer
(``core/lowrank.py``, ``core/buckets.py``).

* Adafactor's update on 1-D, 2-D and stacked 3-D inputs over 5 steps fed
  the same gradients, direction and state to 1e-6; its beta2(t) bit for bit;
  a zero gradient (the subnormal guards); the two Adafactor cases of
  ``tests/test_inner_optimizers.py``.
* One Fira refresh and one hot update against JAX's: ``fira-adam`` (exact
  SVD) and ``fira-sara-adam`` (randomized), on both engines, limiter 1.0
  (the cap does not bind: gradients of scale 10 give ratios ~0.1) and 0.05
  (it binds); ``test_fira_adds_residual``.
* Each new projector inside the optimizer, on both engines: a refresh with
  JAX's draws, then a hot step from JAX's carried state, fed the same
  gradients.
* The port's copy of ``test_all_variants_step_and_descend``: every one of
  its ten names, on both engines.

Params are a small numpy-seeded tree like ``tests/test_lowrank_optimizer.py``'s:
stacked (4, 32, 64) and (4, 96, 32) low-rank leaves (left and right), an
embedding and a norm scale, in f32.  The 3-step ``train_loop`` and the
checkpoints are in ``tests/test_torch_baselines_train.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import inner as jax_inner
from repro.core import make_optimizer as jax_make_optimizer
from repro_torch import bridge
from repro_torch.core import inner, make_optimizer
from repro_torch.core.lowrank import flatten_with_path, tree_leaves
from test_torch_optim_kernels import JaxDraws

# One intra-op thread: the test workers share the host's cores, and the
# port's results do not depend on the thread count (core/svd.py).
torch.set_num_threads(1)

# fed the same gradients and no SVD or QR: f32 results of the same
# arithmetic, reduced in other orders (XLA vs ATen)
TOL = dict(atol=1e-6, rtol=0)
# after a refresh that runs an SVD or a QR: the two LAPACKs' small
# singular vectors and QR columns differ by up to ~2e-5 (ROADMAP queue 3)
REFRESH_TOL = dict(atol=5e-5, rtol=0)
NAMES = ["galore-adam", "galore-sara-adam", "golore-adam", "grass-adam",
         "online-pca-adam", "fira-sara-adam", "galore-sara-adafactor",
         "galore-sara-adam-mini", "galore-sara-adam8bit", "galore-sara-msgd"]


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "blocks": {
            "q_proj": (rng.standard_normal((4, 32, 64)) * 0.02).astype(np.float32),
            "down_proj": (rng.standard_normal((4, 96, 32)) * 0.02).astype(np.float32),
        },
        "embed": rng.standard_normal((128, 32)).astype(np.float32),
        "norm_scale": np.ones((32,), np.float32),
    }


def _grads(params, seed, scale=0.01):
    rng = np.random.default_rng(100 + seed)
    return jax.tree_util.tree_map(
        lambda p: (rng.standard_normal(p.shape) * scale).astype(np.float32), params)


def _jt(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _tt(tree):
    return bridge.params_from_numpy(tree, "cpu")


def _assert_trees_close(jtree, ttree, **tol):
    ja = jax.tree_util.tree_flatten_with_path(_numpy_tree(jtree))[0]
    tb = flatten_with_path(ttree)
    assert [jax.tree_util.keystr(p) for p, _ in ja] == [p for p, _ in tb]
    for (path, a), (_, b) in zip(ja, tb):
        np.testing.assert_allclose(_np(b), a, err_msg=jax.tree_util.keystr(path), **tol)


# ---------------------------------------------------------------------------
# Adafactor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(7,), (5, 9), (3, 4, 8)], ids=["1d", "2d", "3d"])
def test_adafactor_update_matches_jax(shape):
    """Five steps fed the same gradients: direction and every state field
    (m, vr, vc, v; (1,) placeholders where unused) to 1e-6, shapes and
    dtypes exactly; the RMS clip is one scalar over the whole leaf."""
    jopt, topt = jax_inner.adafactor(), inner.adafactor()
    rng = np.random.default_rng(0)
    x = np.zeros(shape, np.float32)
    js, ts = jopt.init(jnp.asarray(x)), topt.init(torch.from_numpy(x))
    assert type(ts).__name__ == type(js).__name__ == "AdafactorState"
    for a, b in zip(ts, js):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
    for step in range(1, 6):
        # one slice of the stack 100x the others: the clip's RMS spans them all
        g = rng.standard_normal(shape).astype(np.float32)
        if len(shape) == 3:
            g[0] *= 100.0
        jd, js = jopt.update(jnp.asarray(g), js, jnp.asarray(step))
        td, ts = topt.update(torch.from_numpy(g), ts, step)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), err_msg=f"step {step}", **TOL)
        # m is a direction (O(1)): 1e-6; the second-moment statistics scale
        # with g^2 (up to 1e4 here): relative 1e-6
        for f, a, b in zip(ts._fields, ts, js):
            tol = TOL if f == "m" else dict(rtol=1e-6, atol=0)
            np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=f"step {step} {f}",
                                       **tol)


def test_adafactor_beta2_is_jax_f32_power():
    """beta2(t) = 1 - t^-0.8 computed in f32 from the step, as JAX does:
    bit for bit on steps 1..5000 (a Python float64 power differs by ulps)."""
    steps = np.arange(1, 5001, dtype=np.int32)
    want = np.asarray(1.0 - jnp.asarray(steps).astype(jnp.float32) ** (-0.8))
    got = np.array([inner.adafactor_beta2(int(s)) for s in steps], np.float32)
    np.testing.assert_array_equal(got, want)
    f64 = (1.0 - steps.astype(np.float64) ** -0.8).astype(np.float32)
    assert (f64 != want).any()  # the reason for the f32 power


@pytest.mark.parametrize("shape,scale", [((6,), 0.0), ((3, 5), 1e-8), ((3, 5), 1e-10),
                                         ((3, 5), 0.0)])
def test_adafactor_tiny_gradients_keep_the_subnormals(shape, scale):
    """The 1e-38 guards and, for gradients of 1e-10 and below, the product
    vr * vc are f32 subnormals.  The port flushes none of them, on the CPU
    (here) or the card (``tests/test_torch_gpu.py``), so its direction is
    finite and, where JAX's is finite too, equal to it.  JAX on the CPU
    flushes them (XLA: ``x + 1e-38`` is ``x``), and its 2-D direction at
    1e-10 and 0 comes out NaN (ROADMAP queue 3, a reference fault)."""
    jopt, topt = jax_inner.adafactor(), inner.adafactor()
    g = (np.random.default_rng(0).standard_normal(shape) * scale).astype(np.float32)
    jd, js = jopt.update(jnp.asarray(g), jopt.init(jnp.asarray(g)), jnp.asarray(1))
    td, ts = topt.update(torch.from_numpy(g), topt.init(torch.from_numpy(g)), 1)
    assert torch.isfinite(td).all()
    for f, a, b in zip(ts._fields, ts, js):
        if f != "m":
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0,
                                       err_msg=f)
    if len(shape) == 2 and scale <= 1e-10:
        assert np.isnan(np.asarray(jd)).all()
        if scale == 0.0:
            np.testing.assert_array_equal(td.numpy(), 0.0)
        return
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    assert torch.tensor(1e-38, dtype=torch.float32).item() > 0  # not flushed


def test_adafactor_factored_second_moment_shapes():
    opt = inner.adafactor()
    x = torch.zeros((4, 8, 16))
    st = opt.init(x)
    assert tuple(st.vr.shape) == (4, 8) and tuple(st.vc.shape) == (4, 16)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(0))
    d, st = opt.update(g, st, 1)
    assert d.shape == x.shape and torch.isfinite(d).all()


def test_adafactor_memory_sublinear():
    full = inner.adam().init(torch.zeros((64, 128)))
    fact = inner.adafactor().init(torch.zeros((64, 128)))
    bytes_full = sum(x.numel() * 4 for x in full)
    bytes_fact = sum(x.numel() * 4 for x in fact)
    # m is the same, v is rows + cols instead of rows x cols
    assert bytes_fact < 0.6 * bytes_full


# ---------------------------------------------------------------------------
# the optimizer: Fira and the new projectors against JAX
# ---------------------------------------------------------------------------


def _refresh_then_hot(name, engine, refresh_tol, hot_tol, grad_scale=0.01, **kw):
    """A refresh from the initial state with JAX's draws, then a hot step
    from JAX's carried-over state, fed the same gradients, on one engine of
    both packages.  Returns the two optimizers."""
    params = _params()
    kw = dict(dict(rank=8, lr=0.01, engine=engine), **kw)
    jopt = jax_make_optimizer(name, _jt(params), **kw)
    topt = make_optimizer(name, _tt(params), **kw)
    method = topt.config.method
    js0 = jopt.init(_jt(params))
    ts0 = bridge.opt_state_from_numpy(topt, _numpy_tree(js0), "cpu")._replace(
        draws=JaxDraws(js0.key, method=method))
    g0, g1 = _grads(params, 0, grad_scale), _grads(params, 1, grad_scale)
    jp1, js1, jaux = jopt.update(_jt(g0), js0, _jt(params), refresh=True, apply=True)
    tp1, ts1, taux = topt.update(_tt(g0), ts0, _tt(params), refresh=True, apply=True)
    _assert_trees_close(jp1, tp1, **refresh_tol)
    np.testing.assert_allclose(float(taux.mean_refresh_overlap),
                               float(jaux.mean_refresh_overlap), rtol=1e-5, atol=1e-6)
    ts1 = bridge.opt_state_from_numpy(topt, _numpy_tree(js1), "cpu")
    jp2, js2, jaux = jopt.update(_jt(g1), js1, jp1, refresh=False, apply=True)
    tp2, ts2, taux = topt.update(_tt(g1), ts1, _tt(_numpy_tree(jp1)), refresh=False,
                                 apply=True)
    _assert_trees_close(jp2, tp2, **hot_tol)
    np.testing.assert_allclose(float(taux.update_norm), float(jaux.update_norm), rtol=1e-5)
    return jopt, topt


@pytest.mark.parametrize("limiter", [1.0, 0.05])
@pytest.mark.parametrize("engine", ["reference", "bucketed"])
@pytest.mark.parametrize("name,backend", [("fira-adam", "exact"),
                                          ("fira-sara-adam", "randomized")])
def test_fira_update_matches_jax(name, backend, engine, limiter):
    """Fira back-projects the projected gradient's residual, scaled by
    min(||direction|| / ||R||, limiter), one scalar per leaf.  Gradients
    of scale 10 give ratios ~0.1: limiter 1.0 leaves them, 0.05 caps them.
    Both engines run the per-leaf loop on per-leaf state, as JAX's."""
    jopt, topt = _refresh_then_hot(name, engine, REFRESH_TOL, TOL, grad_scale=10.0,
                                   svd_backend=backend, fira_limiter=limiter)
    assert topt.state_layout is None and jopt.state_layout is None
    assert (topt.bucket_plan is None) == (engine == "reference")


@pytest.mark.parametrize("engine", ["reference", "bucketed"])
@pytest.mark.parametrize("method", ["golore", "grass", "online-pca", "identity"])
def test_new_projectors_refresh_then_hot_match_jax(method, engine):
    """grass and identity run no QR: 1e-6 through the refresh too; golore
    and online_pca end in a QR (REFRESH_TOL across the refresh).  The hot
    step from JAX's state meets 1e-6 for all four; on the bucketed engine
    the state is bucket-native, as JAX's."""
    exact = method in ("grass", "identity")
    _, topt = _refresh_then_hot(f"{method}-adam", engine, TOL if exact else REFRESH_TOL, TOL)
    assert (topt.state_layout is not None) == (engine == "bucketed")


def test_fira_adds_residual():
    params = _tt(_params())
    g = _tt(_grads(_params(), 0))
    kw = dict(rank=4, alpha=1.0, lr=1e-2)
    plain = make_optimizer("galore-adam", params, **kw)
    fira = make_optimizer("fira-adam", params, **kw)
    up, _, _ = plain.update(g, plain.init(params), params, refresh=True)
    uf, _, _ = fira.update(g, fira.init(params), params, refresh=True)
    dq = float(torch.linalg.norm(uf["blocks"]["q_proj"] - up["blocks"]["q_proj"]))
    assert dq > 1e-8  # the residual term engaged


@pytest.mark.parametrize("engine", ["reference", "bucketed"])
@pytest.mark.parametrize("name", NAMES)
def test_all_variants_step_and_descend(name, engine):
    """Every optimizer variant reduces a convex quadratic (the JAX test's
    setting: (24, 48) weights, rank 8, lr 3e-2, alpha 1, tau 10, 80 steps)."""
    target = torch.from_numpy(np.random.default_rng(3).standard_normal((24, 48))
                              .astype(np.float32))
    params = {"w_proj": torch.zeros((24, 48))}
    opt = make_optimizer(name, params, rank=8, lr=3e-2, alpha=1.0, tau=10, engine=engine)
    state = opt.init(params)
    loss0 = float(torch.sum((params["w_proj"] - target) ** 2))
    for step in range(80):
        g = {"w_proj": 2.0 * (params["w_proj"] - target)}
        params, state, _ = opt.update(g, state, params, refresh=step % 10 == 0, apply=True)
    loss1 = float(torch.sum((params["w_proj"] - target) ** 2))
    assert all(torch.isfinite(x).all() for x in tree_leaves(params))
    # random and row projections and clipped or quantized inners descend
    # slower than dominant or SARA with Adam
    assert loss1 < 0.85 * loss0, (name, loss0, loss1)


@pytest.mark.parametrize("name", ["golore-adam", "grass-adam", "online-pca-adam",
                                  "fira-sara-adam", "galore-sara-adafactor"])
def test_launch_train_takes_the_baselines_on_cpu(name, capsys, tmp_path):
    """The launcher builds every baseline by name, with no new flag, and
    both engines print the same losses (Fira and Adafactor run the per-leaf
    loop on either)."""
    from repro_torch.launch import train as launch_train

    outs = []
    for engine in ("reference", "bucketed"):
        launch_train.main(["--smoke", "--device", "cpu", "--optimizer", name,
                           "--engine", engine, "--svd-backend", "randomized", "--steps", "3",
                           "--tau", "2", "--rank", "8", "--seq", "16", "--batch", "4",
                           "--ckpt-dir", str(tmp_path / engine)])
        lines = capsys.readouterr().out.strip().splitlines()
        # the run's last lines: "done", then the recovery counters
        assert lines[-1].startswith("[train] recovery: 0 skipped, 0 rollbacks")
        outs.append(lines[-2])
    assert outs[0].startswith("[train] done: step 3, loss ")
    assert outs[0] == outs[1]
