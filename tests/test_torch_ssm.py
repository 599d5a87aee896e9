"""The port's SSM family (src/repro_torch/models/ssm.py) against the JAX
package's, on the CPU in f32: the chunked SSD scan (with a carried state
and a ragged last chunk), the mixer, mamba2-370m's smoke model (loss,
every gradient, prefill and the recurrent decode), with JAX's weights
carried across through ``bridge.py``.  And the reference's overflow:
at mamba2-370m's mixer shape (chunk 256, 32 heads) JAX's gradient with
respect to dt is non-finite on many elements, the port's is finite
everywhere and equal to JAX's wherever JAX's is finite."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import ssm as jax_ssm
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.core.lowrank import flatten_with_path, tree_leaves, tree_unflatten
from repro_torch.models import build_model
from repro_torch.models import ssm
from test_torch_family_train import refresh_then_hot_update_match_jax

# One intra-op thread: the test workers share the host's cores, and the
# port's results do not depend on the thread count (core/svd.py).
torch.set_num_threads(1)

# f32, the same products summed in other orders (XLA vs ATen).
TOL = dict(atol=2e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-6, rtol=1e-5)
B, S, EXTRA = 2, 13, 4  # 13 = one whole chunk of 8 and a ragged one


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _scan_inputs(rng, bsz, s, h, p, n, dt_range=(1e-3, 1e-1)):
    lo, hi = np.log(dt_range[0]), np.log(dt_range[1])
    return dict(
        x=rng.standard_normal((bsz, s, h, p)).astype(np.float32),
        dt=np.exp(rng.uniform(lo, hi, (bsz, s, h))).astype(np.float32),
        a=-np.arange(1, h + 1, dtype=np.float32),
        b_mat=rng.standard_normal((bsz, s, n)).astype(np.float32),
        c_mat=rng.standard_normal((bsz, s, n)).astype(np.float32),
    )


def test_ssd_chunked_matches_jax_with_state_and_ragged_chunk():
    rng = np.random.default_rng(0)
    inp = _scan_inputs(rng, 2, 13, 4, 8, 6, dt_range=(1e-2, 1.0))
    state0 = rng.standard_normal((2, 4, 6, 8)).astype(np.float32)
    jy, js = jax_ssm.ssd_chunked(*(jnp.asarray(v) for v in inp.values()), 8,
                                 init_state=jnp.asarray(state0))
    ty, ts = ssm.ssd_chunked(*(torch.from_numpy(v) for v in inp.values()), 8,
                             init_state=torch.from_numpy(state0))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)
    np.testing.assert_allclose(_np(ts), np.asarray(js), **TOL)
    # a padded position has dt 0 and leaves the state alone: 13 tokens in
    # chunks of 8 and of 16 end in the same state
    _, ts16 = ssm.ssd_chunked(*(torch.from_numpy(v) for v in inp.values()), 16,
                              init_state=torch.from_numpy(state0))
    np.testing.assert_allclose(_np(ts16), _np(ts), **TOL)


def test_nan_free_gradient_where_the_reference_overflows():
    """mamba2-370m's mixer shape: chunk 256, 32 heads (a = -1..-32), dt
    log-uniform in the init's [1e-3, 1e-1], P 64, N 128; the gradient of
    sum(y^2).  JAX's exp(diff) overflows above the diagonal (a chunk's
    summed log-decay reaches hundreds), and its backward turns the masked
    zeros into NaN; the port masks before the exponential.  Tolerance:
    f32 sums of 256-term products in other orders, relative to the
    gradient's scale."""
    rng = np.random.default_rng(1)
    inp = _scan_inputs(rng, 1, 256, 32, 64, 128)
    assert float((inp["dt"] * -inp["a"]).sum(axis=1).max()) > 88.0  # exp overflows in f32

    def jloss(x, dt, b_mat, c_mat):
        y, _ = jax_ssm.ssd_chunked(x, dt, jnp.asarray(inp["a"]), b_mat, c_mat, 256)
        return jnp.sum(y * y)

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(
        *(jnp.asarray(inp[k]) for k in ("x", "dt", "b_mat", "c_mat")))
    jg = dict(zip(("x", "dt", "b_mat", "c_mat"), map(np.asarray, jg)))
    n_bad = int((~np.isfinite(jg["dt"])).sum())
    print(f"JAX: {n_bad} of {jg['dt'].size} dt-gradient elements non-finite")
    assert n_bad > 0  # the reference's fault shows at this shape
    for k in ("x", "b_mat", "c_mat"):
        assert np.isfinite(jg[k]).all(), k

    t = {k: torch.from_numpy(v).requires_grad_(k != "a") for k, v in inp.items()}
    y, _ = ssm.ssd_chunked(t["x"], t["dt"], t["a"], t["b_mat"], t["c_mat"], 256)
    torch.sum(y * y).backward()
    for k in ("x", "dt", "b_mat", "c_mat"):
        g = _np(t[k].grad)
        assert np.isfinite(g).all(), k
        ok = np.isfinite(jg[k])
        scale = float(np.abs(jg[k][ok]).max())
        np.testing.assert_allclose(g[ok], jg[k][ok], atol=1e-5 * scale, rtol=1e-4, err_msg=k)


@pytest.fixture(scope="module")
def mamba():
    jcfg = jax_get_config("mamba2-370m", smoke=True).with_(dtype=jnp.float32)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    # non-trivial skip and conv bias, so both are really exercised
    rng = np.random.default_rng(2)
    mixer = tree["blocks"]["mixer"]
    mixer["d_skip"] = (1.0 + 0.5 * rng.standard_normal(mixer["d_skip"].shape)).astype(np.float32)
    mixer["conv_b"] = (0.1 * rng.standard_normal(mixer["conv_b"].shape)).astype(np.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tmodel = build_model(get_config("mamba2-370m", smoke=True).with_(dtype=torch.float32),
                         device="cpu")
    tokens = rng.integers(0, jcfg.vocab_size, (B, S + EXTRA)).astype(np.int32)
    batch = {"tokens": jnp.asarray(tokens[:, :S]), "labels": jnp.asarray(tokens[:, 1:S + 1])}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(jparams, batch)
    jl, jc = jmodel.prefill(jparams, {"tokens": batch["tokens"]})
    jdec = []
    for i in range(EXTRA):
        jl_i, jc = jmodel.decode(jparams, jc, {"token": jnp.asarray(tokens[:, S + i:S + i + 1])})
        jdec.append(np.asarray(jl_i))
    return dict(jcfg=jcfg, jparams=jparams, tmodel=tmodel,
                tparams=bridge.params_from_numpy(tree, "cpu"), tokens=tokens,
                jloss=float(jloss), jgrads=jgrads, jprefill=np.asarray(jl), jcache=jc,
                jdecode=jdec)


def test_mixer_matches_jax(mamba):
    cfg = mamba["jcfg"]
    lp = jax.tree_util.tree_map(lambda x: x[1], mamba["jparams"]["blocks"]["mixer"])
    u = np.random.default_rng(4).standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    jo, js = jax_ssm.apply_ssm_mixer(lp, jnp.asarray(u), cfg, return_state=True)
    tp = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, lp), "cpu")
    to, ts = ssm.apply_ssm_mixer(tp, torch.from_numpy(u), mamba["tmodel"].cfg,
                                 return_state=True)
    np.testing.assert_allclose(_np(to), np.asarray(jo), **TOL)
    np.testing.assert_allclose(_np(ts), np.asarray(js), **TOL)


def test_loss_and_every_grad_match_jax(mamba):
    tp = mamba["tparams"]
    leaves = [p.clone().requires_grad_(True) for p in tree_leaves(tp)]
    tok = torch.from_numpy(mamba["tokens"])
    loss, met = mamba["tmodel"].loss(tree_unflatten(tp, leaves),
                                     {"tokens": tok[:, :S], "labels": tok[:, 1:S + 1]})
    loss.backward()
    assert sorted(met) == ["loss", "tokens"]  # as JAX's: no aux
    np.testing.assert_allclose(float(loss.detach()), mamba["jloss"], rtol=1e-6)
    jflat = jax.tree_util.tree_flatten_with_path(mamba["jgrads"])[0]
    tflat = flatten_with_path(tree_unflatten(tp, [p.grad for p in leaves]))
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == [p for p, _ in tflat]
    for (path, a), (_, b) in zip(jflat, tflat):
        np.testing.assert_allclose(_np(b), np.asarray(a), err_msg=path, **GRAD_TOL)


def test_prefill_cache_and_recurrent_decode_match_jax(mamba):
    tmodel, tp, tokens = mamba["tmodel"], mamba["tparams"], mamba["tokens"]
    with torch.no_grad():
        tl, tc = tmodel.prefill(tp, {"tokens": torch.from_numpy(tokens[:, :S])})
        np.testing.assert_allclose(_np(tl), mamba["jprefill"], **TOL)
        for i in range(EXTRA):
            tl, tc = tmodel.decode(tp, tc, {"token": torch.from_numpy(tokens[:, S + i:S + i + 1])})
            np.testing.assert_allclose(_np(tl), mamba["jdecode"][i], **TOL)
    jc = mamba["jcache"]
    np.testing.assert_allclose(_np(tc.layers.state), np.asarray(jc.layers.state), **TOL)
    np.testing.assert_allclose(_np(tc.layers.conv), np.asarray(jc.layers.conv), **TOL)
    np.testing.assert_array_equal(_np(tc.next_pos), np.asarray(jc.next_pos))


def test_refresh_then_hot_update_match_jax():
    """mamba2-370m's case of test_torch_family_train's: the bucketed
    galore-sara-adam refresh and hot step against JAX's."""
    refresh_then_hot_update_match_jax("mamba2-370m")
