"""The port's hybrid family (src/repro_torch/models/hybrid.py, hymba-1.5b)
against the JAX package's, on the CPU at the smoke config (window 16) in
f32 with JAX's weights carried across through ``bridge.py``: loss and
every gradient (the windowed attention and the SSM mixer of each block),
prefill logits and cache, and the ring decode past the window -- from a
prompt shorter than the window, whose ring then wraps, and from one
longer than it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.core.lowrank import flatten_with_path, tree_leaves, tree_unflatten
from repro_torch.models import build_model

# One intra-op thread: the test workers share the host's cores, and the
# port's results do not depend on the thread count (core/svd.py).
torch.set_num_threads(1)

# f32, the same products summed in other orders (XLA vs ATen).
TOL = dict(atol=2e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-6, rtol=1e-5)
B = 2


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def hymba():
    jcfg = jax_get_config("hymba-1.5b", smoke=True).with_(dtype=jnp.float32)
    assert jcfg.attn_window == 16
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(get_config("hymba-1.5b", smoke=True).with_(dtype=torch.float32),
                         device="cpu")
    tparams = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    tokens = np.random.default_rng(6).integers(0, jcfg.vocab_size, (B, 40)).astype(np.int32)
    return dict(jcfg=jcfg, jmodel=jmodel, jparams=jparams, tmodel=tmodel, tparams=tparams,
                tokens=tokens)


def test_loss_and_every_grad_match_jax(hymba):
    """Sequence 24 > window 16, so the window masks in training too."""
    s = 24
    tok = hymba["tokens"]
    batch = {"tokens": jnp.asarray(tok[:, :s]), "labels": jnp.asarray(tok[:, 1:s + 1])}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(hymba["jmodel"].loss, has_aux=True))(
        hymba["jparams"], batch)
    tp = hymba["tparams"]
    leaves = [p.clone().requires_grad_(True) for p in tree_leaves(tp)]
    t = torch.from_numpy(tok)
    loss, met = hymba["tmodel"].loss(tree_unflatten(tp, leaves),
                                     {"tokens": t[:, :s], "labels": t[:, 1:s + 1]})
    loss.backward()
    assert sorted(met) == ["loss", "tokens"]
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    tflat = flatten_with_path(tree_unflatten(tp, [p.grad for p in leaves]))
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == [p for p, _ in tflat]
    for (path, a), (_, b) in zip(jflat, tflat):
        np.testing.assert_allclose(_np(b), np.asarray(a), err_msg=path, **GRAD_TOL)


@pytest.mark.parametrize("prompt,steps", [(10, 12), (20, 4)])
def test_prefill_and_ring_decode_past_the_window_match_jax(hymba, prompt, steps):
    """(10, 12): the ring fills and wraps during decode (positions 10..21
    in a window of 16).  (20, 4): the prompt is longer than the window,
    prefill keeps its last 16 K/V."""
    jmodel, jparams, tmodel, tp = hymba["jmodel"], hymba["jparams"], hymba["tmodel"], \
        hymba["tparams"]
    tok = hymba["tokens"]
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(tok[:, :prompt])})
    with torch.no_grad():
        tl, tc = tmodel.prefill(tp, {"tokens": torch.from_numpy(tok[:, :prompt])})
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(getattr(tc, name)), np.asarray(getattr(jc, name)), **TOL)
    np.testing.assert_array_equal(_np(tc.pos), np.asarray(jc.pos))
    np.testing.assert_allclose(_np(tc.ssm.state), np.asarray(jc.ssm.state), **TOL)
    np.testing.assert_allclose(_np(tc.ssm.conv), np.asarray(jc.ssm.conv), **TOL)
    decode = jax.jit(jmodel.decode)
    for i in range(steps):
        nxt = tok[:, prompt + i:prompt + i + 1]
        jl, jc = decode(jparams, jc, {"token": jnp.asarray(nxt)})
        with torch.no_grad():
            tl, tc = tmodel.decode(tp, tc, {"token": torch.from_numpy(nxt)})
        np.testing.assert_allclose(_np(tl), np.asarray(jl), err_msg=f"step {i}", **TOL)
    np.testing.assert_array_equal(_np(tc.pos), np.asarray(jc.pos))
    np.testing.assert_array_equal(_np(tc.next_pos), np.asarray(jc.next_pos))
    assert int(tc.next_pos[0]) == prompt + steps > hymba["jcfg"].attn_window
