"""The port's VLM family (src/repro_torch/models/vlm.py, llava-next-34b)
against the JAX package's, on the CPU at the smoke config (8 patches, GQA
4/2) in f32 with JAX's weights carried across through ``bridge.py``: the
``patch_in_proj`` adapter, the loss (the prefix's labels padded with -1)
and every gradient, prefill with the patch prefix ahead of the text and
the decode steps after it, prefill + decode against the full forward, and
the static engine's capacity rule, which counts the patches."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import vlm as jax_vlm
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.core.lowrank import flatten_with_path, tree_leaves, tree_unflatten
from repro_torch.models import build_model
from repro_torch.models import vlm
from repro_torch.serve.engine import ServeEngine

# One intra-op thread: the test workers share the host's cores, and the
# port's results do not depend on the thread count (core/svd.py).
torch.set_num_threads(1)

# f32, the same products summed in other orders (XLA vs ATen).
TOL = dict(atol=2e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-6, rtol=1e-5)
B, S, EXTRA = 2, 10, 3


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def llava():
    jcfg = jax_get_config("llava-next-34b", smoke=True).with_(dtype=jnp.float32)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = get_config("llava-next-34b", smoke=True).with_(dtype=torch.float32)
    tmodel = build_model(tcfg, device="cpu")
    tparams = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(12)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S + EXTRA + 1)).astype(np.int32)
    patches = rng.standard_normal((B, jcfg.n_patches, jcfg.d_model)).astype(np.float32)
    return dict(jcfg=jcfg, tcfg=tcfg, jmodel=jmodel, jparams=jparams, tmodel=tmodel,
                tparams=tparams, tokens=tokens, patches=patches)


def test_adapt_matches_jax(llava):
    want = jax_vlm._adapt(llava["jparams"], jnp.asarray(llava["patches"]), llava["jcfg"])
    got = vlm._adapt(llava["tparams"], torch.from_numpy(llava["patches"]), llava["tcfg"])
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_loss_and_every_grad_match_jax(llava):
    """The patches carry no loss: the token count is the text's alone, and
    ``patch_in_proj`` gets its gradient through the text's attention."""
    tok, patches = llava["tokens"], llava["patches"]
    jbatch = {"tokens": jnp.asarray(tok[:, :S]), "labels": jnp.asarray(tok[:, 1:S + 1]),
              "patch_embeds": jnp.asarray(patches)}
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(llava["jmodel"].loss, has_aux=True))(
        llava["jparams"], jbatch)
    tp = llava["tparams"]
    leaves = [p.clone().requires_grad_(True) for p in tree_leaves(tp)]
    t = torch.from_numpy(tok)
    loss, met = llava["tmodel"].loss(
        tree_unflatten(tp, leaves),
        {"tokens": t[:, :S], "labels": t[:, 1:S + 1], "patch_embeds": torch.from_numpy(patches)})
    loss.backward()
    assert float(met["tokens"]) == float(jmet["tokens"]) == B * S
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    tflat = flatten_with_path(tree_unflatten(tp, [p.grad for p in leaves]))
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == [p for p, _ in tflat]
    assert float(dict(tflat)["['patch_in_proj']"].abs().max()) > 0
    for (path, a), (_, b) in zip(jflat, tflat):
        np.testing.assert_allclose(_np(b), np.asarray(a), err_msg=path, **GRAD_TOL)


def test_prefill_with_the_patch_prefix_and_decode_match_jax(llava):
    """The cache holds the 8 patches' K/V at positions 0-7, the text after
    them; 3 teacher-forced decode steps go on from position 8 + S."""
    jmodel, tmodel = llava["jmodel"], llava["tmodel"]
    tok, patches = llava["tokens"], llava["patches"]
    p = llava["jcfg"].n_patches
    cap = p + S + EXTRA + 1
    jl, jc = jmodel.prefill(llava["jparams"], {"tokens": jnp.asarray(tok[:, :S]),
                                               "patch_embeds": jnp.asarray(patches)}, cap)
    with torch.no_grad():
        tl, tc = tmodel.prefill(llava["tparams"], {"tokens": torch.from_numpy(tok[:, :S]),
                                                   "patch_embeds": torch.from_numpy(patches)},
                                cap)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(getattr(tc, name)), np.asarray(getattr(jc, name)),
                                   err_msg=name, **TOL)
    np.testing.assert_array_equal(_np(tc.pos), np.asarray(jc.pos))
    assert int(tc.next_pos[0]) == p + S
    decode = jax.jit(jmodel.decode)
    for i in range(EXTRA):
        nxt = tok[:, S + i:S + i + 1]
        jl, jc = decode(llava["jparams"], jc, {"token": jnp.asarray(nxt)})
        with torch.no_grad():
            tl, tc = tmodel.decode(llava["tparams"], tc, {"token": torch.from_numpy(nxt)})
        np.testing.assert_allclose(_np(tl), np.asarray(jl), err_msg=f"step {i}", **TOL)
    np.testing.assert_array_equal(_np(tc.next_pos), np.asarray(jc.next_pos))


def test_prefill_plus_decode_equals_the_full_forward(llava):
    tmodel, tp = llava["tmodel"], llava["tparams"]
    tok = torch.from_numpy(llava["tokens"][:1, :S + EXTRA])
    patches = torch.from_numpy(llava["patches"][:1])
    cap = llava["tcfg"].n_patches + S + EXTRA + 2
    with torch.no_grad():
        full, _ = tmodel.prefill(tp, {"tokens": tok, "patch_embeds": patches}, cap)
        logits, cache = tmodel.prefill(tp, {"tokens": tok[:, :S], "patch_embeds": patches}, cap)
        for i in range(EXTRA):
            logits, cache = tmodel.decode(tp, cache, {"token": tok[:, S + i:S + i + 1]})
    torch.testing.assert_close(logits, full, atol=2e-4, rtol=1e-4)


def test_serve_engine_capacity_counts_the_patches(llava):
    """A capacity that holds the text and the new tokens but not the
    patches raises in both packages, naming the prompt's KV length; one
    that holds them all generates the same tokens in both."""
    tok, patches = llava["tokens"][:, :S], llava["patches"]
    p, new = llava["jcfg"].n_patches, 4
    jbatch = {"tokens": jnp.asarray(tok), "patch_embeds": jnp.asarray(patches)}
    tbatch = {"tokens": torch.from_numpy(tok), "patch_embeds": torch.from_numpy(patches)}
    msg = f"cannot hold prompt \\({p + S}\\)"
    with pytest.raises(ValueError, match=msg):
        JaxServeEngine(llava["jmodel"], llava["jparams"], capacity=S + new).generate(jbatch, new)
    with pytest.raises(ValueError, match=msg):
        ServeEngine(llava["tmodel"], llava["tparams"], capacity=S + new).generate(tbatch, new)
    want = JaxServeEngine(llava["jmodel"], llava["jparams"], capacity=p + S + new).generate(
        jbatch, new).tokens
    got = ServeEngine(llava["tmodel"], llava["tparams"], capacity=p + S + new).generate(
        tbatch, new).tokens
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_launcher_counts_the_patches_in_the_capacity(monkeypatch, capsys):
    """Both launchers give each vlm request 8 zero patches under
    ``--smoke``.  With a page size of 4 and 4 new tokens the JAX
    launcher's cache holds prompt + new tokens + a page (40 positions),
    fewer than the 44 a request takes with its patches, so it refuses the
    request; the port's launcher counts the patches in the capacity (48)
    and serves all 3 (ROADMAP queue 3)."""
    import sys

    from repro.launch import serve as jax_launch
    from repro_torch.launch import serve as launch

    argv = ["--arch", "llava-next-34b", "--smoke", "--continuous", "--page-size", "4",
            "--requests", "3", "--new-tokens", "4"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    with pytest.raises(ValueError, match="needs 44 kv positions .* a slot holds 40"):
        jax_launch.main()
    launch.main(argv + ["--device", "cpu"])
    assert "[serve] continuous on cpu: 3 requests, 12 tokens" in capsys.readouterr().out
