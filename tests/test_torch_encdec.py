"""The port's enc-dec family (src/repro_torch/models/encdec.py,
whisper-medium) against the JAX package's, on the CPU at the smoke config
(2 encoder and 2 decoder layers, 24 frames) in f32 with JAX's weights
carried across through ``bridge.py``: the sinusoidal positions, the
non-causal encoder without RoPE, the cross-attention sub-layer, the loss
and every gradient, prefill (logits, the self-attention ring and the
per-layer cross K/V), teacher-forced decode steps, prefill + decode
against the full forward, and the fresh cache's layout.  And whisper's
cases of ``test_torch_family_train.py`` (a 3-step ``train_loop`` on both
engines with frames in every batch, the microbatched step), here to keep
each file within its time."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import encdec as jax_encdec
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.core.lowrank import flatten_with_path, tree_leaves, tree_unflatten
from repro_torch.models import build_model
from repro_torch.models import encdec
from test_torch_family_train import (
    microbatched_step_slices_the_prefix,
    three_step_train_loop_with_the_prefix_matches_jax,
)

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
def whisper():
    jcfg = jax_get_config("whisper-medium", smoke=True).with_(dtype=jnp.float32)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = get_config("whisper-medium", smoke=True).with_(dtype=torch.float32)
    tmodel = build_model(tcfg, device="cpu")
    tparams = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S + EXTRA + 1)).astype(np.int32)
    frames = rng.standard_normal((B, jcfg.enc_frames, jcfg.d_model)).astype(np.float32)
    return dict(jcfg=jcfg, tcfg=tcfg, jmodel=jmodel, jparams=jparams, tmodel=tmodel,
                tparams=tparams, tokens=tokens, frames=frames)


@pytest.mark.parametrize("length,d", [(24, 64), (1500, 1024)])
def test_sinusoidal_positions_match_jax(length, d):
    """At whisper's 1500 frames the angles reach 1499 rad, where one f32
    ulp of the angle is 1.2e-4: XLA's and ATen's exp may round the inverse
    frequency 1 ulp apart, and the sine follows it, so the bar there is
    two ulps of the largest angle; at the smoke's 24 frames it is f32's."""
    want = np.asarray(jax_encdec.sinusoidal_positions(length, d))
    got = encdec.sinusoidal_positions(length, d)
    assert got.dtype == torch.float32 and got.shape == (length, d)
    atol = 2 * float(np.spacing(np.float32(length - 1))) if length > 100 else 2e-6
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


def test_encode_matches_jax(whisper):
    want = jax_encdec.encode(whisper["jparams"], whisper["jcfg"], jnp.asarray(whisper["frames"]))
    with torch.no_grad():
        got = encdec.encode(whisper["tparams"], whisper["tcfg"],
                            torch.from_numpy(whisper["frames"]))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_cross_sublayer_matches_jax(whisper):
    """One decoder layer's cross-attention: Sq = 7 decoder positions
    against the 24 encoder frames, from the encoder output and from the
    cached K/V."""
    jcfg, tcfg = whisper["jcfg"], whisper["tcfg"]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, 7, jcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, jcfg.enc_frames, jcfg.d_model)).astype(np.float32)
    jp = jax.tree_util.tree_map(lambda a: a[1], whisper["jparams"]["blocks"])
    tp = {k: v[1] for k, v in whisper["tparams"]["blocks"].items() if not isinstance(v, dict)}
    jout, (jk, jv) = jax_encdec._cross_sublayer(jp, jnp.asarray(x), jcfg,
                                                enc_out=jnp.asarray(enc))
    tout, (tk, tv) = encdec._cross_sublayer(tp, torch.from_numpy(x), tcfg,
                                            enc_out=torch.from_numpy(enc))
    np.testing.assert_allclose(_np(tout), np.asarray(jout), **TOL)
    np.testing.assert_allclose(_np(tk), np.asarray(jk), **TOL)
    np.testing.assert_allclose(_np(tv), np.asarray(jv), **TOL)
    again, _ = encdec._cross_sublayer(tp, torch.from_numpy(x), tcfg, cross_kv=(tk, tv))
    np.testing.assert_allclose(_np(again), np.asarray(jout), **TOL)


def test_loss_and_every_grad_match_jax(whisper):
    tok, frames = whisper["tokens"], whisper["frames"]
    jbatch = {"tokens": jnp.asarray(tok[:, :S]), "labels": jnp.asarray(tok[:, 1:S + 1]),
              "frame_embeds": jnp.asarray(frames)}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(whisper["jmodel"].loss, has_aux=True))(
        whisper["jparams"], jbatch)
    tp = whisper["tparams"]
    leaves = [p.clone().requires_grad_(True) for p in tree_leaves(tp)]
    t = torch.from_numpy(tok)
    loss, met = whisper["tmodel"].loss(
        tree_unflatten(tp, leaves),
        {"tokens": t[:, :S], "labels": t[:, 1:S + 1], "frame_embeds": torch.from_numpy(frames)})
    loss.backward()
    assert sorted(met) == ["loss", "tokens"] and float(met["tokens"]) == B * S
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    tflat = flatten_with_path(tree_unflatten(tp, [p.grad for p in leaves]))
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == [p for p, _ in tflat]
    assert any("enc_blocks" in p for p, _ in tflat) and any("cross_q_proj" in p for p, _ in tflat)
    for (path, a), (_, b) in zip(jflat, tflat):
        np.testing.assert_allclose(_np(b), np.asarray(a), err_msg=path, **GRAD_TOL)


def test_prefill_and_teacher_forced_decode_match_jax(whisper):
    """Prefill's logits and cache (ring, positions, every layer's cross
    K/V), then 3 teacher-forced decode steps, each step's logits and the
    ring against JAX's."""
    jmodel, tmodel = whisper["jmodel"], whisper["tmodel"]
    tok, frames = whisper["tokens"], whisper["frames"]
    cap = S + EXTRA + 1
    jl, jc = jmodel.prefill(whisper["jparams"], {"tokens": jnp.asarray(tok[:, :S]),
                                                 "frame_embeds": jnp.asarray(frames)}, cap)
    with torch.no_grad():
        tl, tc = tmodel.prefill(whisper["tparams"], {"tokens": torch.from_numpy(tok[:, :S]),
                                                     "frame_embeds": torch.from_numpy(frames)},
                                cap)
    assert type(tc).__name__ == "EncDecCache" and tc._fields == jc._fields
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    for name in ("k", "v", "cross_k", "cross_v"):
        assert getattr(tc, name).shape == getattr(jc, name).shape, name
        np.testing.assert_allclose(_np(getattr(tc, name)), np.asarray(getattr(jc, name)),
                                   err_msg=name, **TOL)
    np.testing.assert_array_equal(_np(tc.pos), np.asarray(jc.pos))
    np.testing.assert_array_equal(_np(tc.next_pos), np.asarray(jc.next_pos))
    decode = jax.jit(jmodel.decode)
    for i in range(EXTRA):
        nxt = tok[:, S + i:S + i + 1]
        jl, jc = decode(whisper["jparams"], jc, {"token": jnp.asarray(nxt)})
        with torch.no_grad():
            tl, tc = tmodel.decode(whisper["tparams"], tc, {"token": torch.from_numpy(nxt)})
        np.testing.assert_allclose(_np(tl), np.asarray(jl), err_msg=f"step {i}", **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(getattr(tc, name)), np.asarray(getattr(jc, name)),
                                   err_msg=name, **TOL)
    np.testing.assert_array_equal(_np(tc.pos), np.asarray(jc.pos))
    np.testing.assert_array_equal(_np(tc.next_pos), np.asarray(jc.next_pos))


def test_prefill_plus_decode_equals_the_full_forward(whisper):
    """As JAX's ``test_prefill_decode_matches_full_forward``: the prompt's
    prefill and teacher-forced steps give the full sequence's last logits."""
    tmodel, tp = whisper["tmodel"], whisper["tparams"]
    tok = torch.from_numpy(whisper["tokens"][:1, :S + EXTRA])
    frames = torch.from_numpy(whisper["frames"][:1])
    cap = S + EXTRA + 2
    with torch.no_grad():
        full, _ = tmodel.prefill(tp, {"tokens": tok, "frame_embeds": frames}, cap)
        logits, cache = tmodel.prefill(tp, {"tokens": tok[:, :S], "frame_embeds": frames}, cap)
        for i in range(EXTRA):
            logits, cache = tmodel.decode(tp, cache, {"token": tok[:, S + i:S + i + 1]})
    torch.testing.assert_close(logits, full, atol=2e-4, rtol=1e-4)


def test_init_cache_matches_jax(whisper):
    """The slot engine's fresh cache: field names, shapes and dtypes equal
    JAX's ``model_zoo._encdec_cache`` (cross K/V over ``enc_frames``)."""
    jc = whisper["jmodel"].init_cache(3, 16)
    tc = whisper["tmodel"].init_cache(3, 16)
    assert tc._fields == jc._fields
    for name in tc._fields:
        a, b = getattr(jc, name), getattr(tc, name)
        assert tuple(b.shape) == a.shape, name
        assert str(b.dtype).split(".")[-1] == jnp.dtype(a.dtype).name, name
        np.testing.assert_array_equal(_np(b), np.asarray(a), err_msg=name)


def test_three_step_train_loop_with_the_frames_matches_jax(tmp_path):
    three_step_train_loop_with_the_prefix_matches_jax("whisper-medium", tmp_path)


def test_microbatched_step_slices_the_frames():
    microbatched_step_slices_the_prefix("whisper-medium")
