"""The port's MSGD, Adam-mini and 8-bit Adam against the JAX package's, on
the CPU: the blockwise quantizer, the plain versions of the three fused
updates (kernels 6-8 of PERF.md's table) against JAX's ``ref.py`` and its
Pallas kernels in interpret mode, the per-leaf inners, the side-split
bucket plan, one refresh and one hot update per inner on the bucketed
engine with JAX's draws, each momentum carry, the two engines against each
other and the state bridge.  tests/test_torch_inners_train.py has the
reference engine's refresh cases, the 3-step ``train_loop`` and the
launcher (two files, so that the CPU time splits between test workers).
The model is ``get_config("llama3-8b", smoke=True)`` in f32 at rank 8 (the
shared ``pair`` fixture of tests/test_torch_train.py); inputs are
numpy-seeded.  The CUDA kernels are held against these plain versions on
the card by tests/test_torch_gpu.py.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import inner as jax_inner
from repro.core import make_optimizer as jax_make_optimizer
from repro.kernels.lowrank_update import quantize as jax_qz
from repro.kernels.lowrank_update import ref as jax_ref
from repro.kernels.lowrank_update.kernel import (
    lowrank_adam8bit_update_batched as jax_adam8bit_kernel,
)
from repro.kernels.lowrank_update.kernel import (
    lowrank_adam_mini_update_batched as jax_adam_mini_kernel,
)
from repro.kernels.lowrank_update.kernel import (
    lowrank_msgd_update_batched as jax_msgd_kernel,
)
from repro.kernels.lowrank_update.ops import adam8bit_kernel_supported
from repro_torch import bridge
from repro_torch.core import buckets, inner, make_optimizer
from repro_torch.core import projectors as proj_lib
from repro_torch.core.lowrank import flatten_with_path
from repro_torch.kernels.lowrank_update import ops as update_ops
from repro_torch.kernels.lowrank_update import quantize as qz
from test_torch_optim_kernels import JaxDraws

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import quantizer_parity  # noqa: E402  (the correctly rounded encoding)
from test_torch_train import (  # noqa: F401  (pair is a fixture)
    HOT_TOL,
    OPT_KW,
    REFRESH_TOL,
    _assert_params_close,
    _np,
    _signs,
    _torch_tree,
    pair,
)

# One intra-op thread: the test workers share the host's cores, and the
# port's results do not depend on the thread count (core/svd.py).
torch.set_num_threads(1)

NAMES = {"msgd": "galore-sara-msgd", "adam_mini": "galore-sara-adam-mini",
         "adam8bit": "galore-sara-adam8bit"}
# f32 results of the same arithmetic, summed in other orders (XLA vs ATen)
F32 = dict(atol=1e-6, rtol=1e-6)
# bf16 W': rounds to 8 significant bits, so one bf16 ulp apart is agreement
BF16 = dict(atol=2e-2, rtol=2.0**-7)


def _assert_codes_close(got, want, what="", share=1e-3):
    """8-bit codes: equal but for at most one step at rounding boundaries
    (a moment one f32 ulp apart), on at most ``share`` of them (ROADMAP
    allows +-1).  After a refresh the moments differ by the projectors'
    LAPACK differences, more than an ulp: there ``share`` is 1."""
    got, want = np.asarray(got).astype(np.int16), np.asarray(want).astype(np.int16)
    assert got.shape == want.shape, what
    diff = np.abs(got - want)
    assert diff.max(initial=0) <= 1, f"{what}: codes {diff.max()} apart"
    assert (diff > 0).mean() <= share, f"{what}: {(diff > 0).mean():.2e} of codes differ"


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------------------
# the blockwise quantizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("signed", [True, False])
def test_quantizer_matches_jax(side, signed):
    """Per-leaf rows of 300 (one full chunk, one short one), an all-zero
    chunk, canonical stacks of either side; then stack invariance."""
    rng = np.random.default_rng(1 + signed)
    shape = (3, 7, 300) if side == "left" else (3, 300, 7)
    x = (rng.standard_normal(shape) * 0.01).astype(np.float32)
    if not signed:
        x = x * x
    if side == "left":
        x[1, 2, :256] = 0.0
    else:
        x[1, :256, 2] = 0.0
    jc, js = jax_qz.quantize_stacked(jnp.asarray(x), side, signed)
    tc, ts = qz.quantize_stacked(_t(x), side, signed)
    assert tc.dtype == torch.uint8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == (3, 7, 2) and tuple(tc.shape) == shape
    _assert_codes_close(tc.numpy(), jc, f"{side} signed={signed}")
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=0)
    assert float(ts[1, 2, 0]) == 1.0  # the all-zero chunk
    np.testing.assert_allclose(
        qz.dequantize_stacked(_t(jc), _t(js), side, signed).numpy(),
        np.asarray(jax_qz.dequantize_stacked(jc, js, side, signed)), rtol=1e-6, atol=0)
    # stack invariance: an (L, a, b) leaf quantizes as its L slices
    c, s = qz.quantize_blockwise(_t(x), signed)
    for i in range(3):
        ci, si = qz.quantize_blockwise(_t(x[i]), signed)
        torch.testing.assert_close(c[i], ci, rtol=0, atol=0)
        torch.testing.assert_close(s[i], si, rtol=0, atol=0)


@pytest.mark.parametrize("values", ["test", "boundaries"])
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("signed", [True, False])
def test_quantizer_codes_are_correctly_rounded(side, signed, values):
    """The port's codes bit for bit against the correctly rounded encoding,
    on ``test_quantizer_matches_jax``'s values and on every half-code
    boundary +-8 ulps, so they depend on no backend: ``torch.sqrt`` on the
    CPU is 1 ulp off on ~0.7% of the unit interval's values, which moves 3
    of the 4335 unsigned boundary codes (ROADMAP queue 3), and the port's
    square root runs in f64."""
    if values == "test":
        rng = np.random.default_rng(1 + signed)
        shape = (3, 7, 300) if side == "left" else (3, 300, 7)
        x = (rng.standard_normal(shape) * 0.01).astype(np.float32)
        if not signed:
            x = x * x
    else:
        x = quantizer_parity.code_boundaries(signed)
        if side == "right":
            x = np.swapaxes(x, -1, -2).copy()
    codes, _ = qz.quantize_stacked(_t(x), side, signed)
    np.testing.assert_array_equal(codes.numpy(),
                                  quantizer_parity.rounded_codes(x, side, signed))


# ---------------------------------------------------------------------------
# plain versions of kernels 6-8 against JAX's ref.py and its Pallas kernels
# ---------------------------------------------------------------------------

# (B, d, n, r) per side, on shapes JAX's Pallas kernels take
SIDE_SHAPES = {"left": (2, 128, 512, 32), "right": (3, 128, 384, 32)}
LR_ALPHA, LR_WD = 0.01 * 0.25, 2e-4


def _update_inputs(seed, shape, dtype):
    b, d, n, r = shape
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((b, d, n)) * 0.1).astype(np.float32)
    p = (rng.standard_normal((b, d, r)) / np.sqrt(d)).astype(np.float32)
    rg = (rng.standard_normal((b, r, n)) * 0.01).astype(np.float32)
    m = (rng.standard_normal((b, r, n)) * 0.01).astype(np.float32)
    v = ((rng.standard_normal((b, r, n)) * 0.01) ** 2).astype(np.float32)
    jw = jnp.asarray(w).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tw = _t(w).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    return jw, tw, p, rg, m, v


def _assert_w(got, want, dtype):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **(F32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step", [1, 5])
def test_msgd_adam_mini_plain_match_jax(side, dtype, step):
    shape = SIDE_SHAPES[side]
    jw, tw, p, rg, m, v = _update_inputs(step, shape, dtype)
    b, _, n, r = shape
    jp, jrg, jm = (jnp.asarray(a) for a in (p, rg, m))
    # kernel 6: MSGD (no step: its direction has no bias correction)
    got = update_ops.bucketed_msgd_update(tw, _t(p), _t(rg), _t(m), LR_ALPHA, LR_WD, b1=0.9)
    wants = [jax_ref.lowrank_msgd_update_ref(jw, jp, jrg, jm, b1=0.9, lr_alpha=LR_ALPHA,
                                              lr_wd=LR_WD)]
    if dtype == "float32" and step == 5:  # the Pallas kernel in interpret mode
        wants.append(jax_msgd_kernel(jw, jp, jrg, jm, jnp.float32(LR_ALPHA),
                                     jnp.float32(LR_WD), interpret=True))
    for want in wants:
        _assert_w(got[0], want[0], dtype)
        np.testing.assert_allclose(_np(got[1]), np.asarray(want[1]), **F32)
    # kernel 7: Adam-mini, v per per-leaf row
    vrow = np.abs(v[:, :, 0] if side == "left" else v[:, 0, :]) + 1e-6
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, side=side)
    got = update_ops.bucketed_adam_mini_update(tw, _t(p), _t(rg), _t(m), _t(vrow), step,
                                               LR_ALPHA, LR_WD, **kw)
    assert tuple(got[2].shape) == (b, r if side == "left" else n)
    jargs = (jw, jp, jrg, jm, jnp.asarray(vrow), jnp.int32(step), jnp.float32(LR_ALPHA),
             jnp.float32(LR_WD))
    wants = [jax_ref.lowrank_adam_mini_update_ref(*jargs, **kw)]
    if dtype == "float32" and step == 5:
        wants.append(jax_adam_mini_kernel(*jargs, interpret=True, **kw))
    for want in wants:
        _assert_w(got[0], want[0], dtype)
        np.testing.assert_allclose(_np(got[1]), np.asarray(want[1]), **F32)
        np.testing.assert_allclose(_np(got[2]), np.asarray(want[2]), **F32)


# side, (B, d, n, r): the Pallas kernel's shapes, then shapes its gate
# (adam8bit_kernel_supported) sends to the jnp version: a short final
# chunk along n (left), r = 300 (right); and r = 100 on the right
ADAM8BIT_SHAPES = [("left", SIDE_SHAPES["left"]), ("right", SIDE_SHAPES["right"]),
                   ("left", (2, 64, 300, 16)), ("right", (2, 320, 40, 300)),
                   ("right", (2, 128, 72, 100))]


@pytest.mark.parametrize("case", range(len(ADAM8BIT_SHAPES)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step", [1, 5])
def test_adam8bit_plain_matches_jax(case, dtype, step):
    side, shape = ADAM8BIT_SHAPES[case]
    b, d, n, r = shape
    jw, tw, p, rg, m, v = _update_inputs(10 + step, shape, dtype)
    if step == 1:  # fresh state: quantized zeros, with an all-zero chunk then
        m, v = np.zeros_like(m), np.zeros_like(v)
    mc, ms = jax_qz.quantize_stacked(jnp.asarray(m), side, signed=True)
    vc, vs = jax_qz.quantize_stacked(jnp.asarray(v), side, signed=False)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, side=side)
    got = update_ops.bucketed_adam8bit_update(
        tw, _t(p), _t(rg), *(_t(a) for a in (mc, ms, vc, vs)), step, LR_ALPHA, LR_WD, **kw)
    jargs = (jw, jnp.asarray(p), jnp.asarray(rg), mc, ms, vc, vs, jnp.int32(step),
             jnp.float32(LR_ALPHA), jnp.float32(LR_WD))
    wants = [jax_ref.lowrank_adam8bit_update_ref(*jargs, **kw)]
    if dtype == "float32" and step == 5 and adam8bit_kernel_supported(side, n, r):
        wants.append(jax_adam8bit_kernel(*jargs, interpret=True, **kw))
    assert got[1].dtype == got[3].dtype == torch.uint8
    for want in wants:
        _assert_w(got[0], want[0], dtype)
        _assert_codes_close(got[1].numpy(), want[1], "m codes")
        _assert_codes_close(got[3].numpy(), want[3], "v codes")
        for a, c in ((got[2], want[2]), (got[4], want[4])):
            np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# the per-leaf inners (full-rank leaves, and the reference engine)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["adam_mini", "adam8bit"])
@pytest.mark.parametrize("shape", [(300,), (48, 300), (2, 7, 300)])
def test_per_leaf_inner_matches_jax(name, shape):
    """Three updates, each from JAX's state carried across."""
    rng = np.random.default_rng(len(shape))
    jopt, topt = jax_inner.make_inner(name), inner.make_inner(name)
    js = jopt.init(jnp.zeros(shape, jnp.float32))
    ts = topt.init(torch.zeros(shape))
    for got, want in zip(ts, js):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for step in (1, 2, 3):
        g = (rng.standard_normal(shape) * 0.01).astype(np.float32)
        ts = type(ts)(*(_t(x) for x in js))
        jd, js = jopt.update(jnp.asarray(g), js, jnp.int32(step))
        td, ts = topt.update(_t(g), ts, step)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), **F32)
        for field, got, want in zip(type(ts)._fields, ts, js):
            if "codes" in field:
                _assert_codes_close(got.numpy(), want, field)
            else:
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                           atol=0, err_msg=field)


# ---------------------------------------------------------------------------
# the optimizer: plan, refresh and hot update, carries, engines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("inner_name", list(NAMES))
def test_bucket_plan_matches_jax(pair, inner_name):
    kw = dict(OPT_KW, engine="bucketed", svd_backend="randomized")
    jopt = jax_make_optimizer(NAMES[inner_name], pair["jparams"], **kw)
    topt = make_optimizer(NAMES[inner_name], pair["tparams"], **kw)
    jplan, tplan = jopt.bucket_plan.buckets, topt.bucket_plan.buckets
    assert len(tplan) == len(jplan)
    for jb, tb in zip(jplan, tplan):
        assert (tb.d, tb.n, tb.rank, tb.side) == (jb.d, jb.n, jb.rank, jb.side)
        assert [tuple(e) for e in tb.entries] == [tuple(e) for e in jb.entries]
    split = inner_name in buckets.SIDE_HOMOGENEOUS_INNERS
    assert {b.side for b in tplan} == ({"left", "right"} if split else {"any"})
    # the smoke model's plan: k/v (right), q/o (left), mlp split in two
    # when split (gate/up left, down right), as at full width
    assert len(tplan) == (4 if split else 3)
    assert topt.config.inner_kwargs() == jopt.config.inner_kwargs()


def _assert_states_close(topt, tstate, jstate, p_atol, m_tol):
    """Bucket stacks against JAX's, sign-aligned: the port's projector
    columns, and the matching moment rows (stacks are canonical 'left'),
    flip with LAPACK's sign choices.  adam8bit's m is compared dequantized
    (a flipped row's code c is 254 - c); scales and second moments are
    sign-free."""
    assert tstate.step == int(jstate.step)
    for bi, (bk, jb, tb) in enumerate(zip(topt.bucket_plan.buckets, jstate.buckets,
                                          tstate.buckets)):
        pj, pt = np.asarray(jb.projector), _np(tb.projector)
        s = _signs(pj, pt)
        np.testing.assert_allclose(pt * s, pj, atol=p_atol, err_msg=f"bucket {bi}")
        rows = np.swapaxes(s, -1, -2)
        if topt.config.inner == "adam8bit":
            side = bk.side
            mt = qz.dequantize_stacked(tb.m, tb.m_scale, side, True).numpy()
            mj = np.asarray(jax_qz.dequantize_stacked(jb.m, jb.m_scale, side, True))
            step_j = np.asarray(jax_qz.dequantize_stacked(
                jnp.full_like(jb.m, 128), jb.m_scale, side, True))  # one code's width
            np.testing.assert_array_less(np.abs(mt * rows - mj), step_j + m_tol["atol"])
            np.testing.assert_allclose(tb.m_scale.numpy(), np.asarray(jb.m_scale), **m_tol)
            np.testing.assert_allclose(tb.v_scale.numpy(), np.asarray(jb.v_scale), **m_tol)
            _assert_codes_close(tb.v.numpy(), jb.v, f"bucket {bi} v codes",
                                share=1.0 if p_atol else 1e-3)
            continue
        np.testing.assert_allclose(_np(tb.m) * rows, np.asarray(jb.m), **m_tol)
        if tb.v is not None:
            np.testing.assert_allclose(_np(tb.v), np.asarray(jb.v), **m_tol)


# Moments after a refresh: the projectors' LAPACK differences (~2e-5,
# ROADMAP queue 3) times |G| ~ 0.05, carried into M with weight 1-b1 = 0.1
# by Adam's inners and b1 = 0.9 by MSGD's (9x the absolute difference).
REFRESH_M_TOL = {"adam_mini": dict(atol=5e-7, rtol=1e-4), "adam8bit": dict(atol=5e-7, rtol=1e-4),
                 "msgd": dict(atol=4.5e-6, rtol=1e-4)}


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def check_refresh_then_hot(pair, inner_name, engine):
    """A refresh with JAX's draws from the initial state (params to
    REFRESH_TOL), then a hot step from JAX's carried-over state (1e-6), on
    one engine of both packages; the bucket stacks sign-aligned."""
    kw = dict(OPT_KW, engine=engine, svd_backend="randomized")
    jopt = jax_make_optimizer(NAMES[inner_name], pair["jparams"], **kw)
    topt = make_optimizer(NAMES[inner_name], pair["tparams"], **kw)
    assert (topt.state_layout is None) == (engine == "reference")
    js0 = jopt.init(pair["jparams"])
    ts0 = bridge.opt_state_from_numpy(topt, _numpy(js0), "cpu")._replace(
        draws=JaxDraws(js0.key))
    g0, g1 = pair["jgrads"]
    update = jopt.update  # eager: faster here than a compile per case
    jp1, js1, _ = update(g0, js0, pair["jparams"], refresh=True, apply=True)
    tp1, ts1, _ = topt.update(_torch_tree(g0), ts0, pair["tparams"], refresh=True,
                              apply=True)
    _assert_params_close(jp1, tp1, **REFRESH_TOL)
    if engine == "bucketed":
        _assert_states_close(topt, ts1, js1, 5e-5, REFRESH_M_TOL[inner_name])
    ts1 = bridge.opt_state_from_numpy(topt, _numpy(js1), "cpu")
    jp2, js2, jaux = update(g1, js1, jp1, refresh=False, apply=True)
    tp2, ts2, taux = topt.update(_torch_tree(g1), ts1, _torch_tree(jp1), refresh=False,
                                 apply=True)
    _assert_params_close(jp2, tp2, **HOT_TOL)
    if engine == "bucketed":
        _assert_states_close(topt, ts2, js2, 0.0, dict(atol=1e-7, rtol=1e-5))
    np.testing.assert_allclose(float(taux.update_norm), float(jaux.update_norm), rtol=1e-5)


@pytest.mark.parametrize("inner_name", list(NAMES))
def test_refresh_then_hot_update_match_jax(pair, inner_name):
    """The bucketed engine (the reference engine's cases are in
    tests/test_torch_inners_train.py, to split the CPU time)."""
    check_refresh_then_hot(pair, inner_name, "bucketed")


@pytest.mark.parametrize("carry", ["keep", "reset", "reproject"])
@pytest.mark.parametrize("inner_name", list(NAMES))
def test_momentum_carry_on_a_second_refresh_matches_jax(pair, inner_name, carry):
    """Refresh, hot step, then a second refresh from JAX's carried-over
    state, on the bucketed engine with JAX's draws.  The carried moments
    are compared with JAX's through the refresh step's update: "reset"
    starts every refreshed slice afresh (adam8bit: codes and scales 0), and
    "reproject" re-expresses M in the new basis, except adam8bit's codes,
    kept as in JAX; both give W' and moments that LAPACK's signs do not
    change, held to REFRESH_TOL.  A kept M pairs with the new projector's
    signs (ROADMAP queue 3): there the projectors are compared."""
    kw = dict(OPT_KW, engine="bucketed", svd_backend="randomized", momentum_carry=carry)
    jopt = jax_make_optimizer(NAMES[inner_name], pair["jparams"], **kw)
    topt = make_optimizer(NAMES[inner_name], pair["tparams"], **kw)
    g0, g1 = pair["jgrads"]
    update = jopt.update
    js = jopt.init(pair["jparams"])
    jp, js, _ = update(g0, js, pair["jparams"], refresh=True, apply=True)
    jp, js, _ = update(g1, js, jp, refresh=False, apply=True)
    ts = bridge.opt_state_from_numpy(topt, _numpy(js), "cpu")._replace(
        draws=JaxDraws(js.key))
    jp3, js3, _ = update(g0, js, jp, refresh=True, apply=True)
    tp3, ts3, _ = topt.update(_torch_tree(g0), ts, _torch_tree(jp), refresh=True,
                              apply=True)
    sign_free = carry == "reset" or (carry == "reproject" and inner_name != "adam8bit")
    if sign_free:
        _assert_params_close(jp3, tp3, **REFRESH_TOL)
        _assert_states_close(topt, ts3, js3, 5e-5, REFRESH_M_TOL[inner_name])
    else:
        for jb, tb in zip(js3.buckets, ts3.buckets):
            pj, pt = np.asarray(jb.projector), _np(tb.projector)
            np.testing.assert_allclose(pt * _signs(pj, pt), pj, atol=5e-5)


def test_second_refresh_does_not_depend_on_the_thread_count(pair):
    """The port's side of the adam8bit-reset case above at 1, 2, 4 and 8
    intra-op threads: the same W' to the bit.  MKL's f32 QR blocks by the
    pool size, and its one-thread result once put that case past
    REFRESH_TOL; the refresh now factors in f64 on the CPU (core/svd.py)."""
    kw = dict(OPT_KW, engine="bucketed", svd_backend="randomized", momentum_carry="reset")
    jopt = jax_make_optimizer(NAMES["adam8bit"], pair["jparams"], **kw)
    topt = make_optimizer(NAMES["adam8bit"], pair["tparams"], **kw)
    g0, g1 = pair["jgrads"]
    js = jopt.init(pair["jparams"])
    jp, js, _ = jopt.update(g0, js, pair["jparams"], refresh=True, apply=True)
    jp, js, _ = jopt.update(g1, js, jp, refresh=False, apply=True)
    runs = []
    try:
        for threads in (1, 2, 4, 8):
            torch.set_num_threads(threads)
            ts = bridge.opt_state_from_numpy(topt, _numpy(js), "cpu")._replace(
                draws=JaxDraws(js.key))
            tp, _, _ = topt.update(_torch_tree(g0), ts, _torch_tree(jp), refresh=True,
                                   apply=True)
            runs.append({path: _np(v) for path, v in flatten_with_path(tp)})
    finally:
        torch.set_num_threads(1)
    for threads, run in zip((2, 4, 8), runs[1:]):
        for path, value in run.items():
            np.testing.assert_array_equal(value, runs[0][path], err_msg=f"{threads} {path}")


@pytest.mark.parametrize("inner_name", list(NAMES))
def test_carries_of_the_bucket_stacks(pair, inner_name):
    """The refresh's carries on the stacks themselves: "reset" zeroes the
    whole inner state of the refreshed slices (adam8bit: codes and scales
    to 0, not the 1.0 of a quantized zero), "reproject" leaves adam8bit's
    codes and scales as they were, "keep" leaves every inner alone."""
    outs = {}
    for carry in ("keep", "reset", "reproject"):
        opt = make_optimizer(NAMES[inner_name], pair["tparams"], engine="bucketed",
                             svd_backend="randomized", momentum_carry=carry, **OPT_KW)
        st = opt.init(pair["tparams"])
        params = pair["tparams"]
        for k, g in enumerate(pair["jgrads"]):
            params, st, _ = opt.update(_torch_tree(g), st, params, refresh=k == 0, apply=True)
        before = st.buckets
        draws = st.draws.split()
        pcfg = opt.config.projector_config()
        flat_g = [g for _, g in flatten_with_path(_torch_tree(pair["jgrads"][0]))]
        after, _ = buckets.bucketed_refresh(
            opt.state_layout, before, opt.specs, flat_g, draws, pcfg, None, group=0,
            momentum_carry=carry,
            stacked_refresh_fn=lambda gs, d, old, r: proj_lib.refresh_projector_stacked(
                gs, d, old, pcfg, rank=r))
        outs[carry] = (before, after)
    for carry, (before, after) in outs.items():
        for b0, b1 in zip(before, after):
            for field in ("m", "v", "m_scale", "v_scale"):
                x0, x1 = getattr(b0, field), getattr(b1, field)
                if x0 is None:
                    assert x1 is None
                elif carry == "reset":
                    assert not bool(x1.any()), (carry, field)  # zeros, scales too
                elif carry == "keep" or inner_name == "adam8bit" or field != "m":
                    torch.testing.assert_close(x1, x0, rtol=0, atol=0)
                else:
                    assert not torch.equal(x1, x0)  # reprojected


@pytest.mark.parametrize("carry", ["keep", "reset", "reproject"])
@pytest.mark.parametrize("inner_name", list(NAMES))
def test_engines_agree_across_refreshes(pair, inner_name, carry):
    """The port's bucketed engine against its reference engine, with the
    port's own draws (the same numbers for both) and one LAPACK: refresh,
    hot, refresh.  Params to 1e-6; the stacks, unstacked per leaf
    (``bucketed_to_leaf_states``), against the reference engine's per-leaf
    states, and ``leaf_states_to_bucketed`` restacks them bit for bit."""
    outs = []
    for engine in ("reference", "bucketed"):
        opt = make_optimizer(NAMES[inner_name], pair["tparams"], engine=engine,
                             svd_backend="randomized", momentum_carry=carry, **OPT_KW)
        params, state = pair["tparams"], opt.init(pair["tparams"])
        for k, g in enumerate(pair["jgrads"] + pair["jgrads"][:1]):
            params, state, _ = opt.update(_torch_tree(g), state, params,
                                          refresh=k != 1, apply=True)
        outs.append((opt, params, state))
    (_, ref_params, ref_state), (opt, params, state) = outs
    for (path, a), (_, b) in zip(flatten_with_path(ref_params), flatten_with_path(params)):
        torch.testing.assert_close(b, a, atol=1e-6, rtol=0, msg=path)
    per_leaf = buckets.bucketed_to_leaf_states(opt.state_layout, state.buckets)
    assert sorted(per_leaf) == sorted(opt.bucket_plan.bucketed)
    for i, (proj, inner_state) in per_leaf.items():
        want = ref_state.leaves[i]
        torch.testing.assert_close(proj, want.projector, atol=1e-6, rtol=0)
        assert type(inner_state) is type(want.inner)
        for field, a, b in zip(type(inner_state)._fields, inner_state, want.inner):
            if "codes" in field:
                _assert_codes_close(a.numpy(), b.numpy(), field)
            else:
                torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-5, msg=field)
    restacked = buckets.leaf_states_to_bucketed(
        opt.state_layout, {i: type(ref_state.leaves[i])(p, s) for i, (p, s) in per_leaf.items()})
    for a, b in zip(restacked, state.buckets):
        for x, y in zip(a, b):
            assert (x is None) == (y is None)
            if x is not None:
                torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("inner_name", list(NAMES))
def test_state_bridge_round_trips_bit_for_bit(pair, inner_name):
    opt = make_optimizer(NAMES[inner_name], pair["tparams"], engine="bucketed", **OPT_KW)
    params, state = pair["tparams"], opt.init(pair["tparams"])
    params, state, _ = opt.update(_torch_tree(pair["jgrads"][0]), state, params,
                                  refresh=True, apply=True)
    back = bridge.opt_state_from_numpy(opt, bridge.opt_state_to_numpy(state), "cpu")
    assert back.step == state.step
    for a, b in zip(back.buckets + tuple(back.leaves), state.buckets + tuple(state.leaves)):
        flat_a = [a.projector, *(a.inner or ())] if hasattr(a, "inner") else list(a)
        flat_b = [b.projector, *(b.inner or ())] if hasattr(b, "inner") else list(b)
        for x, y in zip(flat_a, flat_b):
            assert (x is None) == (y is None)
            if x is not None:
                assert x.dtype == y.dtype
                torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_unported_inner_still_raises(pair):
    """Every inner is ported now: Adafactor builds on both engines, on its
    per-leaf state (no fused layout, in either package)."""
    for engine in ("reference", "bucketed"):
        opt = make_optimizer("galore-sara-adafactor", pair["tparams"], engine=engine, **OPT_KW)
        assert opt.state_layout is None and opt.config.inner == "adafactor"
        state = opt.init(pair["tparams"])
        assert all(type(st.inner) is inner.AdafactorState for st in state.leaves)
    with pytest.raises(ValueError, match="unknown inner"):
        inner.make_inner("adagrad")
