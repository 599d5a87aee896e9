"""An f32-accurate TF32 split of kernel 9's product, emulated on the CPU.

The split is a design for taking Y = G (G^T Q) on Hopper's TF32 tensor
cores to f32's accuracy (kernel 9, ``csrc/power_iter.cu``, computes it in
f32 on the CUDA cores): each f32 operand value x becomes hi = rna_tf32(x)
and lo = rna_tf32(x - hi), and each product a b is taken as hi_a hi_b +
hi_a lo_b + lo_a hi_b (a bf16 G is TF32 already, lo = 0), with Z = G^T Q
stored in f32 between the two products.  Here the rounding is emulated bit
for bit (``rna_tf32``, as ``cvt.rna.tf32.f32``), the products exactly and
the sums in f64, so the tests hold what the three products lose against a
numpy f64 product, beside the JAX package's f32 plain version
(``repro.kernels.power_iter.ref.power_iter_ref``) and kernel 9's bar in
chip_smoke.py, and show that one TF32 product misses that bar.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.power_iter.ref import power_iter_ref as jax_power_ref

torch.set_num_threads(1)

# chip_smoke.TOL["power_iter_batched"]["float32"]: |got - want| <= atol *
# max |want| + rtol * |want|
ATOL, RTOL = 1e-5, 1e-4


def rna_tf32(x) -> np.ndarray:
    """f32 -> TF32 as ``cvt.rna.tf32.f32``: keep 10 mantissa bits, round to
    nearest with ties away from zero (add half a TF32 ulp to the magnitude
    bits, drop the low 13); the sign, zeros and infinities stay, NaN stays
    NaN.  Returned as f32 with the low 13 bits zero."""
    x = np.asarray(x, dtype=np.float32)
    u = x.view(np.uint32)
    r = ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    return np.where(np.isnan(x), x, r)


def split(x: np.ndarray):
    """(hi, lo) in f64: hi = rna_tf32(x), lo = rna_tf32(x - hi); x - hi is
    exact in f32."""
    x = x.astype(np.float32)
    hi = rna_tf32(x)
    lo = rna_tf32(x - hi)
    return hi.astype(np.float64), lo.astype(np.float64)


def split_power_iter(g: np.ndarray, q: np.ndarray, products: int = 3) -> np.ndarray:
    """Y = G (G^T Q) as the split forms it, with exact products and f64 sums:
    three TF32 products per operand pair (hi hi, hi lo, lo hi), or hi hi
    alone (``products`` 1, plain TF32); Z^T rounded to f32 between them."""

    def product(a, b):  # a b per slice, from the split parts
        (ah, al), (bh, bl) = split(a), split(b)
        out = ah @ bh
        if products == 3:
            out += ah @ bl + al @ bh
        return out

    z = product(g.transpose(0, 2, 1), q).astype(np.float32)
    return product(g, z).astype(np.float32)


def f64_power_iter(g, q):
    g64, q64 = g.astype(np.float64), q.astype(np.float64)
    return g64 @ (g64.transpose(0, 2, 1) @ q64)


def inputs(seed, shape, bf16):
    b, m, n, kp = shape
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((b, m, n)).astype(np.float32)
    if bf16:  # bf16 values, held in f32
        g = torch.from_numpy(g).bfloat16().float().numpy()
    q = np.linalg.qr(rng.standard_normal((b, m, kp)))[0].astype(np.float32)
    return g, q


def off_bar(got, want) -> int:
    """Elements of ``got`` outside kernel 9's bar around ``want``."""
    bar = ATOL * np.abs(want).max() + RTOL * np.abs(want)
    return int((np.abs(got.astype(np.float64) - want) > bar).sum())


# ---------------------------------------------------------------------------
# the rounding
# ---------------------------------------------------------------------------

ULP = 2.0 ** -10  # TF32's ulp at 1


@pytest.mark.parametrize("x,want", [
    (1.0, 1.0),                                   # exact TF32 values stay
    (1.0 + ULP, 1.0 + ULP),
    (1.0 + ULP / 2, 1.0 + ULP),                   # a tie goes away from zero (RNE: 1.0)
    (-(1.0 + ULP / 2), -(1.0 + ULP)),             # ... for negatives too
    (1.0 + 3 * ULP / 2, 1.0 + 2 * ULP),           # a tie above an odd last bit
    (1.0 + ULP / 2 - 2.0 ** -23, 1.0),            # just below a tie: down
    (-(1.0 + ULP / 2 - 2.0 ** -23), -1.0),
    (3.0 * 2.0 ** -20 + 2.0 ** -30, 3.0 * 2.0 ** -20 + 2.0 ** -29),  # a tie two decades down
    (3.0 * 2.0 ** -20 + 2.0 ** -31, 3.0 * 2.0 ** -20),               # under it
    (np.inf, np.inf),
    (-np.inf, -np.inf),
])
def test_rna_tf32_rounds_to_nearest_with_ties_away(x, want):
    got = rna_tf32(np.float32(x))
    assert got == np.float32(want)
    assert got.view(np.uint32) & np.uint32(0x1FFF) == 0 or not np.isfinite(got)


def test_rna_tf32_keeps_signed_zeros_and_nan():
    z = rna_tf32(np.array([0.0, -0.0], dtype=np.float32))
    assert (z == 0).all() and not np.signbit(z[0]) and np.signbit(z[1])
    assert np.isnan(rna_tf32(np.float32(np.nan)))
    assert np.isnan(rna_tf32(np.array([0x7F800001], dtype=np.uint32).view(np.float32)))[0]


def test_split_recovers_f32_to_the_split_precision():
    """hi has 11 significant bits, lo the next 11 (rounded): x - (hi + lo)
    is at most 2^-22 |x| off (in practice 2^-23 and below); a bf16 value
    splits with lo = 0."""
    x = np.random.default_rng(0).standard_normal(100_000).astype(np.float32)
    x *= np.exp2(np.random.default_rng(1).integers(-30, 30, x.size)).astype(np.float32)
    hi, lo = split(x)
    assert (np.abs(x - (hi + lo)) <= 2.0 ** -22 * np.abs(x)).all()
    assert (np.abs(x - hi) <= 2.0 ** -11 * np.abs(x)).all()
    b = torch.from_numpy(x).bfloat16().float().numpy()
    hb, lb = split(b)
    assert (hb == b).all() and (lb == 0).all()


# ---------------------------------------------------------------------------
# the split product against f64, beside JAX's f32 plain version
# ---------------------------------------------------------------------------

SHAPES = {"ragged_kp136": ((2, 256, 896, 136), False), "square_130": ((1, 300, 130, 130), False),
          "bf16_g": ((2, 256, 896, 136), True)}


@pytest.mark.parametrize("case", list(SHAPES))
def test_three_products_hold_f32_accuracy(case):
    """The three-product split lies within kernel 9's bar around the f64
    product, its largest error at most twice the JAX package's f32 plain
    version's."""
    shape, bf16 = SHAPES[case]
    g, q = inputs(3, shape, bf16)
    want = f64_power_iter(g, q)
    got = split_power_iter(g, q)
    jax_f32 = np.asarray(jax_power_ref(jnp.asarray(g), jnp.asarray(q)))
    err = np.abs(got.astype(np.float64) - want).max()
    jax_err = np.abs(jax_f32.astype(np.float64) - want).max()
    assert off_bar(got, want) == 0
    assert err <= 2 * jax_err, (err, jax_err)


@pytest.mark.parametrize("case", list(SHAPES))
def test_one_tf32_product_misses_the_bar(case):
    """hi hi alone (plain TF32, three decimal digits) misses the same bar on
    the same inputs: the test tells the split from plain TF32."""
    shape, bf16 = SHAPES[case]
    g, q = inputs(3, shape, bf16)
    want = f64_power_iter(g, q)
    assert off_bar(split_power_iter(g, q, products=1), want) > 0
