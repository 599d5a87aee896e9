"""The port's optimizer kernels and the modules around them against the JAX
package's, on the CPU.

On the CPU each port wrapper runs its plain PyTorch version: the batched
projection (kernel 4 of PERF.md's table), the fused low-rank Adam update
(5) and the power-iteration step (9).  They are held against the JAX refs
and the Pallas kernels in interpret mode, on numpy-seeded inputs, in f32
and with bf16 weights, on stacks gathered from side-left and side-right
leaves.  The kernels themselves are held against these plain versions on
the card by tests/test_torch_gpu.py.  Also here: the port's sampling, SVD
and schedule modules against JAX's, with JAX's own random draws handed in
(``JaxDraws``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as jax_api
from repro.core import buckets as jax_buckets
from repro.core import sampling as jax_sampling
from repro.core import schedules as jax_schedules
from repro.core import svd as jax_svd
from repro.kernels.galore_project.kernel import galore_project_batched as jax_project_kernel
from repro.kernels.galore_project.ref import project_ref as jax_project_ref
from repro.kernels.lowrank_update import ref as jax_update_ref
from repro.kernels.lowrank_update.kernel import (
    lowrank_adam_update_batched as jax_adam_kernel,
)
from repro.kernels.power_iter.kernel import power_iter_batched as jax_power_kernel
from repro.kernels.power_iter.ref import power_iter_ref as jax_power_ref
from repro_torch.core import api, buckets, sampling, schedules, svd
from repro_torch.core.projectors import LeafDraws
from repro_torch.kernels import counters
from repro_torch.kernels.galore_project.kernel import galore_project_batched
from repro_torch.kernels.galore_project.ref import project_ref
from repro_torch.kernels.lowrank_update import ops as update_ops
from repro_torch.kernels.lowrank_update import ref as update_ref
from repro_torch.kernels.lowrank_update.kernel import lowrank_adam_update_batched
from repro_torch.kernels.power_iter import ops as power_ops
from repro_torch.kernels.power_iter.kernel import power_iter_batched
from repro_torch.kernels.power_iter.ref import power_iter_ref

# One intra-op thread: the test workers share the host's cores, and the
# port's results do not depend on the thread count (core/svd.py).
torch.set_num_threads(1)

# f32 on the CPU: the same products summed in other orders (XLA vs ATen).
F32 = dict(atol=2e-5, rtol=1e-5)
# bf16 W': rounds to 8 significant bits, so one bf16 ulp (2^-7 relative)
# apart is agreement.
BF16 = dict(atol=2e-2, rtol=2.0**-7)


class JaxDraws:
    """The port's draw-source interface (``core/lowrank.py::TorchDraws``)
    answered with JAX's own draws, recomputed along the reference's key
    chain: ``key, subkey = split(key)`` per refresh (lowrank.py:673), then
    ``fold_in(subkey, leaf_idx)`` (lowrank.py:800, buckets.py:858), split
    over the leaf's leading dims (buckets.py:859-861; a leaf without them
    uses the folded key whole).  From each slice key ``k``:

      * dominant and sara (the SVD methods) split it once more,
        ``key_svd, key_sample = split(k)`` (projectors.py:174, 253-254):
        the sketch ``normal(key_svd, (n, k'))`` (svd.py:122-124) and sara's
        Gumbel noise ``gumbel(key_sample, (k,))`` (sampling.py:56);
      * golore draws its basis ``normal(k, (d, rank))`` from the slice key
        itself (projectors.py:144, 221);
      * grass draws its Gumbel noise ``gumbel(k, (d,))`` over the rows from
        the slice key itself (projectors.py:148-149, sampling.py:56);
      * identity and online_pca draw nothing.

    ``method`` picks the chain; the default is the SVD methods'.

    Like ``TorchDraws`` it writes its key to a checkpoint (``key()``: the
    carried key, JAX's ``.opt_state.key``), reads one back (``from_key``)
    and moves to a rollback's stream with JAX's rule (``resample``:
    ``fold_in(key, 0x5EED + attempt)``, ``src/repro/train/recovery.py:195``),
    so the port's loop draws JAX's numbers through a rollback."""

    device = "cpu"
    default_method = "sara"  # the chain of a source read back by ``from_key``

    def __init__(self, key, subkey=None, method=None):
        self.jkey, self.subkey = key, subkey
        self.method = method or self.default_method

    def split(self):
        key, sub = jax.random.split(self.jkey)
        return type(self)(key, sub, self.method)

    def key(self):
        return np.asarray(self.jkey, dtype=np.uint32)

    @classmethod
    def from_key(cls, key, device=None):
        return cls(jnp.asarray(np.asarray(key, dtype=np.uint32)))

    def resample(self, attempt):
        return type(self)(jax.random.fold_in(self.jkey, 0x5EED + attempt), method=self.method)

    def leaf(self, leaf_idx, batch_shape, shapes, device=None):
        lkey = jax.random.fold_in(self.subkey, leaf_idx)
        nb = int(np.prod(batch_shape)) if batch_shape else 0
        whole = self.method in ("golore", "grass")
        omega, gumbel, basis = _jax_leaf_draws(lkey, nb, shapes.sketch, shapes.gumbel,
                                               shapes.basis, whole)
        return LeafDraws(_t(omega, device), _t(gumbel, device), _t(basis, device))


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
def _jax_leaf_draws(lkey, nb, sketch, gumbel_len, basis, whole):
    """One leaf's draws from its folded key (``JaxDraws.leaf``); ``nb`` 0
    for a leaf with no leading dims; ``whole``: draw from the slice key
    itself (golore, grass), else from the halves of its split.  Jitted, so
    that each shape traces once per process: the same numbers as the eager
    calls."""
    keys = jax.random.split(lkey, nb) if nb else lkey[None]
    if whole:
        svd_keys = sample_keys = keys
    else:
        pairs = jax.vmap(jax.random.split)(keys)
        svd_keys, sample_keys = pairs[:, 0], pairs[:, 1]
    omega = gumbel = out_basis = None
    if sketch is not None:
        omega = jax.vmap(lambda k: jax.random.normal(k, sketch, jnp.float32))(svd_keys)
    if gumbel_len is not None:
        gumbel = jax.vmap(lambda k: jax.random.gumbel(k, (gumbel_len,), jnp.float32))(
            sample_keys)
    if basis is not None:
        out_basis = jax.vmap(lambda k: jax.random.normal(k, basis, jnp.float32))(keys)
    return omega, gumbel, out_basis


def _t(a, device=None):
    if a is None:
        return None
    return torch.from_numpy(np.array(a, copy=True)).to(device or "cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _stack_pair(rng, side, b, d, n, dtype=np.float32):
    """One (b, d, n) canonical stack as the bucket engines gather it from a
    single leaf: a side-right leaf is stored (b, n, d) and enters
    transposed.  Returns (jax stack, torch stack)."""
    shape = (b, d, n) if side == "left" else (b, n, d)
    leaf = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    entry = (0, side, b)
    jb = jax_buckets.Bucket(d, n, 4, (jax_buckets.BucketEntry(*entry),))
    tb = buckets.Bucket(d, n, 4, (buckets.BucketEntry(*entry),))
    jl = jnp.asarray(leaf).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tl = torch.from_numpy(leaf).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    return jax_buckets._gather(jb, [jl]), buckets._gather(tb, [tl])


# (B, d, n, r): ragged (no 128-multiples) and aligned
SHAPES = {"ragged": (3, 40, 72, 8), "aligned": (2, 128, 256, 16)}


# ---------------------------------------------------------------------------
# kernel 4: batched projection R = P^T G
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_project_plain_matches_jax(shape, side, dtype):
    b, d, n, r = SHAPES[shape]
    rng = np.random.default_rng(0)
    jg, tg = _stack_pair(rng, side, b, d, n, dtype)
    p = rng.standard_normal((b, d, r)).astype(np.float32) / np.sqrt(d)
    got = update_ops.bucketed_project(tg, torch.from_numpy(p))
    assert got.dtype == torch.float32 and got.shape == (b, r, n)
    np.testing.assert_allclose(_np(got), _np(jax_project_ref(jg, jnp.asarray(p))), **F32)
    pallas = jax_project_kernel(jg, jnp.asarray(p), interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), **F32)


# ---------------------------------------------------------------------------
# kernel 5: fused low-rank Adam update with back-projection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step,lr_wd", [(1, 0.0), (7, 1e-3)])
def test_adam_update_plain_matches_jax(shape, side, dtype, step, lr_wd):
    b, d, n, r = SHAPES[shape]
    rng = np.random.default_rng(step)
    jw, tw = _stack_pair(rng, side, b, d, n, dtype)
    p = rng.standard_normal((b, d, r)).astype(np.float32) / np.sqrt(d)
    rg, m = (rng.standard_normal((b, r, n)).astype(np.float32) * 0.1 for _ in range(2))
    v = (rng.standard_normal((b, r, n)).astype(np.float32) * 0.01) ** 2
    lr_alpha = 0.01 * 0.25
    got = update_ops.bucketed_adam_update(
        tw, *(torch.from_numpy(a) for a in (p, rg, m, v)), step, lr_alpha, lr_wd,
        b1=0.9, b2=0.999, eps=1e-8,
    )
    jargs = [jnp.asarray(a) for a in (p, rg, m, v)]
    want_ref = jax_update_ref.lowrank_adam_update_ref(
        jw, *jargs, b1=0.9, b2=0.999, eps=1e-8, step=jnp.int32(step),
        lr_alpha=jnp.float32(lr_alpha), lr_wd=jnp.float32(lr_wd),
    )
    want_pallas = jax_adam_kernel(
        jw, *jargs, jnp.int32(step), jnp.float32(lr_alpha), jnp.float32(lr_wd),
        interpret=True,
    )
    w_tol = F32 if dtype == "float32" else BF16
    assert got[0].dtype == tw.dtype and got[1].dtype == got[2].dtype == torch.float32
    for want in (want_ref, want_pallas):
        np.testing.assert_allclose(_np(got[0]), _np(want[0]), **w_tol)
        np.testing.assert_allclose(_np(got[1]), _np(want[1]), **F32)
        np.testing.assert_allclose(_np(got[2]), _np(want[2]), **F32)


def test_msgd_update_plain_matches_jax():
    rng = np.random.default_rng(3)
    w, p, rg, m = (rng.standard_normal(s).astype(np.float32)
                   for s in ((2, 24, 40), (2, 24, 4), (2, 4, 40), (2, 4, 40)))
    got = update_ops.bucketed_msgd_update(
        *(torch.from_numpy(a) for a in (w, p, rg, m)), 0.0025, 1e-3, b1=0.9)
    want = jax_update_ref.lowrank_msgd_update_ref(
        *(jnp.asarray(a) for a in (w, p, rg, m)), b1=0.9, lr_alpha=0.0025, lr_wd=1e-3)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), **F32)


# ---------------------------------------------------------------------------
# kernel 9: power-iteration step Y = G (G^T Q)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 40, 72, 12), (2, 128, 512, 24), (1, 64, 96, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_power_iter_plain_matches_jax(shape, dtype):
    b, m, n, kp = shape
    rng = np.random.default_rng(4)
    g = (rng.standard_normal((b, m, n)) * 0.1).astype(np.float32)
    q = rng.standard_normal((b, m, kp)).astype(np.float32) / np.sqrt(m)
    jg = jnp.asarray(g).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tg = torch.from_numpy(g).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    got = power_ops.power_iter_step(tg, torch.from_numpy(q))
    assert got.dtype == torch.float32 and got.shape == (b, m, kp)
    np.testing.assert_allclose(_np(got), _np(jax_power_ref(jg, jnp.asarray(q))), **F32)
    pallas = jax_power_kernel(jg, jnp.asarray(q), interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), **F32)
    # the 2-D entry point (per-leaf randomized SVD) is the B=1 stack
    two_d = power_ops.power_iter_step(tg[0], torch.from_numpy(q[0]))
    torch.testing.assert_close(two_d, got[0], rtol=0, atol=0)


def test_dispatch_takes_plain_versions_on_cpu():
    g = torch.randn(2, 16, 24, generator=torch.Generator().manual_seed(0))
    p = torch.randn(2, 16, 4, generator=torch.Generator().manual_seed(1))
    r = torch.randn(2, 4, 24, generator=torch.Generator().manual_seed(2))
    counters.reset()
    torch.testing.assert_close(update_ops.bucketed_project(g, p), project_ref(g, p),
                               rtol=0, atol=0)
    torch.testing.assert_close(power_ops.power_iter_step(g, p), power_iter_ref(g, p),
                               rtol=0, atol=0)
    got = update_ops.bucketed_adam_update(g, p, r, r, r * r, 2, 0.1)
    want = update_ref.lowrank_adam_update_ref(
        g, p, r, r, r * r, b1=0.9, b2=0.999, eps=1e-8, step=2, lr_alpha=0.1)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert counters.snapshot() == {}  # no kernel launched
    # the kernel wrappers have no CPU path
    with pytest.raises(ValueError, match="CUDA"):
        galore_project_batched(g, p)
    with pytest.raises(ValueError, match="CUDA"):
        power_iter_batched(g, p)
    with pytest.raises(ValueError, match="CUDA"):
        lowrank_adam_update_batched(g, p, r, r, r, 1, 0.1)


# ---------------------------------------------------------------------------
# sampling, SVD and schedules with JAX's draws handed in
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("zero_weights", [False, True])
def test_gumbel_topk_and_sara_select_match_jax(zero_weights):
    rng = np.random.default_rng(5)
    b, d, k, r = 4, 24, 16, 5
    s = np.sort(np.abs(rng.standard_normal((b, k))).astype(np.float32))[:, ::-1].copy()
    if zero_weights:
        s[0] = 0.0  # an all-zero row: uniform fallback
        s[1, 3:] = 0.0  # 3 positive weights for 5 draws: ties at -1e30
    u = rng.standard_normal((b, d, k)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), b)
    want_idx = jax_sampling.gumbel_topk_indices_batched(jnp.asarray(s), r, keys)
    want_p, _ = jax_sampling.sara_select_batched(jnp.asarray(u), jnp.asarray(s), r, keys)
    noise = _t(jax.vmap(lambda kk: jax.random.gumbel(kk, (k,), jnp.float32))(keys))
    got_idx = sampling.gumbel_topk_indices(torch.from_numpy(s), r, noise)
    got_p, idx = sampling.sara_select(torch.from_numpy(u), torch.from_numpy(s), r, noise)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    with pytest.raises(ValueError, match="without replacement"):
        sampling.gumbel_topk_indices(torch.ones(3), 4, torch.zeros(3))


@pytest.mark.parametrize("m,n,k", [(48, 80, 8), (32, 64, 30), (64, 64, 12)])
def test_randomized_svd_matches_jax_with_its_sketch(m, n, k):
    """Singular values to 1e-5 relative; left singular vectors up to sign
    (LAPACK's QR/SVD sign choices may differ between the two packages)."""
    rng = np.random.default_rng(6)
    g = (rng.standard_normal((2, m, n)) @ np.diag(np.linspace(2.0, 0.1, n))).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    ju, js = jax_svd.randomized_svd_stacked(jnp.asarray(g), k, keys)
    kk, kp, iters = svd.clamp_sketch(m, n, k, 8, 2)
    assert (kk, kp, iters) == jax_svd.clamp_sketch(m, n, k, 8, 2)
    omega = _t(jax.vmap(lambda key: jax.random.normal(key, (n, kp), jnp.float32))(keys))
    tu, ts = svd.randomized_svd_stacked(torch.from_numpy(g), k, omega)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-6)
    ju = np.asarray(ju)
    sign = np.sign(np.sum(ju * tu.numpy(), axis=1, keepdims=True))
    np.testing.assert_allclose(tu.numpy() * sign, ju, atol=2e-4)
    eu, es = svd.exact_svd(torch.from_numpy(g[0]), k)
    jeu, jes = jax_svd.exact_svd(jnp.asarray(g[0]), k)
    np.testing.assert_allclose(es.numpy(), np.asarray(jes), rtol=1e-5)


def test_schedules_and_names_match_jax():
    for peak, warm, total in ((0.01, 100, 1000), (0.01, 1, 3), (3e-4, 0, 10)):
        jf = jax_schedules.cosine_with_warmup(peak, warm, total)
        tf = schedules.cosine_with_warmup(peak, warm, total)
        for step in (0, 1, 2, warm, warm + 1, total // 2, total, total + 5):
            np.testing.assert_allclose(tf(step), float(jf(jnp.int32(step))), rtol=1e-6)
    assert schedules.constant(0.3)(7) == float(np.float32(0.3))
    for name in ("galore-sara-adam", "sara-adam", "galore-adam", "adam", "full-msgd",
                 "golore-adam", "fira-sara-adam", "online-pca-adam-mini", "grass-adam8bit"):
        assert api.parse_name(name) == jax_api.parse_name(name), name
    with pytest.raises(ValueError):
        api.parse_name("galore-sgd")
