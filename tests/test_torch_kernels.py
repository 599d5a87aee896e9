"""The port's kernels (src/repro_torch/kernels) against the JAX package's.

On the CPU each port wrapper runs its plain PyTorch version; those are
held against the JAX refs and the Pallas kernels in interpret mode, on the
same numpy-seeded inputs.  The kernels themselves are held against these
plain versions on the card by tests/test_torch_gpu.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_fwd as jax_flash_kernel
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref
from repro.kernels.flash_attention_decode.kernel import (
    paged_decode_attention_kernel as jax_paged_kernel,
)
from repro.kernels.flash_attention_decode.ref import (
    paged_decode_attention_ref as jax_paged_ref,
)
from repro.kernels.rmsnorm.kernel import rmsnorm as jax_rmsnorm_kernel
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jax_rmsnorm_ref
from repro_torch.kernels import counters
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.flash_attention_decode import ops as fad_ops
from repro_torch.kernels.flash_attention_decode.kernel import (
    CLUSTER_SIZES,
    cluster_size,
    paged_decode_attention_kernel,
)
from repro_torch.kernels.flash_attention_decode.kernel import design as paged_design
from repro_torch.kernels.flash_attention_decode.ref import paged_decode_attention_ref
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm.kernel import rmsnorm as rmsnorm_kernel
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from test_torch_gpu import FLASH_CASES, TOL, TORCH, paged_inputs

# One intra-op thread: the test workers share the host's cores, and the
# port's results do not depend on the thread count (core/svd.py).
torch.set_num_threads(1)

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch CPU tensor."""
    return jnp.asarray(a).astype(JNP[dtype]), torch.from_numpy(a).to(TORCH[dtype])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(4, 64), (3, 5, 128), (16, 96)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_jax(shape, dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 2.0).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    jx, tx = _pair(x, dtype)
    js, ts = jnp.asarray(scale), torch.from_numpy(scale)
    got = rmsnorm_ref(tx, ts, 1e-5)
    assert got.dtype == TORCH[dtype]
    np.testing.assert_allclose(_np(got), _np(jax_rmsnorm_ref(jx, js, 1e-5)), **TOL[dtype])
    pallas = jax_rmsnorm_kernel(jx, js, eps=1e-5, block_rows=8, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), **TOL[dtype])


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_with_a_given_sum_of_squares_matches_jax(parts, dtype):
    """A row split into ``parts`` blocks of channels, each normalized with
    the whole row's f32 sum of squares (the SSM mixer's gated norm on a
    process's heads), is the whole row's RMSNorm, side by side."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 5, 128)) * 2.0).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    ts = torch.from_numpy(scale)
    ss = torch.sum(tx.float() ** 2, dim=-1, keepdim=True)
    got = torch.cat([rms_ops.rmsnorm(xp, sp, 1e-5, ss=ss, width=128)
                     for xp, sp in zip(tx.chunk(parts, -1), ts.chunk(parts))], dim=-1)
    assert got.dtype == TORCH[dtype]
    want = jax_rmsnorm_ref(jx, jnp.asarray(scale), 1e-5)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def test_rmsnorm_dispatch_takes_plain_version_on_cpu():
    x = torch.randn(6, 32, generator=torch.Generator().manual_seed(0))
    scale = torch.linspace(0.5, 1.5, 32)
    counters.reset()
    torch.testing.assert_close(rms_ops.rmsnorm(x, scale), rmsnorm_ref(x, scale), rtol=0, atol=0)
    assert counters.snapshot() == {}  # no kernel launched
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_kernel(x, scale)  # the kernel wrapper has no CPU path


# ---------------------------------------------------------------------------
# flash-attention forward (prefill)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(FLASH_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_jax(case, dtype):
    b, sq, sk, h, kvh, d, causal, window, q_offset = FLASH_CASES[case]
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, sq, h, d), (b, sk, kvh, d), (b, sk, kvh, d)))
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dtype), _pair(k, dtype), _pair(v, dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = flash_attention_ref(tq, tk, tv, **kw)
    assert got.shape == (b, sq, h, d) and got.dtype == TORCH[dtype]
    np.testing.assert_allclose(_np(got), _np(jax_flash_ref(jq, jk, jv, **kw)), **TOL[dtype])
    pallas = jax_flash_kernel(jq, jk, jv, block_q=16, block_kv=16, interpret=True, **kw)
    np.testing.assert_allclose(_np(got), _np(pallas), **TOL[dtype])


def test_flash_dispatch_takes_plain_version_on_cpu():
    g = torch.Generator().manual_seed(2)
    q = torch.randn(1, 8, 4, 16, generator=g)
    k = torch.randn(1, 8, 2, 16, generator=g)
    pos = torch.arange(8)[None]
    counters.reset()
    out = fa_ops.flash_attention(q, k, k, pos, pos, causal=True, window=3)
    torch.testing.assert_close(out, flash_attention_ref(q, k, k, window=3), rtol=0, atol=0)
    assert counters.snapshot() == {}
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd(q, k, k)


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("window", [0, 5])
def test_paged_decode_plain_matches_jax(ps, window):
    b, mp, h, kvh, d = 4, 3, 4, 2, 64
    fills = [1, ps + 2, 3 * ps - 1, 0]  # partial / multi-page / full / empty
    q, pk, pv, table, lens = paged_inputs(ps, b, mp, ps, h, kvh, d, fills)
    got = paged_decode_attention_ref(
        torch.from_numpy(q), torch.from_numpy(pk), torch.from_numpy(pv),
        torch.from_numpy(table), torch.from_numpy(lens), window=window,
    )
    jargs = [jnp.asarray(a) for a in (q, pk, pv, table, lens)]
    tol = dict(atol=2e-5, rtol=1e-5)  # the JAX repo's own paged-decode bar
    np.testing.assert_allclose(_np(got), _np(jax_paged_ref(*jargs, window=window)), **tol)
    pallas = jax_paged_kernel(*jargs, window=window, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), **tol)
    assert np.all(got[3].numpy() == 0.0)  # empty slot: exact zeros, not NaN


def test_paged_decode_dispatch_takes_plain_version_on_cpu():
    q, pk, pv, table, lens = (
        torch.from_numpy(a) for a in paged_inputs(3, 2, 2, 8, 4, 2, 64, [3, 9])
    )
    counters.reset()
    out = fad_ops.paged_decode_attention(q, pk, pv, table, lens)
    ref = paged_decode_attention_ref(q, pk, pv, table, lens)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert counters.snapshot() == {}
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_attention_kernel(q, pk, pv, table, lens)


# The H100's cluster occupancy for llama3-8b's paged kernel at two blocks
# per SM (cudaOccupancyMaxActiveClusters: clusters may not straddle a GPC)
H100_CLUSTERS = {1: 264, 2: 132, 4: 62, 8: 30}


# (B, KVH, capacity MP * ps, cluster size): the serve trace's 32 (slot, KV
# head) pairs, the bandwidth case's 256, the steps between, and slots too
# short to share
@pytest.mark.parametrize("b,kvh,capacity,want", [
    (4, 8, 1056, 4), (32, 8, 3008, 1), (3, 8, 4096, 8), (5, 8, 4096, 4),
    (8, 8, 4096, 2), (16, 8, 4096, 2), (17, 8, 4096, 1), (4, 8, 32, 1),
    (4, 8, 64, 2), (1, 1, 1, 1), (1, 1, 10**6, 8),
])
def test_paged_decode_cluster_size(b, kvh, capacity, want):
    """The wrapper's grid is (CS, KVH, B) in clusters of (CS, 1, 1): CS is a
    portable cluster size, all B * KVH clusters run at once unless CS is 1,
    and each rank has at least one 32-token tile of the capacity."""
    cs = cluster_size(b, kvh, capacity, H100_CLUSTERS)
    assert cs == want
    assert cs in CLUSTER_SIZES
    assert cs == 1 or b * kvh <= H100_CLUSTERS[cs]
    assert cs == 1 or cs * 32 <= capacity


@pytest.mark.parametrize("dtype,d,g,aligned,rows,want", [
    (torch.bfloat16, 128, 4, True, 10**6, "tensor_cores"),
    (torch.bfloat16, 64, 16, True, 10**6, "tensor_cores"),
    (torch.bfloat16, 256, 1, True, 10**6, "tensor_cores"),
    (torch.bfloat16, 128, 32, True, 10**6, "cuda_cores"),
    (torch.bfloat16, 72, 4, True, 10**6, "cuda_cores"),
    (torch.bfloat16, 128, 4, False, 10**6, "cuda_cores"),
    (torch.bfloat16, 128, 4, True, 2**31, "cuda_cores"),
    (torch.float32, 128, 4, True, 10**6, "cuda_cores"),
])
def test_paged_decode_design(dtype, d, g, aligned, rows, want):
    assert paged_design(dtype, d, g, aligned, rows) == want
