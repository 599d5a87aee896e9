"""Kernel 10 of PERF.md's table, the 2-D gradient projection fused with
Adam's moments, on the CPU against the JAX package.

The port's plain version (``kernels/galore_project/ref.py::
galore_project_ref``) is held against JAX's Pallas kernel
(``galore_project(..., interpret=True)``) and JAX's ref, on the shapes and
dtypes of ``tests/test_kernels_extra.py::test_galore_project_matches_ref``
with numpy-seeded inputs.  The CUDA kernel is held against this plain
version on the card by ``tests/test_torch_gpu.py``; its wrapper raises on
a CPU tensor.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.galore_project.kernel import galore_project as jax_galore_project
from repro.kernels.galore_project.ref import galore_project_ref as jax_galore_project_ref
from repro_torch.kernels import counters
from repro_torch.kernels.galore_project.kernel import galore_project
from repro_torch.kernels.galore_project.ref import galore_project_ref

# One intra-op thread: the test workers share the host's cores, and the
# port's results do not depend on the thread count (core/svd.py).
torch.set_num_threads(1)

# f32: the same products summed over d in other orders (XLA vs ATen), on
# outputs of order 0.1.  bf16 G: the bar of JAX's own test of its kernel
# (test_kernels_extra.py:77).
TOL = {"float32": dict(atol=1e-5, rtol=0.0), "bfloat16": dict(atol=3e-2, rtol=0.0)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(d, n, r, seed=0):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal((d, n)) * 0.1).astype(np.float32)
    p = np.linalg.qr(rng.standard_normal((d, r)))[0].astype(np.float32)
    m = (rng.standard_normal((r, n)) * 0.01).astype(np.float32)
    v = (np.abs(rng.standard_normal((r, n))) * 1e-4).astype(np.float32)
    return g, p, m, v


@pytest.mark.parametrize("d,n,r", [
    (256, 512, 128), (512, 1024, 64), (100, 200, 16), (384, 768, 256),
])
@pytest.mark.parametrize("gdtype", ["float32", "bfloat16"])
def test_project_2d_plain_matches_jax(d, n, r, gdtype):
    g, p, m, v = _inputs(d, n, r)
    tg = torch.from_numpy(g).to(TORCH[gdtype])
    jg = jnp.asarray(g).astype(JNP[gdtype])
    got = galore_project_ref(tg, torch.from_numpy(p), torch.from_numpy(m),
                             torch.from_numpy(v), b1=0.9, b2=0.999)
    assert all(t.dtype == torch.float32 and t.shape == (r, n) for t in got)
    pallas = jax_galore_project(jg, p, m, v, interpret=True)
    ref = jax_galore_project_ref(jg, p, m, v, b1=0.9, b2=0.999)
    for name, a, b, c in zip(("R", "M'", "V'"), got, pallas, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=f"{name} vs Pallas",
                                   **TOL[gdtype])
        np.testing.assert_allclose(a.numpy(), np.asarray(c), err_msg=f"{name} vs ref",
                                   **TOL[gdtype])


def test_project_2d_plain_rounds_each_operation():
    """M' and V' are the f32 products and sums of R, each rounded on its
    own, as the CUDA kernel's epilogue computes them (__fmul_rn, __fadd_rn):
    bit for bit against numpy in f32."""
    g, p, m, v = _inputs(100, 200, 16, seed=1)
    r_, m_new, v_new = galore_project_ref(*map(torch.from_numpy, (g, p, m, v)),
                                          b1=0.9, b2=0.999)
    r32 = r_.numpy()
    b1, c1 = np.float32(0.9), np.float32(1.0 - 0.9)
    b2, c2 = np.float32(0.999), np.float32(1.0 - 0.999)
    np.testing.assert_array_equal(m_new.numpy(), b1 * m + c1 * r32)
    np.testing.assert_array_equal(v_new.numpy(), b2 * v + (c2 * r32) * r32)


def test_project_2d_wrapper_raises_on_cpu():
    g, p, m, v = map(torch.from_numpy, _inputs(40, 72, 8))
    counters.reset()
    with pytest.raises(ValueError, match="CUDA"):
        galore_project(g, p, m, v)
    assert counters.snapshot() == {}
