"""The port's hand-written kernels against their plain PyTorch versions,
on a CUDA card (``gpu`` marker).  Each test decides inside its body whether
a card is present and skips where there is none.  This file imports
neither JAX nor the JAX package, so it also runs on a machine without them;
there, skip the repo's conftest (it imports JAX):

    PYTHONPATH=src python -m pytest -q -p no:cacheprovider --noconftest -m gpu tests/test_torch_gpu.py

The shapes and inputs here are shared with tests/test_torch_kernels.py,
which holds the plain versions against JAX on the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.flash_attention_decode.kernel import (
    paged_decode_attention_kernel,
)
from repro_torch.kernels.flash_attention_decode.ref import paged_decode_attention_ref
from repro_torch.kernels.rmsnorm.kernel import rmsnorm as rmsnorm_kernel
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# f32: the same math summed in other orders.  bf16: outputs round to 8
# significant bits, so one bf16 ulp (2^-7 relative) apart is agreement.
TOL = {"float32": dict(atol=2e-5, rtol=1e-5), "bfloat16": dict(atol=2e-2, rtol=2.0**-7)}

FLASH_CASES = {
    # name: (b, sq, sk, h, kvh, d, causal, window, q_offset)
    "gqa_causal": (1, 64, 64, 4, 2, 32, True, 0, 0),
    "window": (2, 64, 64, 4, 1, 32, True, 24, 0),
    "q_offset": (1, 32, 64, 4, 2, 32, True, 0, 32),
    "ragged": (1, 37, 37, 4, 2, 16, True, 0, 0),
    "not_causal": (1, 16, 24, 2, 2, 16, False, 0, 0),
}


def paged_inputs(seed, b, mp, ps, h, kvh, d, fills):
    """Pool + tables with ragged fills (0 = empty slot) and -1 tails;
    never-referenced pages hold large garbage, so a read through a -1 entry
    or past seq_len shows up as a mismatch."""
    rng = np.random.default_rng(seed)
    p = 1 + b * mp
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    pk = (rng.standard_normal((p, ps, kvh, d)) * 50).astype(np.float32)
    pv = (rng.standard_normal((p, ps, kvh, d)) * 50).astype(np.float32)
    table = np.full((b, mp), -1, np.int32)
    nxt = 1
    for i, n in enumerate(fills):
        for j in range(-(-n // ps)):
            table[i, j] = nxt
            nxt += 1
    used = table[table >= 0]
    pk[used] = rng.standard_normal((used.size, ps, kvh, d)) * 0.5
    pv[used] = rng.standard_normal((used.size, ps, kvh, d)) * 0.5
    return q, pk, pv, table, np.asarray(fills, np.int32)


def _require_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_matches_plain_on_gpu(dtype):
    _require_card()
    g = torch.Generator(device="cuda").manual_seed(0)
    for rows in (1, 4, 1000):
        x = torch.randn(rows, 4096, generator=g, device="cuda").to(TORCH[dtype])
        scale = 1 + 0.1 * torch.randn(4096, generator=g, device="cuda")
        got = rmsnorm_kernel(x, scale)
        torch.testing.assert_close(got.float(), rmsnorm_ref(x, scale).float(), **TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(FLASH_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain_on_gpu(case, dtype):
    _require_card()
    b, sq, sk, h, kvh, d, causal, window, q_offset = FLASH_CASES[case]
    g = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn(b, sq, h, d, generator=g, device="cuda").to(TORCH[dtype])
    k = torch.randn(b, sk, kvh, d, generator=g, device="cuda").to(TORCH[dtype])
    v = torch.randn(b, sk, kvh, d, generator=g, device="cuda").to(TORCH[dtype])
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = flash_attention_fwd(q, k, v, **kw)
    torch.testing.assert_close(
        got.float(), flash_attention_ref(q, k, v, **kw).float(), **TOL[dtype]
    )


@pytest.mark.gpu
@pytest.mark.parametrize("ps", [1, 8, 16, 24])
@pytest.mark.parametrize("window", [0, 5])
def test_paged_decode_kernel_matches_plain_on_gpu(ps, window):
    _require_card()
    fills = [1, ps + 2, 3 * ps - 1, 0]
    arrays = paged_inputs(ps, 4, 3, ps, 4, 2, 64, fills)
    q, pk, pv, table, lens = (torch.from_numpy(a).cuda() for a in arrays)
    got = paged_decode_attention_kernel(q, pk, pv, table, lens, window=window)
    ref = paged_decode_attention_ref(q, pk, pv, table, lens, window=window)
    torch.testing.assert_close(got, ref, atol=2e-5, rtol=1e-5)
    assert bool((got[3] == 0).all())


@pytest.mark.gpu
def test_wrappers_count_launches_and_reject_bad_inputs_on_gpu():
    _require_card()
    from repro_torch.kernels import counters

    q = torch.randn(1, 8, 4, 64, device="cuda")
    k = torch.randn(1, 8, 2, 64, device="cuda")
    counters.reset()
    flash_attention_fwd(q, k, k)
    rmsnorm_kernel(q, torch.ones(64, device="cuda"))
    assert counters.snapshot() == {"flash_attention_fwd": 1, "rmsnorm": 1}
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_fwd(q[..., :12].contiguous(), k[..., :12].contiguous(),
                            k[..., :12].contiguous())
    with pytest.raises(TypeError):
        flash_attention_fwd(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_fwd(q.transpose(1, 2), k, k)
    assert counters.snapshot() == {"flash_attention_fwd": 1, "rmsnorm": 1}

