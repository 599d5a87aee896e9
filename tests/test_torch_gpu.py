"""The port's hand-written kernels against their plain PyTorch versions,
on a CUDA card (``gpu`` marker).  Each test decides inside its body whether
a card is present and skips where there is none.  This file imports
neither JAX nor the JAX package, so it also runs on a machine without them;
there, skip the repo's conftest (it imports JAX):

    PYTHONPATH=src python -m pytest -q -p no:cacheprovider --noconftest -m gpu tests/test_torch_gpu.py

The shapes and inputs here are shared with tests/test_torch_kernels.py,
which holds the plain versions against JAX on the CPU (the optimizer
kernels' plain versions: tests/test_torch_optim_kernels.py).  The autograd
cases hold the gradients through the RMSNorm and flash wrappers (kernel
forward, plain-version recompute backward) against autograd through the
plain versions.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_autograd,
    flash_attention_fwd,
)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.flash_attention_decode.kernel import (
    paged_decode_attention_kernel,
)
from repro_torch.kernels.flash_attention_decode.ref import paged_decode_attention_ref
from repro_torch.kernels.flash_attention.kernel import last_design as flash_design
from repro_torch.kernels.galore_project.kernel import galore_project, galore_project_batched
from repro_torch.kernels.galore_project.ref import galore_project_ref, project_ref
from repro_torch.kernels.lowrank_update import ops as update_ops
from repro_torch.kernels.lowrank_update import quantize as qz
from repro_torch.kernels.lowrank_update.kernel import (
    lowrank_adam8bit_update_batched,
    lowrank_adam_mini_update_batched,
    lowrank_adam_update_batched,
    lowrank_msgd_update_batched,
)
from repro_torch.kernels.lowrank_update.ref import (
    lowrank_adam8bit_update_ref,
    lowrank_adam_mini_update_ref,
    lowrank_adam_update_ref,
    lowrank_msgd_update_ref,
)
from repro_torch.kernels.power_iter.kernel import power_iter_batched
from repro_torch.kernels.power_iter.ref import power_iter_ref
from repro_torch.kernels.rmsnorm.kernel import rmsnorm as rmsnorm_kernel
from repro_torch.kernels.rmsnorm.kernel import rmsnorm_autograd
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
    # bf16 takes the tensor-core design for D % 16 == 0 (64, 128 here) and
    # the CUDA-core design for D = 72; f32 always the CUDA-core design
    "b8_d128_ragged": (8, 37, 37, 4, 2, 128, True, 0, 0),
    "d64_window_ragged": (2, 150, 150, 4, 2, 64, True, 40, 0),
    "d128_q_offset_ragged": (1, 70, 200, 4, 1, 128, True, 0, 130),
    "d128_long": (1, 260, 260, 2, 1, 128, True, 0, 0),
    "d72_window_q_offset": (2, 70, 100, 4, 2, 72, True, 24, 30),
}
# the MoE and hybrid families' shapes, on the card only (too large for the
# CPU tests that share FLASH_CASES): deepseek-moe-16b's MHA 16/16 at D 128;
# hymba-1.5b's GQA 25/5 at D 64 with its 1024 window, S 2048
FAMILY_FLASH_CASES = {
    "mha16_d128": (1, 512, 512, 16, 16, 128, True, 0, 0),
    "gqa25_5_d64_window1024": (1, 2048, 2048, 25, 5, 64, True, 1024, 0),
    # whisper-medium: the encoder over 1500 frames without a mask (1500 is
    # no multiple of the 64-row tile), the cross-attention of a 64-token
    # prompt and of one decode tick of 4 slots against the frames (Sq != Sk)
    "whisper_encoder_s1500_d64": (1, 1500, 1500, 16, 16, 64, False, 0, 0),
    "whisper_cross_64x1500": (1, 64, 1500, 16, 16, 64, False, 0, 0),
    "whisper_cross_decode_b4_1x1500": (4, 1, 1500, 16, 16, 64, False, 0, 0),
    # llava-next-34b's longest prefill: 576 patches + 1024 tokens, G = 7
    "llava_gqa56_8_d128_s1600": (1, 1600, 1600, 56, 8, 128, True, 0, 0),
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
        # a block of the row's channels with the whole row's sum of squares
        ss = torch.sum(x.float() ** 2, dim=-1, keepdim=True)
        got = rmsnorm_kernel(x[:, :1024].contiguous(), scale[:1024].contiguous(), ss=ss,
                             width=4096)
        torch.testing.assert_close(got.float(), rmsnorm_ref(x, scale).float()[:, :1024],
                                   **TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(FLASH_CASES) + list(FAMILY_FLASH_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain_on_gpu(case, dtype):
    _require_card()
    b, sq, sk, h, kvh, d, causal, window, q_offset = {**FLASH_CASES, **FAMILY_FLASH_CASES}[case]
    g = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn(b, sq, h, d, generator=g, device="cuda").to(TORCH[dtype])
    k = torch.randn(b, sk, kvh, d, generator=g, device="cuda").to(TORCH[dtype])
    v = torch.randn(b, sk, kvh, d, generator=g, device="cuda").to(TORCH[dtype])
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = flash_attention_fwd(q, k, v, **kw)
    torch.testing.assert_close(
        got.float(), flash_attention_ref(q, k, v, **kw).float(), **TOL[dtype]
    )
    tensor_cores = dtype == "bfloat16" and d % 16 == 0
    assert flash_design() == ("tensor_cores" if tensor_cores else "cuda_cores")


@pytest.mark.gpu
def test_flash_wrapper_reports_its_design_on_gpu():
    """bf16 with D % 16 == 0 runs on the tensor cores; f32, and bf16 with
    another head dim, on the CUDA cores: two hand-written kernels, chosen
    by the C entry point, never the plain version."""
    _require_card()
    from repro_torch.kernels import counters

    counters.reset()
    for dtype, d, want in (("bfloat16", 128, "tensor_cores"), ("bfloat16", 16, "tensor_cores"),
                           ("bfloat16", 256, "tensor_cores"), ("bfloat16", 72, "cuda_cores"),
                           ("float32", 128, "cuda_cores")):
        q = torch.randn(1, 20, 4, d, device="cuda").to(TORCH[dtype])
        k = torch.randn(1, 20, 2, d, device="cuda").to(TORCH[dtype])
        out = flash_attention_fwd(q, k, k)
        assert flash_design() == want, (dtype, d)
        torch.testing.assert_close(out.float(), flash_attention_ref(q, k, k).float(),
                                   **TOL[dtype])
    assert counters.snapshot() == {"flash_attention_fwd": 5}


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


def _ragged(b, top):
    """b deterministic ragged fills in [0, top), slot 0 empty."""
    return [(37 * i * i + 5 * i) % top for i in range(b)]


# name: (b, kvh, g, d, ps, fills, window, holes); holes are (slot, page)
# table entries set to -1 inside seq_len.  Between them the cases take
# every cluster size on each design (the test after them checks it).
PAGED_CLUSTER_CASES = {
    "d128_g4": (4, 2, 4, 128, 16, [0, 77, 517, 1056], 0, ()),
    "b10_d64_g4": (10, 2, 4, 64, 16, _ragged(10, 700), 0, ()),
    "b20_d64_g4": (20, 2, 4, 64, 16, _ragged(20, 700), 0, ()),
    "b40_d64_g1": (40, 2, 1, 64, 16, _ragged(40, 700), 0, ()),
    "b40_d128_g4": (40, 2, 4, 128, 16, _ragged(40, 700), 0, ()),
    "b72_d128_g8": (72, 2, 8, 128, 16, _ragged(72, 300), 0, ()),
    "short_slots": (4, 2, 4, 128, 16, [0, 1, 17, 31], 0, ()),
    "ps1_long": (3, 2, 4, 64, 1, [45, 1100, 0], 0, ()),
    "ps24_d256": (4, 2, 4, 256, 24, [500, 24 * 7 + 5, 0, 1], 0, ()),
    "g16_d128": (2, 2, 16, 128, 16, [0, 611], 0, ()),
    "g32_d256": (2, 1, 32, 256, 16, [333, 0], 0, ()),
    "g32_d128_window": (3, 1, 32, 128, 16, [0, 700, 290], 100, ()),
    "window_inside_share": (4, 2, 4, 128, 16, [0, 77, 517, 1056], 100, ()),
    "window_longer_than_slot": (4, 2, 8, 128, 16, [0, 77, 517, 1056], 5000, ()),
    "holes_inside_seq_len": (4, 2, 4, 128, 16, [0, 77, 517, 1056], 0,
                             ((1, 2), (2, 0), (3, 40), (3, 65))),
    "d72_ps8": (3, 2, 4, 72, 8, [0, 301, 95], 0, ((1, 5),)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(PAGED_CLUSTER_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_cluster_kernel_matches_plain_on_gpu(case, dtype):
    """The one-launch cluster kernel where its split and merge can go wrong,
    on both designs (bf16 with D % 16 == 0 and G <= 16 takes the tensor
    cores): every cluster size, ragged lengths off the tiles and the page,
    ps 1 (more pages than one table staging holds), 24; D 64, 72, 128, 256;
    G 1, 4, 8, 16, 32; windows; -1 entries inside seq_len; empty slots."""
    _require_card()
    from repro_torch.kernels import counters

    b, kvh, g, d, ps, fills, window, holes = PAGED_CLUSTER_CASES[case]
    mp = -(-max(fills) // ps)
    arrays = paged_inputs(7, b, mp, ps, g * kvh, kvh, d, fills)
    q, pk, pv, table, lens = (torch.from_numpy(a).cuda() for a in arrays)
    for slot, page in holes:
        assert page * ps < fills[slot]
        table[slot, page] = -1
    q, pk, pv = (t.to(TORCH[dtype]) for t in (q, pk, pv))
    counters.reset()
    got = paged_decode_attention_kernel(q, pk, pv, table, lens, window=window)
    assert counters.snapshot() == {"paged_decode_attention": 1}
    ref = paged_decode_attention_ref(q, pk, pv, table, lens, window=window)
    torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])
    empty = [i for i, n in enumerate(fills) if n == 0]
    assert bool((got[empty] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_pools_off_16_bytes_on_gpu(dtype):
    """Pools that do not start on 16 bytes (a contiguous view at an odd
    offset) take the CUDA-core design's element-wise copies."""
    _require_card()
    fills = [0, 77, 517, 1056]
    arrays = paged_inputs(3, 4, 66, 16, 8, 2, 128, fills)
    q, pk, pv, table, lens = (torch.from_numpy(a).cuda().to(TORCH[dtype])
                              if a.dtype == np.float32 else torch.from_numpy(a).cuda()
                              for a in arrays)
    pools = []
    for t in (pk, pv):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device="cuda")
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 != 0 and view.is_contiguous()
        pools.append(view)
    got = paged_decode_attention_kernel(q, *pools, table, lens)
    ref = paged_decode_attention_ref(q, pk, pv, table, lens)
    torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])
    assert bool((got[0] == 0).all())


@pytest.mark.gpu
def test_paged_decode_cluster_cases_take_every_cluster_size_on_gpu():
    """On this card's cluster occupancy, the cases above take every cluster
    size on each design."""
    _require_card()
    from repro_torch.kernels.flash_attention_decode import kernel as km

    seen = {}
    for b, kvh, g, d, ps, fills, _, _ in PAGED_CLUSTER_CASES.values():
        mp = -(-max(fills) // ps)
        for dtype in (torch.float32, torch.bfloat16):
            how = km.design(dtype, d, g)
            room = km.card_clusters(dtype, g * kvh, kvh, d, how, torch.cuda.current_device())
            seen.setdefault(how, set()).add(km.cluster_size(b, kvh, mp * ps, room))
    assert seen == {"cuda_cores": {1, 2, 4, 8}, "tensor_cores": {1, 2, 4, 8}}, seen


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



# (B, d, n, r): ragged edges on every tile axis, 128-aligned, and r > 128
OPT_SHAPES = {"ragged": (3, 40, 72, 8), "aligned": (2, 256, 384, 64), "wide_r": (1, 300, 130, 160)}


def _opt_inputs(seed, shape, dtype):
    b, d, n, r = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = (0.1 * torch.randn(b, d, n, generator=g, device="cuda")).to(TORCH[dtype])
    p = torch.randn(b, d, r, generator=g, device="cuda") / d**0.5
    rg = 0.1 * torch.randn(b, r, n, generator=g, device="cuda")
    m = 0.1 * torch.randn(b, r, n, generator=g, device="cuda")
    v = (0.01 * torch.randn(b, r, n, generator=g, device="cuda")) ** 2
    return w, p, rg, m, v


@pytest.mark.gpu
@pytest.mark.parametrize("shape", list(OPT_SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_project_kernel_matches_plain_on_gpu(shape, dtype):
    _require_card()
    g, p, *_ = _opt_inputs(2, OPT_SHAPES[shape], dtype)
    got = galore_project_batched(g, p)
    torch.testing.assert_close(got, project_ref(g, p), **TOL["float32"])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", list(OPT_SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step,lr_wd", [(1, 0.0), (9, 1e-3)])
def test_adam_update_kernel_matches_plain_on_gpu(shape, dtype, step, lr_wd):
    _require_card()
    w, p, rg, m, v = _opt_inputs(3, OPT_SHAPES[shape], dtype)
    got = lowrank_adam_update_batched(w, p, rg, m, v, step, 0.0025, lr_wd)
    want = lowrank_adam_update_ref(w, p, rg, m, v, b1=0.9, b2=0.999, eps=1e-8,
                                   step=step, lr_alpha=0.0025, lr_wd=lr_wd)
    assert got[0].dtype == w.dtype
    torch.testing.assert_close(got[0].float(), want[0].float(), **TOL[dtype])
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, **TOL["float32"])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 40, 72, 12), (2, 256, 640, 40), (1, 300, 130, 130)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_power_iter_kernel_matches_plain_on_gpu(shape, dtype):
    _require_card()
    b, m, n, kp = shape
    gen = torch.Generator(device="cuda").manual_seed(4)
    g = (0.1 * torch.randn(b, m, n, generator=gen, device="cuda")).to(TORCH[dtype])
    q = torch.linalg.qr(torch.randn(b, m, kp, generator=gen, device="cuda"))[0].contiguous()
    got = power_iter_batched(g, q)
    want = power_iter_ref(g, q)
    # f32 sums over m, then n, in other orders: relative to the output's scale
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


# FSDP's local blocks at a ``data`` extent of 2 (B, d, n, r): a "d" bucket's
# rows (llama3-8b's mlp, d 4096 / 2, n cut to fit a test), deepseek's
# expert d_ff block (1408 / 2 = 704, ragged against the 64-row tile), an
# "n" bucket's columns (k/v, n 4096 / 2), and a small ragged row block
FSDP_SHAPES = {"mlp_rows": (2, 2048, 1792, 64), "expert_rows": (4, 704, 2048, 64),
               "kv_cols": (2, 1024, 2048, 64), "ragged_rows": (3, 88, 200, 24)}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", list(FSDP_SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_project_and_adam_kernels_on_fsdp_blocks_on_gpu(shape, dtype):
    """Kernels 4 and 5 on FSDP's local blocks: R = P^T G of a row block
    (the partial sum the step all-reduces over ``data``) and the fused
    update of the block's W from the reduced R."""
    _require_card()
    w, p, rg, m, v = _opt_inputs(5, FSDP_SHAPES[shape], dtype)
    torch.testing.assert_close(galore_project_batched(w, p), project_ref(w, p),
                               rtol=1e-5, atol=1e-5 * float(project_ref(w, p).abs().max()))
    got = lowrank_adam_update_batched(w, p, rg, m, v, 3, 0.0025, 1e-3)
    want = lowrank_adam_update_ref(w, p, rg, m, v, b1=0.9, b2=0.999, eps=1e-8,
                                   step=3, lr_alpha=0.0025, lr_wd=1e-3)
    assert got[0].dtype == w.dtype
    torch.testing.assert_close(got[0].float(), want[0].float(), **TOL[dtype])
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, **TOL["float32"])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 1024, 2048, 72), (3, 176, 100, 40)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_power_iter_kernel_on_fsdp_blocks_on_gpu(shape, dtype):
    """Kernel 9 on an FSDP block: the sketch route's G (G^T Q) on this
    process's columns of an "n" bucket (k/v at (2, 1)), and a ragged one."""
    _require_card()
    b, m, n, kp = shape
    gen = torch.Generator(device="cuda").manual_seed(6)
    g = (0.1 * torch.randn(b, m, n, generator=gen, device="cuda")).to(TORCH[dtype])
    q = torch.linalg.qr(torch.randn(b, m, kp, generator=gen, device="cuda"))[0].contiguous()
    want = power_iter_ref(g, q)
    torch.testing.assert_close(power_iter_batched(g, q), want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


# Kernel 9 at the mlp bucket's width and at its edges, (B, m, n, k'): one
# main-width slice; k' 8 and 2056 (8 columns past 16 tiles of 128) with n
# 130 and m 1100, whose f32 rows of G do not start on 16 bytes; k' 130
# (Q's and Y's rows off 16 bytes, a ragged 8-column tail)
POWER_ITER_EDGES = {"main_width": (1, 4096, 14336, 2056), "kp8_n130_m1100": (2, 1100, 130, 8),
                    "kp2056_n130_m1100": (1, 1100, 130, 2056),
                    "kp130_m1100": (2, 1100, 520, 130)}


def _power_inputs(seed, shape, dtype, offset=0):
    """G (0.1 unit-normal, ``offset`` elements into its buffer: 0, or 1 to
    start it off 16 bytes) and Q with unit-norm columns (orthonormal where
    k' <= m)."""
    b, m, n, kp = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    buf = (0.1 * torch.randn(b * m * n + offset, generator=gen, device="cuda")).to(TORCH[dtype])
    g = buf[offset:].view(b, m, n)
    q = torch.randn(b, m, kp, generator=gen, device="cuda")
    q = torch.linalg.qr(q)[0].contiguous() if kp <= m else q / m**0.5
    return g, q


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(POWER_ITER_EDGES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_power_iter_kernel_at_main_width_and_edges_on_gpu(case, dtype):
    _require_card()
    g, q = _power_inputs(15, POWER_ITER_EDGES[case], dtype)
    want = power_iter_ref(g, q)
    torch.testing.assert_close(power_iter_batched(g, q), want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_power_iter_kernel_with_g_off_16_bytes_on_gpu(dtype):
    """G starting one element into its buffer: every row of G is read
    element by element in both products."""
    _require_card()
    g, q = _power_inputs(16, (2, 300, 260, 72), dtype, offset=1)
    assert g.data_ptr() % 16 != 0 and g.is_contiguous()
    want = power_iter_ref(g, q)
    torch.testing.assert_close(power_iter_batched(g, q), want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_power_iter_kernel_across_a_wide_range_on_gpu(dtype):
    """G's rows and Q's columns scaled by 2^-20 ... 2^20: the products keep
    each value's relative precision whatever its exponent."""
    _require_card()
    b, m, n, kp = 2, 1024, 2048, 264
    gen = torch.Generator(device="cuda").manual_seed(17)
    rows = torch.exp2(torch.randint(-20, 21, (b, m, 1), generator=gen, device="cuda").float())
    cols = torch.exp2(torch.randint(-20, 21, (b, 1, kp), generator=gen, device="cuda").float())
    g = (0.1 * torch.randn(b, m, n, generator=gen, device="cuda") * rows).to(TORCH[dtype])
    q = torch.linalg.qr(torch.randn(b, m, kp, generator=gen, device="cuda"))[0]
    q = (q * cols).contiguous()
    want = power_iter_ref(g, q)
    torch.testing.assert_close(power_iter_batched(g, q), want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.gpu
def test_optimizer_wrappers_count_launches_and_reject_bad_inputs_on_gpu():
    _require_card()
    from repro_torch.kernels import counters

    w, p, rg, m, v = _opt_inputs(5, OPT_SHAPES["ragged"], "float32")
    counters.reset()
    galore_project_batched(w, p)
    power_iter_batched(w, p)
    lowrank_adam_update_batched(w, p, rg, m, v, 1, 0.1)
    want = {"galore_project_batched": 1, "power_iter_batched": 1,
            "lowrank_adam_update_batched": 1}
    assert counters.snapshot() == want
    with pytest.raises(TypeError):
        galore_project_batched(w, p.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        power_iter_batched(w.transpose(1, 2).contiguous().transpose(1, 2), p)
    with pytest.raises(ValueError, match="mismatched"):
        lowrank_adam_update_batched(w, p, rg[:, :4], m, v, 1, 0.1)
    assert counters.snapshot() == want


# (d, n, r): d and n off the 128 grid, r = 100; and an aligned one
PROJECT_2D_SHAPES = {"ragged": (300, 130, 100), "wide": (200, 520, 100),
                     "aligned": (256, 384, 64)}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", list(PROJECT_2D_SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mdtype", ["float32", "bfloat16"])
def test_project_2d_kernel_matches_plain_on_gpu(shape, dtype, mdtype):
    """Kernel 10, the 2-D projection fused with Adam's moments: R to the
    projection's tolerance, and M', V' equal to the plain moments of the
    kernel's own R (each operation rounded on its own)."""
    _require_card()
    d, n, r = PROJECT_2D_SHAPES[shape]
    gen = torch.Generator(device="cuda").manual_seed(8)
    g = (0.1 * torch.randn(d, n, generator=gen, device="cuda")).to(TORCH[dtype])
    p = torch.linalg.qr(torch.randn(d, r, generator=gen, device="cuda"))[0].contiguous()
    m = (0.01 * torch.randn(r, n, generator=gen, device="cuda")).to(TORCH[mdtype])
    v = (1e-4 * torch.randn(r, n, generator=gen, device="cuda").abs()).to(TORCH[mdtype])
    got = galore_project(g, p, m, v, b1=0.9, b2=0.999)
    want = galore_project_ref(g, p, m, v, b1=0.9, b2=0.999)
    assert all(t.dtype == torch.float32 and t.shape == (r, n) for t in got)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **TOL["float32"])
    m_same = 0.9 * m.float() + (1.0 - 0.9) * got[0]
    v_same = 0.999 * v.float() + (1.0 - 0.999) * got[0] * got[0]
    assert torch.equal(got[1], m_same) and torch.equal(got[2], v_same)


@pytest.mark.gpu
def test_project_2d_wrapper_counts_launches_and_rejects_bad_inputs_on_gpu():
    _require_card()
    from repro_torch.kernels import counters

    g = torch.randn(40, 72, device="cuda")
    p = torch.randn(40, 8, device="cuda")
    m = torch.zeros(8, 72, device="cuda")
    counters.reset()
    galore_project(g, p, m, m)
    assert counters.snapshot() == {"galore_project": 1}
    with pytest.raises(TypeError):
        galore_project(g, p, m, m.bfloat16())
    with pytest.raises(ValueError, match="want"):
        galore_project(g, p, m[:4], m[:4])
    with pytest.raises(ValueError, match="contiguous"):
        galore_project(g.t().contiguous().t(), p, m, m)
    assert counters.snapshot() == {"galore_project": 1}


# ---------------------------------------------------------------------------
# on the card: the MSGD, Adam-mini and 8-bit Adam updates (kernels 6-8)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("shape", list(OPT_SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_msgd_update_kernel_matches_plain_on_gpu(shape, dtype):
    _require_card()
    w, p, rg, m, _ = _opt_inputs(6, OPT_SHAPES[shape], dtype)
    got = lowrank_msgd_update_batched(w, p, rg, m, 0.0025, 1e-3)
    want = lowrank_msgd_update_ref(w, p, rg, m, b1=0.9, lr_alpha=0.0025, lr_wd=1e-3)
    assert got[0].dtype == w.dtype
    torch.testing.assert_close(got[0].float(), want[0].float(), **TOL[dtype])
    torch.testing.assert_close(got[1], want[1], **TOL["float32"])


# side, (B, d, n, r): d and n off the 128 grid; a short final chunk along n
# (left, n % 256 != 0) and along r (right, r = 300), and r = 100 (right):
# shapes JAX's adam8bit_kernel_supported sends to its jnp version
LOWRANK_SIDE_SHAPES = {
    "left_ragged": ("left", (2, 200, 300, 24)),
    "left_aligned": ("left", (2, 256, 512, 64)),
    "right_r100": ("right", (2, 136, 200, 100)),
    "right_r300": ("right", (1, 320, 72, 300)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(LOWRANK_SIDE_SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step", [1, 5])
def test_adam_mini_update_kernel_matches_plain_on_gpu(case, dtype, step):
    _require_card()
    side, shape = LOWRANK_SIDE_SHAPES[case]
    w, p, rg, m, v = _opt_inputs(7, shape, dtype)
    vrow = (v[:, :, 0] if side == "left" else v[:, 0, :]).contiguous()
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, side=side)
    got = lowrank_adam_mini_update_batched(w, p, rg, m, vrow, step, 0.0025, 1e-3, **kw)
    want = lowrank_adam_mini_update_ref(w, p, rg, m, vrow, step, 0.0025, 1e-3, **kw)
    torch.testing.assert_close(got[0].float(), want[0].float(), **TOL[dtype])
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, **TOL["float32"])


def _assert_codes_close(got, want):
    """8-bit codes at most one step apart, on at most 1e-3 of them."""
    diff = (got.int() - want.int()).abs()
    assert int(diff.max()) <= 1
    assert float((diff > 0).float().mean()) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(LOWRANK_SIDE_SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("state", ["moments", "fresh", "reset"])
def test_adam8bit_update_kernel_matches_plain_on_gpu(case, dtype, state):
    """``moments``: quantized random moments, with one all-zero chunk whose
    gradient is zero too (its new scale must be 1.0); ``fresh``: the
    quantized zeros of init (scales 1.0); ``reset``: the refresh's reset
    carry (codes and scales 0)."""
    _require_card()
    side, shape = LOWRANK_SIDE_SHAPES[case]
    b, d, n, r = shape
    w, p, rg, m, v = _opt_inputs(8, shape, dtype)
    if state == "moments":
        if side == "left":
            m[0, 0, :256] = v[0, 0, :256] = rg[0, 0, :256] = 0.0
        else:
            m[0, :256, 0] = v[0, :256, 0] = rg[0, :256, 0] = 0.0
    else:
        m, v = torch.zeros_like(m), torch.zeros_like(v)
    mc, ms = qz.quantize_stacked(m, side, signed=True)
    vc, vs = qz.quantize_stacked(v, side, signed=False)
    if state == "reset":
        mc, ms, vc, vs = (torch.zeros_like(x) for x in (mc, ms, vc, vs))
    step = 1 if state != "moments" else 5
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, side=side)
    got = lowrank_adam8bit_update_batched(w, p, rg, mc, ms, vc, vs, step, 0.0025, 1e-3, **kw)
    want = lowrank_adam8bit_update_ref(w, p, rg, mc, ms, vc, vs, step, 0.0025, 1e-3, **kw)
    assert got[0].dtype == w.dtype and got[1].dtype == got[3].dtype == torch.uint8
    torch.testing.assert_close(got[0].float(), want[0].float(), **TOL[dtype])
    for i in (1, 3):
        _assert_codes_close(got[i], want[i])
    for i in (2, 4):
        torch.testing.assert_close(got[i], want[i], rtol=1e-5, atol=0)
    if state == "moments":
        assert float(got[2][0, 0, 0]) == float(got[4][0, 0, 0]) == 1.0


# 8-bit Adam on a block of rows cut over processes: local widths whose
# blocks end inside a 256-element chunk -- 192 and 320 (the CPU tests'),
# 4480 (qwen2-1.5b's mlp at a model extent of 2) -- two blocks a row
CUT_WIDTHS = {"n192": (2, 128, 192, 64), "n4480": (2, 1536, 4480, 384),
              "n320": (2, 128, 320, 64)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CUT_WIDTHS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", [0, 1])
def test_adam8bit_kernel_on_cut_rows_on_gpu(case, dtype, block):
    """Kernel 8 with a chunk offset and given scales: its absmax launch's
    pieces never above their whole chunk's (the whole row's own absmax
    launch's) and equal on the chunks the block holds whole, then its
    outputs against the plain version's with the same offset and the plain
    whole row's scales, and against the kernel's whole row cut to the
    block (one process's): codes within one step, the scales and W' to the
    tolerances."""
    _require_card()
    b, d, n, r = CUT_WIDTHS[case]
    total = 2 * n
    w, p, rg, m, v = _opt_inputs(21, (b, d, total, r), dtype)
    mc, ms = qz.quantize_stacked(m, "left", signed=True)
    vc, vs = qz.quantize_stacked(v, "left", signed=False)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, side="left")
    lo, hi = block * n, (block + 1) * n
    c0, c1 = lo // qz.QBLOCK, qz.num_blocks(hi)
    held = [c - c0 for c in range(c0, c1)
            if c * qz.QBLOCK >= lo and min((c + 1) * qz.QBLOCK, total) <= hi]

    def whole_row(fn):
        """The whole row's update and the absmax pieces it asked about (at
        offset 0 every chunk is whole, so they are the chunks' absmax)."""
        seen = []
        out = fn(w, p, rg, mc, ms, vc, vs, 3, 0.0025, 1e-3, reduce=lambda am: (
            seen.append(am.clone()), am)[1], **kw)
        return out, [x[..., c0:c1] for x in seen]

    def given(wants):
        calls = []

        def reduce(am):
            want = wants[len(calls) % 2]
            calls.append(am)
            assert not bool((am > want).any())
            assert torch.equal(am[..., held], want[..., held])
            return want.clone()
        return reduce

    cut = lambda x, a, z: x[..., a:z].contiguous()  # noqa: E731
    args = (cut(w, lo, hi), p, cut(rg, lo, hi), cut(mc, lo, hi), cut(ms, c0, c1),
            cut(vc, lo, hi), cut(vs, c0, c1), 3, 0.0025, 1e-3)
    whole, k_abs = whole_row(lowrank_adam8bit_update_batched)
    _, p_abs = whole_row(lowrank_adam8bit_update_ref)
    got = lowrank_adam8bit_update_batched(*args, qoff=lo % qz.QBLOCK, reduce=given(k_abs), **kw)
    want = lowrank_adam8bit_update_ref(*args, qoff=lo % qz.QBLOCK, reduce=given(p_abs), **kw)
    one = (cut(whole[0], lo, hi), cut(whole[1], lo, hi), cut(whole[2], c0, c1),
           cut(whole[3], lo, hi), cut(whole[4], c0, c1))
    for ref in (want, one):
        torch.testing.assert_close(got[0].float(), ref[0].float(), **TOL[dtype])
        for i in (1, 3):
            _assert_codes_close(got[i], ref[i])
        for i in (2, 4):
            torch.testing.assert_close(got[i], ref[i], rtol=1e-5, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("inner", ["adam", "msgd", "adam_mini", "adam8bit"])
def test_update_kernels_split_schedule_on_gpu(inner):
    """The split schedule of ZeRO state on the FSDP step -- each kernel's
    moments launch on a block of rows of the state, ``gather`` of every
    block's N, then its back-projection launch on every row -- against the
    kernel's one call: two blocks of rows, bit-equal W' and moments, one
    launch counted per call."""
    _require_card()
    from repro_torch.kernels import counters

    b, d, n, r = (4, 136, 200, 24)
    w, p, rg, m, v = _opt_inputs(22, (b, d, n, r), "float32")
    if inner == "adam8bit":
        state = (*qz.quantize_stacked(m, "left", signed=True),
                 *qz.quantize_stacked(v, "left", signed=False))
    elif inner == "adam_mini":
        state = (m, v[:, :, 0].contiguous())
    else:
        state = (m, v) if inner == "adam" else (m,)
    fn = {"adam": lambda *a, **k: lowrank_adam_update_batched(*a, 3, 0.0025, 1e-3, **k),
          "msgd": lambda *a, **k: lowrank_msgd_update_batched(*a, 0.0025, 1e-3, **k),
          "adam_mini": lambda *a, **k: lowrank_adam_mini_update_batched(*a, 3, 0.0025, 1e-3,
                                                                        **k),
          "adam8bit": lambda *a, **k: lowrank_adam8bit_update_batched(*a, 3, 0.0025, 1e-3,
                                                                      **k)}[inner]
    full = fn(w, p, rg, *state)
    blocks = [slice(0, 2), slice(2, 4)]
    ns = []
    for rows in blocks:  # each block's N (its back-projection onto zeros dropped)
        fn(w, p, rg[rows].contiguous(), *(x[rows].contiguous() for x in state),
           gather=lambda x: (ns.append(x.clone()), torch.zeros((b,) + x.shape[1:],
                                                               device=x.device))[1])
    counters.reset()
    split = fn(w, p, rg[blocks[1]].contiguous(), *(x[blocks[1]].contiguous() for x in state),
               gather=lambda x: torch.cat([ns[0], x]))
    assert counters.snapshot() == {
        {"adam": "lowrank_adam_update_batched", "msgd": "lowrank_msgd_update_batched",
         "adam_mini": "lowrank_adam_mini_update_batched",
         "adam8bit": "lowrank_adam8bit_update_batched"}[inner]: 1}
    assert torch.equal(split[0], full[0])
    for got, want in zip(split[1:], full[1:]):
        assert torch.equal(got, want[blocks[1]])


@pytest.mark.gpu
def test_inner_dispatch_launches_the_kernels_on_gpu():
    """The bucketed engine's dispatch sends CUDA tensors to the kernels (one
    launch each) and the wrappers refuse what the kernels do not take."""
    _require_card()
    from repro_torch.kernels import counters

    w, p, rg, m, v = _opt_inputs(9, OPT_SHAPES["ragged"], "float32")
    b, d, n, r = OPT_SHAPES["ragged"]
    mc, ms = qz.quantize_stacked(m, "left", signed=True)
    vc, vs = qz.quantize_stacked(v, "left", signed=False)
    counters.reset()
    update_ops.bucketed_msgd_update(w, p, rg, m, 0.1)
    assert counters.snapshot() == {"lowrank_msgd_update_batched": 1}
    update_ops.bucketed_adam_mini_update(w, p, rg, m, v[:, :, 0].contiguous(), 1, 0.1)
    update_ops.bucketed_adam8bit_update(w, p, rg, mc, ms, vc, vs, 1, 0.1)
    want = {"lowrank_msgd_update_batched": 1, "lowrank_adam_mini_update_batched": 1,
            "lowrank_adam8bit_update_batched": 1}
    assert counters.snapshot() == want
    with pytest.raises(ValueError, match="scales"):
        lowrank_adam8bit_update_batched(w, p, rg, mc, ms, vc, vs, 1, 0.1, side="right")
    with pytest.raises(ValueError, match="adam_mini v"):
        lowrank_adam_mini_update_batched(w, p, rg, m, v[:, 0, :].contiguous(), 1, 0.1)
    with pytest.raises(ValueError, match="mismatched"):
        lowrank_msgd_update_batched(w, p, rg[:, :4], m, 0.1)
    assert counters.snapshot() == want


# ---------------------------------------------------------------------------
# on the card: gradients through the kernel wrappers
# ---------------------------------------------------------------------------


def _grads(fn, inputs, weight):
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    (out.float() * weight).sum().backward()
    return out.detach(), [t.grad for t in leaves]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_autograd_matches_plain_on_gpu(dtype):
    _require_card()
    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(3, 37, 512, generator=g, device="cuda").to(TORCH[dtype])
    scale = 1 + 0.1 * torch.randn(512, generator=g, device="cuda")
    weight = torch.randn(3, 37, 512, generator=g, device="cuda")
    out_k, grads_k = _grads(lambda a, s: rmsnorm_autograd(a, s, 1e-5), (x, scale), weight)
    out_p, grads_p = _grads(lambda a, s: rmsnorm_ref(a, s, 1e-5), (x, scale), weight)
    torch.testing.assert_close(out_k.float(), out_p.float(), **TOL[dtype])
    for a, b in zip(grads_k, grads_p):  # both recompute through the plain version
        torch.testing.assert_close(a.float(), b.float(), rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["gqa_causal", "window", "ragged", "not_causal"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_autograd_matches_plain_on_gpu(case, dtype):
    """``not_causal`` is a cross-attention (Sq 16 against Sk 24): the
    plain-recompute backward takes Sq != Sk."""
    _require_card()
    b, sq, sk, h, kvh, d, causal, window, q_offset = FLASH_CASES[case]
    g = torch.Generator(device="cuda").manual_seed(7)
    q = torch.randn(b, sq, h, d, generator=g, device="cuda").to(TORCH[dtype])
    k = torch.randn(b, sk, kvh, d, generator=g, device="cuda").to(TORCH[dtype])
    v = torch.randn(b, sk, kvh, d, generator=g, device="cuda").to(TORCH[dtype])
    weight = torch.randn(b, sq, h, d, generator=g, device="cuda")
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out_k, grads_k = _grads(lambda *a: flash_attention_autograd(*a, **kw), (q, k, v), weight)
    out_p, grads_p = _grads(lambda *a: flash_attention_ref(*a, **kw), (q, k, v), weight)
    torch.testing.assert_close(out_k.float(), out_p.float(), **TOL[dtype])
    for a, b_ in zip(grads_k, grads_p):  # the same plain recompute on both sides
        torch.testing.assert_close(a.float(), b_.float(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# on the card: a checkpoint round trip of a training state
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("inner", ["adam", "msgd", "adam-mini", "adam8bit"])
def test_checkpoint_round_trip_on_gpu(inner, tmp_path):
    """A bucket-native state after a refresh update on the card (its
    kernels), saved blocking and async and loaded back: every leaf equal,
    on the card, in its dtype; canonical <-> storage loses nothing."""
    _require_card()
    from repro_torch.configs.registry import get_config
    from repro_torch.core import make_optimizer
    from repro_torch.core.lowrank import (
        canonical_opt_state,
        storage_opt_state,
        tree_leaves,
        tree_unflatten,
    )
    from repro_torch.models import build_model
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.state import TrainState, checkpoint_converters

    model = build_model(get_config("llama3-8b", smoke=True), device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    opt = make_optimizer(f"galore-sara-{inner}", params, rank=8, engine="bucketed",
                         svd_backend="randomized")
    g = torch.Generator(device="cuda").manual_seed(1)
    grads = tree_unflatten(params, [0.01 * torch.randn(p.shape, generator=g, device="cuda")
                                    for p in tree_leaves(params)])
    params, opt_state, _ = opt.update(grads, opt.init(params), params, refresh=True, apply=True)
    state = TrainState(params, opt_state)
    assert state.opt_state.buckets  # bucket-native: the converters do work

    def assert_equal(a, b):
        ia, ib = ckpt.tree_items(a), ckpt.tree_items(b)
        assert [p for p, _ in ia] == [p for p, _ in ib]
        for (path, x), (_, y) in zip(ia, ib):
            if isinstance(x, torch.Tensor):
                assert x.device.type == "cuda" and x.dtype == y.dtype, path
                assert torch.equal(x, y), path
            else:
                assert np.array_equal(x, y), path

    back = storage_opt_state(opt, canonical_opt_state(opt, state.opt_state))
    assert_equal(TrainState(params, back), state)
    can, loc = checkpoint_converters(opt)
    for blocking in (True, False):
        mgr = ckpt.CheckpointManager(str(tmp_path / f"b{blocking}"), canonicalize=can,
                                     localize=loc)
        mgr.save(state, 1, blocking=blocking)
        mgr.wait()
        skeleton = TrainState(params, opt.init(params))
        loaded, step = mgr.load_latest(skeleton)
        assert step == 1 and mgr.last_save["bytes"] == mgr.last_load["bytes"]
        assert_equal(loaded, state)


# ---------------------------------------------------------------------------
# on the card: the paper's baselines against the CPU's plain path
# ---------------------------------------------------------------------------

BASELINE_KERNELS = {
    # the bucketed hot step: projection and fused Adam update per bucket;
    # online_pca's refresh is one power-iteration product per bucket
    "golore-adam": {"galore_project_batched", "lowrank_adam_update_batched"},
    "grass-adam": {"galore_project_batched", "lowrank_adam_update_batched"},
    "online-pca-adam": {"galore_project_batched", "lowrank_adam_update_batched",
                        "power_iter_batched"},
    # the per-leaf loop: plain products; the randomized SVD's power
    # iterations go through the kernel where k' < d
    "fira-sara-adam": {"power_iter_batched"},
    "galore-sara-adafactor": {"power_iter_batched"},
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(BASELINE_KERNELS))
def test_baseline_optimizer_on_gpu_matches_cpu(name):
    """Three updates (a refresh, two hot steps) of the smoke llama3-8b's
    params at rank 8, fed the same gradients, with the same draws (made on
    the CPU, moved over).  The refresh on the card gives finite params and
    orthonormal projectors.  The SVD-free projectors equal the CPU's:
    grass's selections exactly, golore's and online_pca's QR factors
    sign-aligned to 1e-5.  The sara-based refreshes' W' is not held to the
    CPU's, because sara's sampled small singular vectors differ between
    cuSOLVER and LAPACK and Adam's first step r / (|r| + eps) magnifies
    that (1e-6 of noise in the power iteration moves ``galore-sara-adam``'s
    W' by 4.6e-4 on the CPU).  The hot steps then run on the card (the
    kernels) and the CPU (the plain path) from the CPU's refreshed state,
    to 1e-5, and the path's kernels are launched."""
    _require_card()
    from repro_torch import bridge
    from repro_torch.configs.registry import get_config
    from repro_torch.core import make_optimizer
    from repro_torch.core.lowrank import TorchDraws, tree_leaves, tree_unflatten
    from repro_torch.kernels import counters
    from repro_torch.models import build_model

    class CpuDraws(TorchDraws):
        def split(self):
            return CpuDraws(self.seed, self.device, self.refreshes + 1)

        def leaf(self, leaf_idx, batch_shape, shapes, device=None):
            got = super().leaf(leaf_idx, batch_shape, shapes, "cpu")
            return type(got)(*(None if x is None else x.to(device) for x in got))

    def on(tree, dev):
        return tree_unflatten(tree, [x.to(dev) for x in tree_leaves(tree)])

    cfg = get_config("llama3-8b", smoke=True)
    params0 = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    grads = [tree_unflatten(params0, [0.01 * torch.randn(p.shape, generator=gen)
                                      for p in tree_leaves(params0)]) for _ in range(3)]
    kw = dict(rank=8, engine="bucketed", svd_backend="randomized", grad_clip_norm=1.0)
    opts = {dev: make_optimizer(name, on(params0, dev), **kw) for dev in ("cpu", "cuda")}
    refreshed = {}
    counters.reset()
    for dev, opt in opts.items():
        state = opt.init(on(params0, dev))._replace(draws=CpuDraws(0, dev))
        refreshed[dev] = opt.update(on(grads[0], dev), state, on(params0, dev),
                                    refresh=True, apply=True)[:2]
    torch.cuda.synchronize()
    params, state = refreshed["cuda"]
    assert all(torch.isfinite(x).all() for x in tree_leaves(params))
    method = opts["cuda"].config.method
    for proj, want in zip(_projectors(opts["cuda"], state),
                          _projectors(opts["cpu"], refreshed["cpu"][1])):
        eye = torch.eye(proj.shape[-1], device="cuda").expand(proj.shape[:-2] + (-1, -1))
        torch.testing.assert_close(proj.transpose(-1, -2) @ proj, eye, atol=1e-4, rtol=0)
        got = proj.cpu()
        if method == "grass":
            assert torch.equal(got, want)
        elif method in ("golore", "online_pca"):  # a QR: align its column signs
            signs = torch.sign(torch.sum(got * want, dim=-2, keepdim=True))
            torch.testing.assert_close(got * signs, want, atol=1e-5, rtol=0)
    out = {}
    for dev, opt in opts.items():
        params, state = refreshed["cpu"]
        params = on(params, dev)
        state = bridge.opt_state_from_numpy(opt, bridge.opt_state_to_numpy(state), dev)
        for g in grads[1:]:
            params, state, _ = opt.update(on(g, dev), state, params, refresh=False, apply=True)
        out[dev] = params
    torch.cuda.synchronize()
    launches = counters.snapshot()
    assert {k for k, v in launches.items() if v > 0} == BASELINE_KERNELS[name]
    for a, b in zip(tree_leaves(out["cuda"]), tree_leaves(out["cpu"])):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a.cpu(), b, atol=1e-5, rtol=0)


def _projectors(opt, state):
    """Every low-rank leaf's projector stack: from the buckets, or per leaf."""
    if state.buckets:
        return [b.projector for b in state.buckets]
    return [st.projector for spec, st in zip(opt.specs, state.leaves) if spec.lowrank]


@pytest.mark.gpu
@pytest.mark.parametrize("scale", [1e-10, 0.0])
def test_adafactor_keeps_the_subnormals_on_gpu(scale):
    """On the card Adafactor's 1e-38 guards and the subnormal product
    vr * vc are not flushed either: a tiny gradient's direction is finite,
    and equal to the CPU's to 1e-6."""
    _require_card()
    from repro_torch.core.inner import adafactor

    opt = adafactor()
    g = torch.randn((3, 5), generator=torch.Generator().manual_seed(0)) * scale
    d_cpu, _ = opt.update(g, opt.init(g), 1)
    d_gpu, _ = opt.update(g.cuda(), opt.init(g.cuda()), 1)
    assert torch.isfinite(d_gpu).all()
    torch.testing.assert_close(d_gpu.cpu(), d_cpu, atol=1e-6, rtol=0)


@pytest.mark.gpu
def test_quantizer_square_root_is_correctly_rounded_on_gpu():
    """The 8-bit quantizer takes CUDA's f32 square root as it is (on the
    CPU it rounds an f64 one): it must be IEEE-rounded, on every half-code
    boundary +-8 ulps and on 2^24 values of the unit interval, so that the
    card's codes equal the CPU's bit for bit."""
    _require_card()
    gen = torch.Generator().manual_seed(0)
    k = torch.arange(255, dtype=torch.float64)
    b = (((k + 0.5) / 255.0) ** 2).float()
    near = torch.stack([(b.view(torch.int32) + d).view(torch.float32) for d in range(-8, 9)])
    x = torch.cat([near.reshape(-1).clamp(0, 1), torch.rand(2**24, generator=gen)])
    exact = x.double().sqrt().float()
    assert torch.equal(torch.sqrt(x.cuda()).cpu(), exact)
    rows = torch.cat([torch.ones(1), x[: 255 * 17]]).reshape(1, -1)[:, :4096].reshape(16, 256)
    for signed in (True, False):
        c_cpu, s_cpu = qz.quantize_blockwise(rows, signed)
        c_gpu, s_gpu = qz.quantize_blockwise(rows.cuda(), signed)
        assert torch.equal(c_gpu.cpu(), c_cpu) and torch.equal(s_gpu.cpu(), s_cpu)


# ---------------------------------------------------------------------------
# on the card: the skip-step gate, rank migration, kernels at a ragged rank
# ---------------------------------------------------------------------------


def _smoke_opt_state(name, rank=8, steps=0, **kw):
    """The smoke llama3-8b's params, a bucketed optimizer and its state on
    the CPU after ``steps`` updates (refresh on even steps), and one more
    gradient."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import make_optimizer
    from repro_torch.core.lowrank import tree_leaves, tree_unflatten
    from repro_torch.models import build_model

    params = build_model(get_config("llama3-8b", smoke=True), device="cpu").init(
        torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    grads = [tree_unflatten(params, [0.01 * torch.randn(p.shape, generator=gen)
                                     for p in tree_leaves(params)]) for _ in range(steps + 1)]
    opt = make_optimizer(name, params, rank=rank, engine="bucketed", svd_backend="randomized",
                         grad_clip_norm=1.0, **kw)
    state = opt.init(params)
    for s in range(steps):
        params, state, _ = opt.update(grads[s], state, params, refresh=s % 2 == 0, apply=True)
    return opt, params, state, grads[-1]


@pytest.mark.gpu
def test_skip_gate_on_gpu():
    """The gate on the card: a good hot step gated equals the ungated one
    bit for bit (params and every state leaf), and so does one whose
    gradient holds a finite 1e20 (the global norm overflows, the check says
    finite); a NaN, +Inf or -Inf in one gradient leaf hands back the very
    inputs with ``skipped`` 1 (the check's min/max reduction must carry each
    of them on the card)."""
    _require_card()
    from repro_torch import bridge
    from repro_torch.core.lowrank import tree_leaves, tree_unflatten
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.state import TrainState

    opt, params, state, g = _smoke_opt_state("galore-sara-adam", steps=2)
    params = tree_unflatten(params, [x.cuda() for x in tree_leaves(params)])
    state = bridge.opt_state_from_numpy(opt, bridge.opt_state_to_numpy(state), "cuda")
    g = tree_unflatten(g, [x.cuda() for x in tree_leaves(g)])
    gated = opt.update(g, state, params, refresh=False, apply=True, skip_nonfinite=True)
    plain = opt.update(g, state, params, refresh=False, apply=True)
    assert float(gated[2].skipped) == 0.0
    for (path, a), (_, b) in zip(ckpt.tree_items(TrainState(*gated[:2])),
                                 ckpt.tree_items(TrainState(*plain[:2]))):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else np.array_equal(np.asarray(a), np.asarray(b))), path
    leaves = tree_leaves(g)
    # finite, but its square overflows the global norm: applied, as ungated
    big = [x.clone() for x in leaves]
    big[3].view(-1)[0] = 1e20
    big = tree_unflatten(g, big)
    gated = opt.update(big, state, params, refresh=False, apply=True, skip_nonfinite=True)
    plain = opt.update(big, state, params, refresh=False, apply=True)
    assert float(gated[2].skipped) == 0.0
    for (path, a), (_, b) in zip(ckpt.tree_items(TrainState(*gated[:2])),
                                 ckpt.tree_items(TrainState(*plain[:2]))):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else np.array_equal(np.asarray(a), np.asarray(b))), path
    del gated, plain, big
    for i, value in ((3, float("nan")), (len(leaves) - 1, float("inf")), (0, float("-inf"))):
        bad = [x.clone() for x in leaves]
        bad[i].view(-1)[bad[i].numel() // 2] = value
        out, st, aux = opt.update(tree_unflatten(g, bad), state, params, refresh=False,
                                  apply=True, skip_nonfinite=True)
        assert out is params and st is state and float(aux.skipped) == 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("inner", ["adam", "adam8bit"])
def test_rank_migration_on_gpu_matches_cpu(inner):
    """``migrate_opt_state`` on the card equals the CPU's bit for bit, 8-bit
    codes and scales included, shrinking and growing."""
    _require_card()
    from repro_torch import bridge
    from repro_torch.core import lowrank as lowrank_lib
    from repro_torch.core import rank_schedule as rs_lib
    from repro_torch.train import checkpoint as ckpt

    name = {"adam": "galore-sara-adam", "adam8bit": "galore-sara-adam8bit"}[inner]
    opt, params, state, _ = _smoke_opt_state(name, steps=3)
    states = {"cpu": state,
              "cuda": bridge.opt_state_from_numpy(opt, bridge.opt_state_to_numpy(state), "cuda")}
    for r_from, r_to in ((8, 4), (4, 8)):
        src = opt if r_from == 8 else lowrank_lib.rebuild_at_rank(opt, params, rank=r_from)
        dst = lowrank_lib.rebuild_at_rank(opt, params, rank=r_to)
        out = {dev: rs_lib.migrate_opt_state(src, dst, st) for dev, st in states.items()}
        a = ckpt.tree_items(lowrank_lib.canonical_opt_state(dst, out["cuda"]))
        b = ckpt.tree_items(lowrank_lib.canonical_opt_state(dst, out["cpu"]))
        for (path, x), (_, y) in zip(a, b):
            if isinstance(x, torch.Tensor):
                assert x.is_cuda and x.dtype == y.dtype and torch.equal(x.cpu(), y), path
        states = out


RAGGED_RANK = (2, 640, 1536, 264)  # (B, d, n, r): r = 8 mod 16, a ragged last K tile


@pytest.mark.gpu
def test_optimizer_kernels_at_a_ragged_rank_on_gpu():
    """Kernels 4, 5 and 9 at rank 264 (k' = 4 r + 8 = 1064 for the power
    iteration) against their plain versions."""
    _require_card()
    b, d, n, r = RAGGED_RANK
    w, p, rg, m, v = _opt_inputs(5, RAGGED_RANK, "float32")
    g = w * 10
    torch.testing.assert_close(galore_project_batched(g, p), project_ref(g, p), **TOL["float32"])
    got = lowrank_adam_update_batched(w, p, rg, m, v, 3, 0.0025, 0.0)
    want = lowrank_adam_update_ref(w, p, rg, m, v, b1=0.9, b2=0.999, eps=1e-8, step=3,
                                   lr_alpha=0.0025, lr_wd=0.0)
    for a, c in zip(got, want):
        torch.testing.assert_close(a, c, **TOL["float32"])
    kp = 4 * r + 8
    gen = torch.Generator(device="cuda").manual_seed(6)
    gm = 0.1 * torch.randn(b, 1100, n, generator=gen, device="cuda")
    q = torch.linalg.qr(torch.randn(b, 1100, kp, generator=gen, device="cuda"))[0].contiguous()
    want = power_iter_ref(gm, q)
    torch.testing.assert_close(power_iter_batched(gm, q), want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


# ---------------------------------------------------------------------------
# the MoE, SSM and hybrid families' shapes
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("width", [1600, 2048, 3200, 1024, 7168])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_at_family_widths_on_gpu(width, dtype):
    """hymba's d_model 1600 and its mixer's 3200, deepseek's 2048 (and
    mamba's mixer): widths that are not powers of two but 2048; whisper's
    1024 and llava's 7168."""
    _require_card()
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(37, width, generator=g, device="cuda").to(TORCH[dtype])
    scale = 1 + 0.1 * torch.randn(width, generator=g, device="cuda")
    torch.testing.assert_close(rmsnorm_kernel(x, scale).float(),
                               rmsnorm_ref(x, scale).float(), **TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_kernel_at_mha16_on_gpu(dtype):
    """deepseek-moe-16b's decode: MHA 16/16 (G = 1), D 128, page size 16."""
    _require_card()
    arrays = paged_inputs(11, 4, 8, 16, 16, 16, 128, [0, 17, 64, 120])
    q, pk, pv, table, lens = (torch.from_numpy(a).cuda() for a in arrays)
    q, pk, pv = (t.to(TORCH[dtype]) for t in (q, pk, pv))
    got = paged_decode_attention_kernel(q, pk, pv, table, lens)
    ref = paged_decode_attention_ref(q, pk, pv, table, lens)
    torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])


@pytest.mark.gpu
def test_optimizer_kernels_on_an_expert_bucket_on_gpu():
    """Kernels 4, 5 and 9 on deepseek-moe-16b's expert bucket shape (d
    1408, n 2048; 8 of its 768 slices) at rank 256 and k' 1032."""
    _require_card()
    b, d, n, r, kp = 8, 1408, 2048, 256, 1032
    gen = torch.Generator(device="cuda").manual_seed(12)
    g = 0.1 * torch.randn(b, d, n, generator=gen, device="cuda")
    p = torch.linalg.qr(torch.randn(b, d, r, generator=gen, device="cuda"))[0].contiguous()
    want = project_ref(g, p)
    torch.testing.assert_close(galore_project_batched(g, p), want, rtol=1e-4,
                               atol=1e-5 * float(want.abs().max()))
    w = 0.02 * torch.randn(b, d, n, generator=gen, device="cuda")
    m = 0.1 * torch.randn(b, r, n, generator=gen, device="cuda")
    v = (0.1 * torch.randn(b, r, n, generator=gen, device="cuda")) ** 2
    got = lowrank_adam_update_batched(w, p, want, m, v, 3, 0.0025, 0.0)
    ref = lowrank_adam_update_ref(w, p, want, m, v, b1=0.9, b2=0.999, eps=1e-8, step=3,
                                  lr_alpha=0.0025, lr_wd=0.0)
    for a, bb in zip(got, ref):
        torch.testing.assert_close(a, bb, rtol=1e-4, atol=1e-5 * float(bb.abs().max()))
    q = torch.linalg.qr(torch.randn(b, d, kp, generator=gen, device="cuda"))[0].contiguous()
    want = power_iter_ref(g, q)
    torch.testing.assert_close(power_iter_batched(g, q), want, rtol=1e-4,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.gpu
def test_moe_dispatch_on_gpu_matches_the_cpu():
    """The MoE layer's dispatch and grouped products on the card (f32)
    against the same layer on the CPU: the scatter-add's atomics sum each
    token's k rows in any order, so the bar is f32's, not bits; the aux
    loss and the host-synced group sizes must agree."""
    _require_card()
    from repro_torch.configs.registry import get_config
    from repro_torch.models import build_model, moe

    cfg = get_config("deepseek-moe-16b", smoke=True).with_(dtype=torch.float32)
    params = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    lp = {k: (v[0] if not isinstance(v, dict) else {kk: vv[0] for kk, vv in v.items()})
          for k, v in params["blocks"]["moe"].items()}
    x = torch.randn(4, 33, cfg.d_model, generator=torch.Generator().manual_seed(4))
    want, want_aux = moe.apply_moe_local(lp, x, cfg)
    on_card = {k: (v.cuda() if not isinstance(v, dict) else {kk: vv.cuda() for kk, vv in v.items()})
               for k, v in lp.items()}
    got, aux = moe.apply_moe_local(on_card, x.cuda(), cfg)
    torch.testing.assert_close(got.cpu(), want, **TOL["float32"])
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# the VLM and enc-dec families' shapes
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_kernel_at_gqa56_8_on_gpu(dtype):
    """llava-next-34b's decode: GQA 56/8 (G = 7, the 8-head instance with
    one head idle), D 128, page size 16, each slot's 576 patches ahead."""
    _require_card()
    arrays = paged_inputs(13, 4, 72, 16, 56, 8, 128, [576, 705, 1093, 640])
    q, pk, pv, table, lens = (torch.from_numpy(a).cuda() for a in arrays)
    q, pk, pv = (t.to(TORCH[dtype]) for t in (q, pk, pv))
    got = paged_decode_attention_kernel(q, pk, pv, table, lens)
    ref = paged_decode_attention_ref(q, pk, pv, table, lens)
    torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 7168, 20480, 512, True), (8, 1024, 1024, 256, False)])
def test_optimizer_kernels_on_the_vlm_and_encdec_buckets_on_gpu(shape):
    """Kernels 4 and 5 (and 9 where the path runs it) on llava's mlp bucket
    (7168 x 20480, rank 512, k' 2056; 2 of its 6 slices) and whisper's
    1024 x 1024 bucket (rank 256; 8 of its 288 slices; its sketch spans
    d, so no power iteration)."""
    _require_card()
    b, d, n, r, power = shape
    gen = torch.Generator(device="cuda").manual_seed(14)
    g = 0.1 * torch.randn(b, d, n, generator=gen, device="cuda")
    p = torch.linalg.qr(torch.randn(b, d, r, generator=gen, device="cuda"))[0].contiguous()
    want = project_ref(g, p)
    torch.testing.assert_close(galore_project_batched(g, p), want, rtol=1e-4,
                               atol=1e-5 * float(want.abs().max()))
    w = 0.02 * torch.randn(b, d, n, generator=gen, device="cuda")
    m = 0.1 * torch.randn(b, r, n, generator=gen, device="cuda")
    v = (0.1 * torch.randn(b, r, n, generator=gen, device="cuda")) ** 2
    got = lowrank_adam_update_batched(w, p, want, m, v, 3, 0.0025, 0.0)
    ref = lowrank_adam_update_ref(w, p, want, m, v, b1=0.9, b2=0.999, eps=1e-8, step=3,
                                  lr_alpha=0.0025, lr_wd=0.0)
    for a, bb in zip(got, ref):
        torch.testing.assert_close(a, bb, rtol=1e-4, atol=1e-5 * float(bb.abs().max()))
    if power:
        kp = 4 * r + 8
        q = torch.linalg.qr(torch.randn(b, d, kp, generator=gen, device="cuda"))[0].contiguous()
        want = power_iter_ref(g, q)
        torch.testing.assert_close(power_iter_batched(g, q), want, rtol=1e-4,
                                   atol=1e-5 * float(want.abs().max()))


@pytest.mark.gpu
def test_attention_dispatch_takes_cross_attention_to_the_kernel_on_gpu():
    """``models/attention.py`` sends attention without a mask to the flash
    kernel whatever Sq and Sk (whisper's cross-attention), and refuses a
    causal or windowed call with Sq != Sk, whose arange positions would
    not be the caller's."""
    _require_card()
    from repro_torch.kernels import counters
    from repro_torch.models import attention as attn_lib

    g = torch.Generator(device="cuda").manual_seed(15)
    q = torch.randn(2, 3, 4, 64, generator=g, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(2, 40, 4, 64, generator=g, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    zq = torch.zeros(2, 3, dtype=torch.int32, device="cuda")
    zk = torch.zeros(2, 40, dtype=torch.int32, device="cuda")
    before = counters.LAUNCHES["flash_attention_fwd"]
    got = attn_lib.attention(q, k, v, zq, zk, causal=False)
    assert counters.LAUNCHES["flash_attention_fwd"] == before + 1
    want = attn_lib.exact_attention(q, k, v, zq, zk, causal=False)
    torch.testing.assert_close(got.float(), want.float(), **TOL["bfloat16"])
    for kw in (dict(causal=True), dict(causal=False, window=8)):
        with pytest.raises(ValueError, match="Sq == Sk"):
            attn_lib.attention(q, k, v, zq, zk, **kw)
