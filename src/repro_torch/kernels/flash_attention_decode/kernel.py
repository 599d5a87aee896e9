"""Wrapper of the CUDA paged decode attention (``csrc/paged_decode.cu``).

Replaces the TPU kernel ``src/repro/kernels/flash_attention_decode/
kernel.py::paged_decode_attention_kernel``.  The source's header says how
the kernel is laid out and what bounds it on the H100 (bytes).  Unlike the
JAX dispatch (``ops.py:30-31``), which sends unaligned shapes to the plain
version, this takes any page size >= 1 and any head dim up to 256 that is a
multiple of 8, and raises on anything else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, counters

NAME = "paged_decode_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _chunk() -> int:
    """Tokens per block of the split pass, as compiled into the kernel."""
    fn = build.library("paged_decode").repro_paged_decode_chunk
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


def paged_decode_attention_kernel(
    q: torch.Tensor,  # (B, 1, H, D)
    pages_k: torch.Tensor,  # (P, ps, KVH, D)
    pages_v: torch.Tensor,
    page_table: torch.Tensor,  # (B, MP) int32
    seq_lens: torch.Tensor,  # (B,) int32
    *,
    window: int = 0,
) -> torch.Tensor:
    ts = (q, pages_k, pages_v, page_table, seq_lens)
    if not all(t.is_cuda and t.device == q.device for t in ts):
        raise ValueError("paged decode attention needs every input on one CUDA device")
    if q.dtype not in _DTYPES or pages_k.dtype != q.dtype or pages_v.dtype != q.dtype:
        raise TypeError(
            f"paged decode attention takes one of f32/bf16, got {q.dtype}, "
            f"{pages_k.dtype}, {pages_v.dtype}"
        )
    if page_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("page_table and seq_lens must be int32")
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"paged decode attention requires q (B,1,H,D), got {tuple(q.shape)}")
    b, _, h, d = q.shape
    if pages_k.dim() != 4 or pages_k.shape != pages_v.shape:
        raise ValueError("pages_k and pages_v must both be (P, ps, KVH, D)")
    _, ps, kvh, pd = pages_k.shape
    if pd != d or kvh < 1 or h % kvh or h // kvh > 32:
        raise ValueError(f"q {tuple(q.shape)} does not fit pages {tuple(pages_k.shape)}")
    if not (8 <= d <= 256 and d % 8 == 0) or ps < 1:
        raise ValueError(f"unsupported head_dim {d} / page size {ps}")
    if page_table.dim() != 2 or page_table.shape[0] != b or seq_lens.shape != (b,):
        raise ValueError("page_table must be (B, MP) and seq_lens (B,)")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("paged decode attention needs contiguous inputs")
    out = torch.empty_like(q)
    mp = page_table.shape[1]
    if out.numel() == 0 or mp == 0:
        return out.zero_()
    # f32 partials of the split pass, merged by the combine pass
    n_split = -(-mp * ps // _chunk())
    part_acc = torch.empty((b, h, n_split, d), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((b, h, n_split, 2), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = build.entry("paged_decode")(
            q.data_ptr(), pages_k.data_ptr(), pages_v.data_ptr(),
            page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            part_acc.data_ptr(), part_ml.data_ptr(),
            _DTYPES[q.dtype], b, h, kvh, d, ps, mp, int(window), 1.0 / d**0.5,
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, NAME)
    counters.LAUNCHES[NAME] += 1
    return out
