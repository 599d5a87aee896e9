"""Wrapper of the CUDA flash-attention forward (``csrc/flash_attention.cu``).

Replaces the TPU kernel ``src/repro/kernels/flash_attention/kernel.py::
flash_attention_fwd``.  The source's header says how the kernel is laid out
and what bounds it on the H100 (operations, at the serving shapes).  Only
the forward is ported: serving needs no backward.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, counters

NAME = "flash_attention_fwd"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_fwd(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, KVH, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
) -> torch.Tensor:
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError("flash_attention_fwd needs q, k, v on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention_fwd takes one of f32/bf16, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"want q (B,Sq,H,D), k = v (B,Sk,KVH,D); got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, sq, h, d = q.shape
    kb, sk, kvh, kd = k.shape
    if kb != b or kd != d or kvh < 1 or h % kvh:
        raise ValueError(f"mismatched q {tuple(q.shape)} and k {tuple(k.shape)}")
    if not (8 <= d <= 256 and d % 8 == 0):
        raise ValueError(f"head_dim {d} unsupported: need 8 <= D <= 256, D % 8 == 0")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_fwd needs contiguous q, k, v")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        err = build.entry("flash_attention")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, sq, sk, h, kvh, d, int(bool(causal)),
            int(window), int(q_offset), 1.0 / d**0.5,
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, NAME)
    counters.LAUNCHES[NAME] += 1
    return out
