"""Wrapper of the CUDA flash-attention forward (``csrc/flash_attention.cu``).

Replaces the TPU kernel ``src/repro/kernels/flash_attention/kernel.py::
flash_attention_fwd``.  The source's header says how its two designs are
laid out (bf16 tensor cores for D % 16 == 0, f32 CUDA cores for f32 and
other head dims; the C entry point picks one and ``last_design`` names the
one that ran) and what bounds them on the H100 (operations, at the serving
shapes).  The kernel is the forward; ``flash_attention_autograd`` adds the
gradient by recomputing the plain version, as the JAX package's
``custom_vjp`` does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, counters
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

NAME = "flash_attention_fwd"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
DESIGNS = ("cuda_cores", "tensor_cores")  # csrc/flash_attention.cu FlashDesign
_last_design = None


def last_design():
    """The design of the most recent launch (one of ``DESIGNS``), or None
    before the first."""
    return _last_design


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
    design = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        err = build.entry("flash_attention")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, sq, sk, h, kvh, d, int(bool(causal)),
            int(window), int(q_offset), 1.0 / d**0.5,
            torch.cuda.current_stream().cuda_stream, ctypes.addressof(design),
        )
    build.check(err, NAME)
    global _last_design
    _last_design = DESIGNS[design.value]
    counters.bump(NAME)
    return out


class _FlashAttention(torch.autograd.Function):
    """Forward: the CUDA kernel.  Backward: autograd through
    ``flash_attention_ref`` recomputed from the saved q, k, v, exactly as
    the JAX package's ``custom_vjp`` does
    (``src/repro/kernels/flash_attention/kernel.py:198-208``): it has no
    backward kernel either."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(causal=causal, window=window, q_offset=q_offset)
        return flash_attention_fwd(q, k, v, **ctx.kw)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need)
                      for t, need in zip(saved, ctx.needs_input_grad[:3])]
            out = flash_attention_ref(*leaves, **ctx.kw)
            wanted = [t for t in leaves if t.requires_grad]
            got = iter(torch.autograd.grad(out, wanted, g))
        grads = [next(got) if t.requires_grad else None for t in leaves]
        return (*grads, None, None, None)


def flash_attention_autograd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int = 0, q_offset: int = 0,
) -> torch.Tensor:
    """``flash_attention_fwd`` with a gradient (see ``_FlashAttention``)."""
    return _FlashAttention.apply(q, k, v, causal, window, q_offset)
