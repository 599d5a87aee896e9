"""Triton fused RMSNorm for Hopper.

Replaces the TPU kernel ``src/repro/kernels/rmsnorm/kernel.py::rmsnorm``
(``pallas_call`` at l.45): ``y = x * rsqrt(mean(x^2) + eps) * scale`` over
the last dim, with fp32 statistics, the scale read as f32 and the output in
x's dtype (kernel.py:21-24).

Design.  One program per row with D as one ``tl.constexpr`` block (the next
power of two, masked): the row is read once, reduced and scaled in
registers, and written once.  Any row count works, so a decode tick's
``max_slots`` rows and a prefill's thousands go through the same kernel.

Bound on the H100: bytes.  Each element is read once and written once for
~4 operations, two orders of magnitude below the card's
bytes-to-operations line.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import counters

NAME = "rmsnorm"


@functools.lru_cache(maxsize=None)
def _kernel():
    """The jitted Triton kernel; ``triton`` is imported here, at the first
    launch, because CPU-only installs have none."""
    import triton
    import triton.language as tl

    @triton.jit
    def rmsnorm_kernel(x_ptr, s_ptr, y_ptr, D, eps, BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        offs = tl.arange(0, BLOCK)
        mask = offs < D
        x = tl.load(x_ptr + row * D + offs, mask=mask, other=0.0).to(tl.float32)
        var = tl.sum(x * x, axis=0) / D
        y = x * tl.math.rsqrt(var + eps)
        s = tl.load(s_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        y = y * s
        tl.store(y_ptr + row * D + offs, y.to(y_ptr.dtype.element_ty), mask=mask)

    return triton, rmsnorm_kernel


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x (..., D) f32/bf16 contiguous on a CUDA device; scale (D,)."""
    if not (x.is_cuda and scale.is_cuda and x.device == scale.device):
        raise ValueError("rmsnorm kernel needs x and scale on one CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rmsnorm kernel takes f32 or bf16, got {x.dtype}")
    if scale.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rmsnorm scale must be f32 or bf16, got {scale.dtype}")
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"scale shape {tuple(scale.shape)} != ({d},)")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm kernel needs contiguous x and scale")
    y = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return y
    triton, kernel = _kernel()
    block = triton.next_power_of_2(d)
    with torch.cuda.device(x.device):
        kernel[(rows,)](
            x, scale, y, d, float(eps), BLOCK=block,
            num_warps=min(16, max(1, block // 256)),
        )
    counters.LAUNCHES[NAME] += 1
    return y
