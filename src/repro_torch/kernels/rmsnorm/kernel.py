"""Triton fused RMSNorm for Hopper.

Replaces the TPU kernel ``src/repro/kernels/rmsnorm/kernel.py::rmsnorm``
(``pallas_call`` at l.45): ``y = x * rsqrt(mean(x^2) + eps) * scale`` over
the last dim, with fp32 statistics, the scale read as f32 and the output in
x's dtype (kernel.py:21-24).

Design.  One program per row with D as one ``tl.constexpr`` block (the next
power of two, masked): the row is read once, reduced and scaled in
registers, and written once.  Any row count works, so a decode tick's
``max_slots`` rows and a prefill's thousands go through the same kernel.

Where a row's channels are split over processes (the SSM mixer's gated
norm on a process's heads, ``models/ssm.py``), the caller passes ``ss``,
each row's sum of squares over all ``width`` channels (its partial sums
all-reduced), and the kernel reads it in place of its own sum.

Bound on the H100: bytes.  Each element is read once and written once for
~4 operations, two orders of magnitude below the card's
bytes-to-operations line.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels import counters
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

NAME = "rmsnorm"


@functools.lru_cache(maxsize=None)
def _kernel():
    """The jitted Triton kernel; ``triton`` is imported here, at the first
    launch, because CPU-only installs have none."""
    import triton
    import triton.language as tl

    @triton.jit
    def rmsnorm_kernel(x_ptr, s_ptr, y_ptr, ss_ptr, D, width, eps, BLOCK: tl.constexpr,
                       GIVEN_SS: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        offs = tl.arange(0, BLOCK)
        mask = offs < D
        x = tl.load(x_ptr + row * D + offs, mask=mask, other=0.0).to(tl.float32)
        if GIVEN_SS:
            var = tl.load(ss_ptr + row) / width
        else:
            var = tl.sum(x * x, axis=0) / D
        y = x * tl.math.rsqrt(var + eps)
        s = tl.load(s_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        y = y * s
        tl.store(y_ptr + row * D + offs, y.to(y_ptr.dtype.element_ty), mask=mask)

    return triton, rmsnorm_kernel


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5,
            ss: Optional[torch.Tensor] = None, width: Optional[int] = None) -> torch.Tensor:
    """x (..., D) f32/bf16 contiguous on a CUDA device; scale (D,); ``ss``
    (..., 1) f32 contiguous: each row's sum of squares over ``width``
    channels, read in place of the row's own (module docstring)."""
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
    if ss is not None:
        if ss.device != x.device or ss.dtype != torch.float32 or not ss.is_contiguous():
            raise ValueError("rmsnorm kernel needs ss f32 and contiguous on x's device")
        if tuple(ss.shape) != tuple(x.shape[:-1]) + (1,) or width is None:
            raise ValueError(f"ss shape {tuple(ss.shape)} for x {tuple(x.shape)}, width "
                             f"{width}: need x's rows by 1 and a width")
    y = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return y
    triton, kernel = _kernel()
    block = triton.next_power_of_2(d)
    with torch.cuda.device(x.device):
        kernel[(rows,)](
            x, scale, y, x if ss is None else ss, d, float(width or d), float(eps),
            BLOCK=block, GIVEN_SS=ss is not None,
            num_warps=min(16, max(1, block // 256)),
        )
    counters.bump(NAME)
    return y


class _RMSNorm(torch.autograd.Function):
    """Forward: the Triton kernel.  Backward: autograd through the plain
    version, recomputed from the saved inputs.  The JAX package has no
    backward kernel for RMSNorm either; its gradient is XLA's."""

    @staticmethod
    def forward(ctx, x, scale, eps, ss, width):
        ctx.save_for_backward(x, scale, ss)
        ctx.eps, ctx.width = eps, width
        return rmsnorm(x, scale, eps, ss, width)

    @staticmethod
    def backward(ctx, gy):
        x, scale, ss = ctx.saved_tensors
        with torch.enable_grad():
            xd = x.detach().requires_grad_(ctx.needs_input_grad[0])
            sd = scale.detach().requires_grad_(ctx.needs_input_grad[1])
            ssd = None if ss is None else ss.detach().requires_grad_(ctx.needs_input_grad[3])
            wanted = [t for t in (xd, sd, ssd) if t is not None and t.requires_grad]
            got = iter(torch.autograd.grad(rmsnorm_ref(xd, sd, ctx.eps, ssd, ctx.width),
                                           wanted, gy))
        return (next(got) if xd.requires_grad else None,
                next(got) if sd.requires_grad else None, None,
                next(got) if ssd is not None and ssd.requires_grad else None, None)


def rmsnorm_autograd(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5,
                     ss: Optional[torch.Tensor] = None,
                     width: Optional[int] = None) -> torch.Tensor:
    """``rmsnorm`` with a gradient (see ``_RMSNorm``)."""
    return _RMSNorm.apply(x, scale, eps, ss, width)
