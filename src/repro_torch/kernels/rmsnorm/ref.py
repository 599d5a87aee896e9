"""Plain PyTorch RMSNorm, from ``src/repro/kernels/rmsnorm/ref.py``."""
from __future__ import annotations

from typing import Optional

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5,
                ss: Optional[torch.Tensor] = None, width: Optional[int] = None) -> torch.Tensor:
    """x: (..., D), scale: (D,).  fp32 statistics, input-dtype output.
    ``ss`` (..., 1) f32: each row's sum of squares over ``width`` channels,
    of which ``x`` holds D, used in place of the row's own."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True) if ss is None else ss / width
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)
