"""Plain PyTorch RMSNorm, from ``src/repro/kernels/rmsnorm/ref.py``."""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D), scale: (D,).  fp32 statistics, input-dtype output."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)
