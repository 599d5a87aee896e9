"""RMSNorm dispatch: the Triton kernel for CUDA tensors, the plain version
for CPU tensors (``models/layers.rmsnorm`` routes through here)."""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm import kernel as kernel_lib
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    return kernel_lib.rmsnorm(x, scale, eps)
