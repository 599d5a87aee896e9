"""RMSNorm dispatch: the Triton kernel for CUDA tensors, through its
autograd wrapper where a gradient is wanted (training; the wrapper costs
host time per call that serving does not pay), the plain version for CPU
tensors (``models/layers.rmsnorm`` routes through here)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.rmsnorm import kernel as kernel_lib
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5,
            ss: Optional[torch.Tensor] = None, width: Optional[int] = None) -> torch.Tensor:
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps, ss, width)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or (ss is not None and ss.requires_grad)):
        return kernel_lib.rmsnorm_autograd(x, scale, eps, ss, width)
    return kernel_lib.rmsnorm(x, scale, eps, ss, width)
