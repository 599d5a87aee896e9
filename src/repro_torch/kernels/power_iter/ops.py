"""Power-iteration dispatch, from ``src/repro/kernels/power_iter/ops.py``:
the CUDA kernel for CUDA tensors (every shape; no VMEM-budget gate), the
plain version for CPU tensors.  A 2-D (m, n) gradient gets a B=1 batch dim,
so the per-leaf and stacked refreshes run the same primitive."""
from __future__ import annotations

import torch

from repro_torch.kernels.power_iter import kernel as kernel_lib
from repro_torch.kernels.power_iter.ref import power_iter_ref


def power_iter_step(g: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Y = G (G^T Q) per batch slice (f32); g (B, m, n) or (m, n)."""
    squeeze = g.dim() == 2
    if squeeze:
        g, q = g[None], q[None]
    if g.device.type == "cpu":
        out = power_iter_ref(g, q)
    else:
        out = kernel_lib.power_iter_batched(g.contiguous(), q.float().contiguous())
    return out[0] if squeeze else out
