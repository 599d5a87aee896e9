"""Plain PyTorch power-iteration step, from
``src/repro/kernels/power_iter/ref.py``."""
from __future__ import annotations

import torch


def power_iter_ref(g: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Y = G (G^T Q) per batch slice: g (B, m, n), q (B, m, k') -> (B, m, k')
    f32, with the (B, n, k') intermediate Z = G^T Q materialized."""
    g32, q32 = g.float(), q.float()
    z = torch.einsum("bmn,bmk->bnk", g32, q32)
    return torch.einsum("bmn,bnk->bmk", g32, z)
