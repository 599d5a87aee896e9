"""Plain PyTorch gradient projections, from
``src/repro/kernels/galore_project/ref.py``: ``project_ref`` (the batched
projection) and ``galore_project_ref`` (the 2-D projection fused with
Adam's moments)."""
from __future__ import annotations

from typing import Tuple

import torch


def project_ref(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """R = P^T G with leading batch dims: g (..., d, n), p (..., d, r) ->
    (..., r, n) f32."""
    return torch.einsum("...dr,...dn->...rn", p.float(), g.float())


def galore_project_ref(
    g: torch.Tensor,  # (..., d, n)
    p: torch.Tensor,  # (..., d, r)
    m: torch.Tensor,  # (..., r, n)
    v: torch.Tensor,  # (..., r, n)
    *,
    b1: float,
    b2: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(R, M', V'), all f32: R = P^T G, M' = b1 M + (1-b1) R,
    V' = b2 V + (1-b2) R*R, each operation rounded on its own."""
    r = project_ref(g, p)
    m_new = b1 * m.float() + (1.0 - b1) * r
    v_new = b2 * v.float() + (1.0 - b2) * r * r
    return r, m_new, v_new
