"""Plain PyTorch gradient projection, from
``src/repro/kernels/galore_project/ref.py::project_ref``."""
from __future__ import annotations

import torch


def project_ref(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """R = P^T G with leading batch dims: g (..., d, n), p (..., d, r) ->
    (..., r, n) f32."""
    return torch.einsum("...dr,...dn->...rn", p.float(), g.float())
