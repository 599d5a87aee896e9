"""Plain PyTorch versions of the fused low-rank updates, from
``src/repro/kernels/lowrank_update/ref.py``.

Semantics (canonical side='left' stacks, optional leading batch dims):

  Adam:  M' = b1 M + (1-b1) R,  V' = b2 V + (1-b2) R*R
         N  = (M'/bc1) / (sqrt(V'/bc2) + eps)
         W' = (1 - lr_wd) W - lr_alpha * (P @ N)
  MSGD:  M' = (1-b1) M + b1 R   (inner.msgd's convention)
         W' = (1 - lr_wd) W - lr_alpha * (P @ M')

with bc1 = 1-b1^t, bc2 = 1-b2^t for the 1-indexed step t.  W' keeps W's
dtype; moments are f32.  ``step``, ``lr_alpha`` and ``lr_wd`` are host
numbers here: the port keeps the step count and the schedule on the host.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def bias_corrections(b1: float, b2: float, step: int) -> Tuple[float, float]:
    """(1 - b1^t, 1 - b2^t) in f32, as the JAX code computes them from an
    f32 step."""
    t = np.float32(step)
    one = np.float32(1.0)
    return float(one - np.float32(b1) ** t), float(one - np.float32(b2) ** t)


def lowrank_adam_update_ref(
    w: torch.Tensor,  # (..., d, n)
    p: torch.Tensor,  # (..., d, r)
    r_g: torch.Tensor,  # (..., r, n) projected gradient
    m: torch.Tensor,  # (..., r, n)
    v: torch.Tensor,  # (..., r, n)
    *,
    b1: float,
    b2: float,
    eps: float,
    step: int,
    lr_alpha: float,
    lr_wd: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    r32 = r_g.float()
    m_new = b1 * m.float() + (1.0 - b1) * r32
    v_new = b2 * v.float() + (1.0 - b2) * r32 * r32
    bc1, bc2 = bias_corrections(b1, b2, step)
    n_dir = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    w_new = (1.0 - lr_wd) * w.float() - lr_alpha * torch.einsum(
        "...dr,...rn->...dn", p.float(), n_dir
    )
    return w_new.to(w.dtype), m_new, v_new


def lowrank_msgd_update_ref(
    w: torch.Tensor,  # (..., d, n)
    p: torch.Tensor,  # (..., d, r)
    r_g: torch.Tensor,  # (..., r, n)
    m: torch.Tensor,  # (..., r, n)
    *,
    b1: float,
    lr_alpha: float,
    lr_wd: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    m_new = (1.0 - b1) * m.float() + b1 * r_g.float()
    w_new = (1.0 - lr_wd) * w.float() - lr_alpha * torch.einsum(
        "...dr,...rn->...dn", p.float(), m_new
    )
    return w_new.to(w.dtype), m_new
