"""Plain PyTorch versions of the fused low-rank updates, from
``src/repro/kernels/lowrank_update/ref.py``.

Semantics (canonical side='left' stacks, optional leading batch dims):

  Adam:  M' = b1 M + (1-b1) R,  V' = b2 V + (1-b2) R*R
         N  = (M'/bc1) / (sqrt(V'/bc2) + eps)
         W' = (1 - lr_wd) W - lr_alpha * (P @ N)
  MSGD:  M' = (1-b1) M + b1 R   (inner.msgd's convention)
         W' = (1 - lr_wd) W - lr_alpha * (P @ M')

with bc1 = 1-b1^t, bc2 = 1-b2^t for the 1-indexed step t.  W' keeps W's
dtype; moments are f32.

The quantized-layout variants take a ``side``: their per-row state follows
the PER-LEAF orientation while the stacks are canonical (side='right'
slices enter transposed):

  Adam-mini:  v is one f32 per per-leaf row, (..., r) for 'left' buckets
              (reduced over n), (..., n) for 'right' ones (reduced over r);
              N = (M'/bc1) / (sqrt(v'/bc2) + eps), v' broadcast.
  8-bit Adam: M and V are uint8 codes element-aligned with the stack, with
              f32 per-row-chunk scales in per-leaf row order (quantize.py):
              dequantize, Adam, requantize, W'.  ``step``, ``lr_alpha`` and ``lr_wd`` are host
numbers here: the port keeps the step count and the schedule on the host.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.lowrank_update import quantize as qz


def bias_correction(beta: float, step: int) -> float:
    """1 - beta^t in f32, as the JAX code computes it from an f32 step."""
    return float(np.float32(1.0) - np.float32(beta) ** np.float32(step))


def bias_corrections(b1: float, b2: float, step: int) -> Tuple[float, float]:
    """(1 - b1^t, 1 - b2^t)."""
    return bias_correction(b1, step), bias_correction(b2, step)


def backproject_ref(w: torch.Tensor, p: torch.Tensor, n_dir: torch.Tensor, lr_alpha: float,
                    lr_wd: float = 0.0) -> torch.Tensor:
    """W' = (1 - lr_wd) W - lr_alpha * (P @ N), in W's dtype."""
    w_new = (1.0 - lr_wd) * w.float() - lr_alpha * torch.einsum(
        "...dr,...rn->...dn", p.float(), n_dir
    )
    return w_new.to(w.dtype)


def _apply(w, p, n_dir, lr_alpha, lr_wd, gather):
    """The back-projection of N, gathered first with ``gather`` (the split
    schedule: this process's rows of N -> every row)."""
    return backproject_ref(w, p, n_dir if gather is None else gather(n_dir), lr_alpha, lr_wd)


# ``gather`` (every update below): the split schedule of ZeRO state on the
# FSDP step (``core/buckets.py``).  r_g and the moments are then this
# process's rows of the bucket, w and p every row of its block, and
# ``gather`` takes the rows of N to every row before the back-projection.


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
    gather=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    r32 = r_g.float()
    m_new = b1 * m.float() + (1.0 - b1) * r32
    v_new = b2 * v.float() + (1.0 - b2) * r32 * r32
    bc1, bc2 = bias_corrections(b1, b2, step)
    n_dir = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    return _apply(w, p, n_dir, lr_alpha, lr_wd, gather), m_new, v_new


def lowrank_msgd_update_ref(
    w: torch.Tensor,  # (..., d, n)
    p: torch.Tensor,  # (..., d, r)
    r_g: torch.Tensor,  # (..., r, n)
    m: torch.Tensor,  # (..., r, n)
    *,
    b1: float,
    lr_alpha: float,
    lr_wd: float = 0.0,
    gather=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    m_new = (1.0 - b1) * m.float() + b1 * r_g.float()
    return _apply(w, p, m_new, lr_alpha, lr_wd, gather), m_new


def adam_mini_stats_ref(
    r_g: torch.Tensor,  # (..., r, n) canonical projected gradient
    v: torch.Tensor,  # (..., r) side='left' | (..., n) side='right'
    step: int,
    *,
    b2: float,
    eps: float,
    side: str = "left",
    axes=None,
    n_total: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Adam-mini's per-row second moment and the direction's denominator:
    ``(v', den)`` with ``den`` broadcastable against the (..., r, n) stack.
    Side 'right' reduces in the per-leaf orientation, as JAX does.  On a
    'left' stack whose n ``axes`` cut (this process's columns of rows of
    ``n_total``), the row sums are summed over ``axes`` before the mean."""
    r32 = r_g.float()
    bc2 = bias_correction(b2, step)
    if side == "left":
        if axes is not None:
            blk = axes.all_reduce_(torch.sum(r32 * r32, dim=-1)) / n_total
        else:
            blk = torch.mean(r32 * r32, dim=-1)  # (..., r)
        v_new = b2 * v + (1.0 - b2) * blk
        vb = v_new[..., :, None]
    else:
        rt = r32.transpose(-1, -2)
        blk = torch.mean(rt * rt, dim=-1)  # (..., n)
        v_new = b2 * v + (1.0 - b2) * blk
        vb = v_new[..., None, :]
    return v_new, torch.sqrt(vb / bc2) + eps


def lowrank_adam_mini_update_ref(
    w: torch.Tensor,  # (..., d, n)
    p: torch.Tensor,  # (..., d, r)
    r_g: torch.Tensor,  # (..., r, n)
    m: torch.Tensor,  # (..., r, n)
    v: torch.Tensor,  # (..., r) 'left' | (..., n) 'right'
    step: int,
    lr_alpha: float,
    lr_wd: float = 0.0,
    *,
    b1: float,
    b2: float,
    eps: float,
    side: str = "left",
    axes=None,
    n_total: int = 0,
    gather=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    r32 = r_g.float()
    m_new = b1 * m.float() + (1.0 - b1) * r32
    v_new, den = adam_mini_stats_ref(r_g, v, step, b2=b2, eps=eps, side=side, axes=axes,
                                     n_total=n_total)
    n_dir = (m_new / bias_correction(b1, step)) / den
    return _apply(w, p, n_dir, lr_alpha, lr_wd, gather), m_new, v_new


def adam8bit_moments_ref(r_g, m_codes, m_scale, v_codes, v_scale, step, *, b1, b2, eps,
                         side="left", qoff=0):
    """8-bit Adam's dequantized update: (N, M', V') in f32, canonical."""
    r32 = r_g.float()
    m = qz.dequantize_stacked(m_codes, m_scale, side, signed=True, offset=qoff)
    v = qz.dequantize_stacked(v_codes, v_scale, side, signed=False, offset=qoff)
    m_new = b1 * m + (1.0 - b1) * r32
    v_new = b2 * v + (1.0 - b2) * r32 * r32
    bc1, bc2 = bias_corrections(b1, b2, step)
    return (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps), m_new, v_new


def lowrank_adam8bit_update_ref(
    w: torch.Tensor,  # (..., d, n)
    p: torch.Tensor,  # (..., d, r)
    r_g: torch.Tensor,  # (..., r, n)
    m_codes: torch.Tensor,  # (..., r, n) uint8, canonical orientation
    m_scale: torch.Tensor,  # (..., r, nb) 'left' | (..., n, nb_r) 'right'
    v_codes: torch.Tensor,  # (..., r, n) uint8
    v_scale: torch.Tensor,
    step: int,
    lr_alpha: float,
    lr_wd: float = 0.0,
    *,
    b1: float,
    b2: float,
    eps: float,
    side: str = "left",
    qoff: int = 0,
    reduce=None,
    gather=None,
) -> Tuple[torch.Tensor, ...]:
    """Dequantize, Adam, requantize, W'.  Returns (W', m codes, m scales,
    v codes, v scales).  A 'left' block of cut rows (``quantize.py``):
    ``qoff`` its first column's place in its chunk, ``reduce`` the map of
    each chunk piece's absmax to the whole chunk's (``straddle_max``)."""
    n_dir, m_new, v_new = adam8bit_moments_ref(r_g, m_codes, m_scale, v_codes, v_scale, step,
                                               b1=b1, b2=b2, eps=eps, side=side, qoff=qoff)
    am = av = None
    if reduce is not None:
        am = reduce(qz.chunk_absmax(m_new, qoff))
        av = reduce(qz.chunk_absmax(v_new, qoff))
    mc, ms = qz.quantize_stacked(m_new, side, signed=True, offset=qoff, absmax=am)
    vc, vs = qz.quantize_stacked(v_new, side, signed=False, offset=qoff, absmax=av)
    return _apply(w, p, n_dir, lr_alpha, lr_wd, gather), mc, ms, vc, vs
