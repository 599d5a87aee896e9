"""Wrappers of the CUDA gradient projections (``csrc/galore_project.cu``).

``galore_project_batched`` replaces the TPU kernel of the same name in
``src/repro/kernels/galore_project/kernel.py`` (the bucketed engine's
projection); ``galore_project`` replaces the 2-D ``galore_project`` there,
the projection fused with Adam's moments, which no path of the JAX package
calls.  The source's header says how the kernels are laid out and what
bounds them on the H100 (operations, at the training shapes).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build, counters

NAME = "galore_project_batched"
NAME_2D = "galore_project"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def galore_project_batched(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """R = P^T G per slice: g (B, d, n) f32/bf16, p (B, d, r) f32 ->
    (B, r, n) f32, contiguous on one CUDA device."""
    if not (g.is_cuda and p.is_cuda and g.device == p.device):
        raise ValueError("galore_project_batched needs g and p on one CUDA device")
    if g.dtype not in _DTYPES or p.dtype != torch.float32:
        raise TypeError(
            f"galore_project_batched takes g f32/bf16 and p f32, got {g.dtype}, {p.dtype}"
        )
    if g.dim() != 3 or p.dim() != 3 or p.shape[:2] != g.shape[:2]:
        raise ValueError(
            f"want g (B, d, n) and p (B, d, r); got {tuple(g.shape)}, {tuple(p.shape)}"
        )
    if not (g.is_contiguous() and p.is_contiguous()):
        raise ValueError("galore_project_batched needs contiguous g and p")
    b, d, n = g.shape
    r = p.shape[2]
    out = torch.empty((b, r, n), dtype=torch.float32, device=g.device)
    if out.numel() == 0:
        return out
    if d == 0:
        return out.zero_()
    with torch.cuda.device(g.device):
        err = build.entry("galore_project")(
            g.data_ptr(), p.data_ptr(), out.data_ptr(), _DTYPES[g.dtype],
            b, d, n, r, torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, NAME)
    counters.bump(NAME)
    return out


def galore_project(
    g: torch.Tensor,  # (d, n) f32/bf16
    p: torch.Tensor,  # (d, r) f32
    m: torch.Tensor,  # (r, n) f32/bf16
    v: torch.Tensor,  # (r, n), m's dtype
    *,
    b1: float = 0.9,
    b2: float = 0.999,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(R, M', V'), all (r, n) f32: R = P^T G, M' = b1 M + (1-b1) R,
    V' = b2 V + (1-b2) R*R; contiguous operands on one CUDA device."""
    if not all(t.is_cuda and t.device == g.device for t in (g, p, m, v)):
        raise ValueError("galore_project needs g, p, m and v on one CUDA device")
    if (g.dtype not in _DTYPES or p.dtype != torch.float32
            or m.dtype not in _DTYPES or v.dtype != m.dtype):
        raise TypeError(
            f"galore_project takes g f32/bf16, p f32 and m, v of one dtype "
            f"f32/bf16, got {g.dtype}, {p.dtype}, {m.dtype}, {v.dtype}"
        )
    if any(t.dim() != 2 for t in (g, p, m, v)):
        raise ValueError("galore_project takes 2-D g, p, m and v")
    d, n = g.shape
    r = p.shape[1]
    if p.shape[0] != d or m.shape != (r, n) or v.shape != (r, n):
        raise ValueError(
            f"want g (d, n), p (d, r), m = v (r, n); got {tuple(g.shape)}, "
            f"{tuple(p.shape)}, {tuple(m.shape)}, {tuple(v.shape)}"
        )
    if not all(t.is_contiguous() for t in (g, p, m, v)):
        raise ValueError("galore_project needs contiguous g, p, m and v")
    if d == 0:
        raise ValueError("galore_project needs d >= 1")
    r_out, m_out, v_out = (torch.empty((r, n), dtype=torch.float32, device=g.device)
                           for _ in range(3))
    if r_out.numel() == 0:
        return r_out, m_out, v_out
    with torch.cuda.device(g.device):
        err = build.entry("galore_project_2d")(
            g.data_ptr(), p.data_ptr(), m.data_ptr(), v.data_ptr(),
            r_out.data_ptr(), m_out.data_ptr(), v_out.data_ptr(),
            _DTYPES[g.dtype], _DTYPES[m.dtype], d, n, r,
            b1, 1.0 - b1, b2, 1.0 - b2, torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, NAME_2D)
    counters.bump(NAME_2D)
    return r_out, m_out, v_out
