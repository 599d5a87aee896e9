"""Dispatch of the bucketed engine's primitives, from
``src/repro/kernels/lowrank_update/ops.py``: CUDA tensors go to the
hand-written kernels, CPU tensors to the plain versions.  Every function
takes stacked (B, d, n) / (B, d, r) / (B, r, n) operands in the canonical
side='left' orientation (core/buckets.py transposes side='right' leaves
on the way in and out).  The updates' keywords for blocks of the state
(``gather``, Adam-mini's ``axes`` / ``n_total``, 8-bit Adam's ``qoff`` /
``reduce``) pass to both versions as they are (``kernel.py``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.galore_project import kernel as project_kernel
from repro_torch.kernels.galore_project.ref import project_ref
from repro_torch.kernels.lowrank_update import kernel as update_kernel
from repro_torch.kernels.lowrank_update import ref as ref_lib


def bucketed_project(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """R = P^T G: g (B, d, n), p (B, d, r) -> (B, r, n) f32."""
    if g.device.type == "cpu":
        return project_ref(g, p)
    return project_kernel.galore_project_batched(g.contiguous(), p.contiguous())


def bucketed_adam_update(
    w: torch.Tensor,  # (B, d, n)
    p: torch.Tensor,  # (B, d, r)
    r_g: torch.Tensor,  # (B, r, n)
    m: torch.Tensor,  # (B, r, n)
    v: torch.Tensor,  # (B, r, n)
    step: int,
    lr_alpha: float,
    lr_wd: float = 0.0,
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    gather=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """W' = (1-lr_wd) W - lr_alpha P@N, plus new moments, one call."""
    if w.device.type == "cpu":
        return ref_lib.lowrank_adam_update_ref(
            w, p, r_g, m, v, b1=b1, b2=b2, eps=eps, step=step,
            lr_alpha=lr_alpha, lr_wd=lr_wd, gather=gather,
        )
    return update_kernel.lowrank_adam_update_batched(
        w.contiguous(), p.contiguous(), r_g.contiguous(), m.contiguous(),
        v.contiguous(), step, lr_alpha, lr_wd, b1=b1, b2=b2, eps=eps, gather=gather,
    )


def bucketed_msgd_update(
    w: torch.Tensor,
    p: torch.Tensor,
    r_g: torch.Tensor,
    m: torch.Tensor,
    lr_alpha: float,
    lr_wd: float = 0.0,
    *,
    b1: float = 0.9,
    gather=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """MSGD's fused update: (W', M')."""
    if w.device.type == "cpu":
        return ref_lib.lowrank_msgd_update_ref(
            w, p, r_g, m, b1=b1, lr_alpha=lr_alpha, lr_wd=lr_wd, gather=gather
        )
    return update_kernel.lowrank_msgd_update_batched(
        w.contiguous(), p.contiguous(), r_g.contiguous(), m.contiguous(),
        lr_alpha, lr_wd, b1=b1, gather=gather,
    )


def bucketed_adam_mini_update(
    w: torch.Tensor,  # (B, d, n)
    p: torch.Tensor,  # (B, d, r)
    r_g: torch.Tensor,  # (B, r, n)
    m: torch.Tensor,  # (B, r, n)
    v: torch.Tensor,  # (B, r) 'left' | (B, n) 'right'
    step: int,
    lr_alpha: float,
    lr_wd: float = 0.0,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    side: str = "left",
    **cut,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Adam-mini's fused update with the per-row v: (W', M', v')."""
    if w.device.type == "cpu":
        return ref_lib.lowrank_adam_mini_update_ref(
            w, p, r_g, m, v, step, lr_alpha, lr_wd, b1=b1, b2=b2, eps=eps, side=side, **cut
        )
    return update_kernel.lowrank_adam_mini_update_batched(
        w.contiguous(), p.contiguous(), r_g.contiguous(), m.contiguous(),
        v.contiguous(), step, lr_alpha, lr_wd, b1=b1, b2=b2, eps=eps, side=side, **cut,
    )


def bucketed_adam8bit_update(
    w: torch.Tensor,  # (B, d, n)
    p: torch.Tensor,  # (B, d, r)
    r_g: torch.Tensor,  # (B, r, n)
    m_codes: torch.Tensor,  # (B, r, n) uint8
    m_scale: torch.Tensor,  # (B, r, nb) 'left' | (B, n, nb_r) 'right'
    v_codes: torch.Tensor,
    v_scale: torch.Tensor,
    step: int,
    lr_alpha: float,
    lr_wd: float = 0.0,
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    side: str = "left",
    **cut,
) -> Tuple[torch.Tensor, ...]:
    """8-bit Adam's fused update: (W', m codes, m scales, v codes, v
    scales).  Unlike JAX's dispatch (``adam8bit_kernel_supported``), every
    shape goes to the kernel on the card: a short final chunk, and a chunk
    that straddles a block edge, are masked, not sent to the plain
    version."""
    if w.device.type == "cpu":
        return ref_lib.lowrank_adam8bit_update_ref(
            w, p, r_g, m_codes, m_scale, v_codes, v_scale, step, lr_alpha, lr_wd,
            b1=b1, b2=b2, eps=eps, side=side, **cut,
        )
    return update_kernel.lowrank_adam8bit_update_batched(
        *(t.contiguous() for t in (w, p, r_g, m_codes, m_scale, v_codes, v_scale)),
        step, lr_alpha, lr_wd, b1=b1, b2=b2, eps=eps, side=side, **cut,
    )
