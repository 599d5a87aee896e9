"""Wrapper of the CUDA fused low-rank Adam update (``csrc/lowrank_adam.cu``).

Replaces the TPU kernel ``src/repro/kernels/lowrank_update/kernel.py::
lowrank_adam_update_batched``.  The source's header says how the kernel is
laid out (a moments pass and a back-projection product, in one call) and
what bounds it on the H100 (operations).  The MSGD, Adam-mini and 8-bit
Adam kernels of the same family are not ported yet (ROADMAP queue 2, rows
6-8).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, counters
from repro_torch.kernels.lowrank_update.ref import bias_corrections

NAME = "lowrank_adam_update_batched"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def lowrank_adam_update_batched(
    w: torch.Tensor,  # (B, d, n) f32/bf16
    p: torch.Tensor,  # (B, d, r) f32
    r_g: torch.Tensor,  # (B, r, n) f32
    m: torch.Tensor,  # (B, r, n) f32
    v: torch.Tensor,  # (B, r, n) f32
    step: int,
    lr_alpha: float,
    lr_wd: float = 0.0,
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
):
    """Returns (W' in W's dtype, M', V'), all new tensors."""
    ts = (w, p, r_g, m, v)
    if not all(t.is_cuda and t.device == w.device for t in ts):
        raise ValueError("lowrank_adam_update_batched needs every operand on one CUDA device")
    if w.dtype not in _DTYPES or any(t.dtype != torch.float32 for t in ts[1:]):
        raise TypeError(
            "lowrank_adam_update_batched takes w f32/bf16 and f32 p, r_g, m, v; got "
            + ", ".join(str(t.dtype) for t in ts)
        )
    if any(t.dim() != 3 for t in ts):
        raise ValueError("lowrank_adam_update_batched takes (B, ., .) stacks")
    b, d, n = w.shape
    r = p.shape[2]
    if p.shape != (b, d, r) or any(t.shape != (b, r, n) for t in (r_g, m, v)):
        raise ValueError(
            f"mismatched stacks: w {tuple(w.shape)}, p {tuple(p.shape)}, "
            f"r_g {tuple(r_g.shape)}, m {tuple(m.shape)}, v {tuple(v.shape)}"
        )
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("lowrank_adam_update_batched needs contiguous operands")
    if step < 1:
        raise ValueError(f"step is 1-indexed, got {step}")
    if w.numel() == 0 or r == 0:
        raise ValueError(f"empty stacks: w {tuple(w.shape)}, rank {r}")
    w_out = torch.empty_like(w)
    m_out = torch.empty_like(m)
    v_out = torch.empty_like(v)
    n_scr = torch.empty_like(m)
    bc1, bc2 = bias_corrections(b1, b2, step)
    with torch.cuda.device(w.device):
        err = build.entry("lowrank_adam")(
            w.data_ptr(), p.data_ptr(), r_g.data_ptr(), m.data_ptr(), v.data_ptr(),
            w_out.data_ptr(), m_out.data_ptr(), v_out.data_ptr(), n_scr.data_ptr(),
            _DTYPES[w.dtype], b, d, n, r,
            float(b1), 1.0 - b1, float(b2), 1.0 - b2, float(eps), bc1, bc2,
            float(lr_alpha), 1.0 - float(lr_wd),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, NAME)
    counters.LAUNCHES[NAME] += 1
    return w_out, m_out, v_out
