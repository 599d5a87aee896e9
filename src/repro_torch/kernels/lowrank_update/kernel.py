"""Wrappers of the CUDA fused low-rank updates, one per inner optimizer:

  * ``lowrank_adam_update_batched``      (``csrc/lowrank_adam.cu``)
  * ``lowrank_msgd_update_batched``      (``csrc/lowrank_msgd.cu``)
  * ``lowrank_adam_mini_update_batched`` (``csrc/lowrank_adam_mini.cu``)
  * ``lowrank_adam8bit_update_batched``  (``csrc/lowrank_adam8bit.cu``)

They replace the TPU kernels of the same names in
``src/repro/kernels/lowrank_update/kernel.py``.  Each source's header says
how its kernel is laid out (a moments pass, then the back-projection
product of ``csrc/lowrank_apply.cuh`` with W' in its epilogue) and what
bounds it on the H100 (operations).  The plain versions are in ``ref.py``.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels import build, counters
from repro_torch.kernels.lowrank_update.quantize import num_blocks
from repro_torch.kernels.lowrank_update.ref import (
    adam_mini_stats_ref,
    bias_correction,
    bias_corrections,
)

NAME = "lowrank_adam_update_batched"
MSGD_NAME = "lowrank_msgd_update_batched"
ADAM_MINI_NAME = "lowrank_adam_mini_update_batched"
ADAM8BIT_NAME = "lowrank_adam8bit_update_batched"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIDES = {"left": 0, "right": 1}


def _check(name: str, w: torch.Tensor, p: torch.Tensor,
           stacks: Sequence[torch.Tensor], others: Sequence[torch.Tensor] = ()):
    """Device, dtype, shape and layout checks shared by the wrappers:
    ``stacks`` are the f32 (B, r, n) operands; ``others`` are checked for
    device and contiguity only.  Returns (B, d, n, r)."""
    ts = (w, p, *stacks, *others)
    if not all(t.is_cuda and t.device == w.device for t in ts):
        raise ValueError(f"{name} needs every operand on one CUDA device")
    if w.dtype not in _DTYPES or any(t.dtype != torch.float32 for t in (p, *stacks)):
        raise TypeError(
            f"{name} takes w f32/bf16 and f32 p and (B, r, n) stacks; got "
            + ", ".join(str(t.dtype) for t in ts)
        )
    if any(t.dim() != 3 for t in (w, p, *stacks)):
        raise ValueError(f"{name} takes (B, ., .) stacks")
    b, d, n = w.shape
    r = p.shape[2]
    if p.shape != (b, d, r) or any(t.shape != (b, r, n) for t in stacks):
        raise ValueError(
            f"mismatched stacks: w {tuple(w.shape)}, p {tuple(p.shape)}, "
            + ", ".join(str(tuple(t.shape)) for t in stacks)
        )
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name} needs contiguous operands")
    if w.numel() == 0 or r == 0:
        raise ValueError(f"empty stacks: w {tuple(w.shape)}, rank {r}")
    return b, d, n, r


def _check_step(step: int) -> None:
    if step < 1:
        raise ValueError(f"step is 1-indexed, got {step}")


def _check_side(side: str) -> int:
    if side not in _SIDES:
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    return _SIDES[side]


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


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
    b, d, n, r = _check(NAME, w, p, (r_g, m, v))
    _check_step(step)
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
            float(lr_alpha), 1.0 - float(lr_wd), _stream(),
        )
    build.check(err, NAME)
    counters.bump(NAME)
    return w_out, m_out, v_out


def lowrank_msgd_update_batched(
    w: torch.Tensor,  # (B, d, n) f32/bf16
    p: torch.Tensor,  # (B, d, r) f32
    r_g: torch.Tensor,  # (B, r, n) f32
    m: torch.Tensor,  # (B, r, n) f32
    lr_alpha: float,
    lr_wd: float = 0.0,
    *,
    b1: float = 0.9,
):
    """Returns (W' in W's dtype, M'), new tensors."""
    b, d, n, r = _check(MSGD_NAME, w, p, (r_g, m))
    w_out = torch.empty_like(w)
    m_out = torch.empty_like(m)
    with torch.cuda.device(w.device):
        err = build.entry("lowrank_msgd")(
            w.data_ptr(), p.data_ptr(), r_g.data_ptr(), m.data_ptr(),
            w_out.data_ptr(), m_out.data_ptr(), _DTYPES[w.dtype], b, d, n, r,
            float(b1), 1.0 - b1, float(lr_alpha), 1.0 - float(lr_wd), _stream(),
        )
    build.check(err, MSGD_NAME)
    counters.bump(MSGD_NAME)
    return w_out, m_out


def lowrank_adam_mini_update_batched(
    w: torch.Tensor,  # (B, d, n) f32/bf16
    p: torch.Tensor,  # (B, d, r) f32
    r_g: torch.Tensor,  # (B, r, n) f32
    m: torch.Tensor,  # (B, r, n) f32
    v: torch.Tensor,  # (B, r) 'left' | (B, n) 'right', f32
    step: int,
    lr_alpha: float,
    lr_wd: float = 0.0,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    side: str = "left",
):
    """Returns (W' in W's dtype, M', v'), new tensors.  v' and the
    direction's denominator come from plain PyTorch reductions
    (``adam_mini_stats_ref``), as JAX computes them outside its kernel."""
    code = _check_side(side)
    b, d, n, r = _check(ADAM_MINI_NAME, w, p, (r_g, m), (v,))
    rows = r if side == "left" else n
    if v.dtype != torch.float32 or v.shape != (b, rows):
        raise ValueError(f"adam_mini v must be f32 {(b, rows)} on side {side!r}, "
                         f"got {v.dtype} {tuple(v.shape)}")
    _check_step(step)
    v_new, den = adam_mini_stats_ref(r_g, v, step, b2=b2, eps=eps, side=side)
    den = den.reshape(b, rows).contiguous()
    w_out = torch.empty_like(w)
    m_out = torch.empty_like(m)
    n_scr = torch.empty_like(m)
    with torch.cuda.device(w.device):
        err = build.entry("lowrank_adam_mini")(
            w.data_ptr(), p.data_ptr(), r_g.data_ptr(), m.data_ptr(), den.data_ptr(),
            w_out.data_ptr(), m_out.data_ptr(), n_scr.data_ptr(),
            _DTYPES[w.dtype], b, d, n, r, code,
            float(b1), 1.0 - b1, bias_correction(b1, step),
            float(lr_alpha), 1.0 - float(lr_wd), _stream(),
        )
    build.check(err, ADAM_MINI_NAME)
    counters.bump(ADAM_MINI_NAME)
    return w_out, m_out, v_new


def lowrank_adam8bit_update_batched(
    w: torch.Tensor,  # (B, d, n) f32/bf16
    p: torch.Tensor,  # (B, d, r) f32
    r_g: torch.Tensor,  # (B, r, n) f32
    m_codes: torch.Tensor,  # (B, r, n) uint8
    m_scale: torch.Tensor,  # (B, r, nb) 'left' | (B, n, nb_r) 'right', f32
    v_codes: torch.Tensor,  # (B, r, n) uint8
    v_scale: torch.Tensor,
    step: int,
    lr_alpha: float,
    lr_wd: float = 0.0,
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    side: str = "left",
):
    """Returns (W' in W's dtype, m codes, m scales, v codes, v scales), new
    tensors.  Every shape launches (a short final chunk is masked)."""
    code = _check_side(side)
    b, d, n, r = _check(ADAM8BIT_NAME, w, p, (r_g,), (m_codes, m_scale, v_codes, v_scale))
    sshape = (b, r, num_blocks(n)) if side == "left" else (b, n, num_blocks(r))
    for c in (m_codes, v_codes):
        if c.dtype != torch.uint8 or c.shape != (b, r, n):
            raise ValueError(f"adam8bit codes must be uint8 {(b, r, n)}, "
                             f"got {c.dtype} {tuple(c.shape)}")
    for s in (m_scale, v_scale):
        if s.dtype != torch.float32 or s.shape != sshape:
            raise ValueError(f"adam8bit scales must be f32 {sshape} on side {side!r}, "
                             f"got {s.dtype} {tuple(s.shape)}")
    _check_step(step)
    outs = [torch.empty_like(t) for t in (w, m_codes, m_scale, v_codes, v_scale)]
    n_scr = torch.empty_like(r_g)
    bc1, bc2 = bias_corrections(b1, b2, step)
    with torch.cuda.device(w.device):
        err = build.entry("lowrank_adam8bit")(
            w.data_ptr(), p.data_ptr(), r_g.data_ptr(), m_codes.data_ptr(),
            m_scale.data_ptr(), v_codes.data_ptr(), v_scale.data_ptr(),
            *(t.data_ptr() for t in outs), n_scr.data_ptr(),
            _DTYPES[w.dtype], b, d, n, r, code,
            float(b1), 1.0 - b1, float(b2), 1.0 - b2, float(eps), bc1, bc2,
            float(lr_alpha), 1.0 - float(lr_wd), _stream(),
        )
    build.check(err, ADAM8BIT_NAME)
    counters.bump(ADAM8BIT_NAME)
    return tuple(outs)
