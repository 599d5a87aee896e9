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

``gather`` (every wrapper) is the split schedule of ZeRO state on the FSDP
step: r_g and the moments are this process's rows, w and p every row of
its block; the moments pass runs on the rows (the update's C entry with
W null), ``gather`` takes their N to every row, and the back-projection
runs on all of them (``repro_lowrank_backproject``), counted as one call.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels import build, counters
from repro_torch.kernels.lowrank_update.quantize import QBLOCK, num_blocks
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
           stacks: Sequence[torch.Tensor], others: Sequence[torch.Tensor] = (),
           rows=None):
    """Device, dtype, shape and layout checks shared by the wrappers:
    ``stacks`` are the f32 (B, r, n) operands -- (``rows``, r, n) in the
    split schedule, where w and p hold every row; ``others`` are checked
    for device and contiguity only.  Returns (B, d, n, r)."""
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
    want = (b if rows is None else rows, r, n)
    if p.shape != (b, d, r) or any(t.shape != want for t in stacks):
        raise ValueError(
            f"mismatched stacks: w {tuple(w.shape)}, p {tuple(p.shape)}, "
            + ", ".join(str(tuple(t.shape)) for t in stacks)
        )
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name} needs contiguous operands")
    if w.numel() == 0 or r == 0:
        raise ValueError(f"empty stacks: w {tuple(w.shape)}, rank {r}")
    return b, d, n, r


def _backproject(n_rows: torch.Tensor, gather, w: torch.Tensor, p: torch.Tensor,
                 w_out: torch.Tensor, lr_alpha: float, lr_wd: float) -> int:
    """The split schedule's second half: N of this process's rows gathered
    to every row of the block, then W' = (1 - lr_wd) W - lr_alpha P @ N
    into ``w_out``; returns the launch's cudaError_t."""
    b, d, n = w.shape
    n_dir = gather(n_rows).contiguous()
    if tuple(n_dir.shape) != (b,) + tuple(n_rows.shape[1:]):
        raise ValueError(f"the gathered N is {tuple(n_dir.shape)}, the block has {b} rows")
    return build.entry("lowrank_backproject")(
        w.data_ptr(), p.data_ptr(), n_dir.data_ptr(), w_out.data_ptr(), _DTYPES[w.dtype], b, d,
        n, p.shape[2], float(lr_alpha), 1.0 - float(lr_wd), _stream())


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
    gather=None,
):
    """Returns (W' in W's dtype, M', V'), all new tensors (``gather``: the
    module docstring)."""
    rows = r_g.shape[0]
    b, d, n, r = _check(NAME, w, p, (r_g, m, v), rows=rows if gather else None)
    _check_step(step)
    w_out = torch.empty_like(w)
    m_out = torch.empty_like(m)
    v_out = torch.empty_like(v)
    n_scr = torch.empty_like(m)
    bc1, bc2 = bias_corrections(b1, b2, step)
    fn = build.entry("lowrank_adam")
    hyper = (float(b1), 1.0 - b1, float(b2), 1.0 - b2, float(eps), bc1, bc2,
             float(lr_alpha), 1.0 - float(lr_wd), _stream())
    with torch.cuda.device(w.device):
        if gather is None:
            err = fn(w.data_ptr(), p.data_ptr(), r_g.data_ptr(), m.data_ptr(), v.data_ptr(),
                     w_out.data_ptr(), m_out.data_ptr(), v_out.data_ptr(), n_scr.data_ptr(),
                     _DTYPES[w.dtype], b, d, n, r, *hyper)
        else:
            err = fn(None, None, r_g.data_ptr(), m.data_ptr(), v.data_ptr(), None,
                     m_out.data_ptr(), v_out.data_ptr(), n_scr.data_ptr(),
                     _DTYPES[w.dtype], rows, d, n, r, *hyper)
            if err == 0:
                err = _backproject(n_scr, gather, w, p, w_out, lr_alpha, lr_wd)
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
    gather=None,
):
    """Returns (W' in W's dtype, M'), new tensors (``gather``: the module
    docstring)."""
    rows = r_g.shape[0]
    b, d, n, r = _check(MSGD_NAME, w, p, (r_g, m), rows=rows if gather else None)
    w_out = torch.empty_like(w)
    m_out = torch.empty_like(m)
    fn = build.entry("lowrank_msgd")
    hyper = (float(b1), 1.0 - b1, float(lr_alpha), 1.0 - float(lr_wd), _stream())
    with torch.cuda.device(w.device):
        if gather is None:
            err = fn(w.data_ptr(), p.data_ptr(), r_g.data_ptr(), m.data_ptr(),
                     w_out.data_ptr(), m_out.data_ptr(), _DTYPES[w.dtype], b, d, n, r, *hyper)
        else:
            err = fn(None, None, r_g.data_ptr(), m.data_ptr(), None, m_out.data_ptr(),
                     _DTYPES[w.dtype], rows, d, n, r, *hyper)
            if err == 0:
                err = _backproject(m_out, gather, w, p, w_out, lr_alpha, lr_wd)
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
    axes=None,
    n_total: int = 0,
    gather=None,
):
    """Returns (W' in W's dtype, M', v'), new tensors.  v' and the
    direction's denominator come from plain PyTorch reductions
    (``adam_mini_stats_ref``: on a 'left' stack whose n ``axes`` cut, the
    row sums summed over them), as JAX computes them outside its kernel;
    ``gather`` as in the module docstring."""
    code = _check_side(side)
    nrow = r_g.shape[0]
    b, d, n, r = _check(ADAM_MINI_NAME, w, p, (r_g, m), (v,), rows=nrow if gather else None)
    rows = r if side == "left" else n
    if v.dtype != torch.float32 or v.shape != (nrow, rows):
        raise ValueError(f"adam_mini v must be f32 {(nrow, rows)} on side {side!r}, "
                         f"got {v.dtype} {tuple(v.shape)}")
    _check_step(step)
    v_new, den = adam_mini_stats_ref(r_g, v, step, b2=b2, eps=eps, side=side, axes=axes,
                                     n_total=n_total)
    den = den.reshape(nrow, rows).contiguous()
    w_out = torch.empty_like(w)
    m_out = torch.empty_like(m)
    n_scr = torch.empty_like(m)
    fn = build.entry("lowrank_adam_mini")
    hyper = (code, float(b1), 1.0 - b1, bias_correction(b1, step),
             float(lr_alpha), 1.0 - float(lr_wd), _stream())
    with torch.cuda.device(w.device):
        if gather is None:
            err = fn(w.data_ptr(), p.data_ptr(), r_g.data_ptr(), m.data_ptr(), den.data_ptr(),
                     w_out.data_ptr(), m_out.data_ptr(), n_scr.data_ptr(),
                     _DTYPES[w.dtype], b, d, n, r, *hyper)
        else:
            err = fn(None, None, r_g.data_ptr(), m.data_ptr(), den.data_ptr(), None,
                     m_out.data_ptr(), n_scr.data_ptr(), _DTYPES[w.dtype], nrow, d, n, r,
                     *hyper)
            if err == 0:
                err = _backproject(n_scr, gather, w, p, w_out, lr_alpha, lr_wd)
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
    qoff: int = 0,
    reduce=None,
    gather=None,
):
    """Returns (W' in W's dtype, m codes, m scales, v codes, v scales), new
    tensors.  Every shape launches (a short final chunk is masked).  A
    'left' block of cut rows (``quantize.py``): ``qoff`` is its first
    column's place in its chunk, and ``reduce`` (the whole chunk's absmax
    from each piece's, ``quantize.straddle_max``) runs between the absmax
    launch and the main one, which quantizes with what it returns;
    ``gather`` as in the module docstring."""
    code = _check_side(side)
    if code == 1 and (qoff or reduce is not None):
        raise ValueError("a 'right' bucket's chunks run along r, which no process cuts")
    if not 0 <= qoff < QBLOCK:
        raise ValueError(f"qoff is a column's place in its chunk, got {qoff}")
    rows = r_g.shape[0]
    b, d, n, r = _check(ADAM8BIT_NAME, w, p, (r_g,), (m_codes, m_scale, v_codes, v_scale),
                        rows=rows if gather else None)
    sshape = (rows, r, num_blocks(qoff + n)) if side == "left" else (rows, n, num_blocks(r))
    for c in (m_codes, v_codes):
        if c.dtype != torch.uint8 or c.shape != (rows, r, n):
            raise ValueError(f"adam8bit codes must be uint8 {(rows, r, n)}, "
                             f"got {c.dtype} {tuple(c.shape)}")
    for s in (m_scale, v_scale):
        if s.dtype != torch.float32 or s.shape != sshape:
            raise ValueError(f"adam8bit scales must be f32 {sshape} on side {side!r}, "
                             f"got {s.dtype} {tuple(s.shape)}")
    _check_step(step)
    w_out = torch.empty_like(w)
    outs = [torch.empty_like(t) for t in (m_codes, m_scale, v_codes, v_scale)]
    n_scr = torch.empty_like(r_g)
    bc1, bc2 = bias_corrections(b1, b2, step)
    fn = build.entry("lowrank_adam8bit")
    state = tuple(t.data_ptr() for t in (r_g, m_codes, m_scale, v_codes, v_scale))
    hyper = (float(b1), 1.0 - b1, float(b2), 1.0 - b2, float(eps), bc1, bc2,
             float(lr_alpha), 1.0 - float(lr_wd), _stream())
    dt = _DTYPES[w.dtype]
    with torch.cuda.device(w.device):
        given = (None, None)
        err = 0
        if reduce is not None:
            am, av = torch.empty_like(m_scale), torch.empty_like(v_scale)
            err = fn(None, None, *state, None, *(None,) * 4, None, None, None,
                     am.data_ptr(), av.data_ptr(), dt, rows, d, n, r, code, qoff, *hyper)
            if err == 0:
                am, av = reduce(am).contiguous(), reduce(av).contiguous()
                given = (am.data_ptr(), av.data_ptr())
        if err == 0 and gather is None:
            err = fn(w.data_ptr(), p.data_ptr(), *state, w_out.data_ptr(),
                     *(t.data_ptr() for t in outs), n_scr.data_ptr(), *given, None, None,
                     dt, b, d, n, r, code, qoff, *hyper)
        elif err == 0:
            err = fn(None, None, *state, None, *(t.data_ptr() for t in outs),
                     n_scr.data_ptr(), *given, None, None, dt, rows, d, n, r, code, qoff,
                     *hyper)
            if err == 0:
                err = _backproject(n_scr, gather, w, p, w_out, lr_alpha, lr_wd)
    build.check(err, ADAM8BIT_NAME)
    counters.bump(ADAM8BIT_NAME)
    return (w_out, *outs)
