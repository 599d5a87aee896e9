"""Wrapper of the CUDA power-iteration step (``csrc/power_iter.cu``).

Replaces the TPU kernel ``src/repro/kernels/power_iter/kernel.py::
power_iter_batched``.  The source's header says how the kernel is laid out
and what bounds it on the H100 (operations).  Unlike the JAX dispatch,
which sends an intermediate Z = G^T Q above 6 MB to the plain version (a
TPU VMEM budget, ``ops.py:26, 45-47``), this takes every shape: Z lives in
an f32 scratch allocated here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, counters

NAME = "power_iter_batched"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def power_iter_batched(g: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Y = G (G^T Q) per slice: g (B, m, n) f32/bf16, q (B, m, k') f32 ->
    (B, m, k') f32, contiguous on one CUDA device."""
    if not (g.is_cuda and q.is_cuda and g.device == q.device):
        raise ValueError("power_iter_batched needs g and q on one CUDA device")
    if g.dtype not in _DTYPES or q.dtype != torch.float32:
        raise TypeError(
            f"power_iter_batched takes g f32/bf16 and q f32, got {g.dtype}, {q.dtype}"
        )
    if g.dim() != 3 or q.dim() != 3 or q.shape[:2] != g.shape[:2]:
        raise ValueError(
            f"want g (B, m, n) and q (B, m, k'); got {tuple(g.shape)}, {tuple(q.shape)}"
        )
    if not (g.is_contiguous() and q.is_contiguous()):
        raise ValueError("power_iter_batched needs contiguous g and q")
    b, m, n = g.shape
    kp = q.shape[2]
    y = torch.empty((b, m, kp), dtype=torch.float32, device=g.device)
    if y.numel() == 0:
        return y
    if n == 0:
        return y.zero_()
    z = torch.empty((b, n, kp), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        err = build.entry("power_iter")(
            g.data_ptr(), q.data_ptr(), z.data_ptr(), y.data_ptr(),
            _DTYPES[g.dtype], b, m, n, kp, torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, NAME)
    counters.bump(NAME)
    return y
