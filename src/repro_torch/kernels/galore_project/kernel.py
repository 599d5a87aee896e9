"""Wrapper of the CUDA batched projection (``csrc/galore_project.cu``).

Replaces the TPU kernel ``src/repro/kernels/galore_project/kernel.py::
galore_project_batched``.  The source's header says how the kernel is laid
out and what bounds it on the H100 (operations, at the training shapes).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, counters

NAME = "galore_project_batched"
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
    counters.LAUNCHES[NAME] += 1
    return out
