"""Blockwise 8-bit quantization of the 8-bit Adam state, from
``src/repro/kernels/lowrank_update/quantize.py`` (DESIGN.md §2.8), in plain
PyTorch.  The per-leaf inner (core/inner.py), the bucket layout's init
(core/buckets.py) and the plain version of the fused update (ref.py) use
it; the CUDA kernel (csrc/lowrank_adam8bit.cu) repeats its arithmetic.

Blocks are 256-element chunks within each row of the last axis; the last
chunk of a row may be short, and a block never crosses a row or a leading
dim.  So quantizing an (L, a, b) leaf equals quantizing its L slices, and
a bucket stack carries exactly the per-leaf codes and scales.

Signed values (the first moment) get linear codes, ``(c - 127) / 127 * s``;
unsigned values (the second moment) get sqrt-mapped codes,
``(c / 255)^2 * s``.  An all-zero chunk gets scale 1.0.  Rounding is
``torch.round``, half to even, as ``jnp.round``.

Every f32 step of the encoding is correctly rounded, as XLA's and the CUDA
kernel's (``__fdiv_rn``, ``__fsqrt_rn``) are, so the codes do not depend on
the backend (``_sqrt_rn``).

A row cut into blocks over processes (a moment whose last axis tensor
parallelism or FSDP splits) keeps the whole row's chunks: ``offset`` is
the block's first column's place in its chunk (its global start modulo
256), so local chunk c covers local columns [256 c - offset, 256 (c + 1) -
offset) and a block holds ``num_blocks(offset + n)`` scales.  A chunk that
straddles a block edge takes the absmax of the whole chunk: each process
writes its piece's (``chunk_absmax``), ``straddle_max`` takes the largest
over the processes that share the chunk, and the codes are made with the
given absmax (``absmax=``), so they equal one process's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

QBLOCK = 256


def num_blocks(row: int) -> int:
    """Blocks per row of length ``row`` (the last one possibly short)."""
    return -(-row // QBLOCK)


def _row_blocks(x: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """(..., n) -> (..., nb, QBLOCK), zero-padding ``offset`` columns before
    the row and the short final chunk after it."""
    n = x.shape[-1]
    nb = num_blocks(offset + n)
    pad = nb * QBLOCK - n - offset
    if pad or offset:
        x = torch.nn.functional.pad(x, (offset, pad))
    return x.reshape(tuple(x.shape[:-1]) + (nb, QBLOCK))


def _unblock(xb: torch.Tensor, n: int, offset: int = 0) -> torch.Tensor:
    """(..., nb, QBLOCK) -> (..., n), dropping the pad."""
    return xb.reshape(tuple(xb.shape[:-2]) + (-1,))[..., offset:offset + n]


def chunk_absmax(x: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """f32 absmax of each chunk's piece of the row, ``x.shape[:-1] + (nb,)``."""
    return _row_blocks(x.float(), offset).abs().amax(dim=-1)


def straddle_chunks(n: int, n_total: int) -> Tuple[int, ...]:
    """The global chunks that more than one block of ``n`` columns (of a row
    of ``n_total`` cut into equal blocks) touches."""
    return tuple(sorted({(j * n) // QBLOCK for j in range(1, n_total // n)
                         if (j * n) % QBLOCK}))


def straddle_max(absmax: torch.Tensor, start: int, n_total: int, axes) -> torch.Tensor:
    """``absmax`` (..., nb) of the block starting at global column ``start``,
    its straddling chunks replaced by their largest absmax over ``axes``
    (one MAX all-reduce of a (..., straddling chunks) buffer: zeros where a
    process does not touch the chunk, and an absmax is never below zero)."""
    n = n_total // axes.size
    shared = straddle_chunks(n, n_total)
    if not shared:
        return absmax
    first, nb = start // QBLOCK, absmax.shape[-1]
    mine = [(j, g - first) for j, g in enumerate(shared) if first <= g < first + nb]
    buf = absmax.new_zeros(tuple(absmax.shape[:-1]) + (len(shared),))
    for j, c in mine:
        buf[..., j] = absmax[..., c]
    axes.all_reduce_(buf, op="max")
    out = absmax.clone()
    for j, c in mine:
        out[..., c] = buf[..., j]
    return out


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root.  ATen's on the CPU is not
    (measured 1 ulp off on ~0.7% of the unit interval's values, on the
    AVX512, AVX2 and scalar paths alike), so there it runs in f64 and rounds
    to f32, which is exact for one square root of an f32 operand (53 >=
    2 * 24 + 2 bits).  CUDA's is IEEE-rounded (held by
    tests/test_torch_gpu.py), and an f64 pass over the 525 M-element
    ``embed`` and ``lm_head`` moments would cost the card ~10 ms a step."""
    if x.device.type == "cpu":
        return x.double().sqrt_().float()
    return torch.sqrt(x)


def quantize_blockwise(x: torch.Tensor, signed: bool, offset: int = 0,
                       absmax: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row-chunk absmax 8-bit quantization: ``(codes, scales)``, codes
    uint8 of ``x.shape``, scales f32 of ``x.shape[:-1] + (nb,)``; ``offset``
    and a given ``absmax`` per chunk as in the module docstring."""
    n = x.shape[-1]
    xb = _row_blocks(x.float(), offset)
    if absmax is None:
        absmax = xb.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax, torch.ones_like(absmax))
    rel = xb / scale[..., None]
    if signed:
        codes = (torch.clamp(torch.round(rel * 127.0), -127, 127) + 127).to(torch.uint8)
    else:
        rel = _sqrt_rn(torch.clamp(rel, 0.0, 1.0))
        codes = torch.clamp(torch.round(rel * 255.0), 0, 255).to(torch.uint8)
    codes = _unblock(codes, n, offset)
    # a padded row's codes view the padded buffer: copy them into storage of
    # their own, or the state would hold the pad (256 bytes for a 64-wide
    # norm's moments) that ``state_memory_bytes`` does not count
    return ((codes.clone(memory_format=torch.contiguous_format) if (n + offset) % QBLOCK
             or offset else codes), scale)


def dequantize_blockwise(codes: torch.Tensor, scale: torch.Tensor, signed: bool,
                         offset: int = 0) -> torch.Tensor:
    """Inverse map: uint8 codes and per-chunk scales -> f32 of codes.shape."""
    n = codes.shape[-1]
    cb = _row_blocks(codes.float(), offset)
    if signed:
        vals = (cb - 127.0) / 127.0 * scale[..., None]
    else:
        rel = cb / 255.0
        vals = rel * rel * scale[..., None]
    return _unblock(vals, n, offset)


# Bucket stacks hold moments in the canonical side='left' orientation
# (side='right' slices enter transposed), while blocks follow the per-leaf
# rows: a side='right' stack quantizes through a transpose.  Codes come back
# element-aligned with the canonical (B, r, n) stack; scales stay indexed by
# per-leaf row, (B, r, nb) for 'left' buckets and (B, n, nb_r) for 'right'.


def quantize_stacked(x: torch.Tensor, side: str, signed: bool, offset: int = 0,
                     absmax: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Canonical (B, r, n) f32 -> (canonical uint8 codes, per-leaf scales);
    ``offset`` and ``absmax`` ('left' only: a 'right' stack's chunks run
    along r, which no process cuts) as in ``quantize_blockwise``."""
    if side == "right":
        codes, scale = quantize_blockwise(x.transpose(-1, -2), signed)
        return codes.transpose(-1, -2).contiguous(), scale
    return quantize_blockwise(x, signed, offset, absmax)


def dequantize_stacked(codes: torch.Tensor, scale: torch.Tensor, side: str,
                       signed: bool, offset: int = 0) -> torch.Tensor:
    """Inverse of ``quantize_stacked``: canonical codes -> canonical f32."""
    if side == "right":
        return dequantize_blockwise(codes.transpose(-1, -2), scale, signed).transpose(-1, -2)
    return dequantize_blockwise(codes, scale, signed, offset)
