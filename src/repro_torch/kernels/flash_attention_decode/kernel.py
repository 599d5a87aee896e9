"""Wrapper of the CUDA paged decode attention (``csrc/paged_decode.cu``).

Replaces the TPU kernel ``src/repro/kernels/flash_attention_decode/
kernel.py::paged_decode_attention_kernel``.  The source's header says how
the kernel is laid out and what bounds it on the H100 (bytes): one cluster
launch whose ``cluster_size`` blocks split each slot's visible tokens and
merge their partials in distributed shared memory.  It has two designs,
picked here by ``design``: bf16 with a head dim that is a multiple of 16 and
at most 16 query heads per KV head on the tensor cores, the rest on the
CUDA cores.  Unlike the JAX dispatch
(``ops.py:30-31``), which sends unaligned shapes to the plain version, this
takes any page size >= 1 and any head dim up to 256 that is a multiple of 8,
and raises on anything else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, counters

NAME = "paged_decode_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 32  # tokens: no cluster is larger than a slot's capacity has tiles
CLUSTER_SIZES = (1, 2, 4, 8)  # the portable cluster sizes
DESIGNS = ("cuda_cores", "tensor_cores")  # as the C entry point numbers them


def design(dtype: torch.dtype, d: int, g: int, aligned: bool = True, rows: int = 0) -> str:
    """The kernel's design: bf16 with ``d % 16 == 0``, at most 16 query
    heads per KV head, q and both pools on 16 bytes and fewer than 2^31
    pool rows (``P * ps``: it indexes rows in 32 bits) run on the tensor
    cores; everything else on the CUDA cores."""
    if dtype == torch.bfloat16 and d % 16 == 0 and g <= 16 and aligned and rows < 2**31:
        return "tensor_cores"
    return "cuda_cores"


def cluster_size(b: int, kvh: int, capacity: int, max_clusters: dict) -> int:
    """Blocks per (slot, KV head), from the batch, the KV heads, a slot's
    capacity ``MP * ps`` and ``max_clusters`` (cluster size -> how many such
    clusters of the kernel the card runs at once; ``card_clusters``).  The
    grid is (CS, KVH, B) in clusters of (CS, 1, 1): CS is the largest
    portable cluster size whose B * KVH clusters all run at once, and no
    larger than the capacity has tiles to share."""
    tiles = -(-capacity // TILE)
    cs = 1
    while (cs < CLUSTER_SIZES[-1] and b * kvh <= max_clusters[2 * cs]
           and 2 * cs <= tiles):
        cs *= 2
    return cs


@functools.lru_cache(maxsize=None)
def card_clusters(dtype: torch.dtype, h: int, kvh: int, d: int, how: str,
                  device: int) -> dict:
    """Cluster size -> how many clusters of that size the current card runs
    at once, for the kernel these shapes and this design launch (the CUDA
    occupancy query: it counts the SMs of each GPC, which clusters may not
    straddle)."""
    out = {}
    for cs in CLUSTER_SIZES:
        n = ctypes.c_int(0)
        err = build.entry("paged_decode_max_clusters")(
            _DTYPES[dtype], h, kvh, d, cs, DESIGNS.index(how), ctypes.addressof(n))
        build.check(err, NAME + " occupancy query")
        out[cs] = n.value
    return out


def paged_decode_attention_kernel(
    q: torch.Tensor,  # (B, 1, H, D)
    pages_k: torch.Tensor,  # (P, ps, KVH, D)
    pages_v: torch.Tensor,
    page_table: torch.Tensor,  # (B, MP) int32
    seq_lens: torch.Tensor,  # (B,) int32
    *,
    window: int = 0,
) -> torch.Tensor:
    ts = (q, pages_k, pages_v, page_table, seq_lens)
    if not all(t.is_cuda and t.device == q.device for t in ts):
        raise ValueError("paged decode attention needs every input on one CUDA device")
    if q.dtype not in _DTYPES or pages_k.dtype != q.dtype or pages_v.dtype != q.dtype:
        raise TypeError(
            f"paged decode attention takes one of f32/bf16, got {q.dtype}, "
            f"{pages_k.dtype}, {pages_v.dtype}"
        )
    if page_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("page_table and seq_lens must be int32")
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"paged decode attention requires q (B,1,H,D), got {tuple(q.shape)}")
    b, _, h, d = q.shape
    if pages_k.dim() != 4 or pages_k.shape != pages_v.shape:
        raise ValueError("pages_k and pages_v must both be (P, ps, KVH, D)")
    _, ps, kvh, pd = pages_k.shape
    if pd != d or kvh < 1 or h % kvh or h // kvh > 32:
        raise ValueError(f"q {tuple(q.shape)} does not fit pages {tuple(pages_k.shape)}")
    if not (8 <= d <= 256 and d % 8 == 0) or ps < 1:
        raise ValueError(f"unsupported head_dim {d} / page size {ps}")
    if page_table.dim() != 2 or page_table.shape[0] != b or seq_lens.shape != (b,):
        raise ValueError("page_table must be (B, MP) and seq_lens (B,)")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("paged decode attention needs contiguous inputs")
    out = torch.empty_like(q)
    mp = page_table.shape[1]
    if out.numel() == 0 or mp == 0:
        return out.zero_()
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, pages_k, pages_v))
    how = design(q.dtype, d, h // kvh, aligned, pages_k.shape[0] * ps)
    with torch.cuda.device(q.device):
        err = build.entry("paged_decode")(
            q.data_ptr(), pages_k.data_ptr(), pages_v.data_ptr(),
            page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, h, kvh, d, ps, mp, int(window),
            cluster_size(b, kvh, mp * ps, card_clusters(q.dtype, h, kvh, d, how, q.device.index)),
            DESIGNS.index(how), 1.0 / d**0.5,
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, NAME)
    counters.bump(NAME)
    return out
