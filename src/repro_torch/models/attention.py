"""Attention implementations, from ``src/repro/models/attention.py``.

  * ``exact``   -- materializes (B, H, Sq, Sk) logits: short sequences,
    the ring-cache decode, and the test oracle.
  * ``chunked`` -- online-softmax over (chunk_q, chunk_kv) blocks.
  * the flash kernel -- ``impl="auto"`` (or ``"pallas"``, kept as an
    alias) on a CUDA tensor sends prefill to the hand-written kernel in
    ``kernels/flash_attention``.  That kernel derives positions from
    ``arange`` and ignores the position arguments, so only contiguous
    self-attention may reach it (``forward_hidden``; the ring-cache
    ``decode_step`` asks for ``exact``).  On the CPU, ``auto`` picks exact
    or chunked by size as the JAX dispatch does.

GQA layout: q (B, Sq, H, D), k/v (B, Sk, KVH, D) with H = G * KVH.
Masking is positional: causal = kv_pos <= q_pos, a window also requires
kv_pos > q_pos - window, and a negative kv_pos marks an unwritten slot.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention_decode import ops as fad_ops

_NEG = -1e30


def _mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool, window: int) -> torch.Tensor:
    """(B, Sq, Sk) boolean allow-mask."""
    qp = q_pos[:, :, None]
    kp = kv_pos[:, None, :]
    m = kp >= 0
    if causal:
        m = m & (kp <= qp)
    if window and window > 0:
        m = m & (kp > qp - window)
    return m


def exact_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    b, sq, h, d = q.shape
    _, sk, kvh, _ = k.shape
    g = h // kvh
    scale = 1.0 / (d**0.5)
    qg = q.reshape(b, sq, kvh, g, d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    allow = _mask(q_positions, kv_positions, causal, window)[:, None, None]
    logits = torch.where(allow, logits, torch.full_like(logits, _NEG))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype).float(), v.float())
    return out.reshape(b, sq, h, d).to(v.dtype)


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    chunk_q: int = 512,
    chunk_kv: int = 1024,
) -> torch.Tensor:
    """Exact attention with O(chunk_q * chunk_kv) transient memory.  Every
    KV block is computed: a block past the causal diagonal adds exactly
    zero, so the JAX version's block skip changes no bit of the output."""
    b, sq, h, d = q.shape
    _, sk, kvh, _ = k.shape
    g = h // kvh
    scale = 1.0 / (d**0.5)
    cq, ck = min(chunk_q, sq), min(chunk_kv, sk)
    outs = []
    for qs in range(0, sq, cq):
        qi = q[:, qs:qs + cq].reshape(b, -1, kvh, g, d).float()
        qpi = q_positions[:, qs:qs + cq]
        n = qi.shape[1]
        m_run = torch.full((b, kvh, g, n), _NEG, device=q.device)
        l_run = torch.zeros((b, kvh, g, n), device=q.device)
        acc = torch.zeros((b, kvh, g, n, d), device=q.device)
        for ks in range(0, sk, ck):
            ki, vi = k[:, ks:ks + ck], v[:, ks:ks + ck]
            logits = torch.einsum("bqkgd,bskd->bkgqs", qi, ki.float()) * scale
            allow = _mask(qpi, kv_positions[:, ks:ks + ck], causal, window)
            logits = torch.where(
                allow[:, None, None], logits, torch.full_like(logits, _NEG)
            )
            m_new = torch.maximum(m_run, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = corr * l_run + p.sum(dim=-1)
            pv = torch.einsum(
                "bkgqs,bskd->bkgqd", p.to(vi.dtype).float(), vi.float()
            ).to(vi.dtype)  # the JAX einsum's output dtype
            acc = corr[..., None] * acc + pv.float()
            m_run = m_new
        out = (acc / l_run.clamp(min=1e-30)[..., None]).to(q.dtype)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, n, h, d))
    return torch.cat(outs, dim=1)


def paged_decode_attention(
    q: torch.Tensor,  # (B, 1, H, D) -- one query per decode slot
    pages_k: torch.Tensor,  # (P, ps, KVH, D) shared page pool
    pages_v: torch.Tensor,
    page_table: torch.Tensor,  # (B, MP) int32, -1 = unallocated
    seq_lens: torch.Tensor,  # (B,) int32, incl. the token being decoded
    *,
    window: int = 0,
) -> torch.Tensor:
    """Decode-shaped attention, K/V read through the page table: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if q.shape[1] != 1:
        raise ValueError(f"paged_decode_attention requires q_len=1, got {q.shape[1]}")
    return fad_ops.paged_decode_attention(
        q, pages_k, pages_v, page_table, seq_lens, window=window
    )


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    impl: str = "auto",
    chunk_q: int = 512,
    chunk_kv: int = 1024,
) -> torch.Tensor:
    sq, sk = q.shape[1], k.shape[1]
    if impl == "pallas" or (impl == "auto" and q.is_cuda):
        if q.is_cuda and sq != sk:
            raise ValueError(
                f"the flash kernel serves contiguous self-attention (Sq == Sk), "
                f"got Sq={sq}, Sk={sk}: pass impl='exact' or 'chunked'"
            )
        return fa_ops.flash_attention(
            q, k, v, q_positions, kv_positions, causal=causal, window=window
        )
    if impl == "auto":
        # exact materializes (B,H,Sq,Sk) logits: small products and decode
        impl = "exact" if sq == 1 or sq * sk <= 2048 * 2048 else "chunked"
    if impl == "exact":
        return exact_attention(
            q, k, v, q_positions, kv_positions, causal=causal, window=window
        )
    if impl == "chunked":
        return chunked_attention(
            q, k, v, q_positions, kv_positions,
            causal=causal, window=window, chunk_q=chunk_q, chunk_kv=chunk_kv,
        )
    raise ValueError(f"unknown attention impl {impl!r}")
