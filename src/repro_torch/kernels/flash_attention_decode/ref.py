"""Plain PyTorch paged decode attention (q_len = 1), from
``src/repro/kernels/flash_attention_decode/ref.py``.

Layout: q (B, 1, H, D); pages_k/v (P, ps, KVH, D) with page 0 the trash
page; page_table (B, MP) int32, token j of slot b in page
``page_table[b, j // ps]`` at offset ``j % ps``, -1 = unallocated; seq_lens
(B,) int32 counting the token being decoded.  Masking is
``kv_pos < seq_len`` plus the optional window; ``seq_len == 0`` gives zeros.
This version materialises the gathered (B, MP*ps, KVH, D) K/V, which the
CUDA kernel never does.
"""
from __future__ import annotations

import torch

NEG = -1e30


def paged_decode_attention_ref(
    q: torch.Tensor,  # (B, 1, H, D)
    pages_k: torch.Tensor,  # (P, ps, KVH, D)
    pages_v: torch.Tensor,
    page_table: torch.Tensor,  # (B, MP) int32
    seq_lens: torch.Tensor,  # (B,) int32
    *,
    window: int = 0,
) -> torch.Tensor:
    b, sq, h, d = q.shape
    if sq != 1:
        raise ValueError(f"paged decode attention requires q_len=1, got {sq}")
    _, ps, kvh, _ = pages_k.shape
    mp = page_table.shape[1]
    g = h // kvh
    scale = 1.0 / (d**0.5)

    safe = page_table.long().clamp(min=0)
    k = pages_k[safe].reshape(b, mp * ps, kvh, d)
    v = pages_v[safe].reshape(b, mp * ps, kvh, d)
    kv_pos = torch.arange(mp * ps, device=q.device)[None]
    lens = seq_lens.long()[:, None]
    allow = (kv_pos < lens) & torch.repeat_interleave(page_table >= 0, ps, dim=1)
    if window and window > 0:
        allow = allow & (kv_pos > lens - 1 - window)

    qg = q.reshape(b, kvh, g, d)
    logits = torch.einsum("bkgd,bskd->bkgs", qg.float(), k.float()) * scale
    mask = allow[:, None, None, :]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG))
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(logits - m), torch.zeros_like(logits))
    l = e.sum(dim=-1, keepdim=True)
    probs = e / l.clamp(min=1e-30)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v.float())
    return out.reshape(b, 1, h, d).to(q.dtype)
