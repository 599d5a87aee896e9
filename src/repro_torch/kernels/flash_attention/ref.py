"""Plain PyTorch flash-attention forward, from
``src/repro/kernels/flash_attention/ref.py``: exact softmax attention, GQA,
causal / window masking by position ``arange(Sq) + q_offset`` against
``arange(Sk)``."""
from __future__ import annotations

import torch

NEG = -1e30


def flash_attention_ref(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, KVH, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
) -> torch.Tensor:
    b, sq, h, d = q.shape
    _, sk, kvh, _ = k.shape
    g = h // kvh
    scale = 1.0 / (d**0.5)
    qg = q.reshape(b, sq, kvh, g, d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(sk, device=q.device)
    allow = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        allow &= kpos[None, :] <= qpos[:, None]
    if window:
        allow &= kpos[None, :] > qpos[:, None] - window
    logits = torch.where(allow, logits, torch.full_like(logits, NEG))
    probs = torch.softmax(logits, dim=-1)
    # probabilities in v's dtype, products accumulated in f32 (the JAX
    # einsum's preferred_element_type), output in q's dtype
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype).float(), v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)
