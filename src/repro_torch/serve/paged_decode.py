"""Paged prompt writer and decode step, from
``src/repro/serve/paged_decode.py``.

``write_prompt``    -- copy a batch-1 prefill cache (every prompt position,
                       absolute ``cache.pos``) into the slot's reserved pages.
``make_paged_step`` -- one decode step over all slots at once, the paged
                       twin of ``transformer.decode_step``: embed each slot's
                       last token, rope q/k at position ``seq_lens``, write
                       the new K/V into ``page_table[slot, seq_len // ps]``
                       (inactive slots write to the trash page), then paged
                       decode attention over the pool with ``seq_lens +
                       active`` so the fresh token is visible and empty
                       slots (len 0) yield zeros.

Where JAX scatters into a new pool (``.at[].set``, paged_decode.py:57-62
and 108-113), the port writes the pool in place with ``index_copy_``: the
pool is the engine's own state, and a copy per layer per tick would cost
its whole size.  Positions are absolute across prefill and decode, so RoPE
and masking match the ring-cache engine token for token.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import transformer as tfm

# Families whose decode runs on the page pool; the others keep a
# slot-batched native cache (serve/kv_cache.SlotCache).  vlm decode is
# token-only: its patches entered the pages at prefill.
PAGED_FAMILIES = ("dense", "moe", "vlm")


def write_prompt(
    pages_k: torch.Tensor,  # (L, P, ps, KVH, D), written in place
    pages_v: torch.Tensor,
    k_new: torch.Tensor,  # (L, S, KVH, D) roped prompt K (cache.k[:, 0])
    v_new: torch.Tensor,
    pos: torch.Tensor,  # (S,) absolute positions (cache.pos[0]), -1 = unwritten
    page_row: torch.Tensor,  # (MP,) the slot's page ids, -1 padded
) -> Tuple[torch.Tensor, torch.Tensor]:
    nl, p, ps, kvh, d = pages_k.shape
    pos = pos.long()
    page_of = page_row.long()[pos.clamp(min=0) // ps]  # admission covers S
    dst = torch.where(pos >= 0, page_of * ps + pos % ps, 0)  # -1 -> trash
    pages_k.view(nl, p * ps, kvh, d).index_copy_(1, dst, k_new.to(pages_k.dtype))
    pages_v.view(nl, p * ps, kvh, d).index_copy_(1, dst, v_new.to(pages_v.dtype))
    return pages_k, pages_v


def _paged_decode_step(
    params: Dict[str, Any],
    pages_k: torch.Tensor,  # (L, P, ps, KVH, D), written in place
    pages_v: torch.Tensor,
    page_table: torch.Tensor,  # (M, MP) int32
    seq_lens: torch.Tensor,  # (M,) int32 tokens already in pages
    active: torch.Tensor,  # (M,) bool slot liveness mask
    tokens: torch.Tensor,  # (M,) last sampled token per slot
    *,
    cfg: ModelConfig,
    mlp_fn=tfm.default_mlp_fn,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    m = tokens.shape[0]
    nl, p, ps, kvh, d = pages_k.shape
    mp = page_table.shape[1]

    h = tfm.embed_tokens(params, tokens[:, None], cfg)  # (M, 1, Dm)
    q_pos = seq_lens[:, None]  # the new token's absolute position
    rows = torch.arange(m, device=h.device)
    page_of = page_table[rows, (seq_lens // ps).clamp(0, mp - 1).long()]
    dest_page = torch.where(active & (page_of > 0), page_of, 0)
    dest = (dest_page * ps + seq_lens % ps).long()  # (M,) flat pool index
    attn_lens = seq_lens + active.to(torch.int32)  # incl. the new token

    for i in range(nl):
        bp = tfm.layer_params(params["blocks"], i)
        hnorm = L.rmsnorm(h, bp["attn_norm"], cfg.rms_eps)
        q, k_new, v_new = tfm.project_qkv(bp, hnorm, cfg)
        q = L.apply_rope(q, q_pos, cfg.rope_theta)
        k_new = L.apply_rope(k_new, q_pos, cfg.rope_theta)
        pk, pv = pages_k[i], pages_v[i]
        pk.view(p * ps, kvh, d).index_copy_(0, dest, k_new[:, 0].to(pk.dtype))
        pv.view(p * ps, kvh, d).index_copy_(0, dest, v_new[:, 0].to(pv.dtype))
        out = attn_lib.paged_decode_attention(
            q, pk, pv, page_table, attn_lens, window=cfg.attn_window
        )
        h = h + out.reshape(m, 1, cfg.q_dim) @ bp["o_proj"].to(h.dtype)
        hnorm = L.rmsnorm(h, bp["mlp_norm"], cfg.rms_eps)
        h = h + mlp_fn(bp, hnorm, cfg)[0]
    h = L.rmsnorm(h, params["final_norm"], cfg.rms_eps)
    logits = h[:, 0].float() @ tfm.lm_head_matrix(params, cfg).float()
    return logits, pages_k, pages_v


def make_paged_step(model):
    """``(params, pages_k, pages_v, page_table, seq_lens, active, tokens)
    -> (logits, pages_k, pages_v)`` for a model of ``PAGED_FAMILIES``; the
    MoE family's MLP is its routed experts (``moe.moe_mlp_fn``)."""
    cfg = model.cfg
    if cfg.family not in PAGED_FAMILIES:
        raise ValueError(
            f"family {cfg.family!r} has no paged decode path "
            f"(paged families: {PAGED_FAMILIES})"
        )
    mlp_fn = moe_lib.moe_mlp_fn if cfg.family == "moe" else tfm.default_mlp_fn
    return functools.partial(_paged_decode_step, cfg=cfg, mlp_fn=mlp_fn)
