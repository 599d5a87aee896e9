"""Decoder-only transformer LM for the dense families (llama3, qwen2,
granite, nemotron), from ``src/repro/models/transformer.py``.

Parameters are plain dicts with the JAX tree's names and shapes; block
leaves carry a leading (L,) axis, and the layers run as a Python loop over
views of them.  ``loss_fn`` comes with the training slice.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L

Params = Dict[str, Any]

# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    """Ring-buffer KV cache.

    k, v : (L, B, C, KVH, D)  -- C = capacity.
    pos  : (B, C) int32       -- absolute position stored in each slot,
            -1 = never written; shared across layers.
    next_pos : (B,) int32     -- next absolute position to be written.
    """

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    next_pos: torch.Tensor


def init_kv_cache(cfg: ModelConfig, batch: int, capacity: int, *, device) -> KVCache:
    shape = (cfg.n_layers, batch, capacity, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=cfg.dtype, device=device),
        v=torch.zeros(shape, dtype=cfg.dtype, device=device),
        pos=torch.full((batch, capacity), -1, dtype=torch.int32, device=device),
        next_pos=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------


def init_params(
    gen: torch.Generator, cfg: ModelConfig, device: DeviceLike = "cuda"
) -> Params:
    """Random params in ``cfg.param_dtype`` with the JAX tree's layout.
    ``gen`` must live on ``device``."""
    dev = resolve_device(device)
    nl, d, qd, kvd = cfg.n_layers, cfg.d_model, cfg.q_dim, cfg.kv_dim
    dt = cfg.param_dtype
    o_scale = 1.0 / ((qd * 2 * nl) ** 0.5)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=dev)

    blocks = {
        "attn_norm": ones(nl, d),
        "q_proj": L.dense_init(gen, (nl, d, qd), dtype=dt, device=dev),
        "k_proj": L.dense_init(gen, (nl, d, kvd), dtype=dt, device=dev),
        "v_proj": L.dense_init(gen, (nl, d, kvd), dtype=dt, device=dev),
        "o_proj": L.dense_init(gen, (nl, qd, d), scale=o_scale, dtype=dt, device=dev),
        "mlp_norm": ones(nl, d),
        "mlp": L.init_mlp(gen, cfg, (nl,), device=dev),
    }
    if cfg.qkv_bias:
        blocks["q_bias"] = torch.zeros((nl, qd), dtype=dt, device=dev)
        blocks["k_bias"] = torch.zeros((nl, kvd), dtype=dt, device=dev)
        blocks["v_bias"] = torch.zeros((nl, kvd), dtype=dt, device=dev)
    params = {
        "embed": L.embed_init(gen, cfg.vocab_size, d, dt, device=dev),
        "blocks": blocks,
        "final_norm": ones(d),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(
            gen, (d, cfg.vocab_size), scale=0.02, dtype=dt, device=dev
        )
    return params


def serving_params(params: Params, cfg: ModelConfig) -> Params:
    """Cast the ``*_proj`` weights, the biases and ``embed`` to
    ``cfg.dtype`` once, where the JAX code casts ``p.astype(dt)`` before
    every product (transformer.py:135-144): the operands are the same,
    without re-casting every weight on every tick.  Norm scales stay f32
    (rmsnorm reads them as f32), and so does ``lm_head`` (or ``embed`` for
    tied configs), which the logits product reads in f32."""

    def cast(tree):
        out = {}
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                out[name] = cast(leaf)
            elif name.endswith(("_proj", "_bias")):
                out[name] = leaf.to(cfg.dtype)
            else:
                out[name] = leaf
        return out

    out = cast(params)
    if not cfg.tie_embeddings:
        out["embed"] = params["embed"].to(cfg.dtype)
    return out


def lm_head_matrix(params: Params, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def layer_params(blocks: Params, i: int) -> Params:
    """Layer ``i``'s view of the stacked (L, ...) block leaves."""
    return {
        k: layer_params(v, i) if isinstance(v, dict) else v[i]
        for k, v in blocks.items()
    }


# ---------------------------------------------------------------------------
# Attention sub-layer and dense block
# ---------------------------------------------------------------------------


def project_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """q (B,S,H,D), k/v (B,S,KVH,D) projections, before RoPE."""
    b, s, _ = x.shape
    dt = x.dtype
    q = x @ p["q_proj"].to(dt)
    k = x @ p["k_proj"].to(dt)
    v = x @ p["v_proj"].to(dt)
    if "q_bias" in p:
        q = q + p["q_bias"].to(dt)
        k = k + p["k_bias"].to(dt)
        v = v + p["v_bias"].to(dt)
    return (
        q.reshape(b, s, cfg.n_heads, cfg.head_dim),
        k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim),
        v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim),
    )


def attn_sublayer(
    p: Params,
    x: torch.Tensor,  # (B, S, D) normed input
    cfg: ModelConfig,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Self-attention; returns (attn_out (B,S,D), (k, v)) for cache fills."""
    b, s, _ = x.shape
    q, k, v = project_qkv(p, x, cfg)
    q = L.apply_rope(q, q_positions, cfg.rope_theta)
    k = L.apply_rope(k, q_positions, cfg.rope_theta)
    out = attn_lib.attention(
        q, k, v, q_positions, kv_positions,
        causal=causal, window=window, impl=cfg.attn_impl,
        chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv,
    )
    out = out.reshape(b, s, cfg.q_dim) @ p["o_proj"].to(x.dtype)
    return out, (k, v)


def dense_block(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    positions: torch.Tensor,
    kv_positions: torch.Tensor,
):
    """Pre-norm attention + MLP; returns (x, (k, v))."""
    h = L.rmsnorm(x, p["attn_norm"], cfg.rms_eps)
    attn_out, kv = attn_sublayer(
        p, h, cfg, positions, kv_positions, window=cfg.attn_window
    )
    x = x + attn_out
    h = L.rmsnorm(x, p["mlp_norm"], cfg.rms_eps)
    return x + L.apply_mlp(p["mlp"], h, cfg), kv


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def embed_tokens(params: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    rows = params["embed"].index_select(0, tokens.reshape(-1).long())
    return rows.reshape(*tokens.shape, -1).to(cfg.dtype)


def forward_hidden(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # (B, S)
    *,
    collect_kv: bool = False,
):
    """Embedding -> blocks -> final norm.  Returns (h, kvs) with kvs the
    stacked (L, B, S, KVH, D) K and V when ``collect_kv``."""
    h = embed_tokens(params, tokens, cfg)
    b, s, _ = h.shape
    positions = torch.arange(s, dtype=torch.int32, device=h.device).expand(b, s)
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    for i in range(cfg.n_layers):
        h, (k, v) = dense_block(
            layer_params(params["blocks"], i), h, cfg, positions, positions
        )
        if collect_kv:
            ks.append(k)
            vs.append(v)
    h = L.rmsnorm(h, params["final_norm"], cfg.rms_eps)
    kvs = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    return h, kvs


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------


def _fill_cache_from_kvs(
    cache: KVCache, kvs: Tuple[torch.Tensor, torch.Tensor], positions: torch.Tensor
) -> KVCache:
    """Insert prefill KVs (L,B,S,KVH,D) into slots [0, S) of a fresh cache;
    a windowed cache shorter than S keeps the last ``capacity`` positions."""
    k_new, v_new = kvs
    cap = cache.k.shape[2]
    if k_new.shape[2] > cap:
        k_new, v_new = k_new[:, :, -cap:], v_new[:, :, -cap:]
        positions = positions[:, -cap:]
    s = k_new.shape[2]
    cache.k[:, :, :s] = k_new
    cache.v[:, :, :s] = v_new
    cache.pos[:, :s] = positions.to(torch.int32)
    next_pos = (positions.amax(dim=1) + 1).to(torch.int32)
    return cache._replace(next_pos=next_pos)


def prefill(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    *,
    capacity: Optional[int] = None,
) -> Tuple[torch.Tensor, KVCache]:
    """Run the full prompt; return (last-token logits (B, V) f32, cache)."""
    h, kvs = forward_hidden(params, cfg, tokens, collect_kv=True)
    b, s, _ = h.shape
    cap = capacity or (cfg.attn_window if cfg.attn_window else s)
    cache = init_kv_cache(cfg, b, cap, device=h.device)
    positions = torch.arange(s, dtype=torch.int32, device=h.device).expand(b, s)
    cache = _fill_cache_from_kvs(cache, kvs, positions)
    logits = h[:, -1].float() @ lm_head_matrix(params, cfg).float()
    return logits, cache


def decode_step(
    params: Params,
    cfg: ModelConfig,
    cache: KVCache,
    token: torch.Tensor,  # (B, 1)
) -> Tuple[torch.Tensor, KVCache]:
    """One autoregressive step against the ring cache (B tokens at once).
    The given cache is left unchanged: the step writes into a copy."""
    b = token.shape[0]
    h = embed_tokens(params, token, cfg)
    q_pos = cache.next_pos[:, None]  # (B, 1)
    cap = cache.k.shape[2]
    rows = torch.arange(b, device=h.device)
    slot = (cache.next_pos % cap).long()  # ring write
    new_pos = cache.pos.clone()
    new_pos[rows, slot] = cache.next_pos
    k_all, v_all = cache.k.clone(), cache.v.clone()
    for i in range(cfg.n_layers):
        p = layer_params(params["blocks"], i)
        hnorm = L.rmsnorm(h, p["attn_norm"], cfg.rms_eps)
        q, k_new, v_new = project_qkv(p, hnorm, cfg)
        q = L.apply_rope(q, q_pos, cfg.rope_theta)
        k_new = L.apply_rope(k_new, q_pos, cfg.rope_theta)
        k_all[i, rows, slot] = k_new[:, 0]
        v_all[i, rows, slot] = v_new[:, 0]
        out = attn_lib.attention(
            q, k_all[i], v_all[i], q_pos, new_pos,
            causal=True, window=cfg.attn_window, impl="exact",
        )
        h = h + out.reshape(b, 1, cfg.q_dim) @ p["o_proj"].to(h.dtype)
        hnorm = L.rmsnorm(h, p["mlp_norm"], cfg.rms_eps)
        h = h + L.apply_mlp(p["mlp"], hnorm, cfg)
    h = L.rmsnorm(h, params["final_norm"], cfg.rms_eps)
    logits = h[:, 0].float() @ lm_head_matrix(params, cfg).float()
    return logits, KVCache(k=k_all, v=v_all, pos=new_pos, next_pos=cache.next_pos + 1)
