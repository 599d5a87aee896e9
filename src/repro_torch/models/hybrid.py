"""Hymba-style hybrid blocks, from ``src/repro/models/hybrid.py``:
attention heads and SSM heads run in parallel on the same normed input,
their outputs are averaged (mean fusion), then a SwiGLU MLP follows.

Attention is sliding-window (``cfg.attn_window``): the KV cache is a ring
of ``attn_window`` positions, and the SSM half carries unbounded context
in O(1) state.  Decode writes the ring with a where-mask and attends over
it with exact attention, as JAX does (hybrid.py:159-214).

Under tensor parallelism the attention half goes through
``transformer.attn_sublayer`` (on this process's heads, or gathered and
replicated where the heads do not divide the ``model`` extent) and the
SSM half through ``ssm.apply_ssm_mixer`` (head-parallel or the whole
mixer); under FSDP ``_block`` gathers its layer first, inside the
recomputed region.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import parallel as par
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer as tfm

Params = Dict[str, Any]


class HybridCache(NamedTuple):
    k: torch.Tensor  # (L, B, W, KVH, D) ring buffer
    v: torch.Tensor
    pos: torch.Tensor  # (B, W) absolute position per slot, -1 = unwritten
    ssm: ssm_lib.SSMLayerCache  # stacked (L, ...) leaves
    next_pos: torch.Tensor  # (B,)


def init_blocks(gen: torch.Generator, cfg: ModelConfig, dev, put) -> Params:
    """A dense block (attention + SwiGLU MLP) plus ``ssm_mixer``."""
    blocks = tfm.init_dense_blocks(gen, cfg, dev, put)
    blocks["ssm_mixer"] = ssm_lib.init_ssm_mixer(gen, cfg, (cfg.n_layers,), dev, put)
    return blocks


def init_params(gen: torch.Generator, cfg: ModelConfig, device="cuda", *, serving=False):
    return tfm.init_params(gen, cfg, device, serving=serving, init_blocks=init_blocks)


def _block(p: Params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
           collect_cache: bool = False):
    """One hybrid block; with ``collect_cache`` also (k, v) and the
    layer's SSM cache (final state, conv tail from the last K-1 normed
    inputs, hybrid.py:88-98)."""
    p = par.gather_layer(p)
    hn = L.rmsnorm(x, p["attn_norm"], cfg.rms_eps)
    attn_out, kv = tfm.attn_sublayer(p, hn, cfg, positions, positions, window=cfg.attn_window)
    if collect_cache:
        ssm_out, state = ssm_lib.apply_ssm_mixer(p["ssm_mixer"], hn, cfg, return_state=True)
    else:
        ssm_out = ssm_lib.apply_ssm_mixer(p["ssm_mixer"], hn, cfg)
    y = x + 0.5 * (attn_out + ssm_out)
    h2 = L.rmsnorm(y, p["mlp_norm"], cfg.rms_eps)
    y = y + L.apply_mlp(p["mlp"], h2, cfg)
    if not collect_cache:
        return y
    tail = ssm_lib.conv_tail(p["ssm_mixer"], hn, cfg)
    return y, kv, ssm_lib.SSMLayerCache(conv=tail, state=state)


def forward_hidden(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   collect_cache: bool = False):
    """Returns (h, caches): caches is ((k, v) stacked (L, B, S, KVH, D),
    the stacked SSM layer caches) when ``collect_cache``, else None."""
    h = tfm.embed_tokens(params, tokens, cfg)
    b, s, _ = h.shape
    positions = torch.arange(s, dtype=torch.int32, device=h.device).expand(b, s)
    remat = cfg.remat == "block" and not collect_cache and torch.is_grad_enabled()
    ks, vs, ssm_caches = [], [], []
    for p in tfm.unbind_layers(params["blocks"], cfg.n_layers):
        if collect_cache:
            h, (k, v), lc = _block(p, h, cfg, positions, True)
            ks.append(k)
            vs.append(v)
            ssm_caches.append(lc)
        elif remat:
            h = checkpoint(_block, p, h, cfg, positions, use_reentrant=False)
        else:
            h = _block(p, h, cfg, positions)
    h = L.rmsnorm(h, params["final_norm"], cfg.rms_eps)
    if not collect_cache:
        return h, None
    return h, ((torch.stack(ks), torch.stack(vs)), ssm_lib.stack_layer_caches(ssm_caches))


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """Next-token loss: (loss, {"loss", "tokens"}), as JAX's (no aux)."""
    h, _ = forward_hidden(params, cfg, batch["tokens"])
    loss, n_tok = L.chunked_cross_entropy(
        h, tfm.lm_head_matrix(params, cfg), batch["labels"], cfg.loss_chunk,
        vocab=cfg.vocab_size)
    return loss, {"loss": loss, "tokens": n_tok}


def tp_comm_bytes(cfg: ModelConfig, rows: int, seq: int, tp: int, act_bytes: int) -> int:
    """hymba's bytes over ``model`` in a hot step (``models.tp_hot_comm_bytes``):
    per layer the attention, the mixer and the MLP."""
    tok = rows * seq
    return (cfg.n_layers * (tfm.tp_attn_bytes(cfg, tok, tp, act_bytes)
                            + ssm_lib.tp_mixer_bytes(cfg, tok, tp, act_bytes, rec_out=True)
                            + tfm.tp_mlp_bytes(cfg, tok, tp, act_bytes))
            + tfm.tp_lm_bytes(cfg, rows, seq, tp, act_bytes))


def init_cache(cfg: ModelConfig, batch: int, capacity: int = 0, *, device) -> HybridCache:
    w = cfg.attn_window or capacity
    shape = (cfg.n_layers, batch, w, cfg.n_kv_heads, cfg.head_dim)
    return HybridCache(
        k=torch.zeros(shape, dtype=cfg.dtype, device=device),
        v=torch.zeros(shape, dtype=cfg.dtype, device=device),
        pos=torch.full((batch, w), -1, dtype=torch.int32, device=device),
        ssm=ssm_lib.init_layer_cache(cfg, batch, (cfg.n_layers,), device=device),
        next_pos=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor, capacity: int = 0):
    """The prompt's last ``min(S, W)`` K/V into ring slots [0, keep) with
    their absolute positions (hybrid.py:127-151), and the SSM caches."""
    b, s = tokens.shape
    h, ((k_all, v_all), ssm_caches) = forward_hidden(params, cfg, tokens, collect_cache=True)
    cache = init_cache(cfg, b, capacity, device=h.device)
    keep = min(s, cache.k.shape[2])
    cache.k[:, :, :keep] = k_all[:, :, s - keep:]
    cache.v[:, :, :keep] = v_all[:, :, s - keep:]
    cache.pos[:, :keep] = torch.arange(s - keep, s, dtype=torch.int32, device=h.device)
    logits = h[:, -1].float() @ tfm.lm_head_matrix(params, cfg).float()
    return logits, cache._replace(
        ssm=ssm_caches, next_pos=torch.full((b,), s, dtype=torch.int32, device=h.device))


def decode_step(params: Params, cfg: ModelConfig, cache: HybridCache, token: torch.Tensor):
    """One token per row: the ring written at ``next_pos % W``, exact
    windowed attention over it, the SSM's recurrent step, the mean, then
    the MLP.  The given cache is left unchanged."""
    b = token.shape[0]
    h = tfm.embed_tokens(params, token, cfg)
    q_pos = cache.next_pos[:, None]
    cap = cache.k.shape[2]
    rows = torch.arange(b, device=h.device)
    slot = (cache.next_pos % cap).long()
    new_pos = cache.pos.clone()
    new_pos[rows, slot] = cache.next_pos
    k_all, v_all = cache.k.clone(), cache.v.clone()
    ssm_caches = []
    for i in range(cfg.n_layers):
        p = tfm.layer_params(params["blocks"], i)
        hn = L.rmsnorm(h, p["attn_norm"], cfg.rms_eps)
        q, k_new, v_new = tfm.project_qkv(p, hn, cfg)
        q = L.apply_rope(q, q_pos, cfg.rope_theta)
        k_new = L.apply_rope(k_new, q_pos, cfg.rope_theta)
        k_all[i, rows, slot] = k_new[:, 0]
        v_all[i, rows, slot] = v_new[:, 0]
        attn = attn_lib.attention(
            q, k_all[i], v_all[i], q_pos, new_pos,
            causal=True, window=cfg.attn_window, impl="exact",
        )
        attn_out = attn.reshape(b, 1, cfg.q_dim) @ p["o_proj"].to(h.dtype)
        lc = ssm_lib.SSMLayerCache(conv=cache.ssm.conv[i], state=cache.ssm.state[i])
        ssm_out, new_lc = ssm_lib.decode_ssm_mixer(p["ssm_mixer"], hn, lc, cfg)
        ssm_caches.append(new_lc)
        h = h + 0.5 * (attn_out + ssm_out)
        hn = L.rmsnorm(h, p["mlp_norm"], cfg.rms_eps)
        h = h + L.apply_mlp(p["mlp"], hn, cfg)
    h = L.rmsnorm(h, params["final_norm"], cfg.rms_eps)
    logits = h[:, 0].float() @ tfm.lm_head_matrix(params, cfg).float()
    return logits, HybridCache(k=k_all, v=v_all, pos=new_pos,
                               ssm=ssm_lib.stack_layer_caches(ssm_caches),
                               next_pos=cache.next_pos + 1)
