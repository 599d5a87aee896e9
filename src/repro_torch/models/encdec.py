"""Whisper-style encoder-decoder backbone (whisper-medium), from
``src/repro/models/encdec.py``.

The conv / log-mel audio frontend is a stub: the caller supplies
precomputed frame embeddings (B, enc_frames, d_model).  Sinusoidal
positions are added to the encoder input and its self-attention is
non-causal without RoPE; the decoder has RoPE self-attention (JAX's
deviation from Whisper's learned positions, kept) and cross-attention into
the encoder output (no rotation, no mask: every query sees every frame).
On the card both attentions go to the flash kernel, the cross one with Sq
decoder tokens against Sk frames (``models/attention.py``).

Decode caches the decoder's self-attention ring and the per-layer cross
K/V, computed once from the encoder output at prefill.

Under tensor parallelism both stacks' self-attention and MLP are the
dense ones (``transformer.attn_sublayer``, ``layers.apply_mlp``), and the
cross-attention runs on this process's heads (``transformer._attn_tp``:
``cross_q`` from the decoder through its columns, ``cross_k`` and
``cross_v`` from the encoder's output, ``cross_o`` row-parallel with one
f32 all-reduce), or gathered and replicated where the heads do not divide
the ``model`` extent.  whisper's odd vocabulary keeps ``embed`` and
``lm_head`` whole over ``model``.  Under FSDP each block gathers its layer
first (``parallel.gather_layer``, under ``['enc_blocks']`` or
``['blocks']``), inside the recomputed region, and the loss gathers
``lm_head`` (``transformer.lm_head_matrix``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import parallel as par
from repro_torch.models import transformer as tfm

Params = Dict[str, Any]


class EncDecCache(NamedTuple):
    k: torch.Tensor  # (Ld, B, C, KVH, D) decoder self-attention ring
    v: torch.Tensor
    pos: torch.Tensor  # (B, C)
    cross_k: torch.Tensor  # (Ld, B, F, KVH, D)
    cross_v: torch.Tensor
    next_pos: torch.Tensor  # (B,)


def sinusoidal_positions(length: int, d: int, device=None) -> torch.Tensor:
    """(length, d) f32: sines then cosines of position / 10000^(2i/d)."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    inv = torch.exp(-math.log(10000.0) * dim / d)
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[:, :d]


def init_dec_blocks(gen: torch.Generator, cfg: ModelConfig, dev, put) -> Params:
    """The stacked decoder blocks: a dense block plus ``cross_norm`` and
    the ``cross_{q,k,v,o}_proj`` of its cross-attention."""
    nl, d, qd, kvd = cfg.n_layers, cfg.d_model, cfg.q_dim, cfg.kv_dim
    blocks = tfm.init_dense_blocks(gen, cfg, dev, put)
    o_scale = 1.0 / ((qd * 2 * nl) ** 0.5)
    blocks["cross_norm"] = torch.ones((nl, d), dtype=cfg.param_dtype, device=dev)
    for name, shape, scale in (("cross_q_proj", (nl, d, qd), None),
                               ("cross_k_proj", (nl, d, kvd), None),
                               ("cross_v_proj", (nl, d, kvd), None),
                               ("cross_o_proj", (nl, qd, d), o_scale)):
        blocks[name] = put.dense(name, gen, shape, scale, device=dev)
    return blocks


def init_params(gen: torch.Generator, cfg: ModelConfig, device: DeviceLike = "cuda", *,
                serving: bool = False) -> Params:
    """Random params with the JAX tree's layout: ``embed``, ``enc_blocks``
    (``n_enc_layers`` dense blocks), ``enc_final_norm``, the decoder
    ``blocks``, ``final_norm`` and ``lm_head``; ``serving`` as in
    ``transformer.init_params``."""
    dev = resolve_device(device)
    put = tfm.LeafMaker(cfg, serving)
    d, dt = cfg.d_model, cfg.param_dtype
    embed = put("embed", L.embed_init(gen, cfg.vocab_size, d, dt, device=dev))
    enc_blocks = tfm.init_dense_blocks(gen, cfg, dev, put, n_layers=cfg.n_enc_layers)
    blocks = init_dec_blocks(gen, cfg, dev, put)
    return {
        "embed": embed,
        "enc_blocks": enc_blocks,
        "enc_final_norm": torch.ones((d,), dtype=dt, device=dev),
        "blocks": blocks,
        "final_norm": torch.ones((d,), dtype=dt, device=dev),
        "lm_head": L.dense_init(gen, (d, cfg.vocab_size), scale=0.02, dtype=dt, device=dev),
    }


def _enc_block(p: Params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    p = par.gather_layer(p, "['enc_blocks']")
    hn = L.rmsnorm(x, p["attn_norm"], cfg.rms_eps)
    attn_out, _ = tfm.attn_sublayer(p, hn, cfg, positions, positions, causal=False, rope=False)
    x = x + attn_out
    hn = L.rmsnorm(x, p["mlp_norm"], cfg.rms_eps)
    return x + L.apply_mlp(p["mlp"], hn, cfg)


def encode(params: Params, cfg: ModelConfig, frame_embeds: torch.Tensor) -> torch.Tensor:
    """frame_embeds (B, F, D), the stubbed frontend's output -> encoder
    states (B, F, D)."""
    b, f, d = frame_embeds.shape
    h = frame_embeds.to(cfg.dtype)
    h = h + sinusoidal_positions(f, d, h.device).to(cfg.dtype)[None]
    positions = torch.arange(f, dtype=torch.int32, device=h.device).expand(b, f)
    remat = cfg.remat == "block" and torch.is_grad_enabled()
    for p in tfm.unbind_layers(params["enc_blocks"], cfg.n_enc_layers):
        if remat:
            h = checkpoint(_enc_block, p, h, cfg, positions, use_reentrant=False)
        else:
            h = _enc_block(p, h, cfg, positions)
    return L.rmsnorm(h, params["enc_final_norm"], cfg.rms_eps)


def _cross_sublayer(p: Params, x: torch.Tensor, cfg: ModelConfig, enc_out=None,
                    cross_kv=None):
    """Cross-attention: q from the decoder, k and v from the encoder output
    (or ``cross_kv``, cached); returns (out (B, S, D), (k, v)).  Under
    tensor parallelism (``enc_out`` given) on this process's heads, or
    with the split leaves gathered (module docstring)."""
    b, s, _ = x.shape
    dt = x.dtype
    ax = par.model_axes()
    if ax is not None and cross_kv is None:
        if cfg.n_heads % ax.size == 0:  # no mask: the positions do not enter
            qpos = torch.zeros((b, s), dtype=torch.int32, device=x.device)
            kpos = torch.zeros((b, enc_out.shape[1]), dtype=torch.int32, device=x.device)
            return tfm._attn_tp(p, x, cfg, ax, qpos, kpos, False, 0, False, kv_x=enc_out,
                                prefix="cross_")
        p = tfm.gathered_attn_leaves(p, cfg, ax, prefix="cross_")
    q = (x @ p["cross_q_proj"].to(dt)).reshape(b, s, cfg.n_heads, cfg.head_dim)
    if cross_kv is None:
        f = enc_out.shape[1]
        k = (enc_out @ p["cross_k_proj"].to(dt)).reshape(b, f, cfg.n_kv_heads, cfg.head_dim)
        v = (enc_out @ p["cross_v_proj"].to(dt)).reshape(b, f, cfg.n_kv_heads, cfg.head_dim)
    else:
        k, v = cross_kv
        f = k.shape[1]
    # no mask: positions do not enter (JAX passes zeros)
    qpos = torch.zeros((b, s), dtype=torch.int32, device=x.device)
    kpos = torch.zeros((b, f), dtype=torch.int32, device=x.device)
    out = attn_lib.attention(
        q, k, v, qpos, kpos, causal=False, impl=cfg.attn_impl,
        chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv,
    )
    return out.reshape(b, s, cfg.q_dim) @ p["cross_o_proj"].to(dt), (k, v)


def _dec_block(p: Params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
               enc_out: torch.Tensor):
    p = par.gather_layer(p)
    hn = L.rmsnorm(x, p["attn_norm"], cfg.rms_eps)
    attn_out, kv = tfm.attn_sublayer(p, hn, cfg, positions, positions)
    x = x + attn_out
    hn = L.rmsnorm(x, p["cross_norm"], cfg.rms_eps)
    cross_out, cross_kv = _cross_sublayer(p, hn, cfg, enc_out=enc_out)
    x = x + cross_out
    hn = L.rmsnorm(x, p["mlp_norm"], cfg.rms_eps)
    return x + L.apply_mlp(p["mlp"], hn, cfg), kv, cross_kv


def decoder_hidden(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   enc_out: torch.Tensor, collect_kv: bool = False):
    """Returns (h, kvs): kvs = ((self K, self V), (cross K, cross V)), each
    stacked over the decoder layers, when ``collect_kv``; each block is
    recomputed in backward under ``remat == "block"`` unless it collects."""
    h = tfm.embed_tokens(params, tokens, cfg)
    b, s, _ = h.shape
    positions = torch.arange(s, dtype=torch.int32, device=h.device).expand(b, s)
    remat = cfg.remat == "block" and not collect_kv and torch.is_grad_enabled()
    kvs: List[List[torch.Tensor]] = [[], [], [], []]
    for p in tfm.unbind_layers(params["blocks"], cfg.n_layers):
        if remat:
            h, _, _ = checkpoint(_dec_block, p, h, cfg, positions, enc_out,
                                 use_reentrant=False)
        else:
            h, (k, v), (ck, cv) = _dec_block(p, h, cfg, positions, enc_out)
            if collect_kv:
                for acc, t in zip(kvs, (k, v, ck, cv)):
                    acc.append(t)
    h = L.rmsnorm(h, params["final_norm"], cfg.rms_eps)
    if not collect_kv:
        return h, None
    k, v, ck, cv = (torch.stack(t) for t in kvs)
    return h, ((k, v), (ck, cv))


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    enc_out = encode(params, cfg, batch["frame_embeds"])
    h, _ = decoder_hidden(params, cfg, batch["tokens"], enc_out)
    loss, n_tok = L.chunked_cross_entropy(h, tfm.lm_head_matrix(params, cfg), batch["labels"],
                                          cfg.loss_chunk, vocab=cfg.vocab_size)
    return loss, {"loss": loss, "tokens": n_tok}


def tp_comm_bytes(cfg: ModelConfig, rows: int, seq: int, tp: int, act_bytes: int) -> int:
    """whisper's bytes over ``model`` in a hot step (``models.tp_hot_comm_bytes``):
    per decoder layer the self-attention, the cross-attention (plus its
    encoder input's gradient) and the MLP; per encoder layer the attention
    and the MLP over the frames."""
    tok, frames = rows * seq, rows * cfg.enc_frames
    dec = (tfm.tp_attn_bytes(cfg, tok, tp, act_bytes, bias=cfg.qkv_bias)
           + tfm.tp_attn_bytes(cfg, tok, tp, act_bytes, kv_tok=frames)
           + tfm.tp_mlp_bytes(cfg, tok, tp, act_bytes))
    enc = (tfm.tp_attn_bytes(cfg, frames, tp, act_bytes, bias=cfg.qkv_bias)
           + tfm.tp_mlp_bytes(cfg, frames, tp, act_bytes))
    return (cfg.n_layers * dec + cfg.n_enc_layers * enc
            + tfm.tp_lm_bytes(cfg, rows, seq, tp, act_bytes))


def init_cache(cfg: ModelConfig, batch: int, capacity: int, *, device) -> EncDecCache:
    """A fresh cache: an empty ring and zero cross K/V for ``enc_frames``
    frames (JAX ``model_zoo._encdec_cache``)."""
    base = tfm.init_kv_cache(cfg, batch, capacity, device=device)
    shape = (cfg.n_layers, batch, cfg.enc_frames, cfg.n_kv_heads, cfg.head_dim)
    return EncDecCache(
        k=base.k, v=base.v, pos=base.pos,
        cross_k=torch.zeros(shape, dtype=cfg.dtype, device=device),
        cross_v=torch.zeros(shape, dtype=cfg.dtype, device=device),
        next_pos=base.next_pos,
    )


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            frame_embeds: torch.Tensor, capacity: Optional[int] = None):
    """Encode the frames, run the decoder prompt; return (last-token logits
    (B, V) f32, cache with the prompt's ring and every layer's cross K/V)."""
    enc_out = encode(params, cfg, frame_embeds)
    h, ((k_self, v_self), (cross_k, cross_v)) = decoder_hidden(
        params, cfg, tokens, enc_out, collect_kv=True)
    b, s = tokens.shape
    cache = tfm.init_kv_cache(cfg, b, capacity or s, device=h.device)
    positions = torch.arange(s, dtype=torch.int32, device=h.device).expand(b, s)
    base = tfm._fill_cache_from_kvs(cache, (k_self, v_self), positions)
    logits = h[:, -1].float() @ tfm.lm_head_matrix(params, cfg).float()
    return logits, EncDecCache(k=base.k, v=base.v, pos=base.pos, cross_k=cross_k,
                               cross_v=cross_v, next_pos=base.next_pos)


def decode_step(params: Params, cfg: ModelConfig, cache: EncDecCache, token: torch.Tensor):
    """One step for B slots: the ring write and exact self-attention, as
    ``transformer.decode_step``, then cross-attention from the cached K/V.
    The given cache is left unchanged: the step writes into a copy of the
    ring (the cross K/V are shared)."""
    b = token.shape[0]
    h = tfm.embed_tokens(params, token, cfg)
    q_pos = cache.next_pos[:, None]
    cap = cache.k.shape[2]
    rows = torch.arange(b, device=h.device)
    slot = (cache.next_pos % cap).long()
    new_pos = cache.pos.clone()
    new_pos[rows, slot] = cache.next_pos
    k_all, v_all = cache.k.clone(), cache.v.clone()
    for i in range(cfg.n_layers):
        p = tfm.layer_params(params["blocks"], i)
        hn = L.rmsnorm(h, p["attn_norm"], cfg.rms_eps)
        q, k_new, v_new = tfm.project_qkv(p, hn, cfg)
        q = L.apply_rope(q, q_pos, cfg.rope_theta)
        k_new = L.apply_rope(k_new, q_pos, cfg.rope_theta)
        k_all[i, rows, slot] = k_new[:, 0]
        v_all[i, rows, slot] = v_new[:, 0]
        out = attn_lib.attention(q, k_all[i], v_all[i], q_pos, new_pos, causal=True,
                                 impl="exact")
        h = h + out.reshape(b, 1, cfg.q_dim) @ p["o_proj"].to(h.dtype)
        hn = L.rmsnorm(h, p["cross_norm"], cfg.rms_eps)
        h = h + _cross_sublayer(p, hn, cfg, cross_kv=(cache.cross_k[i], cache.cross_v[i]))[0]
        hn = L.rmsnorm(h, p["mlp_norm"], cfg.rms_eps)
        h = h + L.apply_mlp(p["mlp"], hn, cfg)
    h = L.rmsnorm(h, params["final_norm"], cfg.rms_eps)
    logits = h[:, 0].float() @ tfm.lm_head_matrix(params, cfg).float()
    return logits, EncDecCache(k=k_all, v=v_all, pos=new_pos, cross_k=cache.cross_k,
                               cross_v=cache.cross_v, next_pos=cache.next_pos + 1)
