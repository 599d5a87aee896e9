"""Decoder-only transformer LM for the dense families (llama3, qwen2,
granite, nemotron), from ``src/repro/models/transformer.py``, and the
scaffolding the MoE and hybrid families reuse: the attention block's
init, ``attn_sublayer`` (windowed for hymba), and the ``mlp_fn`` hook of
the forward, loss, prefill and decode (MoE's routed experts).

Parameters are plain dicts with the JAX tree's names and shapes; block
leaves carry a leading (L,) axis, and the layers run as a Python loop over
views of them.

Under tensor parallelism (``models/parallel.py``) each process holds the
blocks the name-based rules give it (``launch/sharding.param_spec``):
``embed_tokens`` is vocab-parallel, ``attn_sublayer`` computes this
process's query heads and the KV heads their GQA groups read
(``_attn_heads``), and ``loss_fn``'s ``lm_head`` is split on the vocab.
The rules split columns, not heads, and leave narrow leaves whole: a leaf
whose block is not this process's heads is gathered on use, and a whole
leaf gives this process its columns.  The SSM, hybrid, enc-dec and VLM
families build on these (``ssm.py``, ``hybrid.py``, ``encdec.py``'s
cross-attention through ``_attn_tp``, ``vlm.py``'s adapter).  Under
``cfg.remat == "block"`` each block is recomputed in backward
(``torch.utils.checkpoint``), as the JAX scan body is
(``transformer.py:232-233``).

Under FSDP (``models/parallel.DataShards``: the standard step at a
``data`` extent above 1) each process holds its ``data`` block of every
leaf the rules put on ``data``: ``dense_block`` gathers its layer's
blocks first (``parallel.gather_layer``), inside the recomputed region,
and ``embed_tokens`` and ``lm_head_matrix`` gather ``embed`` and
``lm_head`` where they use them; each gradient comes back as this
process's block of the sum over ``data``.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import parallel as par

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


_ATTN_BIASES = ("q_bias", "k_bias", "v_bias")


def serving_dtype(name: str, dtype: torch.dtype, cfg: ModelConfig) -> torch.dtype:
    """The serving dtype of a leaf named ``name`` that is made in ``dtype``:
    ``*_proj`` weights (expert stacks included), the attention biases and
    ``embed`` in ``cfg.dtype``; norm scales, the MoE router and the SSM's
    conv, decay, step (``dt_bias``) and skip parameters stay as they are
    (JAX reads them in f32 or casts them per use), and so does ``lm_head``
    (or ``embed`` for tied configs), which the logits product reads in
    f32."""
    if name.endswith("_proj") or name in _ATTN_BIASES or (
            name == "embed" and not cfg.tie_embeddings):
        return cfg.dtype
    return dtype


def serving_leaf(name: str, leaf: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One leaf in its serving dtype (``serving_dtype``)."""
    return leaf.to(serving_dtype(name, leaf.dtype, cfg))


class LeafMaker:
    """``put(name, leaf)``: the leaf as made, or in its serving dtype
    (``serving_leaf``) when ``serving``.  ``put.dense(name, gen, shape,
    scale, device)`` draws a ``dense_init`` leaf straight into its stored
    dtype, one slice of a stacked leaf at a time: a serving init never
    holds a whole stacked leaf in f32, and draws the very numbers of the
    f32 init (``init(gen, serving=True)`` equals ``serving_params(init(gen))``
    bit for bit)."""

    def __init__(self, cfg: ModelConfig, serving: bool):
        self.cfg = cfg
        self.serving = serving

    def __call__(self, name: str, leaf: torch.Tensor) -> torch.Tensor:
        return serving_leaf(name, leaf, self.cfg) if self.serving else leaf

    def dense(self, name: str, gen: torch.Generator, shape, scale=None, device=None):
        dt = self.cfg.param_dtype
        out = serving_dtype(name, dt, self.cfg) if self.serving else dt
        return L.dense_init(gen, shape, scale=scale, dtype=dt, device=device, out_dtype=out)


def init_attn_block(gen: torch.Generator, cfg: ModelConfig, dev: torch.device,
                    put: LeafMaker, n_layers: Optional[int] = None) -> Params:
    """The stacked (L, ...) attention half of a block, as the JAX
    ``init_block`` makes it: both norms and the q/k/v/o projections (and
    biases).  ``n_layers`` stacks another count than ``cfg.n_layers``
    (whisper's encoder), with the same init scales."""
    nl, d, qd, kvd = n_layers or cfg.n_layers, cfg.d_model, cfg.q_dim, cfg.kv_dim
    dt = cfg.param_dtype
    o_scale = 1.0 / ((qd * 2 * cfg.n_layers) ** 0.5)
    blocks = {
        "attn_norm": torch.ones((nl, d), dtype=dt, device=dev),
        "q_proj": put.dense("q_proj", gen, (nl, d, qd), device=dev),
        "k_proj": put.dense("k_proj", gen, (nl, d, kvd), device=dev),
        "v_proj": put.dense("v_proj", gen, (nl, d, kvd), device=dev),
        "o_proj": put.dense("o_proj", gen, (nl, qd, d), o_scale, device=dev),
        "mlp_norm": torch.ones((nl, d), dtype=dt, device=dev),
    }
    if cfg.qkv_bias:
        for name, width in (("q_bias", qd), ("k_bias", kvd), ("v_bias", kvd)):
            blocks[name] = put(name, torch.zeros((nl, width), dtype=dt, device=dev))
    return blocks


def init_dense_blocks(gen: torch.Generator, cfg: ModelConfig, dev: torch.device,
                      put: LeafMaker, n_layers: Optional[int] = None) -> Params:
    blocks = init_attn_block(gen, cfg, dev, put, n_layers)
    blocks["mlp"] = L.init_mlp(gen, cfg, (n_layers or cfg.n_layers,), put, device=dev)
    return blocks


def init_params(
    gen: torch.Generator, cfg: ModelConfig, device: DeviceLike = "cuda", *,
    serving: bool = False, init_blocks=init_dense_blocks,
) -> Params:
    """Random params in ``cfg.param_dtype`` with the JAX tree's layout.
    ``gen`` must live on ``device``.  ``serving`` casts each leaf to its
    serving dtype as it is made (``LeafMaker``).  ``init_blocks(gen, cfg,
    dev, put)`` makes the stacked block leaves (the family's: dense, MoE,
    SSM or hybrid)."""
    dev = resolve_device(device)
    put = LeafMaker(cfg, serving)
    blocks = init_blocks(gen, cfg, dev, put)
    d, dt = cfg.d_model, cfg.param_dtype
    params = {
        "embed": put("embed", L.embed_init(gen, cfg.vocab_size, d, dt, device=dev)),
        "blocks": blocks,
        "final_norm": torch.ones((d,), dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(
            gen, (d, cfg.vocab_size), scale=0.02, dtype=dt, device=dev
        )
    return params


def serving_params(params: Params, cfg: ModelConfig) -> Params:
    """Every leaf in its serving dtype (``serving_leaf``), cast once where
    the JAX code casts ``p.astype(dt)`` before every product
    (transformer.py:135-144): the operands are the same, without re-casting
    every weight on every tick.  Params made with ``serving=True`` pass
    through."""

    def cast(tree):
        return {
            name: cast(leaf) if isinstance(leaf, dict) else serving_leaf(name, leaf, cfg)
            for name, leaf in tree.items()
        }

    return cast(params)


def lm_head_matrix(params: Params, cfg: ModelConfig) -> torch.Tensor:
    """The (d, vocab) output matrix, whole over ``data`` (FSDP)."""
    if cfg.tie_embeddings:
        return par.gather_leaf(params["embed"], "['embed']").T
    return par.gather_leaf(params["lm_head"], "['lm_head']")


def layer_params(blocks: Params, i: int) -> Params:
    """Layer ``i``'s view of the stacked (L, ...) block leaves."""
    return {
        k: layer_params(v, i) if isinstance(v, dict) else v[i]
        for k, v in blocks.items()
    }


def unbind_layers(blocks: Params, n_layers: int) -> List[Params]:
    """Every layer's views of the stacked block leaves, one ``unbind`` per
    leaf.  Its backward stacks the L gradient slices once; indexing each
    layer (``layer_params``) would instead add up L full-size, zero-padded
    (L, ...) gradients per leaf in backward."""
    out: List[Params] = [{} for _ in range(n_layers)]
    for k, v in blocks.items():
        parts = unbind_layers(v, n_layers) if isinstance(v, dict) else torch.unbind(v, 0)
        for i in range(n_layers):
            out[i][k] = parts[i]
    return out


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


def _cols(w: torch.Tensor, full: int, lo: int, n: int, ax, dim: int = -1) -> torch.Tensor:
    """Columns (``dim`` -1) or rows (-2) [lo, lo + n) of a leaf whose extent
    along ``dim`` is ``full``, as this process uses them: its own block as
    it is, else taken from the whole leaf (gathered first when it is a
    block of other columns), whose gradient is then summed over the
    processes (``copy_to_model``).  1-D leaves (biases) take ``dim`` -1."""
    have = w.shape[dim]
    if have != full and ax.index * have == lo and have == n:
        return w
    if have != full:
        w = par.gather_from_model(w, ax, dim)
    return par.copy_to_model(w, ax).narrow(dim, lo, n)


def _attn_heads(cfg: ModelConfig, ax) -> Tuple[int, int, int, int]:
    """(h0, h1, kv0, kv1): this process's query heads, an even block of
    them, and the KV heads their GQA groups read."""
    hl = cfg.n_heads // ax.size
    h0 = ax.index * hl
    g = cfg.n_heads // cfg.n_kv_heads
    return h0, h0 + hl, h0 // g, (h0 + hl - 1) // g + 1


def _attn_tp(p: Params, x: torch.Tensor, cfg: ModelConfig, ax, q_positions, kv_positions,
             causal: bool, window: int, rope: bool, kv_x: Optional[torch.Tensor] = None,
             prefix: str = ""):
    """``attn_sublayer`` on this process's heads: q/k/v from its columns,
    attention, its rows of ``o_proj``, one f32 all-reduce of the partial
    outputs.  Returns this process's (k, v).  ``kv_x`` (k and v's source)
    and ``prefix`` (the leaves' names) make it whisper's cross-attention:
    ``cross_{q,k,v,o}_proj``, k and v from the encoder's output."""
    b, s, _ = x.shape
    dt, hd = x.dtype, cfg.head_dim
    h0, h1, kv0, kv1 = _attn_heads(cfg, ax)
    hl, kvl = h1 - h0, kv1 - kv0
    xc = par.copy_to_model(x, ax)
    kc = xc if kv_x is None else par.copy_to_model(kv_x, ax)
    sk = kc.shape[1]
    q = xc @ _cols(p[prefix + "q_proj"], cfg.q_dim, h0 * hd, hl * hd, ax).to(dt)
    k = kc @ _cols(p[prefix + "k_proj"], cfg.kv_dim, kv0 * hd, kvl * hd, ax).to(dt)
    v = kc @ _cols(p[prefix + "v_proj"], cfg.kv_dim, kv0 * hd, kvl * hd, ax).to(dt)
    if prefix + "q_bias" in p:
        q = q + _cols(p[prefix + "q_bias"], cfg.q_dim, h0 * hd, hl * hd, ax).to(dt)
        k = k + _cols(p[prefix + "k_bias"], cfg.kv_dim, kv0 * hd, kvl * hd, ax).to(dt)
        v = v + _cols(p[prefix + "v_bias"], cfg.kv_dim, kv0 * hd, kvl * hd, ax).to(dt)
    q = q.reshape(b, s, hl, hd)
    k = k.reshape(b, sk, kvl, hd)
    v = v.reshape(b, sk, kvl, hd)
    if rope:
        q = L.apply_rope(q, q_positions, cfg.rope_theta)
        k = L.apply_rope(k, q_positions, cfg.rope_theta)
    g = cfg.n_heads // cfg.n_kv_heads
    kv_of = [(h0 + j) // g - kv0 for j in range(hl)]
    ka, va = k, v
    if hl % kvl or kv_of != [j // (hl // kvl) for j in range(hl)]:
        # the block's heads do not group evenly over its KV heads: each
        # query head takes its own copy of its KV head
        idx = torch.tensor(kv_of, device=k.device)
        ka, va = k.index_select(2, idx), v.index_select(2, idx)
    out = attn_lib.attention(
        q, ka, va, q_positions, kv_positions,
        causal=causal, window=window, impl=cfg.attn_impl,
        chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv,
    )
    wo = _cols(p[prefix + "o_proj"], cfg.q_dim, h0 * hd, hl * hd, ax, dim=-2)
    out = out.reshape(b, s, hl * hd) @ wo.to(dt)
    return par.reduce_from_model(out.float(), ax).to(dt), (k, v)


_ATTN_LEAVES = (("q_proj", -1), ("k_proj", -1), ("v_proj", -1), ("o_proj", -2))


def gathered_attn_leaves(p: Params, cfg: ModelConfig, ax, prefix: str = "") -> Params:
    """``p`` with each of the attention's ``prefix + {q,k,v,o}_proj`` that is
    a block over ``model`` gathered whole: the replicated route where the
    heads do not divide the extent (the same numbers on every process)."""
    full = {"q_proj": cfg.q_dim, "k_proj": cfg.kv_dim, "v_proj": cfg.kv_dim,
            "o_proj": cfg.q_dim}
    p = dict(p)
    for name, dim in _ATTN_LEAVES:
        if p[prefix + name].shape[dim] != full[name]:
            p[prefix + name] = par.gather_from_model(p[prefix + name], ax, dim)
    return p


def attn_sublayer(
    p: Params,
    x: torch.Tensor,  # (B, S, D) normed input
    cfg: ModelConfig,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    rope: bool = True,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Self-attention; returns (attn_out (B,S,D), (k, v)) for cache fills.
    ``rope=False`` leaves q and k unrotated (whisper's encoder).  Under
    tensor parallelism the heads split evenly over ``model`` (``_attn_tp``);
    where they do not divide, every process computes every head, with the
    split leaves gathered (replicated work, the same numbers)."""
    ax = par.model_axes()
    if ax is not None:
        if cfg.n_heads % ax.size == 0:
            return _attn_tp(p, x, cfg, ax, q_positions, kv_positions, causal, window, rope)
        p = gathered_attn_leaves(p, cfg, ax)
    b, s, _ = x.shape
    q, k, v = project_qkv(p, x, cfg)
    if rope:
        q = L.apply_rope(q, q_positions, cfg.rope_theta)
        k = L.apply_rope(k, q_positions, cfg.rope_theta)
    out = attn_lib.attention(
        q, k, v, q_positions, kv_positions,
        causal=causal, window=window, impl=cfg.attn_impl,
        chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv,
    )
    out = out.reshape(b, s, cfg.q_dim) @ p["o_proj"].to(x.dtype)
    return out, (k, v)


def default_mlp_fn(p: Params, h: torch.Tensor, cfg: ModelConfig):
    """(block params, normed hidden) -> (mlp_out, aux).  A dense block has
    no auxiliary loss: its aux is the Python float 0.0, which adds nothing
    and launches nothing (JAX's is an f32 zero)."""
    return L.apply_mlp(p["mlp"], h, cfg), 0.0


def dense_block(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    positions: torch.Tensor,
    kv_positions: torch.Tensor,
    mlp_fn=default_mlp_fn,
):
    """Pre-norm attention + MLP; returns (x, (k, v), aux).  Under FSDP the
    layer's ``data`` blocks are gathered here (module docstring)."""
    p = par.gather_layer(p)
    h = L.rmsnorm(x, p["attn_norm"], cfg.rms_eps)
    attn_out, kv = attn_sublayer(
        p, h, cfg, positions, kv_positions, window=cfg.attn_window
    )
    x = x + attn_out
    h = L.rmsnorm(x, p["mlp_norm"], cfg.rms_eps)
    mlp_out, aux = mlp_fn(p, h, cfg)
    return x + mlp_out, kv, aux


# ---------------------------------------------------------------------------
# Bytes over ``model`` in a hot step: each family module's ``tp_comm_bytes``
# (``models.tp_hot_comm_bytes`` says what is counted and how)
# ---------------------------------------------------------------------------


def tp_attn_bytes(cfg: ModelConfig, n_tok: int, tp: int, act_bytes: int, kv_tok: int = 0,
                  bias: bool = False) -> int:
    """One attention sub-layer over ``n_tok`` tokens (``kv_tok`` encoder
    rows for whisper's cross-attention): on this process's heads, the
    partial outputs' f32 all-reduce twice (forward, recomputation), the
    inputs' gradients and each whole leaf's; where the heads do not
    divide, each split leaf gathered twice."""
    pb = cfg.param_dtype.itemsize
    d, hd, qd, kvd = cfg.d_model, cfg.head_dim, cfg.q_dim, cfg.kv_dim
    leaves = ((d * qd, qd), (d * kvd, kvd), (d * kvd, kvd), (qd * d, qd))
    if cfg.n_heads % tp:
        return sum(2 * size * pb for size, dim in leaves if par.splits_over_model(dim, tp))
    hl, g = cfg.n_heads // tp, cfg.n_heads // cfg.n_kv_heads
    for i in range(tp):  # this process's KV heads, against its block of k and v
        kv0, kv1 = i * hl // g, (i * hl + hl - 1) // g + 1
        if par.splits_over_model(kvd, tp) and (kv0 * hd != i * kvd // tp
                                               or (kv1 - kv0) * hd != kvd // tp):
            raise NotImplementedError("the count assumes split k/v blocks on the heads")
    total = n_tok * d * (2 * 4 + act_bytes) + kv_tok * d * act_bytes
    total += sum(size * pb for size, dim in leaves if not par.splits_over_model(dim, tp))
    return total + (pb * (qd + 2 * kvd) if bias else 0)


def tp_mlp_bytes(cfg: ModelConfig, n_tok: int, tp: int, act_bytes: int) -> int:
    """The MLP where ``d_ff`` splits: the f32 reduction and the input's
    gradient."""
    split = cfg.mlp_kind != "none" and par.splits_over_model(cfg.d_ff, tp)
    return n_tok * cfg.d_model * (4 + act_bytes) if split else 0


def tp_lm_bytes(cfg: ModelConfig, rows: int, seq: int, tp: int, act_bytes: int,
                hidden: int = 0) -> int:
    """Where the vocab splits: the embedding's f32 reduction of ``rows`` x
    ``seq`` token rows, and the cross-entropy's over ``hidden`` positions a
    row (``seq`` by default), per chunk: the max, the sum of exponentials
    and the target logit (f32, one per token) in forward and in the
    chunk's recomputation, and its input's gradient."""
    if not par.splits_over_model(cfg.vocab_size, tp):
        return 0
    d, hidden = cfg.d_model, hidden or seq
    cs = min(cfg.loss_chunk, hidden)
    return rows * seq * d * cfg.param_dtype.itemsize + sum(
        6 * rows * min(cs, hidden - lo) * 4 + rows * min(cs, hidden - lo) * d * act_bytes
        for lo in range(0, hidden, cs))


def tp_comm_bytes(cfg: ModelConfig, rows: int, seq: int, tp: int, act_bytes: int,
                  prefix_len: int = 0) -> int:
    """The dense family's (and, with ``prefix_len`` rows of prefix
    embeddings, llava's decoder)."""
    pos = rows * (seq + prefix_len)
    return (cfg.n_layers * (tp_attn_bytes(cfg, pos, tp, act_bytes, bias=cfg.qkv_bias)
                            + tp_mlp_bytes(cfg, pos, tp, act_bytes))
            + tp_lm_bytes(cfg, rows, seq, tp, act_bytes, hidden=seq + prefix_len))


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def embed_tokens(params: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Embedding rows in ``cfg.dtype``.  Under tensor parallelism with
    ``embed`` this process's block of the vocab: its rows for the tokens
    it holds, zero for the others, summed over ``model`` in the param
    dtype (exact: one term is not zero).  Under FSDP the table is
    gathered over ``data`` first."""
    w = par.gather_leaf(params["embed"], "['embed']")
    ax = par.model_axes()
    if ax is not None and w.shape[0] != cfg.vocab_size:
        t = tokens.reshape(-1).long() - ax.index * w.shape[0]
        mine = ((t >= 0) & (t < w.shape[0]))[:, None]
        rows = w.index_select(0, t.clamp(0, w.shape[0] - 1))
        rows = par.reduce_from_model(torch.where(mine, rows, torch.zeros_like(rows)), ax)
    else:
        rows = w.index_select(0, tokens.reshape(-1).long())
    return rows.reshape(*tokens.shape, -1).to(cfg.dtype)


def forward_hidden(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # (B, S)
    *,
    prefix_embeds: Optional[torch.Tensor] = None,  # (B, P, D) pre-embedded
    collect_kv: bool = False,
    mlp_fn=default_mlp_fn,
):
    """(Prefix +) token embedding -> blocks -> final norm.  Returns (h,
    kvs, aux) with kvs the stacked (L, B, P + S, KVH, D) K and V when
    ``collect_kv`` and aux the blocks' summed auxiliary loss (``mlp_fn``'s
    second output).  A prefix goes ahead of the tokens, with positions
    over the whole sequence (JAX ``transformer.py:246-267``)."""
    h = embed_tokens(params, tokens, cfg)
    if prefix_embeds is not None:
        h = torch.cat([prefix_embeds.to(cfg.dtype), h], dim=1)
    b, s, _ = h.shape
    positions = torch.arange(s, dtype=torch.int32, device=h.device).expand(b, s)
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    aux_sum = 0.0
    remat = cfg.remat == "block" and torch.is_grad_enabled()
    for p in unbind_layers(params["blocks"], cfg.n_layers):
        if remat:
            h, (k, v), aux = checkpoint(
                dense_block, p, h, cfg, positions, positions, mlp_fn, use_reentrant=False
            )
        else:
            h, (k, v), aux = dense_block(p, h, cfg, positions, positions, mlp_fn)
        aux_sum = aux_sum + aux
        if collect_kv:
            ks.append(k)
            vs.append(v)
    h = L.rmsnorm(h, params["final_norm"], cfg.rms_eps)
    kvs = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    return h, kvs, aux_sum


def loss_fn(
    params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
    mlp_fn=default_mlp_fn, aux_weight: float = 0.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token loss, from ``transformer.py:270-290``: (loss + aux_weight
    * aux / n_layers, {"loss", "aux", "tokens"}); labels of -1 carry no
    loss.  A dense model's aux is 0 and its total is the loss itself.  A
    ``patch_embeds`` (or ``frame_embeds``) prefix in the batch goes ahead
    of the tokens and its positions carry no loss."""
    prefix = batch.get("patch_embeds", batch.get("frame_embeds"))
    h, _, aux = forward_hidden(params, cfg, batch["tokens"], prefix_embeds=prefix,
                               mlp_fn=mlp_fn)
    labels = batch["labels"]
    if prefix is not None:
        pad = torch.full(prefix.shape[:2], -1, dtype=labels.dtype, device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    loss, n_tok = L.chunked_cross_entropy(
        h, lm_head_matrix(params, cfg), labels, cfg.loss_chunk, vocab=cfg.vocab_size
    )
    aux = torch.as_tensor(aux, dtype=torch.float32, device=h.device)
    total = loss + aux_weight * aux / max(cfg.n_layers, 1) if aux_weight else loss
    return total, {"loss": loss, "aux": aux.detach(), "tokens": n_tok}


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
    prefix_embeds: Optional[torch.Tensor] = None,
    capacity: Optional[int] = None,
    mlp_fn=default_mlp_fn,
) -> Tuple[torch.Tensor, KVCache]:
    """Run the full prompt (after ``prefix_embeds``, whose positions come
    first in the cache); return (last-token logits (B, V) f32, cache)."""
    h, kvs, _ = forward_hidden(params, cfg, tokens, prefix_embeds=prefix_embeds,
                               collect_kv=True, mlp_fn=mlp_fn)
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
    mlp_fn=default_mlp_fn,
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
        h = h + mlp_fn(p, hnorm, cfg)[0]
    h = L.rmsnorm(h, params["final_norm"], cfg.rms_eps)
    logits = h[:, 0].float() @ lm_head_matrix(params, cfg).float()
    return logits, KVCache(k=k_all, v=v_all, pos=new_pos, next_pos=cache.next_pos + 1)
