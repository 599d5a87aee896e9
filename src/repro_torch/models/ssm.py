"""Mamba-2 (SSD: state-space duality) blocks -- ``mamba2-370m``, and the
SSM half of ``hymba-1.5b`` -- from ``src/repro/models/ssm.py``.

Chunked SSD (Dao & Gu 2024): the sequence is split into chunks of
``cfg.ssm_chunk``; within a chunk the output is a small quadratic
(attention-like) product, and across chunks one (d_state x head_dim) state
per head is carried in f32 by a Python loop over the chunks, each chunk
recomputed in backward (``checkpoint``), as JAX's ``jax.checkpoint`` on its
``lax.scan`` body.  Decode is the O(1) recurrent form, h = a*h + dt*(B (x)
x), y = C.h + D*x, with the last K-1 inputs of the depthwise causal conv
kept in the cache.

One departure from the reference, on purpose: the intra-chunk decay
matrix is masked BEFORE its exponential, ``exp(where(mask, diff, -inf))``,
where JAX computes ``where(mask, exp(diff), 0)`` (ssm.py:130-132).  Above
the diagonal ``diff`` is positive, and once a chunk's summed log-decay
passes ~88 its ``exp`` overflows: JAX's forward stays finite, but its
backward multiplies the zero cotangent by inf and returns NaN gradients
(ROADMAP queue 3).  The entries on and below the diagonal are the same
numbers either way.

Parameter naming: ``*_proj`` matrices are low-rank eligible; ``a_log``,
``dt_bias``, ``conv_*`` and the norm scale are excluded by name
(``d_skip`` is not: see ROADMAP queue 3).

Under tensor parallelism (``models/parallel.py``) the mixer takes one of
two routes.  With ``cfg.ssm_head_tp`` and the heads dividing the
``model`` extent -- where JAX's ``_shard_ssm_heads`` puts ``xh``, ``dt``
and ``y`` on ``model`` (ssm.py:158-190) -- each process runs the SSD on
its ``H / model`` heads (``_mixer_heads``): its heads' ``z``, ``x`` and
``dt`` columns of ``in_proj`` (gathered first: the rules' column blocks
do not fall on the ``[z | x | B | C | dt]`` boundaries), the shared ``B``
and ``C`` whole, the conv over its channels, the per-head leaves narrowed,
the gated RMSNorm's sum of squares all-reduced over ``model`` (it spans
every head) and handed to the RMSNorm kernel, and ``out_proj``'s rows of
its heads, the partial outputs summed in f32.  Otherwise every process runs the whole mixer from the
gathered ``in_proj``, as replicated work with the same numbers, and
multiplies by its own rows of a split ``out_proj`` (summed the same way).
Under FSDP ``_block`` gathers its layer first (``parallel.gather_layer``),
inside the recomputed region.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import parallel as par
from repro_torch.models import transformer as tfm

Params = Dict[str, Any]

_CONV_K = 4  # depthwise causal conv width (mamba2 default)


def ssm_dims(cfg: ModelConfig) -> Dict[str, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    n = cfg.ssm_state
    conv_dim = d_inner + 2 * n  # x, B, C share the conv (n_groups = 1)
    return dict(d_inner=d_inner, n_heads=n_heads, n=n, conv_dim=conv_dim,
                p=cfg.ssm_head_dim)


def init_ssm_mixer(gen: torch.Generator, cfg: ModelConfig, lead, dev, put) -> Params:
    """The mixer's leaves with leading dims ``lead``; the dt bias spans
    softplus^-1 of [1e-3, 1e-1] log-uniformly (the mamba default)."""
    dims = ssm_dims(cfg)
    d, d_inner, h = cfg.d_model, dims["d_inner"], dims["n_heads"]
    in_dim = 2 * d_inner + 2 * dims["n"] + h  # z, x, B, C, dt
    dt = cfg.param_dtype
    lead = tuple(lead)
    out_scale = 1.0 / math.sqrt(d_inner * 2 * cfg.n_layers)
    u = torch.rand(lead + (h,), generator=gen, device=dev)
    dt_init = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))  # inverse softplus
    conv_w = torch.empty(lead + (_CONV_K, dims["conv_dim"]), device=dev)
    conv_w.normal_(0.0, 1.0, generator=gen)
    a_log = torch.log(torch.arange(1, h + 1, dtype=torch.float32, device=dev))
    return {
        "in_proj": put.dense("in_proj", gen, lead + (d, in_dim), device=dev),
        "out_proj": put.dense("out_proj", gen, lead + (d_inner, d), scale=out_scale, device=dev),
        "conv_w": (conv_w * 0.02).to(dt),
        "conv_b": torch.zeros(lead + (dims["conv_dim"],), dtype=dt, device=dev),
        "a_log": a_log.expand(lead + (h,)).contiguous(),
        "dt_bias": dt_bias,
        "d_skip": torch.ones(lead + (h,), dtype=torch.float32, device=dev),
        "ssm_norm_scale": torch.ones(lead + (d_inner,), dtype=dt, device=dev),
    }


def _split_in_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    dims = ssm_dims(cfg)
    d_inner, n = dims["d_inner"], dims["n"]
    return torch.split(zxbcdt, [d_inner, d_inner, n, n, dims["n_heads"]], dim=-1)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C) with kernel (K, C), summed
    tap by tap in the input dtype as the JAX version."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = pad[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + s] * w[i]
    return F.silu((out + b).float()).to(xbc.dtype)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))  # jax.nn.softplus


def _ssd_chunk(state, xc, dtc, bc, cc, a, mask):
    """One chunk of the scan body (ssm.py:121-152): (B,Q,H,P), (B,Q,H),
    (B,Q,N), (B,Q,N) -> (new state, y (B,Q,H,P) f32)."""
    dtc32 = dtc.float()
    la = dtc32 * a  # log decay per step (B,Q,H), <= 0
    cum = torch.cumsum(la, dim=1)
    # intra-chunk decay exp(cum_i - cum_j) for i >= j, masked before the
    # exponential: above the diagonal diff > 0 may overflow (module doc)
    diff = cum[:, :, None, :] - cum[:, None, :, :]  # (B,Qi,Qj,H)
    lmat = torch.exp(torch.where(mask[None, :, :, None], diff, -math.inf))
    cb = torch.einsum("bin,bjn->bij", cc.float(), bc.float())
    w = cb[:, :, :, None] * lmat
    xdt = xc.float() * dtc32[..., None]
    y_diag = torch.einsum("bijh,bjhp->bihp", w, xdt)
    decay_in = torch.exp(cum)  # from the chunk's start to position i
    y_off = torch.einsum("bin,bhnp->bihp", cc.float(), state) * decay_in[..., None]
    decay_out = torch.exp(cum[:, -1:, :] - cum)
    sbar = torch.einsum("bjn,bjhp->bhnp", bc.float(), xdt * decay_out[..., None])
    chunk_decay = torch.exp(cum[:, -1, :])  # (B,H)
    state = state * chunk_decay[:, :, None, None] + sbar
    return state, y_diag + y_off


def ssd_chunked(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) post-softplus
    a: torch.Tensor,  # (H,) negative decay rates
    b_mat: torch.Tensor,  # (B, S, N)
    c_mat: torch.Tensor,  # (B, S, N)
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # (B, H, N, P) f32
):
    """Chunked SSD scan.  Returns (y (B,S,H,P) in x's dtype, final_state
    (B,H,N,P) f32).  The sequence is padded to whole chunks with zeros; a
    padded position has dt 0, so it leaves the state alone."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, pad))
    nc = x.shape[1] // chunk
    xq = x.reshape(bsz, nc, chunk, h, p)
    dtq = dt.reshape(bsz, nc, chunk, h)
    bq = b_mat.reshape(bsz, nc, chunk, n)
    cq = c_mat.reshape(bsz, nc, chunk, n)
    state = (torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
             if init_state is None else init_state)
    mask = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    remat = torch.is_grad_enabled()
    ys = []
    for c in range(nc):
        args = (state, xq[:, c], dtq[:, c], bq[:, c], cq[:, c], a, mask)
        if remat:  # recompute the intra-chunk (B,Q,Q,H) factors in backward
            state, y = checkpoint(_ssd_chunk, *args, use_reentrant=False)
        else:
            state, y = _ssd_chunk(*args)
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(bsz, nc * chunk, h, p)
    return y[:, :s].to(x.dtype), state


def _take(w: torch.Tensor, full: int, ranges, ax) -> torch.Tensor:
    """The columns ``ranges`` ((start, width) pairs) of a leaf whose last
    dim is ``full``, side by side: gathered over ``model`` first when it is
    a block, its gradient summed over the processes (``copy_to_model``)."""
    if w.shape[-1] != full:
        w = par.gather_from_model(w, ax, -1)
    w = par.copy_to_model(w, ax)
    return torch.cat([w.narrow(-1, lo, n) for lo, n in ranges], dim=-1)


def _rmsnorm_over_model(y: torch.Tensor, scale: torch.Tensor, width: int, eps: float,
                        ax) -> torch.Tensor:
    """``L.rmsnorm`` over ``width`` channels of which this process holds
    ``y``'s: the sum of squares in f32 all-reduced over ``model`` (its
    gradient summed over the processes too: every process's outputs read
    it), then the kernel on this process's channels with that sum."""
    y32 = y.float()
    ss = par.reduce_from_model(torch.sum(y32 * y32, dim=-1, keepdim=True), ax)
    return L.rmsnorm(y, scale.contiguous(), eps, ss=par.copy_to_model(ss, ax), width=width)


def _mixer_heads(p: Params, u: torch.Tensor, cfg: ModelConfig, ax, init_state,
                 return_state: bool):
    """``apply_ssm_mixer`` on this process's ``H / model`` heads (module
    docstring); ``init_state`` is global and the state returned this
    process's heads'."""
    dims = ssm_dims(cfg)
    h, pdim, n, d_inner = dims["n_heads"], dims["p"], dims["n"], dims["d_inner"]
    hl = h // ax.size
    h0 = ax.index * hl
    c0, cw = h0 * pdim, hl * pdim  # this process's channels of d_inner
    dt_ = u.dtype
    w_in = _take(p["in_proj"], 2 * d_inner + 2 * n + h,
                 [(c0, cw), (d_inner + c0, cw), (2 * d_inner, 2 * n),
                  (2 * d_inner + 2 * n + h0, hl)], ax)
    zxbcdt = par.copy_to_model(u, ax) @ w_in.to(dt_)
    z, x, b_mat, c_mat, dt_raw = torch.split(zxbcdt, [cw, cw, n, n, hl], dim=-1)
    conv = [(c0, cw), (d_inner, 2 * n)]  # its x channels, then B and C
    xbc = _causal_conv(torch.cat([x, b_mat, c_mat], dim=-1),
                       _take(p["conv_w"], dims["conv_dim"], conv, ax).to(dt_),
                       _take(p["conv_b"], dims["conv_dim"], conv, ax).to(dt_))
    x, b_mat, c_mat = torch.split(xbc, [cw, n, n], dim=-1)
    bsz, s, _ = x.shape
    xh = x.reshape(bsz, s, hl, pdim)
    dt = _softplus(dt_raw.float() + tfm._cols(p["dt_bias"], h, h0, hl, ax))
    a = -torch.exp(tfm._cols(p["a_log"], h, h0, hl, ax))
    if init_state is not None:
        init_state = init_state[:, h0:h0 + hl]
    y, state = ssd_chunked(xh, dt, a, b_mat, c_mat, cfg.ssm_chunk, init_state=init_state)
    d_skip = tfm._cols(p["d_skip"], h, h0, hl, ax)
    y = y + xh.float().to(dt_) * d_skip.to(dt_)[None, None, :, None]
    y = y.reshape(bsz, s, cw)
    y = y * F.silu(z.float()).to(dt_)
    y = _rmsnorm_over_model(y, tfm._cols(p["ssm_norm_scale"], d_inner, c0, cw, ax), d_inner,
                            cfg.rms_eps, ax)
    wo = tfm._cols(p["out_proj"], d_inner, c0, cw, ax, dim=-2)
    out = par.reduce_from_model((y @ wo.to(dt_)).float(), ax).to(dt_)
    if return_state:
        return out, state
    return out


def head_parallel(cfg: ModelConfig, tp: int) -> bool:
    """Whether the mixer runs on a process's heads at a ``model`` extent of
    ``tp`` above 1: ``cfg.ssm_head_tp`` and the heads dividing it, as
    JAX's ``_shard_ssm_heads`` constrains them."""
    return cfg.ssm_head_tp and ssm_dims(cfg)["n_heads"] % tp == 0


def tp_mixer_bytes(cfg: ModelConfig, n_tok: int, tp: int, act_bytes: int,
                   rec_out: bool) -> int:
    """One mixer over ``n_tok`` tokens (``models.tp_hot_comm_bytes``).  On
    this process's heads: its input's gradient; ``in_proj`` gathered
    (forward and recomputation) where split, and its gradient all-reduced;
    the gradients of ``conv_w``, ``conv_b``, ``a_log``, ``dt_bias``,
    ``d_skip`` and the norm's scale all-reduced; the gated norm's f32 sum of
    squares, one per token, in forward, recomputation and backward;
    ``out_proj``'s f32 reduction (again in the recomputation where
    ``rec_out``: hymba's MLP ends its block), and its gradient where whole.
    The whole mixer: ``in_proj`` gathered where split (forward and
    recomputation); where ``out_proj`` splits, the input's gradient of its
    rows (T x d_inner, compute dtype) and its reduction."""
    dims = ssm_dims(cfg)
    d, d_inner, h, n = cfg.d_model, dims["d_inner"], dims["n_heads"], dims["n"]
    pb = cfg.param_dtype.itemsize
    in_dim = 2 * d_inner + 2 * n + h
    split_in = par.splits_over_model(in_dim, tp)
    out = n_tok * d * 4 * (2 if rec_out else 1)
    if head_parallel(cfg, tp):
        total = n_tok * d * act_bytes + d * in_dim * pb * (3 if split_in else 1)
        total += pb * ((_CONV_K + 1) * dims["conv_dim"] + 3 * h + d_inner) + 3 * n_tok * 4
        return total + out + (0 if par.splits_over_model(d_inner, tp) else d_inner * d * pb)
    total = 2 * d * in_dim * pb if split_in else 0
    if par.splits_over_model(d_inner, tp):
        total += n_tok * d_inner * act_bytes + out
    return total


def tp_comm_bytes(cfg: ModelConfig, rows: int, seq: int, tp: int, act_bytes: int) -> int:
    """mamba2's bytes over ``model`` in a hot step (``models.tp_hot_comm_bytes``)."""
    return (cfg.n_layers * tp_mixer_bytes(cfg, rows * seq, tp, act_bytes, rec_out=False)
            + tfm.tp_lm_bytes(cfg, rows, seq, tp, act_bytes))


def apply_ssm_mixer(
    p: Params,
    u: torch.Tensor,  # (B, S, D) normed input
    cfg: ModelConfig,
    *,
    init_state: Optional[torch.Tensor] = None,
    return_state: bool = False,
):
    dims = ssm_dims(cfg)
    h, pdim, n, d_inner = dims["n_heads"], dims["p"], dims["n"], dims["d_inner"]
    ax = par.model_axes()
    if ax is not None:
        if head_parallel(cfg, ax.size):
            return _mixer_heads(p, u, cfg, ax, init_state, return_state)
        in_dim = 2 * d_inner + 2 * n + h
        if p["in_proj"].shape[-1] != in_dim:  # the whole mixer: in_proj gathered
            p = dict(p, in_proj=par.gather_from_model(p["in_proj"], ax, -1))
    dt_ = u.dtype
    zxbcdt = u @ p["in_proj"].to(dt_)
    z, x, b_mat, c_mat, dt_raw = _split_in_proj(zxbcdt, cfg)
    xbc = torch.cat([x, b_mat, c_mat], dim=-1)
    xbc = _causal_conv(xbc, p["conv_w"].to(dt_), p["conv_b"].to(dt_))
    x, b_mat, c_mat = torch.split(xbc, [d_inner, n, n], dim=-1)
    bsz, s, _ = x.shape
    xh = x.reshape(bsz, s, h, pdim)
    dt = _softplus(dt_raw.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])  # (H,) negative
    y, state = ssd_chunked(xh, dt, a, b_mat, c_mat, cfg.ssm_chunk, init_state=init_state)
    y = y + xh.float().to(dt_) * p["d_skip"].to(dt_)[None, None, :, None]
    y = y.reshape(bsz, s, d_inner)
    y = y * F.silu(z.float()).to(dt_)
    y = L.rmsnorm(y, p["ssm_norm_scale"], cfg.rms_eps)
    w_out = p["out_proj"]
    if ax is not None and w_out.shape[-2] != d_inner:
        # this process's rows of out_proj, the partial outputs summed in f32
        r = w_out.shape[-2]
        y = par.copy_to_model(y, ax).narrow(-1, ax.index * r, r)
        out = par.reduce_from_model((y @ w_out.to(dt_)).float(), ax).to(dt_)
    else:
        out = y @ w_out.to(dt_)
    if return_state:
        return out, state
    return out


def conv_tail(p: Params, normed: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The last K-1 conv inputs of a prompt, recomputed from its last K-1
    normed rows, for decode to continue the conv (ssm.py:381-386)."""
    zxbcdt = normed[:, -(_CONV_K - 1):] @ p["in_proj"].to(normed.dtype)
    _, xc, b_mat, c_mat, _ = _split_in_proj(zxbcdt, cfg)
    return torch.cat([xc, b_mat, c_mat], dim=-1)


# ---------------------------------------------------------------------------
# Recurrent decode (O(1) per token)
# ---------------------------------------------------------------------------


class SSMLayerCache(NamedTuple):
    conv: torch.Tensor  # (B, K-1, conv_dim) last inputs to the causal conv
    state: torch.Tensor  # (B, H, N, P) f32


def init_layer_cache(cfg: ModelConfig, batch: int, lead=(), *, device) -> SSMLayerCache:
    """A zero cache with leading dims ``lead`` ((n_layers,) when stacked)."""
    dims = ssm_dims(cfg)
    lead = tuple(lead)
    return SSMLayerCache(
        conv=torch.zeros(lead + (batch, _CONV_K - 1, dims["conv_dim"]), dtype=cfg.dtype,
                         device=device),
        state=torch.zeros(lead + (batch, dims["n_heads"], dims["n"], dims["p"]),
                          dtype=torch.float32, device=device),
    )


def decode_ssm_mixer(p: Params, u: torch.Tensor, cache: SSMLayerCache, cfg: ModelConfig):
    """One token (B, 1, D) through the recurrent form; returns (out, new
    layer cache)."""
    dims = ssm_dims(cfg)
    h, pdim, n, d_inner = dims["n_heads"], dims["p"], dims["n"], dims["d_inner"]
    dt_ = u.dtype
    bsz = u.shape[0]
    zxbcdt = u @ p["in_proj"].to(dt_)
    z, x, b_mat, c_mat, dt_raw = _split_in_proj(zxbcdt, cfg)
    xbc = torch.cat([x, b_mat, c_mat], dim=-1)  # (B,1,conv_dim)
    window = torch.cat([cache.conv, xbc], dim=1)  # (B,K,conv)
    w = p["conv_w"].to(dt_)
    conv_out = torch.sum(window * w[None], dim=1, keepdim=True)
    conv_out = F.silu((conv_out + p["conv_b"].to(dt_)).float()).to(dt_)
    x, b_mat, c_mat = torch.split(conv_out, [d_inner, n, n], dim=-1)
    xh = x.reshape(bsz, h, pdim).float()
    dt = _softplus(dt_raw[:, 0].float() + p["dt_bias"])  # (B,H)
    a = -torch.exp(p["a_log"])
    decay = torch.exp(dt * a)  # (B,H)
    bv = b_mat[:, 0].float()  # (B,N)
    cv = c_mat[:, 0].float()
    outer = torch.einsum("bn,bhp->bhnp", bv, xh * dt[..., None])
    state = cache.state * decay[:, :, None, None] + outer
    y = torch.einsum("bn,bhnp->bhp", cv, state)
    y = y + xh * p["d_skip"][None, :, None]
    y = y.reshape(bsz, 1, d_inner).to(dt_)
    y = y * F.silu(z.float()).to(dt_)
    y = L.rmsnorm(y, p["ssm_norm_scale"], cfg.rms_eps)
    out = y @ p["out_proj"].to(dt_)
    return out, SSMLayerCache(conv=window[:, 1:], state=state)


def stack_layer_caches(caches) -> SSMLayerCache:
    return SSMLayerCache(conv=torch.stack([c.conv for c in caches]),
                         state=torch.stack([c.state for c in caches]))


# ---------------------------------------------------------------------------
# Pure-SSM decoder LM (mamba2-370m): norm -> mixer -> residual, no MLP.
# ---------------------------------------------------------------------------


class MambaCache(NamedTuple):
    layers: SSMLayerCache  # stacked (L, ...) in each leaf
    next_pos: torch.Tensor


def init_blocks(gen: torch.Generator, cfg: ModelConfig, dev, put) -> Params:
    return {
        "ssm_norm": torch.ones((cfg.n_layers, cfg.d_model), dtype=cfg.param_dtype, device=dev),
        "mixer": init_ssm_mixer(gen, cfg, (cfg.n_layers,), dev, put),
    }


def init_params(gen: torch.Generator, cfg: ModelConfig, device="cuda", *, serving=False):
    return tfm.init_params(gen, cfg, device, serving=serving, init_blocks=init_blocks)


def _block(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    p = par.gather_layer(p)
    normed = L.rmsnorm(x, p["ssm_norm"], cfg.rms_eps)
    return x + apply_ssm_mixer(p["mixer"], normed, cfg)


def forward_hidden(params: Params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    h = tfm.embed_tokens(params, tokens, cfg)
    remat = cfg.remat == "block" and torch.is_grad_enabled()
    for p in tfm.unbind_layers(params["blocks"], cfg.n_layers):
        h = checkpoint(_block, p, h, cfg, use_reentrant=False) if remat else _block(p, h, cfg)
    return L.rmsnorm(h, params["final_norm"], cfg.rms_eps)


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """Next-token loss: (loss, {"loss", "tokens"}), as JAX's (no aux)."""
    h = forward_hidden(params, cfg, batch["tokens"])
    loss, n_tok = L.chunked_cross_entropy(
        h, tfm.lm_head_matrix(params, cfg), batch["labels"], cfg.loss_chunk,
        vocab=cfg.vocab_size)
    return loss, {"loss": loss, "tokens": n_tok}


def init_cache(cfg: ModelConfig, batch: int, capacity: int = 0, *, device) -> MambaCache:
    del capacity  # O(1) state: capacity-free
    return MambaCache(
        layers=init_layer_cache(cfg, batch, (cfg.n_layers,), device=device),
        next_pos=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def _logits(params: Params, cfg: ModelConfig, h_last: torch.Tensor) -> torch.Tensor:
    return h_last.float() @ tfm.lm_head_matrix(params, cfg).float()


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor, capacity: int = 0):
    """Forward over the prompt, carrying each layer's final state and conv
    tail into a cache."""
    h = tfm.embed_tokens(params, tokens, cfg)
    bsz, s = tokens.shape
    caches = []
    for i in range(cfg.n_layers):
        p = tfm.layer_params(params["blocks"], i)
        normed = L.rmsnorm(h, p["ssm_norm"], cfg.rms_eps)
        out, state = apply_ssm_mixer(p["mixer"], normed, cfg, return_state=True)
        h = h + out
        caches.append(SSMLayerCache(conv=conv_tail(p["mixer"], normed, cfg), state=state))
    h = L.rmsnorm(h, params["final_norm"], cfg.rms_eps)
    cache = MambaCache(
        layers=stack_layer_caches(caches),
        next_pos=torch.full((bsz,), s, dtype=torch.int32, device=h.device),
    )
    return _logits(params, cfg, h[:, -1]), cache


def decode_step(params: Params, cfg: ModelConfig, cache: MambaCache, token: torch.Tensor):
    """One token per row against the recurrent cache; the given cache is
    left unchanged."""
    h = tfm.embed_tokens(params, token, cfg)
    caches = []
    for i in range(cfg.n_layers):
        p = tfm.layer_params(params["blocks"], i)
        normed = L.rmsnorm(h, p["ssm_norm"], cfg.rms_eps)
        lc = SSMLayerCache(conv=cache.layers.conv[i], state=cache.layers.state[i])
        out, new_lc = decode_ssm_mixer(p["mixer"], normed, lc, cfg)
        h = h + out
        caches.append(new_lc)
    h = L.rmsnorm(h, params["final_norm"], cfg.rms_eps)
    return _logits(params, cfg, h[:, 0]), MambaCache(
        layers=stack_layer_caches(caches), next_pos=cache.next_pos + 1)
