"""Mixture-of-Experts FFN (deepseek-moe-16b, olmoe-1b-7b), from
``src/repro/models/moe.py``: the local dropless path
(``_apply_moe_local``, moe.py:76-126).

  1. router scores in f32 -> softmax -> top-k experts per token, the
     weights renormalized (+1e-9),
  2. the switch load-balancing aux loss from the routed counts,
  3. a stable sort of the (token, slot) pairs by expert id (``jnp.argsort``
     is stable),
  4. three grouped products over the expert-grouped rows in place of
     ``jax.lax.ragged_dot`` (no capacity factor, no dropped tokens),
  5. an f32 scatter-add back, weighted by the routing weights.

``ragged_dot`` is not a Pallas kernel: its counterpart here is plain
products, one ``torch.matmul`` per expert whose group is not empty, on its
contiguous row range.  The group sizes reach the host once per call (one
sync per MoE layer), counted in ``HOST_SYNCS``.  DeepSeek's shared experts
are fused into one dense SwiGLU of width ``n_shared_experts * d_ff``
(always-active experts' outputs sum).  The expert-parallel path
(moe.py:152-261) waits for ROADMAP queue 1 item 11, second half.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as tfm

Params = Dict[str, Any]

# Host syncs for the group sizes, one per MoE layer call (see the module
# docstring); reset and read by whoever measures them.
HOST_SYNCS = [0]


def init_moe_mlp(
    gen: torch.Generator, cfg: ModelConfig, lead: Sequence[int], dev, put
) -> Params:
    """Router (f32, as JAX's), the (..., E, d, ff) expert stacks and the
    fused shared experts, with leading dims ``lead``."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    lead = tuple(lead)
    down_scale = 1.0 / math.sqrt(ff * 2 * cfg.n_layers)

    def stack(name, m, n, scale=None):
        return put.dense(name, gen, lead + (e, m, n), scale=scale, device=dev)

    p = {
        "router_w": L.dense_init(gen, lead + (d, e), scale=0.02, dtype=torch.float32,
                                 device=dev),
        "experts": {
            "gate_proj": stack("gate_proj", d, ff),
            "up_proj": stack("up_proj", d, ff),
            "down_proj": stack("down_proj", ff, d, down_scale),
        },
    }
    if cfg.n_shared_experts:
        p["shared_mlp"] = L.init_mlp(gen, cfg.with_(mlp_kind="swiglu"), lead, put, device=dev,
                                     d_ff=cfg.n_shared_experts * ff)
    return p


def _grouped(x: torch.Tensor, w: torch.Tensor, sizes: List[int]) -> torch.Tensor:
    """``ragged_dot``: rows of ``x`` grouped by expert (``sizes[e]`` rows
    each, in expert order) times that expert's slice ``w[e]`` of the (E,
    m, n) stack.  Under autograd the stack is unbound once, so its gradient
    is stacked once (indexing it per expert would add up E full-size
    zero-padded gradients); without, only the used experts are indexed."""
    ws = w.unbind(0) if w.requires_grad else w
    outs, start = [], 0
    for e, n in enumerate(sizes):
        if n:
            outs.append(x[start:start + n] @ ws[e])
            start += n
    return torch.cat(outs, dim=0)


def apply_moe_local(p: Params, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D), aux scalar), ``_apply_moe_local``.

    Aux: switch-style load balancing, E * sum_e f_e * p_e with f_e the
    share of routed (token, slot) pairs on expert e and p_e the mean router
    probability of e."""
    b, s, d = x.shape
    t, k, e = b * s, cfg.moe_top_k, cfg.n_experts
    dt = x.dtype
    xf = x.reshape(t, d)

    scores = xf.float() @ p["router_w"].float()
    probs = torch.softmax(scores, dim=-1)  # (T, E)
    top_w, top_i = torch.topk(probs, k, dim=-1)  # (T, k), descending
    top_w = top_w / (top_w.sum(dim=-1, keepdim=True) + 1e-9)

    flat_expert = top_i.reshape(-1)  # (T*k,)
    counts = torch.bincount(flat_expert, minlength=e).float()
    aux = e * torch.sum(counts / (t * k) * probs.mean(dim=0))

    # dropless dispatch: stable sort of the (token, slot) pairs by expert
    order = torch.argsort(flat_expert, stable=True)
    tok_sorted = torch.div(order, k, rounding_mode="floor")  # flat_token[order]
    w_sorted = top_w.reshape(-1)[order]
    xs = xf.index_select(0, tok_sorted)  # (T*k, D)
    sizes = counts.to(torch.int64).tolist()  # the layer's one host sync
    HOST_SYNCS[0] += 1

    ew = p["experts"]
    gate = _grouped(xs, ew["gate_proj"].to(dt), sizes)
    up = _grouped(xs, ew["up_proj"].to(dt), sizes)
    h = F.silu(gate.float()).to(dt) * up
    ys = _grouped(h, ew["down_proj"].to(dt), sizes)

    y = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    y = y.index_add(0, tok_sorted, ys.float() * w_sorted[:, None])
    out = y.to(dt).reshape(b, s, d)
    if "shared_mlp" in p:
        out = out + L.apply_mlp(p["shared_mlp"], x, cfg.with_(mlp_kind="swiglu"))
    return out, aux


def apply_moe_mlp(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """The local dropless path; the expert-parallel dispatch over a mesh
    comes with ROADMAP queue 1 item 11, second half."""
    if torch.distributed.is_available() and torch.distributed.is_initialized() \
            and torch.distributed.get_world_size() > 1:
        raise NotImplementedError(
            "MoE expert parallelism over a mesh is not yet ported to "
            "repro_torch (ROADMAP queue 1 item 11, second half); run on one device")
    return apply_moe_local(p, x, cfg)


def moe_mlp_fn(p: Params, h: torch.Tensor, cfg: ModelConfig):
    return apply_moe_mlp(p["moe"], h, cfg)


# ---------------------------------------------------------------------------
# MoE decoder LM = transformer scaffolding with the MoE mlp_fn
# ---------------------------------------------------------------------------


def init_blocks(gen: torch.Generator, cfg: ModelConfig, dev, put) -> Params:
    """The attention half of a dense block (swiglu) and ``moe`` in place of
    its ``mlp``, as ``moe.init_block``."""
    blocks = tfm.init_attn_block(gen, cfg.with_(mlp_kind="swiglu"), dev, put)
    blocks["moe"] = init_moe_mlp(gen, cfg, (cfg.n_layers,), dev, put)
    return blocks


def init_params(gen: torch.Generator, cfg: ModelConfig, device="cuda", *, serving=False):
    return tfm.init_params(gen, cfg, device, serving=serving, init_blocks=init_blocks)


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    return tfm.loss_fn(params, cfg, batch, mlp_fn=moe_mlp_fn,
                       aux_weight=cfg.router_aux_weight)


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor, **kw):
    return tfm.prefill(params, cfg, tokens, mlp_fn=moe_mlp_fn, **kw)


def decode_step(params: Params, cfg: ModelConfig, cache, token: torch.Tensor):
    return tfm.decode_step(params, cfg, cache, token, mlp_fn=moe_mlp_fn)
