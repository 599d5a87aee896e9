"""Mixture-of-Experts FFN (deepseek-moe-16b, olmoe-1b-7b), from
``src/repro/models/moe.py``: the local dropless path
(``_apply_moe_local``, moe.py:76-126) and the expert-parallel path
(``_ep_local_fn`` / ``_apply_moe_ep``, moe.py:152-261).

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
(always-active experts' outputs sum).

The expert-parallel path (``apply_moe_ep``) runs under tensor parallelism
(``models/parallel.py``: a step with a ``model`` extent above 1), each
process holding E / model experts (``launch/sharding.param_spec``'s
``experts`` rule) and the replicated router: every process routes every
token identically, keeps the (token, slot) pairs of its own experts up to
a capacity of ``int(t k / E * moe_capacity_factor) + 1`` per expert (the
position in each expert by a cumulative sum; later pairs are dropped, as
in JAX), runs (E_loc, cap, d) batched products, adds its block of the
shared experts' hidden units, and one f32 all-reduce over ``model`` sums
the partial outputs.  The products are ``torch.bmm``, as JAX's are
einsums outside any Pallas kernel.  The aux loss is the same on every
process of ``model``; its mean over the data-parallel axes is the step's
(each process's loss carries its own rows' aux, and the step averages
the losses and the gradients).  Dropped pairs are counted on the device
in ``EP_DROPS`` (``ep_drops()`` reads them).

Under FSDP (the standard step at a ``data`` extent above 1) each process
holds its ``data`` block of the expert ``d_ff`` (the ``experts`` rule's
``data`` dim) and of the shared experts' leaves; the layer's params come
here already gathered over ``data`` (``transformer.dense_block`` calls
``parallel.gather_layer``), on the local path at a ``model`` extent of 1
and on the expert-parallel path above it, as JAX's ``_ep_local_fn``
gathers them (moe.py:167-172), and their gradients go back
reduce-scattered over ``data``.  JAX takes the EP path at a ``model``
extent of 1 too, the port does not (ROADMAP queue 3).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import parallel as par
from repro_torch.models import transformer as tfm

Params = Dict[str, Any]

# Host syncs for the group sizes, one per MoE layer call (see the module
# docstring); reset and read by whoever measures them.
HOST_SYNCS = [0]

# The expert-parallel path's routed (token, slot) pairs and the pairs it
# dropped past an expert's capacity, summed over its calls on this process
# (each pair is counted once, by the process that owns its expert).  The
# sums stay on the device, so counting adds no host sync to the step:
# ``ep_drops()`` reads them (one sync), ``reset_ep_drops()`` zeroes them.
EP_DROPS: Dict[str, Any] = {"routed": 0, "dropped": 0}


def reset_ep_drops() -> None:
    EP_DROPS.update(routed=0, dropped=0)


def ep_drops() -> Dict[str, int]:
    """``EP_DROPS`` read to the host: {"routed": n, "dropped": n}."""
    return {k: int(v) for k, v in EP_DROPS.items()}


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
        out = out + L.apply_mlp(p["shared_mlp"], x, cfg.with_(mlp_kind="swiglu"),
                                d_ff=cfg.n_shared_experts * cfg.d_ff)
    return out, aux


def ep_dispatch(top_i: torch.Tensor, e: int, e_loc: int, index: int, cap: int):
    """The (token, slot) pairs an expert-parallel process keeps, from the
    (T, k) routed experts: (keep (T*k,) bool, local expert (T*k,), slot in
    its expert (T*k,), owned (T*k,) bool).  A pair's slot is its position
    among its expert's pairs in (token, slot) order; pairs at or past
    ``cap`` are dropped (``_ep_local_fn``)."""
    flat_e = top_i.reshape(-1)
    onehot = torch.nn.functional.one_hot(flat_e, e)
    pos = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(dim=-1)
    lo = index * e_loc
    mine = (flat_e >= lo) & (flat_e < lo + e_loc)
    return mine & (pos < cap), flat_e - lo, pos, mine


def apply_moe_ep(p: Params, x: torch.Tensor, cfg: ModelConfig, ax) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) this process's rows -> (out (B, S, D), aux), the
    expert-parallel path (module docstring) with ``p["experts"]`` this
    process's (E_loc, ...) block of the experts."""
    b, s, d = x.shape
    t, k, e = b * s, cfg.moe_top_k, cfg.n_experts
    dt = x.dtype
    ew = p["experts"]
    e_loc = ew["gate_proj"].shape[0]
    if e_loc * ax.size != e:
        raise ValueError(f"{e} experts do not split over a model axis of {ax.size}: "
                         f"this process holds {e_loc}")
    cap = int(t * k / e * cfg.moe_capacity_factor) + 1
    xf = x.reshape(t, d)

    scores = xf.float() @ p["router_w"].float()
    probs = torch.softmax(scores, dim=-1)
    top_w, top_i = torch.topk(probs, k, dim=-1)
    top_w = top_w / (top_w.sum(dim=-1, keepdim=True) + 1e-9)
    counts = torch.bincount(top_i.reshape(-1), minlength=e).float()  # routed load, pre-drop
    aux = e * torch.sum(counts / (t * k) * probs.mean(dim=0))

    keep, e_idx, pos, mine = ep_dispatch(top_i, e, e_loc, ax.index, cap)
    EP_DROPS["routed"] = EP_DROPS["routed"] + mine.sum()  # on the device: no sync
    EP_DROPS["dropped"] = EP_DROPS["dropped"] + (mine & ~keep).sum()
    e_idx = torch.where(keep, e_idx, torch.full_like(e_idx, e_loc))  # overflow row
    slot = torch.where(keep, pos, torch.full_like(pos, cap))  # overflow slot
    flat_t = torch.arange(t, device=x.device).repeat_interleave(k)
    # the weights enter this process's own experts only: their gradient
    # is this process's part (``copy_to_model``)
    flat_w = par.copy_to_model(top_w, ax).reshape(-1)
    disp = torch.full((e_loc + 1, cap + 1), t, dtype=torch.long, device=x.device)
    disp = disp.index_put((e_idx, slot), flat_t)[:e_loc, :cap]
    wbuf = torch.zeros((e_loc + 1, cap + 1), dtype=torch.float32, device=x.device)
    wbuf = wbuf.index_put((e_idx, slot), flat_w)[:e_loc, :cap]

    xc = par.copy_to_model(xf, ax)
    x_pad = torch.cat([xc, xc.new_zeros((1, d))], dim=0)
    xs = x_pad[disp]  # (E_loc, cap, D)
    gate = torch.bmm(xs, ew["gate_proj"].to(dt))
    up = torch.bmm(xs, ew["up_proj"].to(dt))
    h = F.silu(gate.float()).to(dt) * up
    ys = torch.bmm(h, ew["down_proj"].to(dt))
    out = torch.zeros((t + 1, d), dtype=torch.float32, device=x.device)
    out = out.index_add(0, disp.reshape(-1), (ys * wbuf[..., None].to(dt)).reshape(-1, d).float())
    out = out[:t]
    shared_whole = None
    if "shared_mlp" in p:
        sm, width = p["shared_mlp"], cfg.n_shared_experts * cfg.d_ff
        if sm["up_proj"].shape[-1] != width:
            # this process's block of the fused shared experts' hidden units
            g = xc @ sm["gate_proj"].to(dt)
            u = xc @ sm["up_proj"].to(dt)
            hsh = F.silu(g.float()).to(dt) * u
            out = out + (hsh @ sm["down_proj"].to(dt)).float()
        else:
            # the rules left them whole: every process computes them
            shared_whole = L.apply_mlp(sm, x, cfg.with_(mlp_kind="swiglu"), d_ff=width)
    out = par.reduce_from_model(out, ax).to(dt).reshape(b, s, d)
    if shared_whole is not None:
        out = out + shared_whole
    return out, aux


def apply_moe_mlp(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """JAX's dispatch (moe.py:64-73): the expert-parallel path under a
    ``model`` axis above 1 (``models/parallel.py``), the local dropless
    path otherwise.  In a world of several processes the layer needs the
    mesh of the step (``make_train_step(mesh=...)``) to tell which path
    its params are cut for: without one it raises rather than run the
    local path on a block of the experts (ROADMAP queue 1 item 11)."""
    ax = par.model_axes()
    if ax is not None:
        return apply_moe_ep(p, x, cfg, ax)
    if par.active_axes() is None and torch.distributed.is_available() \
            and torch.distributed.is_initialized() and torch.distributed.get_world_size() > 1:
        raise NotImplementedError(
            "an MoE layer in a world of several processes runs under the mesh of its "
            "step, make_train_step(mesh=...), which picks the expert-parallel or the "
            "local path (ROADMAP queue 1 item 11)")
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
