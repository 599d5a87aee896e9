"""Shared layers, from ``src/repro/models/layers.py``: plain functions over
parameter dicts whose names follow the JAX tree (``*_proj``, ``embed``,
``lm_head``, ``*_norm``, ``*_bias``).

Under tensor parallelism (``models/parallel.py``: a step run with a
``model`` extent above 1) ``apply_mlp`` is Megatron's column-parallel
``gate``/``up`` and row-parallel ``down``, and ``chunked_cross_entropy``
is vocab-parallel, wherever the name-based rules split those leaves (a
leaf narrower than the given width is a block).  JAX's
``manual_axis_names`` and ``shard_activations`` (``layers.py:180-253``)
are placement hints for XLA with no arithmetic of their own: they have
no counterpart here.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
from repro_torch.models import parallel as par

Params = Dict[str, object]

# ---------------------------------------------------------------------------
# Initializers (draws from a torch.Generator: they cannot reproduce JAX's
# threefry draws, so parity tests carry JAX weights across with bridge.py)
# ---------------------------------------------------------------------------


def dense_init(
    gen: torch.Generator, shape: Sequence[int], scale: Optional[float] = None,
    dtype=torch.float32, device=None, out_dtype=None,
) -> torch.Tensor:
    """Truncated-normal (+-3 sigma) fan-in init; ``shape`` is (..., m, n)
    and the fan-in is m.  A stacked leaf ((L, m, n), or (L, E, m, n)) is
    drawn one slice of its first axis at a time, in f32, scaled, cast to
    ``dtype`` and written into a stack made in ``out_dtype`` (default
    ``dtype``): a serving init (``out_dtype`` bf16) never holds the whole
    leaf in f32, and draws the same numbers as the f32 init."""
    shape = tuple(shape)
    if scale is None:
        scale = 1.0 / math.sqrt(shape[-2])

    def draw(part):
        w = torch.empty(part, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=gen)
        return w.mul_(scale).to(dtype)

    if len(shape) <= 2:
        return draw(shape).to(out_dtype or dtype)
    out = torch.empty(shape, dtype=out_dtype or dtype, device=device)
    for i in range(shape[0]):
        out[i] = draw(shape[1:])
    return out


def embed_init(
    gen: torch.Generator, vocab: int, d: int, dtype=torch.float32, device=None
) -> torch.Tensor:
    w = torch.empty((vocab, d), dtype=torch.float32, device=device)
    w.normal_(0.0, 1.0, generator=gen)
    return w.mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5,
            ss: Optional[torch.Tensor] = None, width: Optional[int] = None) -> torch.Tensor:
    # The Triton kernel for CUDA tensors, the plain version for CPU tensors
    # (kernels/rmsnorm/ops.py); identical numerics.  ``ss``: each row's sum
    # of squares over ``width`` channels, when x holds only some of them.
    return rmsnorm_ops.rmsnorm(x, scale, eps, ss, width)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim//2,) inverse frequencies."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding.  x: (B, S, H, D), positions: (B, S) int."""
    d = x.shape[-1]
    inv = rope_frequencies(d, theta, x.device)
    ang = positions.float()[..., None] * inv  # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------


def init_mlp(
    gen: torch.Generator, cfg: ModelConfig, lead: Sequence[int], put,
    device=None, d_ff: Optional[int] = None,
) -> Params:
    """MLP params with leading dims ``lead`` ((n_layers,) for the stacked
    block leaves), ``d_ff`` wide (default ``cfg.d_ff``; MoE's fused shared
    experts are ``n_shared_experts * d_ff``), each projection made by
    ``put`` (a ``transformer.LeafMaker``) in its stored dtype."""
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    lead = tuple(lead)
    out_scale = 1.0 / math.sqrt(ff * 2 * cfg.n_layers)
    if cfg.mlp_kind not in ("swiglu", "squared_relu"):
        raise ValueError(f"unknown mlp_kind {cfg.mlp_kind}")

    def proj(name, shape, scale=None):
        return put.dense(name, gen, lead + shape, scale=scale, device=device)

    p = {}
    if cfg.mlp_kind == "swiglu":
        p["gate_proj"] = proj("gate_proj", (d, ff))
    p["up_proj"] = proj("up_proj", (d, ff))
    p["down_proj"] = proj("down_proj", (ff, d), out_scale)
    return p


def apply_mlp(params: Params, x: torch.Tensor, cfg: ModelConfig,
              d_ff: Optional[int] = None) -> torch.Tensor:
    """The MLP of width ``d_ff`` (default ``cfg.d_ff``).  Under tensor
    parallelism with ``up_proj`` a column block of that width, this
    process's block of the hidden units, then one f32 all-reduce of the
    partial outputs (``reduce_from_model``)."""
    # ``.to(dt)`` is a no-op on weights already cast for serving.
    dt = x.dtype
    ax = par.model_axes()
    split = ax is not None and params["up_proj"].shape[-1] != (d_ff or cfg.d_ff)
    if split:
        x = par.copy_to_model(x, ax)
    if cfg.mlp_kind == "swiglu":
        g = x @ params["gate_proj"].to(dt)
        u = x @ params["up_proj"].to(dt)
        h = F.silu(g.float()).to(dt) * u
    else:  # nemotron-4: squared ReLU, no gate
        u = x @ params["up_proj"].to(dt)
        h = torch.square(torch.relu(u.float())).to(dt)
    out = h @ params["down_proj"].to(dt)
    return par.reduce_from_model(out.float(), ax).to(dt) if split else out


# ---------------------------------------------------------------------------
# Chunked cross entropy (memory-efficient loss for huge vocab x long seq)
# ---------------------------------------------------------------------------


def _xent_chunk(hc: torch.Tensor, lm_head: torch.Tensor, yc: torch.Tensor):
    """(summed NLL, token count) of one sequence chunk; labels < 0 masked."""
    logits = (hc @ lm_head.to(hc.dtype)).float()
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, yc.clamp(min=0).long()[..., None])[..., 0]
    mask = (yc >= 0).float()
    return torch.sum((logz - picked) * mask), torch.sum(mask)


def _xent_chunk_vocab_parallel(hc: torch.Tensor, lm_head: torch.Tensor, yc: torch.Tensor,
                               ax) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_xent_chunk`` with ``lm_head`` this process's (D, V / tp) block of
    the vocab: each token's max, sum of exponentials and target logit in
    f32, each reduced over ``model`` (the max without a gradient)."""
    vl = lm_head.shape[-1]
    logits = (par.copy_to_model(hc, ax) @ lm_head.to(hc.dtype)).float()
    m = par.max_over_model(logits.amax(dim=-1), ax)
    se = par.reduce_from_model(torch.exp(logits - m[..., None]).sum(dim=-1), ax)
    logz = m + torch.log(se)
    yl = yc.long() - ax.index * vl
    mine = (yl >= 0) & (yl < vl)
    picked = torch.gather(logits, -1, yl.clamp(0, vl - 1)[..., None])[..., 0]
    picked = par.reduce_from_model(torch.where(mine, picked, torch.zeros_like(picked)), ax)
    mask = (yc >= 0).float()
    return torch.sum((logz - picked) * mask), torch.sum(mask)


def chunked_cross_entropy(
    hidden: torch.Tensor,  # (B, S, D)
    lm_head: torch.Tensor,  # (D, V)
    labels: torch.Tensor,  # (B, S) int; -1 = masked
    chunk: int = 2048,
    vocab: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean NLL over non-masked tokens without materializing (B, S, V)
    logits: the sequence runs in chunks (the batch dim is kept), logits are
    f32, and each chunk is recomputed in backward (``checkpoint``) instead
    of storing its O(B x chunk x V) residuals.  Returns (mean_loss,
    n_tokens), as ``src/repro/models/layers.py:132-172``; the ragged last
    chunk is sliced rather than padded with masked labels (same sums).
    Under tensor parallelism with ``lm_head`` narrower than ``vocab``,
    each chunk is vocab-parallel (``_xent_chunk_vocab_parallel``)."""
    ax = par.model_axes()
    if ax is not None and vocab and lm_head.shape[-1] != vocab:
        fn = lambda hc, w, yc: _xent_chunk_vocab_parallel(hc, w, yc, ax)  # noqa: E731
    else:
        fn = _xent_chunk
    s = hidden.shape[1]
    cs = min(chunk, s)
    total = hidden.new_zeros((), dtype=torch.float32)
    count = hidden.new_zeros((), dtype=torch.float32)
    for start in range(0, s, cs):
        hc = hidden[:, start:start + cs]
        yc = labels[:, start:start + cs]
        if torch.is_grad_enabled():
            nll, n = checkpoint(fn, hc, lm_head, yc, use_reentrant=False)
        else:
            nll, n = fn(hc, lm_head, yc)
        total = total + nll
        count = count + n
    return total / torch.clamp(count, min=1.0), count
