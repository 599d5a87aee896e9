"""Shared layers, from ``src/repro/models/layers.py``: plain functions over
parameter dicts whose names follow the JAX tree (``*_proj``, ``embed``,
``lm_head``, ``*_norm``, ``*_bias``).  ``chunked_cross_entropy`` comes with
the training slice.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops

Params = Dict[str, object]

# ---------------------------------------------------------------------------
# Initializers (draws from a torch.Generator: they cannot reproduce JAX's
# threefry draws, so parity tests carry JAX weights across with bridge.py)
# ---------------------------------------------------------------------------


def dense_init(
    gen: torch.Generator, shape: Sequence[int], scale: Optional[float] = None,
    dtype=torch.float32, device=None,
) -> torch.Tensor:
    """Truncated-normal (+-3 sigma) fan-in init; ``shape`` is (..., m, n)
    and the fan-in is m, so a stacked (L, m, n) leaf draws all layers."""
    if scale is None:
        scale = 1.0 / math.sqrt(shape[-2])
    w = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return w.mul_(scale).to(dtype)


def embed_init(
    gen: torch.Generator, vocab: int, d: int, dtype=torch.float32, device=None
) -> torch.Tensor:
    w = torch.empty((vocab, d), dtype=torch.float32, device=device)
    w.normal_(0.0, 1.0, generator=gen)
    return w.mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    # The Triton kernel for CUDA tensors, the plain version for CPU tensors
    # (kernels/rmsnorm/ops.py); identical numerics.
    return rmsnorm_ops.rmsnorm(x, scale, eps)


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
    gen: torch.Generator, cfg: ModelConfig, lead: Sequence[int] = (),
    device=None,
) -> Params:
    """MLP params with leading dims ``lead`` ((n_layers,) for the stacked
    block leaves)."""
    d, ff = cfg.d_model, cfg.d_ff
    dt = cfg.param_dtype
    lead = tuple(lead)
    out_scale = 1.0 / math.sqrt(ff * 2 * cfg.n_layers)
    if cfg.mlp_kind not in ("swiglu", "squared_relu"):
        raise ValueError(f"unknown mlp_kind {cfg.mlp_kind}")
    p = {}
    if cfg.mlp_kind == "swiglu":
        p["gate_proj"] = dense_init(gen, lead + (d, ff), dtype=dt, device=device)
    p["up_proj"] = dense_init(gen, lead + (d, ff), dtype=dt, device=device)
    p["down_proj"] = dense_init(
        gen, lead + (ff, d), scale=out_scale, dtype=dt, device=device
    )
    return p


def apply_mlp(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    # ``.to(dt)`` is a no-op on weights already cast for serving.
    dt = x.dtype
    if cfg.mlp_kind == "swiglu":
        g = x @ params["gate_proj"].to(dt)
        u = x @ params["up_proj"].to(dt)
        h = F.silu(g.float()).to(dt) * u
        return h @ params["down_proj"].to(dt)
    # nemotron-4: squared ReLU, no gate
    u = x @ params["up_proj"].to(dt)
    h = torch.square(torch.relu(u.float())).to(dt)
    return h @ params["down_proj"].to(dt)
