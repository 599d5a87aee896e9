"""LLaVA-NeXT backbone (llava-next-34b), from ``src/repro/models/vlm.py``:
the decoder LM consuming a prefix of precomputed anyres patch embeddings
(the vision tower is a stub: the caller supplies (B, n_patches, d_model)
directly).

A learned ``patch_in_proj`` adapter (the multimodal projector's last
linear) maps the embeddings into the residual stream; the rest is the
dense transformer, with the patches ahead of the text in the sequence and
in the KV cache.  Loss is next-token on the text positions only.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm

Params = Dict[str, Any]


def init_params(gen: torch.Generator, cfg: ModelConfig, device="cuda", *, serving=False):
    """The dense init, then ``patch_in_proj`` (d_model x d_model)."""
    dev = resolve_device(device)
    params = tfm.init_params(gen, cfg, dev, serving=serving)
    params["patch_in_proj"] = tfm.LeafMaker(cfg, serving).dense(
        "patch_in_proj", gen, (cfg.d_model, cfg.d_model), device=dev)
    return params


def _adapt(params: Params, patch_embeds: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return patch_embeds.to(cfg.dtype) @ params["patch_in_proj"].to(cfg.dtype)


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    b2 = dict(batch)
    b2["patch_embeds"] = _adapt(params, batch["patch_embeds"], cfg)
    return tfm.loss_fn(params, cfg, b2)


def prefill(params: Params, cfg: ModelConfig, tokens, patch_embeds, capacity=None):
    return tfm.prefill(params, cfg, tokens, prefix_embeds=_adapt(params, patch_embeds, cfg),
                       capacity=capacity)


def decode_step(params: Params, cfg: ModelConfig, cache, token):
    return tfm.decode_step(params, cfg, cache, token)
