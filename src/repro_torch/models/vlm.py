"""LLaVA-NeXT backbone (llava-next-34b), from ``src/repro/models/vlm.py``:
the decoder LM consuming a prefix of precomputed anyres patch embeddings
(the vision tower is a stub: the caller supplies (B, n_patches, d_model)
directly).

A learned ``patch_in_proj`` adapter (the multimodal projector's last
linear) maps the embeddings into the residual stream; the rest is the
dense transformer, with the patches ahead of the text in the sequence and
in the KV cache.  Loss is next-token on the text positions only.

Under tensor parallelism ``patch_in_proj`` is column-parallel: each
process multiplies by its columns and the outputs are gathered over
``model`` (in the compute dtype); under FSDP the leaf is gathered over
``data`` where it is used.  The rest is the dense model's.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import parallel as par
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
    w = par.gather_leaf(params["patch_in_proj"], "['patch_in_proj']")
    out = patch_embeds.to(cfg.dtype) @ w.to(cfg.dtype)
    ax = par.model_axes()
    if ax is not None and w.shape[-1] != cfg.d_model:
        out = par.gather_from_model(out, ax, -1)  # this process's columns of the output
    return out


def tp_comm_bytes(cfg: ModelConfig, rows: int, seq: int, tp: int, act_bytes: int) -> int:
    """llava's bytes over ``model`` in a hot step (``models.tp_hot_comm_bytes``):
    the adapter's output gathered (compute dtype) where ``patch_in_proj``
    splits, then the decoder over the patches and the text."""
    d = cfg.d_model
    adapter = rows * cfg.n_patches * d * act_bytes if par.splits_over_model(d, tp) else 0
    return adapter + tfm.tp_comm_bytes(cfg, rows, seq, tp, act_bytes,
                                       prefix_len=cfg.n_patches)


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    b2 = dict(batch)
    b2["patch_embeds"] = _adapt(params, batch["patch_embeds"], cfg)
    return tfm.loss_fn(params, cfg, b2)


def prefill(params: Params, cfg: ModelConfig, tokens, patch_embeds, capacity=None):
    return tfm.prefill(params, cfg, tokens, prefix_embeds=_adapt(params, patch_embeds, cfg),
                       capacity=capacity)


def decode_step(params: Params, cfg: ModelConfig, cache, token):
    return tfm.decode_step(params, cfg, cache, token)
