"""Model interface, from ``src/repro/models/model_zoo.py``.

    model = build_model(cfg)                      # on cuda; device="cpu" to ask
    params = model.init(torch.Generator(model.device).manual_seed(0))
    logits, cache = model.prefill(params, {"tokens": ...})
    logits, cache = model.decode(params, cache, {"token": ...})
    loss, metrics = model.loss(params, {"tokens": ..., "labels": ...})
    cache = model.init_cache(batch, capacity)     # the family's decode cache

The vlm family's batches also carry ``patch_embeds`` (B, n_patches,
d_model), ahead of the tokens in the sequence and in the KV cache; the
audio family's carry ``frame_embeds`` (B, enc_frames, d_model), which feed
the encoder.  ``model.init(gen, serving=True)`` makes each leaf in its
serving dtype as it is drawn (``transformer.LeafMaker``), so a model whose
f32 params do not fit the card can still be served.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import hybrid as hybrid_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer as tfm
from repro_torch.models import vlm as vlm_lib

FAMILIES = ("dense", "moe", "vlm", "audio", "hybrid", "ssm")


class Model(NamedTuple):
    cfg: ModelConfig
    device: torch.device
    init: Callable[..., Any]  # (gen, serving=False)
    prefill: Callable[..., Any]  # (params, batch, capacity=None)
    decode: Callable[..., Any]  # (params, cache, batch)
    loss: Callable[..., Any]  # (params, batch) -> (loss, metrics)
    init_cache: Callable[[int, int], Any]  # (batch, capacity)


def build_model(cfg: ModelConfig, device: DeviceLike = "cuda") -> Model:
    fam = cfg.family
    if fam not in FAMILIES:
        raise ValueError(f"unknown family {fam!r}")
    dev = resolve_device(device)
    kv_cache = lambda batch, cap: tfm.init_kv_cache(cfg, batch, cap, device=dev)  # noqa: E731
    if fam == "dense":
        return Model(
            cfg=cfg, device=dev,
            init=lambda gen, serving=False: tfm.init_params(gen, cfg, dev, serving=serving),
            prefill=lambda p, b, capacity=None: tfm.prefill(
                p, cfg, b["tokens"], capacity=capacity or b["tokens"].shape[1]),
            decode=lambda p, c, b: tfm.decode_step(p, cfg, c, b["token"]),
            loss=lambda p, b: tfm.loss_fn(p, cfg, b),
            init_cache=kv_cache,
        )
    if fam == "moe":
        return Model(
            cfg=cfg, device=dev,
            init=lambda gen, serving=False: moe_lib.init_params(gen, cfg, dev, serving=serving),
            prefill=lambda p, b, capacity=None: moe_lib.prefill(
                p, cfg, b["tokens"], capacity=capacity or b["tokens"].shape[1]),
            decode=lambda p, c, b: moe_lib.decode_step(p, cfg, c, b["token"]),
            loss=lambda p, b: moe_lib.loss_fn(p, cfg, b),
            init_cache=kv_cache,
        )
    if fam == "vlm":
        return Model(
            cfg=cfg, device=dev,
            init=lambda gen, serving=False: vlm_lib.init_params(gen, cfg, dev, serving=serving),
            prefill=lambda p, b, capacity=None: vlm_lib.prefill(
                p, cfg, b["tokens"], b["patch_embeds"],
                capacity=capacity or b["tokens"].shape[1] + b["patch_embeds"].shape[1]),
            decode=lambda p, c, b: vlm_lib.decode_step(p, cfg, c, b["token"]),
            loss=lambda p, b: vlm_lib.loss_fn(p, cfg, b),
            init_cache=kv_cache,
        )
    if fam == "audio":
        return Model(
            cfg=cfg, device=dev,
            init=lambda gen, serving=False: encdec_lib.init_params(gen, cfg, dev,
                                                                   serving=serving),
            prefill=lambda p, b, capacity=None: encdec_lib.prefill(
                p, cfg, b["tokens"], b["frame_embeds"],
                capacity=capacity or b["tokens"].shape[1]),
            decode=lambda p, c, b: encdec_lib.decode_step(p, cfg, c, b["token"]),
            loss=lambda p, b: encdec_lib.loss_fn(p, cfg, b),
            init_cache=lambda batch, cap: encdec_lib.init_cache(cfg, batch, cap, device=dev),
        )
    if fam == "hybrid":
        return Model(
            cfg=cfg, device=dev,
            init=lambda gen, serving=False: hybrid_lib.init_params(gen, cfg, dev,
                                                                   serving=serving),
            prefill=lambda p, b, capacity=None: hybrid_lib.prefill(
                p, cfg, b["tokens"], capacity=capacity or b["tokens"].shape[1]),
            decode=lambda p, c, b: hybrid_lib.decode_step(p, cfg, c, b["token"]),
            loss=lambda p, b: hybrid_lib.loss_fn(p, cfg, b),
            init_cache=lambda batch, cap: hybrid_lib.init_cache(cfg, batch, cap, device=dev),
        )
    return Model(  # ssm
        cfg=cfg, device=dev,
        init=lambda gen, serving=False: ssm_lib.init_params(gen, cfg, dev, serving=serving),
        prefill=lambda p, b, capacity=None: ssm_lib.prefill(p, cfg, b["tokens"]),
        decode=lambda p, c, b: ssm_lib.decode_step(p, cfg, c, b["token"]),
        loss=lambda p, b: ssm_lib.loss_fn(p, cfg, b),
        init_cache=lambda batch, cap: ssm_lib.init_cache(cfg, batch, cap, device=dev),
    )


def count_params(params: Any) -> int:
    """Elements over every leaf of a params tree (nested dicts of tensors)."""
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return params.numel()
