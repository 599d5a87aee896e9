"""Model interface, from ``src/repro/models/model_zoo.py``.

    model = build_model(cfg)                      # on cuda; device="cpu" to ask
    params = model.init(torch.Generator(model.device).manual_seed(0))
    logits, cache = model.prefill(params, {"tokens": ...})
    logits, cache = model.decode(params, cache, {"token": ...})
    loss, metrics = model.loss(params, {"tokens": ..., "labels": ...})

Only ``family="dense"`` is ported.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tfm

FAMILIES = ("dense", "moe", "vlm", "audio", "hybrid", "ssm")


class Model(NamedTuple):
    cfg: ModelConfig
    device: torch.device
    init: Callable[[torch.Generator], Any]
    prefill: Callable[..., Any]  # (params, batch, capacity=None)
    decode: Callable[..., Any]  # (params, cache, batch)
    loss: Callable[..., Any]  # (params, batch) -> (loss, metrics)


def build_model(cfg: ModelConfig, device: DeviceLike = "cuda") -> Model:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not yet ported to repro_torch (dense only)"
        )
    dev = resolve_device(device)
    return Model(
        cfg=cfg,
        device=dev,
        init=lambda gen: tfm.init_params(gen, cfg, dev),
        prefill=lambda p, b, capacity=None: tfm.prefill(
            p, cfg, b["tokens"], capacity=capacity or b["tokens"].shape[1]
        ),
        decode=lambda p, c, b: tfm.decode_step(p, cfg, c, b["token"]),
        loss=lambda p, b: tfm.loss_fn(p, cfg, b),
    )
