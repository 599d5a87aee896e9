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


def tp_hot_comm_bytes(cfg: ModelConfig, rows: int, seq: int, plan, act_bytes: int,
                      tp: int = 2) -> int:
    """Bytes one process hands the ``model`` collectives in a hot step of a
    model of ``cfg`` (any family but MoE, whose expert exchange is not
    counted here) at a ``model`` extent of ``tp``, with block recomputation
    (``remat="block"``), for ``rows`` of ``seq`` tokens and a compute dtype
    of ``act_bytes``; ``plan`` is this process's bucket plan
    (``Bucket.split``).  A leaf splits where ``launch/sharding``'s guard
    splits it (``parallel.splits_over_model``); the count assumes a split
    attention leaf falls on this process's heads.  Every all-reduce counts
    its input, every all-gather its output; a block's recomputation re-runs
    its collectives up to the last tensor its backward saves, so the
    reduction that ends a block (the MLP's, or mamba2's ``out_proj``) runs
    once.  The family module's ``tp_comm_bytes`` counts its layers, from
    ``transformer.tp_attn_bytes``, ``tp_mlp_bytes`` and ``tp_lm_bytes`` and
    ``ssm.tp_mixer_bytes``; then the optimizer's: each "d" bucket's partial
    R, f32 (B, r, n).

    No counterpart in the reference (its collectives are GSPMD's);
    ``launch/mesh.COMM`` counts what the step hands them."""
    libs = {"dense": tfm, "vlm": vlm_lib, "audio": encdec_lib, "hybrid": hybrid_lib,
            "ssm": ssm_lib}
    if cfg.family not in libs:
        raise NotImplementedError(f"the {cfg.family} family's bytes over model are not counted")
    layers = libs[cfg.family].tp_comm_bytes(cfg, rows, seq, tp, act_bytes)
    return layers + sum(bk.batch * bk.rank * bk.n * 4 for bk in plan.buckets if bk.split == "d")


def count_params(params: Any) -> int:
    """Elements over every leaf of a params tree (nested dicts of tensors)."""
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return params.numel()
