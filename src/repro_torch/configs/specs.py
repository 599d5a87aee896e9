"""Input specs for every (arch x shape) cell, from
``src/repro/configs/specs.py``: meta tensors of the batch's and the decode
cache's shapes and dtypes, which ``launch/dryrun.py`` builds against
without allocating anything.

Token counts follow the assignment: for the VLM the patch prefix plus the
text tokens sum to the shape's seq_len; for audio the encoder frames are
the 1500-frame stub and the seq_len is the decoder's length.
``concrete_train_batch`` is a small real batch for smoke runs, drawn from a
``torch.Generator`` (JAX's is drawn from a PRNG key, so the numbers
differ; the shapes and dtypes do not).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig

# VLM patch-prefix length per shape (anyres tiling: base 24x24 grid = 576;
# prefill_32k uses the full 4-tile + base anyres grid = 2880).
VLM_PATCHES = {"train_4k": 576, "prefill_32k": 2880}


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "vlm":
        p = VLM_PATCHES.get(shape.name, 576)
        return {
            "tokens": _spec((b, s - p), torch.int32),
            "labels": _spec((b, s - p), torch.int32),
            "patch_embeds": _spec((b, p, cfg.d_model), torch.bfloat16),
        }
    if cfg.family == "audio":
        return {
            "tokens": _spec((b, s), torch.int32),
            "labels": _spec((b, s), torch.int32),
            "frame_embeds": _spec((b, cfg.enc_frames, cfg.d_model), torch.bfloat16),
        }
    return {"tokens": _spec((b, s), torch.int32), "labels": _spec((b, s), torch.int32)}


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    specs = train_batch_specs(cfg, shape)
    specs.pop("labels")
    return specs


def decode_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    return {"token": _spec((shape.global_batch, 1), torch.int32)}


def decode_cache_specs(model, shape: ShapeConfig):
    """The decode cache at ``seq_len`` capacity, of meta tensors: ``model``
    built on the meta device (``build_model(cfg, device="meta")``)."""
    if model.device.type != "meta":
        raise ValueError(f"decode_cache_specs wants a model on the meta device, "
                         f"not {model.device}")
    return model.init_cache(shape.global_batch, shape.seq_len)


def concrete_train_batch(cfg: ModelConfig, batch: int, seq: int,
                         gen: Optional[torch.Generator] = None):
    """A small real batch for smoke runs (reduced configs), on ``gen``'s
    device."""
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    dev = gen.device
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen, device=dev,
                           dtype=torch.int32)
    out = {"tokens": tokens, "labels": tokens}
    if cfg.family == "vlm":
        p = max(4, min(8, seq // 4))
        out["tokens"] = tokens[:, : seq - p]
        out["labels"] = tokens[:, : seq - p]
        out["patch_embeds"] = (torch.randn((batch, p, cfg.d_model), generator=gen,
                                           device=dev) * 0.1).to(cfg.dtype)
    if cfg.family == "audio":
        out["frame_embeds"] = (torch.randn((batch, cfg.enc_frames, cfg.d_model), generator=gen,
                                           device=dev) * 0.1).to(cfg.dtype)
    return out
