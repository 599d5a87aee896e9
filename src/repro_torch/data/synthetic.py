"""Deterministic, seekable synthetic LM data, from
``src/repro/data/synthetic.py``: the ``bigram`` corpus.

Tokens follow a fixed random low-rank bigram model (logits = E1[t] @ E2^T,
rank 16, frozen from the seed), so a capable LM drives the loss toward the
bigram entropy.  Every batch is a pure function of (seed, step).  The
draws come from ``torch.Generator``s on the dataset's device, so they are
not JAX's threefry draws: the parity tests hand both packages the JAX
batches.  The ``zipf`` corpus comes with a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class SyntheticDataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    dist: str = "bigram"  # bigram (zipf: a later slice)
    bigram_rank: int = 16
    temperature: float = 1.0


class SyntheticDataset:
    def __init__(self, cfg: SyntheticDataConfig, device: DeviceLike = "cuda"):
        if cfg.dist == "zipf":
            raise NotImplementedError(
                "the zipf corpus is not yet ported to repro_torch; use dist='bigram'"
            )
        if cfg.dist != "bigram":
            raise ValueError(f"unknown dist {cfg.dist!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        shape = (cfg.vocab_size, cfg.bigram_rank)
        self._e1 = torch.randn(shape, generator=gen, device=self.device)
        self._e2 = torch.randn(shape, generator=gen, device=self.device)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """{"tokens", "labels"} (B, S) int32; labels are the next tokens,
        -1 at the last position."""
        cfg = self.cfg
        b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        gen = torch.Generator(device=self.device).manual_seed(
            (cfg.seed * 1_000_003 + step + 1) % (2**63 - 1)
        )
        tok = torch.randint(0, v, (b,), generator=gen, device=self.device)
        cols = [tok]
        for _ in range(s - 1):
            logits = (self._e1[tok] @ self._e2.T) / cfg.temperature
            u = torch.rand((b, v), generator=gen, device=self.device)
            gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))
            tok = torch.argmax(logits + gumbel, dim=-1)  # a categorical draw
            cols.append(tok)
        tokens = torch.stack(cols, dim=1).to(torch.int32)
        labels = torch.cat(
            [tokens[:, 1:], torch.full((b, 1), -1, dtype=torch.int32, device=self.device)],
            dim=1,
        )
        return {"tokens": tokens, "labels": labels}
