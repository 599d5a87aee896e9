"""Deterministic, seekable synthetic LM data, from
``src/repro/data/synthetic.py``:

  * ``bigram`` -- tokens follow a fixed random low-rank bigram model
    (logits = E1[t] @ E2^T, rank 16, frozen from the seed), so a capable LM
    drives the loss toward the bigram entropy;
  * ``zipf`` -- Zipf-distributed unigrams (logits -1.1 log(rank)) with a
    positional drift: position p of S falls in bucket p * 64 // S, and each
    of the 64 buckets adds its own frozen N(0, 0.5^2) offset per token.
    The paper's second corpus (the SlimPajama analog of its Table 4).

Every batch is a pure function of (seed, step), so a resumed run reads the
uninterrupted run's batches with no iterator state to checkpoint.  The
draws come from ``torch.Generator``s on the dataset's device, so they are
not JAX's threefry draws: the parity tests hand both packages the JAX
batches.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import torch

from repro_torch.device import DeviceLike, resolve_device

ZIPF_BUCKETS = 64  # positional-drift buckets of the zipf corpus


@dataclasses.dataclass(frozen=True)
class SyntheticDataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    dist: str = "bigram"  # bigram | zipf
    bigram_rank: int = 16
    temperature: float = 1.0


class SyntheticDataset:
    def __init__(self, cfg: SyntheticDataConfig, device: DeviceLike = "cuda"):
        if cfg.dist not in ("bigram", "zipf"):
            raise ValueError(f"unknown dist {cfg.dist!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        if cfg.dist == "bigram":
            shape = (cfg.vocab_size, cfg.bigram_rank)
            self._e1 = torch.randn(shape, generator=gen, device=self.device)
            self._e2 = torch.randn(shape, generator=gen, device=self.device)
        else:
            ranks = torch.arange(1, cfg.vocab_size + 1, dtype=torch.float32, device=self.device)
            self._logits = -1.1 * torch.log(ranks)
            self._drift = torch.randn((ZIPF_BUCKETS, cfg.vocab_size), generator=gen,
                                      device=self.device) * 0.5

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """{"tokens", "labels"} (B, S) int32; labels are the next tokens,
        -1 at the last position."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(
            (cfg.seed * 1_000_003 + step + 1) % (2**63 - 1)
        )
        tokens = self._zipf(gen) if cfg.dist == "zipf" else self._bigram(gen)
        b = cfg.global_batch
        labels = torch.cat(
            [tokens[:, 1:], torch.full((b, 1), -1, dtype=torch.int32, device=self.device)],
            dim=1,
        )
        return {"tokens": tokens, "labels": labels}

    def iter(self, start_step: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1

    def bigram_entropy(self, n_mc: int = 4096) -> float:
        """Monte-Carlo estimate of the per-token entropy floor (bigram)."""
        if self.cfg.dist != "bigram":
            raise ValueError("entropy floor only defined for bigram")
        gen = torch.Generator(device=self.device).manual_seed(1234)
        toks = torch.randint(0, self.cfg.vocab_size, (n_mc,), generator=gen, device=self.device)
        logits = (self._e1[toks] @ self._e2.T) / self.cfg.temperature
        logp = torch.log_softmax(logits, dim=-1)
        return float(torch.mean(-torch.sum(torch.exp(logp) * logp, dim=-1)))

    def _position_probs(self) -> torch.Tensor:
        """(S, V): position p's unigram distribution, the softmax of the
        logits plus the drift of bucket p * 64 // S (zipf)."""
        bucket = torch.arange(self.cfg.seq_len, device=self.device) * ZIPF_BUCKETS // self.cfg.seq_len
        return torch.softmax(self._logits[None, :] + self._drift[bucket], dim=-1)

    def _zipf(self, gen: torch.Generator) -> torch.Tensor:
        """(B, S) independent draws, position p from ``_position_probs()[p]``
        (``multinomial``: one (S, V) table, not a (B, S, V) Gumbel tensor)."""
        probs = self._position_probs()
        return torch.multinomial(probs, self.cfg.global_batch, replacement=True,
                                 generator=gen).T.to(torch.int32)

    def _bigram(self, gen: torch.Generator) -> torch.Tensor:
        cfg = self.cfg
        b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        tok = torch.randint(0, v, (b,), generator=gen, device=self.device)
        cols = [tok]
        for _ in range(s - 1):
            logits = (self._e1[tok] @ self._e2.T) / cfg.temperature
            u = torch.rand((b, v), generator=gen, device=self.device)
            gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))
            tok = torch.argmax(logits + gumbel, dim=-1)  # a categorical draw
            cols.append(tok)
        return torch.stack(cols, dim=1).to(torch.int32)
