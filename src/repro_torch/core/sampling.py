"""SARA's importance sampling (Algorithm 2, lines 4-5), from
``src/repro/core/sampling.py``.

r of m singular vectors are drawn without replacement with per-draw
probability proportional to the singular values, by the Gumbel top-k
trick: I = top-r(log w_i + Gumbel_i), then sorted ascending so the
selected basis columns keep a stable order across refreshes.

The Gumbel noise is an input here, never drawn inside (the JAX function
draws it from its key at ``sampling.py:56``): the port's refresh draws it
from a ``torch.Generator`` (``gumbel_noise``), and the parity tests hand in
JAX's own draws.  Every function works on one weight vector (m,) or a
stack (B, m) alike: Grass's row sampling draws over the d rows of each
slice, SARA's over the k singular values.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

_NEG_INF = -1e30


def gumbel_noise(
    shape: Sequence[int], generator: torch.Generator, device=None
) -> torch.Tensor:
    """Standard Gumbel draws, -log(-log(U)) with U uniform in [tiny, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(tuple(shape), generator=generator, device=device).clamp_(min=tiny)
    return -torch.log(-torch.log(u))


def gumbel_topk_indices(
    weights: torch.Tensor,  # (..., m) nonnegative
    r: int,
    gumbel: torch.Tensor,  # (..., m) standard Gumbel noise
    *,
    sort_indices: bool = True,
) -> torch.Tensor:
    """Sample r distinct indices per row with probability proportional to
    ``weights``.  Zero weights are never selected unless a row is all zero,
    in which case it samples uniformly (a zero gradient at step 0)."""
    m = weights.shape[-1]
    if r > m:
        raise ValueError(f"cannot sample {r} of {m} indices without replacement")
    w = weights.float()
    total = w.sum(dim=-1, keepdim=True)
    w = torch.where(total > 0, w, torch.ones_like(w))
    logw = torch.where(
        w > 0, torch.log(torch.clamp(w, min=1e-38)), torch.full_like(w, _NEG_INF)
    )
    # top-r by a stable descending sort: exact ties (zero weights score
    # -1e30 whatever their noise) go to the lowest index, as lax.top_k's do
    order = torch.sort(logw + gumbel.float(), dim=-1, descending=True, stable=True)
    idx = order.indices[..., :r]
    if sort_indices:
        idx = torch.sort(idx, dim=-1).values
    return idx


def sara_select(
    u: torch.Tensor,  # (..., d, k) left singular vectors
    s: torch.Tensor,  # (..., k) singular values
    r: int,
    gumbel: torch.Tensor,  # (..., k)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SARA subspace selection: r columns of ``u`` sampled with probability
    proportional to ``s``.  Returns (P (..., d, r), idx (..., r))."""
    idx = gumbel_topk_indices(s, r, gumbel, sort_indices=True)
    cols = idx[..., None, :].expand(*u.shape[:-1], r)
    return torch.gather(u, -1, cols), idx


def gumbel_topk_indices_batched(
    weights: torch.Tensor,  # (B, m)
    r: int,
    gumbel: torch.Tensor,  # (B, m)
    *,
    sort_indices: bool = True,
) -> torch.Tensor:
    """``gumbel_topk_indices`` over a (B, m) weight stack with one noise row
    per slice: slice ``b`` equals ``gumbel_topk_indices(weights[b], r,
    gumbel[b])``.  Returns (B, r) indices."""
    if weights.dim() != 2 or tuple(gumbel.shape) != tuple(weights.shape):
        raise ValueError(
            f"want (B, m) weights and noise, got {tuple(weights.shape)}, "
            f"{tuple(gumbel.shape)}"
        )
    return gumbel_topk_indices(weights, r, gumbel, sort_indices=sort_indices)


# The batched SARA selection is the same function on (B, d, k) stacks: one
# batched top-k and one batched gather.
sara_select_batched = sara_select


def inclusion_probabilities_mc(
    weights: torch.Tensor,  # (m,)
    r: int,
    gumbel: torch.Tensor,  # (n_samples, m) standard Gumbel noise
) -> torch.Tensor:
    """Monte-Carlo estimate of each index's inclusion probability P[i in I]
    under the sampler, one sample per row of ``gumbel`` (a test helper, to
    be compared with ``sequential_sample_reference``)."""
    n_samples, m = gumbel.shape
    idx = gumbel_topk_indices(weights.expand(n_samples, m), r, gumbel, sort_indices=False)
    hits = torch.zeros((n_samples, m), dtype=torch.float32, device=idx.device)
    hits.scatter_(1, idx, 1.0)
    return hits.mean(dim=0)


def sequential_sample_reference(weights, r: int, rng: np.random.Generator):
    """NumPy reference of the paper's sequential sampling law (test oracle):
    r draws without replacement, each with probability proportional to the
    remaining weights; returns the sorted indices."""
    w = np.asarray(weights, dtype=np.float64).copy()
    idx = []
    for _ in range(r):
        i = rng.choice(len(w), p=w / w.sum())
        idx.append(int(i))
        w[i] = 0.0
    return sorted(idx)
