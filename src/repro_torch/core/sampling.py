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
stack (B, m) alike.
"""
from __future__ import annotations

from typing import Sequence, Tuple

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


# The batched forms of the JAX module are the same functions on (B, ...)
# stacks: one batched top-k and one batched gather.
gumbel_topk_indices_batched = gumbel_topk_indices
sara_select_batched = sara_select
