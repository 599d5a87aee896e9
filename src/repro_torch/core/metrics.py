"""Subspace diagnostics of the paper's empirical sections, from
``src/repro/core/metrics.py``.

* ``subspace_overlap`` -- the GARD18 metric of Section 4.3,
  overlap(U, V) = ||U^T V||_F^2 / r, in [0, 1]; 1 iff span(U) == span(V)
  for orthonormal U, V of equal rank.
* ``OverlapTracker`` -- adjacent and anchor overlap series during training
  (Fig. 2, Fig. 3), fed by ``train_loop(track_subspace=True)``.
* ``update_singular_spectrum`` -- normalized singular values of a weight
  delta (Fig. 4); ``effective_rank`` -- exp(entropy) of a spectrum.

Everything stays on the tensors' device; only the tracker's scalars come
to the host.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.core import buckets as buckets_lib


def subspace_overlap(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """GARD18 overlap between orthonormal bases u (.., m, r) and v (.., m, r')."""
    r = v.shape[-1]
    c = torch.einsum("...mr,...ms->...rs", u.float(), v.float())
    return torch.sum(c * c, dim=(-2, -1)) / r


def update_singular_spectrum(w_before: torch.Tensor, w_after: torch.Tensor) -> torch.Tensor:
    """Normalized singular values of the weight delta (Fig. 4)."""
    s = torch.linalg.svdvals((w_after - w_before).float())
    return s / (s[..., :1] + 1e-12)


def effective_rank(s: torch.Tensor) -> torch.Tensor:
    """exp(entropy) of the normalized spectrum: a scalar rank proxy."""
    p = s / (torch.sum(s, dim=-1, keepdim=True) + 1e-12)
    h = -torch.sum(torch.where(p > 0, p * torch.log(p + 1e-12), torch.zeros_like(p)), dim=-1)
    return torch.exp(h)


class OverlapTracker:
    """Adjacent and anchor projector overlaps during training, per leaf
    (a stacked (L, d, r) projector averages over its L slices)."""

    def __init__(self) -> None:
        self._prev: Dict[str, torch.Tensor] = {}
        self._anchor: Dict[str, torch.Tensor] = {}
        self.adjacent: Dict[str, List[float]] = {}
        self.anchored: Dict[str, List[float]] = {}

    def set_anchor(self, projectors: Dict[str, torch.Tensor]) -> None:
        self._anchor = {k: torch.as_tensor(v).detach().clone() for k, v in projectors.items()}

    def observe(self, projectors: Dict[str, torch.Tensor]) -> None:
        for name, p in projectors.items():
            # a copy: the stacks the projector views may be reused
            p = torch.as_tensor(p).detach().clone()
            if name in self._prev:
                ov = float(torch.mean(subspace_overlap(self._prev[name], p)))
                self.adjacent.setdefault(name, []).append(ov)
            if name in self._anchor:
                ov = float(torch.mean(subspace_overlap(self._anchor[name], p)))
                self.anchored.setdefault(name, []).append(ov)
            self._prev[name] = p

    def summary(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for name, series in self.adjacent.items():
            if series:
                out.setdefault(name, {})["adjacent_mean"] = float(sum(series) / len(series))
                out[name]["adjacent_last"] = float(series[-1])
        for name, series in self.anchored.items():
            if series:
                out.setdefault(name, {})["anchor_last"] = float(series[-1])
        return out


def collect_projectors(opt_state, specs, layout=None) -> Dict[str, torch.Tensor]:
    """{path: P} of every low-rank leaf of an optimizer state.  A
    bucket-native state keeps its projectors in ``opt_state.buckets``, so
    it needs ``layout=optimizer.state_layout``."""
    stacked = {}
    if opt_state.buckets:
        if layout is None:
            raise ValueError(
                "opt_state is bucket-native (projectors live in state.buckets); "
                "pass layout=optimizer.state_layout"
            )
        stacked = buckets_lib.leaf_projectors(layout, opt_state.buckets)
    return {spec.path: stacked.get(i, st.projector)
            for i, (spec, st) in enumerate(zip(specs, opt_state.leaves)) if spec.lowrank}
