"""Projector construction and application, from
``src/repro/core/projectors.py``.

A projector for a weight of shape (m, n) is an orthonormal (d, r) matrix P
with d = min(m, n):

  * side='left'  (m <= n): R = P^T G (r x n);  back: P @ D
  * side='right' (m >  n): R = G P   (m x r);  back: D @ P^T

Ported selection methods: ``dominant`` (GaLore: top-r left singular
vectors) and ``sara`` (the paper: r of the singular vectors sampled with
probability proportional to the singular value).  golore, grass,
online_pca and identity come with the remaining-projectors slice (ROADMAP
queue 1 item 7).

Random draws are inputs (``LeafDraws``): the Gaussian sketch of the
randomized SVD and SARA's Gumbel noise, one per slice of a leaf.
``draw_shapes`` says what a refresh consumes; the optimizer state's draw
source makes them (``core/lowrank.py::TorchDraws``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import sampling as sampling_lib
from repro_torch.core import svd as svd_lib

METHODS = ("dominant", "sara", "golore", "grass", "online_pca", "identity")
PORTED_METHODS = ("dominant", "sara")


def batched_refresh_supported(cfg: "ProjectorConfig") -> bool:
    """Can ``refresh_projector_stacked`` cover this config?  The ported
    (SVD-based) methods batch on the randomized backend only; the exact
    backend stays on the per-leaf loop, as in DESIGN.md §2.6."""
    return cfg.method in PORTED_METHODS and cfg.svd_backend == "randomized"


class ProjectorConfig(NamedTuple):
    method: str = "sara"
    rank: int = 128
    svd_backend: str = "exact"  # 'exact' | 'randomized'
    svd_oversample: int = 8
    svd_power_iters: int = 2
    sara_pool_factor: int = 4  # SARA's candidate pool under randomized SVD
    dtype: torch.dtype = torch.float32


class LeafDraws(NamedTuple):
    """The random inputs of one refresh, stacked over its slices: the
    sketch (nb, n, k') for the randomized backend and the Gumbel noise
    (nb, k) for sara; None where the config draws none."""

    omega: Optional[torch.Tensor]
    gumbel: Optional[torch.Tensor]


def projection_side(shape) -> str:
    """Which side to project: the smaller of the two trailing dims."""
    m, n = shape[-2], shape[-1]
    return "left" if m <= n else "right"


def projector_dim(shape) -> int:
    return min(shape[-2], shape[-1])


def project(g: torch.Tensor, p: torch.Tensor, side: str) -> torch.Tensor:
    """R = P^T G (left) or G P (right); batched over leading dims."""
    if side == "left":
        return torch.einsum("...dr,...dn->...rn", p, g)
    return torch.einsum("...md,...dr->...mr", g, p)


def backproject(d: torch.Tensor, p: torch.Tensor, side: str) -> torch.Tensor:
    """Full-space update from a projected direction."""
    if side == "left":
        return torch.einsum("...dr,...rn->...dn", p, d)
    return torch.einsum("...mr,...dr->...md", d, p)


def _pool_size(d: int, cfg: ProjectorConfig, rank: int) -> int:
    """k: how many singular vectors the SVD returns for this method."""
    if cfg.method == "dominant":
        return rank
    if cfg.method == "sara":
        if cfg.svd_backend == "exact":
            return d  # the paper samples from all d singular vectors
        return min(d, cfg.sara_pool_factor * rank)
    if cfg.method in METHODS:
        raise NotImplementedError(
            f"projector method {cfg.method!r} is not yet ported to repro_torch "
            "(it comes with the remaining-projectors slice, ROADMAP queue 1 "
            f"item 7); ported: {PORTED_METHODS}"
        )
    raise ValueError(f"unknown projector method {cfg.method!r}")


def draw_shapes(
    d: int, n: int, cfg: ProjectorConfig, rank: int
) -> Tuple[Optional[Tuple[int, int]], Optional[int]]:
    """Per-slice shapes of a refresh's draws for an oriented (d, n) slice:
    (sketch (n, k') or None, Gumbel length k or None)."""
    rank = min(rank, d)
    k = _pool_size(d, cfg, rank)
    sketch = None
    if cfg.svd_backend == "randomized":
        k, kp, _ = svd_lib.clamp_sketch(
            d, n, k, cfg.svd_oversample, cfg.svd_power_iters
        )
        sketch = (n, kp)
    return sketch, (min(k, d) if cfg.method == "sara" else None)


def _oriented(g: torch.Tensor, side: str) -> torch.Tensor:
    """The gradient with the projected dim first: (..., d, other)."""
    return g if side == "left" else g.transpose(-1, -2)


def refresh_projector_stacked(
    g: torch.Tensor,  # (B, d, n) oriented stack
    draws: LeafDraws,
    prev_p: Optional[torch.Tensor],
    cfg: ProjectorConfig,
    *,
    rank: int,
) -> torch.Tensor:
    """Refresh a whole (B, d, n) oriented gradient stack in one chain:
    batched sketch, power iterations through ``kernels/power_iter``,
    batched thin QR, one small batched SVD, batched Gumbel top-k.
    ``prev_p`` is unused by the ported (SVD-based) methods.  Returns a
    (B, d, rank) stack with orthonormal columns per slice."""
    del prev_p
    if cfg.method in ("dominant", "sara") and cfg.svd_backend != "randomized":
        raise ValueError(
            f"stacked {cfg.method!r} refresh requires svd_backend='randomized'"
        )
    return _refresh_stack(g, draws, cfg, rank)


def _refresh_stack(g: torch.Tensor, draws: LeafDraws, cfg: ProjectorConfig, rank: int):
    d = g.shape[-2]
    rank = min(rank, d)
    u, s = svd_lib.topk_svd_batched(
        g, _pool_size(d, cfg, rank), draws.omega, backend=cfg.svd_backend,
        oversample=cfg.svd_oversample, power_iters=cfg.svd_power_iters,
    )
    if cfg.method == "dominant":
        return u.to(cfg.dtype)
    p, _ = sampling_lib.sara_select(u, s, rank, draws.gumbel)
    return p.to(cfg.dtype)


def refresh_projector(
    g: torch.Tensor,
    draws: LeafDraws,
    prev_p: Optional[torch.Tensor],
    cfg: ProjectorConfig,
    *,
    side: Optional[str] = None,
    rank: Optional[int] = None,
) -> torch.Tensor:
    """A new projector from gradient ``g`` (any leading batch dims):
    P of shape (*batch, d, rank), orthonormal columns per slice."""
    del prev_p
    side = side or projection_side(g.shape)
    d = projector_dim(g.shape)
    rank = min(rank or cfg.rank, d)
    g2 = _oriented(g, side)
    batch_shape = tuple(g2.shape[:-2])
    out = _refresh_stack(
        g2.reshape((-1,) + tuple(g2.shape[-2:])).float(), draws, cfg, rank
    )
    return out.reshape(batch_shape + tuple(out.shape[-2:]))
