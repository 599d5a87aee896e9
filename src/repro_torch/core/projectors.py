"""Projector construction and application, from
``src/repro/core/projectors.py``.

A projector for a weight of shape (m, n) is an orthonormal (d, r) matrix P
with d = min(m, n):

  * side='left'  (m <= n): R = P^T G (r x n);  back: P @ D
  * side='right' (m >  n): R = G P   (m x r);  back: D @ P^T

Selection methods, the paper's and every baseline it compares with:

  * ``dominant``   -- GaLore: the top-r left singular vectors.
  * ``sara``       -- the paper: r of the singular vectors sampled with
                      probability proportional to the singular value.
  * ``golore``     -- GoLore: the Q of a Gaussian (d, r) draw, independent
                      of the gradient.
  * ``grass``      -- Grass: r rows sampled with probability proportional
                      to their squared norm; P is the one-hot selection (the
                      hot step still projects through the dense product).
  * ``online_pca`` -- online subspace descent: P <- qr(P + eta (G G^T) P)
                      with eta = lr / (||G||_F^2 + 1e-12) per slice; (G G^T) P
                      is the power-iteration kernel's product.
  * ``identity``   -- P = I (d x r), for tests.

Random draws are inputs (``LeafDraws``), one per slice of a leaf: the
Gaussian sketch of the randomized SVD and SARA's Gumbel noise over the k
singular values, Grass's Gumbel noise over the d rows, GoLore's Gaussian
basis.  ``draw_shapes`` says what a refresh consumes; the optimizer
state's draw source makes them (``core/lowrank.py::TorchDraws``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import sampling as sampling_lib
from repro_torch.core import svd as svd_lib
from repro_torch.kernels.power_iter import ops as power_ops

METHODS = ("dominant", "sara", "golore", "grass", "online_pca", "identity")

# Methods whose refresh is SVD-free and therefore always batchable.
_SVD_FREE_METHODS = frozenset({"identity", "golore", "grass", "online_pca"})

# Methods whose refresh consumes random draws, so that a new draw moves the
# refreshed subspace (what a rollback-and-resample recovery relies on):
# dominant, identity and online_pca are deterministic in (P_prev, G).
STOCHASTIC_REFRESH_METHODS = frozenset({"sara", "golore", "grass"})


def refresh_is_stochastic(method: str) -> bool:
    """Does a new draw move this method's refreshed subspace?"""
    return method in STOCHASTIC_REFRESH_METHODS


def batched_refresh_supported(cfg: "ProjectorConfig") -> bool:
    """Can ``refresh_projector_stacked`` cover this config?  The SVD-free
    methods always batch; dominant and sara batch on the randomized
    backend only, and the exact backend stays on the per-leaf loop, as in
    DESIGN.md §2.6."""
    if cfg.method in _SVD_FREE_METHODS:
        return True
    if cfg.method in ("dominant", "sara"):
        return cfg.svd_backend == "randomized"
    return False


class ProjectorConfig(NamedTuple):
    method: str = "sara"
    rank: int = 128
    svd_backend: str = "exact"  # 'exact' | 'randomized'
    svd_oversample: int = 8
    svd_power_iters: int = 2
    sara_pool_factor: int = 4  # SARA's candidate pool under randomized SVD
    online_pca_lr: float = 0.1
    dtype: torch.dtype = torch.float32


class LeafDraws(NamedTuple):
    """The random inputs of one refresh, stacked over its slices: the
    sketch (nb, n, k') for the randomized backend, the Gumbel noise (nb, k)
    for sara or (nb, d) for grass, and golore's Gaussian basis
    (nb, d, rank); None where the config draws none."""

    omega: Optional[torch.Tensor]
    gumbel: Optional[torch.Tensor]
    basis: Optional[torch.Tensor] = None


class DrawShapes(NamedTuple):
    """Per-slice shapes of a refresh's draws (``draw_shapes``); None where
    the config draws none."""

    sketch: Optional[Tuple[int, int]]  # (n, k') Gaussian sketch
    gumbel: Optional[int]  # Gumbel noise length: k (sara) or d (grass)
    basis: Optional[Tuple[int, int]] = None  # (d, rank) Gaussian (golore)


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


def residual(g: torch.Tensor, p: torch.Tensor, side: str) -> torch.Tensor:
    """(I - P P^T) G (left) or G (I - P P^T) (right): Fira's error term."""
    return g - backproject(project(g, p, side), p, side)


def _pool_size(d: int, cfg: ProjectorConfig, rank: int) -> int:
    """k: how many singular vectors the SVD returns (dominant, sara)."""
    if cfg.method == "dominant":
        return rank
    if cfg.method == "sara":
        if cfg.svd_backend == "exact":
            return d  # the paper samples from all d singular vectors
        return min(d, cfg.sara_pool_factor * rank)
    raise ValueError(f"unknown SVD projector method {cfg.method!r}")


def draw_shapes(d: int, n: int, cfg: ProjectorConfig, rank: int) -> DrawShapes:
    """Per-slice shapes of a refresh's draws for an oriented (d, n) slice.
    online_pca draws nothing: the optimizer always hands it the previous
    projector (eye(d, r) before the first refresh)."""
    rank = min(rank, d)
    if cfg.method == "golore":
        return DrawShapes(None, None, (d, rank))
    if cfg.method == "grass":
        return DrawShapes(None, d)
    if cfg.method in ("identity", "online_pca"):
        return DrawShapes(None, None)
    k = _pool_size(d, cfg, rank)
    sketch = None
    if cfg.svd_backend == "randomized":
        k, kp, _ = svd_lib.clamp_sketch(
            d, n, k, cfg.svd_oversample, cfg.svd_power_iters
        )
        sketch = (n, kp)
    return DrawShapes(sketch, min(k, d) if cfg.method == "sara" else None)


def _oriented(g: torch.Tensor, side: str) -> torch.Tensor:
    """The gradient with the projected dim first: (..., d, other)."""
    return g if side == "left" else g.transpose(-1, -2)


def refresh_projector_stacked(
    g: torch.Tensor,  # (B, d, n) oriented stack
    draws: LeafDraws,
    prev_p: Optional[torch.Tensor],  # (B, d, r) outgoing projectors
    cfg: ProjectorConfig,
    *,
    rank: int,
) -> torch.Tensor:
    """Refresh a whole (B, d, n) oriented gradient stack in one chain.  For
    dominant and sara (randomized backend only): batched sketch, power
    iterations through ``kernels/power_iter``, batched thin QR, one small
    batched SVD, batched Gumbel top-k.  For the SVD-free methods one
    batched step: a QR of the basis (golore), a top-k over row energies
    (grass), one power-iteration product and a QR (online_pca, which reads
    ``prev_p``).  Returns a (B, d, rank) stack with orthonormal columns per
    slice."""
    if cfg.method in ("dominant", "sara") and cfg.svd_backend != "randomized":
        raise ValueError(
            f"stacked {cfg.method!r} refresh requires svd_backend='randomized'"
        )
    bsz, d, n = g.shape
    step = bsz
    if cfg.method in ("dominant", "sara"):
        _, kp, _ = svd_lib.clamp_sketch(d, n, _pool_size(d, cfg, min(rank, d)),
                                        cfg.svd_oversample, cfg.svd_power_iters)
        step = refresh_chunk(bsz, d, n, kp)
    if step >= bsz:
        return _refresh_stack(g, draws, prev_p, cfg, rank)
    return torch.cat([
        _refresh_stack(g[i:i + step], LeafDraws(*(None if x is None else x[i:i + step]
                                                  for x in draws)),
                       None if prev_p is None else prev_p[i:i + step], cfg, rank)
        for i in range(0, bsz, step)
    ])


# A stacked randomized-SVD refresh holds a few (B, max(d, n), k') f32
# products at once (the sketch product and its QR, the power iteration's
# G^T Q, the small SVD's input and factors).  A stack whose such product
# would pass this many bytes refreshes in equal chunks of slices: each
# slice's chain is its own, so chunking changes no slice's math, only the
# launches (kernel 9 runs once per chunk and power iteration).  It keeps
# the refresh of deepseek-moe-16b's 768-slice expert bucket (6.5 GB per
# such product) beside a full-width training state on one card; the JAX
# package runs the whole stack as one chain and leaves memory to XLA.
STACK_REFRESH_BYTES = 2**31


def refresh_chunk(bsz: int, d: int, n: int, kp: int) -> int:
    """Slices per chunk of a stacked randomized-SVD refresh (see
    ``STACK_REFRESH_BYTES``): the whole stack when it fits, else equal
    chunks."""
    fit = max(1, STACK_REFRESH_BYTES // (4 * max(d, n) * kp))
    chunks = -(-bsz // fit)
    return -(-bsz // chunks)


def _refresh_stack(g: torch.Tensor, draws: LeafDraws, prev_p: Optional[torch.Tensor],
                   cfg: ProjectorConfig, rank: int) -> torch.Tensor:
    bsz, d, _ = g.shape
    rank = min(rank, d)
    method = cfg.method
    if method == "identity":
        eye = torch.eye(d, rank, dtype=cfg.dtype, device=g.device)
        return eye.expand(bsz, d, rank).contiguous()
    if method == "golore":
        if draws.basis is None:
            raise ValueError("a 'golore' refresh needs a Gaussian basis draw")
        return svd_lib.qr_q(draws.basis).to(cfg.dtype)
    if method == "grass":
        row_energy = torch.sum(g.float() ** 2, dim=-1)  # (B, d)
        idx = sampling_lib.gumbel_topk_indices_batched(row_energy, rank, draws.gumbel)
        # the one-hot selection: column j holds a 1 in row idx[:, j]
        sel = torch.zeros((bsz, d, rank), dtype=cfg.dtype, device=g.device)
        return sel.scatter_(1, idx[:, None, :], 1.0)
    if method == "online_pca":
        if prev_p is None:
            raise ValueError("an 'online_pca' refresh needs the previous projector")
        g32, p32 = g.float(), prev_p.float()
        norms = torch.linalg.vector_norm(g32, dim=(-2, -1))  # per-slice Frobenius
        step = (cfg.online_pca_lr / (norms ** 2 + 1e-12))[:, None, None]
        y = p32 + step * power_ops.power_iter_step(g32, p32)
        return svd_lib.qr_q(y).to(cfg.dtype)
    u, s = svd_lib.topk_svd_batched(
        g, _pool_size(d, cfg, rank), draws.omega, backend=cfg.svd_backend,
        oversample=cfg.svd_oversample, power_iters=cfg.svd_power_iters,
    )
    if method == "dominant":
        return u.to(cfg.dtype)
    p, _ = sampling_lib.sara_select(u, s, rank, draws.gumbel)
    return p.to(cfg.dtype)


def split_refresh_supported(cfg: "ProjectorConfig") -> bool:
    """Can ``refresh_projector_stacked_split`` refresh this config from the
    columns of a stack split over processes?  The SVD-free methods, and
    dominant and sara on the randomized backend; the exact SVD gathers."""
    return cfg.method in _SVD_FREE_METHODS or (
        cfg.method in ("dominant", "sara") and cfg.svd_backend == "randomized")


def refresh_projector_stacked_split(
    g: torch.Tensor,  # (B, d, n) this process's columns of the oriented stack
    draws: LeafDraws,  # the sketch's rows of those columns; the Gumbel noise whole
    prev_p: Optional[torch.Tensor],  # (B, d, r) outgoing projectors (online_pca)
    cfg: ProjectorConfig,
    *,
    rank: int,
    n_total: int,
    axes,
) -> torch.Tensor:
    """``refresh_projector_stacked`` on this process's columns of a stack
    split over ``axes``, the same (B, d, rank) projectors on every process
    and no gradient gathered: dominant and sara on the randomized backend
    (``svd.randomized_svd_stacked(split=)``, chunked as the whole stack
    would be); golore's basis (drawn for the global leaf; no gradient
    read); grass's row energies, summed over ``axes``; online PCA's power
    step, G G^T P = sum_k G_k (G_k^T P) through the kernel on the local
    block, and its squared norms, summed over ``axes``."""
    if not split_refresh_supported(cfg):
        raise ValueError(f"the split refresh covers the SVD-free methods and dominant and "
                         f"sara on the randomized backend, not {cfg.method!r} on "
                         f"{cfg.svd_backend!r}")
    bsz, d, _ = g.shape
    rank = min(rank, d)
    if cfg.method in ("identity", "golore"):
        return _refresh_stack(g, draws, prev_p, cfg, rank)
    if cfg.method == "grass":
        row_energy = axes.all_reduce_(torch.sum(g.float() ** 2, dim=-1))  # (B, d)
        idx = sampling_lib.gumbel_topk_indices_batched(row_energy, rank, draws.gumbel)
        sel = torch.zeros((bsz, d, rank), dtype=cfg.dtype, device=g.device)
        return sel.scatter_(1, idx[:, None, :], 1.0)
    if cfg.method == "online_pca":
        if prev_p is None:
            raise ValueError("an 'online_pca' refresh needs the previous projector")
        g32, p32 = g.float(), prev_p.float()
        sq = axes.all_reduce_(torch.sum(g32 * g32, dim=(-2, -1)))
        step = (cfg.online_pca_lr / (sq + 1e-12))[:, None, None]
        y = p32 + step * axes.all_reduce_(power_ops.power_iter_step(g32, p32))
        return svd_lib.qr_q(y).to(cfg.dtype)
    pool = _pool_size(d, cfg, rank)
    _, kp, _ = svd_lib.clamp_sketch(d, n_total, pool, cfg.svd_oversample, cfg.svd_power_iters)
    step = refresh_chunk(bsz, d, n_total, kp)
    outs = []
    for i in range(0, bsz, step):
        u, s = svd_lib.randomized_svd_stacked(
            g[i:i + step].float(), pool, draws.omega[i:i + step],
            oversample=cfg.svd_oversample, power_iters=cfg.svd_power_iters,
            split=(axes, n_total))
        if cfg.method == "dominant":
            outs.append(u.to(cfg.dtype))
        else:
            outs.append(sampling_lib.sara_select(u, s, rank, draws.gumbel[i:i + step])[0]
                        .to(cfg.dtype))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


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
    P of shape (*batch, d, rank), orthonormal columns per slice.
    ``prev_p`` (*batch, d, r) is the outgoing projector, which online_pca
    updates and the other methods ignore."""
    if cfg.method not in METHODS:
        raise ValueError(f"unknown projector method {cfg.method!r}")
    side = side or projection_side(g.shape)
    d = projector_dim(g.shape)
    rank = min(rank or cfg.rank, d)
    g2 = _oriented(g, side)
    batch_shape = tuple(g2.shape[:-2])
    pf = None
    if prev_p is not None and cfg.method == "online_pca":
        pf = prev_p.reshape((-1,) + tuple(prev_p.shape[-2:]))
    out = _refresh_stack(
        g2.reshape((-1,) + tuple(g2.shape[-2:])).float(), draws, pf, cfg, rank
    )
    return out.reshape(batch_shape + tuple(out.shape[-2:]))
