"""SVD backends for projector refresh, from ``src/repro/core/svd.py``.

  * ``exact``      -- ``torch.linalg.svd`` (paper-faithful).
  * ``randomized`` -- the Halko-Martinsson-Tropp range finder in the fused
    subspace-iteration form: one thin QR per iteration followed by
    Y = G (G^T Q), which goes through ``kernels/power_iter`` (the CUDA
    kernel on the card, the plain version on the CPU).

The Gaussian sketch ``omega`` is an input, never drawn inside (the JAX
function draws it from its key at ``svd.py:122-124``): the port's refresh
draws it from a ``torch.Generator``, and the parity tests hand in JAX's own
draws.  QR and the small SVD stay ``torch.linalg``; they are not Pallas
kernels in the JAX package either.  On the CPU they factor in f64 and round
back to f32 (``qr_q``, ``svd_f32``): MKL's LAPACK picks its blocking by the
size of the thread pool, so an f32 factorization moves by an ulp with
``torch.get_num_threads()``, and SARA's draw over small singular values,
then a first Adam or 8-bit Adam step, magnifies that ulp to ~5e-5 in W'.
The f64 factors differ across pool sizes ~2**-29 below an f32 ulp, so the
rounded result does not depend on the pool size.  On the card the factors
stay f32 (cuSOLVER's result does not depend on a host thread count).

Both return the left singular vectors of G (m x k) and the singular values
(k,) for G of shape (m, n).

Under tensor parallelism ``randomized_svd_stacked(split=(axes, n_total))``
takes this process's columns of G: the sketch product and each power
iteration are summed over the ``model`` axis (G Omega = sum_k G_k Omega_k,
G G^T Q = sum_k G_k (G_k^T Q), the kernel on the local block), so Q is the
same on every process, and the small Q^T G is gathered along its columns
for the SVD.  No process holds the whole gradient.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.power_iter import ops as power_ops


def _factor_dtype(x: torch.Tensor) -> torch.dtype:
    """f64 on the CPU, f32 on the card (see the module docstring)."""
    return torch.float64 if x.device.type == "cpu" else torch.float32


def qr_q(y: torch.Tensor) -> torch.Tensor:
    """The orthonormal factor of a thin QR, f32; any leading batch dims."""
    return torch.linalg.qr(y.to(_factor_dtype(y)))[0].float()


def svd_f32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Thin SVD (U, S, Vh) in f32; any leading batch dims."""
    u, s, vh = torch.linalg.svd(x.to(_factor_dtype(x)), full_matrices=False)
    return u.float(), s.float(), vh.float()


def _leading(u: torch.Tensor, s: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top k vectors and values, each in storage of its own: a slice
    would keep the whole factor alive in a projector of the state."""
    return u[..., :k].contiguous(), s[..., :k].contiguous()


def exact_svd(g: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k left singular vectors and singular values, exactly (f32);
    any leading batch dims."""
    u, s, _ = svd_f32(g.float())
    return _leading(u, s, k)


def clamp_sketch(
    m: int, n: int, k: int, oversample: int, power_iters: int
) -> Tuple[int, int, int]:
    """(k, k', power_iters) with k <= k' <= min(m, n), and the power
    iterations dropped when the sketch already spans the full range."""
    d = min(m, n)
    k = max(1, min(k, d))
    kp = min(k + max(oversample, 0), d)
    if kp >= d:
        power_iters = 0
    return k, kp, power_iters


def randomized_svd_stacked(
    g: torch.Tensor,  # (B, m, n)
    k: int,
    omega: torch.Tensor,  # (B, n, k') Gaussian sketch, k' from clamp_sketch
    *,
    oversample: int = 8,
    power_iters: int = 2,
    split=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One batched randomized-SVD chain over a (B, m, n) stack.  Returns
    (U (B, m, k), S (B, k)).  ``split`` = (axes, n_total): ``g`` is this
    process's columns of a (B, m, n_total) stack split over ``axes`` and
    ``omega`` its rows of the sketch (module docstring)."""
    g = g.float()
    bsz, m, n = g.shape
    axes, n_total = split if split is not None else (None, n)
    k, kp, power_iters = clamp_sketch(m, n_total, k, oversample, power_iters)
    if tuple(omega.shape) != (bsz, n, kp):
        raise ValueError(f"sketch shape {tuple(omega.shape)} != {(bsz, n, kp)}")

    def summed(y):
        return y if axes is None else axes.all_reduce_(y)

    y = summed(torch.bmm(g, omega.float()))  # (B, m, k') sketch
    for _ in range(power_iters):
        y = summed(power_ops.power_iter_step(g, qr_q(y)))
    q = qr_q(y)  # (B, m, k') orthonormal range basis
    b = torch.bmm(q.transpose(1, 2), g)  # (B, k', n)
    if axes is not None:
        b = axes.all_gather(b, dim=2)
    ub, s, _ = svd_f32(b)
    u = torch.bmm(q, ub)
    return _leading(u, s, k)


def randomized_svd(
    g: torch.Tensor,  # (m, n)
    k: int,
    omega: torch.Tensor,  # (n, k')
    *,
    oversample: int = 8,
    power_iters: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-slice entry point of the stacked chain (same numerics)."""
    u, s = randomized_svd_stacked(
        g[None], k, omega[None], oversample=oversample, power_iters=power_iters
    )
    return u[0], s[0]


def topk_svd(
    g: torch.Tensor,
    k: int,
    omega: Optional[torch.Tensor] = None,
    *,
    backend: str = "exact",
    oversample: int = 8,
    power_iters: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch on backend.  ``omega`` is ignored by the exact backend."""
    if backend == "exact":
        return exact_svd(g, k)
    if backend == "randomized":
        return randomized_svd(
            g, k, omega, oversample=oversample, power_iters=power_iters
        )
    raise ValueError(f"unknown svd backend: {backend!r}")


def topk_svd_batched(
    g: torch.Tensor,  # (*batch, m, n)
    k: int,
    omega: Optional[torch.Tensor] = None,  # (prod(batch), n, k')
    *,
    backend: str = "exact",
    oversample: int = 8,
    power_iters: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``topk_svd`` over any leading batch dims: U (*batch, m, k),
    S (*batch, k).  The randomized backend takes one sketch per slice."""
    batch_shape = tuple(g.shape[:-2])
    if not batch_shape:
        return topk_svd(g, k, omega, backend=backend, oversample=oversample,
                        power_iters=power_iters)
    gf = g.reshape((-1,) + tuple(g.shape[-2:]))
    if backend == "exact":
        u, s = exact_svd(gf, k)
    elif backend == "randomized":
        u, s = randomized_svd_stacked(
            gf, k, omega, oversample=oversample, power_iters=power_iters
        )
    else:
        raise ValueError(f"unknown svd backend: {backend!r}")
    return u.reshape(batch_shape + u.shape[-2:]), s.reshape(batch_shape + s.shape[-1:])
