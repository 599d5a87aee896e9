"""The port's projectors and sampling (``src/repro_torch/core/projectors.py``,
``core/sampling.py``) against the JAX package's, on the CPU.

* The baselines golore, grass, online_pca and identity, on both sides, on
  2-D and stacked (3, m, n) leaves, through the per-leaf refresh and the
  stacked one, against JAX's ``refresh_projector`` and
  ``refresh_projector_stacked`` with JAX's draws handed in (the chains of
  ``test_torch_optim_kernels.py::JaxDraws``).  identity and grass are
  bit-equal (a selection of rows is exact); golore and online_pca end in a
  QR, whose column signs differ between torch's LAPACK and jaxlib's
  (ROADMAP queue 3): they are compared sign-aligned, to 1e-5.
* The cases of ``tests/test_projectors.py`` on the port: orthonormal
  columns for every method, grass's columns are selections, online_pca
  improves its capture, the batched refresh equals the per-leaf one, and
  the residual is orthogonal to the projection (hypothesis).
* ``batched_refresh_supported`` and ``refresh_is_stochastic`` as JAX's.
* The batched Gumbel top-k against JAX's (the zero-weight fallback and
  unsorted indices included), and the sampler's inclusion probabilities
  against the paper's sequential law.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import projectors as jax_proj
from repro.core import sampling as jax_sampling
from repro_torch.core import projectors as proj
from repro_torch.core import sampling
from test_torch_optim_kernels import _jax_leaf_draws, _t

# One intra-op thread: the test workers share the host's cores, and the
# port's results do not depend on the thread count (core/svd.py).
torch.set_num_threads(1)

NEW_METHODS = ["golore", "grass", "online_pca", "identity"]
# after a QR: sign-aligned columns, to 1e-5 (f32, two LAPACKs)
QR_TOL = dict(atol=1e-5, rtol=0)
RANK = 4
KEY = jax.random.PRNGKey(7)


def _grad(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 0.1).astype(np.float32)


def _orthonormal(lead, d, r, seed=1):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal(lead + (d, r)))
    return q.astype(np.float32)


def _draws(key, nb, d, n, cfg, whole=None):
    """The port's draws for one leaf (or stack) from JAX's key: ``nb``
    slices (0 for a leaf without leading dims), the chain of the method."""
    shapes = proj.draw_shapes(d, n, cfg, cfg.rank)
    if whole is None:
        whole = cfg.method in ("golore", "grass")
    omega, gumbel, basis = _jax_leaf_draws(key, nb, shapes.sketch, shapes.gumbel,
                                           shapes.basis, whole)
    return proj.LeafDraws(_t(omega), _t(gumbel), _t(basis))


def _assert_projectors(method, got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    if method in ("identity", "grass"):
        np.testing.assert_array_equal(got, want)
        return
    signs = np.sign(np.sum(got * want, axis=-2, keepdims=True))
    np.testing.assert_allclose(got * signs, want, **QR_TOL)


# ---------------------------------------------------------------------------
# the new methods against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lead", [(), (3,)], ids=["2d", "stacked"])
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("method", NEW_METHODS)
def test_refresh_projector_matches_jax(method, side, lead):
    m, n = (16, 40) if side == "left" else (40, 16)
    d = min(m, n)
    g = _grad(lead + (m, n))
    jcfg = jax_proj.ProjectorConfig(method=method, rank=RANK, online_pca_lr=0.5)
    tcfg = proj.ProjectorConfig(method=method, rank=RANK, online_pca_lr=0.5)
    prev = _orthonormal(lead, d, RANK) if method == "online_pca" else None
    want = jax_proj.refresh_projector(jnp.asarray(g), KEY,
                                      None if prev is None else jnp.asarray(prev), jcfg,
                                      side=side)
    nb = int(np.prod(lead)) if lead else 0
    got = proj.refresh_projector(torch.from_numpy(g), _draws(KEY, nb, d, max(m, n), tcfg),
                                 None if prev is None else torch.from_numpy(prev), tcfg,
                                 side=side)
    assert tuple(got.shape) == lead + (d, RANK) and got.dtype == torch.float32
    _assert_projectors(method, got, want)


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("method", NEW_METHODS)
def test_refresh_projector_stacked_matches_jax(method, side):
    """A (B, d, n) oriented stack, as the bucketed refresh gathers it (a
    side-right leaf enters transposed), one key per slice."""
    b, m, n = 3, (16 if side == "left" else 40), (40 if side == "left" else 16)
    leaf = _grad((b, m, n), seed=2)
    g = leaf if side == "left" else np.swapaxes(leaf, -1, -2).copy()
    d, nn = g.shape[-2:]
    jcfg = jax_proj.ProjectorConfig(method=method, rank=RANK)
    tcfg = proj.ProjectorConfig(method=method, rank=RANK)
    prev = _orthonormal((b,), d, RANK, seed=3)
    keys = jax.random.split(KEY, b)
    want = jax_proj.refresh_projector_stacked(jnp.asarray(g), keys, jnp.asarray(prev), jcfg,
                                              rank=RANK)
    got = proj.refresh_projector_stacked(torch.from_numpy(g), _draws(KEY, b, d, nn, tcfg),
                                         torch.from_numpy(prev), tcfg, rank=RANK)
    assert tuple(got.shape) == (b, d, RANK)
    _assert_projectors(method, got, want)


def test_online_pca_requires_the_previous_projector():
    """JAX's online_pca starts from golore's basis when it is handed no
    previous projector (``projectors.py:152-155``), which no optimizer does:
    both packages hand it the outgoing projector, eye(d, r) before the first
    refresh.  The port draws nothing for online_pca, so a refresh without
    the previous projector is an error, whatever draws it is given."""
    g = torch.from_numpy(_grad((16, 40)))
    cfg = proj.ProjectorConfig(method="online_pca", rank=RANK)
    assert proj.draw_shapes(16, 40, cfg, RANK) == proj.DrawShapes(None, None)
    basis = _draws(KEY, 0, 16, 40, cfg._replace(method="golore"))
    for draws in (proj.LeafDraws(None, None), basis):
        with pytest.raises(ValueError, match="previous projector"):
            proj.refresh_projector(g, draws, None, cfg)


@pytest.mark.parametrize("method", proj.METHODS)
@pytest.mark.parametrize("backend", ["exact", "randomized"])
def test_coverage_and_stochastic_flags_match_jax(method, backend):
    jcfg = jax_proj.ProjectorConfig(method=method, svd_backend=backend)
    tcfg = proj.ProjectorConfig(method=method, svd_backend=backend)
    assert proj.batched_refresh_supported(tcfg) == jax_proj.batched_refresh_supported(jcfg)
    assert proj.refresh_is_stochastic(method) == jax_proj.refresh_is_stochastic(method)
    assert proj.STOCHASTIC_REFRESH_METHODS == jax_proj.STOCHASTIC_REFRESH_METHODS
    assert proj.METHODS == jax_proj.METHODS
    assert proj.ProjectorConfig().online_pca_lr == jax_proj.ProjectorConfig().online_pca_lr


def test_residual_matches_jax():
    for shape, side in (((16, 40), "left"), ((3, 40, 16), "right")):
        g = _grad(shape)
        p = _orthonormal(shape[:-2], min(shape[-2:]), RANK)
        want = jax_proj.residual(jnp.asarray(g), jnp.asarray(p), side)
        got = proj.residual(torch.from_numpy(g), torch.from_numpy(p), side)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# the cases of tests/test_projectors.py, on the port
# ---------------------------------------------------------------------------


def _port_refresh(g, method, rank, prev=None, key=KEY, **kw):
    cfg = proj.ProjectorConfig(method=method, rank=rank, **kw)
    d, n = min(g.shape[-2:]), max(g.shape[-2:])
    lead = tuple(g.shape[:-2])
    nb = int(np.prod(lead)) if lead else 0
    return proj.refresh_projector(g, _draws(key, nb, d, n, cfg), prev, cfg)


@pytest.mark.parametrize("method", ["dominant", "sara", "golore", "grass", "online_pca"])
def test_orthonormal_columns(method):
    g = torch.from_numpy(_grad((32, 64)))
    prev = torch.eye(32, 8) if method == "online_pca" else None
    p = _port_refresh(g, method, 8, prev)
    assert tuple(p.shape) == (32, 8)
    torch.testing.assert_close(p.T @ p, torch.eye(8), atol=1e-5, rtol=0)


def test_grass_rows_are_selections():
    p = _port_refresh(torch.from_numpy(_grad((16, 32))), "grass", 4).numpy()
    assert ((p == 0) | (p == 1)).all()
    assert (p.sum(axis=0) == 1).all()
    assert len(set(np.argmax(p, axis=0))) == 4  # four distinct rows


def test_online_pca_improves_capture():
    """Each online_pca refresh is one step of subspace descent: the captured
    energy ||P^T G|| grows over refreshes from a random start."""
    g = torch.from_numpy(_grad((32, 64), seed=5))
    start = proj.ProjectorConfig(method="golore", rank=4)
    p = proj.refresh_projector(g, _draws(KEY, 0, 32, 64, start), None, start)
    first = float(torch.linalg.norm(proj.project(g, p, "left")))
    for i in range(20):
        p = _port_refresh(g, "online_pca", 4, prev=p, key=jax.random.fold_in(KEY, i),
                          online_pca_lr=1.0)
    assert float(torch.linalg.norm(proj.project(g, p, "left"))) > first


@pytest.mark.parametrize("method", NEW_METHODS + ["sara"])
def test_batched_refresh_equals_per_leaf_refresh(method):
    """The stacked refresh of a (3, 2, d, n) leaf's six slices equals the
    per-leaf refresh of the leaf, with the same per-slice draws."""
    g = torch.from_numpy(_grad((3, 2, 16, 32), seed=4))
    backend = "randomized" if method == "sara" else "exact"
    cfg = proj.ProjectorConfig(method=method, rank=4, svd_backend=backend)
    draws = _draws(KEY, 6, 16, 32, cfg)
    prev = torch.from_numpy(_orthonormal((3, 2), 16, 4))
    per_leaf = proj.refresh_projector(g, draws, prev, cfg)
    stacked = proj.refresh_projector_stacked(g.reshape(6, 16, 32), draws,
                                             prev.reshape(6, 16, 4), cfg, rank=4)
    assert tuple(per_leaf.shape) == (3, 2, 16, 4)
    torch.testing.assert_close(per_leaf.reshape(6, 16, 4), stacked, rtol=0, atol=0)
    for p in per_leaf.reshape(6, 16, 4):
        torch.testing.assert_close(p.T @ p, torch.eye(4), atol=1e-5, rtol=0)


@given(m=st.integers(8, 32), n=st.integers(8, 32), seed=st.integers(0, 1000))
@settings(max_examples=20, deadline=None)
def test_property_residual_orthogonal_to_projection(m, n, seed):
    """(I - P P^T) G is orthogonal to P P^T G (the Fira split)."""
    g = torch.from_numpy(np.random.default_rng(seed).standard_normal((m, n)).astype(np.float32))
    side = proj.projection_side(g.shape)
    p = _port_refresh(g, "sara", min(4, m, n), key=jax.random.PRNGKey(seed + 1))
    low = proj.backproject(proj.project(g, p, side), p, side)
    res = proj.residual(g, p, side)
    assert abs(float(torch.sum(low * res))) < 1e-3 * float(torch.linalg.norm(g)) ** 2 + 1e-5


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["weights", "zeros", "all_zero_row"])
@pytest.mark.parametrize("sort_indices", [True, False])
def test_gumbel_topk_batched_matches_jax(case, sort_indices):
    """JAX's noise handed in: the same indices, in the same order; a zero
    weight is never drawn while r positive ones exist, an all-zero row
    samples uniformly."""
    rng = np.random.default_rng(3)
    w = rng.random((4, 24)).astype(np.float32)
    if case == "zeros":
        w[:, ::2] = 0.0
    elif case == "all_zero_row":
        w[1] = 0.0
    keys = jax.random.split(KEY, 4)
    want = jax_sampling.gumbel_topk_indices_batched(jnp.asarray(w), 6, keys,
                                                    sort_indices=sort_indices)
    noise = jax.vmap(lambda k: jax.random.gumbel(k, (24,), jnp.float32))(keys)
    got = sampling.gumbel_topk_indices_batched(torch.from_numpy(w), 6, _t(noise),
                                               sort_indices=sort_indices)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if case == "zeros":
        assert (got.numpy() % 2 == 1).all()
    with pytest.raises(ValueError, match="without replacement"):
        sampling.gumbel_topk_indices_batched(torch.from_numpy(w), 25, _t(noise))


def test_inclusion_probabilities_match_the_sequential_law():
    """The Gumbel top-k sampler realises the paper's sequential law: its
    Monte-Carlo inclusion probabilities (JAX's noise) equal JAX's estimate
    and the sequential reference's within sampling error."""
    w = np.array([5.0, 3.0, 1.0, 1.0, 0.5, 0.0, 2.0, 0.25], np.float32)
    n = 4000
    want = np.asarray(jax_sampling.inclusion_probabilities_mc(jnp.asarray(w), 3, KEY, n))
    noise = jax.vmap(lambda k: jax.random.gumbel(k, (8,), jnp.float32))(
        jax.random.split(KEY, n))
    got = sampling.inclusion_probabilities_mc(torch.from_numpy(w), 3, _t(noise)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    rng = np.random.default_rng(0)
    seq = np.zeros(8)
    for _ in range(n):
        seq[sampling.sequential_sample_reference(w, 3, rng)] += 1.0 / n
    assert got[5] == 0.0 and abs(got.sum() - 3.0) < 1e-4
    np.testing.assert_allclose(got, seq, atol=0.04)
    assert sampling.sequential_sample_reference(w, 3, np.random.default_rng(1)) == \
        jax_sampling.sequential_sample_reference(w, 3, np.random.default_rng(1))
