"""The port's subspace diagnostics (``src/repro_torch/core/metrics.py``)
against the JAX package's ``core/metrics.py`` on the CPU, at f32: each
function on the same numpy inputs, ``collect_projectors`` after a refresh
on both engines (sign-aligned: LAPACK's sign choices differ, ROADMAP
queue 3), and the ``OverlapTracker`` series of a 3-refresh ``train_loop``
fed JAX's draws."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.configs.registry import get_config as jax_get_config
from repro.core import make_optimizer as jax_make_optimizer
from repro.core import metrics as jax_metrics
from repro.data.synthetic import SyntheticDataConfig, SyntheticDataset
from repro.models import build_model as jax_build_model
from repro.train.loop import train_loop as jax_train_loop
from repro.train.state import TrainState as JaxTrainState
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch import bridge
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import make_optimizer
from repro_torch.core import metrics
from repro_torch.models import build_model
from repro_torch.train.loop import train_loop
from repro_torch.train.state import TrainState
from repro_torch.train.step import make_train_step
from test_torch_optim_kernels import JaxDraws
from test_torch_train import _SharedData

# One intra-op thread: the test workers share the host's cores, and the
# port's results do not depend on the thread count (core/svd.py).
torch.set_num_threads(1)

# f32 products and reductions in other orders (XLA vs ATen)
F32 = dict(atol=1e-6, rtol=1e-5)
# the singular values of a delta: two LAPACKs, f32
SVD_TOL = dict(atol=1e-6, rtol=1e-4)
# projectors after a refresh: the randomized SVD's small singular vectors
# differ between the two LAPACKs by up to ~2e-5 (test_torch_train.py)
P_ATOL = 5e-5


def _orthonormal(rng, *shape):
    q, _ = np.linalg.qr(rng.standard_normal(shape).astype(np.float64))
    return q.astype(np.float32)


@pytest.mark.parametrize("lead,m,r,r2", [((), 48, 8, 8), ((), 48, 8, 5), ((3,), 40, 6, 6)])
def test_subspace_overlap_matches_jax(lead, m, r, r2):
    rng = np.random.default_rng(0)
    u, v = _orthonormal(rng, *lead, m, r), _orthonormal(rng, *lead, m, r2)
    got = metrics.subspace_overlap(torch.from_numpy(u), torch.from_numpy(v)).numpy()
    want = np.asarray(jax_metrics.subspace_overlap(jnp.asarray(u), jnp.asarray(v)))
    np.testing.assert_allclose(got, want, **F32)
    assert np.all((got >= 0) & (got <= 1 + 1e-6))
    same = metrics.subspace_overlap(torch.from_numpy(u), torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(same, 1.0, atol=1e-6)


@pytest.mark.parametrize("shape", [(32, 48), (2, 24, 16)])
def test_update_singular_spectrum_and_effective_rank_match_jax(shape):
    rng = np.random.default_rng(1)
    w0 = rng.standard_normal(shape).astype(np.float32)
    # a delta of rank 3 plus noise: a spectrum that falls off
    lead = shape[:-2]
    a = rng.standard_normal(lead + (shape[-2], 3)).astype(np.float32)
    b = rng.standard_normal(lead + (3, shape[-1])).astype(np.float32)
    w1 = w0 + a @ b + 0.01 * rng.standard_normal(shape).astype(np.float32)
    got = metrics.update_singular_spectrum(torch.from_numpy(w0), torch.from_numpy(w1))
    want = jax_metrics.update_singular_spectrum(jnp.asarray(w0), jnp.asarray(w1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SVD_TOL)
    assert np.allclose(got.numpy()[..., 0], 1.0)
    np.testing.assert_allclose(metrics.effective_rank(got).numpy(),
                               np.asarray(jax_metrics.effective_rank(want)), **SVD_TOL)


def test_effective_rank_matches_jax_on_edge_spectra():
    spectra = np.array([[1.0, 0.0, 0.0, 0.0], [1.0, 1.0, 1.0, 1.0], [1.0, 0.5, 0.25, 0.0],
                        [0.0, 0.0, 0.0, 0.0]], np.float32)
    got = metrics.effective_rank(torch.from_numpy(spectra)).numpy()
    want = np.asarray(jax_metrics.effective_rank(jnp.asarray(spectra)))
    np.testing.assert_allclose(got, want, **F32)
    np.testing.assert_allclose(got[:2], [1.0, 4.0], rtol=1e-5)


def test_overlap_tracker_matches_jax():
    rng = np.random.default_rng(2)
    names = ["['blocks']['q_proj']", "['w']"]
    seq = [{names[0]: _orthonormal(rng, 2, 32, 4), names[1]: _orthonormal(rng, 24, 4)}
           for _ in range(4)]
    trackers = (metrics.OverlapTracker(), jax_metrics.OverlapTracker())
    trackers[0].set_anchor({k: torch.from_numpy(v) for k, v in seq[0].items()})
    trackers[1].set_anchor({k: jnp.asarray(v) for k, v in seq[0].items()})
    for projs in seq:
        trackers[0].observe({k: torch.from_numpy(v) for k, v in projs.items()})
        trackers[1].observe({k: jnp.asarray(v) for k, v in projs.items()})
    got, want = trackers
    assert sorted(got.adjacent) == sorted(want.adjacent) == sorted(names)
    for name in names:
        np.testing.assert_allclose(got.adjacent[name], want.adjacent[name], **F32)
        np.testing.assert_allclose(got.anchored[name], want.anchored[name], **F32)
        assert len(got.adjacent[name]) == 3 and got.anchored[name][0] == pytest.approx(1.0)
    gs, ws = got.summary(), want.summary()
    assert sorted(gs) == sorted(ws)
    for name in gs:
        assert sorted(gs[name]) == sorted(ws[name])
        for k in gs[name]:
            assert gs[name][k] == pytest.approx(ws[name][k], abs=1e-6)


# ---------------------------------------------------------------------------
# on the optimizer's state and in the loop
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_get_config("llama3-8b", smoke=True).with_(dtype=jnp.float32)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    data = SyntheticDataset(SyntheticDataConfig(vocab_size=jcfg.vocab_size, seq_len=32,
                                                global_batch=4))
    batches = [data.batch_at(i) for i in range(3)]
    _, grads = jax.value_and_grad(jmodel.loss, has_aux=True)(jparams, batches[0])
    tmodel = build_model(get_config("llama3-8b", smoke=True).with_(dtype=torch.float32),
                         device="cpu")
    return dict(jmodel=jmodel, jparams=jparams, batches=batches, grads=grads, tmodel=tmodel,
                tparams=bridge.params_from_numpy(
                    jax.tree_util.tree_map(np.asarray, jparams), "cpu"))


KW = dict(rank=8, lr=0.01, grad_clip_norm=1.0, svd_backend="randomized")


def _assert_projectors_close(got, want):
    assert sorted(got) == sorted(want)
    for path, pj in want.items():
        pj, pt = np.asarray(pj), got[path].numpy()
        assert pt.shape == pj.shape, path
        signs = np.sign(np.sum(pj * pt, axis=-2, keepdims=True))
        np.testing.assert_allclose(pt * signs, pj, atol=P_ATOL, err_msg=path)


@pytest.mark.parametrize("engine", ["reference", "bucketed"])
def test_collect_projectors_matches_jax_after_a_refresh(pair, engine):
    jopt = jax_make_optimizer("galore-sara-adam", pair["jparams"], engine=engine, **KW)
    topt = make_optimizer("galore-sara-adam", pair["tparams"], engine=engine, **KW)
    js0 = jopt.init(pair["jparams"])
    ts0 = topt.init(pair["tparams"])._replace(draws=JaxDraws(js0.key))
    _, js1, _ = jax.jit(jopt.update, static_argnames=("refresh", "apply"))(
        pair["grads"], js0, pair["jparams"], refresh=True, apply=True)
    tgrads = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, pair["grads"]), "cpu")
    _, ts1, _ = topt.update(tgrads, ts0, pair["tparams"], refresh=True, apply=True)
    want = jax_metrics.collect_projectors(js1, jopt.specs, layout=jopt.state_layout)
    got = metrics.collect_projectors(ts1, topt.specs, layout=topt.state_layout)
    assert len(got) == 7  # q, k, v, o and the three mlp projections
    _assert_projectors_close(got, want)
    if engine == "bucketed":
        with pytest.raises(ValueError, match="layout"):
            metrics.collect_projectors(ts1, topt.specs)


def test_overlap_tracker_series_matches_jax_in_the_loop(pair, tmp_path):
    """tau 1: refreshes at steps 0, 1 and 2, so two adjacent overlaps per
    leaf.  ``momentum_carry="reproject"`` keeps the steps blind to the
    projectors' column signs (queue 3), so the second and third refreshes
    see the same params in both packages, to REFRESH_TOL."""
    kw = dict(KW, tau=1, engine="bucketed", momentum_carry="reproject")
    jopt = jax_make_optimizer("galore-sara-adam", pair["jparams"], **kw)
    topt = make_optimizer("galore-sara-adam", pair["tparams"], **kw)
    jstate = JaxTrainState(pair["jparams"], jopt.init(pair["jparams"]))
    jtc = JaxTrainConfig(total_steps=3, checkpoint_every=0, checkpoint_dir=str(tmp_path / "j"))

    class _JaxData:
        def batch_at(self, step):
            return pair["batches"][step]

    jres = jax_train_loop(pair["jmodel"], jopt, _JaxData(), jtc,
                          jax_make_train_step(pair["jmodel"], jopt, train_cfg=jtc, donate=False),
                          state=jstate, log_every=1, handle_signals=False, track_subspace=True)
    tc = TrainConfig(total_steps=3, checkpoint_every=0, checkpoint_dir=str(tmp_path / "t"))
    tstate = TrainState(pair["tparams"], topt.init(pair["tparams"])._replace(
        draws=JaxDraws(jstate.opt_state.key)))
    tres = train_loop(pair["tmodel"], topt, _SharedData(pair["batches"]), tc,
                      make_train_step(pair["tmodel"], topt), state=tstate, log_every=1,
                      handle_signals=False, track_subspace=True)
    got, want = tres.subspace.adjacent, jres.subspace.adjacent
    assert sorted(got) == sorted(want) and len(got) == 7
    for name in want:
        assert len(got[name]) == 2
        np.testing.assert_allclose(got[name], want[name], atol=1e-4, err_msg=name)
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-5)
