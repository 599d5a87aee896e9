"""The port's recovery pieces against the JAX package's, on the CPU: the
skip-step gate (``update(skip_nonfinite=True)``) on both engines and every
fused inner, the ``DivergenceDetector`` on the same loss streams, and the
rollback's resample rule.

The gate is held three ways, on both engines and every fused inner: bit
for bit against the port's own ungated step (a refresh and a hot step),
which tests/test_torch_inners.py and test_torch_train.py hold against
JAX's for every inner; on a bad step (a NaN or an Inf in one gradient
leaf) it must hand back the very inputs; and, for Adam on both engines,
against JAX's gated update itself (``REFRESH_TOL`` across the refresh,
where the port takes JAX's draws, ``HOT_TOL`` for the hot step from JAX's
carried-over state, the same verdict on the bad step).  JAX's eager
updates are this file's main CPU cost, so the other inners take them
through the ungated step's tests.  The model is
``get_config("llama3-8b", smoke=True)`` in f32 at rank 8 (the ``pair``
fixture of tests/test_torch_train.py).

The resample rule (``TorchDraws.resample``): distinct attempts give
distinct sources, a resampled source survives a checkpoint, and sara,
golore and grass then draw another subspace at the next refresh while
dominant draws the same one (after ``tests/test_faults_and_recovery.py::
test_resample_*``).  ``JaxDraws.resample`` applies JAX's fold-in.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_optimizer as jax_make_optimizer
from repro.train import recovery as jax_recovery
from repro_torch import bridge
from repro_torch.core import make_optimizer
from repro_torch.core import metrics as metrics_lib
from repro_torch.core.lowrank import TorchDraws, flatten_with_path, tree_leaves, tree_unflatten
from repro_torch.core.projectors import refresh_is_stochastic
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import recovery
from repro_torch.train.state import TrainState
from test_torch_optim_kernels import JaxDraws
from test_torch_train import (  # noqa: F401  (pair is a fixture)
    HOT_TOL,
    OPT_KW,
    REFRESH_TOL,
    _assert_params_close,
    _torch_tree,
    pair,
)

# One intra-op thread: the test workers share the host's cores, and the
# port's results do not depend on the thread count (core/svd.py).
torch.set_num_threads(1)

NAMES = {"adam": "galore-sara-adam", "msgd": "galore-sara-msgd",
         "adam_mini": "galore-sara-adam-mini", "adam8bit": "galore-sara-adam8bit"}


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _items(params, opt_state):
    """Every leaf of (params, optimizer state) with its path, the step and
    the draw key included (the checkpoint's walk)."""
    return ckpt.tree_items(TrainState(params, opt_state))


def _assert_bit_equal(a, b):
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.dtype == y.dtype and np.array_equal(x, y, equal_nan=True), path


def _poisoned(grads, leaf, value):
    """``grads`` with one element of one leaf set to ``value``."""
    out = {}
    for path, g in flatten_with_path(grads):
        g = g.clone()
        if leaf in path:
            g.view(-1)[g.numel() // 3] = value
        out[path] = g
    return [out[p] for p, _ in flatten_with_path(grads)]


def _gated(topt, grads, state, params, refresh):
    return topt.update(grads, state, params, refresh=refresh, apply=True, skip_nonfinite=True)


@pytest.mark.parametrize("engine", ["reference", "bucketed"])
@pytest.mark.parametrize("inner_name", list(NAMES))
def test_gate_matches_jax_and_the_ungated_step(pair, inner_name, engine):
    kw = dict(OPT_KW, engine=engine, svd_backend="randomized")
    jopt = jax_make_optimizer(NAMES[inner_name], pair["jparams"], **kw)
    topt = make_optimizer(NAMES[inner_name], pair["tparams"], **kw)
    js0 = jopt.init(pair["jparams"])
    ts0 = bridge.opt_state_from_numpy(topt, _numpy(js0), "cpu")._replace(
        draws=JaxDraws(js0.key))
    g0, g1 = pair["jgrads"]
    tg0, tg1 = _torch_tree(g0), _torch_tree(g1)

    with_jax = inner_name == "adam"
    # a good refresh: the ungated one bit for bit (and JAX's, to REFRESH_TOL)
    tp1, ts1, taux = _gated(topt, tg0, ts0, pair["tparams"], True)
    up1, us1, uaux = topt.update(tg0, ts0, pair["tparams"], refresh=True, apply=True)
    assert float(taux.skipped) == 0.0 and uaux.skipped is not None
    _assert_bit_equal(_items(tp1, ts1), _items(up1, us1))
    tjp1 = tp1
    if with_jax:
        jp1, js1, jaux = jopt.update(g0, js0, pair["jparams"], refresh=True, apply=True,
                                     skip_nonfinite=True)
        _assert_params_close(jp1, tp1, **REFRESH_TOL)
        assert float(jaux.skipped) == 0.0
        # the hot step from JAX's carried-over state
        ts1 = bridge.opt_state_from_numpy(topt, _numpy(js1), "cpu")
        tjp1 = _torch_tree(jp1)

    # a good hot step: bit for bit (and JAX's, to HOT_TOL)
    tp2, ts2, taux = _gated(topt, tg1, ts1, tjp1, False)
    up2, us2, _ = topt.update(tg1, ts1, tjp1, refresh=False, apply=True)
    assert float(taux.skipped) == 0.0
    _assert_bit_equal(_items(tp2, ts2), _items(up2, us2))
    if with_jax:
        jp2, _, jaux = jopt.update(g1, js1, jp1, refresh=False, apply=True,
                                   skip_nonfinite=True)
        _assert_params_close(jp2, tp2, **HOT_TOL)
        assert float(jaux.skipped) == 0.0
        np.testing.assert_allclose(float(taux.grad_norm), float(jaux.grad_norm), rtol=1e-5)

    # bad steps: a NaN in a low-rank leaf (hot; for Adam, JAX selects its
    # inputs too) and an Inf in a full-rank one (refresh): the port hands
    # back its inputs
    before1 = _items(tjp1, ts1)
    bad = _poisoned(tg1, "q_proj", float("nan"))
    tp, ts, taux = _gated(topt, tree_unflatten(tg1, bad), ts1, tjp1, False)
    assert tp is tjp1 and ts is ts1 and float(taux.skipped) == 1.0
    assert not math.isfinite(float(taux.grad_norm))
    if with_jax:
        jbad = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jp1),
                                            [jnp.asarray(b.numpy()) for b in bad])
        jp, jst, jaux = jopt.update(jbad, js1, jp1, refresh=False, apply=True,
                                    skip_nonfinite=True)
        assert float(jaux.skipped) == 1.0 and int(jst.step) == int(js1.step)
        _assert_params_close(jp, tp, atol=0, rtol=0)
    tp, ts, taux = _gated(topt, tree_unflatten(tg0, _poisoned(tg0, "embed", float("inf"))), ts0,
                          pair["tparams"], True)
    assert tp is pair["tparams"] and ts is ts0 and float(taux.skipped) == 1.0
    _assert_bit_equal(_items(tjp1, ts1), before1)  # the inputs were not written
    # without apply a skipped step's updates are zeros
    upd, _, aux = topt.update(tree_unflatten(tg1, _poisoned(tg1, "lm_head", float("nan"))), ts1,
                              tjp1, refresh=False, skip_nonfinite=True)
    assert float(aux.skipped) == 1.0
    assert all(not torch.any(u) for u in tree_leaves(upd))


# ---------------------------------------------------------------------------
# the divergence detector: the same streams through both packages
# ---------------------------------------------------------------------------

NAN, INF = float("nan"), float("inf")
# (policy kwargs, [(loss, skipped, verdict)], reset after this many steps)
STREAMS = {
    "nan_streak": ({}, [(1.0, 0, 0), (NAN, 0, 0), (INF, 0, 0), (NAN, 0, 0), (1.0, 0, 0)], None),
    "broken_streak": ({}, [(NAN, 0, 0), (NAN, 0, 0), (1.0, 0, 0), (NAN, 0, 0), (NAN, 0, 0),
                           (1.0, 0, 0)], None),
    "skipped_updates": (dict(max_bad_steps=2), [(1.0, 0, 0), (1.1, 1, 0), (1.2, 1, 0)], None),
    "verdict": (dict(max_bad_steps=2), [(1.0, 0, 1), (1.0, 0, 1)], None),
    # spikes need _MIN_WINDOW good losses first; only good ones enter the median
    "spike": (dict(loss_spike_factor=2.0, max_bad_steps=2),
              [(1.0, 0, 0), (1.1, 0, 0), (0.9, 0, 0), (5.0, 0, 0), (1.0, 0, 0), (1.05, 0, 0),
               (0.95, 0, 0), (2.5, 0, 0), (3.0, 0, 0)], None),
    "spike_window": (dict(loss_spike_factor=1.5, loss_window=5, max_bad_steps=1),
                     [(float(i), 0, 0) for i in range(1, 12)] + [(30.0, 0, 0)], None),
    "reset_keeps_window": (dict(loss_spike_factor=2.0, max_bad_steps=2),
                           [(1.0, 0, 0)] * 5 + [(NAN, 0, 0), (3.0, 0, 0), (2.1, 0, 0)], 6),
}


def _play(lib, kw, stream, reset_at):
    det = lib.DivergenceDetector(lib.RecoveryPolicy(**kw))
    for s, (loss, skipped, verdict) in enumerate(stream):
        if reset_at is not None and s == reset_at:
            det.reset()
        try:
            det.observe(s, loss, skipped=bool(skipped), verdict=bool(verdict))
        except lib.RollbackNeeded as e:
            return ("trip", e.step, e.reason, det.streak, list(det._window))
    return ("none", det.streak, list(det._window))


@pytest.mark.parametrize("name", list(STREAMS))
def test_divergence_detector_matches_jax(name):
    kw, stream, reset_at = STREAMS[name]
    got = _play(recovery, kw, stream, reset_at)
    assert got == _play(jax_recovery, kw, stream, reset_at)
    if name != "broken_streak":
        assert got[0] == "trip", got


def test_recovery_policy_matches_jax():
    for kw in ({}, dict(rollback_backoff_s=0.5), dict(stale_worker_action="abort")):
        mine, ref = recovery.RecoveryPolicy(**kw), jax_recovery.RecoveryPolicy(**kw)
        assert [mine.backoff_s(a) for a in (1, 2, 3)] == [ref.backoff_s(a) for a in (1, 2, 3)]
        assert mine.STALE_ACTIONS == ref.STALE_ACTIONS
    for lib in (recovery, jax_recovery):
        with pytest.raises(ValueError, match="stale_worker_action"):
            lib.RecoveryPolicy(stale_worker_action="retry")


# ---------------------------------------------------------------------------
# the resample rule
# ---------------------------------------------------------------------------


def test_resample_distinct_attempts_distinct_sources_and_checkpoint_round_trip(tmp_path):
    base = TorchDraws(7, "cpu", refreshes=3)
    keys = [base.key().tolist()] + [base.resample(a).key().tolist() for a in range(1, 6)]
    assert len({tuple(k) for k in keys}) == len(keys)
    assert all(k[0] == 3 for k in keys)  # the refresh count is kept
    assert base.resample(1).key().tolist() == base.resample(1).key().tolist()
    # the extreme seeds stay in uint32
    for seed in (0, 2**32 - 1):
        assert 0 <= TorchDraws(seed, "cpu").resample(2**31).seed < 2**32
    # a resampled source in a checkpoint reads back as itself
    params = {"w": torch.from_numpy(np.random.default_rng(1).standard_normal((32, 64)).astype(
        np.float32))}
    opt = make_optimizer("galore-sara-adam", params, rank=4, tau=1)
    st = recovery.resample_opt_state(opt.init(params), 2)
    assert st.draws.key().tolist() == TorchDraws(0, "cpu").resample(2).key().tolist()
    mgr = ckpt.CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(TrainState(params, st), 1)
    back = mgr.load(TrainState(params, opt.init(params)), 1)
    assert (back.opt_state.draws.seed, back.opt_state.draws.refreshes) == (
        st.draws.seed, st.draws.refreshes)
    # the test's JAX draws resample with JAX's fold-in, through a checkpoint too
    jopt = jax_make_optimizer("galore-sara-adam", {"w": jnp.asarray(params["w"].numpy())},
                              rank=4, tau=1)
    js = jopt.init({"w": jnp.asarray(params["w"].numpy())})
    want = np.asarray(jax_recovery.resample_opt_state(js, 3).key)
    jd = JaxDraws(js.key).resample(3)
    assert jd.key().tolist() == want.tolist()
    assert JaxDraws.from_key(jd.key()).key().tolist() == want.tolist()


@pytest.mark.parametrize("name,method", [("galore-sara-adam", "sara"), ("golore-adam", "golore"),
                                         ("grass-adam", "grass"), ("galore-adam", "dominant")])
def test_resample_moves_stochastic_subspaces_only(name, method):
    rng = np.random.default_rng(1)
    params = {"w": torch.from_numpy(rng.standard_normal((48, 96)).astype(np.float32))}
    grads = {"w": torch.from_numpy(rng.standard_normal((48, 96)).astype(np.float32))}
    opt = make_optimizer(name, params, rank=8, tau=1, lr=1e-3)

    def refreshed_projector(state):
        _, new_state, _ = opt.update(grads, state, params, refresh=True)
        (p,) = metrics_lib.collect_projectors(new_state, opt.specs,
                                              layout=opt.state_layout).values()
        return p

    st = opt.init(params)
    p_a, p_b = refreshed_projector(st), refreshed_projector(st)
    assert torch.equal(p_a, p_b)  # a replay draws the same
    p_c = refreshed_projector(recovery.resample_opt_state(st, 1))
    overlap = float(metrics_lib.subspace_overlap(p_a, p_c))
    assert refresh_is_stochastic(method) == (method != "dominant")
    if refresh_is_stochastic(method):
        assert overlap < 0.999, (method, overlap)
    else:
        assert torch.equal(p_a, p_c) and overlap > 0.999999


@pytest.mark.parametrize("engine", ["reference", "bucketed"])
def test_gate_tells_overflow_from_nonfinite(engine):
    """A finite gradient whose squares overflow f32 (an element of 1e20)
    makes the global norm infinite, but it is not a bad step: the port's
    gate reads the gradients again, applies the step bit for bit as the
    ungated one does, and agrees with JAX's gate, which applies it too."""
    rng = np.random.default_rng(5)
    p = {"w": (rng.standard_normal((2, 32, 64)) * 0.02).astype(np.float32),
         "n": np.ones((32,), np.float32)}
    g = {"w": (rng.standard_normal((2, 32, 64)) * 0.01).astype(np.float32),
         "n": (rng.standard_normal((32,)) * 0.01).astype(np.float32)}
    g["w"][1, 3, 5] = 1e20
    kw = dict(rank=4, min_dim=8, engine=engine, svd_backend="randomized", grad_clip_norm=1.0)
    tp, tg = bridge.params_from_numpy(p, "cpu"), bridge.params_from_numpy(g, "cpu")
    topt = make_optimizer("galore-sara-adam", tp, **kw)
    st = topt.init(tp)
    gated = topt.update(tg, st, tp, refresh=True, apply=True, skip_nonfinite=True)
    plain = topt.update(tg, st, tp, refresh=True, apply=True)
    assert float(gated[2].skipped) == 0.0 and math.isinf(float(gated[2].grad_norm))
    _assert_bit_equal(_items(*gated[:2]), _items(*plain[:2]))
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    jopt = jax_make_optimizer("galore-sara-adam", jp, **kw)
    _, jst, jaux = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), jopt.init(jp), jp,
                               refresh=True, apply=True, skip_nonfinite=True)
    assert float(jaux.skipped) == 0.0 and int(jst.step) == gated[1].step == 1


@pytest.mark.parametrize("poison", [None, ("down_proj", float("nan")), ("k_proj", float("inf")),
                                    ("embed", float("nan"))])
def test_bucketed_all_finite_matches_jax(pair, poison):
    """The per-bucket check against JAX's on the same gradients (clean, a
    NaN or an Inf in a bucketed leaf, a NaN in a leaf outside every
    bucket), and the gate's whole-gradient verdict is the buckets' and the
    other leaves' together."""
    from repro.core import buckets as jax_buckets
    from repro_torch.core import buckets

    kw = dict(OPT_KW, engine="bucketed", svd_backend="randomized")
    jopt = jax_make_optimizer("galore-sara-adam", pair["jparams"], **kw)
    topt = make_optimizer("galore-sara-adam", pair["tparams"], **kw)
    tg = tree_leaves(_torch_tree(pair["jgrads"][0]))
    if poison is not None:
        tg = _poisoned(tree_unflatten(pair["tparams"], tg), *poison)
    jg = [jnp.asarray(g.numpy()) for g in tg]
    want = [bool(x) for x in jax_buckets.bucketed_all_finite(jopt.bucket_plan, jg)]
    got = [bool(x) for x in buckets.bucketed_all_finite(topt.bucket_plan, tg)]
    assert got == want and len(got) == len(topt.bucket_plan.buckets) > 1
    assert all(got) == (poison is None or poison[0] == "embed")
    assert bool(buckets.all_finite(tg)) == (poison is None)
