"""The port's training slice (src/repro_torch) against the JAX package's, on
the CPU: ``loss_fn`` and its gradients, the optimizer's static plan, one
refresh and one hot ``update(apply=True)`` of ``galore-sara-adam`` per
engine and SVD backend, a 3-step ``train_loop``, the microbatch contract
and the launcher.  All on ``get_config("llama3-8b", smoke=True)`` in f32,
with JAX's params carried across through ``bridge.py``, JAX's batches
handed to both packages, and JAX's refresh draws handed to the port
(``JaxDraws``).  Rank 8 at d_model 64, so the SARA pool (4 x rank + 8
oversample = 40 < 64) takes the power-iteration path, as at full width.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.configs.registry import get_config as jax_get_config
from repro.core import make_optimizer as jax_make_optimizer
from repro.core import schedules as jax_schedules
from repro.data.synthetic import SyntheticDataConfig, SyntheticDataset
from repro.models import build_model as jax_build_model
from repro.train.loop import train_loop as jax_train_loop
from repro.train.state import TrainState as JaxTrainState
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch import bridge
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import buckets, lowrank, make_optimizer, schedules
from repro_torch.core.lowrank import flatten_with_path, tree_leaves, tree_unflatten
from repro_torch.models import build_model
from repro_torch.train.loop import train_loop
from repro_torch.train.state import TrainState
from repro_torch.train.step import make_train_step
from test_torch_optim_kernels import JaxDraws

# One intra-op thread: the test workers share the host's cores, and the
# port's results do not depend on the thread count (core/svd.py).
torch.set_num_threads(1)

RANK = 8
OPT_KW = dict(rank=RANK, lr=0.01, grad_clip_norm=1.0)
# Loss and gradients: f32, the same products summed in other orders.
GRAD_TOL = dict(atol=1e-6, rtol=1e-5)
# Params after a hot update from one state: the verify skill's 1e-6 bar.
HOT_TOL = dict(atol=1e-6, rtol=0)
# Params after a refresh: the SVD's small singular vectors differ between
# torch's LAPACK and jaxlib's by up to ~2e-5 (measured), SARA samples
# such vectors, and Adam's first-step direction r / (|r| + eps) on their
# rows (|r| ~ 1e-8) amplifies that to up to 1.8e-5 in W (see ROADMAP
# queue 3).  That is < 1% of the step's own move, lr * alpha = 2.5e-3.
REFRESH_TOL = dict(atol=5e-5, rtol=0)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _torch_tree(tree):
    return bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def _batch(b):
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in b.items()}


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_get_config("llama3-8b", smoke=True).with_(dtype=jnp.float32)
    tcfg = get_config("llama3-8b", smoke=True).with_(dtype=torch.float32)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    data = SyntheticDataset(SyntheticDataConfig(
        vocab_size=jcfg.vocab_size, seq_len=32, global_batch=4))
    batches = [data.batch_at(i) for i in range(3)]
    vg = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))
    outs = [vg(jparams, b) for b in batches[:2]]
    return dict(
        jmodel=jmodel, tmodel=build_model(tcfg, device="cpu"), jparams=jparams,
        tparams=_torch_tree(jparams), batches=batches,
        jloss=outs[0][0], jgrads=[g for _, g in outs],
    )


def _assert_params_close(jtree, tparams, **tol):
    ja = jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(np.asarray, jtree))[0]
    tb = flatten_with_path(tparams)
    assert [jax.tree_util.keystr(p) for p, _ in ja] == [p for p, _ in tb]
    for (path, a), (_, b) in zip(ja, tb):
        np.testing.assert_allclose(_np(b), a, err_msg=jax.tree_util.keystr(path), **tol)


def _signs(pj, pt):
    """Per-column signs that align the port's projector columns with JAX's
    (LAPACK's sign choices may differ): (..., 1, r)."""
    return np.sign(np.sum(pj * pt, axis=-2, keepdims=True))


def _assert_states_close(jopt, jstate, topt, tstate, p_atol, m_tol):
    """Projectors and moments sign-invariantly: the port's projector columns
    and moment rows (left) / columns (right) sign-aligned against JAX's;
    V compared directly (squares)."""
    assert tstate.step == int(jstate.step)
    if topt.state_layout is not None:
        for bi, (jb, tb) in enumerate(zip(jstate.buckets, tstate.buckets)):
            pj, pt = np.asarray(jb.projector), _np(tb.projector)
            s = _signs(pj, pt)
            np.testing.assert_allclose(pt * s, pj, atol=p_atol, err_msg=f"bucket {bi}")
            np.testing.assert_allclose(_np(tb.m) * np.swapaxes(s, -1, -2),
                                       np.asarray(jb.m), **m_tol)
            np.testing.assert_allclose(_np(tb.v), np.asarray(jb.v), **m_tol)
        return
    jleaves = jax.tree_util.tree_leaves(
        jstate.leaves, is_leaf=lambda x: hasattr(x, "projector"))
    for spec, jl, tl in zip(topt.specs, jleaves, tstate.leaves):
        if not spec.lowrank:
            np.testing.assert_allclose(_np(tl.inner.m), np.asarray(jl.inner.m), **m_tol)
            continue
        pj, pt = np.asarray(jl.projector), _np(tl.projector)
        s = _signs(pj, pt)
        np.testing.assert_allclose(pt * s, pj, atol=p_atol, err_msg=spec.path)
        ms = np.swapaxes(s, -1, -2) if spec.side == "left" else s
        np.testing.assert_allclose(_np(tl.inner.m) * ms, np.asarray(jl.inner.m), **m_tol)
        np.testing.assert_allclose(_np(tl.inner.v), np.asarray(jl.inner.v), **m_tol)


# ---------------------------------------------------------------------------
# model: loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", ["block", "none"])
def test_loss_and_every_grad_match_jax(pair, remat):
    tmodel = build_model(pair["tmodel"].cfg.with_(remat=remat), device="cpu")
    batch = pair["batches"][0]
    (jl, jm), jg = pair["jloss"], pair["jgrads"][0]
    leaves = [p.clone().requires_grad_(True) for p in tree_leaves(pair["tparams"])]
    params = tree_unflatten(pair["tparams"], leaves)
    tl, tm = tmodel.loss(params, _batch(batch))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    assert float(tm["tokens"]) == float(jm["tokens"]) == 4 * 31  # last label masked
    _assert_params_close(jg, tree_unflatten(pair["tparams"], [p.grad for p in leaves]),
                         **GRAD_TOL)


def test_chunked_cross_entropy_ragged_chunks_match_one_chunk(pair):
    from repro_torch.models import layers as L

    g = torch.Generator().manual_seed(0)
    h = torch.randn(2, 37, 16, generator=g)
    w = torch.randn(16, 50, generator=g)
    y = torch.randint(-1, 50, (2, 37), generator=g)
    one, n1 = L.chunked_cross_entropy(h, w, y, chunk=64)
    many, n2 = L.chunked_cross_entropy(h, w, y, chunk=8)
    torch.testing.assert_close(many, one, rtol=1e-6, atol=1e-6)
    assert float(n1) == float(n2) == float((y >= 0).sum())
    logits = (h @ w).reshape(-1, 50)
    ref = torch.nn.functional.cross_entropy(logits, y.reshape(-1).long(), ignore_index=-1)
    torch.testing.assert_close(one, ref, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# optimizer: the static plan, one refresh and one hot update
# ---------------------------------------------------------------------------


def test_bucket_plan_and_specs_match_jax(pair):
    kw = dict(OPT_KW, engine="bucketed", svd_backend="randomized")
    jopt = jax_make_optimizer("galore-sara-adam", pair["jparams"], **kw)
    topt = make_optimizer("galore-sara-adam", pair["tparams"], **kw)
    jspecs = jax.tree_util.tree_leaves(
        jopt.specs, is_leaf=lambda x: type(x).__name__ == "LeafSpec")
    assert [tuple(s) for s in topt.specs] == [tuple(s) for s in jspecs]
    assert len(topt.bucket_plan.buckets) == len(jopt.bucket_plan.buckets) == 3
    for jb, tb in zip(jopt.bucket_plan.buckets, topt.bucket_plan.buckets):
        assert (tb.d, tb.n, tb.rank, tb.side) == (jb.d, jb.n, jb.rank, jb.side)
        assert [tuple(e) for e in tb.entries] == [tuple(e) for e in jb.entries]
    assert topt.bucket_plan.bucketed == jopt.bucket_plan.bucketed
    # both sides share a bucket: down_proj (128, 64) enters transposed
    sides = {e.side for b in topt.bucket_plan.buckets for e in b.entries}
    assert sides == {"left", "right"}


@pytest.mark.parametrize("engine", ["reference", "bucketed"])
@pytest.mark.parametrize("backend", ["exact", "randomized"])
def test_refresh_then_hot_update_match_jax(pair, engine, backend):
    kw = dict(OPT_KW, engine=engine, svd_backend=backend)
    jopt = jax_make_optimizer("galore-sara-adam", pair["jparams"], **kw)
    topt = make_optimizer("galore-sara-adam", pair["tparams"], **kw)
    assert (topt.state_layout is None) == (engine == "reference")
    js0 = jopt.init(pair["jparams"])
    ts0 = bridge.opt_state_from_numpy(
        topt, jax.tree_util.tree_map(np.asarray, js0), "cpu")._replace(
            draws=JaxDraws(js0.key))
    g0, g1 = pair["jgrads"]

    # refresh (step 0): the port draws JAX's sketches and Gumbel noise
    update = jax.jit(jopt.update, static_argnames=("refresh", "apply"))
    jp1, js1, jaux = update(g0, js0, pair["jparams"], refresh=True, apply=True)
    tp1, ts1, taux = topt.update(_torch_tree(g0), ts0, pair["tparams"],
                                 refresh=True, apply=True)
    _assert_params_close(jp1, tp1, **REFRESH_TOL)
    _assert_states_close(jopt, js1, topt, ts1, p_atol=5e-5, m_tol=dict(atol=5e-7, rtol=1e-4))
    for name in ("grad_norm", "update_norm", "mean_refresh_overlap"):
        np.testing.assert_allclose(float(getattr(taux, name)), float(getattr(jaux, name)),
                                   rtol=1e-5, err_msg=name)

    # hot step from one state: JAX's post-refresh state carried across
    ts1 = bridge.opt_state_from_numpy(topt, jax.tree_util.tree_map(np.asarray, js1), "cpu")
    jp2, js2, jaux = update(g1, js1, jp1, refresh=False, apply=True)
    tp2, ts2, taux = topt.update(_torch_tree(g1), ts1, _torch_tree(jp1),
                                 refresh=False, apply=True)
    _assert_params_close(jp2, tp2, **HOT_TOL)
    _assert_states_close(jopt, js2, topt, ts2, p_atol=0.0, m_tol=dict(atol=1e-7, rtol=1e-5))
    np.testing.assert_allclose(float(taux.update_norm), float(jaux.update_norm), rtol=1e-5)


@pytest.mark.parametrize("carry", ["keep", "reset", "reproject"])
def test_engines_agree_across_refreshes(pair, carry):
    """The port's two engines against each other, with the port's own
    draws (``TorchDraws``: the same numbers for both engines, as they are
    keyed by leaf index) and one LAPACK, so signs agree too: refresh, hot,
    refresh with each momentum carry.  Params, and the bucket stacks
    unstacked per leaf (``bucketed_to_leaf_states``) against the
    reference engine's per-leaf projectors and moments."""
    outs = []
    for engine in ("reference", "bucketed"):
        opt = make_optimizer("galore-sara-adam", pair["tparams"], engine=engine,
                             svd_backend="randomized", momentum_carry=carry, **OPT_KW)
        params, state = pair["tparams"], opt.init(pair["tparams"])
        for k, g in enumerate(pair["jgrads"] + pair["jgrads"][:1]):
            params, state, _ = opt.update(_torch_tree(g), state, params,
                                          refresh=k != 1, apply=True)
        outs.append((opt, params, state))
    (_, ref_params, ref_state), (opt, params, state) = outs
    for (path, a), (_, b) in zip(flatten_with_path(ref_params), flatten_with_path(params)):
        torch.testing.assert_close(b, a, atol=1e-6, rtol=0, msg=path)
    per_leaf = buckets.bucketed_to_leaf_states(opt.state_layout, state.buckets)
    assert sorted(per_leaf) == sorted(opt.bucket_plan.bucketed)
    for i, (proj, inner) in per_leaf.items():
        want = ref_state.leaves[i]
        torch.testing.assert_close(proj, want.projector, atol=1e-6, rtol=0)
        torch.testing.assert_close(inner.m, want.inner.m, atol=1e-7, rtol=1e-5)
        torch.testing.assert_close(inner.v, want.inner.v, atol=1e-9, rtol=1e-5)


# ---------------------------------------------------------------------------
# train step and loop
# ---------------------------------------------------------------------------


class _SharedData:
    """The JAX dataset's batches, as torch tensors, for the port's loop."""

    def __init__(self, batches):
        self.batches = batches

    def batch_at(self, step):
        return _batch(self.batches[step])


def test_three_step_train_loop_matches_jax(pair, tmp_path):
    """Refresh at step 0, then two hot steps, on shared batches, with the
    launcher's schedule (lr 0 at step 0).  Losses to 1e-5; final params to
    REFRESH_TOL (the refresh's SVD differences carry into the hot steps)."""
    steps = 3
    kw = dict(OPT_KW, engine="bucketed", svd_backend="randomized", tau=200)
    jopt = jax_make_optimizer(
        "galore-sara-adam", pair["jparams"],
        lr_schedule=jax_schedules.cosine_with_warmup(0.01, 1, steps), **kw)
    topt = make_optimizer(
        "galore-sara-adam", pair["tparams"],
        lr_schedule=schedules.cosine_with_warmup(0.01, 1, steps), **kw)
    jstate = JaxTrainState(pair["jparams"], jopt.init(pair["jparams"]))
    jtc = JaxTrainConfig(total_steps=steps, checkpoint_every=0,
                         checkpoint_dir=str(tmp_path / "ckpt"))
    jfns = jax_make_train_step(pair["jmodel"], jopt, train_cfg=jtc, donate=False)

    class _JaxData:
        def batch_at(self, step):
            return pair["batches"][step]

    jres = jax_train_loop(pair["jmodel"], jopt, _JaxData(), jtc, jfns, state=jstate,
                          log_every=1, handle_signals=False)
    tc = TrainConfig(total_steps=steps, checkpoint_dir=str(tmp_path / "port_ckpt"))
    tstate = TrainState(pair["tparams"], topt.init(pair["tparams"])._replace(
        draws=JaxDraws(jstate.opt_state.key)))
    tres = train_loop(pair["tmodel"], topt, _SharedData(pair["batches"]), tc,
                      make_train_step(pair["tmodel"], topt, train_cfg=tc),
                      state=tstate, log_every=1)
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-5)
    assert [r["step"] for r in tres.history] == [0.0, 1.0, 2.0]
    for tr, jr in zip(tres.history, jres.history):
        for key in ("loss", "grad_norm", "update_norm"):
            np.testing.assert_allclose(tr[key], jr[key], rtol=1e-4, err_msg=key)
    assert tres.state.step == int(jres.state.opt_state.step) == steps
    _assert_params_close(jres.state.params, tres.state.params, **REFRESH_TOL)


def test_microbatch_accumulation_and_divisibility_error(pair):
    model = pair["tmodel"]
    opt = make_optimizer("galore-sara-adam", pair["tparams"], **OPT_KW)
    state = TrainState(pair["tparams"], opt.init(pair["tparams"]))
    batch = _batch(pair["batches"][0])  # global batch 4
    bad = make_train_step(model, opt, train_cfg=TrainConfig(microbatch=3))
    with pytest.raises(ValueError, match="not divisible by microbatch 3"):
        bad["step"](state, batch)
    # 2 x 2 accumulated in f32 gives the whole batch's gradient (equal-size
    # microbatches with equal token counts: the last label of each row is
    # masked); a microbatch >= the batch is one microbatch.  As in JAX
    # (step.py:117, 282), metrics["loss"] is the last microbatch's.
    with torch.no_grad():
        last_half = float(model.loss(pair["tparams"], {k: v[2:] for k, v in batch.items()})[0])
        whole = float(model.loss(pair["tparams"], batch)[0])
    outs = []
    for micro in (0, 2, 8):
        fns = make_train_step(model, opt, train_cfg=TrainConfig(microbatch=micro))
        new, metrics = fns["refresh_step"](state, batch)
        outs.append((new.params, float(metrics["loss"]), float(metrics["grad_norm"])))
    for (_, loss, _), want in zip(outs, (whole, last_half, whole)):
        np.testing.assert_allclose(loss, want, rtol=1e-6)
    for params, _, gnorm in outs[1:]:
        np.testing.assert_allclose(gnorm, outs[0][2], rtol=1e-5)
        for (path, a), (_, b) in zip(flatten_with_path(outs[0][0]), flatten_with_path(params)):
            torch.testing.assert_close(b, a, atol=5e-5, rtol=0, msg=path)


def test_train_configs_share_the_jax_defaults():
    jt, tt = JaxTrainConfig(), TrainConfig()
    for f in dataclasses.fields(tt):
        a, b = getattr(jt, f.name), getattr(tt, f.name)
        if f.name == "accum_dtype":
            assert jnp.dtype(a).name == str(b).split(".")[-1]
        else:
            assert a == b, f.name
    assert get_config("llama3-8b").remat == jax_get_config("llama3-8b").remat == "block"


# ---------------------------------------------------------------------------
# launcher and device policy
# ---------------------------------------------------------------------------


def test_launch_train_smoke_on_cpu_runs(capsys, tmp_path):
    from repro_torch.launch import train as launch_train

    launch_train.main(["--smoke", "--device", "cpu", "--steps", "3", "--tau", "2",
                       "--rank", "8", "--engine", "bucketed",
                       "--svd-backend", "randomized", "--seq", "16", "--batch", "4",
                       "--ckpt-dir", str(tmp_path / "ckpt")])
    out = capsys.readouterr().out
    assert "[train] done: step 3" in out


def test_training_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    from repro_torch.data.synthetic import SyntheticDataConfig as TDataConfig
    from repro_torch.data.synthetic import SyntheticDataset as TDataset
    from repro_torch.launch import train as launch_train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TDataset(TDataConfig(vocab_size=16, seq_len=4, global_batch=2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(get_config("llama3-8b", smoke=True))  # train_loop's model


def test_unported_optimizer_options_raise(pair):
    """ZeRO state and projected gradients (the data-parallel step's) build
    and run, with JAX's validation (ZeRO needs bucket-native state; a
    projected refresh raises), a projected hot step equals the plain one
    on the same gradients; the baselines (golore, Adafactor, Fira), rank
    schedules and group ranks build, with JAX's validation, and the
    skip-step gate runs."""
    with pytest.raises(ValueError, match="bucket-native state"):
        make_optimizer("galore-sara-adam", pair["tparams"], state_sharding="zero",
                       state_shards=2)
    zopt = make_optimizer("galore-sara-adam", pair["tparams"], state_sharding="zero",
                          state_shards=2, rank=RANK, engine="bucketed")
    assert zopt.state_layout.shards == 2
    plain = make_optimizer("galore-sara-adam", pair["tparams"], rank=RANK)
    pstate = plain.init(pair["tparams"])
    grads = _torch_tree(pair["jgrads"][0])
    want, _, _ = plain.update(grads, pstate, pair["tparams"], refresh=False, apply=True)
    got, _, _ = plain.update(lowrank.project_grads(plain, grads, pstate), pstate,
                             pair["tparams"], refresh=False, projected=True, apply=True)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(got), tree_leaves(want)))
    with pytest.raises(ValueError, match="cannot drive a refresh"):
        plain.update(grads, pstate, pair["tparams"], refresh=True, projected=True)
    for name, kw in (("golore-adam", {}), ("galore-sara-adafactor", {}),
                     ("galore-sara-adam", {"fira": True}),
                     ("galore-sara-adam", {"rank_schedule": "cosine:8:4"}),
                     ("galore-sara-adam", {"group_ranks": (8,)})):
        make_optimizer(name, pair["tparams"], **kw)
    for kw in ({"rank_schedule": "warp:8"}, {"group_ranks": (8, 4)}, {"group_ranks": (0,)}):
        with pytest.raises(ValueError):
            make_optimizer("galore-sara-adam", pair["tparams"], **kw)
    opt = make_optimizer("galore-sara-adam", pair["tparams"], **OPT_KW)
    state = opt.init(pair["tparams"])
    _, new, aux = opt.update(pair["tparams"], state, pair["tparams"], refresh=True,
                             skip_nonfinite=True)
    assert float(aux.skipped) == 0.0 and new.step == 1
