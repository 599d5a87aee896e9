"""The port's bucketed ``galore-sara-adam`` on the MoE, SSM, hybrid, VLM
and enc-dec families against the JAX package's, on the CPU at the smoke
configs in f32: the plan (expert stacks (L, E, d, ff) put L*E slices into
one bucket), one refresh and one hot ``update(apply=True)``, with JAX's
params, gradients and refresh draws carried across; for llava-next-34b and
whisper-medium a 3-step ``train_loop`` on both engines with the family's
prefix (``patch_embeds``, ``frame_embeds``) in every batch, and the
microbatched step slicing it.  And ``build_specs`` of the six full-width
configs, from ``jax.eval_shape`` shapes, against the port's on the same
shapes: path, low-rank flag, side, rank and group."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.configs.registry import get_config as jax_get_config
from repro.core import make_optimizer as jax_make_optimizer
from repro.core import schedules as jax_schedules
from repro.core.lowrank import OptimizerConfig as JaxOptimizerConfig
from repro.core.lowrank import build_specs as jax_build_specs
from repro.models import build_model as jax_build_model
from repro.train.loop import train_loop as jax_train_loop
from repro.train.state import TrainState as JaxTrainState
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch import bridge
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import make_optimizer, schedules
from repro_torch.core.lowrank import OptimizerConfig, build_specs, flatten_with_path
from repro_torch.models import build_model
from repro_torch.train.loop import train_loop
from repro_torch.train.state import TrainState
from repro_torch.train.step import make_train_step
from test_torch_optim_kernels import JaxDraws
from test_torch_train import HOT_TOL, REFRESH_TOL, _assert_params_close, _torch_tree

# One intra-op thread: the test workers share the host's cores, and the
# port's results do not depend on the thread count (core/svd.py).
torch.set_num_threads(1)

# mamba2-370m's case runs in test_torch_ssm.py (each file within its time)
ARCHS = ["deepseek-moe-16b", "hymba-1.5b"]
OPT_KW = dict(rank=8, lr=0.01, grad_clip_norm=1.0, engine="bucketed",
              svd_backend="randomized")


def _eps_sensitive(jopt, jstate, grads, floor=1e-6):
    """{leaf path: bool mask shaped like the leaf} of the elements whose
    first Adam step reads an R = P^T G entry with 0 < |r| < ``floor``:
    there the direction r / (|r| + 1e-8) turns a LAPACK-level difference
    in P into an O(1) one (test_torch_train's REFRESH_TOL note).  Such
    entries come from directions the sampled subspace holds beyond the
    slice gradient's rank: a smoke expert sees ~8 routed tokens, and
    hymba's out_proj gradient (32 tokens) has one such entry at rank 8.
    An expert no token reached has R exactly 0 and is not flagged."""
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    out = {}
    for bk, bst in zip(jopt.bucket_plan.buckets, jstate.buckets):
        proj = np.asarray(bst.projector)
        off = 0
        for e in bk.entries:
            path, g = flat[e.leaf_idx]
            g = np.asarray(g)
            g3 = g.reshape((-1,) + g.shape[-2:])
            gc = np.swapaxes(g3, -1, -2) if e.side == "right" else g3
            r = np.swapaxes(proj[off:off + e.batch], -1, -2) @ gc  # (b, r, n)
            cols = ((np.abs(r) < floor) & (r != 0)).any(axis=-2)  # (b, n)
            mask = cols[:, :, None] if e.side == "right" else cols[:, None, :]
            out[jax.tree_util.keystr(path)] = np.broadcast_to(mask, g3.shape).reshape(g.shape)
            off += e.batch
    return out


def _assert_refresh_params_close(jp1, tp1, sensitive):
    """W' after the refresh at REFRESH_TOL, but for the eps-sensitive
    elements (``_eps_sensitive``), which must stay within one step's
    largest possible move of JAX's: lr * alpha * sum_j |P_ij| |dN_j| <=
    lr * alpha * 2 sqrt(rank)."""
    ja = jax.tree_util.tree_flatten_with_path(jp1)[0]
    tb = flatten_with_path(tp1)
    assert [jax.tree_util.keystr(p) for p, _ in ja] == [p for p, _ in tb]
    bound = OPT_KW["lr"] * 0.25 * 2 * np.sqrt(OPT_KW["rank"])  # alpha 0.25 by default
    for (_, a), (key, b) in zip(ja, tb):
        a, b = np.asarray(a), b.numpy()
        mask = sensitive.get(key, np.zeros(a.shape, bool))
        np.testing.assert_allclose(b[~mask], a[~mask], err_msg=key, **REFRESH_TOL)
        assert np.all(np.abs(b - a)[mask] <= bound), key


@pytest.mark.parametrize("arch", ARCHS)
def test_refresh_then_hot_update_match_jax(arch):
    refresh_then_hot_update_match_jax(arch)


def refresh_then_hot_update_match_jax(arch):
    jcfg = jax_get_config(arch, smoke=True).with_(dtype=jnp.float32)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = _torch_tree(jparams)
    rng = np.random.default_rng(9)
    tok = rng.integers(0, jcfg.vocab_size, (2, 2, 17)).astype(np.int32)
    vg = jax.jit(jax.grad(lambda p, b: jmodel.loss(p, b)[0]))
    g0, g1 = (vg(jparams, {"tokens": jnp.asarray(t[:, :-1]), "labels": jnp.asarray(t[:, 1:])})
              for t in tok)
    jopt = jax_make_optimizer("galore-sara-adam", jparams, **OPT_KW)
    topt = make_optimizer("galore-sara-adam", tparams, **OPT_KW)
    assert [(b.d, b.n, b.rank, b.batch, b.side) for b in topt.bucket_plan.buckets] == \
        [(b.d, b.n, b.rank, b.batch, b.side) for b in jopt.bucket_plan.buckets]
    assert topt.bucket_plan.bucketed == jopt.bucket_plan.bucketed
    if arch == "deepseek-moe-16b":  # gate, up (right) and down (left) share a bucket
        cfg = jcfg
        expert = [b for b in topt.bucket_plan.buckets if (b.d, b.n) == (cfg.d_ff, cfg.d_model)]
        assert expert[0].batch == 3 * cfg.n_layers * cfg.n_experts
    js0 = jopt.init(jparams)
    ts0 = bridge.opt_state_from_numpy(topt, jax.tree_util.tree_map(np.asarray, js0),
                                      "cpu")._replace(draws=JaxDraws(js0.key))
    update = jax.jit(jopt.update, static_argnames=("refresh", "apply"))
    jp1, js1, _ = update(g0, js0, jparams, refresh=True, apply=True)
    tp1, _, _ = topt.update(_torch_tree(g0), ts0, tparams, refresh=True, apply=True)
    _assert_refresh_params_close(jp1, tp1, _eps_sensitive(jopt, js1, g0))
    # hot step from one state: JAX's post-refresh state carried across
    ts1 = bridge.opt_state_from_numpy(topt, jax.tree_util.tree_map(np.asarray, js1), "cpu")
    jp2, _, jaux = update(g1, js1, jp1, refresh=False, apply=True)
    tp2, _, taux = topt.update(_torch_tree(g1), ts1, _torch_tree(jp1), refresh=False,
                               apply=True)
    _assert_params_close(jp2, tp2, **HOT_TOL)
    np.testing.assert_allclose(float(taux.update_norm), float(jaux.update_norm), rtol=1e-5)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "olmoe-1b-7b", "mamba2-370m",
                                  "hymba-1.5b", "llava-next-34b", "whisper-medium"])
def test_full_width_specs_match_jax(arch):
    """Low-rank eligibility reads only the path and the last two dims, so
    mamba's (48, 32) and hymba's (32, 50) ``d_skip`` stacks get a projector
    across the layer axis in both packages (ROADMAP queue 3)."""
    jcfg = jax_get_config(arch)
    shapes = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0))
    for kw in (dict(rank=512), dict(rank=256, refresh_groups=2)):
        jspecs = jax.tree_util.tree_leaves(
            jax_build_specs(shapes, JaxOptimizerConfig(**kw)),
            is_leaf=lambda x: type(x).__name__ == "LeafSpec")
        meta = jax.tree_util.tree_map(lambda s: torch.empty(s.shape, device="meta"), shapes)
        tspecs = build_specs(meta, OptimizerConfig(**kw))
        assert [tuple(s) for s in tspecs] == [tuple(s) for s in jspecs]
    by_path = {s.path: s for s in tspecs}
    if jcfg.family in ("ssm", "hybrid"):
        prefix = "['blocks']['mixer']" if jcfg.family == "ssm" else "['blocks']['ssm_mixer']"
        d_skip = by_path[prefix + "['d_skip']"]
        assert d_skip.lowrank and d_skip.rank == min(jcfg.n_layers, 32 if jcfg.family == "ssm"
                                                     else 50)
        assert not by_path[prefix + "['dt_bias']"].lowrank


def test_chunked_stacked_refresh_equals_one_chain(monkeypatch):
    """A stack past ``STACK_REFRESH_BYTES`` (deepseek's 768-slice expert
    bucket at full width) refreshes in equal chunks of slices, each
    slice's chain its own: the same projectors as one chain, with one
    power-iteration launch per chunk and iteration."""
    from repro_torch.core import projectors as proj_lib
    from repro_torch.kernels.power_iter import ops as power_ops

    cfg = proj_lib.ProjectorConfig(method="sara", rank=4, svd_backend="randomized")
    gen = torch.Generator().manual_seed(0)
    b, d, n = 10, 48, 64  # k 16, k' 24 < d: the power iterations run
    g = torch.randn(b, d, n, generator=gen)
    k = min(d, cfg.sara_pool_factor * 4)
    kp = min(k + cfg.svd_oversample, d)
    draws = proj_lib.LeafDraws(omega=torch.randn(b, n, kp, generator=gen),
                               gumbel=-torch.log(-torch.log(torch.rand(b, k, generator=gen))))
    calls = []
    real_step = power_ops.power_iter_step
    monkeypatch.setattr(power_ops, "power_iter_step",
                        lambda g_, q_: calls.append(g_.shape[0]) or real_step(g_, q_))
    one = proj_lib.refresh_projector_stacked(g, draws, None, cfg, rank=4)
    assert calls == [b] * cfg.svd_power_iters
    calls.clear()
    monkeypatch.setattr(proj_lib, "STACK_REFRESH_BYTES", 4 * n * kp * 4)  # 4 slices fit
    assert proj_lib.refresh_chunk(b, d, n, kp) == 4  # 3 chunks: 4, 4, 2
    chunked = proj_lib.refresh_projector_stacked(g, draws, None, cfg, rank=4)
    assert calls == [c for c in (4, 4, 2) for _ in range(cfg.svd_power_iters)]
    torch.testing.assert_close(chunked, one, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the VLM and enc-dec families: the prefix in every batch
# ---------------------------------------------------------------------------

def _prefix_batches(cfg, n, b=4, s=16, seed=21):
    """``n`` numpy batches of tokens and labels (the next token) with the
    family's prefix: ``n_patches`` patch embeddings or ``enc_frames``
    frames, normal x 0.1."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tok = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
        batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
        if cfg.family == "vlm":
            shape, key = (b, cfg.n_patches, cfg.d_model), "patch_embeds"
        else:
            shape, key = (b, cfg.enc_frames, cfg.d_model), "frame_embeds"
        batch[key] = (0.1 * rng.standard_normal(shape)).astype(np.float32)
        out.append(batch)
    return out


class _Data:
    def __init__(self, batches, to):
        self.batches, self.to = batches, to

    def batch_at(self, step):
        return {k: self.to(v) for k, v in self.batches[step].items()}


# whisper-medium's cases run in test_torch_encdec.py (each file within its time)
def test_three_step_train_loop_with_the_prefix_matches_jax(tmp_path):
    three_step_train_loop_with_the_prefix_matches_jax("llava-next-34b", tmp_path)


def test_microbatched_step_slices_the_prefix():
    microbatched_step_slices_the_prefix("llava-next-34b")


def three_step_train_loop_with_the_prefix_matches_jax(arch, tmp_path):
    """Refresh at step 0, then two hot steps, on shared batches that carry
    the prefix, through the port's loop on both engines: losses to 1e-5,
    the history's norms to 1e-4, final params to REFRESH_TOL (the refresh's
    LAPACK differences carry on).  JAX's loop runs once, on its bucketed
    engine: its two engines agree to 1-2 ulp (ROADMAP queue 3), far inside
    these bars, so one run holds both of the port's (and its compile is
    most of the test's time)."""
    steps = 3
    jcfg = jax_get_config(arch, smoke=True).with_(dtype=jnp.float32)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(get_config(arch, smoke=True).with_(dtype=torch.float32), device="cpu")
    batches = _prefix_batches(jcfg, steps)
    kw = dict(OPT_KW, tau=200)
    jopt = jax_make_optimizer("galore-sara-adam", jparams,
                              lr_schedule=jax_schedules.cosine_with_warmup(0.01, 1, steps),
                              **dict(kw, engine="bucketed"))
    jstate = JaxTrainState(jparams, jopt.init(jparams))
    jtc = JaxTrainConfig(total_steps=steps, checkpoint_every=0,
                         checkpoint_dir=str(tmp_path / "ckpt"))
    jres = jax_train_loop(jmodel, jopt, _Data(batches, jnp.asarray), jtc,
                          jax_make_train_step(jmodel, jopt, train_cfg=jtc, donate=False),
                          state=jstate, log_every=1, handle_signals=False)
    for engine in ("bucketed", "reference"):
        tparams = _torch_tree(jparams)
        topt = make_optimizer("galore-sara-adam", tparams,
                              lr_schedule=schedules.cosine_with_warmup(0.01, 1, steps),
                              **dict(kw, engine=engine))
        tc = TrainConfig(total_steps=steps, checkpoint_dir=str(tmp_path / f"port_{engine}"))
        tstate = TrainState(tparams, topt.init(tparams)._replace(
            draws=JaxDraws(jstate.opt_state.key)))
        tres = train_loop(tmodel, topt, _Data(batches, torch.from_numpy), tc,
                          make_train_step(tmodel, topt, train_cfg=tc), state=tstate,
                          log_every=1)
        np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-5, err_msg=engine)
        for tr, jr in zip(tres.history, jres.history):
            for key in ("loss", "grad_norm", "update_norm"):
                np.testing.assert_allclose(tr[key], jr[key], rtol=1e-4, err_msg=f"{engine} {key}")
        assert tres.state.step == int(jres.state.opt_state.step) == steps
        _assert_params_close(jres.state.params, tres.state.params, **REFRESH_TOL)


def microbatched_step_slices_the_prefix(arch):
    """``train/step.py`` slices every key of the batch per microbatch, the
    prefix included: 2 x 2 accumulated gives the whole batch's gradient
    norm and params; a batch whose prefix does not match its tokens would
    raise inside the model."""
    cfg = get_config(arch, smoke=True).with_(dtype=torch.float32)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    opt = make_optimizer("galore-sara-adam", params, **OPT_KW)
    state = TrainState(params, opt.init(params))
    batch = _Data(_prefix_batches(cfg, 1), torch.from_numpy).batch_at(0)
    seen = []
    loss = model.loss
    outs = []
    for micro in (0, 2):
        spy = model._replace(loss=lambda p, b: seen.append({k: tuple(v.shape) for k, v in
                                                           b.items()}) or loss(p, b))
        new, metrics = make_train_step(spy, opt, train_cfg=TrainConfig(microbatch=micro))[
            "refresh_step"](state, batch)
        outs.append((new.params, float(metrics["grad_norm"])))
    prefix = "patch_embeds" if cfg.family == "vlm" else "frame_embeds"
    assert [s[prefix][0] for s in seen] == [4, 2, 2]
    assert all(s["tokens"][0] == s[prefix][0] for s in seen)
    np.testing.assert_allclose(outs[1][1], outs[0][1], rtol=1e-5)
    for (path, a), (_, b) in zip(flatten_with_path(outs[0][0]), flatten_with_path(outs[1][0])):
        torch.testing.assert_close(b, a, atol=5e-5, rtol=0, msg=path)
