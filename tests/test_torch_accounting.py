"""The port's modeled accounting and roofline against the JAX package's.

``core/buckets.py``'s models (``modeled_hbm_bytes``, ``update_num_ops``,
``reference_num_ops``, ``finite_check_model``, ``refresh_num_ops``,
``modeled_refresh_hbm_bytes``, ``modeled_state_bytes``,
``sharded_ckpt_model``, ``dp_comm_model``) and the rank schedule's
(``scheduled_state_model``, ``rebucket_cost_model``) are integer and
closed-form, so they are held equal to JAX's exactly, on the full-width
bucket plans of every arch (the port's built on meta tensors, JAX's on
``eval_shape``), for every fused inner, both engines, both state layouts,
replicated and ZeRO state at 1, 2, 4 and 8 shards, and the schedule
``cosine:128:32@0.5``.  ``roofline/analysis.py``'s ``active_params``,
``model_bytes`` and ``model_flops`` equal JAX's on all 40 cells; the
report keeps JAX's fields and formulas, on ``roofline/hw.py``'s H100
constants."""
import dataclasses
import json

import jax
import pytest
import torch

from repro.configs.base import SHAPES as JAX_SHAPES
from repro.configs.registry import get_config as jax_get_config
from repro.core import buckets as jax_buckets
from repro.core import make_optimizer as jax_make_optimizer
from repro.core import rank_schedule as jax_rs
from repro.models import build_model as jax_build_model
from repro.roofline import analysis as jax_ra
from repro.roofline import hw as jax_hw
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import cells, get_config, list_archs
from repro_torch.core import buckets as buckets_lib
from repro_torch.core import make_optimizer
from repro_torch.core import rank_schedule as rs_lib
from repro_torch.core.lowrank import tree_leaves
from repro_torch.models import build_model, count_params
from repro_torch.roofline import analysis as ra
from repro_torch.roofline import hw

torch.set_num_threads(1)

INNERS = ("adam", "msgd", "adam-mini", "adam8bit")
SHARDS = (1, 2, 4, 8)
SCHEDULE = "cosine:128:32@0.5"
HORIZON = 1000
_CACHE = {}


def _params(arch):
    """(JAX's ShapeDtypeStruct params, the port's meta params) at full width."""
    if arch not in _CACHE:
        jshapes = jax.eval_shape(jax_build_model(jax_get_config(arch)).init,
                                 jax.random.PRNGKey(0))
        meta = build_model(get_config(arch), device="meta").init(torch.Generator())
        _CACHE[arch] = (jshapes, meta)
    return _CACHE[arch]


def _opt_kw(arch):
    cfg = get_config(arch)
    return dict(rank=min(512, max(128, cfg.d_model // 4)), tau=200, lr=0.01,
                svd_backend="randomized", engine="bucketed")


def _plan_key(plan):
    return [(b.batch, b.d, b.n, b.rank, b.side, [tuple(e) for e in b.entries])
            for b in plan.buckets]


def _jax_flat(jopt, jshapes):
    is_spec = lambda x: hasattr(x, "lowrank")  # noqa: E731
    specs, treedef = jax.tree_util.tree_flatten(jopt.specs, is_leaf=is_spec)
    return specs, treedef.flatten_up_to(jshapes)


@pytest.mark.parametrize("inner", INNERS)
@pytest.mark.parametrize("arch", list_archs())
def test_modeled_accounting_equals_jax(arch, inner):
    jshapes, meta = _params(arch)
    name = f"galore-sara-{inner}"
    kw = _opt_kw(arch)
    jopt = jax_make_optimizer(name, jshapes, **kw)
    opt = make_optimizer(name, meta, **kw)
    plan, jplan = opt.bucket_plan, jopt.bucket_plan
    assert _plan_key(plan) == _plan_key(jplan)
    inn = opt.config.inner
    assert inn == jopt.config.inner
    jspecs, jflat = _jax_flat(jopt, jshapes)
    flat = tree_leaves(meta)
    for engine in ("bucketed", "reference"):
        for projected in (False, True):
            for layout in ("bucketed", "perleaf"):
                for track in (False, True):
                    args = dict(engine=engine, projected=projected, state_layout=layout,
                                track_update_norm=track, inner=inn)
                    assert buckets_lib.modeled_hbm_bytes(plan, **args) == \
                        jax_buckets.modeled_hbm_bytes(jplan, **args), args
            assert buckets_lib.update_num_ops(plan, inn, projected) == \
                jax_buckets.update_num_ops(jplan, inn, projected)
            assert buckets_lib.reference_num_ops(plan, projected, inn) == \
                jax_buckets.reference_num_ops(jplan, projected, inn)
            assert buckets_lib.finite_check_model(plan, projected) == \
                jax_buckets.finite_check_model(jplan, projected)
    for engine in ("batched", "perleaf"):
        for kwr in (dict(), dict(oversample=4, power_iters=1, pool_factor=2)):
            assert buckets_lib.refresh_num_ops(plan, opt.specs, engine=engine, **kwr) == \
                jax_buckets.refresh_num_ops(jplan, jspecs, engine=engine, **kwr)
            assert buckets_lib.modeled_refresh_hbm_bytes(plan, opt.specs, engine=engine,
                                                         **kwr) == \
                jax_buckets.modeled_refresh_hbm_bytes(jplan, jspecs, engine=engine, **kwr)
    sched, jsched = rs_lib.parse_rank_schedule(SCHEDULE), jax_rs.parse_rank_schedule(SCHEDULE)
    rank_plans = rs_lib.schedule_rank_plans(opt.config, meta, sched, total_steps=HORIZON)
    jrank_plans = jax_rs.schedule_rank_plans(jopt.config, jshapes, jsched, total_steps=HORIZON)
    assert [(w, _plan_key(p)) for w, p in rank_plans] == \
        [(w, _plan_key(p)) for w, p in jrank_plans]
    for shards in SHARDS:
        assert buckets_lib.modeled_state_bytes(plan, inn, shards) == \
            jax_buckets.modeled_state_bytes(jplan, inn, shards)
        assert buckets_lib.sharded_ckpt_model(plan, inn, shards) == \
            jax_buckets.sharded_ckpt_model(jplan, inn, shards)
        for sizes in (None, {"data": 4}, {"pod": 2, "data": 4}):
            for rp, jrp in ((None, None), (rank_plans, jrank_plans)):
                assert buckets_lib.dp_comm_model(plan, flat, axis_sizes=sizes,
                                                 state_shards=shards, inner=inn,
                                                 rank_plans=rp) == \
                    jax_buckets.dp_comm_model(jplan, jflat, axis_sizes=sizes,
                                              state_shards=shards, inner=inn,
                                              rank_plans=jrp), (shards, sizes)
        got = rs_lib.scheduled_state_model(opt.config, meta, sched, total_steps=HORIZON,
                                           state_shards=shards)
        want = jax_rs.scheduled_state_model(jopt.config, jshapes, jsched, total_steps=HORIZON,
                                            state_shards=shards)
        gp, wp = got.pop("rank_plans"), want.pop("rank_plans")
        assert got == want
        assert [(w, _plan_key(p)) for w, p in gp] == [(w, _plan_key(p)) for w, p in wp]
    hi, lo = rank_plans[0][1], rank_plans[-1][1]
    jhi, jlo = jrank_plans[0][1], jrank_plans[-1][1]
    for a, b in ((hi, lo), (lo, hi), (hi, hi)):
        ja, jb = (jhi if a is hi else jlo), (jhi if b is hi else jlo)
        assert rs_lib.rebucket_cost_model(a, b, inn) == jax_rs.rebucket_cost_model(ja, jb, inn)


def test_refresh_models_follow_the_groups():
    """With two refresh groups each group's refresh counts its own entries,
    as JAX's."""
    jshapes, meta = _params("llama3-8b")
    kw = dict(_opt_kw("llama3-8b"), refresh_groups=2)
    jopt = jax_make_optimizer("galore-sara-adam", jshapes, **kw)
    opt = make_optimizer("galore-sara-adam", meta, **kw)
    jspecs, _ = _jax_flat(jopt, jshapes)
    for group in (0, 1):
        for engine in ("batched", "perleaf"):
            a = buckets_lib.refresh_num_ops(opt.bucket_plan, opt.specs, engine=engine,
                                            group=group)
            assert a == jax_buckets.refresh_num_ops(jopt.bucket_plan, jspecs, engine=engine,
                                                    group=group)
            assert buckets_lib.modeled_refresh_hbm_bytes(
                opt.bucket_plan, opt.specs, engine=engine, group=group) == \
                jax_buckets.modeled_refresh_hbm_bytes(jopt.bucket_plan, jspecs, engine=engine,
                                                      group=group)


@pytest.mark.parametrize("arch", list_archs())
def test_roofline_formulas_equal_jax_on_every_cell(arch):
    jshapes, meta = _params(arch)
    total = count_params(meta)
    assert total == sum(x.size for x in jax.tree_util.tree_leaves(jshapes))
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert ra.active_params(cfg, total) == jax_ra.active_params(jcfg, total)
    for a, s, _ in cells(include_skipped=True):
        if a != arch:
            continue
        assert ra.model_flops(cfg, SHAPES[s], total) == \
            jax_ra.model_flops(jcfg, JAX_SHAPES[s], total), s
        assert ra.model_bytes(cfg, SHAPES[s], total) == \
            jax_ra.model_bytes(jcfg, JAX_SHAPES[s], total), s


def test_hw_holds_the_h100_datasheet_numbers():
    assert hw.HBM_BYTES_PER_S == 3.35e12
    assert hw.PEAK_OPS_PER_S == {"bfloat16": 989e12, "float32": 67e12}
    assert hw.PEAK_FLOPS_BF16 == 989e12 and hw.HBM_BYTES == 80e9
    assert hw.NVLINK_BYTES_PER_S == 900e9 and hw.COLLECTIVE_BYTES_PER_S == 450e9


def test_report_keeps_jax_fields_and_formulas(monkeypatch):
    """Field for field JAX's report; ``analyze``'s three terms over the H100
    rates; ``roofline_fraction`` is JAX's formula on the port's constants."""
    assert [f.name for f in dataclasses.fields(ra.RooflineReport)] == \
        [f.name for f in dataclasses.fields(jax_ra.RooflineReport)]
    rep = ra.analyze(arch="llama3-8b", shape="train_4k", mesh_name="1,4", n_chips=4,
                     model_flops=5.39e16, flops=1.8e16, bytes_accessed=3.1e10,
                     collective_bytes=2.2e12, collectives={"model": 2.2e12},
                     memory_per_device={"param_bytes": 8e9}, extra={"model_bytes": 9.6e10})
    assert rep.compute_term_s == 1.8e16 / hw.PEAK_FLOPS_BF16
    assert rep.memory_term_s == 3.1e10 / hw.HBM_BYTES_PER_S
    assert rep.collective_term_s == 2.2e12 / hw.COLLECTIVE_BYTES_PER_S
    assert rep.bottleneck == "compute"
    assert rep.step_time_bound_s == rep.compute_term_s
    assert rep.useful_ratio == 5.39e16 / (1.8e16 * 4)
    assert json.loads(rep.to_json())["memory_per_device"] == {"param_bytes": 8e9}
    monkeypatch.setattr(jax_hw, "PEAK_FLOPS_BF16", hw.PEAK_FLOPS_BF16)
    monkeypatch.setattr(jax_hw, "HBM_BW", hw.HBM_BYTES_PER_S)
    jrep = jax_ra.RooflineReport(**dataclasses.asdict(rep))
    assert rep.roofline_fraction() == jrep.roofline_fraction()
    assert rep.step_time_bound_s == jrep.step_time_bound_s
