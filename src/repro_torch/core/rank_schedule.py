"""Rank schedules: evaluation and live-state migration, from
``src/repro/core/rank_schedule.py`` (DESIGN.md §2.12).

``configs.base.RankSchedule`` is the data; this module acts on it:

  * ``scheduled_rank`` / ``propose_adaptive_rank`` evaluate the schedule at
    a refresh boundary, on the host, as plain ints: a rank change reshapes
    every bucket stack, so the loop re-buckets there and nowhere else.
  * ``rank_trajectory`` / ``plan_at_rank`` / ``schedule_rank_plans`` give
    the distinct-rank segments of a run and the bucket plan of each.
  * ``migrate_opt_state`` carries live optimizer state across a rank
    change through the canonical per-leaf layout: projectors truncate
    (shrink) or zero-pad (grow); moments slice or zero-extend along their
    rank axis under ``keep`` / ``reproject`` (under truncation reproject's
    carry ``C = P2^T P1 = [I 0]`` is that slice) and re-initialize under
    ``reset``.  8-bit Adam moves at the code level: codes and scales slice
    or extend with the fill codes that dequantize to 0 under any scale
    (127 signed, 0 unsigned) and scale 1.0, so nothing re-quantizes.

The modeled-bytes models, ``scheduled_state_model`` and
``rebucket_cost_model``, need the bucket engine's modeled accounting and
wait for it (ROADMAP queue 1 item 12).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import RankSchedule
from repro_torch.core import buckets as buckets_lib
from repro_torch.core import inner as inner_lib
from repro_torch.core import lowrank as lowrank_lib
from repro_torch.kernels.lowrank_update import quantize as qz

PyTree = Any

_ITEM_12 = "ROADMAP queue 1 item 12"


def parse_rank_schedule(spec: str, **overrides: Any) -> RankSchedule:
    """``"cosine:128:32@0.5"`` -> RankSchedule (``RankSchedule.parse``)."""
    return RankSchedule.parse(spec, **overrides)


# ---------------------------------------------------------------------------
# evaluation (host ints)
# ---------------------------------------------------------------------------


def _quantize_rank(sched: RankSchedule, raw: float) -> int:
    """Snap to the granularity grid, clamp to [floor, start]."""
    q = max(sched.granularity, 1)
    r = int(round(raw / q)) * q
    return max(sched.effective_floor, min(sched.start, max(r, 1)))


def _apply_hysteresis(sched: RankSchedule, proposed: int, current: Optional[int]) -> int:
    if current is None:
        return proposed
    if abs(proposed - current) < sched.effective_hysteresis:
        return current
    return proposed


def _step_levels(sched: RankSchedule) -> List[int]:
    """The halving ladder of kind 'step': start, start/2, ..., floor."""
    levels = [sched.start]
    floor = sched.effective_floor
    while levels[-1] > floor:
        levels.append(max(levels[-1] // 2, floor))
    return levels


def scheduled_rank(sched: RankSchedule, step: int, *, total_steps: Optional[int] = None,
                   current: Optional[int] = None) -> int:
    """The scheduled global rank at ``step``.  ``total_steps`` is the
    horizon where the schedule has none; ``current`` (the rank the engine
    is built at) turns on hysteresis.  ``adaptive`` has no closed form and
    returns ``current`` (or ``start``): drive it with
    ``propose_adaptive_rank``."""
    if sched.kind == "constant":
        return _apply_hysteresis(sched, sched.start, current)
    if sched.kind == "adaptive":
        return current if current is not None else sched.start
    horizon = sched.total_steps or (total_steps or 0)
    if horizon <= 0:
        raise ValueError(
            f"rank schedule kind {sched.kind!r} needs a horizon: set "
            "total_steps on the schedule or pass total_steps="
        )
    window = max(int(round(horizon * sched.decay_fraction)), 1)
    frac = min(max(step, 0), window) / window
    floor = sched.effective_floor
    if sched.kind == "step":
        levels = _step_levels(sched)
        raw = float(levels[min(int(frac * len(levels)), len(levels) - 1)])
    elif sched.kind == "linear":
        raw = sched.start + (floor - sched.start) * frac
    else:  # cosine
        raw = floor + 0.5 * (sched.start - floor) * (1.0 + math.cos(math.pi * frac))
    return _apply_hysteresis(sched, _quantize_rank(sched, raw), current)


def propose_adaptive_rank(sched: RankSchedule, current: Optional[int],
                          effective_rank: float) -> int:
    """The adaptive policy for one group: ``margin`` times the measured
    effective rank of the refresh step's update (``SpectrumLogger``),
    quantized and clamped like every kind, with hysteresis against the
    group's current rank.  A non-finite or non-positive reading proposes no
    change."""
    if not (effective_rank > 0.0) or not math.isfinite(effective_rank):
        return current if current is not None else sched.start
    proposed = _quantize_rank(sched, sched.margin * float(effective_rank))
    return _apply_hysteresis(sched, proposed, current)


def rank_trajectory(sched: RankSchedule, *, total_steps: int,
                    sub_tau: int = 1) -> List[Tuple[int, int]]:
    """Distinct-rank segments ``[(start_step, rank), ...]`` of a run that
    evaluates the schedule every ``sub_tau`` steps, with hysteresis applied
    in turn, as the loop does.  An adaptive schedule is one segment at
    ``start``."""
    if total_steps < 1:
        raise ValueError(f"total_steps must be >= 1, got {total_steps}")
    traj: List[Tuple[int, int]] = []
    current: Optional[int] = None
    for step in range(0, total_steps, max(sub_tau, 1)):
        r = scheduled_rank(sched, step, total_steps=total_steps, current=current)
        if current is None or r != current:
            traj.append((step, r))
            current = r
    return traj


def plan_at_rank(cfg: "lowrank_lib.OptimizerConfig", params_like: PyTree, rank: int,
                 lowrank_filter: Optional[Callable] = None) -> buckets_lib.BucketPlan:
    """The bucket plan ``cfg`` builds at global rank ``rank`` (only the
    leaves' shapes and dtypes are read)."""
    cfg_r = dataclasses.replace(cfg, rank=int(rank), group_ranks=())
    specs = lowrank_lib.build_specs(params_like, cfg_r, lowrank_filter)
    return buckets_lib.build_bucket_plan(
        specs, lowrank_lib.tree_leaves(params_like),
        split_sides=cfg.inner in buckets_lib.SIDE_HOMOGENEOUS_INNERS,
    )


def schedule_rank_plans(cfg: "lowrank_lib.OptimizerConfig", params_like: PyTree,
                        sched: RankSchedule, *, total_steps: int,
                        sub_tau: Optional[int] = None,
                        lowrank_filter: Optional[Callable] = None,
                        ) -> List[Tuple[float, buckets_lib.BucketPlan]]:
    """``[(time_weight, plan), ...]`` over the schedule's distinct ranks,
    highest first; the weights sum to 1."""
    if sub_tau is None:
        sub_tau = max(cfg.tau // max(cfg.refresh_groups, 1), 1)
    traj = rank_trajectory(sched, total_steps=total_steps, sub_tau=sub_tau)
    weights: Dict[int, float] = {}
    for i, (start, rank) in enumerate(traj):
        end = traj[i + 1][0] if i + 1 < len(traj) else total_steps
        weights[rank] = weights.get(rank, 0.0) + (end - start) / total_steps
    return [(w, plan_at_rank(cfg, params_like, r, lowrank_filter))
            for r, w in sorted(weights.items(), reverse=True)]


def scheduled_state_model(*args: Any, **kwargs: Any) -> Dict[str, Any]:
    """The schedule's modeled state bytes: waits for the bucket engine's
    modeled accounting."""
    raise NotImplementedError(
        f"scheduled_state_model needs the modeled accounting of core/buckets.py, "
        f"which is not yet ported to repro_torch ({_ITEM_12})")


def rebucket_cost_model(*args: Any, **kwargs: Any) -> Dict[str, float]:
    """The modeled cost of a re-bucket event: waits for the bucket engine's
    modeled accounting."""
    raise NotImplementedError(
        f"rebucket_cost_model needs the modeled accounting of core/buckets.py, "
        f"which is not yet ported to repro_torch ({_ITEM_12})")


# ---------------------------------------------------------------------------
# live-state migration across a rank change
# ---------------------------------------------------------------------------


def _resize_axis(x: torch.Tensor, axis: int, new: int, fill=0) -> torch.Tensor:
    """Slice (shrink) or pad with ``fill`` (grow) one axis to ``new``."""
    old = x.shape[axis]
    if new == old:
        return x
    if new < old:
        return x.narrow(axis, 0, new).contiguous()
    pad_shape = list(x.shape)
    pad_shape[axis] = new - old
    return torch.cat([x, torch.full(pad_shape, fill, dtype=x.dtype, device=x.device)], dim=axis)


def _migrate_inner_state(st: Any, side: str, r2: int) -> Any:
    """One canonical per-leaf inner state resized along its rank axis:
    left-side moments are (..., r, n) (axis -2), right-side (..., m, r)
    (axis -1); per-row statistics follow their own shapes (adam_mini's v
    is ``m.shape[:-1]``, adafactor's vr and vc the row and column ones).
    8-bit codes resize with the fill codes (127 signed, 0 unsigned) and
    scales with 1.0; on the right side the 256-element blocks run along
    the rank axis, so the scale plane resizes to ``num_blocks(r2)`` and
    every kept element keeps its block and its scale."""
    if isinstance(st, inner_lib.Adam8bitState):
        if side == "left":
            return inner_lib.Adam8bitState(
                m_codes=_resize_axis(st.m_codes, -2, r2, fill=127),
                m_scale=_resize_axis(st.m_scale, -2, r2, fill=1.0),
                v_codes=_resize_axis(st.v_codes, -2, r2, fill=0),
                v_scale=_resize_axis(st.v_scale, -2, r2, fill=1.0),
            )
        nb2 = qz.num_blocks(r2)
        return inner_lib.Adam8bitState(
            m_codes=_resize_axis(st.m_codes, -1, r2, fill=127),
            m_scale=_resize_axis(st.m_scale, -1, nb2, fill=1.0),
            v_codes=_resize_axis(st.v_codes, -1, r2, fill=0),
            v_scale=_resize_axis(st.v_scale, -1, nb2, fill=1.0),
        )
    ax = -2 if side == "left" else -1
    if isinstance(st, inner_lib.AdamState):
        return inner_lib.AdamState(m=_resize_axis(st.m, ax, r2), v=_resize_axis(st.v, ax, r2))
    if isinstance(st, inner_lib.MSGDState):
        return inner_lib.MSGDState(m=_resize_axis(st.m, ax, r2))
    if isinstance(st, inner_lib.AdamMiniState):
        if side == "left":  # v: one scalar per R-space basis row
            return inner_lib.AdamMiniState(m=_resize_axis(st.m, -2, r2),
                                           v=_resize_axis(st.v, -1, r2))
        return inner_lib.AdamMiniState(m=_resize_axis(st.m, -1, r2), v=st.v)
    if isinstance(st, inner_lib.AdafactorState):
        if side == "left":
            return inner_lib.AdafactorState(m=_resize_axis(st.m, -2, r2),
                                            vr=_resize_axis(st.vr, -1, r2), vc=st.vc, v=st.v)
        return inner_lib.AdafactorState(m=_resize_axis(st.m, -1, r2), vr=st.vr,
                                        vc=_resize_axis(st.vc, -1, r2), v=st.v)
    raise TypeError(f"don't know how to migrate inner state {type(st).__name__} across "
                    "a rank change")


def _moment_shape(st: Any) -> Tuple[int, ...]:
    if isinstance(st, inner_lib.Adam8bitState):
        return tuple(st.m_codes.shape)
    return tuple(st.m.shape)


def migrate_opt_state(old_opt: "lowrank_lib.LowRankOptimizer",
                      new_opt: "lowrank_lib.LowRankOptimizer",
                      state: "lowrank_lib.LowRankOptState") -> "lowrank_lib.LowRankOptState":
    """Carry live optimizer state from ``old_opt``'s ranks to ``new_opt``'s
    (``src/repro/core/rank_schedule.py:409``): canonical layout, a per-leaf
    resize (module docstring), then ``new_opt``'s storage layout.  The step
    and the draw source pass through, so the refresh draws go on as
    before.  Both optimizers share one param tree and low-rank plan
    (``rebuild_at_rank`` makes sure of it)."""
    cfg = new_opt.config
    inner = cfg.make_inner()
    canon = lowrank_lib.canonical_opt_state(old_opt, state)
    out = []
    for old_spec, new_spec, st in zip(old_opt.specs, new_opt.specs, canon.leaves):
        if old_spec.lowrank != new_spec.lowrank:
            raise ValueError(
                f"leaf {old_spec.path!r} changed lowrank-ness across the rebuild; "
                "rebuild_at_rank must keep the lowrank filter")
        if not old_spec.lowrank or old_spec.rank == new_spec.rank:
            out.append(st)
            continue
        r2 = new_spec.rank
        proj = _resize_axis(st.projector, -1, r2, fill=0)
        if cfg.momentum_carry == "reset":
            rshape = _moment_shape(_migrate_inner_state(st.inner, new_spec.side, r2))
            inner_state = inner.init(torch.zeros(rshape, dtype=torch.float32,
                                                 device=proj.device))
        else:
            inner_state = _migrate_inner_state(st.inner, new_spec.side, r2)
        out.append(lowrank_lib.LeafState(projector=proj, inner=inner_state))
    migrated = lowrank_lib.LowRankOptState(step=canon.step, draws=canon.draws, leaves=out,
                                           buckets=())
    return lowrank_lib.storage_opt_state(new_opt, migrated)
