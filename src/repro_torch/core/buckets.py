"""The bucketed update engine and its state layout, from
``src/repro/core/buckets.py`` (DESIGN.md §2.3, §2.5, §2.6).

  * ``build_bucket_plan`` groups the low-rank leaves by canonical
    (d, n, rank, dtype); side='right' leaves enter transposed, so a (96, 32)
    down-projection and a (32, 96) up-projection share a bucket;
  * ``build_state_layout`` makes the per-bucket stacks the storage: the
    moments (B, r, n) and projectors (B, d, r) of covered leaves live in
    ``BucketState`` buffers, not per leaf;
  * ``bucketed_update`` runs each bucket's hot step as two calls, the
    batched projection R = P^T G and the inner's fused update (Adam, MSGD,
    Adam-mini or 8-bit Adam) that writes W' (``kernels/lowrank_update/
    ops.py``: the CUDA kernels on the card, the plain versions on the CPU);
  * ``bucketed_refresh`` refreshes all same-group entries of a bucket as
    one batched chain (the SVD-free methods, and the randomized SVD), or
    leaf by leaf (exact SVD).

Draws are inputs: each refreshed leaf asks the state's draw source for its
sketch, Gumbel noise or basis by its global leaf index, as the JAX key
chain folds the leaf index (``buckets.py:850-861``).  ZeRO padding and the
modeled accounting are not ported (ROADMAP queue 1 items 11 and 12).
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core import inner as inner_lib
from repro_torch.core.projectors import LeafDraws, draw_shapes
from repro_torch.kernels.lowrank_update import ops as update_ops
from repro_torch.kernels.lowrank_update import quantize as qz

# Inner optimizers with a fused update (kernels/lowrank_update).
FUSED_INNERS = ("adam", "msgd", "adam8bit", "adam_mini")

# Inners whose state layout follows the per-leaf rows (adam_mini's per-row
# v, adam8bit's per-row-chunk scales), which a bucket mixing left and right
# leaves cannot stack into one buffer: their plans split by side.
SIDE_HOMOGENEOUS_INNERS = ("adam8bit", "adam_mini")


class BucketEntry(NamedTuple):
    """One low-rank leaf's slot inside a bucket (static)."""

    leaf_idx: int  # index into the flattened spec/param lists
    side: str  # 'left' | 'right' (right enters the stack transposed)
    batch: int  # stacked slices contributed (prod of leading dims, >= 1)


class Bucket(NamedTuple):
    """Leaves sharing canonical oriented dims: one fused call."""

    d: int  # projected dim (= min(m, n) of every member)
    n: int  # free dim after orientation
    rank: int
    entries: Tuple[BucketEntry, ...]
    # 'left' | 'right' in a side-split plan; 'any' where sides may mix
    side: str = "any"

    @property
    def batch(self) -> int:
        return sum(e.batch for e in self.entries)


class BucketPlan(NamedTuple):
    buckets: Tuple[Bucket, ...]
    bucketed: frozenset  # leaf indices the buckets cover


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]


def build_bucket_plan(flat_specs: Sequence, flat_params: Sequence, *,
                      split_sides: bool = False) -> BucketPlan:
    """Static bucketing: group low-rank leaves by (d, n, rank, dtype), in the
    sorted key order of the JAX plan.  The rank is clamped to d here.
    ``split_sides`` adds the side to the key and stamps it on the bucket
    (``SIDE_HOMOGENEOUS_INNERS``)."""
    groups: Dict[Tuple, List[BucketEntry]] = {}
    for i, (spec, leaf) in enumerate(zip(flat_specs, flat_params)):
        if not spec.lowrank:
            continue
        m, n = leaf.shape[-2], leaf.shape[-1]
        d_c, n_c = (m, n) if spec.side == "left" else (n, m)
        if spec.rank < 1:
            raise ValueError(
                f"bucket plan: leaf {i} ({spec.path!r}, shape "
                f"{tuple(leaf.shape)}) has rank {spec.rank}; rank must be "
                ">= 1 for every low-rank leaf"
            )
        b = 1
        for s in leaf.shape[:-2]:
            b *= s
        key = (d_c, n_c, min(spec.rank, d_c), _dtype_name(leaf.dtype))
        if split_sides:
            key = key + (spec.side,)
        groups.setdefault(key, []).append(BucketEntry(i, spec.side, b))
    buckets = tuple(
        Bucket(d=k[0], n=k[1], rank=k[2], entries=tuple(es),
               side=k[4] if split_sides else "any")
        for k, es in sorted(groups.items(), key=lambda kv: kv[0])
    )
    covered = frozenset(e.leaf_idx for bk in buckets for e in bk.entries)
    return BucketPlan(buckets=buckets, bucketed=covered)


# ---------------------------------------------------------------------------
# storage layout: bucket-native optimizer state
# ---------------------------------------------------------------------------


class BucketState(NamedTuple):
    """One bucket's optimizer state, stacked.  ``projector`` is (B, d, r) in
    canonical orientation for both sides; moments are (B, r, n) in the
    canonical 'left' orientation (side='right' slices enter transposed):

      adam       m, v (B, r, n) f32
      msgd       m (B, r, n) f32; v is None
      adam_mini  m (B, r, n) f32; v the per-row second moment, (B, r) for
                 'left' buckets, (B, n) for 'right' ones (per-leaf rows)
      adam8bit   m, v (B, r, n) uint8 codes, element-aligned with the stack;
                 ``m_scale``/``v_scale`` the f32 per-row-chunk scales in
                 per-leaf row order, (B, r, nb) 'left', (B, n, nb_r) 'right'

    ``m_scale``/``v_scale`` are None for the unquantized inners."""

    projector: torch.Tensor
    m: torch.Tensor
    v: Optional[torch.Tensor]
    m_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


class _Like(NamedTuple):
    """A shape and dtype, where no tensor is at hand."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


class LeafStateTemplate(NamedTuple):
    """Per-leaf canonical shapes and dtypes (static): what the per-leaf
    layout stores."""

    projector: _Like
    m: _Like
    v: Optional[_Like]
    m_scale: Optional[_Like] = None
    v_scale: Optional[_Like] = None


class StateLayout(NamedTuple):
    plan: BucketPlan
    inner_name: str  # 'adam' | 'msgd' | 'adam_mini' | 'adam8bit'
    has_v: bool
    templates: Dict[int, LeafStateTemplate]  # keyed by leaf_idx
    projector_dtype: torch.dtype = torch.float32


def build_state_layout(
    plan: BucketPlan,
    flat_specs: Sequence,
    flat_params: Sequence,
    *,
    inner_name: str,
    projector_dtype=torch.float32,
) -> StateLayout:
    """Canonical per-leaf templates for every bucketed leaf."""
    del flat_specs
    has_v = inner_lib.fused_has_second_moment(inner_name)
    if inner_name in SIDE_HOMOGENEOUS_INNERS:
        for bucket in plan.buckets:
            if bucket.side not in ("left", "right"):
                raise ValueError(
                    f"{inner_name!r} needs a side-homogeneous bucket plan "
                    "(build_bucket_plan(split_sides=True))"
                )
    f32 = torch.float32
    templates: Dict[int, LeafStateTemplate] = {}
    for bucket in plan.buckets:
        for e in bucket.entries:
            shape = tuple(flat_params[e.leaf_idx].shape)
            lead = shape[:-2]
            if e.side == "left":
                mshape = lead + (bucket.rank, shape[-1])
            else:
                mshape = lead + (shape[-2], bucket.rank)
            proj = _Like(lead + (bucket.d, bucket.rank), projector_dtype)
            m_scale = None
            if inner_name == "adam8bit":
                m = _Like(mshape, torch.uint8)
                m_scale = _Like(mshape[:-1] + (qz.num_blocks(mshape[-1]),), f32)
                v = m
            elif inner_name == "adam_mini":
                m = _Like(mshape, f32)
                v = _Like(mshape[:-1], f32)
            else:
                m = _Like(mshape, f32)
                v = m if has_v else None
            templates[e.leaf_idx] = LeafStateTemplate(proj, m, v, m_scale, m_scale)
    return StateLayout(plan, inner_name, has_v, templates, projector_dtype)


def init_bucket_states(layout: StateLayout, device) -> Tuple[BucketState, ...]:
    """Eye projectors (the first refresh installs the real ones) and zero
    moments, stacked (quantized zeros for adam8bit: the codes and scales
    of ``inner.adam8bit().init``)."""
    out = []
    for bucket in layout.plan.buckets:
        B, d, n, r = bucket.batch, bucket.d, bucket.n, bucket.rank
        eye = torch.eye(d, r, dtype=layout.projector_dtype, device=device)
        proj = eye.expand(B, d, r).clone()
        z = torch.zeros((B, r, n), dtype=torch.float32, device=device)
        if layout.inner_name == "adam8bit":
            mc, ms = qz.quantize_stacked(z, bucket.side, signed=True)
            vc, vs = qz.quantize_stacked(z, bucket.side, signed=False)
            out.append(BucketState(proj, mc, vc, ms, vs))
            continue
        if layout.inner_name == "adam_mini":
            rows = r if bucket.side == "left" else n
            v = torch.zeros((B, rows), dtype=torch.float32, device=device)
        else:
            v = torch.zeros_like(z) if layout.has_v else None
        out.append(BucketState(projector=proj, m=z, v=v))
    return tuple(out)


# ---------------------------------------------------------------------------
# stack / unstack
# ---------------------------------------------------------------------------


def _orient_in(x: torch.Tensor, side: str) -> torch.Tensor:
    """Leaf -> (b, a, b') canonical stack slices (side='right' transposed)."""
    x2 = x.reshape((-1,) + tuple(x.shape[-2:]))
    return x2.transpose(-1, -2) if side == "right" else x2


def _gather(bucket: Bucket, leaves) -> torch.Tensor:
    """Contiguous (B, d, n) stack of the bucket's leaves (``leaves`` is
    anything indexable by leaf_idx)."""
    parts = [_orient_in(leaves[e.leaf_idx], e.side) for e in bucket.entries]
    return parts[0].contiguous() if len(parts) == 1 else torch.cat(parts, dim=0)


def _gather_plain(bucket: Bucket, leaves, trailing: int) -> torch.Tensor:
    """Plain (never transposed) stack of buffers with ``trailing`` trailing
    dims: projectors and scales (2), adam_mini's per-row v (1)."""
    parts = []
    for e in bucket.entries:
        x = leaves[e.leaf_idx]
        parts.append(x.reshape((-1,) + tuple(x.shape[x.dim() - trailing:])))
    return parts[0].contiguous() if len(parts) == 1 else torch.cat(parts, dim=0)


def _scatter(bucket: Bucket, stacked: torch.Tensor, likes) -> Dict[int, torch.Tensor]:
    """Split a (B, ...) result into per-leaf tensors shaped like
    ``likes[leaf_idx]`` (orientation and dtype restored)."""
    out: Dict[int, torch.Tensor] = {}
    off = 0
    for e in bucket.entries:
        part = stacked[off:off + e.batch]
        off += e.batch
        if e.side == "right":
            part = part.transpose(-1, -2)
        like = likes[e.leaf_idx]
        out[e.leaf_idx] = part.reshape(like.shape).to(like.dtype)
    return out


def _scatter_proj(bucket: Bucket, stacked: torch.Tensor, likes) -> Dict[int, torch.Tensor]:
    """Split a plain (never transposed) stack per leaf: projectors, scales
    and adam_mini's per-row v (``reshape`` restores any trailing rank)."""
    out: Dict[int, torch.Tensor] = {}
    off = 0
    for e in bucket.entries:
        like = likes[e.leaf_idx]
        out[e.leaf_idx] = stacked[off:off + e.batch].reshape(like.shape).to(like.dtype)
        off += e.batch
    return out


def leaf_states_to_bucketed(
    layout: StateLayout, flat_states: Sequence
) -> Tuple[BucketState, ...]:
    """Per-leaf canonical -> storage: ``flat_states`` holds objects with
    ``.projector`` and ``.inner`` at the bucketed indices.  Reshapes,
    transposes and concatenations only: codes transpose like moments,
    scales and per-row v stack in per-leaf row order, and nothing is
    requantized."""
    out = []
    for bucket in layout.plan.buckets:
        proj = _gather_plain(bucket, {e.leaf_idx: flat_states[e.leaf_idx].projector
                                      for e in bucket.entries}, 2)
        fm = {e.leaf_idx: inner_lib.fused_moments(layout.inner_name,
                                                  flat_states[e.leaf_idx].inner)
              for e in bucket.entries}
        m = _gather(bucket, {i: x.m for i, x in fm.items()})
        v = m_scale = v_scale = None
        if layout.inner_name == "adam8bit":
            v = _gather(bucket, {i: x.v for i, x in fm.items()})
            m_scale = _gather_plain(bucket, {i: x.m_scale for i, x in fm.items()}, 2)
            v_scale = _gather_plain(bucket, {i: x.v_scale for i, x in fm.items()}, 2)
        elif layout.inner_name == "adam_mini":
            v = _gather_plain(bucket, {i: x.v for i, x in fm.items()}, 1)
        elif layout.has_v:
            v = _gather(bucket, {i: x.v for i, x in fm.items()})
        out.append(BucketState(proj, m, v, m_scale, v_scale))
    return tuple(out)


def bucketed_to_leaf_states(
    layout: StateLayout, bucket_states: Sequence[BucketState]
) -> Dict[int, Tuple[torch.Tensor, Any]]:
    """Storage -> per-leaf canonical: {leaf_idx: (projector, inner_state)}.
    The inverse of ``leaf_states_to_bucketed`` (no arithmetic)."""
    out: Dict[int, Tuple[torch.Tensor, Any]] = {}
    for bucket, bst in zip(layout.plan.buckets, bucket_states):
        tm = {e.leaf_idx: layout.templates[e.leaf_idx] for e in bucket.entries}
        projs = _scatter_proj(bucket, bst.projector, {i: t.projector for i, t in tm.items()})
        ms = _scatter(bucket, bst.m, {i: t.m for i, t in tm.items()})
        vs = mss = vss = None
        if layout.inner_name == "adam8bit":
            vs = _scatter(bucket, bst.v, {i: t.v for i, t in tm.items()})
            mss = _scatter_proj(bucket, bst.m_scale, {i: t.m_scale for i, t in tm.items()})
            vss = _scatter_proj(bucket, bst.v_scale, {i: t.v_scale for i, t in tm.items()})
        elif layout.inner_name == "adam_mini":
            vs = _scatter_proj(bucket, bst.v, {i: t.v for i, t in tm.items()})
        elif bst.v is not None:
            vs = _scatter(bucket, bst.v, {i: t.v for i, t in tm.items()})
        for e in bucket.entries:
            i = e.leaf_idx
            out[i] = (projs[i], inner_lib.fused_state(
                layout.inner_name, ms[i], *(x[i] if x is not None else None
                                            for x in (vs, mss, vss))))
    return out


def leaf_projectors(
    layout: StateLayout, bucket_states: Sequence[BucketState]
) -> Dict[int, torch.Tensor]:
    """Per-leaf projector views sliced out of the stacks (no transpose:
    projectors are canonical (d, r) for both sides)."""
    out: Dict[int, torch.Tensor] = {}
    for bucket, bst in zip(layout.plan.buckets, bucket_states):
        out.update(_scatter_proj(
            bucket, bst.projector,
            {e.leaf_idx: layout.templates[e.leaf_idx].projector for e in bucket.entries},
        ))
    return out


def all_finite(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """One device bool: every element of every tensor finite.  Each tensor
    is read once, by one min/max reduction (NaN propagates into both,
    +-inf into one), without an element-sized temporary."""
    return torch.isfinite(torch.stack([torch.stack(torch.aminmax(x)) for x in leaves])).all()


def bucketed_all_finite(plan: BucketPlan, flat_grads: Sequence[torch.Tensor]
                        ) -> List[torch.Tensor]:
    """Per-bucket device bool ``all(isfinite(stack))``, JAX's skip-step
    check (``src/repro/core/buckets.py:709``), reading the bucket's leaves
    where they lie, so no stack is built for it.  The port's gate does
    not split its check by bucket: ``all_finite`` over every gradient
    gives the same verdict.  (JAX's ``stacked_grads`` form serves the
    compressed step, ROADMAP queue 1 item 11.)"""
    return [all_finite([flat_grads[e.leaf_idx] for e in bucket.entries])
            for bucket in plan.buckets]


# ---------------------------------------------------------------------------
# the fused hot-path update (bucket-native state)
# ---------------------------------------------------------------------------


def bucketed_update(
    plan: BucketPlan,
    cfg,  # OptimizerConfig
    bucket_states: Sequence[BucketState],
    flat_grads: Sequence[torch.Tensor],
    flat_params: Sequence[torch.Tensor],
    step: int,
    lr: float,
    *,
    apply: bool,
) -> Tuple[Dict[int, torch.Tensor], Tuple[BucketState, ...], List[torch.Tensor]]:
    """Run every bucket against its storage-layout state.  Returns
    ({leaf_idx: new param (apply) or update}, new bucket states,
    per-bucket squared update norms)."""
    lr_alpha = lr * cfg.alpha
    lr_wd = lr * cfg.weight_decay if cfg.weight_decay else 0.0
    ik = cfg.inner_kwargs()
    out_leaves: Dict[int, torch.Tensor] = {}
    new_states: List[BucketState] = []
    norm_sq: List[torch.Tensor] = []
    for bucket, bst in zip(plan.buckets, bucket_states):
        w = _gather(bucket, flat_params)
        p = bst.projector
        r_g = update_ops.bucketed_project(_gather(bucket, flat_grads), p)
        if cfg.inner == "msgd":
            w_new, m_new = update_ops.bucketed_msgd_update(
                w, p, r_g, bst.m, lr_alpha, lr_wd, **ik
            )
            new_bst = BucketState(projector=p, m=m_new, v=None)
        elif cfg.inner == "adam_mini":
            w_new, m_new, v_new = update_ops.bucketed_adam_mini_update(
                w, p, r_g, bst.m, bst.v, step, lr_alpha, lr_wd, side=bucket.side, **ik
            )
            new_bst = BucketState(projector=p, m=m_new, v=v_new)
        elif cfg.inner == "adam8bit":
            w_new, mc, ms, vc, vs = update_ops.bucketed_adam8bit_update(
                w, p, r_g, bst.m, bst.m_scale, bst.v, bst.v_scale, step,
                lr_alpha, lr_wd, side=bucket.side, **ik,
            )
            new_bst = BucketState(projector=p, m=mc, v=vc, m_scale=ms, v_scale=vs)
        else:
            w_new, m_new, v_new = update_ops.bucketed_adam_update(
                w, p, r_g, bst.m, bst.v, step, lr_alpha, lr_wd, **ik
            )
            new_bst = BucketState(projector=p, m=m_new, v=v_new)
        del r_g
        # |W' - W|^2 over slices of 64: a stack-wide difference would be one
        # more full-size f32 transient (8.9 GB for deepseek's expert bucket)
        norm_sq.append(torch.stack([
            torch.sum((a.float() - b.float()).square_())
            for a, b in zip(w_new.split(64), w.split(64))]).sum())
        out = w_new if apply else w_new - w
        del w, w_new
        out_leaves.update(_scatter(bucket, out, flat_params))
        new_states.append(new_bst)
    return out_leaves, tuple(new_states), norm_sq


# ---------------------------------------------------------------------------
# the refresh path on stacked operands
# ---------------------------------------------------------------------------


def entry_draws(draws, entry: BucketEntry, template: LeafStateTemplate,
                bucket: Bucket, pcfg, device) -> LeafDraws:
    """One entry's refresh draws from the state's draw source, keyed by its
    global leaf index; a leaf with leading dims draws one per slice."""
    return draws.leaf(entry.leaf_idx, tuple(template.projector.shape[:-2]),
                      draw_shapes(bucket.d, bucket.n, pcfg, bucket.rank), device)


def _cat(parts: List[Optional[torch.Tensor]]) -> Optional[torch.Tensor]:
    return None if parts[0] is None else torch.cat(parts, dim=0)


def _overlap_per_slice(new: torch.Tensor, old: torch.Tensor, rank: int) -> torch.Tensor:
    """||P_new^T P_old||_F^2 / r per slice (the GARD18 overlap diagnostic)."""
    c = torch.einsum("bdn,bdo->bno", new, old)
    return torch.sum(c.float() ** 2, dim=(-2, -1)) / rank


def bucketed_refresh(
    layout: StateLayout,
    bucket_states: Sequence[BucketState],
    flat_specs: Sequence,
    flat_grads: Sequence[torch.Tensor],
    draws,
    pcfg,  # ProjectorConfig
    refresh_fn,  # (g, leaf_draws, old_p, spec) -> new per-leaf projector
    *,
    group: int,
    momentum_carry: str,
    stacked_refresh_fn=None,  # (g_stack, draws, old_p_stack, rank) -> stack
) -> Tuple[Tuple[BucketState, ...], List[torch.Tensor]]:
    """Refresh the projectors of one refresh ``group`` in the bucket stacks.

    With ``stacked_refresh_fn`` (``projectors.batched_refresh_supported``:
    the SVD-free methods, and the randomized backend) all of a bucket's
    same-group entries refresh as one batched chain over their stacked
    (B', d, n) gradients; otherwise (the exact backend) entry by entry with
    ``refresh_fn``.  ``momentum_carry="reproject"`` runs as one batched
    r x r product per bucket (not for adam8bit, whose first moment is
    codes: as in JAX, it is kept); "reset" zeroes the refreshed slices'
    whole inner state, adam8bit's codes and scales included (scales 0,
    which dequantize to 0 like the quantized zeros of init).
    Returns (new bucket states, per-leaf overlap diagnostics)."""
    new_states: List[BucketState] = []
    overlaps: List[torch.Tensor] = []
    for bucket, bst in zip(layout.plan.buckets, bucket_states):
        device = bst.projector.device
        hot = [e for e in bucket.entries if flat_specs[e.leaf_idx].group == group]
        new_slices: Dict[int, torch.Tensor] = {}
        if hot and stacked_refresh_fn is not None:
            g_stack = _gather(bucket._replace(entries=tuple(hot)), flat_grads)
            old_stack = _slice_entries(bucket, bst.projector, hot)
            per = [entry_draws(draws, e, layout.templates[e.leaf_idx], bucket, pcfg, device)
                   for e in hot]
            stacked = LeafDraws(*(_cat(list(parts)) for parts in zip(*per)))
            new_stack = stacked_refresh_fn(g_stack, stacked, old_stack, bucket.rank)
            new_stack = new_stack.to(bst.projector.dtype)
            del g_stack
            vals = _overlap_per_slice(new_stack, old_stack, bucket.rank)
            off = 0
            for e in hot:
                overlaps.append(torch.mean(vals[off:off + e.batch]))
                new_slices[e.leaf_idx] = new_stack[off:off + e.batch]
                off += e.batch
        elif hot:
            off = 0
            for e in bucket.entries:
                old_slice = bst.projector[off:off + e.batch]
                off += e.batch
                if flat_specs[e.leaf_idx].group != group:
                    continue
                tmpl = layout.templates[e.leaf_idx]
                new_p = refresh_fn(
                    flat_grads[e.leaf_idx],
                    entry_draws(draws, e, tmpl, bucket, pcfg, device),
                    old_slice.reshape(tmpl.projector.shape),
                    flat_specs[e.leaf_idx],
                ).reshape(old_slice.shape).to(bst.projector.dtype)
                overlaps.append(torch.mean(
                    _overlap_per_slice(new_p, old_slice, bucket.rank)))
                new_slices[e.leaf_idx] = new_p
        parts, refreshed, off = [], [], 0
        for e in bucket.entries:
            old_slice = bst.projector[off:off + e.batch]
            off += e.batch
            parts.append(new_slices.get(e.leaf_idx, old_slice))
            refreshed.append(e.leaf_idx in new_slices)
        new_proj = parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)

        m, v, ms_, vs_ = bst.m, bst.v, bst.m_scale, bst.v_scale
        if any(refreshed):
            if momentum_carry == "reset":
                m, v, ms_, vs_ = (
                    None if x is None
                    else _select_slices(bucket, refreshed, torch.zeros_like(x), x)
                    for x in (m, v, ms_, vs_)
                )
            elif momentum_carry == "reproject" and layout.inner_name != "adam8bit":
                # C = P_new^T P_old per slice, then M' = C M; in canonical
                # orientation one formula covers both sides.
                c = torch.einsum("bdn,bdo->bno", new_proj, bst.projector)
                m2 = torch.einsum("bno,bok->bnk", c, m).to(m.dtype)
                m = _select_slices(bucket, refreshed, m2, m)
        new_states.append(BucketState(new_proj, m, v, ms_, vs_))
    return tuple(new_states), overlaps


def _slice_entries(
    bucket: Bucket, stacked: torch.Tensor, entries: Sequence[BucketEntry]
) -> torch.Tensor:
    """Concatenated stack slices of an entry subset (in bucket order)."""
    want = frozenset(e.leaf_idx for e in entries)
    parts = []
    off = 0
    for e in bucket.entries:
        if e.leaf_idx in want:
            parts.append(stacked[off:off + e.batch])
        off += e.batch
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


def _select_slices(
    bucket: Bucket, take_new: Sequence[bool], new: torch.Tensor, old: torch.Tensor
) -> torch.Tensor:
    """Static per-entry selection between two stacked buffers."""
    if all(take_new):
        return new
    parts = []
    off = 0
    for e, t in zip(bucket.entries, take_new):
        parts.append((new if t else old)[off:off + e.batch])
        off += e.batch
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
