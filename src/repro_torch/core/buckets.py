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
chain folds the leaf index (``buckets.py:850-861``).

The data-parallel step (``train/step.py``) reduces the gradients in this
layout: ``bucketed_project_grads`` (one f32 (B, r, n) R stack per bucket,
the hot step's payload) and ``bucketed_stack_grads`` (one (B, d, n) stack,
the refresh's), which ``bucketed_update`` and ``bucketed_refresh`` take
as ``stacked_grads``.  ``state_sharding="zero"`` pads every stack to a
multiple of the shard count with inert zero rows (the ``zero_*``
helpers), so each process owns one block of rows.

Under tensor parallelism (``core/lowrank.tensor_parallel_optimizer``) a
bucket holds this process's blocks of its leaves, and ``Bucket.split``
says which canonical dim of them is split over ``model``: "n" (the free
dim: R = P^T G is this process's columns of R, the projector whole),
"d" (the projected dim: R is a partial sum, all-reduced over ``model``
before the update, the projector this process's rows of it, the moments
whole), "b" (a stack dim, the experts: each process its own slices) or
"" (a whole leaf).  The plan keys on it, so a bucket is one kind.  The
refresh of a "d" bucket gathers its gradient and projector stacks over
``model`` and refreshes redundantly; an "n" bucket under the randomized
SVD takes the sketch route (``svd.randomized_svd_stacked(split=)``: the
kernel on the local block, its products summed over ``model``), and
gathers under the other methods.

FSDP over ``data`` (the standard step at a ``data`` extent above 1)
cuts the leaves the same way on a second axis: ``Bucket.dsplit`` is the
canonical dim split over ``data`` ("d", "n" or ""; the rules never split
a stack dim over it), and a bucket may be cut on both axes, on a
different dim by each.  A "d" bucket over ``data`` sums its partial R
over ``data``; a refresh gathers over ``data`` where the bucket is "d"
there, and takes the sketch route over ``data`` where it is "n" (then
over ``model`` a "d" bucket gathers first).  Where an axis cuts a 'left'
bucket's n, Adam-mini's row sums and 8-bit Adam's 256-element row chunks
span processes (``_cut_kwargs``); ZeRO state on the FSDP step keeps rows
of the moments (``StateLayout.zero_rows``, ``bucketed_update``'s split
schedule).

The modeled accounting is the reference's, on the host, from the plan's
shapes alone: ``modeled_hbm_bytes`` / ``update_num_ops`` /
``reference_num_ops`` (a hot step of either engine),
``finite_check_model`` (the skip-step gate), ``refresh_num_ops`` /
``modeled_refresh_hbm_bytes`` (a randomized refresh),
``modeled_state_bytes`` (the resident state), ``sharded_ckpt_model``
(one checkpoint writer) and ``dp_comm_model`` (the data-parallel
collectives' bytes).  ``launch/dryrun.py`` records them per cell.
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
    # tensor parallelism (module docstring): the canonical dim split over
    # ``model`` ("d", "n", "b" or "") and the ``model`` extent
    split: str = ""
    tp: int = 1
    # a "b" bucket's leaves' leading dim split over ``model`` (the experts)
    lead_split: int = -1
    # FSDP: the canonical dim split over ``data`` ("d", "n" or "") and the
    # ``data`` extent
    dsplit: str = ""
    dp: int = 1
    # the global column of this process's first canonical column where an
    # axis cuts n (0 otherwise): where 8-bit Adam's row chunks fall
    n0: int = 0

    @property
    def batch(self) -> int:
        return sum(e.batch for e in self.entries)

    def global_dims(self) -> Tuple[int, int]:
        """(d, n) of the global leaves the blocks are cut from."""
        d, n = self.d, self.n
        for kind, size in ((self.split, self.tp), (self.dsplit, self.dp)):
            d, n = (d * size, n) if kind == "d" else (d, n * size) if kind == "n" else (d, n)
        return d, n

    def n_axes(self, tp_axes=None, fsdp_axes=None):
        """The axes that cut the canonical n, or None."""
        return next((ax for kind, ax in self.cuts(tp_axes, fsdp_axes) if kind == "n"), None)

    def cuts(self, tp_axes=None, fsdp_axes=None) -> List[Tuple[str, Any]]:
        """(kind, axes) of each axis that cuts a canonical dim of the
        bucket's leaves ("d" or "n"), ``data`` first; an axis given as None
        is left out."""
        out = []
        for kind, ax in ((self.dsplit, fsdp_axes), (self.split, tp_axes)):
            if ax is not None and kind in ("d", "n"):
                out.append((kind, ax))
        return out


class BucketPlan(NamedTuple):
    buckets: Tuple[Bucket, ...]
    bucketed: frozenset  # leaf indices the buckets cover


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]


def tp_kind(side: str, split: Optional[int], ndim: int) -> str:
    """The canonical dim a leaf's ``model`` split falls on (``Bucket.split``)
    from its side and the split dim of its global shape (None: whole)."""
    if split is None:
        return ""
    if split < ndim - 2:
        return "b"
    left_rows = split == ndim - 2
    return "d" if left_rows == (side == "left") else "n"


def build_bucket_plan(flat_specs: Sequence, flat_params: Sequence, *,
                      split_sides: bool = False, tp_splits: Optional[Sequence] = None,
                      tp: int = 1, dp_splits: Optional[Sequence] = None,
                      dp: int = 1, tp_index: int = 0, dp_index: int = 0) -> BucketPlan:
    """Static bucketing: group low-rank leaves by (d, n, rank, dtype), in the
    sorted key order of the JAX plan.  The rank is clamped to d here.
    ``split_sides`` adds the side to the key and stamps it on the bucket
    (``SIDE_HOMOGENEOUS_INNERS``).  Under tensor parallelism
    ``flat_params`` are this process's blocks, ``tp_splits`` the dim each
    global leaf splits over a ``model`` axis of ``tp`` (None: whole), the
    specs (side, rank) the global leaves'; the kind of split
    (``tp_kind``) joins the key, and the rank clamps to the global d.
    ``dp_splits`` / ``dp`` are the same over ``data`` (FSDP); ``tp_index``
    / ``dp_index`` are this process's places on the axes, which give
    ``Bucket.n0``."""
    groups: Dict[Tuple, List[BucketEntry]] = {}
    for i, (spec, leaf) in enumerate(zip(flat_specs, flat_params)):
        if not spec.lowrank:
            continue
        m, n = leaf.shape[-2], leaf.shape[-1]
        d_c, n_c = (m, n) if spec.side == "left" else (n, m)
        split = tp_splits[i] if tp_splits is not None and tp > 1 else None
        kind = tp_kind(spec.side, split, len(leaf.shape))
        dkind = tp_kind(spec.side, dp_splits[i] if dp_splits is not None and dp > 1 else None,
                        len(leaf.shape))
        if spec.rank < 1:
            raise ValueError(
                f"bucket plan: leaf {i} ({spec.path!r}, shape "
                f"{tuple(leaf.shape)}) has rank {spec.rank}; rank must be "
                ">= 1 for every low-rank leaf"
            )
        b = 1
        for s in leaf.shape[:-2]:
            b *= s
        gd = d_c * (tp if kind == "d" else 1) * (dp if dkind == "d" else 1)
        key = (d_c, n_c, min(spec.rank, gd), _dtype_name(leaf.dtype))
        if split_sides:
            key = key + (spec.side,)
        if kind or dkind:
            key = key + ("tp", kind, dkind, split if kind == "b" else -1)
        groups.setdefault(key, []).append(BucketEntry(i, spec.side, b))
    buckets = tuple(
        Bucket(d=k[0], n=k[1], rank=k[2], entries=tuple(es),
               side=k[4] if split_sides else "any",
               split=k[-3] if "tp" in k else "", tp=tp if "tp" in k and k[-3] else 1,
               lead_split=k[-1] if "tp" in k else -1,
               dsplit=k[-2] if "tp" in k else "", dp=dp if "tp" in k and k[-2] else 1,
               n0=k[1] * (tp_index if "tp" in k and k[-3] == "n" else
                          dp_index if "tp" in k and k[-2] == "n" else 0))
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
    """The state's bucket-native layout.  ``shards > 1`` is the ZeRO layout
    (``state_sharding="zero"``): every stack is padded along its leading B
    to a multiple of ``shards`` with inert zero rows, so each process can
    own ``B_pad / shards`` contiguous rows.  Checkpoints of the canonical
    format hold the unpadded per-leaf layout.

    ``zero_rows`` (ZeRO state on the FSDP step, per bucket; empty for the
    compressed steps, where every buffer of every bucket takes rows): the
    buckets whose moments take rows of B over ``data`` -- those whose R is
    whole over ``data`` once reduced ("d" over ``data``: the partial R is
    reduce-scattered; "": the R of a leaf whole over ``data``).  A bucket
    ``data`` cuts on n ("n"; the rules never cut a stack dim over it)
    holds its block of every row already and keeps it, and the projector
    stacks (this process's block of d over ``data`` where it cuts d) keep
    every row: the hot step projects and back-projects every row of this
    process's block of W."""

    plan: BucketPlan
    inner_name: str  # 'adam' | 'msgd' | 'adam_mini' | 'adam8bit'
    has_v: bool
    templates: Dict[int, LeafStateTemplate]  # keyed by leaf_idx
    projector_dtype: torch.dtype = torch.float32
    shards: int = 1  # 1: replicated; > 1: ZeRO-sharded over the DP axes
    zero_rows: Tuple[bool, ...] = ()


def build_state_layout(
    plan: BucketPlan,
    flat_specs: Sequence,
    flat_params: Sequence,
    *,
    inner_name: str,
    projector_dtype=torch.float32,
    shards: int = 1,
    fsdp_rows: bool = False,
) -> StateLayout:
    """Canonical per-leaf templates for every bucketed leaf; ``fsdp_rows``
    the FSDP step's ZeRO layout (``StateLayout.zero_rows``)."""
    del flat_specs
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
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
                qoff = bucket.n0 % qz.QBLOCK if e.side == "left" else 0
                m_scale = _Like(mshape[:-1] + (qz.num_blocks(qoff + mshape[-1]),), f32)
                v = m
            elif inner_name == "adam_mini":
                m = _Like(mshape, f32)
                v = _Like(mshape[:-1], f32)
            else:
                m = _Like(mshape, f32)
                v = m if has_v else None
            templates[e.leaf_idx] = LeafStateTemplate(proj, m, v, m_scale, m_scale)
    zero_rows = tuple(bk.dsplit in ("d", "") for bk in plan.buckets) if fsdp_rows else ()
    return StateLayout(plan, inner_name, has_v, templates, projector_dtype, shards, zero_rows)


def init_bucket_states(layout: StateLayout, device, tp_index: int = 0,
                       dp_index: int = 0) -> Tuple[BucketState, ...]:
    """Eye projectors (the first refresh installs the real ones) and zero
    moments, stacked (quantized zeros for adam8bit: the codes and scales
    of ``inner.adam8bit().init``); padded to the ZeRO rows when
    ``layout.shards > 1`` (``zero_pad_states``).  A "d" bucket's projector
    is process ``tp_index``'s rows of the global eye (``dp_index``'s where
    the bucket is "d" over ``data``)."""
    out = []
    for bucket in layout.plan.buckets:
        B, d, n, r = bucket.batch, bucket.d, bucket.n, bucket.rank
        eye = torch.eye(bucket.global_dims()[0], r, dtype=layout.projector_dtype, device=device)
        if bucket.split == "d":
            eye = eye[tp_index * d:(tp_index + 1) * d]
        elif bucket.dsplit == "d":
            eye = eye[dp_index * d:(dp_index + 1) * d]
        proj = eye.expand(B, d, r).clone()
        z = torch.zeros((B, r, n), dtype=torch.float32, device=device)
        if layout.inner_name == "adam8bit":
            qoff = bucket.n0 % qz.QBLOCK if bucket.side == "left" else 0
            mc, ms = qz.quantize_stacked(z, bucket.side, signed=True, offset=qoff)
            vc, vs = qz.quantize_stacked(z, bucket.side, signed=False, offset=qoff)
            out.append(BucketState(proj, mc, vc, ms, vs))
            continue
        if layout.inner_name == "adam_mini":
            rows = r if bucket.side == "left" else n
            v = torch.zeros((B, rows), dtype=torch.float32, device=device)
        else:
            v = torch.zeros_like(z) if layout.has_v else None
        out.append(BucketState(projector=proj, m=z, v=v))
    return zero_pad_states(layout, out)


# ---------------------------------------------------------------------------
# the ZeRO layout (state_sharding="zero"), ``src/repro/core/buckets.py:409-600``
# ---------------------------------------------------------------------------
#
# Each (B, ...) stack pads along dim 0 to B_pad = ceil(B / shards) * shards,
# so every process owns a contiguous (B_pad / shards, ...) block of rows of
# every buffer.  The pad rows are inert: every fused update works row by
# row, all their inputs (W, G, P, moments) are zero, and zero rows are fixed
# points of every update (adam8bit's too: zero codes with scale 0, and the
# requantized zero rows, dequantize to exactly 0).  The canonical layout
# drops them first, so their bit patterns never reach a checkpoint of that
# format.


def zero_padded_batch(batch: int, shards: int) -> int:
    """Smallest multiple of ``shards`` >= ``batch``."""
    return -(-batch // shards) * shards


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    if x.shape[0] == rows:
        return x
    pad = x.new_zeros((rows - x.shape[0],) + tuple(x.shape[1:]))
    return torch.cat([x, pad], dim=0)


def _map_state(bst: BucketState, fn, fields: Sequence[int] = range(5)) -> BucketState:
    return BucketState(*[None if x is None else fn(x) if i in fields else x
                         for i, x in enumerate(bst)])


def zero_fields(layout: StateLayout, i: int) -> Tuple[int, ...]:
    """The ``BucketState`` fields of bucket ``i`` that take rows of B: every
    one in the compressed steps' layout, the moments of a ``zero_rows``
    bucket on the FSDP step, none elsewhere."""
    if layout.shards <= 1:
        return ()
    if not layout.zero_rows:
        return (0, 1, 2, 3, 4)
    return (1, 2, 3, 4) if layout.zero_rows[i] else ()


def zero_pad_states(layout: StateLayout, bucket_states: Sequence[BucketState]
                    ) -> Tuple[BucketState, ...]:
    """Canonical-batch stacks -> the padded ZeRO stacks (zero rows)."""
    if layout.shards <= 1:
        return tuple(bucket_states)
    return tuple(
        _map_state(bst, lambda x, bp=zero_padded_batch(bucket.batch, layout.shards):
                   _pad_rows(x, bp), zero_fields(layout, i))
        for i, (bucket, bst) in enumerate(zip(layout.plan.buckets, bucket_states)))


def zero_unpad_states(layout: StateLayout, bucket_states: Sequence[BucketState]
                      ) -> Tuple[BucketState, ...]:
    """Padded ZeRO stacks -> canonical-batch stacks (pad rows dropped)."""
    if layout.shards <= 1:
        return tuple(bucket_states)
    return tuple(_map_state(bst, lambda x, b=bucket.batch: x[:b], zero_fields(layout, i))
                 for i, (bucket, bst) in enumerate(zip(layout.plan.buckets, bucket_states)))


def zero_pad_grad_stacks(layout: StateLayout, stacks: Sequence[torch.Tensor]
                         ) -> Tuple[torch.Tensor, ...]:
    """Per-bucket gradient stacks zero-padded to the shardable batch, what
    the per-bucket reduce-scatter takes: a pad row is zero on every
    process, so its scattered sum is exactly zero."""
    return tuple(_pad_rows(x, zero_padded_batch(bucket.batch, layout.shards))
                 for bucket, x in zip(layout.plan.buckets, stacks))


def zero_shard_index(axes) -> int:
    """This process's combined index over the DP axes (``launch/mesh.
    DPAxes``): the row order of their reduce-scatters and all-gathers."""
    return axes.index


def zero_local_states(layout: StateLayout, bucket_states: Sequence[BucketState],
                      shard_index: int) -> Tuple[BucketState, ...]:
    """One shard's block of rows of full padded stacks, each a copy of its
    own (the full stacks can then be freed)."""
    out = []
    for i, (bucket, bst) in enumerate(zip(layout.plan.buckets, bucket_states)):
        rows = zero_padded_batch(bucket.batch, layout.shards) // layout.shards
        lo = shard_index * rows
        out.append(_map_state(bst, lambda x, lo=lo, rows=rows: x[lo:lo + rows].clone(),
                              zero_fields(layout, i)))
    return tuple(out)


def zero_gather_states(local_states: Sequence[BucketState], axes,
                       layout: Optional[StateLayout] = None) -> Tuple[BucketState, ...]:
    """Every shard's rows gathered back into the full padded stacks (the
    inverse of ``zero_local_states``); ``layout`` says which fields took
    rows (None: every one)."""
    return tuple(_map_state(bst, axes.all_gather,
                            range(5) if layout is None else zero_fields(layout, i))
                 for i, bst in enumerate(local_states))


def zero_gather_projectors(layout: StateLayout, local_states: Sequence[BucketState], axes
                           ) -> Tuple[torch.Tensor, ...]:
    """The full unpadded (B, d, r) projector stacks from shard-local state:
    the hot step's projection runs over all B rows of this process's
    gradient before the reduce-scatter, so every process needs every
    projector (the per-step price of sharding them, ``dp_comm_model``'s
    zero schedule)."""
    return tuple(axes.all_gather(bst.projector)[:bucket.batch]
                 for bucket, bst in zip(layout.plan.buckets, local_states))


def zero_local_param_stacks(layout: StateLayout, flat_params: Sequence[torch.Tensor],
                            shard_index: int) -> Tuple[torch.Tensor, ...]:
    """This shard's (B_pad / shards, d, n) block of rows of every W stack
    (params are replicated, so no collective)."""
    out = []
    for bucket in layout.plan.buckets:
        bp = zero_padded_batch(bucket.batch, layout.shards)
        rows = bp // layout.shards
        lo = shard_index * rows
        w = _pad_rows(_gather_rows(bucket, flat_params, lo, min(lo + rows, bucket.batch)),
                      rows)
        out.append(w)
    return tuple(out)


def _gather_rows(bucket: Bucket, leaves, lo: int, hi: int) -> torch.Tensor:
    """Rows [lo, hi) of the bucket's (B, d, n) stack, stacking only the
    entries they touch (an empty (0, d, n) stack when lo >= hi)."""
    parts, off = [], 0
    for e in bucket.entries:
        a, b = max(lo, off), min(hi, off + e.batch)
        if a < b:
            parts.append(_orient_in(leaves[e.leaf_idx], e.side)[a - off:b - off])
        off += e.batch
    if not parts:
        x = _orient_in(leaves[bucket.entries[0].leaf_idx], bucket.entries[0].side)
        return x.new_zeros((0,) + tuple(x.shape[1:]))
    return parts[0].contiguous() if len(parts) == 1 else torch.cat(parts, dim=0)


def zero_gather_stacks(layout: StateLayout, local_stacks: Sequence[torch.Tensor], axes
                       ) -> Tuple[torch.Tensor, ...]:
    """Every shard's block of rows gathered into full unpadded stacks: the
    W' gather of the ZeRO hot step (pad rows dropped)."""
    return tuple(axes.all_gather(x)[:bucket.batch]
                 for bucket, x in zip(layout.plan.buckets, local_stacks))


def zero_scatter_outputs(plan: BucketPlan, stacks: Sequence[torch.Tensor],
                         flat_params: Sequence) -> Dict[int, torch.Tensor]:
    """Full (B, d, n) output stacks -> {leaf_idx: per-leaf tensor}."""
    out: Dict[int, torch.Tensor] = {}
    for bucket, x in zip(plan.buckets, stacks):
        out.update(_scatter(bucket, x, flat_params))
    return out


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
    not split its check by bucket: ``all_finite`` over every gradient (the
    data-parallel step's reduced stacks too) gives the same verdict."""
    return [all_finite([flat_grads[e.leaf_idx] for e in bucket.entries])
            for bucket in plan.buckets]


def _tp_reduce_r(bucket: Bucket, r_g: torch.Tensor, tp_axes, fsdp_axes=None) -> torch.Tensor:
    """A "d" bucket's partial R summed over the axis that cuts its d
    (``model`` or, under FSDP, ``data``), in place."""
    for kind, ax in bucket.cuts(tp_axes, fsdp_axes):
        if kind == "d":
            ax.all_reduce_(r_g)
    return r_g


def bucketed_project_grads(plan: BucketPlan, bucket_states: Sequence[BucketState],
                           flat_grads: Sequence[torch.Tensor],
                           projectors: Optional[Sequence[torch.Tensor]] = None,
                           tp_axes=None, fsdp_axes=None) -> Tuple[torch.Tensor, ...]:
    """One f32 (B, r, n) R-space stack per bucket, R = P^T G from the bucket
    projector stacks (the projection kernel on the card): the hot payload
    of the project-then-reduce step, one contiguous buffer per bucket.
    ``projectors`` overrides the (B, d, r) stacks (the ZeRO step passes the
    gathered full projectors, ``zero_gather_projectors``).  Under tensor
    parallelism (``tp_axes``) a "d" bucket's R is summed over ``model``
    (over ``data`` under FSDP, ``fsdp_axes``)."""
    if projectors is None:
        projectors = [bst.projector for bst in bucket_states]
    return tuple(_tp_reduce_r(bucket, update_ops.bucketed_project(_gather(bucket, flat_grads), p),
                              tp_axes, fsdp_axes)
                 for bucket, p in zip(plan.buckets, projectors))


def bucketed_stack_grads(plan: BucketPlan, flat_grads: Sequence[torch.Tensor]
                         ) -> Tuple[torch.Tensor, ...]:
    """One full (B, d, n) gradient stack per bucket, canonical orientation:
    the refresh step's payload, which ``bucketed_refresh`` and
    ``bucketed_update`` take as it is."""
    return tuple(_gather(bucket, flat_grads) for bucket in plan.buckets)


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
    projected: bool = False,
    stacked_grads: Optional[Sequence[torch.Tensor]] = None,
    stacked_params: Optional[Sequence[torch.Tensor]] = None,
    out_stacked: bool = False,
    tp_axes=None,
    fsdp_axes=None,
    zero_rows=None,
) -> Tuple[Any, Tuple[BucketState, ...], List[torch.Tensor]]:
    """Run every bucket against its storage-layout state.  Returns
    ({leaf_idx: new param (apply) or update}, new bucket states,
    per-bucket squared update norms).

    ``stacked_grads`` (one stack per bucket, canonical orientation) stands
    for the per-leaf gather: the data-parallel step's reduced (B, r, n) R
    stacks with ``projected=True`` (no projection runs), or its reduced
    full (B, d, n) stacks.  The ZeRO hot step passes each process's block
    of rows of every operand, ``stacked_params`` included, and takes the
    W' stacks back unscattered (``out_stacked``) for its all-gather: every
    fused update works row by row, so a block goes through the same
    kernels.  Under tensor parallelism (``tp_axes``) a "d" bucket's R is
    summed over ``model`` between the projection and the update (over
    ``data`` under FSDP, ``fsdp_axes``).  Where an axis cuts the n of a
    'left' bucket, Adam-mini's row sums are summed over it and 8-bit
    Adam's chunks keep their global places (``kernels/lowrank_update``).

    ``zero_rows`` = (``data`` axes, ``StateLayout``): ZeRO state on the FSDP
    step, whose ``zero_rows`` buckets hold this process's rows of their
    moments.  Such a bucket's partial R is reduce-scattered over ``data``
    ("d") or its rows are taken (""), the moments pass runs on the rows,
    their N is all-gathered over ``data`` and every row of this process's
    block of W is back-projected (the kernels' split schedule): the same
    bytes over ``data`` as the all-reduce of R."""
    lr_alpha = lr * cfg.alpha
    lr_wd = lr * cfg.weight_decay if cfg.weight_decay else 0.0
    ik = cfg.inner_kwargs()
    out_leaves: Dict[int, torch.Tensor] = {}
    out_stacks: List[torch.Tensor] = []
    new_states: List[BucketState] = []
    norm_sq: List[torch.Tensor] = []
    for bi, (bucket, bst) in enumerate(zip(plan.buckets, bucket_states)):
        w = stacked_params[bi] if stacked_params is not None else _gather(bucket, flat_params)
        p = bst.projector
        g = stacked_grads[bi] if stacked_grads is not None else _gather(bucket, flat_grads)
        kw = dict(ik, **_cut_kwargs(cfg.inner, bucket, tp_axes, fsdp_axes))
        if projected:
            r_g = g
        elif zero_rows is not None and zero_rows[1].zero_rows[bi]:
            r_g, kw["gather"] = _zero_rows_r(bucket, update_ops.bucketed_project(g, p),
                                             tp_axes, *zero_rows)
        else:
            r_g = _tp_reduce_r(bucket, update_ops.bucketed_project(g, p), tp_axes, fsdp_axes)
        del g
        if cfg.inner == "msgd":
            w_new, m_new = update_ops.bucketed_msgd_update(
                w, p, r_g, bst.m, lr_alpha, lr_wd, **kw
            )
            new_bst = BucketState(projector=p, m=m_new, v=None)
        elif cfg.inner == "adam_mini":
            w_new, m_new, v_new = update_ops.bucketed_adam_mini_update(
                w, p, r_g, bst.m, bst.v, step, lr_alpha, lr_wd, side=bucket.side, **kw
            )
            new_bst = BucketState(projector=p, m=m_new, v=v_new)
        elif cfg.inner == "adam8bit":
            w_new, mc, ms, vc, vs = update_ops.bucketed_adam8bit_update(
                w, p, r_g, bst.m, bst.m_scale, bst.v, bst.v_scale, step,
                lr_alpha, lr_wd, side=bucket.side, **kw,
            )
            new_bst = BucketState(projector=p, m=mc, v=vc, m_scale=ms, v_scale=vs)
        else:
            w_new, m_new, v_new = update_ops.bucketed_adam_update(
                w, p, r_g, bst.m, bst.v, step, lr_alpha, lr_wd, **kw
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
        if out_stacked:
            out_stacks.append(out)
        else:
            out_leaves.update(_scatter(bucket, out, flat_params))
        new_states.append(new_bst)
    return (out_stacks if out_stacked else out_leaves), tuple(new_states), norm_sq


def _cut_kwargs(inner: str, bucket: Bucket, tp_axes, fsdp_axes) -> Dict[str, Any]:
    """The fused update's keywords for a 'left' bucket whose n an axis cuts:
    Adam-mini's row sums summed over it, 8-bit Adam's chunk offset and the
    largest absmax of a straddling chunk over it."""
    ax = bucket.n_axes(tp_axes, fsdp_axes)
    if ax is None or bucket.side != "left" or inner not in ("adam_mini", "adam8bit"):
        return {}
    n_total = bucket.global_dims()[1]
    if inner == "adam_mini":
        return dict(axes=ax, n_total=n_total)
    return dict(qoff=bucket.n0 % qz.QBLOCK,
                reduce=lambda am: qz.straddle_max(am, bucket.n0, n_total, ax))


def _zero_rows_r(bucket: Bucket, r_full: torch.Tensor, tp_axes, data_axes, layout):
    """(this process's rows of a ``zero_rows`` bucket's R, the gather of
    their N to every row): the partial R reduce-scattered over ``data``
    where it cuts d, else its rows taken; then summed over ``model`` where
    that cuts d."""
    bp = zero_padded_batch(bucket.batch, layout.shards)
    padded = _pad_rows(r_full, bp)
    if bucket.dsplit == "d":
        r_g = data_axes.reduce_scatter(padded)
    else:
        rows = bp // layout.shards
        r_g = padded[data_axes.index * rows:(data_axes.index + 1) * rows].contiguous()
    del padded
    if bucket.split == "d" and tp_axes is not None:
        tp_axes.all_reduce_(r_g)
    return r_g, lambda n_rows: data_axes.all_gather(n_rows)[:bucket.batch]


# ---------------------------------------------------------------------------
# the refresh path on stacked operands
# ---------------------------------------------------------------------------


def entry_draws(draws, entry: BucketEntry, template: LeafStateTemplate,
                bucket: Bucket, pcfg, device, tp_index: int = 0) -> LeafDraws:
    """One entry's refresh draws from the state's draw source, keyed by its
    global leaf index; a leaf with leading dims draws one per slice.  The
    draws are the global leaf's (its (d, n), every slice): an entry whose
    leading dim is split over ``model`` takes process ``tp_index``'s
    block of the slices."""
    lead = tuple(template.projector.shape[:-2])
    shapes = draw_shapes(*bucket.global_dims(), pcfg, bucket.rank)
    ls = bucket.lead_split
    if ls < 0 or bucket.tp == 1:
        return draws.leaf(entry.leaf_idx, lead, shapes, device)
    glead = lead[:ls] + (lead[ls] * bucket.tp,) + lead[ls + 1:]
    full = draws.leaf(entry.leaf_idx, glead, shapes, device)

    def block(x):
        if x is None:
            return None
        x = x.reshape(glead + tuple(x.shape[1:]))
        x = x.narrow(ls, tp_index * lead[ls], lead[ls])
        return x.reshape((-1,) + tuple(x.shape[len(glead):]))

    return LeafDraws(*(block(x) for x in full))


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
    stacked_grads: Optional[Sequence[torch.Tensor]] = None,
    tp_axes=None,
    split_refresh_fn=None,  # (g_stack, draws, old_p_stack, rank, n_full, axes) -> stack
    fsdp_axes=None,
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
    ``stacked_grads`` (one canonical (B, d, n) stack per bucket, the
    data-parallel refresh's reduced payload) stands for the per-leaf
    gradients: the refreshed entries' rows are sliced out of it.

    Under tensor parallelism (``tp_axes``, the module docstring) a "d"
    bucket gathers its gradient and projector stacks over ``model``,
    refreshes them whole and keeps its rows of the new projectors; an "n"
    bucket refreshes through ``split_refresh_fn`` on its own columns (the
    sketch route, ``projectors.refresh_projector_stacked_split``) where one
    is given, and gathers its gradients otherwise.
    Under FSDP (``fsdp_axes``) the same holds over ``data``, which comes
    first: a bucket cut on both axes gathers over the one that cuts its d
    and takes the sketch route over the one that cuts its n.
    The draws are the global leaves' on every process.
    Returns (new bucket states, per-leaf overlap diagnostics)."""
    new_states: List[BucketState] = []
    overlaps: List[torch.Tensor] = []
    tp_index = tp_axes.index if tp_axes is not None else 0
    for bi, (bucket, bst) in enumerate(zip(layout.plan.buckets, bucket_states)):
        device = bst.projector.device
        hot = [e for e in bucket.entries if flat_specs[e.leaf_idx].group == group]
        new_slices: Dict[int, torch.Tensor] = {}
        stack = stacked_grads[bi] if stacked_grads is not None else None
        proj = bst.projector
        cuts = bucket.cuts(tp_axes, fsdp_axes) if hot else []
        d_axes = [ax for kind, ax in cuts if kind == "d"]
        sketch = next((ax for kind, ax in cuts if kind == "n"), None) \
            if split_refresh_fn is not None else None
        if cuts and stack is None:
            stack = _gather(bucket, flat_grads)
        for kind, ax in cuts:
            if kind == "d":
                stack = ax.all_gather(stack, dim=1)
                proj = ax.all_gather(proj, dim=1)
            elif ax is not sketch:
                stack = ax.all_gather(stack, dim=2)
        if hot and stacked_refresh_fn is not None:
            if stack is not None:
                g_stack = _slice_entries(bucket, stack, hot)
            else:
                g_stack = _gather(bucket._replace(entries=tuple(hot)), flat_grads)
            old_stack = _slice_entries(bucket, proj, hot)
            per = [entry_draws(draws, e, layout.templates[e.leaf_idx], bucket, pcfg, device,
                               tp_index) for e in hot]
            stacked = LeafDraws(*(_cat(list(parts)) for parts in zip(*per)))
            # the gather route: each process of the axis that cut d refreshes
            # its block of the slices, and the new projectors are gathered
            share = d_axes[0] if d_axes and sketch is None \
                and g_stack.shape[0] % d_axes[0].size == 0 else None
            if share is not None:
                rows = g_stack.shape[0] // share.size
                cut = slice(share.index * rows, (share.index + 1) * rows)
                new_stack = stacked_refresh_fn(
                    g_stack[cut], LeafDraws(*(None if x is None else x[cut] for x in stacked)),
                    old_stack[cut], bucket.rank)
                new_stack = share.all_gather(new_stack.to(bst.projector.dtype).contiguous())
            elif sketch is not None:
                # this process's rows of the global sketch
                n, i = bucket.n, sketch.index
                if stacked.omega is not None:
                    stacked = stacked._replace(omega=stacked.omega[:, i * n:(i + 1) * n])
                new_stack = split_refresh_fn(g_stack, stacked, old_stack, bucket.rank,
                                             bucket.global_dims()[1], sketch)
            else:
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
                old_slice = proj[off:off + e.batch]
                off += e.batch
                if flat_specs[e.leaf_idx].group != group:
                    continue
                tmpl = layout.templates[e.leaf_idx]
                if stack is not None:
                    g_leaf = _unstack_entry(stack, bucket, e, tmpl)
                else:
                    g_leaf = flat_grads[e.leaf_idx]
                new_p = refresh_fn(
                    g_leaf,
                    entry_draws(draws, e, tmpl, bucket, pcfg, device, tp_index),
                    old_slice.reshape(tuple(tmpl.projector.shape[:-2]) + old_slice.shape[-2:]),
                    flat_specs[e.leaf_idx],
                ).reshape(old_slice.shape).to(bst.projector.dtype)
                overlaps.append(torch.mean(
                    _overlap_per_slice(new_p, old_slice, bucket.rank)))
                new_slices[e.leaf_idx] = new_p
        del stack
        parts, refreshed, off = [], [], 0
        for e in bucket.entries:
            old_slice = proj[off:off + e.batch]
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
                c = torch.einsum("bdn,bdo->bno", new_proj, proj)
                m2 = torch.einsum("bno,bok->bnk", c, m).to(m.dtype)
                m = _select_slices(bucket, refreshed, m2, m)
        for ax in d_axes:
            # this process's rows of the whole refreshed projectors
            new_proj = new_proj[:, ax.index * bucket.d:(ax.index + 1) * bucket.d].contiguous()
        new_states.append(BucketState(new_proj, m, v, ms_, vs_))
    return tuple(new_states), overlaps


def _unstack_entry(stacked: torch.Tensor, bucket: Bucket, entry: BucketEntry,
                   template: LeafStateTemplate) -> torch.Tensor:
    """One entry's per-leaf view of a full (B, d, n) gradient stack
    (orientation and leading dims restored)."""
    off = 0
    for e in bucket.entries:
        if e.leaf_idx == entry.leaf_idx:
            break
        off += e.batch
    part = stacked[off:off + entry.batch]
    if entry.side == "right":
        part = part.transpose(-1, -2)
    return part.reshape(tuple(template.projector.shape[:-2]) + tuple(part.shape[-2:]))


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


# ---------------------------------------------------------------------------
# host models of the state, checkpoint and data-parallel bytes,
# ``src/repro/core/buckets.py:1150-1560``
# ---------------------------------------------------------------------------


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _leaf_nbytes(leaf) -> int:
    """Bytes of a tensor, or of anything with a shape and a torch dtype."""
    n = 1
    for s in leaf.shape:
        n *= int(s)
    return n * _itemsize(leaf.dtype)


def modeled_state_bytes(plan: BucketPlan, inner: str = "adam", shards: int = 1
                        ) -> Dict[str, float]:
    """Resident bytes of the bucketed leaves' state: f32 projector stacks and
    the inner's moment buffers (``moment_bytes_per_param`` per R-space
    element: 8 for adam, ~2 for adam8bit's codes and scales).  ``shards``
    adds the ZeRO layout: ``padded_total`` the padded stacks' bytes,
    ``per_device`` what one process holds (``padded_total / shards``)."""
    projectors = moments = n_elems = per_device = padded_total = 0
    for bk in plan.buckets:
        B, d, n, r = bk.batch, bk.d, bk.n, bk.rank
        row_proj = d * r * 4
        if inner == "msgd":
            row_mom = r * n * 4
        elif inner == "adam_mini":
            rows = r if bk.side != "right" else n
            row_mom = r * n * 4 + rows * 4
        elif inner == "adam8bit":
            rows, rowlen = (r, n) if bk.side != "right" else (n, r)
            row_mom = 2 * r * n + 2 * rows * qz.num_blocks(rowlen) * 4
        else:
            row_mom = 2 * r * n * 4
        projectors += B * row_proj
        moments += B * row_mom
        n_elems += B * r * n
        bp = zero_padded_batch(B, shards)
        padded_total += bp * (row_proj + row_mom)
        per_device += (bp // shards) * (row_proj + row_mom)
    return {
        "total": float(projectors + moments),
        "projectors": float(projectors),
        "moments": float(moments),
        "moment_bytes_per_param": moments / max(n_elems, 1),
        "shards": float(shards),
        "padded_total": float(padded_total),
        "per_device": float(per_device),
    }


def sharded_ckpt_model(plan: BucketPlan, inner: str = "adam", shards: int = 1
                       ) -> Dict[str, float]:
    """The bucketed state's checkpoint write: ``canonical_bytes`` through one
    writer in the canonical format, ``sharded_bytes_per_host`` one writer's
    block of rows in the shard-parallel format (``padded_total / shards``),
    and ``stack_files_per_host`` its files (one per bucket per live
    ``BucketState`` field).  Params and the other leaves are replicated in
    both formats and left out."""
    if inner == "msgd":
        fields = 2  # projector + m
    elif inner == "adam8bit":
        fields = 5  # projector + m/v codes + m/v scales
    else:
        fields = 3  # projector + m + v (adam_mini's per-row v too)
    st = modeled_state_bytes(plan, inner, shards)
    return {
        "canonical_bytes": st["total"],
        "sharded_bytes_per_host": st["padded_total"] / max(shards, 1),
        "stack_files_per_host": float(len(plan.buckets) * fields),
        "shards": float(shards),
    }


def _moment_traffic_bytes(bk: Bucket, inner: str, engine: str) -> int:
    """Moment-buffer bytes one hot step moves for one bucket: adam's M and V
    read and written; msgd's M; adam_mini's M, the extra R read of its
    per-row statistic and the small v; adam8bit's codes of both moments and
    their scales (the fused update keeps the f32 moments on chip), plus, on
    the reference engine, the dequantized f32 M and V written and read."""
    B, n, r = bk.batch, bk.n, bk.rank
    rn = B * r * n * 4
    if inner == "msgd":
        return 2 * rn
    if inner == "adam_mini":
        rows = r if bk.side != "right" else n
        return 2 * rn + rn + 2 * B * rows * 4
    if inner == "adam8bit":
        rows, rowlen = (r, n) if bk.side != "right" else (n, r)
        codes = 4 * B * r * n  # M, V codes read + write, 1 byte each
        scales = 4 * B * rows * qz.num_blocks(rowlen) * 4
        if engine != "bucketed":
            codes += 4 * rn  # dequantized f32 M, V temporaries, w + r
        return codes + scales
    return 4 * rn  # adam


def modeled_hbm_bytes(
    plan: BucketPlan,
    engine: str,
    itemsize: int = 4,
    projected: bool = False,
    state_layout: str = "bucketed",
    track_update_norm: bool = False,
    inner: str = "adam",
) -> int:
    """Modeled optimizer-path bytes per hot step of the bucketed leaves
    (``buckets.py:1097``).  bucketed: G read once, R written and read, P
    read twice, the moments (``_moment_traffic_bytes``), W read and W'
    written; ``projected`` (the compressed step) drops the projection;
    ``state_layout="perleaf"`` adds the moments' and projectors' stack and
    unstack passes; ``track_update_norm`` the re-read of W' and W.
    reference: the projection, the inner on R, the direction N written and
    read, the back-projection to d x n and the separate apply pass."""
    total = 0
    for bk in plan.buckets:
        B, d, n, r = bk.batch, bk.d, bk.n, bk.rank
        wn = B * d * n * itemsize
        pr = B * d * r * 4
        rn = B * r * n * 4
        moments = _moment_traffic_bytes(bk, inner, engine)
        if engine == "bucketed":
            proj = 0 if projected else (wn + pr + rn)  # read G, P; write R
            upd = wn + pr + rn + moments + wn  # W r, P, R, moments, W' w
            extra = 0
            if state_layout == "perleaf":
                extra += 2 * moments + 2 * pr
            if track_update_norm:
                extra += 2 * wn  # re-read W' and W for ||W' - W||
            total += proj + upd + extra
        else:
            proj = 0 if projected else (wn + pr + rn)
            inner_tr = rn + moments  # R read, moments r/w
            direction = rn + 2 * rn  # N = f(M', V') r-space write + read
            backproj = pr + rn + 2 * wn  # P, N_r -> full-space dir d x n
            apply = 3 * wn  # params read + dir read + params write
            total += proj + inner_tr + direction + backproj + apply
    return total


def update_num_ops(plan: BucketPlan, inner: str = "adam", projected: bool = False) -> int:
    """Launches per bucketed hot step: the projection (unless the gradients
    come projected) and the fused update per bucket, plus adam_mini's
    per-row statistic (one reduction per bucket)."""
    per_bucket = 1 if projected else 2
    if inner == "adam_mini":
        per_bucket += 1
    return len(plan.buckets) * per_bucket


def reference_num_ops(plan: BucketPlan, projected: bool = False, inner: str = "adam") -> int:
    """The per-leaf chain on the reference engine: project, moments,
    direction, back-project and apply per low-rank leaf; adam8bit adds the
    dequantize and requantize passes, adam_mini the per-row statistic."""
    n_leaves = sum(len(bk.entries) for bk in plan.buckets)
    per_leaf = 4 if projected else 5
    if inner == "adam8bit":
        per_leaf += 2
    elif inner == "adam_mini":
        per_leaf += 1
    return n_leaves * per_leaf


def finite_check_model(plan: BucketPlan, projected: bool = False, itemsize: int = 4
                       ) -> Dict[str, float]:
    """The skip-step gate's cost (``bucketed_all_finite``): one
    ``all(isfinite)`` reduction per bucket stack over the (B, r, n) R
    stacks on the projected step, the full (B, d, n) stacks otherwise."""
    nbytes = 0
    for bk in plan.buckets:
        rows = bk.rank if projected else bk.d
        nbytes += bk.batch * rows * bk.n * itemsize
    return {"modeled_hbm_bytes": float(nbytes), "dispatched_ops": float(len(plan.buckets))}


# The refresh models describe the randomized (SARA pool) chain, as the
# reference's (``buckets.py:1282-1297``): "perleaf" is the baseline of
# record, one chain per refreshed leaf with the (n, k') Z = G^T Q written
# out and re-orthonormalized each power iteration; "batched" one chain per
# bucket with refreshed entries, thin-QR iterations on the fused power
# step (kernel 9), plus the gradient stack's concat.


def _refresh_chain_ops(engine: str, power_iters: int) -> int:
    """One chain's launches: sketch draw, sketch product, final QR, B =
    Q^T G, the small SVD, the Gumbel draw and the column gather (7), plus
    per power iteration QR and the fused step (batched, 2) or QR, Z, QR,
    Y (perleaf, 4); ``power_iters`` after ``svd.clamp_sketch``."""
    per_iter = 2 if engine == "batched" else 4
    return 7 + per_iter * power_iters


def refresh_num_ops(
    plan: BucketPlan,
    flat_specs: Sequence,
    *,
    engine: str,
    group: int = 0,
    oversample: int = 8,
    power_iters: int = 2,
    pool_factor: int = 4,
) -> int:
    """Launches of one randomized refresh of ``group``, clamped as
    ``modeled_refresh_hbm_bytes`` (a bucket whose sketch spans its range
    runs no power iteration)."""
    from repro_torch.core import svd as svd_lib

    total = 0
    for bk in plan.buckets:
        k = min(bk.d, pool_factor * bk.rank)
        _, _, iters = svd_lib.clamp_sketch(bk.d, bk.n, k, oversample, power_iters)
        chain = _refresh_chain_ops(engine, iters)
        n_hot = sum(1 for e in bk.entries if flat_specs[e.leaf_idx].group == group)
        total += chain * (min(n_hot, 1) if engine == "batched" else n_hot)
    return total


def modeled_refresh_hbm_bytes(
    plan: BucketPlan,
    flat_specs: Sequence,
    *,
    engine: str,
    group: int = 0,
    oversample: int = 8,
    power_iters: int = 2,
    pool_factor: int = 4,
    itemsize: int = 4,
) -> int:
    """Modeled bytes of one randomized refresh step (``buckets.py:1341``):
    per refreshed (d, n) slice at sketch width k' (``svd.clamp_sketch``),
    the sketch product, the power iterations (per engine, above), the
    final QR, B = Q^T G, the small SVD, U = Q U_b and the sampled (d, r)
    projector written; the batched engine also pays the gradient stack's
    concat where a bucket has more than one refreshed entry."""
    from repro_torch.core import svd as svd_lib

    total = 0
    for bk in plan.buckets:
        d, n, r = bk.d, bk.n, bk.rank
        k = min(d, pool_factor * r)
        _, kp, iters = svd_lib.clamp_sketch(d, n, k, oversample, power_iters)
        dn, dkp, nkp = d * n, d * kp, n * kp
        per_slice = dn + nkp + dkp  # sketch: G read, omega read, Y write
        if engine == "batched":
            # thin QR (Y r/w) + fused step (G read twice, Q read, Y write)
            per_slice += iters * (2 * dkp + 2 * dn + 2 * dkp)
        else:
            # QR(Y) + Z = G^T Q (written) + QR(Z) + Y = G Z
            per_slice += iters * (2 * dkp + (dn + dkp + nkp) + 2 * nkp + (dn + nkp + dkp))
        per_slice += 2 * dkp  # final QR
        per_slice += dkp + dn + nkp  # B = Q^T G
        per_slice += nkp + kp * kp + kp  # small SVD of B
        per_slice += 2 * dkp + kp * kp  # U = Q @ U_b
        per_slice += kp + d * r  # spectrum read + sampled projector write
        hot = [e for e in bk.entries if flat_specs[e.leaf_idx].group == group]
        n_slices = sum(e.batch for e in hot)
        bucket_bytes = n_slices * per_slice
        if engine == "batched" and len(hot) > 1:
            bucket_bytes += 2 * n_slices * dn  # gradient stack concat r/w
        total += bucket_bytes * itemsize
    return total


def dp_comm_model(
    plan: BucketPlan,
    flat_params: Sequence,
    *,
    axis_sizes: Optional[Dict[str, int]] = None,
    state_shards: int = 1,
    inner: str = "adam",
    rank_plans: Optional[Sequence[Tuple[float, BucketPlan]]] = None,
) -> Dict[str, Any]:
    """Bytes one process hands the data-parallel collectives per step, by
    schedule, as the reference's model (``buckets.py:1401``):

    * ``standard`` -- every gradient leaf full-rank, one operand per leaf;
    * ``compressed_hot`` -- one f32 (B, r, n) R stack per bucket plus the
      full-rank leaves (the low-rank part shrinks by d / r);
    * ``compressed_refresh`` -- full-rank stacks, one per bucket;
    * ``zero_hot`` (``state_shards > 1``) -- the R stacks reduce-scattered
      (padded rows), the full projector stacks and the updated W' rows
      all-gathered;
    * ``zero_refresh`` -- the refresh's full stacks plus the one gather of
      every padded state stack.

    ``axis_sizes`` ({"pod": p, "data": d}) adds the per-axis split of a
    hierarchical reduction and ``pod_mode_hot``; ``rank_plans`` ([(weight,
    plan)], a rank schedule's segments) the peak and time-weighted state
    bytes.  Full-rank gradients count at their param dtype, R stacks as
    f32.  ``train/step.py``'s collectives count the same bytes
    (``launch/mesh.COMM``)."""
    rest_bytes = n_rest = 0
    for i, leaf in enumerate(flat_params):
        if i in plan.bucketed:
            continue
        rest_bytes += _leaf_nbytes(leaf)
        n_rest += 1
    lowrank_full = lowrank_rspace = n_lowrank_leaves = 0
    rs_rspace_pad = ag_proj = ag_w = 0
    for bk in plan.buckets:
        dt = _itemsize(flat_params[bk.entries[0].leaf_idx].dtype)
        for e in bk.entries:
            lowrank_full += e.batch * bk.d * bk.n * _itemsize(flat_params[e.leaf_idx].dtype)
            n_lowrank_leaves += 1
        lowrank_rspace += bk.batch * bk.rank * bk.n * 4
        bp = zero_padded_batch(bk.batch, max(state_shards, 1))
        rs_rspace_pad += bp * bk.rank * bk.n * 4
        ag_proj += bp * bk.d * bk.rank * 4
        ag_w += bp * bk.d * bk.n * dt
    state_gather = modeled_state_bytes(plan, inner=inner,
                                       shards=max(state_shards, 1))["padded_total"]
    out: Dict[str, Any] = {
        "standard": {"bytes": rest_bytes + lowrank_full,
                     "collectives": n_rest + n_lowrank_leaves},
        "compressed_hot": {"bytes": rest_bytes + lowrank_rspace,
                           "collectives": n_rest + len(plan.buckets)},
        "compressed_refresh": {"bytes": rest_bytes + lowrank_full,
                               "collectives": n_rest + len(plan.buckets)},
        "lowrank_bytes_standard": lowrank_full,
        "lowrank_bytes_compressed_hot": lowrank_rspace,
        "lowrank_compression_ratio": (lowrank_full / lowrank_rspace
                                      if lowrank_rspace else 1.0),
    }
    if state_shards > 1:
        out["zero_hot"] = {
            "bytes": rest_bytes + rs_rspace_pad + ag_proj + ag_w,
            "collectives": n_rest + 3 * len(plan.buckets),
            "reduce_scatter_bytes": rs_rspace_pad,
            "all_gather_bytes": ag_proj + ag_w,
        }
        stacks_per_bucket = 2 + (inner != "msgd") + 2 * (inner == "adam8bit")
        out["zero_refresh"] = {
            "bytes": rest_bytes + lowrank_full + int(state_gather),
            "collectives": n_rest + len(plan.buckets) * (1 + stacks_per_bucket),
            "state_gather_bytes": int(state_gather),
        }
        out["modeled_state_bytes_per_device"] = modeled_state_bytes(
            plan, inner=inner, shards=state_shards)["per_device"]
    if axis_sizes:
        data_n = int(axis_sizes.get("data", 1))
        pod_n = int(axis_sizes.get("pod", 1))
        for key in ("standard", "compressed_hot", "compressed_refresh", "zero_hot",
                    "zero_refresh"):
            if key not in out:
                continue
            payload = out[key]["bytes"]
            out[key]["per_axis"] = {
                "intra_pod_bytes": payload if data_n > 1 else 0,
                "inter_pod_bytes": payload // data_n if pod_n > 1 else 0,
            }
        # compressed="pod": the data axis reduces every leaf full-rank, only
        # the compressed stacks cross pods
        out["pod_mode_hot"] = {
            "intra_pod_bytes": out["standard"]["bytes"] if data_n > 1 else 0,
            "inter_pod_bytes": out["compressed_hot"]["bytes"] if pod_n > 1 else 0,
        }
    if rank_plans:
        seg_bytes = [(w, modeled_state_bytes(p, inner=inner,
                                             shards=max(state_shards, 1))["total"])
                     for w, p in rank_plans]
        wsum = sum(w for w, _ in seg_bytes) or 1.0
        out["modeled_state_bytes_peak"] = max(b for _, b in seg_bytes)
        out["modeled_state_bytes_avg"] = sum(w * b for w, b in seg_bytes) / wsum
    return out
