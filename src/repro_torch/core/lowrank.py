"""The low-rank optimization wrapper (Algorithm 1), from
``src/repro/core/lowrank.py``.

Composes a projector-selection method (``projectors.py``: dominant, SARA,
GoLore, Grass, online PCA, identity) with an inner stateful optimizer
(``inner.py``: Adam, MSGD, Adafactor, Adam-mini, 8-bit Adam), plus Fira's
residual path, over a nested dict of parameters, flattened in sorted key
order exactly as ``jax.tree_util`` flattens the JAX tree, so leaf indices,
bucket entries and the per-leaf draws line up with the reference.

As in the reference:

  * ``update(..., refresh=False)`` is the hot step and
    ``update(..., refresh=True, group=g)`` recomputes the projectors of
    refresh group ``g`` first; the caller alternates on step % tau.
  * ``engine="reference"`` runs a per-leaf project -> inner -> back-project
    loop; ``engine="bucketed"`` groups the low-rank leaves into buckets
    whose moments and projectors live stacked (``LowRankOptState.buckets``)
    and runs one batched projection and one fused update per bucket
    (the CUDA kernels on the card).  The bucketed refresh is one batched
    chain per bucket for the SVD-free methods, and for dominant and sara
    under ``svd_backend="randomized"``.  Fira and Adafactor have no fused
    update in either package: with ``engine="bucketed"`` they keep the
    bucket plan for accounting only and run the per-leaf loop on
    per-leaf state, as JAX's do.
  * ``update(..., apply=True)`` returns new params instead of updates.

The step count and the learning-rate schedule live on the host (a Python
int and float); the state's draw source (``TorchDraws``) makes the
refresh's random sketches, Gumbel noise and bases from a
``torch.Generator``.

``canonical_opt_state`` / ``storage_opt_state`` convert between the
bucket-native storage layout and the canonical per-leaf layout that
checkpoints hold, as the reference's do.

``update(..., skip_nonfinite=True)`` is the recovery's skip-step gate, and
``rebuild_at_rank`` / ``current_ranks`` the re-bucketing half of the rank
schedules (``core/rank_schedule.py`` evaluates them and migrates state).

The data-parallel step (``train/step.py``) reduces gradients before the
update: ``project_grads`` / ``project_grads_stacked`` (R-space, the hot
step's project-then-reduce payload) and ``stack_grads`` (full-rank
stacks, the refresh's), which ``update`` takes with ``projected=True`` or
as ``StackedGrads``.  ``state_sharding="zero"`` pads the bucket stacks to
``state_shards`` blocks of rows; ``update(..., shard_axes=)`` then runs on
this process's block (``launch/mesh.DPAxes``).

Tensor parallelism (``tensor_parallel_optimizer``): the optimizer of one
process's blocks of the params (``launch/sharding.param_spec``), its plan
made from the global leaves -- the side (left if m <= n), the rank clamp
and the refresh groups -- and run on the blocks.  Where the projector
spans the unsplit dim, R and W' are local; where it spans the split dim,
R is a partial sum all-reduced over ``model`` (the moments are then the
same on every process) and the projector is this process's rows of it
(``core/buckets.py``).  The squared norms of the split leaves are summed
over ``model`` and the whole leaves counted once, so the global norm, the
clip and the skip-step verdict are the same on every process.
``tp_global_opt_state`` / ``tp_local_opt_state`` convert between the
blocks and the global canonical per-leaf state, what checkpoints hold.
Every config takes it, as the reference's sharded step does: every inner,
both engines, Fira and a rank schedule.  The fused buckets reduce what
spans a cut dim (Adam-mini's row sums, 8-bit Adam's straddling chunks,
``core/buckets.py``); the per-leaf loop (the reference engine, Fira,
Adafactor) runs on this process's block of each leaf: R = P^T G summed
over the axis that cuts d, the back-projection local, the refresh by the
buckets' routes (``buckets.bucketed_refresh`` on a bucket of the one
leaf), the inner handed a ``Cut`` (``core/inner.py``) and Fira's ratio of
norms over the whole leaf.  Under FSDP with ``state_sharding="zero"``
(``state_shards`` the ``data`` extent) the buckets whose R is whole over
``data`` keep this process's rows of their moments
(``buckets.StateLayout.zero_rows``); ``update(..., shard_axes=)`` then
runs the split schedule of ``buckets.bucketed_update``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import RankSchedule
from repro_torch.core import buckets as buckets_lib
from repro_torch.core import inner as inner_lib
from repro_torch.core import projectors as proj_lib
from repro_torch.core.sampling import gumbel_noise
from repro_torch.kernels.lowrank_update import quantize as qz

PyTree = Any

DEFAULT_EXCLUDE = (
    "embed",
    "lm_head",
    "norm",
    "bias",
    "router",
    "gate_w",
    "conv",
    "a_log",
    "dt_",
    "scale",
    "pos_",
)


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Everything needed to build Algorithm 1, with the JAX field names and
    defaults.  ``lr_schedule`` maps the int step to a float."""

    method: str = "sara"  # full|dominant|sara|golore|grass|online_pca|identity
    inner: str = "adam"
    rank: int = 128
    # a RankSchedule spec ("cosine:128:32@0.5"), evaluated by the train
    # loop at refresh boundaries, where it re-buckets; "" keeps rank static
    rank_schedule: str = ""
    # per-group ranks (the adaptive schedule's): leaf rank =
    # min(group_ranks[group], d); one entry per refresh group
    group_ranks: Tuple[int, ...] = ()
    tau: int = 200
    alpha: float = 0.25  # GaLore scale factor applied to the low-rank update
    lr: float = 0.01
    lr_schedule: Optional[Callable[[int], float]] = None
    weight_decay: float = 0.0
    grad_clip_norm: float = 0.0  # 0 disables
    fira: bool = False
    fira_limiter: float = 1.0  # cap on the residual scaling ratio
    momentum_carry: str = "keep"  # keep | reset | reproject
    refresh_groups: int = 1
    engine: str = "reference"  # reference | bucketed
    # ZeRO state sharding: "" keeps the full bucket stacks on every
    # process; "zero" pads each stack's B to a multiple of state_shards
    # (inert zero rows), so one process owns a block of rows of every
    # buffer.  Needs bucket-native state; state_shards must equal the DP
    # replica count of the mesh the step runs on (train/step.py checks).
    state_sharding: str = ""  # "" | "zero"
    state_shards: int = 1
    min_dim: int = 16  # leaves with min(m, n) < this stay full-rank
    exclude: Tuple[str, ...] = DEFAULT_EXCLUDE
    seed: int = 0
    svd_backend: str = "exact"
    svd_oversample: int = 8
    svd_power_iters: int = 2
    sara_pool_factor: int = 4
    online_pca_lr: float = 0.1
    projector_dtype: Any = torch.float32
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def projector_config(self) -> proj_lib.ProjectorConfig:
        return proj_lib.ProjectorConfig(
            method=self.method, rank=self.rank, svd_backend=self.svd_backend,
            svd_oversample=self.svd_oversample,
            svd_power_iters=self.svd_power_iters,
            sara_pool_factor=self.sara_pool_factor,
            online_pca_lr=self.online_pca_lr, dtype=self.projector_dtype,
        )

    def inner_kwargs(self) -> Dict[str, Any]:
        """The inner optimizer's hyperparameters, field for field as JAX's
        (``src/repro/core/lowrank.py``), shared by both engines (the
        per-leaf inner and the fused update), so the two cannot drift:
        Adam-mini caps b2 at 0.95."""
        if self.inner in ("adam", "adam8bit"):
            return dict(b1=self.b1, b2=self.b2, eps=self.eps)
        if self.inner == "msgd":
            return dict(b1=self.b1)
        if self.inner == "adam_mini":
            return dict(b1=self.b1, b2=min(self.b2, 0.95), eps=self.eps)
        if self.inner == "adafactor":
            return dict(b1=self.b1)
        return {}

    def make_inner(self) -> inner_lib.InnerOptimizer:
        return inner_lib.make_inner(self.inner, **self.inner_kwargs())


class LeafSpec(NamedTuple):
    """Static per-leaf plan (computed once from path and shape)."""

    path: str
    lowrank: bool
    side: str  # 'left' | 'right' (ignored if not lowrank)
    rank: int
    group: int  # refresh group


class LeafState(NamedTuple):
    projector: torch.Tensor  # (.., d, r), or a () placeholder
    inner: Any


class TorchDraws:
    """The refresh's draw source: Gaussian sketches, Gumbel noise and
    golore's Gaussian bases from a ``torch.Generator`` on the params'
    device.

    Like the JAX key chain (split the state key once per refresh, then fold
    in the global leaf index, ``lowrank.py:673, 800``), each leaf's draws
    depend only on (seed, refresh count, leaf index), so the reference and
    bucketed engines draw the same numbers.  The numbers are not JAX's:
    the parity tests swap in a source that recomputes JAX's draws.

    In a checkpoint the source stands where JAX keeps its PRNG key,
    ``.opt_state.key``, with the key's shape and dtype: ``key()`` writes the
    uint32 words ``[refreshes, seed]`` and ``from_key`` reads any key back
    by the same rule (ROADMAP queue 3).  JAX's fresh key for a seed below
    2**32, ``PRNGKey(seed) = [0, seed]``, thus reads as the port's fresh
    source for that seed, and the port's fresh source writes that key; a
    key after refreshes reads as some other (seed, refreshes), so the two
    packages' draws part there."""

    def __init__(self, seed: int, device, refreshes: int = 0):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.refreshes = refreshes

    def key(self) -> np.ndarray:
        """The checkpoint's ``.opt_state.key``: uint32 ``[refreshes, seed]``."""
        if not (0 <= self.seed < 2**32 and 0 <= self.refreshes < 2**32):
            raise ValueError(
                f"draw source (seed {self.seed}, refreshes {self.refreshes}) does "
                "not fit a uint32[2] key"
            )
        return np.array([self.refreshes, self.seed], dtype=np.uint32)

    @classmethod
    def from_key(cls, key, device) -> "TorchDraws":
        """The source that ``key()`` wrote, from any uint32[2] key."""
        words = np.asarray(key)
        if words.shape != (2,):
            raise ValueError(f"a draw key has shape (2,), got {words.shape}")
        return cls(int(words[1]), device, refreshes=int(words[0]))

    def split(self) -> "TorchDraws":
        """The source of the next refresh (JAX: ``key, subkey = split(key)``)."""
        return TorchDraws(self.seed, self.device, self.refreshes + 1)

    def resample(self, attempt: int) -> "TorchDraws":
        """The source after rollback ``attempt`` (JAX folds ``0x5EED +
        attempt`` into its key, ``src/repro/train/recovery.py:195``): the
        seed word XORed with ``(0x5EED + attempt) * 0x9E3779B1 mod 2**32``,
        the refresh count kept.  The multiplier is odd, so the map is one
        to one: distinct attempts give distinct seeds, none of them the
        seed itself, all in uint32, so the two-word key (and a checkpoint)
        carries the resampled source like any other."""
        mix = ((_RESAMPLE_SALT + int(attempt)) * 0x9E3779B1) % 2**32
        return TorchDraws(self.seed ^ mix, self.device, self.refreshes)

    def leaf(self, leaf_idx: int, batch_shape: Tuple[int, ...],
             shapes: proj_lib.DrawShapes, device=None) -> proj_lib.LeafDraws:
        """One leaf's draws, one per slice: ``shapes`` from
        ``projectors.draw_shapes``."""
        nb = 1
        for s in batch_shape:
            nb *= s
        mix = (self.seed * 0x9E3779B1 + self.refreshes * 0x85EBCA77
               + (leaf_idx + 1) * 0xC2B2AE3D) % (2**63 - 1)
        dev = torch.device(device) if device is not None else self.device
        gen = torch.Generator(device=dev).manual_seed(mix)
        omega = (torch.randn((nb,) + tuple(shapes.sketch), generator=gen, device=dev)
                 if shapes.sketch is not None else None)
        gumbel = (gumbel_noise((nb, shapes.gumbel), gen, dev)
                  if shapes.gumbel is not None else None)
        basis = (torch.randn((nb,) + tuple(shapes.basis), generator=gen, device=dev)
                 if shapes.basis is not None else None)
        return proj_lib.LeafDraws(omega, gumbel, basis)


# Salt of the resample rule, as the reference's ``_RESAMPLE_SALT``: a
# resampled source never replays an ordinary refresh's stream.
_RESAMPLE_SALT = 0x5EED


class LowRankOptState(NamedTuple):
    step: int  # updates applied so far (host int)
    draws: Any  # the refresh's draw source (TorchDraws)
    leaves: List[LeafState]  # one per param leaf, in flat order
    buckets: Tuple[buckets_lib.BucketState, ...] = ()


class StackedGrads(NamedTuple):
    """Gradients in the bucket-native layout, for the data-parallel step:
    one stack per bucket of the plan (f32 (B, r, n) R stacks on the hot
    step, full (B, d, n) stacks on the refresh, canonical orientation) and
    the gradients of every leaf outside the buckets, in ascending leaf
    order.  Reducing it takes ``len(buckets) + len(rest)`` collectives."""

    buckets: Tuple[torch.Tensor, ...]
    rest: Tuple[torch.Tensor, ...]


class AuxInfo(NamedTuple):
    grad_norm: torch.Tensor
    update_norm: torch.Tensor
    mean_refresh_overlap: torch.Tensor  # ||P_new^T P_old||_F^2 / r, mean
    # 1.0 when the skip-step gate held the update back (non-finite grads),
    # else 0.0 (always 0.0 with the gate off)
    skipped: Any = None


# ---------------------------------------------------------------------------
# flattening in jax.tree_util's order
# ---------------------------------------------------------------------------


# The walks are module-level functions taking their accumulator as an
# argument: a nested function that calls itself is a reference cycle, and
# its closure would keep every leaf (a whole step's gradients) alive until
# the cyclic garbage collector happens to run.


def flatten_with_path(tree: PyTree) -> List[Tuple[str, Any]]:
    """(path string, leaf) pairs of a nested dict in sorted key order, with
    ``jax.tree_util.keystr`` paths (``"['blocks']['q_proj']"``)."""
    out: List[Tuple[str, Any]] = []
    _walk(tree, "", out)
    return out


def _walk(node, prefix: str, out: List[Tuple[str, Any]]) -> None:
    if isinstance(node, dict):
        for k in sorted(node):
            _walk(node[k], f"{prefix}[{k!r}]", out)
    else:
        out.append((prefix, node))


def tree_leaves(tree: PyTree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)]


def tree_unflatten(like: PyTree, leaves: Sequence[Any]) -> PyTree:
    """A nested dict shaped like ``like`` holding ``leaves`` in flat order."""
    it = iter(leaves)
    out = _build(like, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def _build(node, it):
    if isinstance(node, dict):
        return {k: _build(node[k], it) for k in sorted(node)}
    return next(it)


# ---------------------------------------------------------------------------
# the static plan
# ---------------------------------------------------------------------------


def default_lowrank_filter(path: str, shape: Tuple[int, ...], cfg: OptimizerConfig) -> bool:
    if cfg.method == "full":
        return False
    if len(shape) < 2:
        return False
    if min(shape[-2], shape[-1]) < cfg.min_dim:
        return False
    low = path.lower()
    return not any(pat in low for pat in cfg.exclude)


def build_specs(
    params: PyTree,
    cfg: OptimizerConfig,
    lowrank_filter: Optional[Callable[[str, Tuple[int, ...]], bool]] = None,
) -> List[LeafSpec]:
    """Static plan: one LeafSpec per param leaf, in flat order."""
    specs = []
    n_lowrank = 0
    for ps, leaf in flatten_with_path(params):
        shape = tuple(leaf.shape)
        if lowrank_filter is not None:
            lowrank = lowrank_filter(ps, shape)
        else:
            lowrank = default_lowrank_filter(ps, shape, cfg)
        if lowrank:
            side = proj_lib.projection_side(shape)
            group = n_lowrank % max(cfg.refresh_groups, 1)
            base_rank = cfg.group_ranks[group] if cfg.group_ranks else cfg.rank
            rank = min(base_rank, proj_lib.projector_dim(shape))
            n_lowrank += 1
        else:
            side, rank, group = "left", 0, 0
        specs.append(LeafSpec(ps, lowrank, side, rank, group))
    return specs


class TPPlan(NamedTuple):
    """Tensor parallelism of an optimizer: the ``model`` axis
    (``launch/mesh.DPAxes``) and, per leaf in flat order, the dim of the
    global leaf split over it (None: whole); under FSDP the same over
    ``data`` (``data_axes`` None: no FSDP)."""

    axes: Any
    splits: Tuple[Optional[int], ...]
    data_axes: Any = None
    data_splits: Optional[Tuple[Optional[int], ...]] = None

    def pairs(self) -> List[Tuple[Optional[int], Optional[int]]]:
        """Per leaf, (``data`` dim, ``model`` dim): ``launch/sharding``'s
        ``param_splits``."""
        ds = self.data_splits or (None,) * len(self.splits)
        return list(zip(ds, self.splits))

    def leaf_axes(self, i: int) -> Tuple[Any, ...]:
        """The axes leaf ``i`` is split over, ``data`` first."""
        out = ()
        if self.data_splits is not None and self.data_splits[i] is not None:
            out += (self.data_axes,)
        if self.splits[i] is not None:
            out += (self.axes,)
        return out


class LowRankOptimizer(NamedTuple):
    """(init, update, specs).  ``bucket_plan`` is the static bucketing
    (None for the reference engine); ``state_layout`` is non-None iff the
    state is stored bucket-native.  ``likes`` are the leaves' shapes and
    dtypes in flat order (this process's blocks under ``tp``)."""

    init: Callable[[PyTree], LowRankOptState]
    update: Callable[..., Tuple[PyTree, LowRankOptState, AuxInfo]]
    specs: List[LeafSpec]
    config: OptimizerConfig
    bucket_plan: Optional[buckets_lib.BucketPlan] = None
    state_layout: Optional[buckets_lib.StateLayout] = None
    likes: Tuple[Any, ...] = ()
    tp: Optional[TPPlan] = None


def _placeholder(device) -> LeafState:
    return LeafState(projector=torch.zeros((), dtype=torch.float32, device=device), inner=None)


def _global_norm(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))


def _tp_norm(values: Sequence[torch.Tensor], split_axes: Sequence[Tuple[Any, ...]], shard_axes,
             n_rows: int, order: Sequence[Any], squared: bool = False) -> torch.Tensor:
    """The global norm of blocks: the squares of each value summed over
    every axis that splits it (``split_axes``, per value), whole ones
    counted once; the first ``n_rows`` values are a ZeRO shard's rows,
    summed over ``shard_axes`` too.  One scalar collective per axis, in
    ``order`` (``shard_axes`` first): the values that still need an axis
    are summed over it and then join those of the same remaining axes.
    ``values`` are tensors, or their squared norms with ``squared``."""
    sqs = [v if squared else torch.sum(torch.square(v.float())) for v in values]
    groups: Dict[Tuple[Any, ...], torch.Tensor] = {}
    for i, (q, axs) in enumerate(zip(sqs, split_axes)):
        key = ((shard_axes,) if shard_axes is not None and i < n_rows else ()) + tuple(axs)
        groups[key] = groups[key] + q if key in groups else q
    for ax in ((shard_axes,) if shard_axes is not None else ()) + tuple(order):
        keys = [k for k in groups if any(a is ax for a in k)]
        if not keys:
            continue
        vec = ax.all_reduce_scalars(torch.stack([groups.pop(k).reshape(()) for k in keys]))
        for j, k in enumerate(keys):
            rest = tuple(a for a in k if a is not ax)
            groups[rest] = groups[rest] + vec[j] if rest in groups else vec[j]
    zero = torch.zeros((), dtype=torch.float32, device=sqs[0].device)
    return torch.sqrt(sum(groups.values(), zero))


def _safe_ratio(num: torch.Tensor, den: torch.Tensor,
                cut: Optional[inner_lib.Cut] = None) -> torch.Tensor:
    """||num|| / (||den|| + 1e-12), one scalar over the whole leaf (all its
    stacked slices), as ``src/repro/core/lowrank.py:941``; blocks of a
    ``cut`` leaf sum their squares over the axes that cut it."""
    if cut is None or not cut.dims:
        nn = torch.linalg.vector_norm(num.float().reshape(-1))
        dd = torch.linalg.vector_norm(den.float().reshape(-1))
        return nn / (dd + 1e-12)
    sq = torch.stack([torch.sum(num.float() ** 2), torch.sum(den.float() ** 2)])
    for _, ax in cut.dims:
        ax.all_reduce_(sq)
    return torch.sqrt(sq[0]) / (torch.sqrt(sq[1]) + 1e-12)


def _validate(cfg: OptimizerConfig) -> None:
    if cfg.method not in ("full",) + proj_lib.METHODS:
        raise ValueError(f"unknown method {cfg.method!r}")
    if cfg.state_sharding not in ("", "zero"):
        raise ValueError(f"unknown state_sharding {cfg.state_sharding!r}")
    if cfg.state_sharding == "zero" and cfg.state_shards < 1:
        raise ValueError(f"state_shards must be >= 1, got {cfg.state_shards}")
    if cfg.group_ranks:
        if len(cfg.group_ranks) != max(cfg.refresh_groups, 1):
            raise ValueError(
                f"group_ranks has {len(cfg.group_ranks)} entries for "
                f"{max(cfg.refresh_groups, 1)} refresh groups"
            )
        if any(r < 1 for r in cfg.group_ranks):
            raise ValueError(f"group_ranks must all be >= 1: {cfg.group_ranks}")
    if cfg.rank_schedule:
        # fail at build time, not at the first refresh boundary
        RankSchedule.parse(cfg.rank_schedule)


def make_lowrank_optimizer(
    cfg: OptimizerConfig,
    params_like: PyTree,
    lowrank_filter: Optional[Callable[[str, Tuple[int, ...]], bool]] = None,
) -> LowRankOptimizer:
    """Build the optimizer for a concrete parameter structure."""
    _validate(cfg)
    if cfg.momentum_carry not in ("keep", "reset", "reproject"):
        raise ValueError(f"unknown momentum_carry {cfg.momentum_carry!r}")
    if cfg.engine not in ("reference", "bucketed"):
        raise ValueError(f"unknown engine {cfg.engine!r}")
    if cfg.rank < 1:
        raise ValueError(f"rank must be >= 1, got {cfg.rank}")
    specs = build_specs(params_like, cfg, lowrank_filter)
    return _assemble(cfg, specs, tree_leaves(params_like))


def tensor_parallel_optimizer(optimizer: "LowRankOptimizer", mesh,
                              fsdp: bool = False) -> "LowRankOptimizer":
    """The optimizer of this process's blocks under ``mesh``'s ``model``
    axis (module docstring) and, with ``fsdp``, its ``data`` axis: the
    global optimizer's specs, its leaves cut by
    ``launch/sharding.param_spec``.  The optimizer itself where no leaf is
    cut."""
    from repro_torch.launch import sharding as shd

    ax = mesh.model_axes()
    dax = mesh.data_axes() if fsdp else None
    pairs = [shd.leaf_splits(spec.path, tuple(like.shape), mesh, fsdp)
             for spec, like in zip(optimizer.specs, optimizer.likes)]
    if ax.size == 1 and all(dd is None for dd, _ in pairs):
        return optimizer
    cfg = optimizer.config
    likes = []
    for (dd, md), like in zip(pairs, optimizer.likes):
        shape = tuple(like.shape)
        for d, size in ((dd, dax.size if dax is not None else 1), (md, ax.size)):
            if d is not None:
                shape = shape[:d] + (shape[d] // size,) + shape[d + 1:]
        likes.append(buckets_lib._Like(shape, like.dtype))
    plan = TPPlan(ax, tuple(md for _, md in pairs), dax,
                  tuple(dd for dd, _ in pairs) if fsdp else None)
    return _assemble(cfg, optimizer.specs, likes, plan)


def _assemble(cfg: OptimizerConfig, specs: List[LeafSpec], flat_like: Sequence,
              tp: Optional[TPPlan] = None) -> "LowRankOptimizer":
    """The optimizer of ``specs`` over leaves shaped like ``flat_like``
    (with ``tp``, this process's blocks of the global leaves the specs
    were made from)."""
    inner = cfg.make_inner()
    pcfg = cfg.projector_config()
    groups = max(cfg.refresh_groups, 1)
    likes = tuple(buckets_lib._Like(tuple(x.shape), x.dtype) for x in flat_like)
    tp_axes = tp.axes if tp is not None else None
    tp_split = tp.splits if tp is not None else (None,) * len(specs)
    fsdp_axes = tp.data_axes if tp is not None else None
    dp_split = tp.data_splits if tp is not None and tp.data_splits else (None,) * len(specs)
    # the axes that split some leaf, in the norms' reduction order
    norm_axes = tuple(a for a in (fsdp_axes, tp_axes) if a is not None)

    def bucket_axes(bk, projected: bool) -> Tuple[Any, ...]:
        """The axes a bucket's stack is split over: its R stack is whole
        over an axis that cuts its d once reduced (``projected``)."""
        out = ()
        for kind, ax in ((bk.dsplit, fsdp_axes), (bk.split, tp_axes)):
            if ax is not None and (kind in ("n", "b") or (kind == "d" and not projected)):
                out += (ax,)
        return out

    bucket_plan = None
    state_layout = None
    if cfg.engine == "bucketed":
        # adam_mini's per-row v and adam8bit's scales follow the per-leaf
        # rows, which transpose with the slices: their buckets split by side
        bucket_plan = buckets_lib.build_bucket_plan(
            specs, flat_like,
            split_sides=cfg.inner in buckets_lib.SIDE_HOMOGENEOUS_INNERS,
            tp_splits=tp_split, tp=tp_axes.size if tp_axes is not None else 1,
            dp_splits=dp_split, dp=fsdp_axes.size if fsdp_axes is not None else 1,
            tp_index=tp_axes.index if tp_axes is not None else 0,
            dp_index=fsdp_axes.index if fsdp_axes is not None else 0,
        )
        # bucket-native storage only where the fused engine covers every hot
        # step of every low-rank leaf: Adafactor (no fused update) and Fira
        # (the residual needs the full gradient per leaf) keep the plan for
        # accounting and run the per-leaf loop, as in JAX
        if bucket_plan.buckets and inner.fused_eligible and not cfg.fira:
            state_layout = buckets_lib.build_state_layout(
                bucket_plan, specs, flat_like, inner_name=cfg.inner,
                projector_dtype=cfg.projector_dtype,
                shards=cfg.state_shards if cfg.state_sharding == "zero" else 1,
                fsdp_rows=fsdp_axes is not None,
            )
    if cfg.state_sharding == "zero" and state_layout is None:
        raise ValueError(
            "state_sharding='zero' shards the bucket stacks, so it needs "
            "bucket-native state: engine='bucketed' with a fused inner "
            "(adam/msgd/adam8bit/adam_mini), no Fira, and at least one "
            "bucketed leaf"
        )
    # the leaves outside the buckets: the ``rest`` of ``StackedGrads``
    rest_indices = tuple(i for i in range(len(specs))
                         if bucket_plan is None or i not in bucket_plan.bucketed)

    def leaf_cuts(i: int, ndim: int) -> List[Tuple[str, int, Any]]:
        """(kind, dim, axes) of each axis that cuts leaf ``i``, ``data``
        first: kind ``buckets.tp_kind`` for a low-rank leaf, "" otherwise."""
        out = []
        for d, ax in ((dp_split[i], fsdp_axes), (tp_split[i], tp_axes)):
            if d is not None and ax is not None:
                out.append((buckets_lib.tp_kind(specs[i].side, d, ndim) if specs[i].lowrank
                            else "", d, ax))
        return out

    def inner_cut(i: int, x: torch.Tensor) -> Optional[inner_lib.Cut]:
        """The ``Cut`` of the tensor leaf ``i``'s inner gets (its R, whole
        along a d reduced over its axis; or its gradient)."""
        dims = tuple((d, ax) for kind, d, ax in leaf_cuts(i, x.dim()) if kind != "d")
        if not dims:
            return None
        shape = list(x.shape)
        for d, ax in dims:
            shape[d] *= ax.size
        return inner_lib.Cut(dims, tuple(shape))

    def init(params: PyTree) -> LowRankOptState:
        flat = tree_leaves(params)
        device = flat[0].device
        leaves = []
        for i, (spec, p) in enumerate(zip(specs, flat)):
            if spec.lowrank and state_layout is not None:
                leaves.append(_placeholder(device))  # lives in the stacks
            elif spec.lowrank:
                lead = tuple(p.shape[:-2])
                d = p.shape[-2] if spec.side == "left" else p.shape[-1]
                d_ax = next((ax for kind, _, ax in leaf_cuts(i, p.dim()) if kind == "d"), None)
                if d_ax is None:
                    eye = torch.eye(d, spec.rank, dtype=cfg.projector_dtype, device=device)
                else:  # this process's rows of the global eye
                    eye = torch.eye(d * d_ax.size, spec.rank, dtype=cfg.projector_dtype,
                                    device=device)[d_ax.index * d:(d_ax.index + 1) * d]
                proj = eye.expand(lead + (d, spec.rank)).clone()
                if spec.side == "left":
                    rshape = lead + (spec.rank, p.shape[-1])
                else:
                    rshape = lead + (p.shape[-2], spec.rank)
                z = torch.zeros(rshape, dtype=torch.float32, device=device)
                leaves.append(LeafState(projector=proj, inner=inner.init(z, inner_cut(i, z))))
            else:
                leaves.append(LeafState(
                    projector=torch.zeros((), dtype=torch.float32, device=device),
                    inner=inner.init(p, inner_cut(i, p)),
                ))
        bucket_states = (
            buckets_lib.init_bucket_states(state_layout, device,
                                           tp_axes.index if tp_axes is not None else 0,
                                           fsdp_axes.index if fsdp_axes is not None else 0)
            if state_layout is not None else ()
        )
        return LowRankOptState(
            step=0, draws=TorchDraws(cfg.seed, device), leaves=leaves,
            buckets=bucket_states,
        )

    def _lr_at(step: int) -> float:
        if cfg.lr_schedule is not None:
            return float(cfg.lr_schedule(step))
        return float(cfg.lr)

    def _leaf_draws(draws, i: int, spec: LeafSpec, g: torch.Tensor) -> proj_lib.LeafDraws:
        shape = tuple(g.shape)
        d = min(shape[-2], shape[-1])
        n = max(shape[-2], shape[-1])
        return draws.leaf(i, shape[:-2], proj_lib.draw_shapes(d, n, pcfg, spec.rank),
                          g.device)

    def _carry(spec: LeafSpec, st: LeafState, new_p: torch.Tensor,
               d_axes: Sequence[Any] = ()) -> Tuple[LeafState, torch.Tensor]:
        """The refreshed leaf's state and overlap; ``d_axes`` cut the
        projectors' d, so C = P_new^T P_old is summed over them."""
        old_p = st.projector
        c = torch.einsum("...dn,...do->...no", new_p, old_p)
        for ax in d_axes:
            ax.all_reduce_(c)
        overlap = torch.mean(torch.sum(c.float() ** 2, dim=(-2, -1)) / spec.rank)
        inner_state = st.inner
        if cfg.momentum_carry == "reset":
            inner_state = type(inner_state)(*[torch.zeros_like(x) for x in inner_state])
        elif cfg.momentum_carry == "reproject" and hasattr(inner_state, "m"):
            # 8-bit Adam's first moment lives as codes (Adam8bitState has
            # no ``.m``): no linear reprojection, as in JAX
            m = inner_state.m
            if spec.side == "left":
                m2 = torch.einsum("...no,...ok->...nk", c, m)
            else:
                m2 = torch.einsum("...ko,...no->...kn", m, c)
            inner_state = inner_state._replace(m=m2.to(m.dtype))
        return LeafState(projector=new_p, inner=inner_state), overlap

    def _refresh_fn(g, leaf_draws, old_p, spec):
        return proj_lib.refresh_projector(g, leaf_draws, old_p, pcfg, side=spec.side,
                                          rank=spec.rank)

    stacked_fn = split_fn = None
    if proj_lib.batched_refresh_supported(pcfg):
        def stacked_fn(gs, leaf_draws, old_ps, rank):
            return proj_lib.refresh_projector_stacked(gs, leaf_draws, old_ps, pcfg, rank=rank)

    if tp is not None and proj_lib.split_refresh_supported(pcfg):
        def split_fn(gs, leaf_draws, old_ps, rank, n_total, axes):
            return proj_lib.refresh_projector_stacked_split(
                gs, leaf_draws, old_ps, pcfg, rank=rank, n_total=n_total, axes=axes)

    def _tp_leaf_refresh(i: int, spec: LeafSpec, g: torch.Tensor, proj: torch.Tensor,
                         flat_g, draws, cuts) -> torch.Tensor:
        """This process's block of leaf ``i``'s refreshed projector: the
        buckets' routes (``buckets.bucketed_refresh``) on a bucket of the
        one leaf."""
        kinds = {ax: (kind, d) for kind, d, ax in cuts}
        mk, md = kinds.get(tp_axes, ("", None))
        dk, _ = kinds.get(fsdp_axes, ("", None))
        gs = buckets_lib._orient_in(g, spec.side)
        lead = tuple(g.shape[:-2])
        bk = buckets_lib.Bucket(
            d=gs.shape[1], n=gs.shape[2], rank=spec.rank,
            entries=(buckets_lib.BucketEntry(i, spec.side, gs.shape[0]),),
            split=mk, tp=tp_axes.size if mk else 1, lead_split=md if mk == "b" else -1,
            dsplit=dk, dp=fsdp_axes.size if dk else 1)
        like = buckets_lib._Like(lead + (bk.d, spec.rank), proj.dtype)
        layout = buckets_lib.StateLayout(
            buckets_lib.BucketPlan((bk,), frozenset((i,))), cfg.inner, False,
            {i: buckets_lib.LeafStateTemplate(like, None, None)}, proj.dtype)
        bst = buckets_lib.BucketState(proj.reshape((-1,) + tuple(proj.shape[-2:])), None, None)
        (new,), _ = buckets_lib.bucketed_refresh(
            layout, (bst,), specs, flat_g, draws, pcfg, _refresh_fn, group=spec.group,
            momentum_carry="keep", stacked_refresh_fn=stacked_fn, tp_axes=tp_axes,
            split_refresh_fn=split_fn, fsdp_axes=fsdp_axes)
        return new.projector.reshape(proj.shape)

    def _split_flags(stacked_in: bool, projected: bool) -> List[Tuple[Any, ...]]:
        """Per gradient tensor handed to the update (the leaves, or the
        bucket stacks then the rest): the axes it is a block over.  A "d"
        bucket's or leaf's R is whole once reduced."""
        if stacked_in:
            return ([bucket_axes(bk, projected) for bk in bucket_plan.buckets]
                    + [tp.leaf_axes(i) for i in rest_indices])
        return [tuple(ax for kind, _, ax in leaf_cuts(i, len(likes[i].shape))
                      if not (projected and kind == "d")) for i in range(len(specs))]

    def update(
        grads: PyTree,
        state: LowRankOptState,
        params: PyTree,
        *,
        refresh: bool,
        group: int = 0,
        projected: bool = False,
        apply: bool = False,
        skip_nonfinite: bool = False,
        shard_axes=None,
    ) -> Tuple[PyTree, LowRankOptState, AuxInfo]:
        """Returns (updates, or new params with ``apply=True``, new state,
        aux).  ``state`` is not modified.

        ``skip_nonfinite=True`` is the skip-step gate
        (``src/repro/core/lowrank.py:525-534, 848-867``): a non-finite
        element in any raw (pre-clip) gradient returns ``params`` (zero
        updates without ``apply``) and ``state`` themselves -- step, draw
        source, moments and projectors unchanged -- with ``aux.skipped =
        1``; otherwise the step is the ungated one, bit for bit.  JAX
        selects with ``jnp.where`` over the whole transition; here the
        verdict is fetched to the host once, after the backward and before
        any update kernel, and a bad step launches none of them: the new
        state is never made, so nothing is read twice to select it.  The
        verdict reads no gradient of its own on a good step: the raw
        gradients' global norm, which the step computes anyway, is finite
        unless an element is not or their squares overflow, and only a
        non-finite norm reads the gradients again (``all_finite``: JAX's
        per-bucket check, which reads the same elements) to tell the two
        apart.

        ``projected=True``: the low-rank gradients are already in R-space
        (``project_grads``, or the R stacks of ``project_grads_stacked``),
        reduced across processes by the data-parallel step; no projection
        runs.  Not with a refresh or Fira, which need the full gradient.
        ``grads`` may be ``StackedGrads`` (bucket-native optimizers): R
        stacks with ``projected=True``, full stacks with ``refresh=True``.

        ``shard_axes`` (a ZeRO optimizer, ``state_shards > 1``: the
        ``launch/mesh.DPAxes`` its stacks are sharded over): ``state.buckets``
        hold this process's block of rows.  A hot step takes the
        reduce-scattered block of every R stack, runs the fused update on
        those rows and all-gathers W'; a refresh gathers the state once,
        runs the replicated refresh and update, and keeps its rows again.
        The squared norms and the gate's verdict are summed across the
        processes (one scalar each), so every process skips or applies
        together.  Without ``shard_axes`` a ZeRO optimizer computes on the
        full padded stacks, which it unpads first and pads again after.
        On the FSDP step (``StateLayout.zero_rows``; ``shard_axes`` its
        ``data`` axis) the update takes the per-leaf gradients, its hot step
        runs the split schedule of ``buckets.bucketed_update`` and its
        refresh gathers the rows as above."""
        if projected and refresh:
            raise ValueError("projected gradients cannot drive a refresh step")
        if projected and cfg.fira:
            raise ValueError("Fira needs full-rank grads (residual term)")
        stacked_in = isinstance(grads, StackedGrads)
        if stacked_in:
            if state_layout is None:
                raise ValueError(
                    "StackedGrads need a bucket-native optimizer "
                    "(engine='bucketed' with a fused inner, no Fira)"
                )
            if not (projected or refresh):
                raise ValueError(
                    "StackedGrads hold R-space stacks (projected=True) or "
                    "full-rank refresh stacks (refresh=True); a plain hot "
                    "step takes the per-leaf gradient tree"
                )
            if (len(grads.buckets) != len(bucket_plan.buckets)
                    or len(grads.rest) != len(rest_indices)):
                raise ValueError(
                    "StackedGrads shape mismatch: expected "
                    f"{len(bucket_plan.buckets)} bucket stacks + "
                    f"{len(rest_indices)} rest leaves, got "
                    f"{len(grads.buckets)} + {len(grads.rest)}"
                )
        zero_layout = state_layout is not None and state_layout.shards > 1
        shard_local = zero_layout and shard_axes is not None
        fsdp_zero = shard_local and bool(state_layout.zero_rows)
        # the compressed ZeRO hot step: its gradients are blocks of rows
        rows_in = shard_local and not refresh and not fsdp_zero
        if shard_axes is not None and not zero_layout:
            raise ValueError(
                "shard_axes is only meaningful for a zero-sharded "
                "optimizer (state_sharding='zero', state_shards > 1)"
            )
        if shard_local and not stacked_in and not fsdp_zero:
            raise ValueError(
                "shard-local updates take StackedGrads (the reduce-"
                "scattered hot payload or full refresh stacks)"
            )
        if state_layout is not None and not state.buckets:
            raise ValueError("bucket-native optimizer got a per-leaf state")
        given = state  # what a skipped step returns
        shard_index = None
        if zero_layout and not shard_local:
            # the replicated representation: compute on the unpadded stacks
            state = state._replace(buckets=buckets_lib.zero_unpad_states(
                state_layout, state.buckets))
        if shard_local:
            shard_index = buckets_lib.zero_shard_index(shard_axes)
            if refresh:
                # gather once, refresh and update replicated, keep the rows
                full = buckets_lib.zero_gather_states(state.buckets, shard_axes, state_layout)
                state = state._replace(
                    buckets=buckets_lib.zero_unpad_states(state_layout, full))
                del full
        step = state.step + 1  # 1-indexed for bias correction
        lr = _lr_at(state.step)
        flat_p = tree_leaves(params)
        if stacked_in:
            # the bucketed leaves' gradients live in the stacks
            flat_g: List[Optional[torch.Tensor]] = [None] * len(specs)
            for j, i in enumerate(rest_indices):
                flat_g[i] = grads.rest[j]
            stacked_g: Optional[List[torch.Tensor]] = list(grads.buckets)
            every_g = list(grads.buckets) + list(grads.rest)
        else:
            flat_g = tree_leaves(grads)
            stacked_g = None
            every_g = flat_g
        if tp is not None:
            gnorm = _tp_norm(every_g, _split_flags(stacked_in, projected),
                             shard_axes if rows_in else None,
                             len(stacked_g) if stacked_in else 0, norm_axes)
        elif rows_in:
            # disjoint blocks of rows: the global norm is the summed local
            # squares (pad rows are zero) plus the replicated rest's
            bsq = sum(torch.sum(torch.square(x.float())) for x in stacked_g)
            bsq = shard_axes.all_reduce_scalars(bsq.reshape(1))[0]
            gnorm = torch.sqrt(bsq + sum((torch.sum(torch.square(g.float())) for g in grads.rest),
                                         torch.zeros((), device=bsq.device)))
        else:
            gnorm = _global_norm(every_g)
        skipped = None
        if skip_nonfinite:
            # on the raw (pre-clip) gradients: a NaN norm would make the clip
            # scale poison every leaf; ``bool`` is the gate's one host sync.
            # The norm is the same number on every process; a shard's own
            # check of its rows is summed across them, so all agree.
            bad = not bool(torch.isfinite(gnorm)) and not bool(buckets_lib.all_finite(every_g))
            if (shard_local or tp is not None) and not bool(torch.isfinite(gnorm)):
                flag = torch.full((1,), float(bad), device=gnorm.device)
                for ax in (shard_axes if shard_local else None,) + norm_axes:
                    if ax is not None:
                        flag = ax.all_reduce_scalars(flag)
                bad = bool(flag[0] > 0)
            if bad:
                nan = torch.full((), float("nan"), device=gnorm.device)
                out = params if apply else tree_unflatten(
                    params, [torch.zeros_like(p) for p in flat_p])
                return out, given, AuxInfo(
                    grad_norm=gnorm, update_norm=nan,
                    mean_refresh_overlap=nan if refresh else torch.zeros_like(nan),
                    skipped=torch.ones_like(nan))
            skipped = torch.zeros((), dtype=torch.float32, device=gnorm.device)
        if cfg.grad_clip_norm and cfg.grad_clip_norm > 0:
            scale = torch.clamp(cfg.grad_clip_norm / (gnorm + 1e-12), max=1.0)
            flat_g = [None if g is None else g * scale.to(g.dtype) for g in flat_g]
            if stacked_g is not None:
                stacked_g = [g * scale.to(g.dtype) for g in stacked_g]
        del every_g
        draws = state.draws.split() if refresh else state.draws
        g_now = group % groups

        overlaps: List[torch.Tensor] = []
        fused: Dict[int, torch.Tensor] = {}
        new_buckets = state.buckets
        bucket_norm_sq: List[torch.Tensor] = []
        if state_layout is not None:
            if refresh:
                new_buckets, bucket_overlaps = buckets_lib.bucketed_refresh(
                    state_layout, state.buckets, specs, flat_g, draws,
                    pcfg, _refresh_fn, group=g_now,
                    momentum_carry=cfg.momentum_carry, stacked_refresh_fn=stacked_fn,
                    stacked_grads=stacked_g, tp_axes=tp_axes, split_refresh_fn=split_fn,
                    fsdp_axes=fsdp_axes,
                )
                overlaps.extend(bucket_overlaps)
            if rows_in:
                # this process's rows of every W stack through the fused
                # update, then the one gather of W'
                local_w = buckets_lib.zero_local_param_stacks(state_layout, flat_p, shard_index)
                out_stacks, new_buckets, bucket_norm_sq = buckets_lib.bucketed_update(
                    bucket_plan, cfg, new_buckets, flat_g, flat_p, step, lr, apply=apply,
                    projected=projected, stacked_grads=stacked_g, stacked_params=local_w,
                    out_stacked=True, tp_axes=tp_axes, fsdp_axes=fsdp_axes,
                )
                del local_w
                full_stacks = buckets_lib.zero_gather_stacks(state_layout, out_stacks,
                                                             shard_axes)
                del out_stacks
                fused = buckets_lib.zero_scatter_outputs(bucket_plan, full_stacks, flat_p)
                del full_stacks
            else:
                fused, new_buckets, bucket_norm_sq = buckets_lib.bucketed_update(
                    bucket_plan, cfg, new_buckets, flat_g, flat_p, step, lr, apply=apply,
                    projected=projected, stacked_grads=stacked_g, tp_axes=tp_axes,
                    fsdp_axes=fsdp_axes,
                    zero_rows=(shard_axes, state_layout) if fsdp_zero and not refresh else None,
                )
        del stacked_g

        flat_out: List[torch.Tensor] = []
        norm_sq: List[torch.Tensor] = []
        new_leaves: List[LeafState] = []
        for i, (spec, st, g, p) in enumerate(zip(specs, state.leaves, flat_g, flat_p)):
            if i in fused:
                flat_out.append(fused[i])
                new_leaves.append(st)
                continue
            if not spec.lowrank:
                direction, inner_state = inner.update(g, st.inner, step, inner_cut(i, g))
                upd = -lr * direction
                if cfg.weight_decay:
                    upd = upd - lr * cfg.weight_decay * p.float()
                upd = upd.to(p.dtype)
                norm_sq.append(torch.sum(torch.square(upd.float())))
                flat_out.append((p + upd) if apply else upd)
                new_leaves.append(LeafState(st.projector, inner_state))
                continue
            cuts = leaf_cuts(i, g.dim())
            d_axes = [ax for kind, _, ax in cuts if kind == "d"]
            if refresh and spec.group == g_now:
                if cuts:
                    new_p = _tp_leaf_refresh(i, spec, g, st.projector, flat_g, draws, cuts)
                else:
                    new_p = proj_lib.refresh_projector(
                        g, _leaf_draws(draws, i, spec, g), st.projector, pcfg,
                        side=spec.side, rank=spec.rank,
                    ).to(st.projector.dtype)
                st, ov = _carry(spec, st, new_p, d_axes)
                overlaps.append(ov)
            proj = st.projector
            if projected:
                r_g = g.float()
            else:
                r_g = proj_lib.project(g.float(), proj, spec.side)
                for ax in d_axes:  # this process's rows of d: a partial sum
                    ax.all_reduce_(r_g)
            cut = inner_cut(i, r_g)
            direction, inner_state = inner.update(r_g, st.inner, step, cut)
            full_dir = proj_lib.backproject(direction.to(proj.dtype), proj, spec.side)
            upd = -lr * cfg.alpha * full_dir.float()
            if cfg.fira:
                # Fira: add the projection residual, scaled by the ratio of
                # the adapted direction's norm to the projected gradient's,
                # capped by the limiter (spike protection)
                s_res = g.float() - proj_lib.backproject(r_g, proj, spec.side).float()
                ratio = torch.clamp(_safe_ratio(direction, r_g, cut), max=cfg.fira_limiter)
                upd = upd - lr * cfg.alpha * ratio * s_res
                del s_res
            if cfg.weight_decay:
                upd = upd - lr * cfg.weight_decay * p.float()
            upd = upd.to(p.dtype)
            norm_sq.append(torch.sum(torch.square(upd.float())))
            flat_out.append((p + upd) if apply else upd)
            new_leaves.append(LeafState(proj, inner_state))

        zero = torch.zeros((), dtype=torch.float32, device=gnorm.device)
        if tp is not None:
            # blocks of split leaves summed over their axes, whole leaves once
            flags = [bucket_axes(bk, False) for bk in bucket_plan.buckets] \
                if bucket_norm_sq else []
            flags += [tp.leaf_axes(i) for i in range(len(specs)) if i not in fused]
            unorm = _tp_norm(list(bucket_norm_sq) + norm_sq, flags,
                             shard_axes if rows_in else None,
                             len(bucket_norm_sq), norm_axes, squared=True)
        else:
            bucket_sq = sum(bucket_norm_sq, zero)
            if rows_in:
                # disjoint blocks of rows: one scalar sum across the processes
                bucket_sq = shard_axes.all_reduce_scalars(bucket_sq.reshape(1))[0]
            unorm = torch.sqrt(sum(norm_sq, zero) + bucket_sq)
        mean_overlap = torch.mean(torch.stack(overlaps)) if overlaps else zero
        if zero_layout and not shard_local:
            new_buckets = buckets_lib.zero_pad_states(state_layout, new_buckets)
        elif shard_local and refresh:
            new_buckets = buckets_lib.zero_local_states(
                state_layout, buckets_lib.zero_pad_states(state_layout, new_buckets),
                shard_index)
        new_state = LowRankOptState(
            step=step, draws=draws, leaves=new_leaves, buckets=new_buckets
        )
        aux = AuxInfo(grad_norm=gnorm, update_norm=unorm, mean_refresh_overlap=mean_overlap,
                      skipped=zero if skipped is None else skipped)
        return tree_unflatten(params, flat_out), new_state, aux

    return LowRankOptimizer(
        init=init, update=update, specs=specs, config=cfg,
        bucket_plan=bucket_plan, state_layout=state_layout, likes=likes, tp=tp,
    )


def rebuild_at_rank(
    optimizer: LowRankOptimizer,
    params_like: PyTree,
    *,
    rank: Optional[int] = None,
    group_ranks: Optional[Tuple[int, ...]] = None,
    lowrank_filter: Optional[Callable] = None,
) -> LowRankOptimizer:
    """The same optimizer at a new global or per-group rank
    (``src/repro/core/lowrank.py:902``): fresh specs, bucket plan and
    state layout.  Live state does not carry over by itself: migrate it
    with ``core.rank_schedule.migrate_opt_state``.  ``lowrank_filter``
    must be the one the optimizer was built with (None: the default)."""
    kw: Dict[str, Any] = {}
    if rank is not None:
        kw["rank"] = rank
        kw["group_ranks"] = ()
    if group_ranks is not None:
        kw["group_ranks"] = tuple(group_ranks)
    if not kw:
        raise ValueError("rebuild_at_rank needs rank or group_ranks")
    cfg = dataclasses.replace(optimizer.config, **kw)
    return make_lowrank_optimizer(cfg, params_like, lowrank_filter)


def current_ranks(optimizer: LowRankOptimizer) -> Tuple[int, Tuple[int, ...]]:
    """(global rank, per-group ranks) the optimizer was built at: what a
    checkpoint's manifest meta carries, so a resume rebuilds the same
    bucket geometry before it loads."""
    cfg = optimizer.config
    groups = max(cfg.refresh_groups, 1)
    if cfg.group_ranks:
        return max(cfg.group_ranks), tuple(cfg.group_ranks)
    return cfg.rank, (cfg.rank,) * groups


# ---------------------------------------------------------------------------
# the data-parallel step's payloads
# ---------------------------------------------------------------------------


def project_grads(optimizer: LowRankOptimizer, grads: PyTree, state: LowRankOptState) -> PyTree:
    """The low-rank leaves' gradients in R-space under the current
    projectors (``src/repro/core/lowrank.py:947``), the others as they are:
    the per-leaf project-then-reduce payload.  P is the same on every
    process, so the sum of the projections is the projection of the sum.
    Under tensor parallelism a leaf whose d ``model`` cuts is summed over
    it, as the buckets' R is (``buckets.bucketed_project_grads``)."""
    stacked_projs: Dict[int, torch.Tensor] = {}
    layout = optimizer.state_layout
    if layout is not None and state.buckets:
        stacked_projs = buckets_lib.leaf_projectors(
            layout, buckets_lib.zero_unpad_states(layout, state.buckets))
    tp = optimizer.tp
    out = []
    for i, (spec, st, g) in enumerate(zip(optimizer.specs, state.leaves, tree_leaves(grads))):
        if spec.lowrank:
            proj = stacked_projs.get(i, st.projector)
            r = proj_lib.project(g.float(), proj, spec.side)
            if tp is not None and tp.splits[i] is not None \
                    and buckets_lib.tp_kind(spec.side, tp.splits[i], g.dim()) == "d":
                tp.axes.all_reduce_(r)
            out.append(r)
        else:
            out.append(g)
    return tree_unflatten(grads, out)


def _require_bucket_native(optimizer: LowRankOptimizer, what: str) -> None:
    if optimizer.state_layout is None:
        raise ValueError(
            f"{what} needs a bucket-native optimizer (engine='bucketed' "
            "with a fused inner, no Fira); the reference engine uses the "
            "per-leaf project_grads path"
        )


def _rest(optimizer: LowRankOptimizer, flat_grads: Sequence[torch.Tensor]) -> Tuple:
    bucketed = optimizer.bucket_plan.bucketed
    return tuple(g for i, g in enumerate(flat_grads) if i not in bucketed)


def project_grads_stacked(optimizer: LowRankOptimizer, grads: PyTree, state: LowRankOptState,
                          shard_axes=None) -> StackedGrads:
    """One f32 (B, r, n) R stack per bucket, from the bucket projector
    stacks (the projection kernel on the card), and the other leaves'
    gradients: the hot payload of the project-then-reduce step, handed to
    ``update(..., projected=True)`` once reduced (``lowrank.py:999``).  A
    ZeRO state's projectors are gathered first where ``shard_axes`` is
    given (every process projects all B rows of its own gradient before
    the reduce-scatter), or unpadded where it is not."""
    _require_bucket_native(optimizer, "project_grads_stacked")
    if not state.buckets:
        raise ValueError(
            "bucket-native optimizer got a canonical per-leaf state; "
            "convert with storage_opt_state(optimizer, state)"
        )
    layout = optimizer.state_layout
    flat_g = tree_leaves(grads)
    projectors = None
    if layout.shards > 1:
        if shard_axes is not None:
            projectors = buckets_lib.zero_gather_projectors(layout, state.buckets, shard_axes)
        else:
            projectors = [bst.projector
                          for bst in buckets_lib.zero_unpad_states(layout, state.buckets)]
    tp = optimizer.tp
    stacks = buckets_lib.bucketed_project_grads(
        layout.plan, state.buckets, flat_g, projectors=projectors,
        tp_axes=tp.axes if tp is not None else None,
        fsdp_axes=tp.data_axes if tp is not None else None)
    return StackedGrads(buckets=stacks, rest=_rest(optimizer, flat_g))


def stack_grads(optimizer: LowRankOptimizer, grads: PyTree) -> StackedGrads:
    """The full gradients in the bucket-native layout: one (B, d, n) stack
    per bucket and the other leaves (``lowrank.py:1049``), the refresh
    step's payload, which ``update(..., refresh=True)`` takes as it is."""
    _require_bucket_native(optimizer, "stack_grads")
    flat_g = tree_leaves(grads)
    stacks = buckets_lib.bucketed_stack_grads(optimizer.state_layout.plan, flat_g)
    return StackedGrads(buckets=stacks, rest=_rest(optimizer, flat_g))


# ---------------------------------------------------------------------------
# state-layout conversion: storage <-> canonical per-leaf (the checkpoint's)
# ---------------------------------------------------------------------------


def canonical_opt_state(optimizer: LowRankOptimizer, state: LowRankOptState) -> LowRankOptState:
    """Storage layout -> the canonical per-leaf layout, the one checkpoints
    hold (``src/repro/core/lowrank.py:1070``): each bucketed leaf gets its
    projector and inner state back, and ``buckets`` is empty, as a
    reference-engine state is.  A re-layout only (views, transposes and
    copies; codes and per-row v carried bit for bit), so a checkpoint from
    either engine resumes on the other.  A ZeRO state's pad rows are
    dropped first, so the checkpoint is the same at every shard count.
    No-op for a state that is already canonical."""
    layout = optimizer.state_layout
    if layout is None or not state.buckets:
        return state
    per_leaf = buckets_lib.bucketed_to_leaf_states(
        layout, buckets_lib.zero_unpad_states(layout, state.buckets))
    leaves = [LeafState(*per_leaf[i]) if i in per_leaf else st
              for i, st in enumerate(state.leaves)]
    return LowRankOptState(step=state.step, draws=state.draws, leaves=leaves, buckets=())


def storage_opt_state(optimizer: LowRankOptimizer, state: LowRankOptState) -> LowRankOptState:
    """The inverse of ``canonical_opt_state`` (``lowrank.py:1106``): stacks
    the bucketed leaves' state and leaves their per-leaf slots as ()
    placeholders.  No-op for per-leaf optimizers and bucket-native states."""
    layout = optimizer.state_layout
    if layout is None or state.buckets:
        return state
    bucket_states = buckets_lib.zero_pad_states(
        layout, buckets_lib.leaf_states_to_bucketed(layout, state.leaves))
    leaves = [_placeholder(st.projector.device) if i in layout.plan.bucketed else st
              for i, st in enumerate(state.leaves)]
    return LowRankOptState(step=state.step, draws=state.draws, leaves=leaves,
                           buckets=bucket_states)


# ---------------------------------------------------------------------------
# tensor parallelism: this process's blocks <-> the global canonical state
# ---------------------------------------------------------------------------


def _chunk_block(scale: torch.Tensor, n_total: int, ax) -> torch.Tensor:
    """This process's scales of 8-bit chunks along a row of ``n_total`` cut
    over ``ax``: the chunks its block of columns touches
    (``kernels/lowrank_update/quantize.py``)."""
    n = n_total // ax.size
    lo, hi = ax.index * n // qz.QBLOCK, qz.num_blocks(ax.index * n + n)
    return scale[..., lo:hi].clone()


def _chunk_gather(scale: torch.Tensor, n_total: int, ax) -> torch.Tensor:
    """The whole row's chunk scales from every process's: each writes its
    chunks into zeros and the largest is taken (a straddling chunk's scale
    is the same on the processes that share it; a scale is positive)."""
    n = n_total // ax.size
    out = scale.new_zeros(tuple(scale.shape[:-1]) + (qz.num_blocks(n_total),))
    lo = ax.index * n // qz.QBLOCK
    out[..., lo:lo + scale.shape[-1]] = scale
    return ax.all_reduce_(out, op="max")


def _inner_dims(st: Any, mdim: int, ndim: int) -> List[Optional[int]]:
    """Per field of a canonical inner state, the dim that a cut of its
    moments along ``mdim`` (a leaf of ``ndim`` dims) cuts, or None: every
    moment-shaped field along ``mdim``; Adam-mini's per-row v and
    Adafactor's row statistic (the moment without its last dim) along it
    unless it is the last; Adafactor's column statistic (without the
    second to last) along its own place of it; 8-bit Adam's scales
    (chunks of the last dim) along it, -1 meaning the chunks."""
    if isinstance(st, inner_lib.AdafactorState):
        vc = None if mdim == ndim - 2 else (mdim if mdim < ndim - 2 else ndim - 2)
        return [mdim, mdim if mdim < ndim - 1 else None, vc, None]
    if isinstance(st, inner_lib.AdamMiniState):
        return [mdim, mdim if mdim < ndim - 1 else None]
    if isinstance(st, inner_lib.Adam8bitState):
        sc = mdim if mdim < ndim - 1 else -1
        return [mdim, sc, mdim, sc]
    return [mdim if torch.is_tensor(x) and x.dim() == ndim else None for x in st]


def _map_tp_leaf(spec: LeafSpec, st: LeafState, split: Optional[int], ndim: int, ax,
                 gather: bool) -> LeafState:
    """A canonical per-leaf state with its tensors that are split over
    ``ax`` cut into this process's block, or (``gather``) joined from every
    process's: the projector along its d ("d") or its stack dim ("b"), the
    moments along the leaf's own split dim where that is not the projected
    one (a moment is the leaf's shape with the projected dim replaced by
    the rank), and the rest of the inner state as ``_inner_dims`` says.
    Other leaves' inner state is shaped like the param."""
    if split is None:
        return st

    def fn(x, dim):
        if gather:
            return ax.all_gather(x, dim=dim)
        n = x.shape[dim] // ax.size
        return x.narrow(dim, ax.index * n, n).clone()

    proj, mdim = st.projector, split
    if spec.lowrank:
        kind = buckets_lib.tp_kind(spec.side, split, ndim)
        if kind in ("d", "b"):
            proj = fn(proj, ndim - 2 if kind == "d" else split)
        mdim = None if kind == "d" else split
    if mdim is None or st.inner is None:
        return LeafState(proj, st.inner)
    n_total = None
    if isinstance(st.inner, inner_lib.Adam8bitState):
        n_total = st.inner.m_codes.shape[-1] * (ax.size if gather else 1)
    fields = []
    for x, dim in zip(st.inner, _inner_dims(st.inner, mdim, ndim)):
        if dim == -1:
            fields.append((_chunk_gather if gather else _chunk_block)(x, n_total, ax))
        else:
            fields.append(x if dim is None else fn(x, dim))
    return LeafState(proj, type(st.inner)(*fields))


def _tp_cuts(optimizer: LowRankOptimizer):
    """(axes, per-leaf split dims) of each axis of a
    ``tensor_parallel_optimizer``: ``model``, then ``data`` under FSDP."""
    tp = optimizer.tp
    out = [(tp.axes, tp.splits)]
    if tp.data_axes is not None:
        out.append((tp.data_axes, tp.data_splits))
    return out


def tp_global_opt_state(optimizer: LowRankOptimizer, state: LowRankOptState) -> LowRankOptState:
    """This process's state of a ``tensor_parallel_optimizer`` -> the global
    canonical per-leaf state, gathered over ``model``, then over ``data``
    under FSDP (every process gets it; the collectives run in leaf order on
    every process)."""
    canon = canonical_opt_state(optimizer, state)
    leaves = list(canon.leaves)
    for ax, splits in _tp_cuts(optimizer):
        leaves = [_map_tp_leaf(spec, st, d, len(like.shape), ax, gather=True)
                  for spec, st, d, like in zip(optimizer.specs, leaves, splits, optimizer.likes)]
    return canon._replace(leaves=leaves)


def tp_global_projectors(optimizer: LowRankOptimizer, state: LowRankOptState
                         ) -> Dict[str, torch.Tensor]:
    """{path: the global projector} of every low-rank leaf of this
    process's state of a ``tensor_parallel_optimizer`` (the projectors
    alone gathered, on every process): what the subspace metrics read."""
    canon = canonical_opt_state(optimizer, state)
    leaves = [LeafState(st.projector, None) for st in canon.leaves]
    for ax, splits in _tp_cuts(optimizer):
        leaves = [_map_tp_leaf(spec, st, d, len(like.shape), ax, gather=True)
                  for spec, st, d, like in zip(optimizer.specs, leaves, splits, optimizer.likes)]
    return {spec.path: st.projector for spec, st in zip(optimizer.specs, leaves) if spec.lowrank}


def tp_local_opt_state(optimizer: LowRankOptimizer, state: LowRankOptState) -> LowRankOptState:
    """The global canonical per-leaf state -> this process's blocks in the
    storage layout of ``optimizer`` (a ``tensor_parallel_optimizer``)."""
    leaves = list(state.leaves)
    for ax, splits in _tp_cuts(optimizer):
        leaves = [_map_tp_leaf(spec, st, d, len(like.shape), ax, gather=False)
                  for spec, st, d, like in zip(optimizer.specs, leaves, splits, optimizer.likes)]
    return storage_opt_state(optimizer, LowRankOptState(
        step=state.step, draws=state.draws, leaves=leaves, buckets=()))


def fsdp_hot_comm_bytes(optimizer: LowRankOptimizer, cfg, whole_over_data: bool = True) -> int:
    """Bytes one process hands the ``data`` collectives (``<kind>@data``)
    in a hot step of the FSDP step (``train/step.py``) of a model of any
    family (``cfg``: ``remat``, ``tie_embeddings``) under ``optimizer``,
    the ``tensor_parallel_optimizer`` of its blocks, counted from the
    shapes:

      each leaf split over ``data``: its gathered bytes (this process's
        block times the ``data`` extent) in the all-gather where it is
        used -- a block leaf in the layer's forward and again in its
        recomputation under ``remat="block"`` (the decoder's ``blocks`` and
        whisper's ``enc_blocks``), ``embed``, ``lm_head`` and llava's
        ``patch_in_proj`` once (a tied ``embed`` twice) -- and in the
        reduce-scatter of its
        gradient, once per gather that reaches the loss outside a
        recomputation;
      each leaf whole over ``data``: its gradient's all-reduce, counted
        under ``@data`` only where the batch axes are ``data`` alone
        (``whole_over_data``; with ``pod`` it is ``@pod+data``);
      each bucket whose d ``data`` cuts: its partial R, f32 (B, r, n).

    No counterpart in the reference (its collectives are GSPMD's);
    ``launch/mesh.COMM`` counts what the step hands them."""
    tp = optimizer.tp
    dp = tp.data_axes.size
    total = 0
    for spec, like, dsplit in zip(optimizer.specs, optimizer.likes, tp.data_splits):
        nbytes = int(np.prod(like.shape)) * torch.empty((), dtype=like.dtype).element_size()
        if dsplit is None:
            total += nbytes if whole_over_data else 0
            continue
        block = spec.path.startswith(("['blocks']", "['enc_blocks']"))
        uses = 2 if spec.path == "['embed']" and cfg.tie_embeddings else 1
        gathers = uses * (2 if block and cfg.remat == "block" else 1)
        total += (gathers + uses) * nbytes * dp
    return total + sum(bk.batch * bk.rank * bk.n * 4 for bk in optimizer.bucket_plan.buckets
                       if bk.dsplit == "d")


# ---------------------------------------------------------------------------
# the paper's memory claim
# ---------------------------------------------------------------------------


# Bytes of what the port keeps on the host and the reference keeps as
# arrays of its state: the int32 step and the two-word uint32 key.
HOST_STATE_BYTES = 4 + 8


def _tensors(node, out: List[torch.Tensor]) -> None:
    if isinstance(node, torch.Tensor):
        out.append(node)
    elif isinstance(node, (tuple, list)):  # NamedTuples too; None is skipped
        for x in node:
            _tensors(x, out)
    elif isinstance(node, dict):
        for k in sorted(node):
            _tensors(node[k], out)


def state_tensors(state: LowRankOptState) -> List[torch.Tensor]:
    """Every tensor of the state: the leaves' projectors (placeholders
    included) and inner states, then the bucket stacks."""
    out: List[torch.Tensor] = []
    _tensors(state.leaves, out)
    _tensors(state.buckets, out)
    return out


def state_memory_bytes(state: LowRankOptState) -> int:
    """Total bytes held in optimizer state (the paper's memory claim), as
    ``src/repro/core/lowrank.py:1140`` counts them: every tensor at its
    dtype's itemsize, plus the step and key that the reference holds as
    arrays (``HOST_STATE_BYTES``), so the two packages' totals are equal."""
    return HOST_STATE_BYTES + sum(t.numel() * t.element_size() for t in state_tensors(state))


def optimizer_memory_report(params: PyTree, state: LowRankOptState) -> Dict[str, float]:
    """Param bytes, state bytes and their ratio (full Adam: ~2)."""
    pbytes = sum(p.numel() * p.element_size() for p in tree_leaves(params))
    sbytes = state_memory_bytes(state)
    return {
        "param_bytes": float(pbytes),
        "opt_state_bytes": float(sbytes),
        "state_to_param_ratio": float(sbytes) / float(max(pbytes, 1)),
    }
