"""The train step, from ``src/repro/train/step.py``.

``make_train_step(model, optimizer, train_cfg=...)`` returns the hot step
and the refresh step, ``f(state, batch) -> (state, metrics)``; the caller
picks one on step % tau (``train/loop.py``).  A step takes the loss and
every param gradient through autograd (optionally accumulated over
microbatches in ``TrainConfig.accum_dtype``), then calls
``optimizer.update(..., apply=True)``: with ``engine="bucketed"`` the fused
update writes W' itself and no separate apply pass runs.

With ``mesh=`` (``launch/mesh.py``, one process per card) the step is data
parallel: it takes the global batch, runs its own rows of it
(``launch/sharding.shard_batch``) and reduces the gradients over the
batch axes before the update, each collective a sum divided by the
replica count as a Python float (gloo has no average; this is the
reference's psum-then-divide):

  * ``compressed=""`` -- every gradient leaf reduced full-rank, one
    collective per leaf, largest first (what the reference's SPMD step
    inserts);
  * ``compressed="flat"`` -- project-then-reduce over all the batch axes:
    the hot step reduces one f32 (B, r, n) R stack per bucket (d / r fewer
    bytes; P is the same on every process), the refresh one full (B, d, n)
    stack per bucket, each largest first, and the full-rank leaves;
  * ``compressed="pod"`` -- the same over the ``pod`` axis only, after a
    full-rank reduction over ``data`` within each pod.

With a ``model`` extent above 1 the step is also tensor (and, for MoE,
expert) parallel: each process holds its blocks of the params and of the
optimizer state, cut by the name-based rules (``launch/sharding``), runs
the model under its ``model`` axis (``models/parallel.use``: the layers'
collectives) and the optimizer of its blocks
(``core/lowrank.tensor_parallel_optimizer``).  Every family runs so: the
dense and MoE layers, the SSM mixer on its heads (``cfg.ssm_head_tp``) or
whole, hymba's two halves, whisper's cross-attention and llava's adapter
(``models/ssm.py``, ``hybrid.py``, ``encdec.py``, ``vlm.py``).

The standard step (``compressed=""``) at a ``data`` extent above 1 is FSDP
over ``data`` as well, the reference's standard step
(``src/repro/train/step.py:5-7``), for every family: each process holds
its ``data`` block of every leaf the rules put on ``data`` (and of its
optimizer state), the model gathers a block where it is used
(``models/parallel.DataShards``) and the block's gradient comes back
reduce-scattered, summed over ``data``: the step divides it by the batch
replica count and sums it over ``pod``, while the leaves whole over
``data`` are averaged over (pod, data) as before.  The compressed steps
keep the params whole over ``data``, as the reference's do.  ZeRO state on
the FSDP step (``state_sharding="zero"``, ``state_shards`` the ``data``
extent) keeps this process's rows of the moments of the buckets whose R is
whole over ``data`` (``core/buckets.StateLayout.zero_rows``): the hot step
reduce-scatters their partial R over ``data`` in place of the all-reduce,
updates its rows and all-gathers their direction N before each process
back-projects its block of W (``update(..., shard_axes=)``).
``fns["place_state"]`` cuts a global state into this process's blocks and
``fns["gather_state"]`` returns the global state (the given optimizer's
layout), which the loop's checkpoints hold.

Outside these, params stay replicated.  With ``state_sharding="zero"`` (``state_shards``
= the compressed axes' replica count) each process keeps only its rows of
the padded bucket stacks (``shard_train_state``): the hot step
reduce-scatters the R stacks and updates its rows (``update(...,
shard_axes=)``).  The loss and the metrics are averaged across the
processes, and ``metrics["bad_step"]`` is one summed verdict (any
process's non-finite loss, or a skipped update), so the loop's rollback
decision is the same on every process.

``recovery=`` (a ``RecoveryPolicy`` with ``skip_nonfinite_updates``) turns
on the skip-step gate of both steps; ``watchdog=`` (a
``CollectiveWatchdog``) guards each call; ``fns["rebuild"](new_optimizer)``
makes the same steps around an optimizer re-bucketed at a new rank.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Tuple

import torch
# ``torch.utils.checkpoint`` (block remat, the chunked loss) imports
# torch._dynamo at its first call, and that import makes a reference cycle
# through its frames (torch.fx's ``wrap``) that would pin the frames of
# the step running it -- its params and gradients -- until a full garbage
# collection.  Importing it here keeps that import out of every step.
import torch._dynamo  # noqa: F401

from repro_torch.configs.base import TrainConfig
from repro_torch.core import buckets as buckets_lib
from repro_torch.core import lowrank as lowrank_lib
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import axes_size, batch_axes
from repro_torch.models import parallel as par
from repro_torch.train.state import TrainState

def _value_and_grad(model, microbatch: int, accum_dtype=torch.float32, model_axes=None,
                    data_shards=None):
    """(params, batch) -> ((loss, metrics), grads), with optional gradient
    accumulation.  Accumulation sums per-microbatch gradients in
    ``accum_dtype`` and returns them cast back to the param dtype; the
    global batch must divide evenly into microbatches (``step.py:83-89``);
    ``microbatch >= batch`` is one microbatch, unaccumulated.  The forward
    and backward run under ``model_axes`` and ``data_shards``
    (``models/parallel.use``)."""

    def single(params, batch):
        leaves = lowrank_lib.tree_leaves(params)
        req = [p.detach().requires_grad_(True) for p in leaves]
        with par.use(model_axes, data_shards):
            loss, metrics = model.loss(lowrank_lib.tree_unflatten(params, req), batch)
            grads = torch.autograd.grad(loss, req)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return (loss.detach(), metrics), lowrank_lib.tree_unflatten(params, grads)

    if microbatch <= 0:
        return single

    def accumulated(params, batch):
        gb = next(iter(batch.values())).shape[0]
        if microbatch >= gb:
            n_micro, mb_size = 1, gb
        elif gb % microbatch != 0:
            raise ValueError(
                f"global batch {gb} is not divisible by microbatch "
                f"{microbatch}: {gb % microbatch} trailing samples would "
                "be silently dropped -- pick a microbatch that divides "
                "the batch"
            )
        else:
            n_micro, mb_size = gb // microbatch, microbatch
        leaves = lowrank_lib.tree_leaves(params)
        sums = [torch.zeros(p.shape, dtype=accum_dtype, device=p.device) for p in leaves]
        loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        metrics = {}
        for i in range(n_micro):
            micro = {k: v[i * mb_size:(i + 1) * mb_size] for k, v in batch.items()}
            (loss, metrics), grads = single(params, micro)
            for acc, g in zip(sums, lowrank_lib.tree_leaves(grads)):
                acc.add_(g.to(accum_dtype))
            loss_sum = loss_sum + loss
        grads = [(a / n_micro).to(p.dtype) for a, p in zip(sums, leaves)]
        return (loss_sum / n_micro, metrics), lowrank_lib.tree_unflatten(params, grads)

    return accumulated


def _split_grad_scale(batch):
    """(batch, scale): pops the ``grad_scale`` scalar that
    ``train/faults.py`` adds to a dict batch to inject non-finite gradients
    (token batches are integers, so they cannot carry a NaN); None when
    absent, and the gradients are then left as they are."""
    if isinstance(batch, dict) and "grad_scale" in batch:
        batch = dict(batch)
        return batch, batch.pop("grad_scale")
    return batch, None


def _largest_first(tensors) -> List[int]:
    """Dispatch order of the per-bucket collectives: the largest payload
    first, so the longest reduction starts earliest."""
    return sorted(range(len(tensors)), key=lambda i: (-tensors[i].numel(), i))


def _mean_(tensors, axes, n: float) -> None:
    """Average each tensor across ``axes`` in place, largest first: a sum,
    then a division by the replica count as a Python float."""
    for i in _largest_first(tensors):
        axes.all_reduce_(tensors[i]).div_(n)


def _pmean_stacked(sg: lowrank_lib.StackedGrads, axes, n: float) -> lowrank_lib.StackedGrads:
    """One collective per bucket stack (largest first) and one per leaf
    outside the buckets (``step.py:155``)."""
    _mean_(list(sg.buckets), axes, n)
    _mean_(list(sg.rest), axes, n)
    return sg


def _reduce_scatter_stacked(sg: lowrank_lib.StackedGrads, axes, n: float, layout
                            ) -> lowrank_lib.StackedGrads:
    """The ZeRO hot step's reduction (``step.py:170``): each bucket's R stack
    padded to the shardable batch, reduce-scattered over ``axes`` (largest
    first) and divided by the replica count, so each process keeps its own
    (B_pad / shards, r, n) rows; the other leaves averaged."""
    padded = list(buckets_lib.zero_pad_grad_stacks(layout, sg.buckets))
    for i in _largest_first(padded):
        padded[i] = axes.reduce_scatter(padded[i]).div_(n)
    _mean_(list(sg.rest), axes, n)
    return sg._replace(buckets=tuple(padded))


def _scale(grads, gscale):
    if gscale is None:
        return grads
    return lowrank_lib.tree_unflatten(grads, [
        g * torch.as_tensor(gscale, dtype=g.dtype, device=g.device)
        for g in lowrank_lib.tree_leaves(grads)])


def make_train_step(
    model,
    optimizer: lowrank_lib.LowRankOptimizer,
    *,
    mesh=None,
    train_cfg: Optional[TrainConfig] = None,
    compressed="",  # False/'' | True/'flat' | 'pod'
    recovery=None,  # Optional[repro_torch.train.recovery.RecoveryPolicy]
    watchdog=None,  # Optional[repro_torch.train.monitor.CollectiveWatchdog]
) -> Dict[str, Callable]:
    """Returns {'step': f(state, batch), 'refresh_step': f(state, batch,
    group=0), 'rebuild': f(new_optimizer) -> the same dict, ...}.
    The model's device decides where the step runs (``build_model``
    defaults to the card and raises without one unless asked for the CPU).

    ``mesh`` and ``compressed`` as in the module docstring; an unknown
    mode, a compressed mode without a mesh, ``"pod"`` without a pod axis,
    and a ZeRO optimizer whose ``state_shards`` is not the compressed
    axes' replica count raise, as in the reference.  ``fns["place_state"]``
    turns a state with the full stacks into the step's layout (this
    process's rows for a ZeRO compressed step), ``fns["gather_state"]``
    the other way.

    With ``recovery.skip_nonfinite_updates`` both steps gate the update
    (``optimizer.update(skip_nonfinite=True)``) and report
    ``metrics["skipped"]``; ``metrics["bad_step"]`` is 1 for a non-finite
    loss or a skipped update.  ``watchdog`` waits for each call's result
    and records calls past its timeout (keyed by the call's ordinal)."""
    global_optimizer = optimizer
    compressed = "flat" if compressed is True else (compressed or "")
    # FSDP over data: the standard step at a data extent above 1
    fsdp = mesh is not None and not compressed and mesh.shape.get("data", 1) > 1
    if fsdp and optimizer.config.state_sharding == "zero" \
            and optimizer.config.state_shards != mesh.dp:
        raise ValueError(
            f"state_sharding='zero' on the FSDP step shards over data: state_shards must be "
            f"the data extent {mesh.dp}, got {optimizer.config.state_shards}")
    if (mesh is not None and mesh.tp > 1) or fsdp:
        optimizer = lowrank_lib.tensor_parallel_optimizer(optimizer, mesh, fsdp=fsdp)
    # this process holds blocks of the leaves (over model, data or both)
    tp = optimizer.tp is not None
    data_split = tp and optimizer.tp.data_axes is not None and any(
        d is not None for d in optimizer.tp.data_splits)
    if compressed not in ("", "flat", "pod"):
        raise ValueError(
            f"unknown compressed mode {compressed!r}: expected "
            "False/''/True/'flat'/'pod'"
        )
    if compressed and mesh is None:
        raise ValueError(
            f"compressed={compressed!r} needs a mesh (the project-then-"
            "reduce schedule reduces over the DP axes)"
        )
    if compressed == "pod" and "pod" not in mesh.axis_names:
        raise ValueError(f"'pod' compression needs a pod axis; mesh has {mesh.axis_names}")
    layout = optimizer.state_layout
    zero = layout is not None and layout.shards > 1
    if zero and compressed:
        dp_names = ("pod",) if compressed == "pod" else batch_axes(mesh)
        n = axes_size(mesh, dp_names)
        if optimizer.config.state_shards != n:
            raise ValueError(
                f"state_sharding='zero' built with state_shards="
                f"{optimizer.config.state_shards}, but compressed="
                f"{compressed!r} reduces over DP axes {dp_names} of total "
                f"size {n}; the shard count must equal the DP replica count"
            )
    micro = train_cfg.microbatch if train_cfg else 0
    accum_dtype = (train_cfg.accum_dtype if train_cfg else None) or torch.float32
    shards = None
    if data_split:
        shards = par.DataShards(optimizer.tp.data_axes, {
            spec.path: d - len(like.shape) for spec, like, d in zip(
                global_optimizer.specs, global_optimizer.likes, optimizer.tp.data_splits)
            if d is not None})
    vg = _value_and_grad(model, micro, accum_dtype,
                         mesh.model_axes() if mesh is not None else None, shards)
    skip_nonfinite = bool(recovery is not None and recovery.skip_nonfinite_updates)
    # the reductions: over every batch axis (metrics, verdicts, the standard
    # step's gradients), the compressed axes, and a pod's data axis
    all_dp = mesh.axes(batch_axes(mesh)) if mesh is not None else None
    # FSDP: the gradients of the leaves split over data come back summed
    # over it, and are summed over pod only; the others over (pod, data)
    pod = mesh.axes(("pod",)) if data_split and "pod" in mesh.axis_names else None
    dsplit = [d is not None for d in optimizer.tp.data_splits] if data_split else None
    red = intra = None
    if compressed:
        red = mesh.axes(("pod",)) if compressed == "pod" else all_dp
        if compressed == "pod" and "data" in mesh.axis_names:
            intra = mesh.axes(("data",))
    shard_axes = red if zero and compressed else None
    # ZeRO on the FSDP step: the zero_rows buckets' moments, rows over data
    fsdp_zero = zero and bool(layout.zero_rows)
    if fsdp_zero:
        shard_axes = mesh.data_axes()
    local_rows = shard_axes is not None and mesh.distributed

    def local_loss_and_grads(state: TrainState, batch):
        batch, gscale = _split_grad_scale(batch)
        if mesh is not None:
            batch = shd.shard_batch(batch, mesh)
        (loss, metrics), grads = vg(state.params, batch)
        return loss, metrics, _scale(grads, gscale)

    def finish(loss, metrics, aux, params, opt_state):
        out_metrics = {
            **metrics,
            "grad_norm": aux.grad_norm,
            "update_norm": aux.update_norm,
            "refresh_overlap": aux.mean_refresh_overlap,
        }
        bad = (~torch.isfinite(loss)).float()
        if all_dp is not None and all_dp.group is not None:
            # one collective: every metric's mean and the summed verdict of
            # "my own loss went non-finite", clamped to a flag
            keys = sorted(metrics)
            vec = torch.stack([metrics[k].float().reshape(()) for k in keys] + [bad])
            vec = all_dp.all_reduce_scalars(vec)
            for j, k in enumerate(keys):
                out_metrics[k] = (vec[j] / all_dp.size).to(metrics[k].dtype)
            bad = torch.clamp(vec[-1], max=1.0)
        if skip_nonfinite:
            # the update's verdict is already the same on every process
            out_metrics["skipped"] = aux.skipped
            bad = torch.maximum(bad, aux.skipped)
        out_metrics["bad_step"] = bad
        return TrainState(params, opt_state), out_metrics

    def reduced_loss_and_grads(state: TrainState, batch):
        """(this process's loss, its metrics, the gradients averaged over
        the batch axes as the standard step's update takes them)."""
        loss, metrics, grads = local_loss_and_grads(state, batch)
        if dsplit is not None:
            flat = lowrank_lib.tree_leaves(grads)
            n = float(all_dp.size)
            _mean_([g for g, s in zip(flat, dsplit) if not s], all_dp, n)
            split = [g for g, s in zip(flat, dsplit) if s]
            if pod is not None and pod.group is not None:
                _mean_(split, pod, n)
            else:
                for g in split:
                    g.div_(n)
        elif all_dp is not None and all_dp.group is not None:
            _mean_(lowrank_lib.tree_leaves(grads), all_dp, float(all_dp.size))
        return loss, metrics, grads

    def step_fn(state: TrainState, batch, *, refresh: bool, group: int = 0):
        loss, metrics, grads = reduced_loss_and_grads(state, batch)
        params, opt_state, aux = optimizer.update(
            grads, state.opt_state, state.params, refresh=refresh,
            group=group, apply=True, skip_nonfinite=skip_nonfinite,
            shard_axes=shard_axes if local_rows else None,
        )
        del grads
        return finish(loss, metrics, aux, params, opt_state)

    def compressed_step_fn(state: TrainState, batch, *, refresh: bool, group: int = 0):
        loss, metrics, grads = local_loss_and_grads(state, batch)
        if intra is not None and intra.group is not None:
            # 'pod': the data axis reduces full-rank inside each pod first
            _mean_(lowrank_lib.tree_leaves(grads), intra, float(intra.size))
        n = float(red.size)
        if refresh:
            if layout is not None:
                # full-rank (B, d, n) stacks, one collective per bucket; the
                # refresh and the update take the reduced stacks as they are
                grads = _pmean_stacked(lowrank_lib.stack_grads(optimizer, grads), red, n)
            else:
                _mean_(lowrank_lib.tree_leaves(grads), red, n)
            params, opt_state, aux = optimizer.update(
                grads, state.opt_state, state.params, refresh=True, group=group,
                apply=True, skip_nonfinite=skip_nonfinite, shard_axes=shard_axes,
            )
        else:
            if layout is not None:
                # one f32 (B, r, n) R stack per bucket from the projector
                # stacks (gathered first in ZeRO); ZeRO keeps its rows
                rgrads = lowrank_lib.project_grads_stacked(
                    optimizer, grads, state.opt_state, shard_axes=shard_axes)
                del grads
                if shard_axes is not None:
                    rgrads = _reduce_scatter_stacked(rgrads, red, n, layout)
                else:
                    rgrads = _pmean_stacked(rgrads, red, n)
            else:
                rgrads = lowrank_lib.project_grads(optimizer, grads, state.opt_state)
                del grads
                _mean_(lowrank_lib.tree_leaves(rgrads), red, n)
            params, opt_state, aux = optimizer.update(
                rgrads, state.opt_state, state.params, refresh=False, projected=True,
                apply=True, skip_nonfinite=skip_nonfinite, shard_axes=shard_axes,
            )
            del rgrads
        return finish(loss, metrics, aux, params, opt_state)

    base = compressed_step_fn if compressed else step_fn
    fns: Dict[str, Callable] = {
        "step": functools.partial(base, refresh=False),
        "refresh_step": functools.partial(base, refresh=True),
    }
    if watchdog is not None:
        def guarded(fn):
            calls = [0]  # each step counts its own calls, as the reference's

            @functools.wraps(fn)
            def run(*a, **k):
                out = fn(*a, **k)
                watchdog.guard(calls[0], out)
                calls[0] += 1
                return out
            return run

        fns = {k: guarded(f) for k, f in fns.items()}
    fns["watchdog"] = watchdog
    fns["mesh"] = mesh
    # the standard step's gradients alone (not under a compressed mode)
    fns["grads"] = reduced_loss_and_grads
    fns["tp"] = tp
    fns["fsdp"] = data_split
    fns["optimizer"] = optimizer  # the one the steps run (this process's blocks)
    splits = optimizer.tp.pairs() if tp else None
    fns["splits"] = splits  # per leaf (data dim, model dim): launch/sharding.param_splits

    def place_state(state: TrainState) -> TrainState:
        """A global state (the given optimizer's layout, or canonical) ->
        the step's layout: this process's blocks under tensor parallelism
        and FSDP, then its rows of a ZeRO step's stacks."""
        if not (tp or local_rows):
            return state
        return shard_train_state(state, mesh, zero_dp_axes=shard_axes.names if local_rows
                                 else None, optimizer=global_optimizer, fsdp=fsdp)[0]

    def gather_state(state: TrainState) -> TrainState:
        """The inverse of ``place_state``: every process's rows gathered,
        then the blocks (the given optimizer's layout)."""
        if local_rows:
            full = buckets_lib.zero_gather_states(state.opt_state.buckets, shard_axes, layout)
            state = state._replace(opt_state=state.opt_state._replace(buckets=full))
        if tp:
            canon = lowrank_lib.tp_global_opt_state(optimizer, state.opt_state)
            state = TrainState(shd.gather_params(state.params, mesh, splits),
                               lowrank_lib.storage_opt_state(global_optimizer, canon))
        return state

    fns["place_state"] = place_state
    fns["gather_state"] = gather_state
    # the axes whose block of rows this process's state holds (None: the
    # full stacks): the loop's shard-parallel checkpoints write that block
    fns["zero_axes"] = shard_axes if local_rows and not tp else None

    def rebuild(new_optimizer: lowrank_lib.LowRankOptimizer) -> Dict[str, Callable]:
        """The same steps (mesh, mode, config, recovery, watchdog) around an
        optimizer re-bucketed at a new rank."""
        return make_train_step(model, new_optimizer, mesh=mesh, train_cfg=train_cfg,
                               compressed=compressed, recovery=recovery, watchdog=watchdog)

    fns["rebuild"] = rebuild
    return fns


def shard_train_state(state: TrainState, mesh, *,
                      zero_dp_axes: Optional[Tuple[str, ...]] = None, optimizer=None,
                      fsdp: bool = False):
    """(state, rows): under a ``model`` extent above 1 (or FSDP, ``fsdp``),
    first this process's blocks of a global state (``optimizer``, the
    global one, whose layout or the canonical one ``state`` is in; the
    rules of ``launch/sharding``); then with ``zero_dp_axes`` (a ZeRO optimizer's
    state), the state holding only this process's rows of every padded
    bucket stack (``launch/sharding.zero_state_rows``), each a copy of its
    own so the full stacks can be freed, and those rows per bucket; else
    the state as it is and None."""
    if mesh is not None and (mesh.tp > 1 or fsdp):
        if optimizer is None:
            raise ValueError("cutting a state into tensor-parallel blocks needs its optimizer")
        local = lowrank_lib.tensor_parallel_optimizer(optimizer, mesh, fsdp=fsdp)
        if local.tp is not None:
            canon = lowrank_lib.canonical_opt_state(optimizer, state.opt_state)
            state = TrainState(shd.shard_params(state.params, mesh, local.tp.pairs()),
                               lowrank_lib.tp_local_opt_state(local, canon))
            optimizer = local
    if not zero_dp_axes:
        return state, None
    if not state.opt_state.buckets:
        raise ValueError("zero_dp_axes given for a state without bucket stacks")
    axes = mesh.axes(zero_dp_axes)
    layout = optimizer.state_layout if optimizer is not None else None
    if layout is not None and layout.zero_rows:
        # the FSDP step's layout: the zero_rows buckets' moments only
        local = buckets_lib.zero_local_states(layout, state.opt_state.buckets, axes.index)
        rows = [(0, b.batch) if not layout.zero_rows[i] else
                (axes.index * x.m.shape[0], (axes.index + 1) * x.m.shape[0])
                for i, (b, x) in enumerate(zip(layout.plan.buckets, local))]
        return state._replace(opt_state=state.opt_state._replace(buckets=local)), rows
    rows = shd.zero_state_rows(state, axes)
    local = tuple(buckets_lib.BucketState(*[None if x is None else x[lo:hi].clone() for x in bst])
                  for (lo, hi), bst in zip(rows, state.opt_state.buckets))
    return state._replace(opt_state=state.opt_state._replace(buckets=local)), rows


# ---------------------------------------------------------------------------
# serve steps
# ---------------------------------------------------------------------------


def make_prefill_fn(model) -> Callable:
    """(params, batch) -> (logits, cache): the model's prefill."""

    def prefill_fn(params, batch):
        return model.prefill(params, batch)

    return prefill_fn


def make_decode_fn(model) -> Callable:
    """(params, cache, batch) -> (logits, cache): one decode step."""

    def decode_fn(params, cache, batch):
        return model.decode(params, cache, batch)

    return decode_fn
