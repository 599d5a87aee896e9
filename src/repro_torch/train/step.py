"""The train step, from ``src/repro/train/step.py`` (single device).

``make_train_step(model, optimizer, train_cfg=...)`` returns the hot step
and the refresh step, ``f(state, batch) -> (state, metrics)``; the caller
picks one on step % tau (``train/loop.py``).  A step takes the loss and
every param gradient through autograd (optionally accumulated over
microbatches in ``TrainConfig.accum_dtype``), then calls
``optimizer.update(..., apply=True)``: with ``engine="bucketed"`` the fused
update writes W' itself and no separate apply pass runs.

``recovery=`` (a ``RecoveryPolicy`` with ``skip_nonfinite_updates``) turns
on the skip-step gate of both steps; ``watchdog=`` (a
``CollectiveWatchdog``) guards each call; ``fns["rebuild"](new_optimizer)``
makes the same steps around an optimizer re-bucketed at a new rank.  The
distributed flavours (compressed DP, ZeRO) come with their slice (ROADMAP
queue 1 item 11).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import torch
# ``torch.utils.checkpoint`` (block remat, the chunked loss) imports
# torch._dynamo at its first call, and that import makes a reference cycle
# through its frames (torch.fx's ``wrap``) that would pin the frames of
# the step running it -- its params and gradients -- until a full garbage
# collection.  Importing it here keeps that import out of every step.
import torch._dynamo  # noqa: F401

from repro_torch.configs.base import TrainConfig
from repro_torch.core import lowrank as lowrank_lib
from repro_torch.train.state import TrainState


def _value_and_grad(model, microbatch: int, accum_dtype=torch.float32):
    """(params, batch) -> ((loss, metrics), grads), with optional gradient
    accumulation.  Accumulation sums per-microbatch gradients in
    ``accum_dtype`` and returns them cast back to the param dtype; the
    global batch must divide evenly into microbatches (``step.py:83-89``);
    ``microbatch >= batch`` is one microbatch, unaccumulated."""

    def single(params, batch):
        leaves = lowrank_lib.tree_leaves(params)
        req = [p.detach().requires_grad_(True) for p in leaves]
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


def make_train_step(
    model,
    optimizer: lowrank_lib.LowRankOptimizer,
    *,
    train_cfg: Optional[TrainConfig] = None,
    recovery=None,  # Optional[repro_torch.train.recovery.RecoveryPolicy]
    watchdog=None,  # Optional[repro_torch.train.monitor.CollectiveWatchdog]
) -> Dict[str, Callable]:
    """Returns {'step': f(state, batch), 'refresh_step': f(state, batch,
    group=0), 'rebuild': f(new_optimizer) -> the same dict}.
    The model's device decides where the step runs (``build_model``
    defaults to the card and raises without one unless asked for the CPU).

    With ``recovery.skip_nonfinite_updates`` both steps gate the update
    (``optimizer.update(skip_nonfinite=True)``) and report
    ``metrics["skipped"]``; ``metrics["bad_step"]`` is 1 for a non-finite
    loss or a skipped update.  ``watchdog`` waits for each call's result
    and records calls past its timeout (keyed by the call's ordinal)."""
    micro = train_cfg.microbatch if train_cfg else 0
    accum_dtype = (train_cfg.accum_dtype if train_cfg else None) or torch.float32
    vg = _value_and_grad(model, micro, accum_dtype)
    skip_nonfinite = bool(recovery is not None and recovery.skip_nonfinite_updates)

    def step_fn(state: TrainState, batch, *, refresh: bool, group: int = 0):
        batch, gscale = _split_grad_scale(batch)
        (loss, metrics), grads = vg(state.params, batch)
        if gscale is not None:
            grads = lowrank_lib.tree_unflatten(grads, [
                g * torch.as_tensor(gscale, dtype=g.dtype, device=g.device)
                for g in lowrank_lib.tree_leaves(grads)])
        params, opt_state, aux = optimizer.update(
            grads, state.opt_state, state.params, refresh=refresh,
            group=group, apply=True, skip_nonfinite=skip_nonfinite,
        )
        del grads
        out_metrics = {
            **metrics,
            "grad_norm": aux.grad_norm,
            "update_norm": aux.update_norm,
            "refresh_overlap": aux.mean_refresh_overlap,
        }
        bad = (~torch.isfinite(loss)).float()
        if skip_nonfinite:
            out_metrics["skipped"] = aux.skipped
            bad = torch.maximum(bad, aux.skipped)
        out_metrics["bad_step"] = bad
        return TrainState(params, opt_state), out_metrics

    fns: Dict[str, Callable] = {
        "step": functools.partial(step_fn, refresh=False),
        "refresh_step": functools.partial(step_fn, refresh=True),
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

    def rebuild(new_optimizer: lowrank_lib.LowRankOptimizer) -> Dict[str, Callable]:
        """The same steps (config, recovery, watchdog) around an optimizer
        re-bucketed at a new rank."""
        return make_train_step(model, new_optimizer, train_cfg=train_cfg,
                               recovery=recovery, watchdog=watchdog)

    fns["rebuild"] = rebuild
    return fns


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
