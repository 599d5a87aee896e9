"""Deterministic fault injection for the training runtime, from
``src/repro/train/faults.py``.

A ``FaultPlan`` is a fixed list of ``FaultSpec`` entries and a seed.  Step
faults key on the loop's step (not the optimizer's, which stalls under a
skip or a rollback), checkpoint faults on the manager's save ordinal; each
spec has a firing budget (``times``, default 1), so a fault that recovery
absorbed does not fire again on the replayed steps.  Everything that fired
is logged in ``plan.fired``: the same specs and seed inject the same
faults.

Injection points, as in the reference:

  * ``batch_hook(batch, step)`` -- non-finite gradients: adds a
    ``grad_scale`` scalar (NaN or Inf) to the batch dict, which
    ``train/step.py`` pops and multiplies into the gradients.
  * ``loss_hook(step, metrics)`` -- a NaN or spiked loss in the metrics.
  * ``sleep_s(step)`` -- a slow step; ``preempt(step)`` -- a simulated
    SIGTERM; ``maybe_kill(step)`` -- ``ProcessKilled`` out of the loop.
  * ``checkpoint_io()`` -- a ``CheckpointIO`` that raises write errors from
    ``save_leaf`` and, after the commit, corrupts a leaf file or truncates
    the manifest.  The port writes the reference's on-disk format, and the
    corruption draws from ``np.random.default_rng(seed)`` over the same
    sorted ``.npy`` names, so one plan corrupts the same file at the same
    offset with the same bytes in both packages.

The shard kinds act on the shard-parallel format: ``ckpt_missing_shard`` /
``ckpt_corrupt_shard`` delete or flip bytes in one committed shard file
(a committed checkpoint with one shard invalid, which verification and
the fallback load must walk past), and ``ckpt_divergent_manifest`` makes
the last shard's manifest disagree at write time (the commit barrier must
refuse to merge it).
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.train import checkpoint as ckpt_lib

STEP_KINDS = (
    "nan_grads",  # grad_scale = NaN at `step`
    "inf_grads",  # grad_scale = Inf at `step`
    "nan_loss",  # reported loss = NaN at `step`
    "loss_spike",  # reported loss *= `value` at `step`
    "slow_step",  # host sleeps `value` seconds at `step`
    "preempt",  # simulated SIGTERM at `step`
    "kill_process",  # raise ProcessKilled at `step` (worker loss)
)
CKPT_KINDS = (
    "ckpt_write_error",  # save_leaf raises on save ordinal `save_index`
    "ckpt_corrupt_leaf",  # flip bytes in one committed leaf file
    "ckpt_truncate_manifest",  # truncate the committed manifest
    "ckpt_missing_shard",  # delete one committed shard row-block file
    "ckpt_corrupt_shard",  # flip bytes in one committed shard file
    "ckpt_divergent_manifest",  # mutate one per-shard manifest at write
)
KINDS = STEP_KINDS + CKPT_KINDS
# the kinds that act on the shard-parallel checkpoint format
SHARD_KINDS = ("ckpt_missing_shard", "ckpt_corrupt_shard", "ckpt_divergent_manifest")


class ProcessKilled(RuntimeError):
    """An injected worker death at a step.  The loop lets it through (a dead
    process cannot roll itself back); a restart resumes from the last
    committed checkpoint."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault.  ``step`` targets the step kinds, ``save_index`` the
    checkpoint kinds (the manager's save ordinal from 0; with recovery on,
    ordinal 0 is the loop's pinned checkpoint of the first step).
    ``value``: the spike factor of ``loss_spike``, the seconds of
    ``slow_step``.  ``times``: the firing budget; for ``ckpt_write_error``
    the failing attempts, so 1 fails once and the manager's retry lands."""

    kind: str
    step: int = -1
    save_index: int = -1
    value: float = float("nan")
    times: int = 1

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}: {KINDS}")
        if self.kind in STEP_KINDS and self.step < 0:
            raise ValueError(f"{self.kind} needs step >= 0")
        if self.kind in CKPT_KINDS and self.save_index < 0:
            raise ValueError(f"{self.kind} needs save_index >= 0")


class FaultPlan:
    """A seeded, replayable schedule of injected faults."""

    def __init__(self, specs=(), seed: int = 0):
        self.specs: Tuple[FaultSpec, ...] = tuple(specs)
        self.seed = seed
        self.fired: List[Tuple[str, int]] = []  # (kind, step or save_index)
        self._budget = [sp.times for sp in self.specs]

    def _take(self, kind: str, *, step: Optional[int] = None,
              save_index: Optional[int] = None) -> Optional[FaultSpec]:
        for idx, sp in enumerate(self.specs):
            if sp.kind != kind or self._budget[idx] <= 0:
                continue
            if step is not None and sp.step != step:
                continue
            if save_index is not None and sp.save_index != save_index:
                continue
            self._budget[idx] -= 1
            self.fired.append((kind, step if step is not None else int(save_index or 0)))
            return sp
        return None

    # ---- step faults (called by train_loop) ----

    def batch_hook(self, batch, step: int):
        """Arm non-finite gradients for ``step``: a ``grad_scale`` entry."""
        sp = self._take("nan_grads", step=step) or self._take("inf_grads", step=step)
        if sp is not None:
            if not isinstance(batch, dict):
                raise TypeError(f"{sp.kind} injection needs a dict batch to carry grad_scale")
            batch = dict(batch)
            batch["grad_scale"] = np.float32("nan" if sp.kind == "nan_grads" else "inf")
        return batch

    def loss_hook(self, step: int, metrics):
        """Poison the reported loss (the step itself ran as it was)."""
        sp = self._take("nan_loss", step=step)
        if sp is not None:
            metrics = dict(metrics)
            metrics["loss"] = np.float32("nan")
        sp = self._take("loss_spike", step=step)
        if sp is not None:
            metrics = dict(metrics)
            metrics["loss"] = metrics["loss"] * np.float32(sp.value)
        return metrics

    def sleep_s(self, step: int) -> float:
        sp = self._take("slow_step", step=step)
        return float(sp.value) if sp is not None else 0.0

    def preempt(self, step: int) -> bool:
        return self._take("preempt", step=step) is not None

    def maybe_kill(self, step: int) -> None:
        if self._take("kill_process", step=step) is not None:
            raise ProcessKilled(f"injected process loss at step {step}")

    # ---- checkpoint faults ----

    def checkpoint_io(self) -> "FaultyCheckpointIO":
        return FaultyCheckpointIO(self)


class FaultyCheckpointIO(ckpt_lib.CheckpointIO):
    """A ``CheckpointIO`` that injects the plan's checkpoint faults.  Write
    errors raise from ``save_leaf`` before any byte lands (the manager's
    retry starts again at ``begin``); a divergent shard manifest is written
    as it goes; corruption, deletion and truncation follow the commit, so
    the checkpoint is committed but invalid, the case the verified
    fallback of the load must walk past."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._ordinal = -1
        self._rng = np.random.default_rng(plan.seed)

    def begin(self, save_ordinal: int, attempt: int) -> None:
        self._ordinal = save_ordinal

    def save_leaf(self, fpath: str, arr) -> None:
        if self.plan._take("ckpt_write_error", save_index=self._ordinal) is not None:
            raise IOError(f"injected write error (save #{self._ordinal}, "
                          f"{os.path.basename(fpath)})")
        super().save_leaf(fpath, arr)

    def write_manifest(self, mpath: str, manifest) -> None:
        # the divergent manifest: the last shard's header names another
        # step, so shard 0's (the barrier's reference) stays clean
        if ckpt_lib._SHARD_MANIFEST_RE.match(os.path.basename(mpath)):
            if int(manifest.get("shard", -1)) == int(manifest.get("num_shards", 0)) - 1:
                if self.plan._take("ckpt_divergent_manifest",
                                   save_index=self._ordinal) is not None:
                    manifest = dict(manifest, step=int(manifest["step"]) + 1)
        super().write_manifest(mpath, manifest)

    def _corrupt_file(self, victim: str) -> None:
        size = os.path.getsize(victim)
        junk = self._rng.integers(0, 256, 16, dtype=np.uint8)
        with open(victim, "r+b") as f:
            f.seek(int(self._rng.integers(max(size - 16, 1))))
            f.write(junk.tobytes())

    def commit(self, tmp: str, final: str) -> None:
        super().commit(tmp, final)
        all_npy = sorted(f for f in os.listdir(final) if f.endswith(".npy"))
        shard_npy = [f for f in all_npy if ckpt_lib._SHARD_FILE_RE.search(f)]
        if self.plan._take("ckpt_corrupt_leaf", save_index=self._ordinal) is not None:
            self._corrupt_file(os.path.join(final, all_npy[int(self._rng.integers(len(all_npy)))]))
        if shard_npy and self.plan._take("ckpt_missing_shard",
                                         save_index=self._ordinal) is not None:
            os.remove(os.path.join(final, shard_npy[int(self._rng.integers(len(shard_npy)))]))
        if shard_npy and self.plan._take("ckpt_corrupt_shard",
                                         save_index=self._ordinal) is not None:
            self._corrupt_file(os.path.join(final,
                                            shard_npy[int(self._rng.integers(len(shard_npy)))]))
        if self.plan._take("ckpt_truncate_manifest", save_index=self._ordinal) is not None:
            mpath = os.path.join(final, ckpt_lib._MANIFEST)
            with open(mpath, "r+b") as f:
                f.truncate(max(os.path.getsize(mpath) // 2, 1))
