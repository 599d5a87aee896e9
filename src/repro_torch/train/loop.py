"""The training loop, from ``src/repro/train/loop.py``: the staggered
projector-refresh cadence and the history records.

Refresh group g refreshes at steps where step % (tau / groups) == 0,
cycling groups (``loop.py:493-507``); every other step is a hot step.
Checkpoints and resume, preemption, recovery, the spectrum logger,
heartbeats and re-bucketing come with their slices (ROADMAP queue 1
items 6, 9, 10).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core import lowrank as lowrank_lib
from repro_torch.train.state import TrainState


@dataclasses.dataclass
class TrainResult:
    state: TrainState
    history: List[Dict[str, Any]]
    final_step: int
    losses: List[float]


def train_loop(
    model,
    optimizer: lowrank_lib.LowRankOptimizer,
    data,
    train_cfg: TrainConfig,
    step_fns: Dict[str, Callable],
    *,
    state: Optional[TrainState] = None,
    log_every: int = 50,
) -> TrainResult:
    """Run ``train_cfg.total_steps`` steps from ``state`` (or from fresh
    params made by ``model.init`` with ``train_cfg.seed``, on the model's
    device).  ``data.batch_at(step)`` gives each step's batch."""
    tau = max(optimizer.config.tau, 1)
    groups = max(optimizer.config.refresh_groups, 1)
    sub_tau = max(tau // groups, 1)
    if state is None:
        gen = torch.Generator(device=model.device).manual_seed(train_cfg.seed)
        params = model.init(gen)
        state = TrainState(params, optimizer.init(params))
        del params  # the state owns them: the first step's output replaces them
    history: List[Dict[str, Any]] = []
    losses: List[float] = []
    for step in range(train_cfg.total_steps):
        batch = data.batch_at(step)
        if step % sub_tau == 0:
            group = (step // sub_tau) % groups
            state, m = step_fns["refresh_step"](state, batch, group=group)
        else:
            state, m = step_fns["step"](state, batch)
        loss = float(m["loss"])
        losses.append(loss)
        if step % log_every == 0 or step == train_cfg.total_steps - 1:
            history.append({
                "step": float(step),
                "loss": loss,
                "grad_norm": float(m["grad_norm"]),
                "update_norm": float(m["update_norm"]),
                "skipped": 0.0,
            })
    return TrainResult(
        state=state, history=history, final_step=train_cfg.total_steps, losses=losses
    )
