"""Shared harness of the paper's tables and figures, from
``benchmarks/common.py``.

The paper's C4/SlimPajama LLaMA runs are reproduced on the synthetic
bigram corpus (``data/synthetic.py``) with the same optimizer matrix and
metrics: ``final loss - entropy floor`` plays the role of validation
perplexity, and the optimizer orderings and gap reductions are the claims.
The defaults are the reference's CPU scale (d_model 96, 2 layers, seq 64,
batch 8); ``bench_model``'s overrides and ``train_once``'s keywords run the
same matrix at a published width on the card.

Everything runs on the card unless ``device="cpu"`` is given.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.registry import get_config
from repro_torch.core import make_optimizer, optimizer_memory_report
from repro_torch.core.metrics import collect_projectors, subspace_overlap
from repro_torch.data.synthetic import SyntheticDataConfig, SyntheticDataset
from repro_torch.kernels import counters
from repro_torch.models import build_model
from repro_torch.train.state import TrainState
from repro_torch.train.step import make_train_step

Row = Tuple[str, float, str]  # (name, us_per_call, derived)

# The port's sidecar records: each names the device it was measured on.
JSON_RECORDS: List[Dict] = []


def record(
    op: str,
    wall_us: float,
    roofline_us: Optional[float] = None,
    engine: str = "reference",
    state_layout: str = "none",
    *,
    device: str,
    **extra,
) -> None:
    """Append one sidecar record.  ``engine``, ``state_layout`` ("bucketed"
    | "perleaf" | "none") and ``device`` (the card's name, or "cpu") are
    required metadata on every record."""
    JSON_RECORDS.append({
        "op": op,
        "wall_us": round(float(wall_us), 2),
        "roofline_us": round(float(roofline_us), 2) if roofline_us is not None else None,
        "engine": engine,
        "state_layout": state_layout,
        "device": device,
        **extra,
    })


def bench_model(d_model: int = 96, n_layers: int = 2, vocab: int = 512,
                device: str = "cuda", **overrides):
    """(cfg, model): the smoke llama3-8b at the reference's overrides, then
    ``overrides`` (a published width, a compute dtype)."""
    cfg = get_config("llama3-8b", smoke=True).with_(
        dtype=torch.float32, d_model=d_model, n_layers=n_layers,
        n_heads=4, head_dim=d_model // 4, n_kv_heads=2,
        d_ff=2 * d_model, vocab_size=vocab,
    ).with_(**overrides)
    return cfg, build_model(cfg, device=device)


def bench_data(cfg, seq: int = 64, batch: int = 8, seed: int = 3, dist: str = "bigram",
               device: str = "cuda") -> SyntheticDataset:
    return SyntheticDataset(
        SyntheticDataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
                            seed=seed, dist=dist),
        device=device,
    )


class SharedBatches:
    """A dataset's first ``steps`` batches, made once up front: every batch
    is a pure function of (seed, step), so the runs of a table share them,
    and ``train_once``'s time per step does not include making them."""

    def __init__(self, data: SyntheticDataset, steps: int):
        self.data = data
        self._batches = [data.batch_at(step) for step in range(steps)]

    def batch_at(self, step: int):
        return self._batches[step]

    def bigram_entropy(self) -> float:
        return self.data.bigram_entropy()


def _overlap(prev: Dict[str, torch.Tensor], cur: Dict[str, torch.Tensor]) -> float:
    """Mean over leaves of each leaf's mean adjacent overlap."""
    vals = [float(torch.mean(subspace_overlap(prev[k], cur[k]))) for k in cur]
    return sum(vals) / len(vals)


def train_once(
    model,
    data,
    opt_name: str,
    steps: int = 150,
    lr: float = 2e-3,
    rank: int = 8,
    tau: int = 20,
    seed: int = 0,
    track_overlap: bool = False,
    *,
    params=None,
    draws=None,
    **opt_kw,
) -> Dict:
    """Train ``steps`` steps from fresh params (a ``torch.Generator`` seeded
    with ``seed``, or ``params``), refreshing on ``step % tau == 0`` for
    every optimizer but ``adam``.  ``draws`` replaces the state's refresh
    draw source (a parity test hands in the reference's).  Returns the
    reference's keys, and ``engine`` (the state's layout: "bucketed" or
    "perleaf"), ``memory`` (``optimizer_memory_report`` at init, and on
    the card the caching allocator's growth over ``opt.init``) and
    ``launches`` (the kernels launched by the run)."""
    if params is None:
        params = model.init(torch.Generator(device=model.device).manual_seed(seed))
    kw = dict(lr=lr)
    if opt_name != "adam":
        kw.update(rank=rank, tau=tau, alpha=1.0)
    kw.update(opt_kw)
    opt = make_optimizer(opt_name, params, **kw)
    on_card = model.device.type == "cuda"
    before = torch.cuda.memory_allocated(model.device) if on_card else 0
    opt_state = opt.init(params)
    grown = torch.cuda.memory_allocated(model.device) - before if on_card else None
    memory = dict(optimizer_memory_report(params, opt_state), allocator_growth=grown)
    if draws is not None:
        opt_state = opt_state._replace(draws=draws)
    state = TrainState(params, opt_state)
    fns = make_train_step(model, opt)
    losses: List[torch.Tensor] = []
    overlaps: List[float] = []
    prev_proj = None
    launched = counters.snapshot()
    if on_card:
        torch.cuda.synchronize(model.device)
    t0 = time.perf_counter()
    for step in range(steps):
        batch = data.batch_at(step)
        if opt_name != "adam" and step % tau == 0:
            state, m = fns["refresh_step"](state, batch)
            if track_overlap:
                projs = collect_projectors(state.opt_state, opt.specs, opt.state_layout)
                # copies: the stacks the projectors view are updated in place
                cur = {k: v.detach().clone() for k, v in projs.items()}
                if prev_proj is not None:
                    overlaps.append(_overlap(prev_proj, cur))
                prev_proj = cur
        else:
            state, m = fns["step"](state, batch)
        losses.append(m["loss"].detach().float())  # read once, at the end
    host_losses = torch.stack(losses).tolist() if losses else []
    wall = time.perf_counter() - t0
    launches = {k: v - launched.get(k, 0) for k, v in counters.snapshot().items()
                if v != launched.get(k, 0)}
    return {
        "losses": host_losses,
        "final_loss": sum(host_losses[-10:]) / len(host_losses[-10:]),
        "us_per_step": wall / steps * 1e6,
        "overlaps": overlaps,
        "state": state,
        "optimizer": opt,
        "engine": "bucketed" if opt.state_layout is not None else "perleaf",
        "memory": memory,
        "launches": launches,
    }


def gap_reduction(full: float, base: float, ours: float) -> Optional[float]:
    """Paper's 'PPL gap reduction': (base-ours)/(base-full) when base>full."""
    if base <= full:
        return None
    return (base - ours) / (base - full) * 100.0
