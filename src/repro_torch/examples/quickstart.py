"""Quickstart on the port, from ``examples/quickstart.py``: pretrain a tiny
LLaMA with GaLore-SARA-Adam.

    PYTHONPATH=src python -m repro_torch.examples.quickstart                  # on the card
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

Checkpoints go to a fresh temporary directory, removed at the end, unless
``--ckpt-dir`` names one: a run there resumes from what it holds.
"""
from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import make_optimizer, optimizer_memory_report
from repro_torch.data.synthetic import SyntheticDataConfig, SyntheticDataset
from repro_torch.models import build_model, count_params
from repro_torch.train.loop import train_loop
from repro_torch.train.step import make_train_step


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)
    if args.ckpt_dir is not None:
        run(args.device, args.steps, args.ckpt_dir)
        return
    with tempfile.TemporaryDirectory(prefix="repro_quickstart_") as ckpt_dir:
        run(args.device, args.steps, ckpt_dir)


def run(device: str, steps: int, ckpt_dir: str) -> None:
    """Train ``steps`` steps on ``device``, checkpointing into ``ckpt_dir``
    every 50 steps (at the end of a shorter run)."""
    cfg = get_config("llama3-8b", smoke=True).with_(dtype=torch.float32)
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    print(f"model: {count_params(params) / 1e6:.2f}M params")

    # The paper's optimizer: importance-sampled low-rank subspace + Adam.
    opt = make_optimizer("galore-sara-adam", params, rank=8, tau=20, lr=2e-3, alpha=1.0)
    rep = optimizer_memory_report(params, opt.init(params))
    print(f"optimizer state/param ratio: {rep['state_to_param_ratio']:.2f} "
          f"(full Adam would be 2.0)")
    del params  # train_loop makes the same params from its seed and owns them

    data = SyntheticDataset(
        SyntheticDataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8),
        device=model.device)
    print(f"bigram entropy floor: {data.bigram_entropy():.3f}")

    tc = TrainConfig(total_steps=steps, checkpoint_every=min(50, steps),
                     checkpoint_dir=ckpt_dir)
    fns = make_train_step(model, opt, train_cfg=tc)
    res = train_loop(model, opt, data, tc, fns, log_every=20)
    if not res.losses:
        print(f"{ckpt_dir} is at step {res.final_step}: nothing to run")
        return
    print(f"loss: {res.losses[0]:.3f} -> {res.losses[-1]:.3f}")
    for rec in res.history:
        print({k: round(v, 4) for k, v in rec.items()})


if __name__ == "__main__":
    main()
