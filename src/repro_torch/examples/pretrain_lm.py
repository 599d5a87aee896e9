"""End-to-end pretraining example of the port, from ``examples/pretrain_lm.py``.

Presets:
  cpu-small  (default) -- ~10M-param LLaMA, 200 steps: checkpoints, the
                          step monitor, staggered SARA refresh and subspace
                          tracking, end to end.
  llama-60m             -- the paper's LLaMA-60M configuration (its Table 1
                          row), vocab cut to the synthetic corpus's.

    PYTHONPATH=src python -m repro_torch.examples.pretrain_lm --preset cpu-small \\
        --optimizer galore-sara-adam --steps 200              # on the card
    PYTHONPATH=src python -m repro_torch.examples.pretrain_lm --device cpu --steps 20

Runs on the card unless ``--device cpu`` is given.  It checkpoints a
quarter of the way through, four times, into ``--ckpt-dir``, and resumes
from there when run again with the same directory.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import make_optimizer
from repro_torch.core.schedules import cosine_with_warmup
from repro_torch.data.synthetic import SyntheticDataConfig, SyntheticDataset
from repro_torch.models import build_model, count_params
from repro_torch.train.loop import train_loop
from repro_torch.train.step import make_train_step

PRESETS = {
    # ~10M params
    "cpu-small": dict(
        n_layers=4, d_model=256, n_heads=8, n_kv_heads=4, head_dim=32,
        d_ff=688, vocab_size=2048, seq=128, batch=8, rank=32, tau=50,
    ),
    # the paper's LLaMA-60M (vocab reduced to the synthetic corpus size)
    "llama-60m": dict(
        n_layers=8, d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
        d_ff=1376, vocab_size=32100, seq=256, batch=32, rank=128, tau=200,
    ),
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="cpu-small", choices=list(PRESETS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--optimizer", default="galore-sara-adam")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_pretrain")
    ap.add_argument("--refresh-groups", type=int, default=1)
    args = ap.parse_args(argv)

    p = PRESETS[args.preset]
    cfg = ModelConfig(
        arch_id=f"llama-{args.preset}", family="dense",
        n_layers=p["n_layers"], d_model=p["d_model"], n_heads=p["n_heads"],
        n_kv_heads=p["n_kv_heads"], head_dim=p["head_dim"], d_ff=p["d_ff"],
        vocab_size=p["vocab_size"], dtype=torch.float32,
    )
    model = build_model(cfg, device=args.device)
    tc = TrainConfig(
        total_steps=args.steps, checkpoint_every=max(args.steps // 4, 1),
        checkpoint_dir=args.ckpt_dir, async_checkpoint=True,
    )
    params = model.init(torch.Generator(device=model.device).manual_seed(tc.seed))
    n_params = count_params(params)
    print(f"[pretrain] {n_params / 1e6:.1f}M params on {model.device}, "
          f"optimizer={args.optimizer}")

    kw = dict(
        lr=args.lr,
        lr_schedule=cosine_with_warmup(args.lr, args.warmup, args.steps),
        grad_clip_norm=1.0,
    )
    if args.optimizer != "adam":
        kw.update(rank=p["rank"], tau=p["tau"], alpha=0.25,
                  refresh_groups=args.refresh_groups)
    opt = make_optimizer(args.optimizer, params, **kw)
    del params  # train_loop makes the same params from tc.seed and owns them

    data = SyntheticDataset(
        SyntheticDataConfig(vocab_size=cfg.vocab_size, seq_len=p["seq"],
                            global_batch=p["batch"]),
        device=model.device,
    )
    fns = make_train_step(model, opt, train_cfg=tc)
    res = train_loop(
        model, opt, data, tc, fns, log_every=max(args.steps // 10, 1),
        track_subspace=(args.optimizer != "adam"),
    )
    if not res.losses:
        print(f"[pretrain] {args.ckpt_dir} is at step {res.final_step}: nothing to run")
        return
    print(f"[pretrain] final loss {res.losses[-1]:.4f} "
          f"(floor {data.bigram_entropy():.4f})")
    if res.subspace is not None:
        for name, vals in list(res.subspace.summary().items())[:3]:
            print(f"[subspace] {name}: {vals}")


if __name__ == "__main__":
    main()
