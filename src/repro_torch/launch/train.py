"""Pretraining launcher, from ``src/repro/launch/train.py``: seeded random
weights, synthetic bigram data, the low-rank optimizer, ``train_loop``.
Runs on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
        --optimizer galore-sara-adam --engine bucketed --steps 100
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b --smoke \\
        --device cpu --steps 4 --tau 2

``--optimizer`` takes every composed name of ``core/api.py``, as the
reference's launcher does: the paper's ``galore-sara-adam``, the other
inners (``galore-sara-msgd``, ``-adam-mini``, ``-adam8bit``, ``-adafactor``)
and the baselines (``galore-adam``, ``golore-adam``, ``grass-adam``,
``online-pca-adam``, ``identity-adam``, ``fira-adam``, ``fira-sara-adam``).
They run on either engine.  On the bucketed one every fused inner (Adam,
MSGD, Adam-mini, 8-bit Adam) takes its CUDA update, with any projector;
Fira and Adafactor run its per-leaf loop, as in the reference:

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b --smoke \\
        --device cpu --optimizer galore-sara-adam8bit --engine bucketed \\
        --svd-backend randomized --steps 4 --tau 2 --rank 8
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b --smoke \\
        --device cpu --optimizer online-pca-adam --engine bucketed \\
        --svd-backend randomized --steps 4 --tau 2 --rank 8

``--smoke`` selects the reduced config in f32.  Checkpoints go to
``--ckpt-dir`` every ``--ckpt-every`` steps (and on SIGTERM or SIGINT);
run the launcher again with the same ``--ckpt-dir`` and it resumes from
the newest checkpoint that verifies:

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b --smoke \\
        --device cpu --steps 8 --tau 2 --rank 8 --ckpt-dir /path/to/ckpt --ckpt-every 4

Beyond the reference's flags, ``--svd-backend`` picks the refresh's SVD
(the reference's default, exact, or randomized, whose power iterations
run on the CUDA kernel), and ``--dist`` the synthetic corpus (bigram or
zipf).  Mesh, ZeRO, recovery and rank-schedule flags come with their
slices (ROADMAP queue 1 items 9-12); Fira's limiter keeps its default,
as the reference's launcher has no flag for it either.
"""
from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--optimizer", default="galore-sara-adam")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--tau", type=int, default=200)
    ap.add_argument("--alpha", type=float, default=0.25)
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--engine", default="",
                    help="optimizer engine override: reference | bucketed")
    ap.add_argument("--svd-backend", default="",
                    help="refresh SVD override: exact | randomized")
    ap.add_argument("--dist", default="bigram", choices=("bigram", "zipf"),
                    help="synthetic corpus")
    ap.add_argument("--ckpt-dir", default="/tmp/repro_train")
    ap.add_argument("--ckpt-every", type=int, default=200)
    ap.add_argument("--refresh-groups", type=int, default=1)
    ap.add_argument("--microbatch", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core import make_optimizer
    from repro_torch.core.lowrank import tree_leaves
    from repro_torch.core.schedules import cosine_with_warmup
    from repro_torch.data.synthetic import SyntheticDataConfig, SyntheticDataset
    from repro_torch.models import build_model
    from repro_torch.train.loop import train_loop
    from repro_torch.train.step import make_train_step

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.smoke:
        cfg = cfg.with_(dtype=torch.float32)
    model = build_model(cfg, device=args.device)
    tc = TrainConfig(total_steps=args.steps, microbatch=args.microbatch,
                     checkpoint_every=args.ckpt_every, checkpoint_dir=args.ckpt_dir)
    params = model.init(torch.Generator(device=model.device).manual_seed(tc.seed))
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"[train] {args.arch} {n_params / 1e6:.1f}M params on {model.device}")

    rank = args.rank or min(512, max(8, cfg.d_model // 4))
    kw = dict(
        lr=args.lr,
        lr_schedule=cosine_with_warmup(args.lr, args.warmup, args.steps),
        grad_clip_norm=1.0,
    )
    if args.engine:
        kw["engine"] = args.engine
    if args.svd_backend:
        kw["svd_backend"] = args.svd_backend
    if args.optimizer != "adam":
        kw.update(rank=rank, tau=args.tau, alpha=args.alpha,
                  refresh_groups=args.refresh_groups)
    opt = make_optimizer(args.optimizer, params, **kw)
    # train_loop makes the same params from tc.seed and owns them; a copy
    # held here would stay alive for the whole run
    del params

    seq = args.seq or (64 if args.smoke else 512)
    batch = args.batch or (8 if args.smoke else 512)
    data = SyntheticDataset(
        SyntheticDataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
                            dist=args.dist),
        device=model.device,
    )
    fns = make_train_step(model, opt, train_cfg=tc)
    res = train_loop(model, opt, data, tc, fns, log_every=max(args.steps // 20, 1))
    if not res.losses:
        print(f"[train] done: step {res.final_step}, no steps left to run")
        return
    print(f"[train] done: step {res.final_step}, "
          f"loss {res.losses[0]:.4f} -> {res.losses[-1]:.4f}")


if __name__ == "__main__":
    main()
