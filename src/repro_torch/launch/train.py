"""Pretraining launcher, from ``src/repro/launch/train.py``: seeded random
weights, synthetic bigram data, the low-rank optimizer, ``train_loop``.
Runs on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
        --optimizer galore-sara-adam --engine bucketed --steps 100
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b --smoke \\
        --device cpu --steps 4 --tau 2

``--arch`` takes every ported config: the dense ones, deepseek-moe-16b and
olmoe-1b-7b (MoE: the loss carries the router's aux loss), mamba2-370m and
hymba-1.5b.

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

Recovery is on unless ``--no-recovery`` is given, as in the reference:
the skip-step gate on every step, a pinned checkpoint before the first
step of a fresh run, rollback-and-resample after ``--max-bad-steps``
consecutive bad steps (``--loss-spike-factor`` > 0 makes a loss spike a
bad step too), at most ``--max-rollbacks`` times, each after a backoff of
0.5 s doubled per attempt.  ``--collective-timeout`` > 0 arms the
watchdog, which waits for every step on the card.  ``--rank-schedule
kind:start[:floor][@fraction]`` (e.g. ``step:512:256``) starts at the
schedule's rank and re-buckets at refresh boundaries; ``--log-spectrum``
adds the refresh update's spectrum to the history.  The run ends with a
``[train] recovery: ...`` line of its counters:

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b --smoke \\
        --device cpu --steps 8 --tau 2 --engine bucketed --svd-backend randomized \\
        --rank-schedule step:16:8 --ckpt-dir /path/to/ckpt

Data and tensor parallel, one process per card: ``--mesh data,model``
(or ``pod,data,model``) over the processes, ``--compressed-dp`` for the
project-then-reduce step (``flat``, or ``--compressed-dp pod``),
``--state-sharding zero`` for ZeRO state (``--state-shards`` defaults to
the compressed axes' replica count, and to the ``data`` extent on the
FSDP step).  A ``model`` extent above 1 runs every family tensor parallel
(MoE: expert parallel), and a ``data`` extent above 1 without
``--compressed-dp`` runs it FSDP over ``data`` (the reference's standard
step), each process holding its blocks of the params and optimizer state
(``train/step.py``), with every ``--optimizer``, both engines,
``--rank-schedule`` and ``--log-spectrum``; ``--state-sharding zero`` on
the FSDP step keeps each process's rows of the moments too.  Start the
processes with torchrun, which sets ``RANK`` / ``WORLD_SIZE`` /
``MASTER_ADDR`` / ``MASTER_PORT``:

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch llama3-8b --engine bucketed --svd-backend randomized \
        --mesh 4,1 --compressed-dp --state-sharding zero --steps 100
    PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \
        --arch llama3-8b --engine bucketed --svd-backend randomized --mesh 4,2
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch qwen2-1.5b --optimizer galore-sara-adam8bit --engine bucketed \
        --svd-backend randomized --mesh 1,2
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch llama3-8b --engine bucketed --svd-backend randomized --mesh 4,1 \
        --state-sharding zero


or one launcher per process with ``--coordinator`` (``host:port``, or a
``file://`` store), ``--num-processes`` and ``--process-id``.  The process
group is NCCL on the card and gloo with ``--device cpu``; there is no
fallback from one to the other, and a collective that fails or waits
past ``GROUP_TIMEOUT`` raises.  On the CPU a tensor-parallel or FSDP
world is gloo processes (``--mesh 1,2`` or ``--mesh 2,1 --device cpu``,
two launchers with ``--coordinator``; the smoke llama's widths leave
every leaf whole over ``data``, the MoE smoke configs split their expert
``d_ff``, and the smoke mamba2 splits ``in_proj`` and ``out_proj`` over
``model``).  Each process feeds the global batch
(``--batch``) and runs its own rows of it.

Each process beats a ``HeartbeatRegistry`` (``--heartbeat-timeout``
seconds) as ``worker<process id>`` every step, and a worker that goes
stale is escalated per ``--stale-action``: ``log`` (a ``stale_worker``
record), ``rollback`` or ``abort``.  The registry is the reference's, held
in the process, and the closing line counts its stale workers.  A process
that dies takes its world down: its peers' next collective raises (gloo;
NCCL aborts under ``TORCH_NCCL_ASYNC_ERROR_HANDLING=1``, the ``overlap``
preset of ``launch/runtime.py``), each survivor exits non-zero with the
step it was in (``[train] step N failed``), and running the same
command again resumes from the newest checkpoint that verifies.

``--shape`` names the cell's shape (``configs/base.SHAPES``), as the
reference's launcher takes it; as there, the batch comes from ``--seq``
and ``--batch``.  Beyond the reference's flags, ``--svd-backend`` picks
the refresh's SVD (the reference's default, exact, or randomized, whose
power iterations run on the CUDA kernel), and ``--dist`` the synthetic
corpus (bigram or zipf); Fira's limiter keeps its default, as the
reference's launcher has no flag for it either.
"""
from __future__ import annotations

import argparse
import math
import os
from datetime import timedelta

# how long a collective of the process group may wait before it raises
GROUP_TIMEOUT = timedelta(minutes=10)


def maybe_init_distributed(args) -> bool:
    """Start the default process group when the run has several processes
    (``src/repro/launch/train.py:22``): from ``--coordinator`` /
    ``--num-processes`` / ``--process-id``, or from torchrun's ``RANK`` /
    ``WORLD_SIZE`` / ``MASTER_ADDR`` environment.  NCCL when the device is
    CUDA (each process on the card of its ``LOCAL_RANK``), gloo only with
    ``--device cpu``.  Returns whether a group was started."""
    import torch
    import torch.distributed as dist

    if args.coordinator:
        addr = args.coordinator
        init = addr if "://" in addr else f"tcp://{addr}"
        world, rank = args.num_processes, args.process_id
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        init, world, rank = "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        return False
    backend = "gloo" if torch.device(args.device).type == "cpu" else "nccl"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            timeout=GROUP_TIMEOUT)
    return True


def main(argv=None) -> None:
    from repro_torch.configs.base import SHAPES

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--shape", default="train_4k", choices=tuple(SHAPES))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--optimizer", default="galore-sara-adam")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--rank-schedule", default="",
                    help="rank schedule 'kind:start[:floor][@decay_fraction]' "
                         "(e.g. cosine:128:32@0.5): the loop re-buckets at refresh boundaries")
    ap.add_argument("--log-spectrum", action="store_true",
                    help="log the refresh-step update spectrum (effective rank) into the history")
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
    ap.add_argument("--no-recovery", action="store_true",
                    help="abort on the first fault (no skip-step, no rollback)")
    ap.add_argument("--max-rollbacks", type=int, default=3)
    ap.add_argument("--max-bad-steps", type=int, default=3,
                    help="consecutive bad steps before a rollback")
    ap.add_argument("--loss-spike-factor", type=float, default=0.0,
                    help=">0: loss > factor x windowed median is a bad step")
    ap.add_argument("--stale-action", default="log", choices=("log", "rollback", "abort"),
                    help="escalation for a stale worker heartbeat")
    ap.add_argument("--collective-timeout", type=float, default=0.0,
                    help=">0: arm the step watchdog (a sync per step)")
    ap.add_argument("--heartbeat-timeout", type=float, default=60.0)
    ap.add_argument("--mesh", default="",
                    help="'data,model' or 'pod,data,model' over the processes "
                         "(model > 1: tensor parallel; data > 1 without --compressed-dp: "
                         "FSDP over data)")
    ap.add_argument("--compressed-dp", nargs="?", const="flat", default="",
                    choices=("flat", "pod"),
                    help="project-then-reduce DP gradient compression (flat | pod)")
    ap.add_argument("--state-sharding", default="", choices=("", "zero"),
                    help="'' (replicated) | 'zero' (each process keeps its rows of the stacks)")
    ap.add_argument("--state-shards", type=int, default=0,
                    help="ZeRO shard count; default: the compressed axes' replica count")
    ap.add_argument("--coordinator", default="",
                    help="host:port (or a file:// store) of the process group")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    args = ap.parse_args(argv)
    distributed = maybe_init_distributed(args)

    import torch

    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core import make_optimizer
    from repro_torch.core.schedules import cosine_with_warmup
    from repro_torch.data.synthetic import SyntheticDataConfig, SyntheticDataset
    from repro_torch.launch.mesh import axes_size, batch_axes, make_mesh, single_device_mesh
    from repro_torch.models import build_model, count_params
    from repro_torch.core.rank_schedule import parse_rank_schedule
    from repro_torch.train.loop import train_loop
    from repro_torch.train.monitor import CollectiveWatchdog, HeartbeatRegistry
    from repro_torch.train.recovery import RecoveryPolicy
    from repro_torch.train.step import make_train_step

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.smoke:
        cfg = cfg.with_(dtype=torch.float32)
    device = args.device
    if distributed and torch.device(device).type == "cuda" and torch.device(device).index is None:
        device = f"cuda:{torch.cuda.current_device()}"
    model = build_model(cfg, device=device)
    tc = TrainConfig(total_steps=args.steps, microbatch=args.microbatch,
                     checkpoint_every=args.ckpt_every, checkpoint_dir=args.ckpt_dir,
                     log_spectrum=args.log_spectrum)
    params = model.init(torch.Generator(device=model.device).manual_seed(tc.seed))
    n_params = count_params(params)
    mesh = None
    if args.mesh:
        mesh = make_mesh(tuple(int(x) for x in args.mesh.split(",")))
    elif distributed:
        mesh = make_mesh((torch.distributed.get_world_size(), 1))
    elif args.compressed_dp:
        mesh = single_device_mesh()
    procs = mesh.size if mesh is not None else 1
    print(f"[train] {args.arch} {n_params / 1e6:.1f}M params on {model.device}, "
          f"{procs} process(es)")

    rank = args.rank or min(512, max(8, cfg.d_model // 4))
    if args.rank_schedule and not args.rank:
        # start at the schedule's step-0 rank; the loop re-buckets from there
        rank = parse_rank_schedule(args.rank_schedule).start
    kw = dict(
        lr=args.lr,
        lr_schedule=cosine_with_warmup(args.lr, args.warmup, args.steps),
        grad_clip_norm=1.0,
    )
    if args.state_sharding:
        dp = ("pod",) if args.compressed_dp == "pod" else (
            batch_axes(mesh) if mesh is not None else ())
        if mesh is not None and not args.compressed_dp and mesh.dp > 1:
            dp = ("data",)  # the FSDP step's rows are over data
        kw.update(state_sharding=args.state_sharding,
                  state_shards=args.state_shards or (axes_size(mesh, dp) if mesh else 1))
    if args.engine:
        kw["engine"] = args.engine
    if args.svd_backend:
        kw["svd_backend"] = args.svd_backend
    if args.optimizer != "adam":
        kw.update(rank=rank, tau=args.tau, alpha=args.alpha,
                  refresh_groups=args.refresh_groups)
        if args.rank_schedule:
            kw["rank_schedule"] = args.rank_schedule
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
    recovery = None
    if not args.no_recovery:
        recovery = RecoveryPolicy(
            max_bad_steps=args.max_bad_steps, loss_spike_factor=args.loss_spike_factor,
            max_rollbacks=args.max_rollbacks, rollback_backoff_s=0.5,
            stale_worker_action=args.stale_action,
        )
    heartbeats = HeartbeatRegistry(timeout_s=args.heartbeat_timeout)
    watchdog = None
    if args.collective_timeout > 0:
        watchdog = CollectiveWatchdog(
            timeout_s=args.collective_timeout,
            on_timeout=lambda s, dt: print(
                f"[train] WATCHDOG: step call {s} exceeded {dt:.1f}s", flush=True),
        )
    fns = make_train_step(model, opt, mesh=mesh, train_cfg=tc, compressed=args.compressed_dp,
                          recovery=recovery, watchdog=watchdog)
    if fns["fsdp"]:
        local = sum(math.prod(like.shape) for like in fns["optimizer"].likes)
        print(f"[train] FSDP over data: this process holds {local / 1e6:.1f}M of the "
              f"{n_params / 1e6:.1f}M params")
    try:
        res = train_loop(model, opt, data, tc, fns, log_every=max(args.steps // 20, 1),
                         recovery=recovery, heartbeats=heartbeats,
                         worker_name=f"worker{args.process_id}")
    finally:
        if distributed:
            torch.distributed.destroy_process_group()
    if not res.losses:
        print(f"[train] done: step {res.final_step}, no steps left to run")
        return
    print(f"[train] done: step {res.final_step}, "
          f"loss {res.losses[0]:.4f} -> {res.losses[-1]:.4f}")
    recs = [r for r in res.history if "skip_steps" in r]
    if recs:
        last = recs[-1]
        events = [r for r in res.history if "event" in r]
        print(f"[train] recovery: {int(last['skip_steps'])} skipped, "
              f"{int(last['rollbacks'])} rollbacks, "
              f"{int(last['save_retries'])} save retries, "
              f"{int(last['save_failures'])} save failures, "
              f"{len(events)} recovery events, "
              f"stale workers: {int(last.get('stale_workers', 0))}")


if __name__ == "__main__":
    main()
