if __name__ == "__main__":
    # Before torch is imported, and only when run as a script: importing
    # this module for its functions leaves the environment as it is.  The
    # preset composes with what the user set; it never overwrites it.
    from repro_torch.launch.runtime import apply_runtime_preset

    apply_runtime_preset("dryrun")

_DOC = """The dry run, from ``src/repro/launch/dryrun.py``: every (arch x
shape) cell built on the ``meta`` device, counted, never run.

For each cell this
  1. builds the full-width model and, for a train shape, the optimizer
     (bucketed engine) and its state, on the meta device: shapes and
     dtypes, no storage;
  2. cuts them as the train step would for process 0 of ``--mesh`` (the
     launcher's ``data,model`` or ``pod,data,model``): its blocks under
     tensor parallelism (``model`` > 1) and FSDP (``data`` > 1 without
     ``--compressed-dp``), then its rows of a ZeRO state;
  3. counts that process's param, gradient and optimizer-state bytes, the
     bytes it hands the collectives over ``model`` and over ``data`` in a
     hot step (``models.tp_hot_comm_bytes``,
     ``core/lowrank.fsdp_hot_comm_bytes``, ``core/buckets.dp_comm_model``),
     the rank schedule's state model where one is given, and the roofline
     (``roofline/analysis.py`` on ``roofline/hw.py``'s H100 numbers);
  4. says whether params, gradients and state fit one card's 80 GB
     (activations are not counted) and writes a JSON artifact under
     ``--out-dir``.

The reference lowers and compiles each cell with XLA; the port has no
graph to compile, so the operations, bytes and collective bytes are
counted from the shapes (``hlo_*`` keep the reference's field names).
Prefill and decode cells count the serving params (bf16 where the engines
serve in bf16) and the decode cache on one process: the serving engines
take no mesh.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k --mesh 1,4
  python -m repro_torch.launch.dryrun --all --mesh 4,1 --state-sharding zero
"""

import argparse
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import specs as specs_lib
from repro_torch.configs.base import SHAPES, TrainConfig
from repro_torch.configs.registry import cells, get_config
from repro_torch.core import buckets as buckets_lib
from repro_torch.core import lowrank as lowrank_lib
from repro_torch.core import make_optimizer
from repro_torch.core import rank_schedule as rank_schedule_lib
from repro_torch.core import svd as svd_lib
from repro_torch.launch.mesh import AXES, DP_AXES, Mesh, axes_size
from repro_torch.models import build_model, count_params, tp_hot_comm_bytes
from repro_torch.roofline import analysis as ra
from repro_torch.roofline import hw
from repro_torch.train.state import TrainState

__doc__ = _DOC

ACTIVATIONS = "not counted: the fit is params + gradients + optimizer state only"
# the forward runs twice in a step under remat="block" (8 N D, not 6 N D)
REMAT_FACTOR = {"block": 4.0 / 3.0, "none": 1.0}


def _nbytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_nbytes(v) for v in tree)
    return 0


def layout_mesh(text: str) -> Mesh:
    """The mesh of ``--mesh`` (the launcher's form) as process 0 sees it,
    without a process group: its coordinates and extents only."""
    shape = tuple(int(x) for x in text.split(","))
    axes = ("data", "model")[: len(shape)] if len(shape) <= 2 else AXES
    if len(axes) != len(shape):
        raise ValueError(f"--mesh {text!r}: give 'data,model' or 'pod,data,model'")
    return Mesh(axes, shape)


def _rank(cfg, args) -> int:
    """The launcher's rank (``launch/train.py``): ``--rank``, else the
    schedule's start, else d_model / 4 within [8, 512]."""
    if args.rank:
        return args.rank
    if args.rank_schedule:
        return rank_schedule_lib.parse_rank_schedule(args.rank_schedule).start
    return min(512, max(8, cfg.d_model // 4))


def _state_axes(mesh: Mesh, compressed: str) -> Tuple[str, ...]:
    """The axes a ZeRO state's rows split over: the compressed step's
    reduction axes, or ``data`` on the FSDP step."""
    if compressed == "pod":
        return ("pod",)
    if compressed:
        return tuple(a for a in DP_AXES if a in mesh.axis_names)
    return ("data",)


def train_counts(cfg, shape, mesh: Mesh, args) -> Dict[str, Any]:
    """Process 0's bytes in a train cell (module docstring), counted on the
    meta device."""
    # imported here: train/step.py imports torch._dynamo, whose import sets
    # TORCHINDUCTOR_CACHE_DIR, and importing this module changes no variable
    from repro_torch.train.step import shard_train_state

    compressed = args.compressed_dp or ""
    model = build_model(cfg, device="meta")
    params = model.init(torch.Generator().manual_seed(0))
    # the standard step at a data extent above 1 is FSDP (train/step.py)
    fsdp_step = not compressed and mesh.dp > 1
    zero = args.state_sharding == "zero"
    kw: Dict[str, Any] = dict(rank=_rank(cfg, args), tau=200, lr=0.01, engine="bucketed",
                              svd_backend="randomized", refresh_groups=args.refresh_groups)
    if args.rank_schedule:
        kw["rank_schedule"] = args.rank_schedule
    state_axes = _state_axes(mesh, compressed)
    if zero:
        kw.update(state_sharding="zero", state_shards=axes_size(mesh, state_axes))
    opt = make_optimizer(args.optimizer, params, **kw)
    state = TrainState(params, opt.init(params))
    global_state_bytes = lowrank_lib.state_memory_bytes(state.opt_state)
    local_opt = opt
    if mesh.tp > 1 or fsdp_step:
        local_opt = lowrank_lib.tensor_parallel_optimizer(opt, mesh, fsdp=fsdp_step)
    # whether some leaf is cut over data (else the step all-reduces them all)
    fsdp = fsdp_step and local_opt.tp is not None and local_opt.tp.data_axes is not None \
        and any(d is not None for d in local_opt.tp.data_splits)
    # the rows of a ZeRO state this process keeps, as the step cuts them: the
    # compressed step over its reduction axes, the FSDP step over data where
    # its layout marks rows (a model with nothing cut over data keeps them)
    rows_axes = None
    if zero and axes_size(mesh, state_axes) > 1:
        layout = local_opt.state_layout
        if compressed or (layout is not None and layout.zero_rows):
            rows_axes = state_axes
    local, _ = shard_train_state(state, mesh, zero_dp_axes=rows_axes, optimizer=opt,
                                 fsdp=fsdp_step)
    param_bytes = _nbytes(local.params)
    state_bytes = lowrank_lib.state_memory_bytes(local.opt_state)
    plan = local_opt.bucket_plan
    batch_axes = tuple(a for a in DP_AXES if a in mesh.axis_names)
    dp = axes_size(mesh, batch_axes)
    rows = shape.global_batch // dp
    tokens = specs_lib.train_batch_specs(cfg, shape)["tokens"].shape[1]
    act_bytes = torch.empty((), dtype=cfg.dtype).element_size()
    n_micro = max(rows // args.microbatch, 1) if args.microbatch else 1

    over_model: Optional[int] = 0
    if mesh.tp > 1:
        over_model = None  # the MoE family's expert exchange is not counted
        if cfg.family != "moe" and plan is not None:
            over_model = tp_hot_comm_bytes(cfg, rows, tokens, plan, act_bytes, tp=mesh.tp)
    dp_model = None
    over_data = 0
    if fsdp:
        whole = batch_axes == ("data",)
        split = lowrank_lib.fsdp_hot_comm_bytes(local_opt, cfg, whole_over_data=False)
        r_part = sum(bk.batch * bk.rank * bk.n * 4 for bk in plan.buckets if bk.dsplit == "d")
        whole_part = lowrank_lib.fsdp_hot_comm_bytes(local_opt, cfg, whole_over_data=whole) \
            - split
        # each microbatch gathers the split leaves and reduce-scatters their
        # gradients again; the whole leaves and the partial R reduce once
        over_data = n_micro * (split - r_part) + r_part + whole_part
    elif dp > 1 and plan is not None:
        sizes = {a: mesh.shape[a] for a in batch_axes}
        dp_model = buckets_lib.dp_comm_model(
            plan, local_opt.likes, axis_sizes=sizes,
            state_shards=local_opt.state_layout.shards if local_opt.state_layout else 1,
            inner=opt.config.inner)
        key = ("zero" if zero and compressed else "compressed") if compressed else "standard"
        if key != "standard":
            key += "_refresh" if args.refresh else "_hot"
        over_data = dp_model[key]["bytes"]

    sched = None
    if args.rank_schedule:
        sc = rank_schedule_lib.parse_rank_schedule(args.rank_schedule)
        sched = rank_schedule_lib.scheduled_state_model(
            opt.config, params, sc, total_steps=sc.total_steps or TrainConfig().total_steps,
            state_shards=opt.state_layout.shards if opt.state_layout else 1)
        sched.pop("rank_plans", None)  # bucket plans: not JSON

    opt_bytes = opt_ops = 0
    if plan is not None:  # Fira and Adafactor: the per-leaf loop, not modeled
        opt_bytes = buckets_lib.modeled_hbm_bytes(plan, "bucketed", projected=bool(compressed),
                                                  inner=opt.config.inner)
        # R = P^T G and the back-projection P N, per slice
        opt_ops = sum(4 * bk.batch * bk.d * bk.rank * bk.n for bk in plan.buckets)
        if args.refresh:
            opt_bytes += buckets_lib.modeled_refresh_hbm_bytes(plan, local_opt.specs,
                                                               engine="batched")
            ocfg = opt.config
            for bk in plan.buckets:
                # the sketch, power-iteration and B = Q^T G products
                k = min(bk.d, ocfg.sara_pool_factor * bk.rank) if ocfg.method == "sara" \
                    else bk.rank
                _, kp, iters = svd_lib.clamp_sketch(bk.d, bk.n, k, ocfg.svd_oversample,
                                                    ocfg.svd_power_iters)
                opt_ops += bk.batch * (4 + 4 * iters) * bk.d * bk.n * kp
    return {
        "params": params,
        "param_bytes": param_bytes, "grad_bytes": param_bytes, "state_bytes": state_bytes,
        "global_state_bytes": global_state_bytes, "rows": rows, "tokens": tokens,
        "n_micro": n_micro, "bytes_over_model": over_model, "bytes_over_data": over_data,
        "dp_comm_model": dp_model, "rank_schedule": sched, "fsdp": fsdp,
        "opt_bytes": opt_bytes, "opt_ops": opt_ops,
        "buckets": [[bk.batch, bk.d, bk.n, bk.rank, bk.split, bk.dsplit]
                    for bk in plan.buckets] if plan is not None else [],
    }


def serve_counts(cfg, shape) -> Dict[str, Any]:
    """A prefill or decode cell on one process: the serving params and the
    cache at the shape's capacity."""
    model = build_model(cfg, device="meta")
    params = model.init(torch.Generator().manual_seed(0), serving=True)
    cache = specs_lib.decode_cache_specs(model, shape)
    return {"params": params, "param_bytes": _nbytes(params), "cache_bytes": _nbytes(cache)}


def run_cell(arch: str, shape_name: str, args, cfg=None) -> ra.RooflineReport:
    """One cell's report (``cfg`` in place of the registry's full-width
    config: a cut depth, a smoke config)."""
    t0 = time.time()
    if cfg is None:
        cfg = get_config(arch).with_(ssm_head_tp=args.ssm_head_tp)
    shape = SHAPES[shape_name]
    extra: Dict[str, Any] = {"kind": shape.kind, "variant": args.variant,
                             "activations": ACTIVATIONS, "n_layers": cfg.n_layers}
    if shape.kind == "train":
        mesh = layout_mesh(args.mesh)
        c = train_counts(cfg, shape, mesh, args)
        total_params = count_params(c["params"])
        n_chips = mesh.size
        mf = ra.model_flops(cfg, shape, total_params)
        mb = ra.model_bytes(cfg, shape, total_params)
        flops = mf * REMAT_FACTOR.get(cfg.remat, 1.0) / n_chips + c["opt_ops"]
        nbytes = mb / n_chips + c["opt_bytes"]
        coll = {"model": c["bytes_over_model"], "data": c["bytes_over_data"]}
        cbytes = float(sum(v for v in coll.values() if v))
        mem = {"param_bytes": float(c["param_bytes"]), "grad_bytes": float(c["grad_bytes"]),
               "opt_state_bytes": float(c["state_bytes"])}
        extra.update(optimizer=args.optimizer, refresh=bool(args.refresh),
                     compressed_dp=args.compressed_dp or "", state_sharding=args.state_sharding,
                     microbatch=args.microbatch, n_micro=c["n_micro"], rows=c["rows"],
                     tokens=c["tokens"], fsdp=c["fsdp"], buckets=c["buckets"],
                     global_opt_state_bytes=float(c["global_state_bytes"]),
                     dp_comm_model=c["dp_comm_model"], rank_schedule=c["rank_schedule"])
        mesh_name = args.mesh
    else:
        c = serve_counts(cfg, shape)
        total_params = count_params(c["params"])
        n_chips = 1
        mf = ra.model_flops(cfg, shape, total_params)
        mb = ra.model_bytes(cfg, shape, total_params)
        flops, nbytes, cbytes, coll = mf, mb, 0.0, {}
        mem = {"param_bytes": float(c["param_bytes"]), "cache_bytes": float(c["cache_bytes"])}
        mesh_name = "1,1"  # the serving engines take no mesh
    resident = sum(mem.values())
    mem["total_bytes"] = float(resident)
    extra.update(model_bytes=mb, total_params=total_params, fits=resident <= hw.HBM_BYTES,
                 card_bytes=hw.HBM_BYTES, seconds=time.time() - t0)
    return ra.analyze(arch=arch, shape=shape_name, mesh_name=mesh_name, n_chips=n_chips,
                      model_flops=mf, flops=flops, bytes_accessed=nbytes,
                      collective_bytes=cbytes, collectives=coll, memory_per_device=mem,
                      extra=extra)


def summary(tag: str, report: ra.RooflineReport) -> str:
    """The ``[ok]`` line of a cell."""
    mem, coll = report.memory_per_device, report.collectives
    gb = lambda x: "n/a" if x is None else f"{x / 1e9:.3f}"  # noqa: E731
    parts = [f"[ok] {tag}:"]
    if report.extra["kind"] == "train":
        parts.append(f"params={gb(mem['param_bytes'])}GB grads={gb(mem['grad_bytes'])}GB "
                     f"state={gb(mem['opt_state_bytes'])}GB "
                     f"over_model={gb(coll.get('model'))}GB "
                     f"over_data={gb(coll.get('data'))}GB")
        sched = report.extra.get("rank_schedule")
        if sched:
            parts.append(f"sched_peak={gb(sched['modeled_state_bytes_peak'])}GB "
                         f"sched_avg={gb(sched['modeled_state_bytes_avg'])}GB")
    else:
        parts.append(f"params={gb(mem['param_bytes'])}GB cache={gb(mem['cache_bytes'])}GB")
    parts.append(f"total={gb(mem['total_bytes'])}GB fits_80GB={report.extra['fits']} "
                 f"model_flops={report.model_flops:.4g} model_bytes="
                 f"{report.extra['model_bytes']:.4g} bottleneck={report.bottleneck} "
                 f"compute={report.compute_term_s:.4f}s memory={report.memory_term_s:.4f}s "
                 f"collective={report.collective_term_s:.4f}s "
                 f"roofline_frac={report.roofline_fraction():.3f}")
    return " ".join(parts)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=_DOC.splitlines()[0],
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true", help="every runnable cell")
    ap.add_argument("--mesh", default="1,1",
                    help="'data,model' or 'pod,data,model', as the train launcher's")
    ap.add_argument("--optimizer", default="galore-sara-adam")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--rank-schedule", default="",
                    help="'kind:start[:floor][@decay_fraction]' (e.g. cosine:128:32@0.5): "
                         "the step-0 geometry, and the schedule's state model in the artifact")
    ap.add_argument("--refresh", action="store_true",
                    help="count the projector-refresh step instead of the hot step")
    ap.add_argument("--refresh-groups", type=int, default=1)
    ap.add_argument("--compressed-dp", nargs="?", const="flat", default="",
                    choices=("flat", "pod"), help="project-then-reduce DP (flat | pod)")
    ap.add_argument("--state-sharding", default="", choices=("", "zero"),
                    help="'zero': each process keeps its rows of the bucket stacks")
    ap.add_argument("--microbatch", type=int, default=0,
                    help="gradient-accumulation microbatch rows (FSDP gathers per microbatch)")
    ap.add_argument("--ssm-head-tp", action="store_true",
                    help="split the SSD heads over model (cfg.ssm_head_tp)")
    ap.add_argument("--variant", default="baseline", help="label stored in the artifact")
    ap.add_argument("--out-dir", default="experiments/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    return ap


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    if args.all:
        todo = [(a, s) for a, s, _ in cells(include_skipped=False)]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        todo = [(args.arch, args.shape)]
    layout_mesh(args.mesh)  # a bad --mesh fails before any cell
    os.makedirs(args.out_dir, exist_ok=True)
    failures = []
    for arch, shape in todo:
        tag = f"{arch}__{shape}__{args.mesh.replace(',', 'x')}"
        if args.variant != "baseline":
            tag += f"__{args.variant}"
        path = os.path.join(args.out_dir, tag + ".json")
        if args.skip_existing and os.path.exists(path):
            print(f"[skip] {tag}")
            continue
        try:
            report = run_cell(arch, shape, args)
            with open(path, "w") as f:
                f.write(report.to_json())
            print(summary(tag, report), flush=True)
        except Exception as e:  # noqa: BLE001 -- every cell is tried, failures listed
            failures.append((tag, repr(e)))
            traceback.print_exc()
            print(f"[FAIL] {tag}: {e!r}", flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for tag, err in failures:
            print(f"  {tag}: {err}")
        return 1
    print(f"\nall {len(todo)} cells counted")
    return 0


if __name__ == "__main__":
    sys.exit(main())
