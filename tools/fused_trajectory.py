#!/usr/bin/env python3
"""One low-rank optimizer along a real trajectory on the card, with and
without each hand-written kernel under it.

    python3 tools/fused_trajectory.py --optimizer galore-adam8bit [--steps 60] [--tau 12] \\
        [--layers 8] [--batch 32] [--modes kernel,plain-update,...] [--seeds 0,1,2]

Trains ``--optimizer`` (an Adam-mini or 8-bit Adam name) at the ``tables``
path's LLaMA-60M configuration (``chip_smoke.paper_tables``: 8 layers,
d_model 512, vocab 32100, seq 256, batch 32, bf16 compute, rank 128,
alpha 0.25, lr 2e-3, the randomized SVD; ``--layers`` and ``--batch`` cut
it to the size of tools/tables_cpu.py's ``--trajectory`` runs) from the
same init and batches in each mode:

  kernel        -- the bucketed engine with the fused update, each call
                   also run through its plain version on copies of its
                   inputs (the largest difference of each output);
  plain-update  -- the bucketed engine with the plain update in its place;
  reference     -- the per-leaf loop (no fused update), kernels 1, 2, 9;
  f32           -- the bucketed engine with the kernels, f32 activations;
  no-flash      -- the per-leaf loop with exact attention (no kernel 2);
  no-rmsnorm    -- the per-leaf loop with the plain RMSNorm (no kernel 1);
  no-power      -- the per-leaf loop with the plain power iteration (no
                   kernel 9);
  no-kernel     -- the per-leaf loop with none of kernels 1, 2 and 9: no
                   hand-written kernel at all.

Each ``--seeds`` entry s draws the init from seed s and the corpus from
seed 3 + s (the harness's 3 at s = 0).  Prints every ``--every``-th loss,
the final (mean of the last 10) and the largest of each run, and the
largest difference of each fused-update output over the calls (each
call's in ``chiprun_out/fused_trajectory_<optimizer>_b<batch>.json``);
exits 1 if a call's W' is more than ``TOL`` from the plain version's.
Needs a card; imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5  # W' against the plain version, chip_smoke's TOL for kernels 7 and 8 (f32)
DISPATCH = {"adam_mini": ("bucketed_adam_mini_update", "lowrank_adam_mini_update_ref"),
            "adam8bit": ("bucketed_adam8bit_update", "lowrank_adam8bit_update_ref")}
# mode: (update, engine, compute dtype, the kernels of 1, 2, 9 it replaces)
MODES = {
    "kernel": ("checked", "bucketed", torch.bfloat16, ()),
    "plain-update": ("plain", "bucketed", torch.bfloat16, ()),
    "reference": ("kernel", "reference", torch.bfloat16, ()),
    "f32": ("kernel", "bucketed", torch.float32, ()),
    "no-flash": ("kernel", "reference", torch.bfloat16, ("flash",)),
    "no-rmsnorm": ("kernel", "reference", torch.bfloat16, ("rmsnorm",)),
    "no-power": ("kernel", "reference", torch.bfloat16, ("power",)),
    "no-kernel": ("kernel", "reference", torch.bfloat16, ("flash", "rmsnorm", "power")),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--optimizer", default="galore-adam-mini")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--tau", type=int, default=12)
    ap.add_argument("--every", type=int, default=4)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--modes", default="kernel,plain-update,reference,f32,no-kernel")
    ap.add_argument("--seeds", default="0")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.benchmarks import common
    from repro_torch.core import parse_name
    from repro_torch.kernels.lowrank_update import ops as update_ops
    from repro_torch.kernels.lowrank_update import ref as ref_lib
    from repro_torch.kernels.power_iter import ops as power_ops
    from repro_torch.kernels.power_iter.ref import power_iter_ref
    from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    op_name, ref_name = DISPATCH[parse_name(args.optimizer)["inner"]]
    kernel, ref = getattr(update_ops, op_name), getattr(ref_lib, ref_name)
    width = dict(n_heads=8, n_kv_heads=8, head_dim=64, d_ff=1376, rope_theta=10000.0,
                 loss_chunk=2048)
    calls = []

    def checked(*a, **k):
        copies = [x.clone() if isinstance(x, torch.Tensor) else x for x in a]
        out = kernel(*a, **k)
        want = ref(*copies, **k)
        calls.append({"step": a[-3], "side": k.get("side"), "shape": tuple(a[0].shape),
                      "errs": [float((o.float() - w.float()).abs().max())
                               for o, w in zip(out, want)]})
        return out

    def plain_power(g, q):
        if g.dim() == 2:
            return power_iter_ref(g[None], q[None].float())[0]
        return power_iter_ref(g, q.float())

    updates = {"checked": checked, "plain": lambda *a, **k: ref(*a, **k), "kernel": kernel}
    kernels = {"rmsnorm": (rmsnorm_ops, "rmsnorm", rmsnorm_ops.rmsnorm, rmsnorm_ref),
               "power": (power_ops, "power_iter_step", power_ops.power_iter_step, plain_power)}
    try:
        for mode in args.modes.split(","):
            update, engine, dtype, plain = MODES[mode]
            setattr(update_ops, op_name, updates[update])
            for key, (mod, name, op, plain_op) in kernels.items():
                setattr(mod, name, plain_op if key in plain else op)
            attn = dict(attn_impl="exact") if "flash" in plain else {}
            cfg, model = common.bench_model(512, args.layers, 32100, device="cuda", dtype=dtype,
                                            **width, **attn)
            for seed in (int(s) for s in args.seeds.split(",")):
                data = common.SharedBatches(common.bench_data(
                    cfg, seq=256, batch=args.batch, seed=3 + seed, device="cuda"), args.steps)
                out = common.train_once(model, data, args.optimizer, steps=args.steps, lr=2e-3,
                                        rank=128, tau=args.tau, alpha=0.25, seed=seed,
                                        engine=engine, svd_backend="randomized")
                ls = out["losses"]
                print(f"{mode}, seed {seed}: losses {[round(x, 3) for x in ls[::args.every]]}, "
                      f"final {out['final_loss']:.4f}, max after step 0 {max(ls[1:]):.4f}",
                      flush=True)
    finally:
        setattr(update_ops, op_name, kernel)
        for mod, name, op, _ in kernels.values():
            setattr(mod, name, op)
    print(torch.cuda.get_device_name(0))
    if not calls:
        return 0
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"fused_trajectory_{args.optimizer}_b{args.batch}.json").write_text(json.dumps(calls))
    worst = max(c["errs"][0] for c in calls)
    print(f"{args.optimizer}: {len(calls)} calls; largest W' error {worst:.3e}; largest of "
          f"each output {[max(c['errs'][i] for c in calls) for i in range(len(calls[0]['errs']))]}")
    return 0 if worst <= TOL else 1


if __name__ == "__main__":
    sys.exit(main())
