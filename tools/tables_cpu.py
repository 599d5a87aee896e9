#!/usr/bin/env python3
"""The paper's experiments in both packages on the CPU, side by side.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/tables_cpu.py [--json out.json]
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/tables_cpu.py --trajectory galore-adam8bit \\
        [--n-layers 2 --batch 8 --lr 2e-3 --steps 60 --compute bf16 ...]

Without ``--trajectory``: tables 1, 3 and 4 at the JAX package's CPU scale
(d_model 96, 2 layers, seq 64, batch 8, rank 8, tau 20, 150 steps).  Each
package trains from its own init, batches and refresh draws (the port's
are not JAX's: tests/test_torch_tables.py holds the two on JAX's), so the
rows compare as two runs of the same experiment.  Prints one line per row
(the final loss, or the gap reduction, of each package) and, with
``--json``, writes the rows.  Table 3 reuses table 1's adam and
galore-sara-adam runs in the port, as the card's ``tables`` phase does;
the JAX package's table 3 trains them again, with the same result.

With ``--trajectory NAME``: one optimizer's run in both packages from the
same start -- JAX's init, JAX's batches and JAX's refresh draws -- at the
card's ``tables`` configuration (LLaMA-60M's widths: d_model 512, 8 heads
of 64, d_ff 1376, vocab 32100, seq 256; rank 128, alpha 0.25, the
randomized SVD, the bucketed engine) cut in depth and batch by the flags,
and at the compute dtype of ``--compute`` (f32 params either way); the
init from ``--seed``, the corpus from 3 + ``--seed``.  Prints
both loss trajectories, each one's largest loss after step 0, and with
``--json`` writes them.  A check tool: it imports JAX, which the port
never does.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def tables(args) -> int:
    import torch

    from benchmarks import tables as jax_tables
    from repro_torch.benchmarks import tables

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    jrows = jax_tables.table1() + jax_tables.table3() + jax_tables.table4()
    t1 = time.perf_counter()
    runs = {}
    trows = (tables.table1(results=runs, device="cpu") + tables.table3(results=runs, device="cpu")
             + tables.table4(device="cpu"))
    t2 = time.perf_counter()
    if [r[0] for r in jrows] != [r[0] for r in trows]:
        raise SystemExit("the packages' row names differ")
    out = []
    for (name, _, jd), (_, _, td) in zip(jrows, trows):
        print(f"{name:60s} jax {jd:36s} port {td}")
        out.append({"name": name, "jax": jd, "port": td})
    print(f"jax {t1 - t0:.1f} s, port {t2 - t1:.1f} s (CPU)")
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


def trajectory(args) -> int:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from benchmarks import common as jax_common
    from repro.models import build_model as jax_build_model
    from repro_torch import bridge
    from repro_torch.benchmarks import common
    from test_torch_optim_kernels import JaxDraws

    torch.set_num_threads(args.threads)
    width = dict(n_heads=8, n_kv_heads=8, head_dim=64, d_ff=1376, rope_theta=10000.0,
                 loss_chunk=2048)
    jdtype, tdtype = {"bf16": (jnp.bfloat16, torch.bfloat16),
                      "f32": (jnp.float32, torch.float32)}[args.compute]
    jcfg, _ = jax_common.bench_model(args.d_model, args.n_layers, args.vocab)
    jcfg = jcfg.with_(dtype=jdtype, **width)
    jmodel = jax_build_model(jcfg)
    jmodel = jmodel._replace(init=jax.jit(jmodel.init))
    jdata = jax_common.bench_data(jcfg, seq=args.seq, batch=args.batch, seed=3 + args.seed)
    batches = [jdata.batch_at(step) for step in range(args.steps)]

    class Batches:
        def __init__(self, as_torch):
            self.as_torch = as_torch

        def batch_at(self, step):
            if self.as_torch:
                return {k: torch.from_numpy(np.array(v)) for k, v in batches[step].items()}
            return batches[step]

    kw = dict(steps=args.steps, lr=args.lr, rank=args.rank, tau=args.tau, alpha=args.alpha,
              seed=args.seed, engine="bucketed", svd_backend="randomized")
    t0 = time.perf_counter()
    jo = jax_common.train_once(jmodel, Batches(False), args.trajectory, **kw)
    t1 = time.perf_counter()
    _, tmodel = common.bench_model(args.d_model, args.n_layers, args.vocab, device="cpu",
                                   dtype=tdtype, **width)
    init = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(args.seed)))
    draws = JaxDraws(jax.random.PRNGKey(jo["optimizer"].config.seed))
    to = common.train_once(tmodel, Batches(True), args.trajectory,
                           params=bridge.params_from_numpy(init, "cpu"), draws=draws, **kw)
    t2 = time.perf_counter()
    out = {"name": args.trajectory, "config": vars(args)}
    for pkg, run, secs in (("jax", jo, t1 - t0), ("port", to, t2 - t1)):
        losses = [float(x) for x in run["losses"]]
        out[pkg] = {"losses": losses, "final": run["final_loss"], "max_after_0": max(losses[1:])}
        print(f"{pkg}: losses {[round(x, 3) for x in losses]}; final {run['final_loss']:.4f}, "
              f"largest after step 0 {max(losses[1:]):.4f}; {secs:.1f} s (CPU)", flush=True)
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default="")
    ap.add_argument("--trajectory", default="", help="an optimizer name: one run per package")
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--n-layers", type=int, default=2)
    ap.add_argument("--vocab", type=int, default=32100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--rank", type=int, default=128)
    ap.add_argument("--alpha", type=float, default=0.25)
    ap.add_argument("--tau", type=int, default=12)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--compute", choices=["bf16", "f32"], default="bf16")
    ap.add_argument("--seed", type=int, default=0, help="the init's; the corpus's is 3 + seed")
    ap.add_argument("--threads", type=int, default=4, help="torch's intra-op threads")
    args = ap.parse_args(argv)
    sys.path.append(str(ROOT))
    sys.path.append(str(ROOT / "tests"))
    return trajectory(args) if args.trajectory else tables(args)


if __name__ == "__main__":
    sys.exit(main())
