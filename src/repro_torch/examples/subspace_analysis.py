"""The paper's subspace phenomenology (Figs. 2-4) on the port, from
``examples/subspace_analysis.py``:

  1. frozen dominant subspace: adjacent overlap under GaLore rises with step;
  2. SARA keeps adjacent overlap low (more exploration);
  3. SARA's accumulated updates have higher effective rank.

    PYTHONPATH=src python -m repro_torch.examples.subspace_analysis              # on the card
    PYTHONPATH=src python -m repro_torch.examples.subspace_analysis --device cpu --steps 40

The reference's CPU scale (d_model 96, 2 layers, rank 8, tau 10).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.benchmarks.common import bench_data, bench_model, train_once
from repro_torch.core.metrics import effective_rank, update_singular_spectrum


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--tau", type=int, default=10)
    args = ap.parse_args(argv)

    cfg, model = bench_model(device=args.device)
    data = bench_data(cfg, device=args.device)
    params0 = model.init(torch.Generator(device=model.device).manual_seed(0))

    print("== adjacent subspace overlap over refreshes (Fig. 2/3a) ==")
    series = {}
    for name in ("galore-adam", "galore-sara-adam"):
        out = train_once(model, data, name, steps=args.steps, tau=args.tau, track_overlap=True)
        series[name] = out
        ovl = out["overlaps"]
        print(f"  {name:20s} first3={[round(x, 3) for x in ovl[:3]]} "
              f"last3={[round(x, 3) for x in ovl[-3:]]} mean={sum(ovl) / len(ovl):.3f}")
    print("  -> SARA adjacent overlap should be consistently lower.")

    print("\n== update effective rank (Fig. 4) ==")
    for name, out in series.items():
        w0 = params0["blocks"]["q_proj"][0]
        w1 = out["state"].params["blocks"]["q_proj"][0]
        spec = update_singular_spectrum(w0, w1)
        print(f"  {name:20s} effective_rank={float(effective_rank(spec)):.2f}"
              f" top8_mass={float(spec[:8].sum() / spec.sum()):.3f}")
    print("  -> SARA spreads update energy over more directions.")


if __name__ == "__main__":
    main()
