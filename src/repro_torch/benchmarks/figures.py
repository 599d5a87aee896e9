"""The paper's figures 2-4 as numeric rows, from ``benchmarks/figures.py``.

fig2: frozen dominant subspace -- adjacent overlap under GaLore climbs as
      training progresses (the paper's motivating observation).
fig3: SARA lowers adjacent + anchor overlap vs dominant selection.
fig4: SARA's accumulated weight updates have flatter singular spectra
      (higher effective rank) than dominant selection's.

``fig2``-``fig4`` train their own runs (the reference's 200 steps at tau 10,
``device`` and ``bench_model`` overrides as in ``tables.py``); ``fig2_row``,
``fig3_rows`` and ``fig4_row`` read the rows off runs already made by
``train_once(..., track_overlap=True)``, such as table 1's.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch.benchmarks.common import Row, SharedBatches, bench_data, bench_model, train_once
from repro_torch.core.metrics import effective_rank, update_singular_spectrum

FIG_STEPS, FIG_TAU = 200, 10


def _mean(xs) -> float:
    return float(sum(xs) / len(xs))


def _setup(device: str, d_model: int, n_layers: int, model_kw: Optional[Dict], steps: int):
    cfg, model = bench_model(d_model=d_model, n_layers=n_layers, device=device,
                             **(model_kw or {}))
    return model, SharedBatches(bench_data(cfg, device=device), steps)


def fig2_row(out: Dict) -> Row:
    """Adjacent dominant-subspace overlap early vs late in training."""
    ovl = out["overlaps"]
    early, late = _mean(ovl[:3]), _mean(ovl[-3:])
    return ("fig2/adjacent_overlap_galore", out["us_per_step"],
            f"early={early:.3f} late={late:.3f} frozen={late > early}")


def fig3_rows(series: Dict[str, Dict]) -> List[Row]:
    """fig3a: mean adjacent overlap per method; fig3b: the last one."""
    rows: List[Row] = [
        (f"fig3a/adjacent[{name}]", out["us_per_step"],
         f"mean_overlap={_mean(out['overlaps']):.3f}")
        for name, out in series.items()
    ]
    rows += [(f"fig3b/final_vs_first[{name}]", 0.0,
              f"last_adjacent={out['overlaps'][-1]:.3f}") for name, out in series.items()]
    return rows


def fig4_row(name: str, out: Dict, params0, rank: int = 8) -> Row:
    """Effective rank of layer 0's accumulated q_proj update (the paper's
    per-layer spectra), and the spectrum's mean beyond the projector rank."""
    w0 = params0["blocks"]["q_proj"][0]
    w1 = out["state"].params["blocks"]["q_proj"][0]
    spec = update_singular_spectrum(w0, w1)
    er = float(effective_rank(spec))
    tail = float(torch.mean(spec[rank:]))
    return (f"fig4/update_rank[{name}]", out["us_per_step"],
            f"effective_rank={er:.2f} tail_mass={tail:.4f}")


def fig2(device: str = "cuda", steps: int = FIG_STEPS, tau: int = FIG_TAU, d_model: int = 96,
         n_layers: int = 2, model_kw: Optional[Dict] = None, **train_kw) -> List[Row]:
    model, data = _setup(device, d_model, n_layers, model_kw, steps)
    out = train_once(model, data, "galore-adam", steps=steps, tau=tau, track_overlap=True,
                     **train_kw)
    return [fig2_row(out)]


def fig3(device: str = "cuda", steps: int = FIG_STEPS, tau: int = FIG_TAU, d_model: int = 96,
         n_layers: int = 2, model_kw: Optional[Dict] = None, **train_kw) -> List[Row]:
    model, data = _setup(device, d_model, n_layers, model_kw, steps)
    series = {name: train_once(model, data, name, steps=steps, tau=tau, track_overlap=True,
                               **train_kw)
              for name in ("galore-adam", "galore-sara-adam")}
    assert series["galore-sara-adam"]["overlaps"], "no overlaps tracked"
    return fig3_rows(series)


def fig4(device: str = "cuda", steps: int = FIG_STEPS, tau: int = FIG_TAU, d_model: int = 96,
         n_layers: int = 2, model_kw: Optional[Dict] = None, **train_kw) -> List[Row]:
    model, data = _setup(device, d_model, n_layers, model_kw, steps)
    seed = train_kw.get("seed", 0)
    params0 = model.init(torch.Generator(device=model.device).manual_seed(seed))
    rank = train_kw.get("rank", 8)
    return [fig4_row(name, train_once(model, data, name, steps=steps, tau=tau, **train_kw),
                     params0, rank)
            for name in ("galore-adam", "galore-sara-adam", "adam")]
