"""The paper's tables 1-4 on the port, from ``benchmarks/tables.py``.

table1: optimizer matrix -- Full Adam vs GaLore(+SARA) x
        {Adam, Adafactor, Adam-mini, 8-bit Adam} and Fira(+SARA).
table2: 'scale-up' proxy -- a deeper/wider model, full vs galore vs sara.
table3: additional baselines -- GoLore, online-PCA vs SARA.
table4: second dataset (zipf 'SlimPajama' analog).

Each table takes ``_matrix``'s keywords: the reference's shape arguments
(``steps``, ``d_model``, ``n_layers``, ``seq``, ``batch``), ``device``,
``model_kw`` (``bench_model`` overrides: a published width, the compute
dtype), ``results`` (a dict that collects each optimizer's run and lends
runs already in it to the next table on the same data), and ``train_once``
keywords (``lr``, ``rank``, ``tau``, ``track_overlap``, optimizer fields
such as ``engine``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

from repro_torch.benchmarks.common import (
    Row, SharedBatches, bench_data, bench_model, gap_reduction, train_once,
)

STEPS = 150

# (base, ours) pairs whose gap reduction a table reports when it has both
GAP_PAIRS = (
    ("galore-adam", "galore-sara-adam"),
    ("fira-adam", "fira-sara-adam"),
    ("galore-adafactor", "galore-sara-adafactor"),
    ("galore-adam-mini", "galore-sara-adam-mini"),
    ("galore-adam8bit", "galore-sara-adam8bit"),
    ("golore-adam", "galore-sara-adam"),
    ("online-pca-adam", "galore-sara-adam"),
)

TABLE1 = [
    "adam",
    "galore-adam", "galore-sara-adam",
    "fira-adam", "fira-sara-adam",
    "galore-adafactor", "galore-sara-adafactor",
    "galore-adam-mini", "galore-sara-adam-mini",
    "galore-adam8bit", "galore-sara-adam8bit",
]
TABLE3 = ["adam", "golore-adam", "online-pca-adam", "galore-sara-adam"]
SCALE_NAMES = ["adam", "galore-adam", "galore-sara-adam"]  # tables 2 and 4


def _matrix(names, steps=STEPS, d_model=96, n_layers=2, dist="bigram", seq=64, batch=8, *,
            device: str = "cuda", model_kw: Optional[Dict] = None,
            results: Optional[Dict[str, Dict]] = None, **opt_kw) -> List[Row]:
    cfg, model = bench_model(d_model=d_model, n_layers=n_layers, device=device,
                             **(model_kw or {}))
    data = SharedBatches(bench_data(cfg, dist=dist, seq=seq, batch=batch, device=device), steps)
    floor = data.bigram_entropy() if dist == "bigram" else math.nan
    results = {} if results is None else results
    rows: List[Row] = []
    for name in names:
        if name not in results:
            results[name] = train_once(model, data, name, steps=steps, **opt_kw)
        out = results[name]
        rows.append((
            name, out["us_per_step"],
            f"final_loss={out['final_loss']:.4f} floor={floor:.4f}",
        ))
    full = results.get("adam")
    if full and "adam" in names:
        for base, ours in GAP_PAIRS:
            if base in names and ours in names:
                red = gap_reduction(
                    full["final_loss"], results[base]["final_loss"],
                    results[ours]["final_loss"],
                )
                rows.append((
                    f"gap_reduction[{ours} vs {base}]", 0.0,
                    f"{red:.1f}%" if red is not None else "base<=full",
                ))
    return rows


def table1(**kw) -> List[Row]:
    return [("table1/" + n, u, d) for n, u, d in _matrix(TABLE1, **kw)]


def table2(**kw) -> List[Row]:
    """Scale proxy: 4 layers, d=128 (the 1.1B row of the paper)."""
    kw = dict(dict(d_model=128, n_layers=4, steps=120), **kw)
    return [("table2/" + n, u, d) for n, u, d in _matrix(SCALE_NAMES, **kw)]


def table3(**kw) -> List[Row]:
    return [("table3/" + n, u, d) for n, u, d in _matrix(TABLE3, **kw)]


def table4(**kw) -> List[Row]:
    kw = dict(dict(dist="zipf"), **kw)
    return [("table4/" + n, u, d) for n, u, d in _matrix(SCALE_NAMES, **kw)]
