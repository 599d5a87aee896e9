"""The port's paper drivers (``repro_torch.benchmarks.tables`` and
``figures``) against the JAX package's (``benchmarks/tables.py``,
``figures.py``) on the CPU, and the port's examples.

Each driver runs for real at a tiny width and a few steps on the CPU; its
row names must equal JAX's and its ``derived`` strings must parse.  JAX's
names come from its drivers with ``train_once`` replaced by a stand-in
that trains nothing; the same stand-in, handed to both packages' drivers,
gives the same ``derived`` strings (the gap reductions, the overlap and
rank summaries), but for the corpus floor, which each package's own data
generator sets."""
import math
import re
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import pytest
import torch

from repro.core import make_optimizer as jax_make_optimizer
from repro_torch.benchmarks import common, figures, tables

sys.path.append(str(Path(__file__).resolve().parents[1]))
from benchmarks import figures as jax_figures  # noqa: E402  (the repo root's package)
from benchmarks import tables as jax_tables  # noqa: E402

# One intra-op thread: the test workers share the host's cores, and the
# port's results do not depend on the thread count (core/svd.py).
torch.set_num_threads(1)

DRIVERS = ["table1", "table2", "table3", "table4", "fig2", "fig3", "fig4"]
# the tiny CPU run: 4 steps at tau 2 (refreshes 0 and 2: one overlap)
TINY = dict(device="cpu", steps=4, tau=2, d_model=32, n_layers=2)
TINY_TABLE = dict(TINY, seq=16, batch=2)
# final losses of the stand-in: full Adam best, SARA between it and GaLore
# on the first pairs, worse on the last (both signs of a gap reduction)
FAKE = {name: 3.0 + 0.01 * i for i, name in enumerate(
    ["adam", "galore-sara-adam", "galore-adam", "fira-sara-adam", "fira-adam",
     "galore-adafactor", "galore-sara-adafactor", "golore-adam", "online-pca-adam",
     "galore-sara-adam-mini", "galore-adam-mini", "galore-adam8bit", "galore-sara-adam8bit"])}
FAKE_OVERLAPS = [0.31, 0.42, 0.47, 0.55, 0.58]


def _table_stand_in(model, data, opt_name, steps=150, **kw):
    return {"final_loss": FAKE[opt_name], "us_per_step": 0.0}


_JAX_INIT = {}  # the stand-in's params, one init per model config


def _jax_fig_stand_in(model, data, opt_name, steps=150, **kw):
    if model.cfg not in _JAX_INIT:
        _JAX_INIT[model.cfg] = jax.jit(model.init)(jax.random.PRNGKey(0))
    params = _JAX_INIT[model.cfg]
    opt = jax_make_optimizer(opt_name, params, **({} if opt_name == "adam" else dict(rank=8)))
    return {"final_loss": FAKE[opt_name], "us_per_step": 0.0, "overlaps": FAKE_OVERLAPS,
            "optimizer": opt,
            "state": SimpleNamespace(params=params, opt_state=jax.eval_shape(opt.init, params))}


def _port_fig_stand_in(model, data, opt_name, steps=150, **kw):
    params = model.init(torch.Generator().manual_seed(0))
    return {"final_loss": FAKE[opt_name], "us_per_step": 0.0, "overlaps": FAKE_OVERLAPS,
            "state": SimpleNamespace(params=params)}


def _fields(derived):
    """A derived string as {key: float}: ``k=v`` pairs, or one percentage
    (a gap reduction), or ``base<=full``."""
    if derived == "base<=full":
        return {"gap": None}
    if derived.endswith("%"):
        return {"gap": float(derived[:-1])}
    out = {}
    for key, val in re.findall(r"(\w+)=(\S+)", derived):
        out[key] = {"True": 1.0, "False": 0.0}.get(val, None)
        if out[key] is None:
            out[key] = float(val)
    assert out, derived
    return out


def _stand_in_rows(monkeypatch, name):
    monkeypatch.setattr(jax_tables, "train_once", _table_stand_in)
    monkeypatch.setattr(jax_figures, "train_once", _jax_fig_stand_in)
    monkeypatch.setattr(tables, "train_once", _table_stand_in)
    monkeypatch.setattr(figures, "train_once", _port_fig_stand_in)
    jrows = getattr(jax_tables if name.startswith("table") else jax_figures, name)()
    trows = getattr(tables if name.startswith("table") else figures, name)(device="cpu")
    return jrows, trows


@pytest.mark.parametrize("name", DRIVERS)
def test_driver_rows_match_jax(monkeypatch, name):
    jrows, stand_in = _stand_in_rows(monkeypatch, name)
    assert [r[0] for r in stand_in] == [r[0] for r in jrows]
    for (_, _, jd), (_, _, td) in zip(jrows, stand_in):
        jf, tf = _fields(jd), _fields(td)
        jf.pop("floor", None)
        assert math.isfinite(tf.pop("floor", 0.0)) or "table4" == name
        assert tf == jf, (jd, td)
    monkeypatch.undo()
    module = tables if name.startswith("table") else figures
    rows = getattr(module, name)(**(TINY_TABLE if name.startswith("table") else TINY))
    assert [r[0] for r in rows] == [r[0] for r in jrows]
    for row_name, us, derived in rows:
        fields = _fields(derived)
        assert us >= 0.0 and fields, row_name
        assert all(v is None or math.isfinite(v) for k, v in fields.items() if k != "floor")


def test_matrix_lends_runs_and_records_its_engine():
    """A table that shares a run dict reuses the rows it finds there (table
    3 takes table 1's adam and galore-sara-adam); each run records its
    state layout, its memory report and its kernels (none on the CPU)."""
    runs = {}
    tables.table1(results=runs, engine="bucketed", **TINY_TABLE)
    first = {n: runs[n] for n in ("adam", "galore-sara-adam")}
    rows = tables.table3(results=runs, engine="bucketed", **TINY_TABLE)
    assert all(runs[n] is first[n] for n in first) and len(runs) == 13
    assert {n for n, r in runs.items() if r["engine"] == "bucketed"} == {
        "galore-adam", "galore-sara-adam", "galore-adam-mini", "galore-sara-adam-mini",
        "galore-adam8bit", "galore-sara-adam8bit", "golore-adam", "online-pca-adam"}
    assert runs["adam"]["memory"]["state_to_param_ratio"] > 1.99
    assert all(r["memory"]["allocator_growth"] is None and r["launches"] == {}
               for r in runs.values())
    assert rows[0][1:] == tables.table1(results=runs, **TINY_TABLE)[0][1:]
    common.record("table3/adam", rows[0][1], device="cpu", engine="reference",
                  state_layout="perleaf")
    assert common.JSON_RECORDS[-1]["device"] == "cpu"
    with pytest.raises(TypeError):
        common.record("x", 1.0)  # the device is required


@pytest.mark.parametrize("example", ["quickstart", "subspace_analysis", "serve_decode"])
def test_examples_need_a_card_unless_cpu_is_asked(example, monkeypatch):
    import importlib

    mod = importlib.import_module(f"repro_torch.examples.{example}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main([])


def test_quickstart_trains_on_every_run(capsys, tmp_path):
    """Two runs in a row each train from step 0: without ``--ckpt-dir``
    each takes a fresh checkpoint directory, so the second does not resume
    the checkpoints the first wrote.  A named directory is resumed."""
    from repro_torch.examples import quickstart

    named = ["--ckpt-dir", str(tmp_path)]
    outs = []
    for argv in ([], [], named, named):
        quickstart.main(["--device", "cpu", "--steps", "2"] + argv)
        outs.append(capsys.readouterr().out)
    losses = [re.search(r"loss: (\S+) ->", out) for out in outs]
    assert all(losses[:3]), outs
    assert losses[0].group(1) == losses[1].group(1) == losses[2].group(1)
    assert losses[3] is None and "nothing to run" in outs[3], outs[3]
