"""The port's dry run (``launch/dryrun.py``): every cell built on the meta
device and counted, never run.

  * Its param and optimizer-state bytes equal a real CPU build's
    (``state_memory_bytes``) for the smoke llama3-8b, deepseek-moe-16b and
    mamba2-370m, on one process, for three inners and ZeRO state.
  * In a spawned gloo world of two processes, each process's measured
    param and state bytes after ``fns["place_state"]`` equal the dry run's
    for process 0 of the same mesh: FSDP (2, 1), FSDP with ZeRO, the
    compressed step with ZeRO, and tensor parallel (1, 2).
  * ``--all`` counts every runnable cell of the 40 at full width in a
    bounded time, writing one artifact each, and a schedule's model and
    the roofline terms travel with the artifact.

The world's rules are ``test_torch_distributed.py``'s (a ``file://``
store, one intra-op thread, a 60-s group timeout); this file imports no
JAX."""
import json
import os
import time
from datetime import timedelta

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import cells, get_config
from repro_torch.core import make_optimizer
from repro_torch.core import rank_schedule as rs_lib
from repro_torch.core.lowrank import state_memory_bytes, tree_leaves
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import build_model
from repro_torch.roofline import hw
from repro_torch.train.state import TrainState
from repro_torch.train.step import make_train_step

torch.set_num_threads(1)

ARCHS = ("llama3-8b", "deepseek-moe-16b", "mamba2-370m")
OPTIMIZERS = ("galore-sara-adam", "galore-sara-adam8bit", "galore-sara-msgd")
TIMEOUT = timedelta(seconds=60)
ALL_CELLS_S = 120  # --all at full width, on the meta device
# (mesh, compressed, zero) of the world's cases
WORLD_CASES = {"fsdp": ("2,1", "", ""), "fsdp_zero": ("2,1", "", "zero"),
               "flat_zero": ("2,1", "flat", "zero"), "tp": ("1,2", "", "")}
WORLD_ARCHS = ("deepseek-moe-16b", "llama3-8b")


def _args(**kw):
    args = dryrun.parser().parse_args([])
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def _real_optimizer(cfg, params, name, **kw):
    return make_optimizer(name, params, rank=min(512, max(8, cfg.d_model // 4)), tau=200,
                          lr=0.01, engine="bucketed", svd_backend="randomized", **kw)


@pytest.mark.parametrize("zero", [False, True])
@pytest.mark.parametrize("name", OPTIMIZERS)
@pytest.mark.parametrize("arch", ARCHS)
def test_state_bytes_equal_a_real_cpu_build(arch, name, zero):
    cfg = get_config(arch, smoke=True).with_(dtype=torch.float32)
    args = _args(optimizer=name, state_sharding="zero" if zero else "")
    rep = dryrun.run_cell(arch, "train_4k", args, cfg=cfg)
    params = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    opt = _real_optimizer(cfg, params, name,
                          **(dict(state_sharding="zero", state_shards=1) if zero else {}))
    state = opt.init(params)
    mem = rep.memory_per_device
    assert mem["opt_state_bytes"] == state_memory_bytes(state)
    assert mem["param_bytes"] == mem["grad_bytes"] == sum(
        p.numel() * p.element_size() for p in tree_leaves(params))
    assert rep.extra["fits"] and rep.extra["activations"].startswith("not counted")


# ---------------------------------------------------------------------------
# the world: each process's measured bytes against the dry run's
# ---------------------------------------------------------------------------


def _world(rank, world, store, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world,
                            rank=rank, timeout=TIMEOUT)
    try:
        out = {}
        meshes = {}
        for arch in WORLD_ARCHS:
            cfg = get_config(arch, smoke=True).with_(dtype=torch.float32)
            model = build_model(cfg, device="cpu")
            params = model.init(torch.Generator().manual_seed(0))
            for case, (mesh_text, compressed, zero) in WORLD_CASES.items():
                shape = tuple(int(x) for x in mesh_text.split(","))
                if shape not in meshes:
                    meshes[shape] = mesh_lib.make_mesh(shape)
                mesh = meshes[shape]
                kw = dict(state_sharding="zero", state_shards=mesh.dp) if zero else {}
                opt = _real_optimizer(cfg, params, "galore-sara-adam", **kw)
                fns = make_train_step(model, opt, mesh=mesh, compressed=compressed)
                local = fns["place_state"](TrainState(params, opt.init(params)))
                out[(arch, case)] = (
                    sum(p.numel() * p.element_size() for p in tree_leaves(local.params)),
                    state_memory_bytes(local.opt_state))
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world_bytes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun_world")
    mp.spawn(_world, args=(2, str(tmp / "store"), str(tmp)), nprocs=2, join=True)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]


@pytest.mark.parametrize("case", list(WORLD_CASES))
@pytest.mark.parametrize("arch", WORLD_ARCHS)
def test_world_bytes_per_process_equal_the_dry_run(world_bytes, arch, case):
    mesh_text, compressed, zero = WORLD_CASES[case]
    cfg = get_config(arch, smoke=True).with_(dtype=torch.float32)
    rep = dryrun.run_cell(arch, "train_4k", _args(mesh=mesh_text, compressed_dp=compressed,
                                                  state_sharding=zero), cfg=cfg)
    got = world_bytes[0][(arch, case)]
    assert world_bytes[1][(arch, case)] == got
    mem = rep.memory_per_device
    assert (mem["param_bytes"], mem["opt_state_bytes"]) == got, (arch, case)
    assert rep.n_chips == 2 and rep.mesh == mesh_text


def test_all_cells_at_full_width(tmp_path):
    """``--all`` (the 32 runnable cells of the 40) counts each cell and
    writes its artifact, in a bounded time."""
    t0 = time.time()
    assert dryrun.main(["--all", "--out-dir", str(tmp_path)]) == 0
    assert time.time() - t0 < ALL_CELLS_S
    runnable = cells()
    assert len(cells(include_skipped=True)) == 40 and len(runnable) == 32
    names = sorted(os.listdir(tmp_path))
    assert names == sorted(f"{a}__{s}__1x1.json" for a, s, _ in runnable)
    for a, s, _ in runnable:
        art = json.loads((tmp_path / f"{a}__{s}__1x1.json").read_text())
        assert art["arch"] == a and art["shape"] == s
        assert art["extra"]["kind"] == SHAPES[s].kind
        assert art["memory_per_device"]["total_bytes"] > 0
        assert art["extra"]["fits"] == (art["memory_per_device"]["total_bytes"] <= hw.HBM_BYTES)
    # --skip-existing passes over them all
    assert dryrun.main(["--all", "--out-dir", str(tmp_path), "--skip-existing"]) == 0


def test_schedule_mesh_and_roofline_in_the_artifact(tmp_path, capsys):
    """Under a schedule the artifact carries ``scheduled_state_model``; the
    collective term reads the bytes over ``model`` and ``data``; a bad mesh
    fails before any cell."""
    assert dryrun.main(["--arch", "llama3-8b", "--shape", "train_4k", "--mesh", "2,2",
                        "--compressed-dp", "--state-sharding", "zero", "--rank-schedule",
                        "cosine:128:32@0.5", "--out-dir", str(tmp_path)]) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[ok]")][0]
    assert "sched_peak=" in line and "fits_80GB=True" in line
    art = json.loads((tmp_path / "llama3-8b__train_4k__2x2.json").read_text())
    sched = art["extra"]["rank_schedule"]
    cfg = get_config("llama3-8b")
    meta = build_model(cfg, device="meta").init(torch.Generator())
    opt = make_optimizer("galore-sara-adam", meta, rank=128, tau=200, lr=0.01,
                         engine="bucketed", svd_backend="randomized",
                         rank_schedule="cosine:128:32@0.5", state_sharding="zero",
                         state_shards=2)
    want = rs_lib.scheduled_state_model(opt.config, meta,
                                        rs_lib.parse_rank_schedule("cosine:128:32@0.5"),
                                        total_steps=10000, state_shards=2)
    want.pop("rank_plans")
    assert sched == json.loads(json.dumps(want))
    coll = art["collectives"]
    assert coll["model"] > 0 and coll["data"] > 0
    assert art["collective_bytes"] == coll["model"] + coll["data"]
    assert art["collective_term_s"] == art["collective_bytes"] / hw.COLLECTIVE_BYTES_PER_S
    with pytest.raises(ValueError):
        dryrun.main(["--arch", "llama3-8b", "--shape", "train_4k", "--mesh", "1,2,3,4",
                     "--out-dir", str(tmp_path)])
