"""The port's FSDP over ``data`` (``launch/mesh.py``'s data axis,
``launch/sharding.param_splits``, ``models/parallel.gather_from_data`` and
``DataShards``, the layers' gathers at use, ``core/lowrank``'s optimizer of
blocks over two axes, ``train/step.py``'s standard step, ``train/loop.py``'s
checkpoints and the launcher), in spawned gloo worlds on the CPU: (2, 1)
and (4, 1) FSDP, (2, 2) FSDP with tensor parallelism, (2, 2, 1) pod x
data.  The processes' side is in this module too; it imports no JAX (the
parent imports it inside its fixtures), so the spawned processes do not.

JAX's sharded standard step fails on this tree's jax
(``tests/test_distributed.py``), but under GSPMD it computes the single
device's math: so the FSDP step is held against the single-process step
of both packages.  JAX's expert-parallel MoE layer runs on 4 forced host
devices, so the (2, 2) layer is held against it directly.

The models: the smoke llama at f32 with d 128, 4 heads, 2 KV heads and
d_ff 256 (every weight splits over ``data`` at 2, the guard's
``MIN_SHARD_EXTENT`` of 64), d 256 at a ``data`` extent of 4, and the MoE
smoke configs (olmoe on the local path at (2, 1), deepseek on the
expert-parallel path at (2, 2) with capacity factor 8, no pair dropped),
whose expert d_ff splits over ``data`` at any width; rank 8, tau 4, seq
32, global batch 4, the randomized SVD; 3 steps (a refresh, 2 hot).

Bars:
  * ``REFRESH_TOL`` (5e-5 abs on params) after each step of a trajectory
    that starts with a refresh (``test_torch_tensor_parallel.py``: the
    sketch's products summed over processes move the randomized SVD's
    last bits, and SARA's draw and Adam's first step amplify them), the
    step-0 loss within ``LOSS_TOL`` (1e-5);
  * ``HOT_LOOP_TOL`` (1e-6 abs) after one hot step from the
    single-process state (the same sums in other orders);
  * the MoE models' references run the global batch in microbatches of
    one process's rows (``TrainConfig.microbatch``): the router's aux
    loss is a product of two means over the tokens a process routes, so
    a world's gradient is the mean of its processes', as JAX's pmean of
    per-shard losses is, not the whole batch's;
  * against JAX's single-device step on JAX's params, batch, gradients
    and draws: ``GRAD_TOL`` (1e-6 abs + 1e-5 rel) on the loss and the
    step's reduced gradients, ``REFRESH_TOL`` after the refresh,
    ``HOT_LOOP_TOL`` after a hot step from JAX's post-refresh state;
  * the (2, 2) MoE layer's output and aux within ``EP_TOL`` (1e-5) of
    JAX's expert-parallel path, as many pairs dropped as JAX drops (which
    pairs: ``test_torch_tensor_parallel.py``'s EP cases);
  * exact: the bytes handed to the ``data`` collectives in a hot step
    against ``core.lowrank.fsdp_hot_comm_bytes``, every split leaf's local
    shape against ``param_spec``, and the processes' gathered params
    against each other.
"""
import os
import re
import shutil
import subprocess
import sys
import textwrap
import time
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import bridge
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import make_optimizer
from repro_torch.core.lowrank import (canonical_opt_state, flatten_with_path,
                                      fsdp_hot_comm_bytes, tree_leaves)
from repro_torch.data.synthetic import SyntheticDataConfig, SyntheticDataset
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as shd
from repro_torch.models import build_model
from repro_torch.models import moe as moe_lib
from repro_torch.models import parallel as par
from repro_torch.train.loop import train_loop
from repro_torch.train.state import TrainState
from repro_torch.train.step import make_train_step

import tp_worlds as W

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# One intra-op thread: the test workers share the host's cores, and the
# port's results do not depend on the thread count (core/svd.py).
torch.set_num_threads(1)

REFRESH_TOL = 5e-5
HOT_LOOP_TOL = 1e-6
LOSS_TOL = 1e-5
GRAD_TOL = dict(atol=1e-6, rtol=1e-5)
EP_TOL = 1e-5
WORLD_TIMEOUT_S = 180  # each world's own limit: a hang fails, not the suite's clock
GROUP_TIMEOUT = timedelta(seconds=60)
MOE_CAPACITY = 8.0
# (2, 2): JAX's EP layer on its params and input (``test_torch_tensor_parallel.
# _EP_SCRIPT``): (capacity factor, expert d_ff), d_ff 64 splits the fused
# shared experts over ``model`` too
EP_CASES = {"cf8_ff32": (8.0, 32), "cf1.25_ff64": (1.25, 64)}


def model_cfg(name):
    if name in W.MODELS:
        return W.dense_cfg(name)
    return get_config(name, smoke=True).with_(dtype=torch.float32,
                                              moe_capacity_factor=MOE_CAPACITY)


def setup(name):
    cfg = model_cfg(name)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    data = SyntheticDataset(SyntheticDataConfig(vocab_size=cfg.vocab_size, seq_len=W.SEQ,
                                                global_batch=W.BATCH), device="cpu")
    return model, params, data


# ---------------------------------------------------------------------------
# the processes' side
# ---------------------------------------------------------------------------


def traj_case(mesh, case, ref_dir):
    """3 steps of the FSDP step from the seed's params: the gathered params,
    losses and the bytes to each collective per step (before the state is
    gathered), the local shapes and plan, then one hot step from the
    single-process state after step 1."""
    model, params, data = setup(case["model"])
    opt = W.optimizer(params)
    fns = make_train_step(model, opt, mesh=mesh)
    state = fns["place_state"](TrainState(W.copy(params), opt.init(params)))
    out = {"fsdp": fns["fsdp"], "params": [], "comm": [], "losses": [],
           "local": [tuple(x.shape) for x in tree_leaves(state.params)],
           "plan": [(b.d, b.n, b.batch, b.split, b.dsplit)
                    for b in fns["optimizer"].bucket_plan.buckets],
           "formula": fsdp_hot_comm_bytes(fns["optimizer"], model.cfg,
                                          whole_over_data="pod" not in mesh.axis_names)}
    for s in range(W.STEPS):
        mesh_lib.comm_reset()
        state, m = (fns["refresh_step"] if s == 0 else fns["step"])(state, data.batch_at(s))
        out["comm"].append(mesh_lib.comm_snapshot())
        out["losses"].append(float(m["loss"]))
        out["params"].append(tree_leaves(fns["gather_state"](state).params))
    out["canonical"] = canonical_opt_state(opt, fns["gather_state"](state).opt_state)
    ref = torch.load(os.path.join(ref_dir, f"{case['model']}_1.pt"), weights_only=False)
    st, _ = fns["step"](fns["place_state"](TrainState(ref["params"], ref["opt_state"])),
                        data.batch_at(2))
    out["hot_from_ref"] = tree_leaves(fns["gather_state"](st).params)
    return out


def jax_case(mesh, case, ref_dir):
    """The d 128 model from JAX's params (``jax.pt``, written by
    ``test_torch_tensor_parallel._jax_reference``): the loss of this
    process's rows and the step's reduced gradients on JAX's batch, then
    the optimizer of this process's blocks on JAX's gradients -- a refresh
    with JAX's draws, and a hot step from JAX's post-refresh state."""
    src = torch.load(os.path.join(ref_dir, "jax.pt"), weights_only=False)
    model = build_model(W.dense_cfg("d128"), device="cpu")
    params = bridge.params_from_numpy(src["params"], "cpu")
    batch = {k: torch.from_numpy(v) for k, v in src["batch"].items()}
    opt = W.optimizer(params, lr=0.01, grad_clip_norm=1.0, tau=200)
    fns = make_train_step(model, opt, mesh=mesh)
    topt, blocks = fns["optimizer"], fns["splits"]
    state = TrainState(params, opt.init(params)._replace(draws=W.RecordedDraws(src["draws"])))
    local = fns["place_state"](state)
    loss, _, grads = fns["grads"](local, batch)
    g0 = shd.shard_params(bridge.params_from_numpy(src["grads0"], "cpu"), mesh, blocks)
    p1, _, aux1 = topt.update(g0, local.opt_state, local.params, refresh=True, apply=True)
    js1 = bridge.opt_state_from_numpy(opt, src["state1"], "cpu")
    local1 = fns["place_state"](TrainState(bridge.params_from_numpy(src["params1"], "cpu"), js1))
    g1 = shd.shard_params(bridge.params_from_numpy(src["grads1"], "cpu"), mesh, blocks)
    p2, _, aux2 = topt.update(g1, local1.opt_state, local1.params, refresh=False, apply=True)
    return {"loss": float(loss), "grads": tree_leaves(shd.gather_params(grads, mesh, blocks)),
            "params1": tree_leaves(shd.gather_params(p1, mesh, blocks)),
            "params2": tree_leaves(shd.gather_params(p2, mesh, blocks)),
            "aux1": [float(aux1.grad_norm), float(aux1.update_norm),
                     float(aux1.mean_refresh_overlap)],
            "aux2": [float(aux2.grad_norm), float(aux2.update_norm)]}


def loop_case(mesh, case, ref_dir):
    """``train_loop`` of the d 256 model under FSDP: 3 steps writing a
    checkpoint at step 2 (``case["write"]``), or resuming a checkpoint of
    another ``data`` extent from step 2 to 3 (``case["resume"]``)."""
    model, params, data = setup("d256")
    opt = W.optimizer(params)
    fns = make_train_step(model, opt, mesh=mesh)
    ck = case.get("write") or os.path.join(ref_dir, f"resume_{mesh.rank}")
    if "resume" in case:
        shutil.copytree(case["resume"], ck)
    tc = TrainConfig(total_steps=W.STEPS, checkpoint_every=2 if "write" in case else 0,
                     checkpoint_dir=ck, async_checkpoint=False)
    res = train_loop(model, opt, data, tc, fns, log_every=1, handle_signals=False)
    return {"fsdp": fns["fsdp"], "losses": res.losses,
            "params": tree_leaves(fns["gather_state"](res.state).params)}


def ep_case(mesh, case, ref_dir):
    """The MoE layer on JAX's EP params and input (``moe_<name>.npz``) with
    this process's blocks over both axes (the expert d_ff over ``data``),
    gathered over ``data`` as the FSDP step's layers gather them: its
    rows' output and aux, and the pairs its experts dropped."""
    src = np.load(os.path.join(ref_dir, f"moe_{case['name']}.npz"))
    cfg = get_config("deepseek-moe-16b", smoke=True).with_(
        dtype=torch.float32, d_ff=int(src["d_ff"]), moe_capacity_factor=float(src["cf"]))
    p = bridge.params_from_numpy({
        "router_w": src["router_w"],
        "experts": {k: src[f"experts_{k}"] for k in ("gate_proj", "up_proj", "down_proj")},
        "shared_mlp": {k: src[f"shared_{k}"] for k in ("gate_proj", "up_proj", "down_proj")},
    }, "cpu")
    x = torch.from_numpy(src["x"])
    lo, hi = shd.batch_rows(x.shape[0], mesh)
    splits = shd.param_splits(p, mesh)
    local = shd.shard_params(p, mesh, splits)
    shards = par.DataShards(mesh.data_axes(), {
        path: d - len(leaf.shape) for (path, leaf), (d, _) in zip(flatten_with_path(p), splits)
        if d is not None})
    moe_lib.reset_ep_drops()
    with torch.no_grad(), par.use(mesh.model_axes(), shards):
        out, aux = moe_lib.apply_moe_mlp(par.gather_layer(local, ""), x[lo:hi], cfg)
    return {"rows": (lo, hi), "out": out, "aux": float(aux), "drops": moe_lib.ep_drops(),
            "split_data": sorted(path for path, (d, _) in zip(
                [q for q, _ in flatten_with_path(p)], splits) if d is not None)}


CASES = {"traj": traj_case, "jax": jax_case, "loop": loop_case, "ep": ep_case}


def world(rank, size, store, out_dir, ref_dir, plan):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=size,
                            rank=rank, timeout=GROUP_TIMEOUT)
    try:
        mesh = mesh_lib.make_mesh(tuple(plan["mesh"]))
        out = {}
        for name, case in plan["cases"].items():
            out[name] = CASES[case["kind"]](mesh, case, ref_dir)
            mesh_lib.barrier(mesh)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(tmp, ref_dir, plan):
    """Start the world of ``plan``; the returned function waits for it (at
    most ``WORLD_TIMEOUT_S``, then kills it and fails) and loads each
    process's outputs."""
    size = int(np.prod(plan["mesh"]))
    out_dir = tmp / f"world_{'x'.join(map(str, plan['mesh']))}"
    out_dir.mkdir()
    ctx = mp.start_processes(world, args=(size, str(out_dir / "store"), str(out_dir), ref_dir,
                                          plan), nprocs=size, join=False, start_method="spawn")
    deadline = time.monotonic() + WORLD_TIMEOUT_S

    def finish():
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise AssertionError(f"the {plan['mesh']} world outlived {WORLD_TIMEOUT_S} s")
        return [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(size)]

    return finish


# ---------------------------------------------------------------------------
# the parent's side
# ---------------------------------------------------------------------------


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _max_err(got, want):
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


def _rows_per_process(mesh_shape, axes):
    batch = dict(zip(axes, mesh_shape))
    return W.BATCH // (batch.get("pod", 1) * batch.get("data", 1))


def _ref_trajectory(name, ref_dir, microbatch=0):
    """The single-process step's 3 steps (the global batch in microbatches
    of ``microbatch`` rows for the MoE models), its step-0 loss, and its
    state after step 1 on disk."""
    model, params, data = setup(name)
    opt = W.optimizer(params)
    fns = make_train_step(model, opt, train_cfg=TrainConfig(microbatch=microbatch))
    state = TrainState(W.copy(params), opt.init(params))
    traj, losses = [], []
    for s in range(W.STEPS):
        batch = data.batch_at(s)
        if microbatch:
            # the mean of the microbatches' losses, as the world's processes'
            # (the step's metrics are its last microbatch's, as JAX's)
            with torch.no_grad():
                losses.append(float(np.mean([
                    float(model.loss(state.params, {k: v[i:i + microbatch]
                                                    for k, v in batch.items()})[1]["loss"])
                    for i in range(0, W.BATCH, microbatch)])))
        state, m = (fns["refresh_step"] if s == 0 else fns["step"])(state, batch)
        traj.append(tree_leaves(state.params))
        if not microbatch:
            losses.append(float(m["loss"]))
        if s == 1:
            torch.save({"params": state.params, "opt_state": state.opt_state},
                       os.path.join(ref_dir, f"{name}_1.pt"))
    return {"traj": traj, "losses": losses, "opt": opt, "params0": params}


def _one_process_loop(ref_dir):
    """A one-process run of the d 256 model to step 2 (a checkpoint there),
    which the (4, 1) world resumes."""
    model, params, data = setup("d256")
    opt = W.optimizer(params)
    ck = os.path.join(ref_dir, "one_process")
    tc = TrainConfig(total_steps=2, checkpoint_every=2, checkpoint_dir=ck,
                     async_checkpoint=False)
    train_loop(model, opt, data, tc, make_train_step(model, opt), log_every=1,
               handle_signals=False)
    return ck


def _jax_ep(ref_dir):
    """JAX's EP layer cases in a subprocess (4 forced host devices), started
    here and waited for by the returned function."""
    from test_torch_tensor_parallel import _EP_SCRIPT

    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(_EP_SCRIPT), ref_dir,
                             repr(EP_CASES)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)

    def finish():
        out, err = proc.communicate(timeout=WORLD_TIMEOUT_S)
        assert proc.returncode == 0 and "OK" in out, err[-4000:]

    return finish


MOE_LOCAL, MOE_EP = "olmoe-1b-7b", "deepseek-moe-16b"
WORLDS = {
    "w2": ((2, 1), ("data", "model"), dict(
        d128=dict(kind="traj", model="d128"), moe=dict(kind="traj", model=MOE_LOCAL),
        jax=dict(kind="jax"))),
    "w41": ((4, 1), ("data", "model"), dict(
        d256=dict(kind="traj", model="d256"))),
    "w22": ((2, 2), ("data", "model"), dict(
        d128=dict(kind="traj", model="d128"), moe=dict(kind="traj", model=MOE_EP),
        **{f"ep_{n}": dict(kind="ep", name=n) for n in EP_CASES})),
    "w221": ((2, 2, 1), ("pod", "data", "model"), dict(
        d128=dict(kind="traj", model="d128"))),
}
TRAJ = [(w, c) for w, (_, _, cases) in WORLDS.items() for c, spec in cases.items()
        if spec["kind"] == "traj"]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world, one after another (each its own time limit), beside the
    references: the single-process trajectories, the one-process
    checkpoint, JAX's single-device step and its EP layer."""
    from test_torch_tensor_parallel import _jax_reference

    tmp = tmp_path_factory.mktemp("fsdp")
    ref_dir = tmp / "ref"
    ref_dir.mkdir()
    jax_ep = _jax_ep(str(ref_dir))
    refs = {m: _ref_trajectory(m, str(ref_dir)) for m in W.MODELS}
    runs = {}
    plans = {k: {"mesh": shape, "cases": dict(cases)} for k, (shape, _, cases) in WORLDS.items()}
    plans["w2"]["cases"]["loop_write"] = dict(kind="loop", write=str(tmp / "fsdp_ck"))
    # the MoE references: one process's rows per microbatch
    refs[MOE_LOCAL] = _ref_trajectory(MOE_LOCAL, str(ref_dir), microbatch=W.BATCH // 2)
    jref = _jax_reference(str(ref_dir))
    w2 = spawn(tmp, str(ref_dir), plans["w2"])
    refs[MOE_EP] = _ref_trajectory(MOE_EP, str(ref_dir), microbatch=W.BATCH // 2)
    one_ck = _one_process_loop(str(ref_dir))
    plans["w41"]["cases"]["loop_resume"] = dict(kind="loop", resume=one_ck)
    runs["w2"] = w2()
    jax_ep()
    for k in ("w41", "w22", "w221"):
        runs[k] = spawn(tmp, str(ref_dir), plans[k])()
    return dict(refs=refs, jref=jref, runs=runs, ref_dir=str(ref_dir),
                fsdp_ck=str(tmp / "fsdp_ck"))


@pytest.mark.parametrize("world,case", TRAJ)
def test_fsdp_world_matches_the_single_process_step(worlds, world, case):
    """The step-0 loss (LOSS_TOL), the params after each step
    (REFRESH_TOL), one hot step from the single-process state
    (HOT_LOOP_TOL), the processes' params equal, and the FSDP step taken:
    every leaf's local shape is its ``param_spec`` block."""
    ranks = worlds["runs"][world]
    shape, axes, cases = WORLDS[world]
    ref = worlds["refs"][cases[case]["model"]]
    got = ranks[0][case]
    assert got["fsdp"]
    assert abs(got["losses"][0] - ref["losses"][0]) <= LOSS_TOL, (got["losses"], ref["losses"])
    for s in range(W.STEPS):
        assert _max_err(got["params"][s], ref["traj"][s]) <= REFRESH_TOL, (case, s)
        for r in ranks[1:]:
            assert all(torch.equal(a, b) for a, b in zip(r[case]["params"][s], got["params"][s]))
    assert _max_err(got["hot_from_ref"], ref["traj"][2]) <= HOT_LOOP_TOL
    mesh = mesh_lib.Mesh(axes, shape)
    n_split = 0
    for r in ranks:
        for (path, leaf), local in zip(flatten_with_path(ref["params0"]), r[case]["local"]):
            spec = shd.param_spec(path, tuple(leaf.shape), mesh)
            want = list(leaf.shape)
            for i, a in enumerate(spec):
                if a is not None and mesh.shape[a] > 1:
                    want[len(want) - len(spec) + i] //= mesh.shape[a]
                    n_split += a == "data"
            assert tuple(want) == local, (path, spec, local)
    assert n_split > 0


@pytest.mark.parametrize("world,case", TRAJ)
def test_hot_step_bytes_over_data_equal_the_shape_count(worlds, world, case):
    """Each hot step hands the ``data`` collectives the bytes that
    ``core.lowrank.fsdp_hot_comm_bytes`` counts from the shapes, on every
    process: the split leaves gathered at use (and again in the blocks'
    recomputation) and their gradients reduce-scattered, the whole leaves'
    gradients all-reduced (``@pod+data`` on the pod mesh), the partial R
    of the buckets ``data`` cuts on their d."""
    for r in worlds["runs"][world]:
        got = r[case]
        for c in got["comm"][1:]:
            on_data = sum(v for k, v in c.items() if k.endswith("@data"))
            assert on_data == got["formula"], (c, got["formula"])


def test_fsdp_against_jax_single_device_step(worlds):
    """JAX's params, batch, gradients and draws at (2, 1): the mean of the
    processes' losses and the step's reduced gradients (GRAD_TOL), the
    params after a refresh (REFRESH_TOL) and after a hot step from JAX's
    post-refresh state (HOT_LOOP_TOL), the norms."""
    import jax

    j, ranks = worlds["jref"], [r["jax"] for r in worlds["runs"]["w2"]]
    got = ranks[0]
    np.testing.assert_allclose(np.mean([r["loss"] for r in ranks]), j["loss"], **GRAD_TOL)
    for a, b in zip(got["grads"], jax.tree_util.tree_leaves(j["grads"])):
        np.testing.assert_allclose(_np(a), b, **GRAD_TOL)
    for a, b in zip(got["params1"], jax.tree_util.tree_leaves(j["params1"])):
        np.testing.assert_allclose(_np(a), b, atol=REFRESH_TOL, rtol=0)
    for a, b in zip(got["params2"], jax.tree_util.tree_leaves(j["params2"])):
        np.testing.assert_allclose(_np(a), b, atol=HOT_LOOP_TOL, rtol=0)
    np.testing.assert_allclose(got["aux1"], j["aux1"], rtol=1e-5)
    np.testing.assert_allclose(got["aux2"], j["aux2"], rtol=1e-5)


@pytest.mark.parametrize("name", list(EP_CASES))
def test_fsdp_ep_layer_matches_jax_expert_parallel_path(worlds, name):
    """The (2, 2) world's MoE layer with the expert d_ff over ``data``,
    gathered at use: each row block's output and the aux (averaged over
    ``data``) within EP_TOL of JAX's EP path, the dropped pairs JAX's
    count."""
    src = np.load(os.path.join(worlds["ref_dir"], f"moe_{name}.npz"))
    ranks = [r[f"ep_{name}"] for r in worlds["runs"]["w22"]]
    assert any("experts" in p for p in ranks[0]["split_data"]), ranks[0]["split_data"]
    out = np.zeros_like(src["out"])
    for r in ranks:
        lo, hi = r["rows"]
        out[lo:hi] = _np(r["out"])
    np.testing.assert_allclose(out, src["out"], atol=EP_TOL, rtol=0)
    np.testing.assert_allclose(np.mean([r["aux"] for r in ranks]), float(src["aux"]),
                               atol=EP_TOL, rtol=0)
    assert sum(r["drops"]["dropped"] for r in ranks) == len(src["dropped"])


def test_fsdp_checkpoint_resumes_on_one_process_and_in_jax(worlds):
    """The (2, 1) world's loop wrote JAX's canonical per-leaf checkpoint at
    step 2 from the gathered state: one process resumes it to step 3 (its
    params within HOT_LOOP_TOL of the world's own step 3: one hot step from
    the same state), and JAX loads the same params bit for bit."""
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import get_config as jax_get_config
    from repro.core import make_optimizer as jax_make_optimizer
    from repro.models import build_model as jax_build_model
    from repro.train import checkpoint as jax_ckpt
    from repro.train.state import TrainState as JaxTrainState
    from repro.train.state import checkpoint_converters as jax_converters
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train import state as state_lib

    written = worlds["runs"]["w2"][0]["loop_write"]
    assert written["fsdp"]
    model, params, data = setup("d256")
    opt = W.optimizer(params)
    ck = os.path.join(worlds["ref_dir"], "resume_on_one")
    shutil.copytree(worlds["fsdp_ck"], ck)
    tc = TrainConfig(total_steps=W.STEPS, checkpoint_every=0, checkpoint_dir=ck,
                     async_checkpoint=False)
    res = train_loop(model, opt, data, tc, make_train_step(model, opt), log_every=1,
                     handle_signals=False)
    assert len(res.losses) == 1
    assert _max_err(tree_leaves(res.state.params), written["params"]) <= HOT_LOOP_TOL
    canon, loc = state_lib.checkpoint_converters(opt)
    saved = ckpt_lib.CheckpointManager(worlds["fsdp_ck"], canonicalize=canon,
                                       localize=loc).load(TrainState(params, opt.init(params)),
                                                          step=2)
    jcfg = jax_get_config("llama3-8b", smoke=True).with_(dtype=jnp.float32,
                                                         **W.MODELS["d256"])
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    jopt = jax_make_optimizer("galore-sara-adam", jparams, **W.OPT_KW)
    jcan, jloc = jax_converters(jopt)
    jstate = jax_ckpt.CheckpointManager(worlds["fsdp_ck"], canonicalize=jcan,
                                        localize=jloc).load(
        JaxTrainState(jparams, jopt.init(jparams)), step=2)
    for a, b in zip(jax.tree_util.tree_leaves(jstate.params), tree_leaves(saved.params)):
        np.testing.assert_array_equal(np.asarray(a), _np(b))
    assert int(jstate.opt_state.step) == 2


def test_one_process_checkpoint_resumes_under_fsdp_at_4(worlds):
    """A one-process checkpoint at step 2, resumed by the (4, 1) world (its
    leaves cut into four ``data`` blocks) to step 3: within HOT_LOOP_TOL of
    the single-process run's step 3."""
    got = worlds["runs"]["w41"][0]["loop_resume"]
    assert got["fsdp"] and len(got["losses"]) == 1
    assert _max_err(got["params"], worlds["refs"]["d256"]["traj"][2]) <= HOT_LOOP_TOL


def _done_losses(out):
    done = [ln for ln in out.splitlines() if "done:" in ln]
    assert done, out[-2000:]
    return [float(x) for x in re.findall(r"loss ([0-9.]+) -> ([0-9.]+)", done[0])[0]]


def test_launcher_runs_an_fsdp_world(tmp_path):
    """``launch/train.py --mesh 2,1 --device cpu`` (two gloo launchers,
    olmoe's smoke config: its expert d_ff splits over ``data``) takes the
    FSDP step, both processes print the same losses over 3 steps, and the
    first is the one-process launcher's to the printed digits (the same
    params on the same rows; later steps differ by the router's aux loss,
    which each process takes over its own rows)."""
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch", MOE_LOCAL, "--smoke",
            "--device", "cpu", "--steps", "3", "--tau", "2", "--rank", "8", "--engine",
            "bucketed", "--svd-backend", "randomized", "--no-recovery", "--ckpt-every", "0",
            "--seq", "32", "--batch", "4"]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    runs = [base + ["--ckpt-dir", str(tmp_path / "one")]]
    runs += [base + ["--ckpt-dir", str(tmp_path / "w"), "--mesh", "2,1", "--coordinator",
                     f"file://{tmp_path / 'store'}", "--num-processes", "2", "--process-id",
                     str(i)] for i in range(2)]
    procs = [subprocess.Popen(r, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env) for r in runs]
    outs = [p.communicate(timeout=WORLD_TIMEOUT_S) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e[-3000:] for _, e in outs]
    want = _done_losses(outs[0][0])
    got = [_done_losses(out) for out, _ in outs[1:]]
    for out, _ in outs[1:]:
        assert "2 process(es)" in out and "FSDP over data" in out
    assert got[0] == got[1] and all(np.isfinite(got[0]))
    assert abs(got[0][0] - want[0]) <= 1e-4 + 1e-9, (got, want)


# the family models of ``tp_worlds.py`` (widths the guard splits over data)
FAMILY_ARCHS = {"mamba2-370m": "ssm", "hymba-1.5b": "hybrid", "whisper-medium": "audio",
                "llava-next-34b": "vlm"}


@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b", "whisper-medium",
                                  "llava-next-34b", "llama3-8b", "olmoe-1b-7b"])
def test_which_families_take_the_fsdp_step(arch):
    """At a ``data`` extent of 2 (a stub mesh: the step is only built)
    every family takes the FSDP step at widths the guard splits: the
    optimizer of this process's blocks, some leaf split over ``data``;
    the compressed step keeps every family's params whole."""
    if arch in FAMILY_ARCHS:
        cfg = W.family_cfg(FAMILY_ARCHS[arch])
    else:
        cfg = model_cfg("d128") if arch == "llama3-8b" else get_config(arch, smoke=True).with_(
            dtype=torch.float32)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    opt = make_optimizer("galore-sara-adam", params, rank=8, engine="bucketed")
    mesh = mesh_lib.Mesh(("data", "model"), (2, 1))
    fns = make_train_step(model, opt, mesh=mesh)
    assert fns["fsdp"] and fns["tp"] and fns["optimizer"] is not opt
    assert any(d is not None for d, _ in fns["splits"])
    flat = make_train_step(model, opt, mesh=mesh, compressed="flat")
    assert not flat["fsdp"] and flat["optimizer"] is opt


def test_zero_state_on_the_fsdp_step_raises():
    """ZeRO state (``state_sharding="zero"``) on the FSDP step raises where
    its ``state_shards`` is not the ``data`` extent, naming the extent; at
    the extent the FSDP step takes it (the buckets whose R is whole over
    ``data`` hold rows of their moments, ``StateLayout.zero_rows``), and
    the compressed step takes it as before."""
    model, params, _ = setup("d128")
    mesh = mesh_lib.Mesh(("data", "model"), (2, 1))
    with pytest.raises(ValueError, match="state_shards must be the data extent 2, got 4"):
        make_train_step(model, W.optimizer(params, zero_shards=4), mesh=mesh)
    opt = W.optimizer(params, zero_shards=2)
    fns = make_train_step(model, opt, mesh=mesh)
    layout = fns["optimizer"].state_layout
    assert fns["fsdp"] and layout.shards == 2
    assert layout.zero_rows == tuple(b.dsplit in ("d", "") for b in layout.plan.buckets)
    assert any(layout.zero_rows) and not all(layout.zero_rows)
    assert make_train_step(model, opt, mesh=mesh, compressed="flat")["optimizer"] is opt


def test_data_axis_collectives_along_any_dim():
    """``DPAxes.reduce_scatter`` and ``all_gather`` along a dim other than
    0 on one process (the identities), the data axis of a mesh, and a leaf
    cut over both axes (``block_of``)."""
    m = mesh_lib.Mesh(("data", "model"), (2, 4), rank=6)
    assert (m.dp, m.data_axes().names, m.data_axes().index) == (2, ("data",), 1)
    assert mesh_lib.single_device_mesh().data_axes().size == 1
    x = torch.arange(48.0).reshape(4, 12)
    assert torch.equal(shd.block_of(x, (0, 1), m), x[2:4, 6:9])
    one = mesh_lib.single_device_mesh().data_axes()
    assert torch.equal(one.reduce_scatter(x, dim=1), x) and torch.equal(one.all_gather(x, 1), x)
    assert shd.leaf_splits("['blocks']['q_proj']", (2, 128, 256), m) == (1, 2)
    assert shd.leaf_splits("['blocks']['q_proj']", (2, 128, 256), m, fsdp=False) == (None, 2)
