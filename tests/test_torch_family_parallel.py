"""Tensor parallelism over ``model`` and FSDP over ``data`` for the SSM,
hybrid, enc-dec and VLM families (``models/ssm.py``'s head-parallel and
whole-mixer routes, ``hybrid.py``, ``encdec.py``'s cross-attention,
``vlm.py``'s adapter, ``train/step.py``, ``models.tp_hot_comm_bytes``
and ``core/lowrank.fsdp_hot_comm_bytes``), in spawned gloo worlds on the
CPU: (1, 2), (2, 1), (2, 2) and (1, 4), one world per mesh running every
family's cases (``tp_worlds.py``, which imports no JAX).

JAX's sharded steps fail on this tree's jax (``tests/test_distributed.py``),
but under GSPMD they compute the single device's math: so each world is
held against the single-process step of both packages, from JAX's init,
on JAX's batches and with JAX's refresh draws.  The models
(``tp_worlds.FAMILY_MODELS``): one layer each at widths where the guard
splits every matrix over ``model`` in some world and over ``data`` in
another and keeps some leaf whole; mamba2 head-parallel (with an
``in_proj`` block that ends inside ``x``), with 6 heads (the whole mixer at
4) and without ``ssm_head_tp``; hymba's head counts (the gathered
attention, its SSM head-parallel at 2 and whole at 4); whisper with an
odd vocabulary; llava with 8 patches.  rank 8, tau 4, seq 32, global batch
4, the randomized SVD; 3 steps (a refresh, 2 hot).

Bars:
  * ``LOSS_TOL`` (1e-5) on the step-0 loss and ``GRAD_TOL`` (1e-6 abs +
    1e-5 rel) on the step's reduced step-0 gradients, against both
    packages (against JAX's SSD gradients only where JAX's are finite:
    its backward may return NaN, ROADMAP queue 3);
  * ``REFRESH_TOL`` (5e-5 abs on params) after each step of the
    trajectory, against both (the sketch's products summed over
    processes move the randomized SVD's last bits,
    ``test_torch_tensor_parallel.py``), but for the elements whose
    refresh reads an R entry below Adam's reach in JAX's state
    (``test_torch_family_train._eps_sensitive``: at rank 8 hymba's up_proj
    has some), which stay within the steps' largest possible move;
  * ``HOT_LOOP_TOL`` (1e-6 abs) after one hot step from the one-process
    state;
  * exact: the processes' gathered params against each other, every
    leaf's local shape against ``param_spec``, and the bytes each hot step
    hands the ``model`` and ``data`` collectives against the shapes'
    counts.
"""
import os
import pickle
import re
import shutil
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.configs.registry import get_config as jax_get_config
from repro.core import make_optimizer as jax_make_optimizer
from repro.data.synthetic import SyntheticDataConfig as JaxDataConfig
from repro.data.synthetic import SyntheticDataset as JaxDataset
from repro.models import build_model as jax_build_model
from repro.train import checkpoint as jax_ckpt
from repro.train.state import TrainState as JaxTrainState
from repro.train.state import checkpoint_converters as jax_converters
from repro_torch import bridge
from repro_torch.configs.base import TrainConfig
from repro_torch.core import buckets as buckets_lib
from repro_torch.core import make_optimizer
from repro_torch.core.lowrank import (canonical_opt_state, flatten_with_path, state_tensors,
                                      tree_leaves, tree_unflatten)
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as shd
from repro_torch.models import build_model
from repro_torch.models import ssm as ssm_lib
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import state as state_lib
from repro_torch.train.loop import train_loop
from repro_torch.train.state import TrainState
from repro_torch.train.step import make_train_step
from repro_torch.core.lowrank import TorchDraws
from test_torch_family_train import _eps_sensitive
from test_torch_optim_kernels import JaxDraws

import tp_worlds as W

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# One intra-op thread: the test workers share the host's cores, and the
# port's results do not depend on the thread count (core/svd.py).
torch.set_num_threads(1)

LOSS_TOL = 1e-5
GRAD_TOL = dict(atol=1e-6, rtol=1e-5)
REFRESH_TOL = 5e-5
HOT_LOOP_TOL = 1e-6
WORLD_TIMEOUT_S = 180  # each world's own limit: a hang fails, not the suite's clock
JAX_MODELS = ("ssm", "hybrid", "audio", "vlm")  # one per family, also against JAX
# the models held against the port's one process only: ssm_whole on its
# twin's params (the same shapes), ssm_h6 on the port's seeded init
TWINS = {"ssm_whole": "ssm", "ssm_h6": None}
WORLDS = {
    (1, 2): ("ssm", "ssm_whole", "ssm_h6", "hybrid", "audio", "vlm"),
    (2, 1): ("ssm", "hybrid", "audio", "vlm"),
    (2, 2): ("ssm", "hybrid", "audio", "vlm"),
    (1, 4): ("ssm", "ssm_h6", "hybrid", "audio"),
}
CASES = [(w, m) for w, models in WORLDS.items() for m in models]
# the SSM mixer's route per (model, model extent): head-parallel or whole
ROUTES = {("ssm", 2): True, ("ssm", 4): True, ("ssm_whole", 2): False, ("ssm_h6", 2): True,
          ("ssm_h6", 4): False, ("hybrid", 2): True, ("hybrid", 4): False}


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _max_err(got, want):
    return max(float(np.abs(_np(a) - _np(b)).max()) for a, b in zip(got, want))


def _jax_cfg(name):
    arch, kw = W.FAMILY_MODELS[name]
    return jax_get_config(arch, smoke=True).with_(dtype=jnp.float32, n_layers=1, **kw)


def _record_draws(topt, draws_source):
    """The refresh's draws of every bucket entry of the optimizer ``topt``
    at its global leaves' shapes, as numpy, by leaf index
    (``tp_worlds.RecordedDraws``)."""
    pcfg, out = topt.config.projector_config(), {}
    for bk in topt.bucket_plan.buckets:
        for e in bk.entries:
            ld = buckets_lib.entry_draws(draws_source, e, topt.state_layout.templates[e.leaf_idx],
                                         bk, pcfg, "cpu")
            out[e.leaf_idx] = tuple(None if x is None else _np(x) for x in ld)
    return out


def _batches(cfg, data):
    """3 batches of ``data`` as numpy, with seeded patches or frames for
    llava and whisper."""
    rng = np.random.default_rng(7)
    out = []
    for s in range(W.STEPS):
        b = {k: np.asarray(v) for k, v in data.batch_at(s).items()}
        if cfg.family in ("vlm", "audio"):
            key, rows = (("patch_embeds", cfg.n_patches) if cfg.family == "vlm"
                         else ("frame_embeds", cfg.enc_frames))
            b[key] = (0.1 * rng.standard_normal((W.BATCH, rows, cfg.d_model))).astype(np.float32)
        out.append(b)
    return out


def _inputs(name, ref_dir, twin=None):
    """The params, 3 batches and refresh draws the processes start from
    (``fam_<name>.pt``): JAX's init, batches and draws for ``JAX_MODELS``
    (returned with JAX's model, params, optimizer and state), a twin's own
    where ``twin`` names one of the same shapes, else the port's seeded
    init and draws on JAX's batches."""
    if twin is not None:
        src, side = twin
    else:
        jcfg = _jax_cfg(name)
        data = JaxDataset(JaxDataConfig(vocab_size=jcfg.vocab_size, seq_len=W.SEQ,
                                        global_batch=W.BATCH))
        if name in JAX_MODELS:
            jmodel = jax_build_model(jcfg)
            jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
            jopt = jax_make_optimizer("galore-sara-adam", jparams, **W.OPT_KW)
            js0 = jopt.init(jparams)
            tree = jax.tree_util.tree_map(np.asarray, jparams)
            draws = JaxDraws(js0.key).split()
            side = (jmodel, jparams, jopt, js0)
        else:
            tree = bridge.params_to_numpy(build_model(W.family_cfg(name), device="cpu").init(
                torch.Generator().manual_seed(0)))
            draws, side = TorchDraws(0, "cpu").split(), None
        topt = W.optimizer(bridge.params_from_numpy(tree, "cpu"))
        src = {"params": tree, "batches": _batches(jcfg, data),
               "draws": _record_draws(topt, draws)}
    torch.save(src, os.path.join(ref_dir, f"fam_{name}.pt"))
    return src, side


def _port_one(name, src, ref_dir):
    """The port's one-process step from the same params, batches and draws:
    its step-0 loss and gradients, 3 steps, its state after step 1 on disk
    (``fam_<name>_1.pt``) and its gradients there on the third batch."""
    model = build_model(W.family_cfg(name), device="cpu")
    params = bridge.params_from_numpy(src["params"], "cpu")
    batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in src["batches"]]
    opt = W.optimizer(params)
    loss0, grads0 = W.loss_and_grads(model, params, batches[0], None)
    fns = make_train_step(model, opt)
    state = TrainState(W.copy(params), opt.init(params)._replace(
        draws=W.RecordedDraws(src["draws"])))
    traj = []
    for s in range(W.STEPS):
        state, _ = (fns["refresh_step"] if s == 0 else fns["step"])(state, batches[s])
        traj.append(tree_leaves(state.params))
        if s == 1:
            torch.save({"params": state.params, "opt_state": state.opt_state},
                       os.path.join(ref_dir, f"fam_{name}_1.pt"))
            hot_grads = tree_leaves(W.loss_and_grads(model, state.params, batches[2], None)[1])
    return {"loss0": loss0, "grads0": tree_leaves(grads0), "traj": traj, "params0": params,
            "hot_grads": hot_grads, "opt": opt}


def _jax_trajectory(jax_side, batches):
    """JAX's single-device step (its value and gradient, then the
    optimizer's update, as JAX's ``make_train_step`` runs them): the step-0
    loss and gradients, the params after each of the 3 steps, and the
    elements whose refresh reads an R entry below Adam's reach
    (``test_torch_family_train._eps_sensitive``)."""
    jmodel, jparams, jopt, js0 = jax_side
    vg = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))
    update = jax.jit(jopt.update, static_argnames=("refresh", "apply"))
    params, state, traj = jparams, js0, []
    for s in range(W.STEPS):
        (loss, _), grads = vg(params, batches[s])
        if s == 0:
            loss0, grads0 = float(loss), grads
        params, state, _ = update(grads, state, params, refresh=s == 0, apply=True)
        traj.append([np.asarray(x) for x in jax.tree_util.tree_leaves(params)])
        if s == 0:
            sensitive = _eps_sensitive(jopt, state, grads0)
    return {"loss0": loss0, "traj": traj, "sensitive": sensitive,
            "grads0": [np.asarray(x) for x in jax.tree_util.tree_leaves(grads0)]}


def _jax_child(names, ref_dir):
    """For each of ``names``, in a process of its own: its inputs
    (``_inputs``, then ``fam_<name>.ready``) and its JAX trajectory
    (``jax_<name>.pkl``)."""
    torch.set_num_threads(1)
    sides = {}
    for name in names:
        sides[name] = _inputs(name, ref_dir)
        open(os.path.join(ref_dir, f"fam_{name}.ready"), "w").close()
    for name in names:
        src, side = sides[name]
        with open(os.path.join(ref_dir, f"jax_{name}.pkl"), "wb") as f:
            pickle.dump(_jax_trajectory(side, src["batches"]), f)


def _assert_steps_close(got, want, sensitive, paths, s):
    """The params after step ``s`` within REFRESH_TOL, but for the elements
    whose refresh read an R entry below Adam's reach (``sensitive``), which
    stay within ``s + 1`` steps' largest possible move, lr * alpha * 2
    sqrt(rank) each (``test_torch_family_train``)."""
    bound = (s + 1) * W.OPT_KW["lr"] * 0.25 * 2 * np.sqrt(W.OPT_KW["rank"])
    for path, a, b in zip(paths, got, want):
        a, b = _np(a), _np(b)
        mask = sensitive.get(path, np.zeros(a.shape, bool))
        err = np.abs(a - b)
        assert err[~mask].max(initial=0.0) <= REFRESH_TOL, (path, s, err[~mask].max())
        assert err[mask].max(initial=0.0) <= bound, (path, s)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world beside both packages' one-process runs.  A process of
    its own makes the inputs of the second half of ``JAX_MODELS`` and
    their JAX trajectories, while this one makes the first half's and the
    twins' inputs and the port's one-process runs (the worlds read them),
    then runs the first half's JAX trajectories while the worlds run two
    at a time."""
    tmp = tmp_path_factory.mktemp("family")
    ref_dir = tmp / "ref"
    ref_dir.mkdir()
    mine, theirs = JAX_MODELS[:2], JAX_MODELS[2:]
    child = mp.get_context("spawn").Process(target=_jax_child, args=(theirs, str(ref_dir)))
    child.start()
    port, inputs = {}, {}
    for m in mine + tuple(TWINS):
        inputs[m] = _inputs(m, str(ref_dir), inputs.get(TWINS.get(m)))
        port[m] = _port_one(m, inputs[m][0], str(ref_dir))
    for m in theirs:
        path = ref_dir / f"fam_{m}.pt"
        deadline = time.monotonic() + WORLD_TIMEOUT_S
        while not (ref_dir / f"fam_{m}.ready").exists():
            assert child.is_alive() and time.monotonic() < deadline, "JAX's inputs: no file"
            time.sleep(0.2)
        port[m] = _port_one(m, torch.load(path, weights_only=False), str(ref_dir))
    plans = {shape: {"mesh": shape, "cases": {m: dict(kind="family", model=m) for m in ms}}
             for shape, ms in WORLDS.items()}
    plans[(2, 2)]["cases"]["loop"] = dict(kind="family_loop", write=str(tmp / "fam_ck"))
    runs, jref = {}, {}
    for shapes, models in ((((1, 2), (2, 1)), mine), (((2, 2), (1, 4)), ())):
        running = {s: W.spawn(tmp, str(ref_dir), plans[s], WORLD_TIMEOUT_S) for s in shapes}
        for m in models:
            jref[m] = _jax_trajectory(inputs[m][1], inputs[m][0]["batches"])
        runs.update({s: f() for s, f in running.items()})
    child.join(WORLD_TIMEOUT_S)
    assert child.exitcode == 0, f"JAX's trajectories ended with {child.exitcode}"
    for m in theirs:
        with open(ref_dir / f"jax_{m}.pkl", "rb") as f:
            jref[m] = pickle.load(f)
    return dict(port=port, jref=jref, runs=runs, ref_dir=str(ref_dir), ck=str(tmp / "fam_ck"))


@pytest.mark.parametrize("world,model", CASES, ids=lambda x: "x".join(map(str, x))
                         if isinstance(x, tuple) else x)
def test_family_world_matches_both_single_process_steps(worlds, world, model):
    """The step-0 loss (LOSS_TOL) and reduced gradients (GRAD_TOL), the
    params after each step (REFRESH_TOL, ``_assert_steps_close``) against
    both packages' one process; from the one-process state after step 1, the reduced
    gradients (GRAD_TOL) and the update of the blocks on them against the
    one-process update on the same gradients (HOT_LOOP_TOL: full-rank
    Adam turns the gradients' last bits into more than that where a
    token's row has seen one small gradient); the processes' params
    equal, the FSDP step taken at a ``data`` extent above 1, and every
    leaf's local shape its ``param_spec`` block."""
    ranks = [r[model] for r in worlds["runs"][world]]
    got, one = ranks[0], worlds["port"][model]
    jref = worlds["jref"].get(model)
    assert got["fsdp"] == (world[0] > 1)
    assert abs(got["losses"][0] - one["loss0"]) <= LOSS_TOL, (got["losses"], one["loss0"])
    for a, b in zip(got["grads0"], one["grads0"]):
        np.testing.assert_allclose(_np(a), _np(b), **GRAD_TOL)
    if jref is not None:
        assert abs(got["losses"][0] - jref["loss0"]) <= LOSS_TOL
        for a, b in zip(got["grads0"], jref["grads0"]):
            ok = np.isfinite(b)
            np.testing.assert_allclose(_np(a)[ok], b[ok], **GRAD_TOL)
    paths = [p for p, _ in flatten_with_path(one["params0"])]
    twin = model if model in JAX_MODELS else TWINS[model]
    sensitive = worlds["jref"][twin]["sensitive"] if twin else {}
    for s in range(W.STEPS):
        _assert_steps_close(got["params"][s], one["traj"][s], sensitive, paths, s)
        if jref is not None:
            _assert_steps_close(got["params"][s], jref["traj"][s], sensitive, paths, s)
        for r in ranks[1:]:
            assert all(torch.equal(a, b) for a, b in zip(r["params"][s], got["params"][s]))
    for a, b in zip(got["hot_grads"], one["hot_grads"]):
        np.testing.assert_allclose(_np(a), _np(b), **GRAD_TOL)
    ref = torch.load(os.path.join(worlds["ref_dir"], f"fam_{model}_1.pt"), weights_only=False)
    want, _, _ = one["opt"].update(tree_unflatten(ref["params"], got["hot_grads"]),
                                   ref["opt_state"], ref["params"], refresh=False, apply=True)
    assert _max_err(got["hot_from_ref"], tree_leaves(want)) <= HOT_LOOP_TOL
    mesh = mesh_lib.Mesh(("data", "model"), world)
    n_split = {"data": 0, "model": 0}
    for r in ranks:
        for (path, leaf), local in zip(flatten_with_path(one["params0"]), r["local"]):
            spec = shd.param_spec(path, tuple(leaf.shape), mesh)
            want = list(leaf.shape)
            for i, a in enumerate(spec):
                if a is not None and mesh.shape[a] > 1:
                    want[len(want) - len(spec) + i] //= mesh.shape[a]
                    n_split[a] += 1
            assert tuple(want) == local, (path, spec, local)
    assert all(n_split[a] > 0 for a in ("data", "model") if mesh.shape[a] > 1), n_split


@pytest.mark.parametrize("world,model", CASES, ids=lambda x: "x".join(map(str, x))
                         if isinstance(x, tuple) else x)
def test_family_hot_step_bytes_equal_the_shape_count(worlds, world, model):
    """Each hot step hands the ``model`` collectives the bytes
    ``models.tp_hot_comm_bytes`` counts from the shapes and the route,
    and the ``data`` collectives those of ``core.lowrank.fsdp_hot_comm_bytes``,
    on every process."""
    for r in worlds["runs"][world]:
        got = r[model]
        assert got["model_formula"] > 0 or world[1] == 1
        assert got["data_formula"] > 0 or world[0] == 1
        for c in got["comm"][1:]:
            on_model = sum(v for k, v in c.items() if k.endswith("@model"))
            on_data = sum(v for k, v in c.items() if k.endswith("@data"))
            assert (on_model, on_data) == (got["model_formula"], got["data_formula"]), c


@pytest.mark.parametrize("model,tp", list(ROUTES), ids=lambda x: str(x))
def test_ssm_route_follows_the_heads(model, tp):
    """The mixer runs on its heads with ``ssm_head_tp`` and the heads
    dividing the ``model`` extent, as JAX's ``_shard_ssm_heads`` constrains
    them, and whole otherwise."""
    assert ssm_lib.head_parallel(W.family_cfg(model), tp) == ROUTES[(model, tp)]


def test_family_checkpoint_resumes_on_one_process_and_in_jax(worlds):
    """The (2, 2) world's loop (tensor parallel and FSDP) wrote JAX's
    canonical per-leaf checkpoint of the ``ssm`` model at step 2 from the
    gathered state: it holds the world's params and optimizer state bit
    for bit; one process resumes it to step 3, the same params as one step
    from the loaded state; and JAX loads the same params bit for bit."""
    written = worlds["runs"][(2, 2)][0]["loop"]
    assert written["fsdp"] and len(written["losses"]) == 2
    cfg = W.family_cfg("ssm")
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    opt = W.optimizer(params)
    canon, loc = state_lib.checkpoint_converters(opt)
    saved = ckpt_lib.CheckpointManager(worlds["ck"], canonicalize=canon, localize=loc).load(
        TrainState(params, opt.init(params)), step=2)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(saved.params), written["params"]))
    mine = state_tensors(canonical_opt_state(opt, saved.opt_state))
    theirs = state_tensors(written["canonical"])
    assert len(mine) == len(theirs) and all(torch.equal(a, b) for a, b in zip(mine, theirs))
    data = W.SyntheticDataset(W.SyntheticDataConfig(vocab_size=cfg.vocab_size, seq_len=W.SEQ,
                                                    global_batch=W.BATCH), device="cpu")
    fns = make_train_step(model, opt)
    want, _ = fns["step"](saved, data.batch_at(2))
    ck = os.path.join(worlds["ref_dir"], "resume_on_one")
    shutil.copytree(worlds["ck"], ck)
    tc = TrainConfig(total_steps=W.STEPS, checkpoint_every=0, checkpoint_dir=ck,
                     async_checkpoint=False)
    res = train_loop(model, opt, data, tc, fns, log_every=1, handle_signals=False)
    assert len(res.losses) == 1
    assert _max_err(tree_leaves(res.state.params), tree_leaves(want.params)) <= HOT_LOOP_TOL
    jmodel = jax_build_model(_jax_cfg("ssm"))
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    jopt = jax_make_optimizer("galore-sara-adam", jparams, **W.OPT_KW)
    jcan, jloc = jax_converters(jopt)
    jstate = jax_ckpt.CheckpointManager(worlds["ck"], canonicalize=jcan, localize=jloc).load(
        JaxTrainState(jparams, jopt.init(jparams)), step=2)
    for a, b in zip(jax.tree_util.tree_leaves(jstate.params), written["params"]):
        np.testing.assert_array_equal(np.asarray(a), _np(b))
    assert int(jstate.opt_state.step) == 2


def _done_losses(out):
    done = [ln for ln in out.splitlines() if "done:" in ln]
    assert done, out[-2000:]
    return [float(x) for x in re.findall(r"loss ([0-9.]+) -> ([0-9.]+)", done[0])[0]]


def test_launcher_runs_an_ssm_world(tmp_path):
    """``launch/train.py --arch mamba2-370m --mesh 1,2 --device cpu`` (two
    gloo launchers: the smoke mamba2's in_proj and out_proj split over
    ``model``, the whole mixer on each process) prints the one-process
    launcher's losses over 3 steps, on both processes."""
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "mamba2-370m",
            "--smoke", "--device", "cpu", "--steps", "3", "--tau", "2", "--rank", "8",
            "--engine", "bucketed", "--svd-backend", "randomized", "--no-recovery",
            "--ckpt-every", "0", "--seq", "32", "--batch", "4"]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    runs = [base + ["--ckpt-dir", str(tmp_path / "one")]]
    runs += [base + ["--ckpt-dir", str(tmp_path / "w"), "--mesh", "1,2", "--coordinator",
                     f"file://{tmp_path / 'store'}", "--num-processes", "2", "--process-id",
                     str(i)] for i in range(2)]
    procs = [subprocess.Popen(r, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env) for r in runs]
    outs = [p.communicate(timeout=WORLD_TIMEOUT_S) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e[-3000:] for _, e in outs]
    want = _done_losses(outs[0][0])
    for out, _ in outs[1:]:
        assert "2 process(es)" in out
        assert _done_losses(out) == want
