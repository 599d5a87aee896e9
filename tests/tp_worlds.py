"""The processes' side of ``test_torch_tensor_parallel.py``,
``test_torch_family_parallel.py`` and ``test_torch_parallel_inners*.py``:
spawned gloo worlds that run the port's
tensor-, expert- and FSDP-parallel paths and save what each process
computed.  This module imports no JAX, so the spawned
processes do not: the parent hands them JAX's numbers (params, gradients,
states, refresh draws, MoE inputs) as files.

Rules of the worlds, as ``test_torch_distributed.py``'s: a ``file://``
store under the test's temporary directory, one intra-op thread per
process, a 60-s timeout on the process group.
"""
import os
import shutil
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import bridge
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import make_optimizer
from repro_torch.core.lowrank import (canonical_opt_state, fsdp_hot_comm_bytes,
                                      state_memory_bytes, tree_leaves, tree_unflatten)
from repro_torch.core.projectors import LeafDraws
from repro_torch.data.synthetic import SyntheticDataConfig, SyntheticDataset
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as shd
from repro_torch.models import build_model, tp_hot_comm_bytes
from repro_torch.models import moe as moe_lib
from repro_torch.models import parallel as par
from repro_torch.train.loop import train_loop
from repro_torch.train.state import TrainState
from repro_torch.train.step import make_train_step

TIMEOUT = timedelta(seconds=60)
OPT_KW = dict(rank=8, tau=4, lr=2e-3, engine="bucketed", svd_backend="randomized")
SEQ, BATCH, STEPS = 32, 4, 3  # refresh, hot, hot
# The dense models: d 128 with 2 of 4 heads' KV (k_proj and v_proj, 64
# columns, stay whole under the guard at TP 2: the mixed case), and d 256,
# where every leaf splits.
MODELS = {
    "d128": dict(d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256, n_layers=2),
    "d256": dict(d_model=256, n_heads=4, n_kv_heads=4, head_dim=64, d_ff=512, n_layers=2),
}


def dense_cfg(name):
    return get_config("llama3-8b", smoke=True).with_(dtype=torch.float32, **MODELS[name])


def setup(name):
    cfg = dense_cfg(name)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    data = SyntheticDataset(SyntheticDataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                                global_batch=BATCH), device="cpu")
    return model, params, data


def copy(tree):
    return {k: copy(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def optimizer(params, zero_shards=0, **kw):
    z = dict(state_sharding="zero", state_shards=zero_shards) if zero_shards else {}
    return make_optimizer("galore-sara-adam", params, **dict(OPT_KW, **kw), **z)


def loss_and_grads(model, params, batch, axes):
    """(loss, gradients) of ``model`` on ``params`` under ``axes``."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with par.use(axes):
        loss, _ = model.loss(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), tree_unflatten(params, list(grads))


class RecordedDraws:
    """A draw source that answers each leaf with draws recorded beforehand
    (the parent's JAX draws of one refresh, at the global leaves'
    shapes), so the processes draw JAX's numbers without importing it."""

    device = "cpu"

    def __init__(self, by_leaf, refreshes=0):
        self.by_leaf, self.refreshes = by_leaf, refreshes

    def split(self):
        return RecordedDraws(self.by_leaf, self.refreshes + 1)

    def leaf(self, leaf_idx, batch_shape, shapes, device=None):
        return LeafDraws(*(None if x is None else torch.from_numpy(x)
                           for x in self.by_leaf[leaf_idx]))


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------


def traj_case(mesh, case, ref_dir):
    """3 steps from the seed's params through ``make_train_step(mesh=)``:
    the gathered params and the bytes over ``model`` per step, the loss
    and the gathered gradients of step 0, then one hot step from the
    single-process state after step 1."""
    model, params, data = setup(case["model"])
    zero = case.get("zero", 0)
    opt = optimizer(params, zero)
    fns = make_train_step(model, opt, mesh=mesh, compressed=case.get("compressed", ""))
    loss, grads = loss_and_grads(model, shd.shard_params(params, mesh), data.batch_at(0),
                                 mesh.model_axes())
    out = {"loss0": loss, "grads0": tree_leaves(shd.gather_params(
        grads, mesh, fns["optimizer"].tp.splits)), "params": [], "comm": [], "losses": []}
    state = fns["place_state"](TrainState(copy(params), opt.init(params)))
    out["plan"] = [(b.d, b.n, b.rank, b.batch, b.split)
                   for b in fns["optimizer"].bucket_plan.buckets]
    for s in range(STEPS):
        mesh_lib.comm_reset()
        state, m = (fns["refresh_step"] if s == 0 else fns["step"])(state, data.batch_at(s))
        out["comm"].append(mesh_lib.comm_snapshot())
        out["losses"].append(float(m["loss"]))
        out["params"].append(tree_leaves(fns["gather_state"](state).params))
    out["canonical"] = canonical_opt_state(opt, fns["gather_state"](state).opt_state)
    # the single-process state (a replicated optimizer's layout): placing
    # it canonicalizes it first, so a ZeRO step takes it as it is
    ref = torch.load(os.path.join(ref_dir, f"{case['model']}_1.pt"), weights_only=False)
    st, _ = fns["step"](fns["place_state"](TrainState(ref["params"], ref["opt_state"])),
                        data.batch_at(2))
    out["hot_from_ref"] = tree_leaves(fns["gather_state"](st).params)
    return out


def jax_case(mesh, case, ref_dir):
    """The d 128 model from JAX's params: the loss and gathered gradients on
    JAX's batch, then the optimizer of this process's blocks on JAX's
    gradients -- a refresh with JAX's draws, and a hot step from JAX's
    post-refresh state carried across."""
    src = torch.load(os.path.join(ref_dir, "jax.pt"), weights_only=False)
    model = build_model(dense_cfg("d128"), device="cpu")
    params = bridge.params_from_numpy(src["params"], "cpu")
    ax = mesh.model_axes()
    splits = shd.tp_splits(params, mesh)
    batch = {k: torch.from_numpy(v) for k, v in src["batch"].items()}
    loss, grads = loss_and_grads(model, shd.shard_params(params, mesh, splits), batch, ax)
    opt = optimizer(params, lr=0.01, grad_clip_norm=1.0, tau=200)
    fns = make_train_step(model, opt, mesh=mesh)
    topt = fns["optimizer"]
    # the optimizer's blocks: over both axes where the step is FSDP too
    blocks = fns["splits"]
    state = TrainState(params, opt.init(params)._replace(draws=RecordedDraws(src["draws"])))
    local = fns["place_state"](state)
    g0 = shd.shard_params(bridge.params_from_numpy(src["grads0"], "cpu"), mesh, blocks)
    p1, s1, aux1 = topt.update(g0, local.opt_state, local.params, refresh=True, apply=True)
    js1 = bridge.opt_state_from_numpy(opt, src["state1"], "cpu")
    local1 = fns["place_state"](TrainState(bridge.params_from_numpy(src["params1"], "cpu"), js1))
    g1 = shd.shard_params(bridge.params_from_numpy(src["grads1"], "cpu"), mesh, blocks)
    p2, _, aux2 = topt.update(g1, local1.opt_state, local1.params, refresh=False, apply=True)
    return {"loss": loss, "grads": tree_leaves(shd.gather_params(grads, mesh, splits)),
            "params1": tree_leaves(shd.gather_params(p1, mesh, blocks)),
            "params2": tree_leaves(shd.gather_params(p2, mesh, blocks)),
            "aux1": [float(aux1.grad_norm), float(aux1.update_norm),
                     float(aux1.mean_refresh_overlap)],
            "aux2": [float(aux2.grad_norm), float(aux2.update_norm)]}


def loop_case(mesh, case, ref_dir):
    """``train_loop`` of the d 256 model under tensor parallelism: 3 steps
    writing a checkpoint at step 2 (``case["write"]``), or resuming a
    one-process checkpoint from step 2 to 3 (``case["resume"]``)."""
    model, params, data = setup("d256")
    opt = optimizer(params)
    fns = make_train_step(model, opt, mesh=mesh)
    ck = case.get("write") or os.path.join(ref_dir, f"resume_{mesh.rank}")
    if "resume" in case:
        shutil.copytree(case["resume"], ck)
    tc = TrainConfig(total_steps=STEPS, checkpoint_every=2 if "write" in case else 0,
                     checkpoint_dir=ck, async_checkpoint=False)
    res = train_loop(model, opt, data, tc, fns, log_every=1, handle_signals=False)
    return {"losses": res.losses, "params": tree_leaves(fns["gather_state"](res.state).params)}


def ep_case(mesh, case, ref_dir):
    """The MoE layer's expert-parallel path on JAX's params and input
    (``case["name"]`` in ``moe.npz``): this process's rows of the input
    (its ``data`` index) and its experts, the layer's output rows, aux and
    the (token, slot) pairs its experts dropped, by global token index."""
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
    local = shd.shard_params(p, mesh)
    ax = mesh.model_axes()
    with torch.no_grad(), par.use(ax):
        out, aux = moe_lib.apply_moe_mlp(local, x[lo:hi], cfg)
        # the pairs this process's experts dropped, by (global token, slot)
        t = (hi - lo) * x.shape[1]
        xf = x[lo:hi].reshape(t, -1)
        probs = torch.softmax(xf.float() @ p["router_w"].float(), dim=-1)
        top_i = torch.topk(probs, cfg.moe_top_k, dim=-1)[1]
        e_loc = cfg.n_experts // ax.size
        cap = int(t * cfg.moe_top_k / cfg.n_experts * cfg.moe_capacity_factor) + 1
        keep, _, _, mine = moe_lib.ep_dispatch(top_i, cfg.n_experts, e_loc, ax.index, cap)
    pairs = torch.nonzero(mine & ~keep)[:, 0]
    dropped = [(int(j) // cfg.moe_top_k + lo * x.shape[1], int(j) % cfg.moe_top_k)
               for j in pairs]
    return {"rows": (lo, hi), "out": out, "aux": float(aux), "dropped": dropped}


# ---------------------------------------------------------------------------
# the SSM, hybrid, enc-dec and VLM families (test_torch_family_parallel.py)
# ---------------------------------------------------------------------------

# Widths at which the guard (``MIN_SHARD_EXTENT`` 64) splits each matrix
# over ``model`` in some world and over ``data`` in another, and keeps
# some leaf whole, 1 layer (whisper 1 + 1), f32:
#   ssm: 8 SSD heads of 32, in_proj 536 columns: at 2 a process's block of
#     268 ends 12 columns into x (at 4, 134); head-parallel at 2 and 4;
#   ssm_whole: the same without ``ssm_head_tp``: the whole mixer;
#   ssm_h6: 6 heads of 64: head-parallel at 2 (in_proj's block of 396 ends
#     12 columns into x), the whole mixer at 4 (6 heads do not divide it),
#     in_proj (792) and out_proj's 384 rows split there;
#   hybrid: hymba's shape: 5 query heads over 1 KV head (the heads divide
#     neither 2 nor 4: the gathered attention; k and v whole), 10 SSM
#     heads: head-parallel at 2, the whole mixer at 4, where in_proj's
#     666 columns stay whole as hymba's 6482 do;
#   audio: whisper with an odd vocabulary (513: embed and lm_head whole over
#     model, split over data), 4 heads: q/k/v/o split at 2, whole at 4;
#   vlm: llava with 4 heads over 2 KV heads (k and v whole at 2) and 8
#     patches; patch_in_proj splits at 2, whole at 4.
FAMILY_MODELS = {
    "ssm": ("mamba2-370m", dict(d_model=128, ssm_head_dim=32, ssm_state=8, ssm_head_tp=True)),
    "ssm_whole": ("mamba2-370m", dict(d_model=128, ssm_head_dim=32, ssm_state=8)),
    "ssm_h6": ("mamba2-370m", dict(d_model=192, ssm_head_dim=64, ssm_state=9,
                                   ssm_head_tp=True)),
    "hybrid": ("hymba-1.5b", dict(d_model=160, n_heads=5, n_kv_heads=1, head_dim=64, d_ff=256,
                                  ssm_head_dim=32, ssm_state=8, ssm_head_tp=True)),
    "audio": ("whisper-medium", dict(d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
                                     d_ff=256, vocab_size=513, n_enc_layers=1)),
    "vlm": ("llava-next-34b", dict(d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
                                   d_ff=256)),
}


def family_cfg(name):
    arch, kw = FAMILY_MODELS[name]
    return get_config(arch, smoke=True).with_(dtype=torch.float32, n_layers=1, **kw)


def family_case(mesh, case, ref_dir):
    """One family's model from JAX's params (``fam_<model>.pt``, written by
    the parent with JAX's batches and refresh draws): the step's reduced
    step-0 gradients, 3 steps of ``make_train_step(mesh=)`` (the gathered
    params, losses and bytes per collective each step, the counts of the
    shapes), then from the one-process state after step 1 the step's
    reduced gradients and the update of this process's blocks on them (a
    hot step isolated from the gradients' rounding)."""
    name = case["model"]
    src = torch.load(os.path.join(ref_dir, f"fam_{name}.pt"), weights_only=False)
    cfg = family_cfg(name)
    model = build_model(cfg, device="cpu")
    params = bridge.params_from_numpy(src["params"], "cpu")
    batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in src["batches"]]
    opt = optimizer(params)
    fns = make_train_step(model, opt, mesh=mesh)
    lopt = fns["optimizer"]
    init = opt.init(params)._replace(draws=RecordedDraws(src["draws"]))
    state = fns["place_state"](TrainState(copy(params), init))
    _, _, grads = fns["grads"](state, batches[0])
    rows = BATCH // (mesh.dp * mesh.shape.get("pod", 1))
    out = {"fsdp": fns["fsdp"], "tp": mesh.tp, "params": [], "comm": [], "losses": [],
           "grads0": tree_leaves(shd.gather_params(grads, mesh, fns["splits"])),
           "local": [tuple(x.shape) for x in tree_leaves(state.params)],
           "model_formula": tp_hot_comm_bytes(cfg, rows, SEQ, lopt.bucket_plan, 4, tp=mesh.tp)
           if mesh.tp > 1 else 0,
           "data_formula": fsdp_hot_comm_bytes(lopt, cfg) if fns["fsdp"] else 0}
    del grads
    for s in range(STEPS):
        mesh_lib.comm_reset()
        state, m = (fns["refresh_step"] if s == 0 else fns["step"])(state, batches[s])
        out["comm"].append(mesh_lib.comm_snapshot())
        out["losses"].append(float(m["loss"]))
        out["params"].append(tree_leaves(fns["gather_state"](state).params))
    ref = torch.load(os.path.join(ref_dir, f"fam_{name}_1.pt"), weights_only=False)
    st = fns["place_state"](TrainState(ref["params"], ref["opt_state"]))
    _, _, grads = fns["grads"](st, batches[2])
    hot, _, _ = lopt.update(grads, st.opt_state, st.params, refresh=False, apply=True)
    out["hot_grads"] = tree_leaves(shd.gather_params(grads, mesh, fns["splits"]))
    out["hot_from_ref"] = tree_leaves(shd.gather_params(hot, mesh, fns["splits"]))
    return out


def family_loop_case(mesh, case, ref_dir):
    """``train_loop`` of the ``ssm`` model on the seed's params: 2 steps
    writing the gathered checkpoint at step 2 into ``case["write"]``; the
    gathered params and canonical optimizer state there."""
    cfg = family_cfg("ssm")
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    data = SyntheticDataset(SyntheticDataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                                global_batch=BATCH), device="cpu")
    opt = optimizer(params)
    fns = make_train_step(model, opt, mesh=mesh)
    tc = TrainConfig(total_steps=2, checkpoint_every=2, checkpoint_dir=case["write"],
                     async_checkpoint=False)
    res = train_loop(model, opt, data, tc, fns, log_every=1, handle_signals=False)
    state = fns["gather_state"](res.state)
    return {"fsdp": fns["fsdp"], "losses": res.losses, "params": tree_leaves(state.params),
            "canonical": canonical_opt_state(opt, state.opt_state)}


# ---------------------------------------------------------------------------
# every optimizer under tensor parallelism and FSDP (test_torch_parallel_inners*.py)
# ---------------------------------------------------------------------------

# The eight optimizers of the inners worlds: (name, keywords over OPT_KW).
INNER_RUNS = {
    "adam_mini": ("galore-sara-adam-mini", {}),
    "adam8bit": ("galore-sara-adam8bit", {}),
    "golore": ("golore-adam", {}),
    "grass": ("grass-adam", {}),
    "online_pca": ("online-pca-adam", {}),
    "fira": ("fira-sara-adam", {}),
    "adafactor": ("galore-sara-adafactor", {}),
    "reference": ("galore-sara-adam", dict(engine="reference")),
}
# Adam on the bucketed engine, beside them in the ZeRO worlds
RUNS = dict(INNER_RUNS, adam=("galore-sara-adam", {}))
# the loop under a rank schedule (16 -> 8 at the step-2 refresh: a
# re-bucket), the spectrum logger and track_subspace, 6 steps at tau 2
LOOP_KW = dict(rank=16, tau=2, rank_schedule="step:16:8@0.5")
LOOP_STEPS = 6
# d_ff 384: at a model extent of 2 gate_proj's and up_proj's blocks of 192
# columns end inside 8-bit chunk 0 and cut Adam-mini's rows; d 128 splits
# every weight over data at 2, k_proj and v_proj (64 columns) stay whole
# over model; embed's 64-column blocks over data cut its chunk 0 too.
INNERS_MODEL = dict(d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=384, n_layers=1)


def inners_cfg():
    return get_config("llama3-8b", smoke=True).with_(dtype=torch.float32, **INNERS_MODEL)


def inners_setup():
    cfg = inners_cfg()
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    data = SyntheticDataset(SyntheticDataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                                global_batch=BATCH), device="cpu")
    return model, params, data


def inner_optimizer(params, run, **kw):
    name, extra = RUNS[run]
    return make_optimizer(name, params, **dict(OPT_KW, **extra, **kw))


def inners_case(mesh, case, ref_dir):
    """Each optimizer of ``case["runs"]`` (``INNER_RUNS``) through
    ``make_train_step(mesh=)``: 3 steps from the seed's params (the
    gathered params and losses), then from the one-process state after
    step 1 (``inner_<run>_1.pt``) the step's reduced gradients and the
    update of this process's blocks on them, hot and refresh (gathered
    params and canonical state).  ``case["zero"]``: ZeRO state over data
    as well, with the state bytes this process holds; ``case["compressed"]``
    the compressed step's mode."""
    model, params, data = inners_setup()
    out = {}
    for run in case["runs"]:
        z = dict(state_sharding="zero", state_shards=mesh.dp) if case.get("zero") else {}
        opt = inner_optimizer(params, run, **z)
        fns = make_train_step(model, opt, mesh=mesh, compressed=case.get("compressed", ""))
        lopt = fns["optimizer"]
        state = fns["place_state"](TrainState(copy(params), opt.init(params)))
        got = {"params": [], "losses": [], "fsdp": fns["fsdp"],
               "state_bytes": state_memory_bytes(state.opt_state)}
        for s in range(STEPS):
            state, m = (fns["refresh_step"] if s == 0 else fns["step"])(state, data.batch_at(s))
            got["losses"].append(float(m["loss"]))
            got["params"].append(tree_leaves(fns["gather_state"](state).params))
        ref = torch.load(os.path.join(ref_dir, f"inner_{run}_1.pt"), weights_only=False)
        st = fns["place_state"](TrainState(ref["params"], ref["opt_state"]))
        _, _, grads = fns["grads"](st, data.batch_at(2))
        got["grads"] = tree_leaves(shd.gather_params(grads, mesh, fns["splits"]))
        for kind in ("hot", "refresh"):
            p, ost, _ = lopt.update(grads, st.opt_state, st.params, refresh=kind == "refresh",
                                    apply=True, shard_axes=mesh.data_axes() if z else None)
            full = fns["gather_state"](TrainState(p, ost))
            got[kind] = tree_leaves(full.params)
            got[kind + "_state"] = canonical_opt_state(opt, full.opt_state)
        out[run] = got
    return out


def inners_jax_case(mesh, case, ref_dir):
    """Each optimizer of ``case["runs"]`` from JAX's params
    (``jax_<run>.pt``, written by the parent, which marks them done with
    ``jax_ready`` while the world runs its other cases): the world's loss on
    JAX's batch (this process's rows) and reduced gradients, then the
    optimizer of this process's blocks on JAX's gradients -- a refresh with
    JAX's draws, and a hot step from JAX's post-refresh state."""
    deadline = time.monotonic() + TIMEOUT.total_seconds()
    while not os.path.exists(os.path.join(ref_dir, "jax_ready")):
        if time.monotonic() > deadline:
            raise TimeoutError("the parent wrote no JAX references")
        time.sleep(0.2)
    model = build_model(inners_cfg(), device="cpu")
    out = {}
    for run in case["runs"]:
        src = torch.load(os.path.join(ref_dir, f"jax_{run}.pt"), weights_only=False)
        params = bridge.params_from_numpy(src["params"], "cpu")
        batch = {k: torch.from_numpy(v) for k, v in src["batch"].items()}
        opt = inner_optimizer(params, run, lr=0.01, grad_clip_norm=1.0, tau=200)
        fns = make_train_step(model, opt, mesh=mesh)
        topt, blocks = fns["optimizer"], fns["splits"]
        local = fns["place_state"](TrainState(params, opt.init(params)._replace(
            draws=RecordedDraws(src["draws"]))))
        loss, _, grads = fns["grads"](local, batch)
        g0 = shd.shard_params(bridge.params_from_numpy(src["grads0"], "cpu"), mesh, blocks)
        p1, _, aux1 = topt.update(g0, local.opt_state, local.params, refresh=True, apply=True)
        js1 = bridge.opt_state_from_numpy(opt, src["state1"], "cpu")
        local1 = fns["place_state"](TrainState(bridge.params_from_numpy(src["params1"], "cpu"),
                                               js1))
        g1 = shd.shard_params(bridge.params_from_numpy(src["grads1"], "cpu"), mesh, blocks)
        p2, s2, aux2 = topt.update(g1, local1.opt_state, local1.params, refresh=False,
                                   apply=True)
        out[run] = {"loss": float(loss), "grads": tree_leaves(shd.gather_params(grads, mesh,
                                                                                 blocks)),
                    "params1": tree_leaves(shd.gather_params(p1, mesh, blocks)),
                    "params2": tree_leaves(shd.gather_params(p2, mesh, blocks)),
                    "state2": canonical_opt_state(opt, fns["gather_state"](
                        TrainState(p2, s2)).opt_state),
                    "aux1": [float(aux1.grad_norm), float(aux1.update_norm),
                             float(aux1.mean_refresh_overlap)],
                    "aux2": [float(aux2.grad_norm), float(aux2.update_norm)]}
    return out


def inners_loop_case(mesh, case, ref_dir):
    """``train_loop`` of ``galore-sara-adam`` on the inners model: with
    ``case["schedule"]`` 6 steps under ``LOOP_KW`` with the spectrum logger
    and ``track_subspace`` (losses, gathered params, the history's spectrum
    and re-bucket records, the tracker's summary, the final rank), saving
    at step 4 (at the re-bucketed rank), then a new loop at the schedule's
    first rank resuming that checkpoint to step 6 (its gathered params),
    both in ``case["write"]``; with
    ``case["zero"]`` ZeRO state over data, 3 steps writing the gathered
    checkpoint at step 2 into ``case["write"]``."""
    model, params, data = inners_setup()
    kw = dict(LOOP_KW) if case.get("schedule") else {}
    if case.get("zero"):
        kw.update(state_sharding="zero", state_shards=mesh.dp)
    opt = make_optimizer("galore-sara-adam", params, **dict(OPT_KW, **kw))
    fns = make_train_step(model, opt, mesh=mesh)
    steps = LOOP_STEPS if case.get("schedule") else STEPS
    every = 4 if case.get("schedule") else 2 if "write" in case else 0
    tc = TrainConfig(total_steps=steps, checkpoint_every=every,
                     checkpoint_dir=case.get("write") or os.path.join(ref_dir, f"il_{mesh.rank}"),
                     async_checkpoint=False, log_spectrum=bool(case.get("schedule")))
    res = train_loop(model, opt, data, tc, fns, log_every=1, handle_signals=False,
                     track_subspace=bool(case.get("schedule")))
    state = make_train_step(model, res.optimizer, mesh=mesh)["gather_state"](res.state)
    out = {"fsdp": fns["fsdp"], "losses": res.losses, "params": tree_leaves(state.params),
           "events": [r for r in res.history if "event" in r],
           "subspace": res.subspace.summary() if res.subspace is not None else None,
           "rank": res.optimizer.config.rank,
           "canonical": canonical_opt_state(res.optimizer, state.opt_state)}
    if case.get("schedule"):
        # the rank-aware restore: a loop built at the first rank resumes the
        # step-4 checkpoint, whose manifest carries the re-bucketed rank
        again = train_loop(model, opt, data, tc, make_train_step(model, opt, mesh=mesh),
                           log_every=1, handle_signals=False)
        out["resumed"] = tree_leaves(make_train_step(model, again.optimizer, mesh=mesh)[
            "gather_state"](again.state).params)
        out["resumed_rank"] = again.optimizer.config.rank
    return out


CASES = {"traj": traj_case, "jax": jax_case, "loop": loop_case, "ep": ep_case,
         "family": family_case, "family_loop": family_loop_case, "inners": inners_case,
         "inners_jax": inners_jax_case, "inners_loop": inners_loop_case}


def world(rank, size, store, out_dir, ref_dir, plan):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=size,
                            rank=rank, timeout=TIMEOUT)
    try:
        mesh = mesh_lib.make_mesh(tuple(plan["mesh"]))
        out = {}
        for name, case in plan["cases"].items():
            out[name] = CASES[case["kind"]](mesh, case, ref_dir)
            mesh_lib.barrier(mesh)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(tmp, ref_dir, plan, timeout_s=None):
    """Start the world of ``plan`` (its processes run while the caller goes
    on); the returned function waits for them (with ``timeout_s``, at most
    that long from the start: then it kills them and fails) and loads each
    process's outputs."""
    size = int(np.prod(plan["mesh"]))
    out_dir = tmp / f"world_{'x'.join(map(str, plan['mesh']))}"
    out_dir.mkdir()
    ctx = mp.start_processes(world, args=(size, str(out_dir / "store"), str(out_dir), ref_dir,
                                          plan), nprocs=size, join=False, start_method="spawn")
    deadline = None if timeout_s is None else time.monotonic() + timeout_s

    def finish():
        while not ctx.join(timeout=None if deadline is None
                           else max(deadline - time.monotonic(), 0.1)):
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise AssertionError(f"the {plan['mesh']} world outlived {timeout_s} s")
        return [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(size)]

    return finish


