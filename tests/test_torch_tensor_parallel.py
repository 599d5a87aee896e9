"""The port's tensor parallelism over ``model`` and its MoE expert-parallel
path (``launch/mesh.py``'s model axis, ``launch/sharding.param_spec``,
``models/parallel.py``, the tensor-parallel layers, ``models/moe.py``'s EP
path, ``core/lowrank.tensor_parallel_optimizer``, ``train/step.py``,
``train/loop.py`` and the launcher with ``--mesh``), in spawned gloo worlds
of 2 and 4 processes on the CPU (``tp_worlds.py``, which imports no JAX).

JAX's sharded standard step fails on this tree's jax
(``tests/test_distributed.py``), but under GSPMD it computes the single
device's math: so the tensor-parallel step is held against the
single-process step of both packages.  JAX's expert-parallel path runs
(``test_moe_ep_equals_local_on_mesh``), so the port's is held against it
directly, on 4 forced host devices in a subprocess.

The models: the smoke llama at f32 with d 128, 4 heads and 2 KV heads
(k_proj and v_proj stay whole under the guard at TP 2, the rest splits:
the mixed case) and at d 256 (every leaf splits), 2 layers, rank 8, tau 4,
seq 32, global batch 4, the randomized SVD, on (1, 2) and (2, 2) meshes
(the latter with ``compressed="flat"``, replicated and ZeRO state).

Bars:
  * ``TP_TOL`` (1e-6 abs): the loss and every gathered gradient against
    the single-process step's, and the params after one hot step from
    the single-process state (the same sums in other orders: each
    process's partial products, then the all-reduce);
  * ``REFRESH_TOL`` (5e-5 abs on params) through a refresh: the sketch's
    products summed over processes move the randomized SVD's last bits,
    and SARA's draw and Adam's first step amplify them
    (``test_torch_train.py``);
  * against JAX's single-device step on JAX's params, batch, gradients
    and draws: ``GRAD_TOL`` (1e-6 abs + 1e-5 rel) on the loss and the
    gradients, ``REFRESH_TOL`` after the refresh, ``HOT_TOL`` (1e-6 abs)
    after a hot step from JAX's post-refresh state (``test_torch_train.py``'s
    bars);
  * the MoE layer's expert-parallel output and aux within ``EP_TOL`` (1e-5
    abs) of JAX's expert-parallel path at capacity factors 8 and 1.25,
    and the dropped (token, slot) pairs equal; at 8 (no drops) within
    ``EP_TOL`` of the port's local path;
  * bit-equal where the arithmetic is the same: the bytes handed to the
    ``model`` collectives against ``models.tp_hot_comm_bytes``, the
    processes' params against each other, and the launcher's printed
    losses at ``--mesh 1,2`` and ``--mesh 2,2`` against the one-process
    launcher's.
"""
import os
import shutil
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import list_archs
from repro.core import make_optimizer as jax_make_optimizer
from repro.data.synthetic import SyntheticDataConfig as JaxDataConfig
from repro.data.synthetic import SyntheticDataset as JaxDataset
from repro.launch import sharding as jax_shd
from repro.models import build_model as jax_build_model
from repro.train import checkpoint as jax_ckpt
from repro.train.state import TrainState as JaxTrainState
from repro.train.state import checkpoint_converters as jax_converters
from repro_torch import bridge
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import buckets as buckets_lib
from repro_torch.core import make_optimizer
from repro_torch.core.lowrank import tree_leaves
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as shd
from repro_torch.models import build_model, tp_hot_comm_bytes
from repro_torch.models import moe as moe_lib
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import state as state_lib
from repro_torch.train.loop import train_loop
from repro_torch.train.state import TrainState
from repro_torch.train.step import make_train_step
from test_torch_optim_kernels import JaxDraws

import tp_worlds as W

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# One intra-op thread: the test workers share the host's cores, and the
# port's results do not depend on the thread count (core/svd.py).
torch.set_num_threads(1)

TP_TOL = 1e-6
REFRESH_TOL = 5e-5
GRAD_TOL = dict(atol=1e-6, rtol=1e-5)
HOT_TOL = 1e-6
EP_TOL = 1e-5
JAX_OPT_KW = dict(rank=8, tau=200, lr=0.01, grad_clip_norm=1.0, engine="bucketed",
                  svd_backend="randomized")
MESHES = {(1, 2): ("data", "model"), (2, 2): ("data", "model"), (1, 4): ("data", "model"),
          (16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model")}
# the SSM, hybrid, enc-dec and VLM families' leaves at full width that
# ``test_param_spec_matches_jax`` must meet
_SSM_LEAVES = ("in_proj", "out_proj", "conv_w", "conv_b", "d_skip", "a_log", "dt_bias",
               "ssm_norm_scale")
FAMILY_LEAVES = {
    "mamba2-370m": [f"['blocks']['mixer']['{n}']" for n in _SSM_LEAVES],
    "hymba-1.5b": [f"['blocks']['ssm_mixer']['{n}']" for n in _SSM_LEAVES],
    "whisper-medium": [f"['blocks']['cross_{n}_proj']" for n in "qkvo"]
    + ["['embed']", "['lm_head']", "['enc_blocks']['q_proj']"],
    "llava-next-34b": ["['patch_in_proj']"],
}
# the MoE layer's cases: (capacity factor, expert d_ff); d_ff 32 leaves the
# fused shared experts (64 wide) whole at TP 2, 64 splits them
EP_CASES = {"cf8_ff32": (8.0, 32), "cf8_ff64": (8.0, 64), "cf1.25_ff32": (1.25, 32),
            "cf1.25_ff64": (1.25, 64)}


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _max_err(got, want):
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# the name-based rules against JAX's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def arch_shapes():
    """{arch: [(keystr path, global shape)]} of every registry arch's params
    at full width, from JAX's init traced abstractly (nothing allocated)."""
    out = {}
    for arch in list_archs():
        model = jax_build_model(jax_get_config(arch))
        tree = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        out[arch] = [(jax.tree_util.keystr(p), tuple(x.shape))
                     for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]
    return out


@pytest.mark.parametrize("shape", list(MESHES), ids=lambda s: "x".join(map(str, s)))
def test_param_spec_matches_jax(arch_shapes, shape):
    """Every leaf of every registry arch: the port's spec is JAX's (JAX's
    ``param_spec`` reads only ``.shape`` and ``.axis_names``: a stub mesh)."""
    mesh = types.SimpleNamespace(shape=dict(zip(MESHES[shape], shape)),
                                 axis_names=MESHES[shape])
    n = 0
    seen = {arch: set() for arch in FAMILY_LEAVES}
    for arch, leaves in arch_shapes.items():
        for path, gshape in leaves:
            want = tuple(jax_shd.param_spec(path, gshape, mesh))
            assert shd.param_spec(path, gshape, mesh) == want, (arch, path, gshape)
            n += 1
            if arch in seen:
                seen[arch].add(path)
    assert n > 100  # every leaf of the ten archs
    # the SSM, hybrid, enc-dec and VLM families' own leaves at full width
    for arch, paths in FAMILY_LEAVES.items():
        assert set(paths) <= seen[arch], (arch, set(paths) - seen[arch])
    # whisper's odd vocabulary (51865) keeps embed and lm_head whole over model
    dims = dict(arch_shapes["whisper-medium"])
    for path in ("['embed']", "['lm_head']"):
        assert "model" not in shd.param_spec(path, dims[path], mesh)


# ---------------------------------------------------------------------------
# the worlds
# ---------------------------------------------------------------------------


def _ref_trajectory(name, ref_dir):
    """The single-process step's 3 steps, its step-0 loss and gradients,
    and its state after step 1 on disk (the hot-step-from-one-state case)."""
    model, params, data = W.setup(name)
    opt = W.optimizer(params)
    loss, grads = W.loss_and_grads(model, params, data.batch_at(0), None)
    fns = make_train_step(model, opt)
    state = TrainState(W.copy(params), opt.init(params))
    traj = []
    for s in range(W.STEPS):
        state, m = (fns["refresh_step"] if s == 0 else fns["step"])(state, data.batch_at(s))
        traj.append(tree_leaves(state.params))
        if s == 1:
            torch.save({"params": state.params, "opt_state": state.opt_state},
                       os.path.join(ref_dir, f"{name}_1.pt"))
    return {"loss0": loss, "grads0": tree_leaves(grads), "traj": traj, "opt": opt,
            "canonical": state_lib.canonical_train_state(opt, state).opt_state}


def _jax_reference(ref_dir):
    """JAX's d 128 model: its params, batches, gradients, one refresh (its
    draws recorded for the processes) and one hot step."""
    jcfg = jax_get_config("llama3-8b", smoke=True).with_(dtype=jnp.float32,
                                                         **W.MODELS["d128"])
    jmodel = jax_build_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    data = JaxDataset(JaxDataConfig(vocab_size=jcfg.vocab_size, seq_len=W.SEQ,
                                    global_batch=W.BATCH))
    batches = [data.batch_at(i) for i in range(2)]
    vg = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))
    (l0, _), g0 = vg(jparams, batches[0])
    _, g1 = vg(jparams, batches[1])
    jopt = jax_make_optimizer("galore-sara-adam", jparams, **JAX_OPT_KW)
    js0 = jopt.init(jparams)
    update = jax.jit(jopt.update, static_argnames=("refresh", "apply"))
    jp1, js1, jaux1 = update(g0, js0, jparams, refresh=True, apply=True)
    jp2, _, jaux2 = update(g1, js1, jp1, refresh=False, apply=True)
    # the refresh's draws, per leaf at its global shape, as the port's
    # optimizer asks for them
    tparams = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    topt = make_optimizer("galore-sara-adam", tparams, **JAX_OPT_KW)
    jd = JaxDraws(js0.key).split()
    pcfg = topt.config.projector_config()
    draws = {}
    for bk in topt.bucket_plan.buckets:
        for e in bk.entries:
            ld = buckets_lib.entry_draws(jd, e, topt.state_layout.templates[e.leaf_idx], bk,
                                         pcfg, "cpu")
            draws[e.leaf_idx] = tuple(None if x is None else _np(x) for x in ld)
    n = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    torch.save({"params": n(jparams), "batch": {k: np.asarray(v) for k, v in batches[0].items()},
                "grads0": n(g0), "grads1": n(g1), "draws": draws, "state1": n(js1),
                "params1": n(jp1)}, os.path.join(ref_dir, "jax.pt"))
    return {"loss": float(l0), "grads": n(g0), "params1": n(jp1), "params2": n(jp2),
            "aux1": [float(jaux1.grad_norm), float(jaux1.update_norm),
                     float(jaux1.mean_refresh_overlap)],
            "aux2": [float(jaux2.grad_norm), float(jaux2.update_norm)],
            "jopt": jopt, "jstate1": js1}


_EP_SCRIPT = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs.registry import get_config
from repro.launch.mesh import make_mesh
from repro.models import moe as moe_lib

out_dir, cases = sys.argv[1], eval(sys.argv[2])
mesh = make_mesh((2, 2))
for name, (cf, d_ff) in cases.items():
    cfg = get_config("deepseek-moe-16b", smoke=True).with_(
        dtype=jnp.float32, moe_capacity_factor=cf, d_ff=d_ff)
    key = jax.random.PRNGKey(0)
    p = moe_lib.init_moe_mlp(key, cfg)
    x = jax.random.normal(jax.random.fold_in(key, 1), (4, 16, cfg.d_model)) * 0.5
    with mesh:
        out, aux = jax.jit(lambda p_, x_: moe_lib.apply_moe_mlp(p_, x_, cfg))(p, x)
    # the (token, slot) pairs JAX's EP drops: per data shard (2 rows), the
    # position of each routed pair in its expert past the capacity
    dropped, k, e = [], cfg.moe_top_k, cfg.n_experts
    for shard in range(2):
        xs = x[2 * shard:2 * shard + 2].reshape(-1, cfg.d_model)
        t = xs.shape[0]
        probs = jax.nn.softmax((xs.astype(jnp.float32) @ p["router_w"]), axis=-1)
        top_i = np.asarray(jax.lax.top_k(probs, k)[1]).reshape(-1)
        cap = int(t * k / e * cf) + 1
        seen = np.zeros(e, int)
        for j, ex in enumerate(top_i):
            if seen[ex] >= cap:
                dropped.append((shard * t + j // k, j % k))
            seen[ex] += 1
    np.savez(os.path.join(out_dir, f"moe_{name}.npz"), x=np.asarray(x), out=np.asarray(out),
             aux=np.asarray(aux), router_w=np.asarray(p["router_w"]), cf=cf, d_ff=d_ff,
             dropped=np.asarray(dropped, dtype=np.int64).reshape(-1, 2),
             **{f"experts_{n}": np.asarray(v) for n, v in p["experts"].items()},
             **{f"shared_{n}": np.asarray(v) for n, v in p["shared_mlp"].items()})
print("OK")
"""


def _jax_ep(ref_dir):
    """JAX's EP cases in a subprocess (4 forced host devices), started here
    and waited for by the returned function."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(_EP_SCRIPT), ref_dir,
                             repr(EP_CASES)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)

    def finish():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0 and "OK" in out, err[-4000:]

    return finish


def _one_process_loop(ref_dir):
    """A one-process run of the d 256 model to step 2 (a checkpoint there),
    which the (1, 2) world resumes under tensor parallelism."""
    model, params, data = W.setup("d256")
    opt = W.optimizer(params)
    ck = os.path.join(ref_dir, "one_process")
    tc = TrainConfig(total_steps=2, checkpoint_every=2, checkpoint_dir=ck,
                     async_checkpoint=False)
    train_loop(model, opt, data, tc, make_train_step(model, opt), log_every=1,
               handle_signals=False)
    return ck


TRAJ_2 = {f"{m}": dict(kind="traj", model=m) for m in W.MODELS}
TRAJ_4 = {f"{m}_flat_{z}": dict(kind="traj", model=m, compressed="flat",
                                zero=2 if z == "zero" else 0)
          for m in W.MODELS for z in ("repl", "zero")}
TRAJ_4["d256_standard"] = dict(kind="traj", model="d256")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    ref_dir = tmp / "ref"
    ref_dir.mkdir()
    # JAX's EP subprocess, the single-process runs and the (1, 2) world run
    # at once while this process makes JAX's single-device reference; the
    # (2, 2) world then takes both
    jax_ep = _jax_ep(str(ref_dir))
    refs = {m: _ref_trajectory(m, str(ref_dir)) for m in W.MODELS}
    one_ck = _one_process_loop(str(ref_dir))
    w2 = W.spawn(tmp, str(ref_dir), {"mesh": (1, 2), "cases": dict(
        TRAJ_2, loop_write=dict(kind="loop", write=str(tmp / "tp_ck")),
        loop_resume=dict(kind="loop", resume=one_ck))})
    jref = _jax_reference(str(ref_dir))
    w2 = w2()
    jax_ep()
    w4 = W.spawn(tmp, str(ref_dir), {"mesh": (2, 2), "cases": dict(
        TRAJ_4, jax=dict(kind="jax"), **{f"ep_{n}": dict(kind="ep", name=n) for n in EP_CASES})})()
    return dict(refs=refs, jref=jref, w2=w2, w4=w4, ref_dir=str(ref_dir),
                tp_ck=str(tmp / "tp_ck"))


@pytest.mark.parametrize("world,case", [(2, c) for c in TRAJ_2] + [(4, c) for c in TRAJ_4])
def test_tp_world_matches_the_single_process_step(worlds, world, case):
    """The step-0 loss and every gathered gradient (TP_TOL), the params
    after each step (REFRESH_TOL: the trajectory starts with a refresh),
    one hot step from the single-process state (TP_TOL), the processes'
    params bit-equal, and the local plans of the mixed and the split
    model."""
    ranks = worlds[f"w{world}"]
    spec = (TRAJ_2 if world == 2 else TRAJ_4)[case]
    ref = worlds["refs"][spec["model"]]
    got = ranks[0][case]
    assert abs(got["loss0"] - ref["loss0"]) <= TP_TOL
    assert _max_err(got["grads0"], ref["grads0"]) <= TP_TOL
    for s in range(W.STEPS):
        assert _max_err(got["params"][s], ref["traj"][s]) <= REFRESH_TOL, (case, s)
        for r in ranks[1:]:
            assert all(torch.equal(a, b) for a, b in zip(r[case]["params"][s], got["params"][s]))
    assert _max_err(got["hot_from_ref"], ref["traj"][2]) <= TP_TOL
    if world == 2:
        kinds = sorted({b[-1] for b in got["plan"]})
        # d 128: q and the mlp split on their free dim, o on its projected
        # dim, k and v whole; d 256: k and v split too
        assert kinds == (["", "d", "n"] if spec["model"] == "d128" else ["d", "n"]), got["plan"]


@pytest.mark.parametrize("world,case", [(2, "d256"), (4, "d256_flat_repl"),
                                        (4, "d256_flat_zero"), (4, "d256_standard")])
def test_hot_step_bytes_over_model_equal_the_shape_count(worlds, world, case):
    """Each hot step hands the ``model`` collectives the bytes that
    ``models.tp_hot_comm_bytes`` counts from the shapes (the layers'
    activations, the embedding, the cross-entropy and the "d" buckets'
    partial R), on every process."""
    cfg = W.dense_cfg("d256")
    rows = W.BATCH // (world // 2)
    model, params, _ = W.setup("d256")
    for r in worlds[f"w{world}"]:
        plan = buckets_lib.BucketPlan(tuple(
            buckets_lib.Bucket(d, n, rk, (buckets_lib.BucketEntry(0, "left", b),), split=sp,
                               tp=2) for d, n, rk, b, sp in r[case]["plan"]), frozenset())
        want = tp_hot_comm_bytes(cfg, rows, W.SEQ, plan, 4)
        for c in r[case]["comm"][1:]:
            assert c.get("all_reduce@model", 0) + c.get("all_gather@model", 0) == want


def test_tp_against_jax_single_device_step(worlds):
    """JAX's params, batch, gradients and draws: the loss and every gathered
    gradient (GRAD_TOL), the params after a refresh (REFRESH_TOL) and
    after a hot step from JAX's post-refresh state (HOT_TOL), the norms."""
    j, got = worlds["jref"], worlds["w4"][0]["jax"]
    np.testing.assert_allclose(got["loss"], j["loss"], **GRAD_TOL)
    jleaves = jax.tree_util.tree_leaves(j["grads"])
    for a, b in zip(got["grads"], jleaves):
        np.testing.assert_allclose(_np(a), b, **GRAD_TOL)
    for a, b in zip(got["params1"], jax.tree_util.tree_leaves(j["params1"])):
        np.testing.assert_allclose(_np(a), b, atol=REFRESH_TOL, rtol=0)
    for a, b in zip(got["params2"], jax.tree_util.tree_leaves(j["params2"])):
        np.testing.assert_allclose(_np(a), b, atol=HOT_TOL, rtol=0)
    np.testing.assert_allclose(got["aux1"], j["aux1"], rtol=1e-5)
    np.testing.assert_allclose(got["aux2"], j["aux2"], rtol=1e-5)


def test_tp_checkpoint_resumes_on_one_process_and_in_jax(worlds):
    """The (1, 2) world's loop wrote JAX's canonical per-leaf checkpoint at
    step 2 from the gathered state: one process resumes it to step 3 (its
    params within TP_TOL of the world's own step 3: one hot step from the
    same state), and JAX loads it into its skeleton, the same params."""
    model, params, data = W.setup("d256")
    opt = W.optimizer(params)
    ck = os.path.join(worlds["ref_dir"], "resume_on_one")
    shutil.copytree(worlds["tp_ck"], ck)
    tc = TrainConfig(total_steps=W.STEPS, checkpoint_every=0, checkpoint_dir=ck,
                     async_checkpoint=False)
    res = train_loop(model, opt, data, tc, make_train_step(model, opt), log_every=1,
                     handle_signals=False)
    assert len(res.losses) == 1
    assert _max_err(tree_leaves(res.state.params), worlds["w2"][0]["loop_write"]["params"]) \
        <= TP_TOL
    # JAX reads it: the step-2 params the world gathered, bit for bit
    canon, loc = state_lib.checkpoint_converters(opt)
    saved = ckpt_lib.CheckpointManager(worlds["tp_ck"], canonicalize=canon, localize=loc).load(
        TrainState(params, opt.init(params)), step=2)
    jcfg = jax_get_config("llama3-8b", smoke=True).with_(dtype=jnp.float32,
                                                         **W.MODELS["d256"])
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    jopt = jax_make_optimizer("galore-sara-adam", jparams, **W.OPT_KW)
    jcan, jloc = jax_converters(jopt)
    jstate = jax_ckpt.CheckpointManager(worlds["tp_ck"], canonicalize=jcan, localize=jloc).load(
        JaxTrainState(jparams, jopt.init(jparams)), step=2)
    for a, b in zip(jax.tree_util.tree_leaves(jstate.params), tree_leaves(saved.params)):
        np.testing.assert_array_equal(np.asarray(a), _np(b))
    assert int(jstate.opt_state.step) == 2


def test_one_process_checkpoint_resumes_under_tp(worlds):
    """A one-process checkpoint at step 2, resumed by the (1, 2) world to
    step 3: one hot step from the same state, within TP_TOL of the
    single-process run's step 3."""
    got = worlds["w2"][0]["loop_resume"]
    assert len(got["losses"]) == 1
    assert _max_err(got["params"], worlds["refs"]["d256"]["traj"][2]) <= TP_TOL


@pytest.mark.parametrize("name", list(EP_CASES))
def test_ep_matches_jax_expert_parallel_path(worlds, name):
    """The (2, 2) world's expert-parallel MoE layer on JAX's params and
    input: each data row block's output within EP_TOL of JAX's EP, the aux
    (averaged over ``data`` as JAX's pmean) within EP_TOL, and the dropped
    (token, slot) pairs JAX's."""
    src = np.load(os.path.join(worlds["ref_dir"], f"moe_{name}.npz"))
    ranks = [r[f"ep_{name}"] for r in worlds["w4"]]
    out = np.zeros_like(src["out"])
    for r in ranks:
        lo, hi = r["rows"]
        out[lo:hi] = _np(r["out"])
    np.testing.assert_allclose(out, src["out"], atol=EP_TOL, rtol=0)
    aux = np.mean([r["aux"] for r in ranks])
    np.testing.assert_allclose(aux, float(src["aux"]), atol=EP_TOL, rtol=0)
    dropped = sorted({tuple(p) for r in ranks for p in r["dropped"]})
    assert dropped == sorted(map(tuple, src["dropped"].tolist()))
    if src["cf"] == 8.0:
        assert dropped == []
    else:
        assert dropped, "capacity 1.25 should drop pairs at this routing"


@pytest.mark.parametrize("name", ["cf8_ff32", "cf8_ff64"])
def test_ep_matches_the_local_path_without_drops(worlds, name):
    """At capacity factor 8 nothing is dropped, and the expert-parallel
    output equals the port's local dropless path on each row block."""
    src = np.load(os.path.join(worlds["ref_dir"], f"moe_{name}.npz"))
    cfg = get_config("deepseek-moe-16b", smoke=True).with_(
        dtype=torch.float32, d_ff=int(src["d_ff"]), moe_capacity_factor=float(src["cf"]))
    p = bridge.params_from_numpy({
        "router_w": src["router_w"],
        "experts": {k: src[f"experts_{k}"] for k in ("gate_proj", "up_proj", "down_proj")},
        "shared_mlp": {k: src[f"shared_{k}"] for k in ("gate_proj", "up_proj", "down_proj")},
    }, "cpu")
    x = torch.from_numpy(src["x"])
    for r in worlds["w4"]:
        lo, hi = r[f"ep_{name}"]["rows"]
        with torch.no_grad():
            want, _ = moe_lib.apply_moe_local(p, x[lo:hi], cfg)
        np.testing.assert_allclose(_np(r[f"ep_{name}"]["out"]), _np(want), atol=EP_TOL, rtol=0)


LAUNCHER_MESHES = ("1,2", "2,2")


@pytest.fixture(scope="module")
def launcher_runs(tmp_path_factory):
    """``launch/train.py`` on one process and at each of ``LAUNCHER_MESHES``
    (gloo worlds of 2 and 4 launchers with ``--coordinator``), all at once:
    {mesh or "one": [each process's stdout]}."""
    tmp = tmp_path_factory.mktemp("launcher")
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "llama3-8b", "--smoke",
            "--device", "cpu", "--steps", "3", "--tau", "2", "--rank", "8", "--engine",
            "bucketed", "--svd-backend", "randomized", "--no-recovery", "--ckpt-every", "0"]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    runs = {"one": [base + ["--ckpt-dir", str(tmp / "one")]]}
    for mesh in LAUNCHER_MESHES:
        n = int(np.prod([int(x) for x in mesh.split(",")]))
        runs[mesh] = [base + ["--ckpt-dir", str(tmp / mesh), "--mesh", mesh, "--coordinator",
                              f"file://{tmp / ('store' + mesh)}", "--num-processes", str(n),
                              "--process-id", str(i)] for i in range(n)]
    procs = {k: [subprocess.Popen(r, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                  env=env) for r in rs] for k, rs in runs.items()}
    out = {}
    for k, ps in procs.items():
        outs = [p.communicate(timeout=300) for p in ps]
        assert all(p.returncode == 0 for p in ps), (k, [e[-3000:] for _, e in outs])
        out[k] = [o for o, _ in outs]
    return out


@pytest.mark.parametrize("mesh", LAUNCHER_MESHES)
def test_launcher_runs_a_tp_world(launcher_runs, mesh):
    """``launch/train.py --mesh D,M --device cpu`` (tensor parallel over 2,
    data parallel over D) prints the one-process launcher's losses over 3
    steps, on every process."""
    done = [ln for ln in launcher_runs["one"][0].splitlines() if "done:" in ln]
    assert done and "step 3" in done[0]
    for out in launcher_runs[mesh]:
        assert f"{len(launcher_runs[mesh])} process(es)" in out
        assert [ln for ln in out.splitlines() if "done:" in ln] == done


@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b", "whisper-medium",
                                  "llava-next-34b"])
def test_other_families_raise_naming_what_is_left(arch):
    """ssm, hybrid, enc-dec and VLM build a tensor-parallel step with a
    ``model`` extent above 1 (the optimizer of this process's blocks, some
    leaf split over ``model``) and take ZeRO state on the FSDP step at a
    ``data`` extent of 2; what is left there, a ``state_shards`` other than
    the ``data`` extent, raises naming it."""
    cfg = get_config(arch, smoke=True).with_(dtype=torch.float32)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    opt = make_optimizer("galore-sara-adam", params, rank=8, engine="bucketed")
    fns = make_train_step(model, opt, mesh=mesh_lib.Mesh(("data", "model"), (1, 2)))
    assert fns["tp"] and fns["optimizer"] is not opt
    assert any(m is not None for _, m in fns["splits"])
    zopt = make_optimizer("galore-sara-adam", params, rank=8, engine="bucketed",
                          state_sharding="zero", state_shards=2)
    zfns = make_train_step(model, zopt, mesh=mesh_lib.Mesh(("data", "model"), (2, 1)))
    assert zfns["optimizer"].state_layout.shards == 2
    with pytest.raises(ValueError, match="state_shards must be the data extent 4"):
        make_train_step(model, zopt, mesh=mesh_lib.Mesh(("data", "model"), (4, 1)))


def test_mesh_model_axis_and_blocks():
    """The model axis of a mesh, a leaf's blocks and their gathering
    inverse on one process (the model axis of a one-process mesh is the
    identity)."""
    m = mesh_lib.Mesh(("data", "model"), (2, 4), rank=6)
    assert m.coords == {"data": 1, "model": 2} and m.tp == 4
    ax = m.model_axes()
    assert (ax.names, ax.size, ax.index) == (("model",), 4, 2)
    assert mesh_lib.single_device_mesh().model_axes().size == 1
    x = torch.arange(24.0).reshape(2, 12)
    assert torch.equal(shd.local_block(x, 1, 2, 4), x[:, 6:9])
    assert shd.model_dim(("data", "model"), 3) == 2 and shd.model_dim((), 2) is None
