"""ZeRO state on the port's FSDP step (``state_sharding="zero"`` at a
``data`` extent above 1: ``core/buckets.StateLayout.zero_rows``, the
split schedule of ``bucketed_update``, ``train/step.py``'s placing and
gathering) and the loop's rank schedule, spectrum logger and
``track_subspace`` under tensor parallelism (``train/loop.py``), in
spawned gloo worlds on the CPU (``tp_worlds.py``, which imports no JAX),
on ``tp_worlds``' inners model (d 128, d_ff 384, 1 layer, f32).

ZeRO runs ``galore-sara-adam``, ``-adam8bit`` and ``-adam-mini`` in the
(2, 1) and (2, 2) worlds beside the same optimizers with replicated state
in the same world; the (2, 1) world also runs the loop with ZeRO state and
writes its checkpoint; the (1, 2) world runs the loop under
``tp_worlds.LOOP_KW`` (rank 16 -> 8 at the step-2 refresh, tau 2, 6
steps).

Bars:
  * ``ZERO_TOL`` (1e-6 abs, the bar of ``test_torch_distributed.py``'s
    ZeRO against replicated) for ZeRO against replicated state in one
    world: the params after each step and after the hot and the refresh
    step from the single-process state; ZeRO holds fewer state bytes;
  * ``HOT_LOOP_TOL`` (1e-6) for ZeRO's hot step from the single-process
    state against the single-process step on the world's gradients;
  * the checkpoint: one process resumes it to step 3 within
    ``HOT_LOOP_TOL`` of the world's own step 3, and JAX loads its params
    bit for bit;
  * the loop: the rank trajectory and the events equal, the losses within
    ``LOSS_TOL``, the spectrum and overlap records within ``RECORD_RTOL``
    (1e-5 relative: the world's sums in other orders) of one process's,
    every process's records equal.
"""
import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core import make_optimizer
from repro_torch.core.lowrank import canonical_opt_state, tree_leaves, tree_unflatten
from repro_torch.train.loop import train_loop
from repro_torch.train.state import TrainState
from repro_torch.train.step import make_train_step

import tp_worlds as W

# One intra-op thread: the test workers share the host's cores, and the
# port's results do not depend on the thread count (core/svd.py).
torch.set_num_threads(1)

ZERO_TOL = 1e-6
HOT_LOOP_TOL = 1e-6
LOSS_TOL = 1e-5
RECORD_RTOL = 1e-5
CODE_STEP = 1
WORLD_TIMEOUT_S = 240
ZERO_RUNS = ["adam", "adam8bit", "adam_mini"]
ZERO_WORLDS = {"w21": (2, 1), "w22": (2, 2)}


def _max_err(got, want):
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


def _ref_states(ref_dir):
    """Each ZeRO run's single-process state after step 1 on disk
    (``inner_<run>_1.pt``), which the worlds' isolated steps start from."""
    model, params, data = W.inners_setup()
    out = {}
    for run in ZERO_RUNS:
        opt = W.inner_optimizer(params, run)
        fns = make_train_step(model, opt)
        state = TrainState(W.copy(params), opt.init(params))
        for s in range(2):
            state, _ = (fns["refresh_step"] if s == 0 else fns["step"])(state, data.batch_at(s))
        torch.save({"params": state.params, "opt_state": state.opt_state},
                   os.path.join(ref_dir, f"inner_{run}_1.pt"))
        out[run] = {"opt": opt, "state1": state}
    return out


def _one_process_loop(tmp):
    """The scheduled loop on one process (the (1, 2) world's reference)."""
    model, params, data = W.inners_setup()
    opt = make_optimizer("galore-sara-adam", params, **dict(W.OPT_KW, **W.LOOP_KW))
    tc = TrainConfig(total_steps=W.LOOP_STEPS, checkpoint_every=0,
                     checkpoint_dir=str(tmp / "one_loop"), async_checkpoint=False,
                     log_spectrum=True)
    res = train_loop(model, opt, data, tc, make_train_step(model, opt), log_every=1,
                     handle_signals=False, track_subspace=True)
    return {"losses": res.losses, "events": [r for r in res.history if "event" in r],
            "subspace": res.subspace.summary(), "rank": res.optimizer.config.rank}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero")
    ref_dir = tmp / "ref"
    ref_dir.mkdir()
    refs = _ref_states(str(ref_dir))
    cases = {"z": dict(kind="inners", runs=ZERO_RUNS, zero=True),
             "r": dict(kind="inners", runs=ZERO_RUNS)}
    w21 = W.spawn(tmp, str(ref_dir), {"mesh": ZERO_WORLDS["w21"], "cases": dict(
        cases, ck=dict(kind="inners_loop", zero=True, write=str(tmp / "zero_ck")))},
        WORLD_TIMEOUT_S)
    w12 = W.spawn(tmp, str(ref_dir), {"mesh": (1, 2), "cases": {
        "loop": dict(kind="inners_loop", schedule=True, write=str(tmp / "loop_ck"))}},
        WORLD_TIMEOUT_S)
    w22 = W.spawn(tmp, str(ref_dir), {"mesh": ZERO_WORLDS["w22"], "cases": cases},
                  WORLD_TIMEOUT_S)
    one_loop = _one_process_loop(tmp)
    runs = {"w21": w21(), "w12": w12(), "w22": w22()}
    return dict(refs=refs, runs=runs, one_loop=one_loop, ref_dir=str(ref_dir),
                zero_ck=str(tmp / "zero_ck"))


@pytest.mark.parametrize("world,run", [(w, r) for w in ZERO_WORLDS for r in ZERO_RUNS])
def test_zero_fsdp_step_matches_the_replicated_one(worlds, world, run):
    """ZeRO against replicated state in one world (ZERO_TOL): the params
    after each step, the hot and the refresh step from the single-process
    state; fewer state bytes a process; the processes' params bit-equal;
    the hot step against the single-process step on the world's
    gradients (HOT_LOOP_TOL), 8-bit codes within one step."""
    ranks = worlds["runs"][world]
    z, r = ranks[0]["z"][run], ranks[0]["r"][run]
    assert z["fsdp"] and r["fsdp"]
    assert z["state_bytes"] < r["state_bytes"], (z["state_bytes"], r["state_bytes"])
    for s in range(W.STEPS):
        assert _max_err(z["params"][s], r["params"][s]) <= ZERO_TOL, s
        for other in ranks[1:]:
            assert all(torch.equal(a, b) for a, b in zip(other["z"][run]["params"][s],
                                                         z["params"][s]))
    for kind in ("hot", "refresh"):
        assert _max_err(z[kind], r[kind]) <= ZERO_TOL, kind
    ref = worlds["refs"][run]
    opt, st1 = ref["opt"], ref["state1"]
    hot, hs, _ = opt.update(tree_unflatten(st1.params, z["grads"]), st1.opt_state, st1.params,
                            refresh=False, apply=True)
    assert _max_err(z["hot"], tree_leaves(hot)) <= HOT_LOOP_TOL
    if run == "adam8bit":
        want = canonical_opt_state(opt, hs)
        for a, b in zip(z["hot_state"].leaves, want.leaves):
            if hasattr(a.inner, "m_codes"):
                for x, y in ((a.inner.m_codes, b.inner.m_codes),
                             (a.inner.v_codes, b.inner.v_codes)):
                    assert int((x.int() - y.int()).abs().max()) <= CODE_STEP


def test_zero_fsdp_checkpoint_resumes_on_one_process_and_in_jax(worlds):
    """The (2, 1) ZeRO world's loop wrote JAX's canonical per-leaf
    checkpoint at step 2 from the gathered state: one process resumes it
    to step 3 (HOT_LOOP_TOL of the world's own step 3), and JAX loads the
    same params bit for bit and the step."""
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

    written = worlds["runs"]["w21"][0]["ck"]
    assert written["fsdp"]
    model, params, data = W.inners_setup()
    opt = make_optimizer("galore-sara-adam", params, **W.OPT_KW)
    ck = os.path.join(worlds["ref_dir"], "resume_on_one")
    shutil.copytree(worlds["zero_ck"], ck)
    tc = TrainConfig(total_steps=W.STEPS, checkpoint_every=0, checkpoint_dir=ck,
                     async_checkpoint=False)
    res = train_loop(model, opt, data, tc, make_train_step(model, opt), log_every=1,
                     handle_signals=False)
    assert len(res.losses) == 1
    assert _max_err(tree_leaves(res.state.params), written["params"]) <= HOT_LOOP_TOL
    canon, loc = state_lib.checkpoint_converters(opt)
    saved = ckpt_lib.CheckpointManager(worlds["zero_ck"], canonicalize=canon,
                                       localize=loc).load(TrainState(params, opt.init(params)),
                                                          step=2)
    jcfg = jax_get_config("llama3-8b", smoke=True).with_(dtype=jnp.float32, **W.INNERS_MODEL)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    jopt = jax_make_optimizer("galore-sara-adam", jparams, **W.OPT_KW)
    jcan, jloc = jax_converters(jopt)
    jstate = jax_ckpt.CheckpointManager(worlds["zero_ck"], canonicalize=jcan,
                                        localize=jloc).load(
        JaxTrainState(jparams, jopt.init(jparams)), step=2)
    for a, b in zip(jax.tree_util.tree_leaves(jstate.params), tree_leaves(saved.params)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert int(jstate.opt_state.step) == 2


def _records_close(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _records_close(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _records_close(a, b)
    elif isinstance(want, float):
        assert abs(got - want) <= RECORD_RTOL * max(abs(want), 1e-6), (got, want)
    else:
        assert got == want


def test_loop_under_tp_matches_one_process(worlds):
    """The (1, 2) world's loop under a rank schedule with the spectrum
    logger and ``track_subspace``: the rank trajectory (one re-bucket, 16
    -> 8 at step 2), the losses, the spectrum and re-bucket records and the
    tracker's summary equal one process's, on every process alike; a loop
    built at rank 16 resumes the step-4 checkpoint at rank 8 (the
    rank-aware restore on a mesh) to the uninterrupted run's params."""
    one = worlds["one_loop"]
    ranks = [r["loop"] for r in worlds["runs"]["w12"]]
    assert one["rank"] == 8
    assert [e["event"] for e in one["events"]].count("rebucket") == 1
    for got in ranks:
        assert got["rank"] == one["rank"]
        assert max(abs(a - b) for a, b in zip(got["losses"], one["losses"])) <= LOSS_TOL
        _records_close(got["events"], one["events"])
        _records_close(got["subspace"], one["subspace"])
    assert ranks[1]["events"] == ranks[0]["events"]
    assert ranks[1]["subspace"] == ranks[0]["subspace"]
    for got in ranks:
        assert got["resumed_rank"] == 8
        assert _max_err(got["resumed"], got["params"]) <= HOT_LOOP_TOL
