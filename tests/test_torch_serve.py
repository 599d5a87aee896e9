"""The port's serving path (src/repro_torch/serve) against the JAX
package's, on the CPU at the smoke size in f32: the paged prompt writer
and decode step, continuous-batching tokens against the JAX engine and the
port's static engine, and the allocator, scheduler and engine contracts of
tests/test_train_and_serve.py.  Also: importing the port (and
chip_smoke.py) pulls in neither JAX nor the JAX package."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import transformer as jax_tfm
from repro.serve import paged_decode as jax_pgd
from repro.serve.engine import ContinuousEngine as JaxContinuousEngine
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.models import build_model
from repro_torch.models import transformer as tfm
from repro_torch.serve import paged_decode as pgd
from repro_torch.serve.engine import ContinuousEngine, ServeEngine
from repro_torch.serve.kv_cache import PageAllocator, pages_needed
from repro_torch.serve.scheduler import Request, Scheduler

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=2e-5, rtol=1e-5)  # f32, same math in other summation orders


def _models(arch="llama3-8b"):
    jcfg = jax_get_config(arch, smoke=True).with_(dtype=jnp.float32)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(get_config(arch, smoke=True).with_(dtype=torch.float32), device="cpu")
    tparams = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jmodel, jparams, tmodel, tparams


@pytest.fixture(scope="module")
def llama():
    return _models("llama3-8b")


def _prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32) for n in lens]


def _static_tokens(tmodel, tparams, prompt, n, capacity=64):
    out = ServeEngine(tmodel, tparams, capacity=capacity).generate(
        {"tokens": torch.from_numpy(prompt)[None]}, max_new_tokens=n
    )
    return out.tokens[0].numpy()


# ---------------------------------------------------------------------------
# paged pieces against JAX
# ---------------------------------------------------------------------------


@pytest.mark.serve
def test_write_prompt_matches_jax():
    rng = np.random.default_rng(0)
    nl, p, ps, kvh, d, s = 2, 6, 4, 2, 8, 10
    pk = rng.standard_normal((nl, p, ps, kvh, d)).astype(np.float32)
    pv = rng.standard_normal((nl, p, ps, kvh, d)).astype(np.float32)
    k_new = rng.standard_normal((nl, s, kvh, d)).astype(np.float32)
    v_new = rng.standard_normal((nl, s, kvh, d)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)
    row = np.array([4, 2, 5, -1], np.int32)
    jk, jv = jax_pgd.write_prompt(*(jnp.asarray(a) for a in (pk, pv, k_new, v_new, pos, row)))
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    out = pgd.write_prompt(tk, tv, *(torch.from_numpy(a) for a in (k_new, v_new, pos, row)))
    assert out[0] is tk and out[1] is tv  # written in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.serve
@pytest.mark.parametrize("arch", ["llama3-8b", "qwen2-1.5b"])
def test_paged_decode_step_matches_jax(arch):
    jmodel, jparams, tmodel, tparams = _models(arch)
    cfg = jmodel.cfg
    rng = np.random.default_rng(1)
    p, ps, mp = 8, 8, 3
    shape = (cfg.n_layers, p, ps, cfg.n_kv_heads, cfg.head_dim)
    pk = (0.5 * rng.standard_normal(shape)).astype(np.float32)
    pv = (0.5 * rng.standard_normal(shape)).astype(np.float32)
    # slot 0: 5 tokens in page 1; slot 1: 17 tokens over pages 2,3,4 (the
    # new token opens page 4); slot 2: inactive, empty
    table = np.array([[1, -1, -1], [2, 3, 4], [-1, -1, -1]], np.int32)
    lens = np.array([5, 16, 0], np.int32)
    active = np.array([True, True, False])
    toks = np.array([3, 7, 0], np.int32)
    jl, jk, jv = jax_pgd._paged_decode_step(
        jparams, *(jnp.asarray(a) for a in (pk, pv, table, lens, active, toks)),
        cfg=cfg, mlp_fn=jax_tfm.default_mlp_fn,
    )
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    step = pgd.make_paged_step(tmodel)
    tl, _, _ = step(
        tfm.serving_params(tparams, tmodel.cfg), tk, tv,
        *(torch.from_numpy(a) for a in (table, lens, active, toks)),
    )
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


# ---------------------------------------------------------------------------
# engines: tokens identical to the JAX engine and to static generation
# ---------------------------------------------------------------------------


def _copying_device_tables(self):
    return jnp.array(self.page_table, copy=True), jnp.array(self.seq_lens, copy=True)


@pytest.mark.serve
def test_continuous_engine_matches_jax_and_static_tokens(llama, monkeypatch):
    """Paged continuous batching with mid-flight arrivals, 2 slots for 4
    requests: the port's tokens equal the JAX engine's and the port's
    static greedy generate, request by request, and the pool drains.

    The JAX engine is pinned first: on the CPU backend its
    ``PagedKVCache.device_tables`` (``jnp.asarray``) may alias the host page
    table and seq_lens, which ``ContinuousEngine._decode_tick`` mutates
    (``seq_lens[act] += 1``) while the dispatched step may still read them,
    so its tokens can change from run to run.  The patch hands the step
    copies, as the port does."""
    from repro.serve.kv_cache import PagedKVCache as JaxPagedKVCache

    monkeypatch.setattr(JaxPagedKVCache, "device_tables", _copying_device_tables)
    jmodel, jparams, tmodel, tparams = llama
    prompts = _prompts(jmodel.cfg, [5 + 3 * i for i in range(4)], seed=5)
    new, arrivals = [6, 4, 7, 5], [0, 0, 1, 2]
    kw = dict(max_slots=2, max_seq_len=64, page_size=8)
    je = JaxContinuousEngine(jmodel, jparams, **kw)
    te = ContinuousEngine(tmodel, tparams, **kw)
    jr = [je.submit(p, n, arrival=a) for p, n, a in zip(prompts, new, arrivals)]
    tr = [te.submit(p, n, arrival=a) for p, n, a in zip(prompts, new, arrivals)]
    jres, tres = je.run(), te.run()
    for jid, tid, p, n in zip(jr, tr, prompts, new):
        np.testing.assert_array_equal(tres[tid].tokens, jres[jid].tokens)
        np.testing.assert_array_equal(tres[tid].tokens, _static_tokens(tmodel, tparams, p, n))
        assert tres[tid].token_ticks == jres[jid].token_ticks
    assert te.kv.allocator.used_pages == 0
    assert te.total_ticks == je.total_ticks and te.occupancy_trace == je.occupancy_trace
    assert max(te.occupancy_trace) > 0


@pytest.mark.serve
def test_continuous_engine_page_accounting(llama):
    """Admission reserves ceil((prompt+max_new)/ps) pages, retirement
    returns them, over-budget and degenerate requests are rejected."""
    _, _, tmodel, tparams = llama
    ce = ContinuousEngine(tmodel, tparams, max_slots=2, max_seq_len=32, page_size=8)
    with pytest.raises(ValueError, match="max_seq_len"):
        ce.submit(np.zeros((30,), np.int32), 10)  # 40 > 32 capacity
    with pytest.raises(ValueError, match="degenerate"):
        ce.submit(np.zeros((4,), np.int32), 0)
    with pytest.raises(ValueError, match="degenerate"):
        ce.submit(np.zeros((0,), np.int32), 4)
    rid = ce.submit(np.zeros((9,), np.int32), 4)  # 13 tokens -> 2 pages
    assert pages_needed(13, 8) == 2
    res = ce.run()
    assert ce.kv.allocator.used_pages == 0
    assert len(res[rid].tokens) == 4


@pytest.mark.serve
def test_continuous_engine_no_overadmission(llama):
    """6 free pages, two requests of 5 pages each: one admits, the other
    waits for the pool, and both still match static generation."""
    jmodel, _, tmodel, tparams = llama
    prompts = _prompts(jmodel.cfg, [14, 14], seed=11)
    ce = ContinuousEngine(tmodel, tparams, max_slots=2, max_seq_len=20,
                          page_size=4, num_pages=7)
    rids = [ce.submit(p, 4, arrival=0) for p in prompts]
    res = ce.run()
    first, second = res[rids[0]], res[rids[1]]
    assert second.admit_tick > first.admit_tick  # waited for the pool
    assert ce.kv.allocator.used_pages == 0
    for p, r in zip(prompts, (first, second)):
        np.testing.assert_array_equal(r.tokens, _static_tokens(tmodel, tparams, p, 4))
        assert r.token_ticks[0] == r.admit_tick
        assert (np.diff(r.token_ticks) >= 1).all()


@pytest.mark.serve
def test_serve_capacity_validation_raises(llama):
    jmodel, _, tmodel, tparams = llama
    batch = {"tokens": torch.from_numpy(_prompts(jmodel.cfg, [12], seed=2)[0])[None]}
    with pytest.raises(ValueError, match="capacity=20"):
        ServeEngine(tmodel, tparams, capacity=16).generate(batch, max_new_tokens=8)
    with pytest.raises(ValueError, match="capacity=13"):
        ServeEngine(tmodel, tparams).generate(batch, max_new_tokens=1)
    out = ServeEngine(tmodel, tparams, capacity=20).generate(batch, max_new_tokens=8)
    assert tuple(out.tokens.shape) == (1, 8)


@pytest.mark.serve
def test_serve_eos_early_exit(llama):
    jmodel, _, tmodel, tparams = llama
    row = torch.from_numpy(_prompts(jmodel.cfg, [10], seed=3)[0])
    batch = {"tokens": torch.stack([row, row])}
    eng = ServeEngine(tmodel, tparams, capacity=64)
    base = eng.generate(batch, max_new_tokens=8).tokens.numpy()
    eos = int(base[0, 2])  # both rows identical -> both finish at step 2
    out = eng.generate(batch, max_new_tokens=8, eos_id=eos)
    got = out.tokens.numpy()
    assert got.shape == (2, 8)
    np.testing.assert_array_equal(got[:, :3], base[:, :3])
    assert (got[:, 3:] == eos).all()
    assert out.steps < 8


# ---------------------------------------------------------------------------
# scheduler and allocator (host state, mirrored from the JAX tests)
# ---------------------------------------------------------------------------


@pytest.mark.serve
def test_scheduler_fcfs_head_of_line():
    sched = Scheduler(max_slots=2)
    for rid in range(3):
        sched.submit(Request(rid=rid, tokens=np.zeros(4, np.int32), max_new_tokens=2))
    assert sched.try_admit(0, lambda r, s: r.rid != 0) == []
    admitted = sched.try_admit(0, lambda r, s: True)
    assert [st.req.rid for st in admitted] == [0, 1]
    sched.retire(admitted[0].slot, 5, "eos")
    assert [st.req.rid for st in sched.try_admit(5, lambda r, s: True)] == [2]


@pytest.mark.serve
def test_scheduler_reserve_inside_admission_loop():
    sched = Scheduler(max_slots=2)
    for rid in range(2):
        sched.submit(Request(rid=rid, tokens=np.zeros(4, np.int32), max_new_tokens=2))
    budget = {"free": 6}

    def reserve(req, slot):
        if budget["free"] < 5:
            return False
        budget["free"] -= 5
        return True

    assert [st.req.rid for st in sched.try_admit(0, reserve)] == [0]
    assert budget["free"] == 1


@pytest.mark.serve
def test_page_allocator_reuse_and_double_free():
    alloc = PageAllocator(num_pages=5)
    a = alloc.alloc(3)
    assert alloc.alloc(2) is None
    alloc.free(a)
    assert alloc.free_pages == 4
    assert alloc.alloc(0) == [] and alloc.free_pages == 4
    b = alloc.alloc(4)
    assert sorted(b) == [1, 2, 3, 4]
    alloc.free(b)
    with pytest.raises(ValueError, match="double free"):
        alloc.free([b[0]])


# ---------------------------------------------------------------------------
# import hygiene
# ---------------------------------------------------------------------------


def test_port_and_chip_smoke_import_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
