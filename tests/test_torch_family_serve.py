"""The port's continuous engines for the MoE, SSM and hybrid families
against the JAX package's static ``generate``, on the CPU at the smoke
configs in f32: deepseek-moe-16b through the paged engine (its routed
experts in the paged step), mamba2-370m and hymba-1.5b through the
slot-cache engine, with mid-flight arrivals, 2 slots for 4 requests and
prompts on both sides of hymba's window (16).  Greedy tokens must be
equal.  Also ``SlotCache``'s structural batch axes against JAX's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.serve import kv_cache as jax_kvc
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.models import build_model
from repro_torch.serve import kv_cache as kvc
from repro_torch.serve.engine import ContinuousEngine, ServeEngine

ARCHS = ["deepseek-moe-16b", "mamba2-370m", "hymba-1.5b"]
PROMPT_LENS = [6, 6, 20, 20]  # 20 > hymba's smoke window
NEW = [5, 3, 6, 4]
ARRIVALS = [0, 0, 1, 2]


def _pair(arch):
    jcfg = jax_get_config(arch, smoke=True).with_(dtype=jnp.float32)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    tmodel = build_model(get_config(arch, smoke=True).with_(dtype=torch.float32), device="cpu")
    tparams = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jmodel, jparams, tmodel, tparams


@pytest.mark.serve
@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_engine_matches_jax_static_generate(arch):
    jmodel, jparams, tmodel, tparams = _pair(arch)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, jmodel.cfg.vocab_size, (n,)).astype(np.int32)
               for n in PROMPT_LENS]
    cap = max(PROMPT_LENS) + max(NEW)
    # JAX's static engine: one batch per prompt length
    want = {}
    jeng = JaxServeEngine(jmodel, jparams, capacity=cap)
    for n in sorted(set(PROMPT_LENS)):
        idx = [i for i, m in enumerate(PROMPT_LENS) if m == n]
        out = jeng.generate({"tokens": jnp.asarray(np.stack([prompts[i] for i in idx]))},
                            max(NEW[i] for i in idx))
        for row, i in enumerate(idx):
            want[i] = np.asarray(out.tokens)[row, :NEW[i]]
    eng = ContinuousEngine(tmodel, tparams, max_slots=2, max_seq_len=cap, page_size=8)
    assert eng.paged == (arch == "deepseek-moe-16b")
    rids = [eng.submit(p, n, arrival=a) for p, n, a in zip(prompts, NEW, ARRIVALS)]
    res = eng.run()
    for i, rid in enumerate(rids):
        np.testing.assert_array_equal(res[rid].tokens, want[i], err_msg=f"request {i}")
    assert max(r.admit_tick - r.arrival for r in res.values()) > 0  # a request waited
    # the port's own static engine agrees too
    out = ServeEngine(tmodel, tparams, capacity=cap).generate(
        {"tokens": torch.from_numpy(np.stack(prompts[2:]))}, max(NEW[2:]))
    np.testing.assert_array_equal(out.tokens[0, :NEW[2]].numpy(), want[2])


@pytest.mark.serve
@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b"])
def test_slot_cache_batch_axes_match_jax(arch):
    jmodel, jparams, tmodel, tparams = _pair(arch)
    tok = np.arange(9, dtype=np.int32)[None] % jmodel.cfg.vocab_size
    _, jsub = jmodel.prefill(jparams, {"tokens": jnp.asarray(tok)}, 32)
    want = jax_kvc.batch_axes(jmodel.init_cache(3, 32), jsub)
    slots = kvc.SlotCache(tmodel, 3, 32)
    with torch.no_grad():
        _, tsub = tmodel.prefill(tparams, {"tokens": torch.from_numpy(tok)}, 32)
    assert kvc.batch_axes(slots.cache, tsub) == want
    # insert writes exactly the slot's rows; the others keep their init
    slots.insert(tsub, 1)
    fresh = kvc._leaves_with_path(tmodel.init_cache(3, 32))
    for (path, full), (_, sub), (_, init) in zip(kvc._leaves_with_path(slots.cache),
                                                 kvc._leaves_with_path(tsub), fresh):
        ax = want[path]
        torch.testing.assert_close(full.narrow(ax, 1, 1), sub.to(full.dtype), msg=path)
        for other in (0, 2):
            torch.testing.assert_close(full.narrow(ax, other, 1), init.narrow(ax, other, 1),
                                       msg=path)
