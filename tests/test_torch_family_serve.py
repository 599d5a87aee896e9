"""The port's continuous engines for the MoE, SSM, hybrid, VLM and enc-dec
families against the JAX package's static ``generate``, on the CPU at the
smoke configs in f32: deepseek-moe-16b (its routed experts in the paged
step) and llava-next-34b (each request's 8 patches ahead of its prompt in
the pages) through the paged engine, mamba2-370m, hymba-1.5b and
whisper-medium (each request's own frames, its cross K/V in the slot
cache) through the slot-cache engine, with mid-flight arrivals, 2 slots
for 4 requests and prompts on both sides of hymba's window (16).  Greedy
tokens must be equal.  Also ``SlotCache``'s structural batch axes against
JAX's."""
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

# One intra-op thread: the test workers share the host's cores, and the
# port's results do not depend on the thread count (core/svd.py).
torch.set_num_threads(1)

ARCHS = ["deepseek-moe-16b", "mamba2-370m", "hymba-1.5b", "llava-next-34b", "whisper-medium"]
PAGED = ("deepseek-moe-16b", "llava-next-34b")
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


def _extras(cfg, rng):
    """One request's prefix without the batch axis (none for the families
    that have none)."""
    if cfg.family == "vlm":
        return {"patch_embeds": rng.standard_normal((cfg.n_patches, cfg.d_model)).astype(
            np.float32)}
    if cfg.family == "audio":
        return {"frame_embeds": rng.standard_normal((cfg.enc_frames, cfg.d_model)).astype(
            np.float32)}
    return {}


@pytest.mark.serve
@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_engine_matches_jax_static_generate(arch):
    jmodel, jparams, tmodel, tparams = _pair(arch)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, jmodel.cfg.vocab_size, (n,)).astype(np.int32)
               for n in PROMPT_LENS]
    extras = [_extras(jmodel.cfg, rng) for _ in PROMPT_LENS]
    prefix = jmodel.cfg.n_patches if jmodel.cfg.family == "vlm" else 0
    cap = prefix + max(PROMPT_LENS) + max(NEW)

    def group(idx, to):
        batch = {"tokens": to(np.stack([prompts[i] for i in idx]))}
        for k in extras[0]:
            batch[k] = to(np.stack([extras[i][k] for i in idx]))
        return batch

    # JAX's static engine: one batch per prompt length
    want = {}
    jeng = JaxServeEngine(jmodel, jparams, capacity=cap)
    for n in sorted(set(PROMPT_LENS)):
        idx = [i for i, m in enumerate(PROMPT_LENS) if m == n]
        out = jeng.generate(group(idx, jnp.asarray), max(NEW[i] for i in idx))
        for row, i in enumerate(idx):
            want[i] = np.asarray(out.tokens)[row, :NEW[i]]
    eng = ContinuousEngine(tmodel, tparams, max_slots=2, max_seq_len=cap, page_size=8)
    assert eng.paged == (arch in PAGED)
    rids = [eng.submit(p, n, arrival=a, extras=e or None)
            for p, n, a, e in zip(prompts, NEW, ARRIVALS, extras)]
    res = eng.run()
    for i, rid in enumerate(rids):
        np.testing.assert_array_equal(res[rid].tokens, want[i], err_msg=f"request {i}")
    assert max(r.admit_tick - r.arrival for r in res.values()) > 0  # a request waited
    # the port's own static engine agrees too
    out = ServeEngine(tmodel, tparams, capacity=cap).generate(group([2, 3], torch.from_numpy),
                                                              max(NEW[2:]))
    np.testing.assert_array_equal(out.tokens[0, :NEW[2]].numpy(), want[2])


@pytest.mark.serve
@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b", "whisper-medium"])
def test_slot_cache_batch_axes_match_jax(arch):
    """whisper's ``EncDecCache``: the batch axis is 1 for the rings and
    the cross K/V, 0 for ``pos`` and ``next_pos``."""
    jmodel, jparams, tmodel, tparams = _pair(arch)
    tok = np.arange(9, dtype=np.int32)[None] % jmodel.cfg.vocab_size
    ex = {k: v[None] for k, v in _extras(jmodel.cfg, np.random.default_rng(2)).items()}
    _, jsub = jmodel.prefill(jparams, {"tokens": jnp.asarray(tok),
                                       **{k: jnp.asarray(v) for k, v in ex.items()}}, 32)
    want = jax_kvc.batch_axes(jmodel.init_cache(3, 32), jsub)
    slots = kvc.SlotCache(tmodel, 3, 32)
    with torch.no_grad():
        _, tsub = tmodel.prefill(tparams, {"tokens": torch.from_numpy(tok),
                                           **{k: torch.from_numpy(v) for k, v in ex.items()}},
                                 32)
    assert kvc.batch_axes(slots.cache, tsub) == want
    if arch == "whisper-medium":
        assert want == {".k": 1, ".v": 1, ".pos": 0, ".cross_k": 1, ".cross_v": 1,
                        ".next_pos": 0}
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
