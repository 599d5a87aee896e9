"""The port's single-process API left from the JAX package, against it on
the CPU: ``state_memory_bytes`` / ``optimizer_memory_report`` (the paper's
memory claim) for every optimizer name on both engines, ``count_params``
for every arch, and ``make_prefill_fn`` / ``make_decode_fn``.  The same
params on both sides (JAX init, carried across through numpy); JAX's state
is read off ``jax.eval_shape(opt.init, params)``, whose leaves have the
shapes and dtypes of the real init's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import list_archs as jax_list_archs
from repro.core import make_optimizer as jax_make_optimizer
from repro.core import optimizer_memory_report as jax_memory_report
from repro.core import state_memory_bytes as jax_state_bytes
from repro.models import build_model as jax_build_model
from repro.models import count_params as jax_count_params
from repro.train.step import make_decode_fn as jax_decode_fn
from repro.train.step import make_prefill_fn as jax_prefill_fn
from repro_torch import bridge
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.core import make_optimizer, optimizer_memory_report, state_memory_bytes
from repro_torch.core.lowrank import state_tensors
from repro_torch.models import build_model, count_params
from repro_torch.train.step import make_decode_fn, make_prefill_fn

# One intra-op thread: the test workers share the host's cores, and the
# port's results do not depend on the thread count (core/svd.py).
torch.set_num_threads(1)

# every composed name of make_optimizer: the full-rank inners and each
# projector family (with SARA's selection where the family takes it) over
# each inner
INNERS = ["adam", "msgd", "adafactor", "adam-mini", "adam8bit"]
PREFIXES = ["", "galore-", "galore-sara-", "golore-", "grass-", "online-pca-", "fira-",
            "fira-sara-", "identity-"]
NAMES = [p + i for p in PREFIXES for i in INNERS]
# f32 on the CPU: the same products summed in other orders (XLA vs ATen),
# test_torch_model.py's bar
TOL = dict(atol=2e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def smoke():
    cfg = jax_get_config("llama3-8b", smoke=True).with_(dtype=jnp.float32)
    jmodel = jax_build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jmodel, jparams, bridge.params_from_numpy(tree, "cpu")


@pytest.mark.parametrize("engine", ["reference", "bucketed"])
def test_state_memory_bytes_match_jax_for_every_optimizer(smoke, engine):
    """Byte for byte, every name at rank 8: leaves, placeholders and
    bucket stacks at their dtypes' itemsizes, plus the step and key (the
    port keeps them on the host); and every byte is a tensor's storage."""
    _, jparams, tparams = smoke
    for name in NAMES:
        kw = dict(engine=engine) if name in INNERS else dict(engine=engine, rank=8)
        jopt = jax_make_optimizer(name, jparams, **kw)
        topt = make_optimizer(name, tparams, **kw)
        jstate = jax.eval_shape(jopt.init, jparams)
        tstate = topt.init(tparams)
        assert (topt.state_layout is None) == (jopt.state_layout is None), name
        assert state_memory_bytes(tstate) == jax_state_bytes(jstate), name
        assert optimizer_memory_report(tparams, tstate) == jax_memory_report(jparams, jstate), name
        storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                    for t in state_tensors(tstate)}
        assert sum(storages.values()) + 12 == state_memory_bytes(tstate), name
    full = optimizer_memory_report(tparams, make_optimizer("adam", tparams).init(tparams))
    low = make_optimizer("galore-sara-adam", tparams, rank=4, engine=engine)
    assert full["state_to_param_ratio"] > 1.99
    assert optimizer_memory_report(tparams, low.init(tparams))["state_to_param_ratio"] < 1.6


@pytest.mark.parametrize("arch", jax_list_archs())
def test_count_params_matches_jax(arch):
    assert list_archs() == jax_list_archs()
    jcfg = jax_get_config(arch, smoke=True)
    shapes = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0))
    tmodel = build_model(get_config(arch, smoke=True), device="cpu")
    assert count_params(tmodel.init(torch.Generator().manual_seed(0))) == \
        jax_count_params(shapes)


def test_prefill_and_decode_fns_match_jax(smoke):
    """The smoke llama's prefill and two decode steps through the step
    makers, on the same tokens."""
    jmodel, jparams, tparams = smoke
    tmodel = build_model(get_config("llama3-8b", smoke=True).with_(dtype=torch.float32),
                         device="cpu")
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, jmodel.cfg.vocab_size, (2, 14)).astype(np.int32)
    jprefill, jdecode = jax_prefill_fn(jmodel), jax_decode_fn(jmodel)
    tprefill, tdecode = make_prefill_fn(tmodel), make_decode_fn(tmodel)
    jl, jc = jprefill(jparams, {"tokens": jnp.asarray(tokens[:, :12])})
    tl, tc = tprefill(tparams, {"tokens": torch.from_numpy(tokens[:, :12])})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for i in (12, 13):
        tok = tokens[:, i:i + 1]
        jl, jc = jdecode(jparams, jc, {"token": jnp.asarray(tok)})
        tl, tc = tdecode(tparams, tc, {"token": torch.from_numpy(tok)})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
