"""The port's dense model (src/repro_torch) against the JAX package's, on
the CPU: configs, the weight bridge, ``prefill`` logits and cache, and
``decode_step`` logits, on the smoke configs in f32 with the same weights
(JAX init, carried across through numpy)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch import bridge
from repro.configs.registry import list_archs as jax_list_archs
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.models import build_model
from repro_torch.models import transformer as tfm

# One intra-op thread: the test workers share the host's cores, and the
# port's results do not depend on the thread count (core/svd.py).
torch.set_num_threads(1)

DENSE = ["llama3-8b", "qwen2-1.5b", "granite-8b", "nemotron-4-15b"]
# the MoE, SSM, hybrid, VLM and enc-dec families' configs
FAMILIES = ["deepseek-moe-16b", "olmoe-1b-7b", "mamba2-370m", "hymba-1.5b",
            "llava-next-34b", "whisper-medium"]
# f32 on the CPU: the same products summed in other orders (XLA vs ATen).
TOL = dict(atol=2e-5, rtol=1e-5)


def _pair_models(arch, **overrides):
    """(jax model, port model, jax params, port params) on one smoke config
    in f32.  QKV biases are made non-zero so they are really exercised."""
    jcfg = jax_get_config(arch, smoke=True).with_(dtype=jnp.float32, **overrides)
    tcfg = get_config(arch, smoke=True).with_(dtype=torch.float32, **overrides)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    if jcfg.qkv_bias:
        rng = np.random.default_rng(7)
        for name in ("q_bias", "k_bias", "v_bias"):
            leaf = tree["blocks"][name]
            tree["blocks"][name] = (0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
        jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jmodel, build_model(tcfg, device="cpu"), jparams, bridge.params_from_numpy(tree, "cpu")


def _np(x):
    return np.asarray(x) if not isinstance(x, torch.Tensor) else x.detach().numpy()


@pytest.mark.parametrize("arch", DENSE + FAMILIES)
@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_jax_field_by_field(arch, smoke):
    jcfg, tcfg = jax_get_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
    for f in dataclasses.fields(tcfg):
        a, b = getattr(jcfg, f.name), getattr(tcfg, f.name)
        if f.name in ("dtype", "param_dtype"):
            assert jnp.dtype(a).name == str(b).split(".")[-1], f.name
        else:
            assert a == b, f.name
    assert tcfg.q_dim == jcfg.q_dim and tcfg.kv_dim == jcfg.kv_dim


def test_unported_archs_raise_clearly():
    """Every arch of the JAX registry is in the port's, in its order, and
    builds; only an unknown arch raises."""
    assert list_archs() == jax_list_archs() == [
        a for a in jax_list_archs() if a in DENSE + FAMILIES]
    assert sorted(list_archs()) == sorted(DENSE + FAMILIES)
    for arch in list_archs():
        assert build_model(get_config(arch, smoke=True), device="cpu").cfg.arch_id == arch
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("no-such-arch")


def test_bridge_round_trip_is_bit_exact():
    cfg = jax_get_config("qwen2-1.5b", smoke=True)
    tree = jax.tree_util.tree_map(np.asarray, jax_build_model(cfg).init(jax.random.PRNGKey(3)))
    params = bridge.params_from_numpy(tree, "cpu")
    back = bridge.params_to_numpy(params)
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b)
    # the scan-stacked block leaves keep their leading (L,) axis
    assert params["blocks"]["q_proj"].shape == (cfg.n_layers, cfg.d_model, cfg.q_dim)
    # bf16 leaves carry their bits across
    bf = {"w": np.asarray(jnp.asarray([1.0, -2.5, 3.140625], jnp.bfloat16))}
    t = bridge.params_from_numpy(bf, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(bf["w"], np.float32))


def test_port_init_has_the_jax_layout():
    cfg = get_config("nemotron-4-15b", smoke=True)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    jtree = jax_build_model(jax_get_config("nemotron-4-15b", smoke=True)).init(
        jax.random.PRNGKey(0))
    ja = jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(np.asarray, jtree))[0]
    tb = jax.tree_util.tree_flatten_with_path(bridge.params_to_numpy(params))[0]
    assert [(p, a.shape, a.dtype) for p, a in ja] == [(p, b.shape, b.dtype) for p, b in tb]
    # truncated-normal fan-in init, as dense_init
    w = params["blocks"]["mlp"]["up_proj"]
    assert float(w.abs().max()) <= 3.0 / cfg.d_model**0.5 + 1e-6


@pytest.mark.parametrize(
    "arch,overrides",
    [
        ("llama3-8b", {}),
        ("qwen2-1.5b", {}),  # QKV bias
        ("nemotron-4-15b", {}),  # squared-ReLU MLP
        ("llama3-8b", {"attn_impl": "pallas"}),  # the flash plain version
        ("granite-8b", {"attn_impl": "chunked"}),
    ],
)
def test_prefill_and_decode_match_jax(arch, overrides):
    jmodel, tmodel, jparams, tparams = _pair_models(arch, **overrides)
    rng = np.random.default_rng(11)
    b, s, extra = 2, 12, 3
    tokens = rng.integers(0, jmodel.cfg.vocab_size, (b, s + extra)).astype(np.int32)
    cap = s + extra + 1
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens[:, :s])}, cap)
    tl, tc = tmodel.prefill(tparams, {"tokens": torch.from_numpy(tokens[:, :s])}, cap)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(getattr(tc, name)), _np(getattr(jc, name)), **TOL)
    np.testing.assert_array_equal(_np(tc.pos), _np(jc.pos))
    np.testing.assert_array_equal(_np(tc.next_pos), _np(jc.next_pos))
    for i in range(extra):
        tok = tokens[:, s + i:s + i + 1]
        jl, jc = jmodel.decode(jparams, jc, {"token": jnp.asarray(tok)})
        tl, tc = tmodel.decode(tparams, tc, {"token": torch.from_numpy(tok)})
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    np.testing.assert_array_equal(_np(tc.pos), _np(jc.pos))


def test_serving_params_cast_once_and_keep_numerics():
    """The serving cast (bf16 projections, f32 norms and lm_head) gives the
    same logits as casting before every product, as JAX does."""
    cfg = get_config("qwen2-1.5b", smoke=True)  # bf16 activations
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(1))
    served = tfm.serving_params(params, cfg)
    blocks = served["blocks"]
    assert blocks["q_proj"].dtype == torch.bfloat16 and blocks["q_bias"].dtype == torch.bfloat16
    assert blocks["mlp"]["down_proj"].dtype == torch.bfloat16
    assert blocks["attn_norm"].dtype == torch.float32
    assert served["lm_head"].dtype == torch.float32 and served["embed"].dtype == torch.bfloat16
    tokens = torch.randint(0, cfg.vocab_size, (1, 9), generator=torch.Generator().manual_seed(2))
    a, _ = model.prefill(params, {"tokens": tokens})
    b, _ = model.prefill(served, {"tokens": tokens})
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    """With no card, every entry point raises unless device='cpu' is passed:
    the port never falls back to the CPU on its own."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve.engine import ContinuousEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("llama3-8b", smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfm.init_params(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bridge.params_from_numpy({"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.main(["--smoke"])
    model = build_model(cfg, device="cpu")  # asked for: runs
    eng = ContinuousEngine(model, model.init(torch.Generator()), max_seq_len=16)
    assert eng.kv.pages_k.device.type == "cpu"


def test_unported_family_raises():
    """Every family builds; an unknown family raises ValueError."""
    from repro_torch.models.model_zoo import FAMILIES as ALL_FAMILIES

    assert {get_config(a).family for a in list_archs()} == set(ALL_FAMILIES)
    cfg = get_config("llama3-8b", smoke=True).with_(family="no-such-family")
    with pytest.raises(ValueError, match="unknown family"):
        build_model(cfg, device="cpu")


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_init_has_the_jax_layout(arch):
    """The port's init of the MoE, SSM, hybrid, VLM and enc-dec smoke
    configs has JAX's paths, shapes and dtypes (4-D expert stacks, the
    nested ``mixer`` / ``ssm_mixer`` dicts, f32 router, ``a_log``,
    ``dt_bias``, ``d_skip``, ``patch_in_proj``, ``enc_blocks`` and the
    ``cross_*`` leaves), and its serving init casts only what
    ``serving_params`` casts, to the same bits."""
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    jtree = jax_build_model(jax_get_config(arch, smoke=True)).init(jax.random.PRNGKey(0))
    ja = jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(np.asarray, jtree))[0]
    tb = jax.tree_util.tree_flatten_with_path(bridge.params_to_numpy(params))[0]
    assert [(p, a.shape, a.dtype) for p, a in ja] == [(p, b.shape, b.dtype) for p, b in tb]
    served = model.init(torch.Generator().manual_seed(0), serving=True)
    want = tfm.serving_params(params, cfg)
    from repro_torch.core.lowrank import flatten_with_path

    for (path, a), (_, b) in zip(flatten_with_path(served), flatten_with_path(want)):
        assert a.dtype == b.dtype, path
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=path)


@pytest.mark.parametrize("arch", ["llava-next-34b", "whisper-medium", "deepseek-moe-16b",
                                  "mamba2-370m"])
def test_serving_init_never_holds_a_stacked_leaf_in_f32(arch):
    """Every tensor that any op makes during ``init(gen, serving=True)`` is
    recorded (a dispatch mode sees factories and in-place draws alike): no
    f32 tensor has the shape of a whole stacked leaf that serving stores in
    bf16; each such leaf is drawn one layer slice at a time.  The f32 init
    does make them whole, which shows that the check sees them."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.core.lowrank import flatten_with_path

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.f32_shapes = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor) and t.dtype == torch.float32:
                    self.f32_shapes.add(tuple(t.shape))
            return out

    cfg = get_config(arch, smoke=True)
    model = build_model(cfg, device="cpu")
    with Record() as served_rec:
        served = model.init(torch.Generator().manual_seed(0), serving=True)
    with Record() as f32_rec:
        model.init(torch.Generator().manual_seed(0))
    cast = [(path, tuple(leaf.shape)) for path, leaf in flatten_with_path(served)
            if leaf.dtype == torch.bfloat16 and leaf.dim() >= 3]
    assert cast, "no stacked leaf is cast for serving"
    for path, shape in cast:
        assert shape not in served_rec.f32_shapes, path
        assert shape[1:] in served_rec.f32_shapes, path  # drawn a slice at a time
        assert shape in f32_rec.f32_shapes, path
