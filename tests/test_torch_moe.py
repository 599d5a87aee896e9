"""The port's MoE family (src/repro_torch/models/moe.py) against the JAX
package's, on the CPU at the smoke configs of deepseek-moe-16b (2 shared
experts) and olmoe-1b-7b (none), in f32 with JAX's weights carried across
through ``bridge.py``: the local dropless dispatch and its aux loss, the
total loss and every gradient (expert stacks and router included),
prefill and decode logits.  Each JAX function runs once per arch, shared
through module-scoped fixtures."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import moe as jax_moe
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.core.lowrank import flatten_with_path, tree_leaves, tree_unflatten
from repro_torch.models import build_model
from repro_torch.models import moe

# One intra-op thread: the test workers share the host's cores, and the
# port's results do not depend on the thread count (core/svd.py).
torch.set_num_threads(1)

ARCHS = ["deepseek-moe-16b", "olmoe-1b-7b"]
# f32, the same products summed in other orders (XLA vs ATen); the
# scatter-add sums each token's k routed rows in another order too.
TOL = dict(atol=2e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-6, rtol=1e-5)
B, S, EXTRA = 2, 12, 3


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    jcfg = jax_get_config(arch, smoke=True).with_(dtype=jnp.float32)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(get_config(arch, smoke=True).with_(dtype=torch.float32), device="cpu")
    tparams = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S + EXTRA)).astype(np.int32)
    batch = {"tokens": jnp.asarray(tokens[:, :S]), "labels": jnp.asarray(tokens[:, 1:S + 1])}
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
        jparams, batch)
    jl, jc = jmodel.prefill(jparams, {"tokens": batch["tokens"]}, S + EXTRA)
    jdec = []
    for i in range(EXTRA):
        jl_i, jc = jmodel.decode(jparams, jc, {"token": jnp.asarray(tokens[:, S + i:S + i + 1])})
        jdec.append(np.asarray(jl_i))
    return dict(arch=arch, jcfg=jcfg, jparams=jparams, tmodel=tmodel, tparams=tparams,
                tokens=tokens, jloss=float(jloss), jmet=jmet, jgrads=jgrads,
                jprefill=np.asarray(jl), jdecode=jdec)


def test_dispatch_and_aux_match_jax(pair):
    """``apply_moe_local`` on one layer's weights: the routed + shared
    output and the switch aux loss, against ``_apply_moe_local``."""
    cfg = pair["jcfg"]
    lp = jax.tree_util.tree_map(lambda x: x[0], pair["jparams"]["blocks"]["moe"])
    x = np.random.default_rng(5).standard_normal((3, 7, cfg.d_model)).astype(np.float32)
    jout, jaux = jax_moe._apply_moe_local(lp, jnp.asarray(x), cfg)
    tp = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, lp), "cpu")
    moe.HOST_SYNCS[0] = 0
    tout, taux = moe.apply_moe_local(tp, torch.from_numpy(x), pair["tmodel"].cfg)
    assert moe.HOST_SYNCS[0] == 1  # one host sync per layer call: the group sizes
    np.testing.assert_allclose(_np(tout), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    assert ("shared_mlp" in tp) == (cfg.n_shared_experts > 0)


def test_loss_and_every_grad_match_jax(pair):
    tp = pair["tparams"]
    leaves = [p.clone().requires_grad_(True) for p in tree_leaves(tp)]
    tok = torch.from_numpy(pair["tokens"])
    loss, met = pair["tmodel"].loss(tree_unflatten(tp, leaves),
                                    {"tokens": tok[:, :S], "labels": tok[:, 1:S + 1]})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), pair["jloss"], rtol=1e-6)
    for key in ("loss", "aux", "tokens"):
        np.testing.assert_allclose(float(met[key].detach()), float(pair["jmet"][key]), rtol=1e-6,
                                   err_msg=key)
    # the total carries the router aux loss: aux_weight * aux / n_layers
    cfg = pair["jcfg"]
    np.testing.assert_allclose(
        float(loss.detach()),
        float(met["loss"].detach()) + cfg.router_aux_weight * float(met["aux"]) / cfg.n_layers,
        rtol=1e-7)
    jflat = jax.tree_util.tree_flatten_with_path(pair["jgrads"])[0]
    tflat = flatten_with_path(tree_unflatten(tp, [p.grad for p in leaves]))
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == [p for p, _ in tflat]
    for (path, a), (_, b) in zip(jflat, tflat):
        np.testing.assert_allclose(_np(b), np.asarray(a), err_msg=path, **GRAD_TOL)
    # the 4-D expert stacks (L, E, d, ff) crossed the bridge whole
    assert tp["blocks"]["moe"]["experts"]["gate_proj"].shape == (
        cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff)


def test_prefill_and_decode_logits_match_jax(pair):
    tmodel, tp, tokens = pair["tmodel"], pair["tparams"], pair["tokens"]
    with torch.no_grad():
        tl, tc = tmodel.prefill(tp, {"tokens": torch.from_numpy(tokens[:, :S])}, S + EXTRA)
        np.testing.assert_allclose(_np(tl), pair["jprefill"], **TOL)
        for i in range(EXTRA):
            tl, tc = tmodel.decode(tp, tc, {"token": torch.from_numpy(tokens[:, S + i:S + i + 1])})
            np.testing.assert_allclose(_np(tl), pair["jdecode"][i], **TOL)


def test_expert_parallel_path_raises_naming_item_11(pair, monkeypatch):
    """Across processes the reference takes its expert-parallel path
    (moe.py:152-261), which the distributed slice ports: the port raises
    rather than run the local path on a shard of the tokens."""
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a, **k: 2)
    lp = {k: v[0] if not isinstance(v, dict) else {kk: vv[0] for kk, vv in v.items()}
          for k, v in pair["tparams"]["blocks"]["moe"].items()}
    with pytest.raises(NotImplementedError, match="item 11"):
        moe.apply_moe_mlp(lp, torch.zeros(1, 2, pair["jcfg"].d_model), pair["tmodel"].cfg)
