"""Resume across packages and inside the port, through both training loops,
on the CPU (``get_config("llama3-8b", smoke=True)`` in f32,
``galore-sara-adam``, rank 8, tau 2: refreshes at steps 0, 2 and 4).

* JAX -> port: JAX's ``train_loop`` checkpoints every step; the port's
  ``train_loop`` resumes from one of them and its next step meets JAX's
  uninterrupted run: ``HOT_LOOP_TOL`` (1e-6 but for a few elements of the
  full-rank leaves, below) for a hot step, ``REFRESH_TOL`` across a
  refresh, where the port is handed JAX's draws (``JaxDraws`` built from
  the key it read, ``TorchDraws.key``).
* port -> JAX: the port's loop checkpoints; JAX's ``train_loop``
  (``CheckpointManager.load_latest`` with ``checkpoint_converters``)
  resumes and its next step meets the port's from the same checkpoint,
  to the same bars.
* port -> port: a run stopped at step 3 and resumed replays the
  uninterrupted run bit for bit across the step-4 refresh, for every inner
  on both engines; a resume onto the other engine stays within the
  engines' own agreement (``test_torch_train.py::
  test_engines_agree_across_refreshes``: params to 1e-6).
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.configs.registry import get_config as jax_get_config
from repro.core import make_optimizer as jax_make_optimizer
from repro.data.synthetic import SyntheticDataConfig as JaxDataConfig
from repro.data.synthetic import SyntheticDataset as JaxDataset
from repro.models import build_model as jax_build_model
from repro.train.loop import train_loop as jax_train_loop
from repro.train.state import TrainState as JaxTrainState
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch import bridge
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import make_optimizer
from repro_torch.core.lowrank import TorchDraws, flatten_with_path
from repro_torch.core.schedules import cosine_with_warmup
from repro_torch.data.synthetic import SyntheticDataConfig, SyntheticDataset
from repro_torch.models import build_model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.loop import train_loop
from repro_torch.train.state import checkpoint_converters
from repro_torch.train.step import make_train_step
from test_torch_optim_kernels import JaxDraws
from test_torch_train import HOT_TOL, REFRESH_TOL, _SharedData

# One intra-op thread: the test workers share the host's cores, and the
# port's results do not depend on the thread count (core/svd.py).
torch.set_num_threads(1)

# "reproject": the refresh turns the kept first moment into the new basis,
# which makes the step blind to the projectors' column signs; under "keep"
# a refresh after the first pairs JAX's moments with the port's columns,
# whose signs LAPACK may choose otherwise (ROADMAP queue 3).
JAX_KW = dict(rank=8, lr=0.01, grad_clip_norm=1.0, tau=2, engine="bucketed",
              svd_backend="randomized", momentum_carry="reproject")
# A hot step, each package computing its own gradients: they agree to
# GRAD_TOL (1e-6 abs, 1e-5 rel), but on an element whose gradient is tiny
# (~5e-9 in lm_head) the relative difference reaches percents, and Adam
# divides each element by its own sqrt(v), so that element's update
# differs by that share of a step (measured: 1 element of lm_head by
# 1.3e-6, 1 of embed by 2.5e-5; a step is lr = 1e-2).  So HOT_TOL on all
# but 1e-4 of each leaf's elements, and those within 1% of a step.
HOT_LOOP_TOL = dict(atol=HOT_TOL["atol"], share=1e-4, cap=1e-4)
STEPS = 4  # refresh 0, hot 1, refresh 2, hot 3
# after JAX's checkpoint of step k the port runs step k: a hot or a refresh step
RESUME_AT = {"hot": 1, "refresh": 2}


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's and the port's uninterrupted 4-step runs, each checkpointing
    after every step (the same params and batches)."""
    base = tmp_path_factory.mktemp("runs")
    jcfg = jax_get_config("llama3-8b", smoke=True).with_(dtype=jnp.float32)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    data = JaxDataset(JaxDataConfig(vocab_size=jcfg.vocab_size, seq_len=32, global_batch=4))
    batches = [data.batch_at(i) for i in range(STEPS)]
    jopt = jax_make_optimizer("galore-sara-adam", jparams, **JAX_KW)
    jtc = JaxTrainConfig(total_steps=STEPS, checkpoint_every=1, keep_checkpoints=10,
                         checkpoint_dir=str(base / "jax"), async_checkpoint=False)
    jfns = jax_make_train_step(jmodel, jopt, train_cfg=jtc, donate=False)

    class _JaxData:
        def batch_at(self, step):
            return batches[step]

    jres = jax_train_loop(jmodel, jopt, _JaxData(), jtc, jfns,
                          state=JaxTrainState(jparams, jopt.init(jparams)),
                          log_every=1, handle_signals=False)
    tcfg = get_config("llama3-8b", smoke=True).with_(dtype=torch.float32)
    tmodel = build_model(tcfg, device="cpu")
    tparams = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    topt = make_optimizer("galore-sara-adam", tparams, **JAX_KW)
    tres = _port_run(tmodel, topt, _SharedData(batches), str(base / "port"), STEPS,
                     checkpoint_every=1)
    return dict(base=base, jmodel=jmodel, jopt=jopt, jfns=jfns, jparams=jparams, jres=jres,
                batches=batches, _JaxData=_JaxData, tmodel=tmodel, topt=topt, tparams=tparams,
                tres=tres)


def _port_run(model, opt, data, ckpt_dir, total, checkpoint_every=0, fns=None):
    tc = TrainConfig(total_steps=total, checkpoint_every=checkpoint_every,
                     keep_checkpoints=10, checkpoint_dir=ckpt_dir, async_checkpoint=False)
    return train_loop(model, opt, data, tc, fns or make_train_step(model, opt, train_cfg=tc),
                      log_every=1, handle_signals=False)


def _with_jax_draws(fns):
    """The port's step functions with JAX's refresh draws: the refresh step
    takes ``JaxDraws`` on the key the state's ``TorchDraws`` reads as (the
    checkpoint's key, word for word), and hands back the ``TorchDraws`` of
    the key JAX's chain moved on to."""

    def refresh_step(state, batch, group=0):
        key = jnp.asarray(state.opt_state.draws.key())
        st = state._replace(opt_state=state.opt_state._replace(draws=JaxDraws(key)))
        new, m = fns["refresh_step"](st, batch, group=group)
        draws = TorchDraws.from_key(new.opt_state.draws.key(), "cpu")
        return new._replace(opt_state=new.opt_state._replace(draws=draws)), m

    return dict(fns, refresh_step=refresh_step)


def _copy_step(src_dir, step, dst_dir):
    os.makedirs(dst_dir)
    shutil.copytree(os.path.join(src_dir, f"step_{step:08d}"),
                    os.path.join(dst_dir, f"step_{step:08d}"))
    return dst_dir


def _ckpt_params(base, step, like, tmp_path):
    """The params of one checkpoint of ``base``."""
    return ckpt.load_params_latest(_copy_step(base, step, str(tmp_path / "params")), like)[0]


def _assert_close(got, want, **tol):
    got, want = dict(flatten_with_path(got)), dict(flatten_with_path(want))
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_allclose(_np(got[path]), _np(want[path]), err_msg=path, **tol)


def _assert_step_close(got, want, kind):
    """Params after one step of each package: ``HOT_LOOP_TOL`` for a hot
    step, ``REFRESH_TOL`` across a refresh."""
    if kind == "refresh":
        _assert_close(got, want, **REFRESH_TOL)
        return
    got, want = dict(flatten_with_path(got)), dict(flatten_with_path(want))
    assert sorted(got) == sorted(want)
    for path in want:
        err = np.abs(_np(got[path]) - _np(want[path]))
        off = float(np.mean(err > HOT_LOOP_TOL["atol"]))
        assert off <= HOT_LOOP_TOL["share"] and err.max() <= HOT_LOOP_TOL["cap"], \
            (path, off, float(err.max()))


@pytest.mark.parametrize("kind", list(RESUME_AT))
def test_jax_checkpoint_resumes_in_port_loop(runs, tmp_path, kind):
    k = RESUME_AT[kind]
    jdir = str(runs["base"] / "jax")
    work = _copy_step(jdir, k, str(tmp_path / "resume"))
    fns = make_train_step(runs["tmodel"], runs["topt"])
    res = _port_run(runs["tmodel"], runs["topt"], _SharedData(runs["batches"]), work, k + 1,
                    fns=_with_jax_draws(fns))
    assert res.checkpoints.last_load["step"] == k and res.final_step == k + 1
    np.testing.assert_allclose(res.losses, runs["jres"].losses[k:k + 1], rtol=1e-6)
    assert res.state.step == k + 1
    want = _ckpt_params(jdir, k + 1, runs["tparams"], tmp_path)  # JAX's state after step k
    _assert_step_close(res.state.params, want, kind)
    if kind == "refresh":  # the key moved on along JAX's chain
        jkey = np.load(os.path.join(jdir, f"step_{k + 1:08d}", "_opt_state_key.npy"))
        assert res.state.opt_state.draws.key().tolist() == jkey.tolist()


@pytest.mark.parametrize("kind", list(RESUME_AT))
def test_port_checkpoint_resumes_in_jax_loop(runs, tmp_path, kind):
    k = RESUME_AT[kind]
    tdir = str(runs["base"] / "port")
    jtc = JaxTrainConfig(total_steps=k + 1, checkpoint_every=0,
                         checkpoint_dir=_copy_step(tdir, k, str(tmp_path / "jax")))
    jopt, jparams = runs["jopt"], runs["jparams"]
    jres = jax_train_loop(runs["jmodel"], jopt, runs["_JaxData"](), jtc, runs["jfns"],
                          state=JaxTrainState(jparams, jopt.init(jparams)),
                          log_every=1, handle_signals=False)
    assert int(jres.state.opt_state.step) == k + 1 and len(jres.losses) == 1
    if kind == "hot":  # the port's own next step, from its uninterrupted run
        want = _ckpt_params(tdir, k + 1, runs["tparams"], tmp_path)
        np.testing.assert_allclose(jres.losses, runs["tres"].losses[k:k + 1], rtol=1e-6)
    else:  # the port's next step from the same checkpoint, on JAX's draws
        work = _copy_step(tdir, k, str(tmp_path / "port"))
        fns = _with_jax_draws(make_train_step(runs["tmodel"], runs["topt"]))
        tres = _port_run(runs["tmodel"], runs["topt"], _SharedData(runs["batches"]), work,
                         k + 1, fns=fns)
        want = tres.state.params
        np.testing.assert_allclose(jres.losses, tres.losses, rtol=1e-6)
    got = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jres.state.params), "cpu")
    _assert_step_close(got, want, kind)


# ---------------------------------------------------------------------------
# port -> port
# ---------------------------------------------------------------------------

PORT_STEPS, STOP_AT = 5, 3  # refreshes at 0, 2, 4: the resumed run refreshes
PORT_KW = dict(rank=8, grad_clip_norm=1.0, tau=2, svd_backend="randomized",
               lr_schedule=cosine_with_warmup(0.01, 1, PORT_STEPS))


@pytest.fixture(scope="module")
def port_model():
    cfg = get_config("llama3-8b", smoke=True).with_(dtype=torch.float32)
    model = build_model(cfg, device="cpu")
    data = SyntheticDataset(SyntheticDataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                                global_batch=2, dist="zipf"), device="cpu")
    return model, model.init(torch.Generator().manual_seed(0)), data


def _port_opt(params, inner, engine):
    return make_optimizer(f"galore-sara-{inner}", params, engine=engine, **PORT_KW)


def _stop_and_resume(port_model, tmp_path, inner, engine, resume_engine):
    model, params, data = port_model
    opt = _port_opt(params, inner, engine)
    full = _port_run(model, opt, data, str(tmp_path / "full"), PORT_STEPS)
    part = str(tmp_path / "part")
    first = _port_run(model, opt, data, part, STOP_AT, checkpoint_every=STOP_AT)
    rest = _port_run(model, _port_opt(params, inner, resume_engine), data, part, PORT_STEPS)
    assert ckpt.checkpoint_dirs(part) == [STOP_AT]
    assert rest.checkpoints.last_load["step"] == STOP_AT
    assert first.losses == full.losses[:STOP_AT]
    return opt, full, rest


def _canonical_items(opt, state):
    can, _ = checkpoint_converters(opt)
    return ckpt.tree_items(can(state) if can else state)


@pytest.mark.parametrize("engine", ["reference", "bucketed"])
@pytest.mark.parametrize("inner", ["adam", "msgd", "adam-mini", "adam8bit"])
def test_port_resume_is_bit_identical_across_a_refresh(port_model, tmp_path, inner, engine):
    opt, full, rest = _stop_and_resume(port_model, tmp_path, inner, engine, engine)
    assert rest.losses == full.losses[STOP_AT:]
    assert rest.final_step == PORT_STEPS and rest.state.opt_state.draws.refreshes == 3
    a, b = ckpt.tree_items(rest.state), ckpt.tree_items(full.state)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        assert np.array_equal(_np(x), _np(y)) and _np(x).dtype == _np(y).dtype, path


@pytest.mark.parametrize("engines", [("bucketed", "reference"), ("reference", "bucketed")])
def test_port_resume_onto_the_other_engine(port_model, tmp_path, engines):
    opt, full, rest = _stop_and_resume(port_model, tmp_path, "adam", *engines)
    np.testing.assert_allclose(rest.losses, full.losses[STOP_AT:], rtol=1e-6)
    _assert_close(rest.state.params, full.state.params, atol=1e-6, rtol=0)
    other = _port_opt(port_model[1], "adam", engines[1])
    a, b = _canonical_items(other, rest.state), _canonical_items(opt, full.state)
    assert [p for p, _ in a] == [p for p, _ in b]
