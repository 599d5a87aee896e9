"""The port's MSGD, Adam-mini and 8-bit Adam against the JAX package's, on
the CPU, continued from tests/test_torch_inners.py (two files, so that the
CPU time splits between test workers): one refresh and one hot update per
inner on the reference engine with JAX's draws, a 3-step ``train_loop``
for Adam-mini and 8-bit Adam, and the launcher."""
import jax
import numpy as np
import pytest

from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core import make_optimizer as jax_make_optimizer
from repro.core import schedules as jax_schedules
from repro.train.loop import train_loop as jax_train_loop
from repro.train.state import TrainState as JaxTrainState
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs.base import TrainConfig
from repro_torch.core import make_optimizer, schedules
from repro_torch.core.lowrank import flatten_with_path
from repro_torch.kernels import counters
from repro_torch.train.loop import train_loop
from repro_torch.train.state import TrainState
from repro_torch.train.step import make_train_step
from test_torch_inners import NAMES, _numpy, check_refresh_then_hot
from test_torch_optim_kernels import JaxDraws
from test_torch_train import (  # noqa: F401  (pair is a fixture)
    OPT_KW,
    REFRESH_TOL,
    _assert_params_close,
    _np,
    _SharedData,
    pair,
)


@pytest.mark.parametrize("inner_name", list(NAMES))
def test_refresh_then_hot_update_match_jax_on_reference_engine(pair, inner_name):
    check_refresh_then_hot(pair, inner_name, "reference")


# ---------------------------------------------------------------------------
# train loop and launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("inner_name", ["adam_mini", "adam8bit"])
def test_three_step_train_loop_matches_jax(pair, inner_name, tmp_path):
    """Refresh at step 0, then two hot steps, on shared batches with the
    launcher's schedule: losses to 1e-5; final params to REFRESH_TOL for
    Adam-mini.  For 8-bit Adam the moments after the refresh carry the
    projectors' LAPACK differences (~2e-5, ROADMAP queue 3), requantizing
    them moves a code by one step here and there, and on a small second
    moment one v code moves its element's direction a long way: measured,
    36 of 16384 elements of down_proj and 1 of embed beyond REFRESH_TOL,
    at most 3.1e-4.  So there at most 0.5% of a leaf's elements may leave
    REFRESH_TOL, and none by more than a quarter of the low-rank step
    lr * alpha = 2.5e-3."""
    steps = 3
    name = NAMES[inner_name]
    kw = dict(OPT_KW, engine="bucketed", svd_backend="randomized", tau=200)
    jopt = jax_make_optimizer(name, pair["jparams"],
                              lr_schedule=jax_schedules.cosine_with_warmup(0.01, 1, steps), **kw)
    topt = make_optimizer(name, pair["tparams"],
                          lr_schedule=schedules.cosine_with_warmup(0.01, 1, steps), **kw)
    jstate = JaxTrainState(pair["jparams"], jopt.init(pair["jparams"]))
    jtc = JaxTrainConfig(total_steps=steps, checkpoint_every=0,
                         checkpoint_dir=str(tmp_path / "ckpt"))
    jfns = jax_make_train_step(pair["jmodel"], jopt, train_cfg=jtc, donate=False)

    class _JaxData:
        def batch_at(self, step):
            return pair["batches"][step]

    jres = jax_train_loop(pair["jmodel"], jopt, _JaxData(), jtc, jfns, state=jstate,
                          log_every=1, handle_signals=False)
    tc = TrainConfig(total_steps=steps, checkpoint_dir=str(tmp_path / "port_ckpt"))
    tstate = TrainState(pair["tparams"], topt.init(pair["tparams"])._replace(
        draws=JaxDraws(jstate.opt_state.key)))
    tres = train_loop(pair["tmodel"], topt, _SharedData(pair["batches"]), tc,
                      make_train_step(pair["tmodel"], topt, train_cfg=tc),
                      state=tstate, log_every=1)
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-5)
    if inner_name == "adam_mini":
        _assert_params_close(jres.state.params, tres.state.params, **REFRESH_TOL)
        return
    ja = jax.tree_util.tree_flatten_with_path(_numpy(jres.state.params))[0]
    for (path, a), (_, b) in zip(ja, flatten_with_path(tres.state.params)):
        diff = np.abs(_np(b) - a)
        what = jax.tree_util.keystr(path)
        off = diff > REFRESH_TOL["atol"]
        print(f"{what}: {int(off.sum())} of {off.size} beyond REFRESH_TOL, max {diff.max():.3g}")
        assert off.mean() <= 5e-3, what
        assert diff.max() <= 0.25 * 0.01 * 0.25, what


def test_launch_train_takes_the_new_optimizers_on_cpu(capsys, tmp_path):
    from repro_torch.launch import train as launch_train

    counters.reset()
    launch_train.main(["--smoke", "--device", "cpu", "--optimizer", "galore-sara-adam8bit",
                       "--engine", "bucketed", "--svd-backend", "randomized", "--steps", "3",
                       "--tau", "2", "--rank", "8", "--seq", "16", "--batch", "4",
                       "--ckpt-dir", str(tmp_path / "ckpt")])
    assert "[train] done: step 3" in capsys.readouterr().out
    assert counters.snapshot() == {}  # the CPU runs the plain versions


