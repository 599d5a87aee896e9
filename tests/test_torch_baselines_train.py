"""The paper's baselines trained by the port's ``train_loop`` against the
JAX package's, on the CPU: 3 steps (the refresh at step 0, then two hot
steps) of ``get_config("llama3-8b", smoke=True)`` in f32 at rank 8, on
JAX's batches and params, with JAX's draws handed to the port
(``JaxDraws`` along the method's chain) and the launcher's schedule.

* ``golore-adam`` and ``grass-adam`` on both engines (bucket-native state
  on the bucketed one, the fused update's plain version on the CPU), here;
* ``online-pca-adam`` on both engines, and ``fira-sara-adam`` and
  ``galore-sara-adafactor``, which both packages run on the per-leaf loop
  with per-leaf state under ``engine="bucketed"``, in
  ``tests/test_torch_baselines_loop.py`` (two files, so that the CPU time
  splits between test workers).

Losses to 1e-5 (relative); final params to ``REFRESH_TOL`` where the
refresh runs an SVD or a QR, and to ``HOT_LOOP_TOL`` for grass, whose
selection is exact (the measured cause is written there).
"""
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
from repro_torch.train.loop import train_loop
from repro_torch.train.state import TrainState
from repro_torch.train.step import make_train_step
from test_torch_optim_kernels import JaxDraws
from test_torch_resume import _assert_step_close
from test_torch_train import (  # noqa: F401  (pair is a fixture)
    OPT_KW,
    REFRESH_TOL,
    _assert_params_close,
    _SharedData,
    _torch_tree,
    pair,
)

RUNS = [("golore-adam", "bucketed"), ("golore-adam", "reference"),
        ("grass-adam", "bucketed"), ("grass-adam", "reference")]


@pytest.mark.parametrize("name,engine", RUNS)
def test_three_step_train_loop_matches_jax(pair, name, engine, tmp_path):
    check_three_step_loop(pair, name, engine, tmp_path)


def check_three_step_loop(pair, name, engine, tmp_path):
    """JAX's and the port's 3-step loops from the same params, batches and
    draws: losses, history and final params."""
    steps = 3
    kw = dict(OPT_KW, engine=engine, svd_backend="randomized", tau=200)
    jopt = jax_make_optimizer(name, pair["jparams"],
                              lr_schedule=jax_schedules.cosine_with_warmup(0.01, 1, steps), **kw)
    topt = make_optimizer(name, pair["tparams"],
                          lr_schedule=schedules.cosine_with_warmup(0.01, 1, steps), **kw)
    per_leaf = name.startswith("fira") or name.endswith("adafactor")
    assert (topt.state_layout is None) == (per_leaf or engine == "reference")
    assert (jopt.state_layout is None) == (topt.state_layout is None)
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
        draws=JaxDraws(jstate.opt_state.key, method=topt.config.method)))
    tres = train_loop(pair["tmodel"], topt, _SharedData(pair["batches"]), tc,
                      make_train_step(pair["tmodel"], topt, train_cfg=tc),
                      state=tstate, log_every=1)
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-5)
    for tr, jr in zip(tres.history, jres.history):
        for key in ("loss", "grad_norm", "update_norm"):
            np.testing.assert_allclose(tr[key], jr[key], rtol=1e-4, err_msg=key)
    assert tres.state.step == int(jres.state.opt_state.step) == steps
    if name.startswith("grass"):
        # grass selects rows exactly (its one-hot projector is bit-equal to
        # JAX's, tests/test_torch_projectors.py), but each package takes the
        # gradients of its own params, which agree to GRAD_TOL, and Adam
        # divides every element by its own sqrt(v): on the full-rank embed
        # an element whose gradient is tiny moves by more than 1e-6 after the
        # hot steps (measured: 1 of 32768 elements, by 1.13e-6, on both
        # engines; every low-rank leaf within 1e-6).  So the bar is
        # HOT_LOOP_TOL's: 1e-6 on all but 1e-4 of a leaf's elements, those
        # within 1e-4 (1% of a step of lr = 1e-2).
        _assert_step_close(tres.state.params, _torch_tree(jres.state.params), "hot")
    else:
        _assert_params_close(jres.state.params, tres.state.params, **REFRESH_TOL)
