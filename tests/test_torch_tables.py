"""The port's benchmark harness (``src/repro_torch/benchmarks/common.py``)
against the JAX package's (``benchmarks/common.py``) on the CPU:
``train_once`` at the harness's own scale (d_model 96, 2 layers, seq 64,
batch 8, rank 8, tau 20, lr 2e-3), on JAX's init, JAX's batches and JAX's
refresh draws, for the three optimizers that state the paper's claim:
full Adam, GaLore and GaLore-SARA.  60 steps (as tests/test_system.py's
gap test; 150, the tables' own count, would take the file past its share
of the suite's time), so three refreshes: 0, 20 and 40.  The low-rank
rows carry their moments with ``momentum_carry="reproject"``: the
harness's default, "keep", pairs the kept moments with the new
projector's columns, whose signs torch's LAPACK and jaxlib's pick
differently, so from the second refresh on each package's "keep" run is
one draw of its LAPACK's sign choices (ROADMAP queue 3: on these inputs
the final losses part by 1.29e-3 for GaLore and 2.88e-3 for SARA under
"keep", by 8.1e-7 and 3.3e-7 under "reproject").  Then item 2's leftover
(ROADMAP): 20 steps of galore-sara-adam at tau 5 under "keep".

The bars, each with its mechanism:

* ``STEP0_TOL``: step 0 is the same forward on the same params and batch,
  summed in other orders (measured 9.5e-7: two f32 ulps of the loss).
* ``ADAM_TOL``: full Adam, every step: f32 sums in other orders, carried
  through 60 Adam steps (measured 2.4e-6).
* ``FIRST_TAU_TOL``: the low-rank rows up to their second refresh: the
  first refresh's LAPACK differences in the small singular vectors that
  SARA samples (``REFRESH_TOL``'s mechanism, tests/test_torch_train.py;
  measured 8.3e-5 for SARA, 2.4e-6 for GaLore).
* ``LOW_RANK_TOL``: the low-rank rows, every step under "reproject": the
  same LAPACK differences, carried through three refreshes (measured
  5.8e-4 for SARA, 2.4e-6 for GaLore).
* ``FINAL_TOL``: the final loss (the mean of the last 10) of every row
  and of the "keep" case.  It must stay under half the smallest gap
  between two rows' final losses in JAX's own run (7.04e-3, GaLore against
  SARA), so that both packages rank the optimizers alike: the test checks
  that too (measured 1.7e-7, 8.1e-7 and 3.3e-7 for the rows, 8.9e-4 for
  the "keep" case).
"""
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.benchmarks import common
from test_torch_optim_kernels import JaxDraws

sys.path.append(str(Path(__file__).resolve().parents[1]))
from benchmarks import common as jax_common  # noqa: E402  (the repo root's package)

# One intra-op thread: the test workers share the host's cores, and the
# port's results do not depend on the thread count (core/svd.py).
torch.set_num_threads(1)

STEPS, TAU = 60, 20
NAMES = ["adam", "galore-adam", "galore-sara-adam"]
STEP0_TOL = 1e-6
ADAM_TOL = 1e-5
FIRST_TAU_TOL = 2e-4
LOW_RANK_TOL = 1e-3
FINAL_TOL = 2e-3
# the low-rank rows' carry in the three-optimizer comparison (see above)
CARRY = dict(momentum_carry="reproject")


class JaxBatches:
    """JAX's ``batch_at(step)``, each batch made once: as JAX arrays for
    JAX's ``train_once`` and, with ``torch=True``, as tensors for the
    port's."""

    def __init__(self, data, cache=None, torch=False):
        self.data, self.cache, self.torch = data, {} if cache is None else cache, torch

    def batch_at(self, step):
        if step not in self.cache:
            self.cache[step] = self.data.batch_at(step)
        batch = self.cache[step]
        if self.torch:
            return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
        return batch


@pytest.fixture(scope="module")
def harness():
    jcfg, jmodel = jax_common.bench_model()
    # JAX's train_once draws its params with ``model.init``; run op by op
    # they differ from the compiled draw by up to 7.5e-9, so both packages
    # take the compiled one
    jmodel = jmodel._replace(init=jax.jit(jmodel.init))
    jdata = JaxBatches(jax_common.bench_data(jcfg))
    _, tmodel = common.bench_model(device="cpu")
    # the params JAX's train_once makes (PRNGKey(seed 0)), as numpy
    init = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    return dict(jmodel=jmodel, jdata=jdata, tmodel=tmodel,
                tdata=JaxBatches(jdata.data, jdata.cache, torch=True), init=init, runs={})


def _pair(h, name, steps=STEPS, **kw):
    """(JAX's train_once, the port's on JAX's init, batches and draws)."""
    key = (name, steps, tuple(sorted(kw.items())))
    if key not in h["runs"]:
        jo = jax_common.train_once(h["jmodel"], h["jdata"], name, steps=steps, **kw)
        params = bridge.params_from_numpy(h["init"], "cpu")
        # the key of JAX's optimizer state (lowrank.py: PRNGKey(cfg.seed))
        draws = JaxDraws(jax.random.PRNGKey(jo["optimizer"].config.seed))
        to = common.train_once(h["tmodel"], h["tdata"], name, steps=steps, params=params,
                               draws=draws, **kw)
        h["runs"][key] = (jo, to)
    return h["runs"][key]


def _row(h, name):
    """A row of the three-optimizer comparison: the low-rank rows under
    ``CARRY``."""
    return _pair(h, name, **({} if name == "adam" else CARRY))


def _check_losses(jo, to, name, tau, step_tol=None):
    """Step 0, the steps up to the second refresh (every step for adam),
    every step within ``step_tol`` when given, and the final loss."""
    jl, tl = np.array(jo["losses"]), np.array(to["losses"])
    assert jl.shape == tl.shape
    np.testing.assert_allclose(tl[0], jl[0], rtol=0, atol=STEP0_TOL, err_msg=name)
    head = tl if name == "adam" else tl[:tau]
    np.testing.assert_allclose(head, jl[:len(head)], rtol=0,
                               atol=ADAM_TOL if name == "adam" else FIRST_TAU_TOL, err_msg=name)
    if step_tol is not None:
        np.testing.assert_allclose(tl, jl, rtol=0, atol=step_tol, err_msg=name)
    assert abs(to["final_loss"] - jo["final_loss"]) <= FINAL_TOL, (name, to["final_loss"],
                                                                    jo["final_loss"])


@pytest.mark.parametrize("name", NAMES)
def test_train_once_matches_jax(harness, name):
    jo, to = _row(harness, name)
    _check_losses(jo, to, name, TAU, None if name == "adam" else LOW_RANK_TOL)
    assert to["final_loss"] == pytest.approx(np.mean(to["losses"][-10:]), rel=1e-12)
    assert to["engine"] == "perleaf" and to["launches"] == {}  # the CPU runs no kernel


def test_ordering_and_gap_reduction_match_jax(harness):
    """The table's claim: both packages rank the three rows alike, and the
    gap reduction of SARA over GaLore has the same sign."""
    runs = {name: _row(harness, name) for name in NAMES}
    jf = {n: jo["final_loss"] for n, (jo, _) in runs.items()}
    tf = {n: to["final_loss"] for n, (_, to) in runs.items()}
    finals = sorted(jf.values())
    assert FINAL_TOL < min(b - a for a, b in zip(finals, finals[1:])) / 2, jf
    assert sorted(jf, key=jf.get) == sorted(tf, key=tf.get), (jf, tf)
    jred = jax_common.gap_reduction(jf["adam"], jf["galore-adam"], jf["galore-sara-adam"])
    tred = common.gap_reduction(tf["adam"], tf["galore-adam"], tf["galore-sara-adam"])
    assert (jred is None) == (tred is None)
    if jred is not None:
        assert np.sign(jred) == np.sign(tred), (jred, tred)


def test_kept_moments_over_four_refreshes(harness):
    """Item 2's leftover: 20 steps of galore-sara-adam at tau 5 under
    "keep" (refreshes at 0, 5, 10 and 15).  Each refresh after the first
    pairs kept moments with differently signed projector columns: single
    steps part by up to 6.5e-3 by step 19 (nearly the table's smallest gap;
    ROADMAP queue 3), the final loss by 8.9e-4, within FINAL_TOL."""
    jo, to = _pair(harness, "galore-sara-adam", steps=20, tau=5, momentum_carry="keep")
    _check_losses(jo, to, "galore-sara-adam", 5)
    assert len(to["losses"]) == 20
