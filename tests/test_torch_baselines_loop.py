"""The paper's baselines trained by the port's ``train_loop`` against the
JAX package's, continued from tests/test_torch_baselines_train.py (two
files, so that the CPU time splits between test workers): 3 steps of
``online-pca-adam`` on both engines, and of ``fira-sara-adam`` and
``galore-sara-adafactor``, which both packages run on the per-leaf loop
with per-leaf state under ``engine="bucketed"``.  Losses to 1e-5; final
params to ``REFRESH_TOL`` (every refresh here ends in a QR or an SVD)."""
import pytest

from test_torch_baselines_train import check_three_step_loop
from test_torch_train import pair  # noqa: F401  (a fixture)

RUNS = [("online-pca-adam", "bucketed"), ("online-pca-adam", "reference"),
        ("fira-sara-adam", "bucketed"), ("galore-sara-adafactor", "bucketed")]


@pytest.mark.parametrize("name,engine", RUNS)
def test_three_step_train_loop_matches_jax(pair, name, engine, tmp_path):  # noqa: F811
    check_three_step_loop(pair, name, engine, tmp_path)
