"""The port's ``launch/runtime.py`` against the rules of
``src/repro/launch/runtime.py`` (``tests/test_runtime_preset.py``'s nine
cases): it imports neither torch nor jax; ``PYTORCH_CUDA_ALLOC_CONF``
entries compose with the user's (a key the user set keeps its value); the
other variables are written only where absent; applying a preset twice
writes nothing new; ``LD_PRELOAD`` is an advisory shell export; and
importing ``repro_torch.launch.dryrun`` leaves ``os.environ`` as it was."""
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.launch.runtime import (
    ALLOC_CONF,
    PRESETS,
    apply_runtime_preset,
    compose_alloc_conf,
    shell_exports,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compose_appends_and_preserves_user_entries():
    out = compose_alloc_conf("max_split_size_mb:128", ("expandable_segments:True",))
    assert out == "max_split_size_mb:128,expandable_segments:True"


def test_compose_user_value_wins_on_key_collision():
    # the same key with another value: the user's stays, the preset's is
    # dropped (never duplicated, never overwritten)
    out = compose_alloc_conf("expandable_segments:False",
                             ("expandable_segments:True", "garbage_collection_threshold:0.8"))
    assert out == "expandable_segments:False,garbage_collection_threshold:0.8"


def test_compose_from_empty():
    assert compose_alloc_conf("", ("a:1", "b:2")) == "a:1,b:2"
    assert compose_alloc_conf("  , ", ("a:1",)) == "a:1"


def test_apply_preset_composes_with_preexisting_alloc_conf():
    env = {ALLOC_CONF: "max_split_size_mb:64"}
    written = apply_runtime_preset("overlap", env=env)
    entries = env[ALLOC_CONF].split(",")
    assert entries[0] == "max_split_size_mb:64"  # the user's, first
    for e in PRESETS["overlap"]["alloc_conf"]:
        assert e in entries
    assert written[ALLOC_CONF] == env[ALLOC_CONF]
    # the other variables, set where absent
    for key, val in PRESETS["overlap"]["env"].items():
        assert env[key] == val and written[key] == val


def test_apply_preset_never_overwrites_user_env():
    env = {"TORCH_NCCL_ASYNC_ERROR_HANDLING": "0"}
    written = apply_runtime_preset("overlap", env=env)
    assert env["TORCH_NCCL_ASYNC_ERROR_HANDLING"] == "0"  # the user's setting wins
    assert "TORCH_NCCL_ASYNC_ERROR_HANDLING" not in written


def test_apply_preset_is_idempotent():
    for name in PRESETS:
        env = {}
        apply_runtime_preset(name, env=env)
        once = dict(env)
        assert apply_runtime_preset(name, env=env) == {}  # nothing new to write
        assert env == once


def test_unknown_preset_rejected():
    with pytest.raises(ValueError, match="unknown runtime preset"):
        apply_runtime_preset("warp", env={})
    with pytest.raises(ValueError, match="unknown runtime preset"):
        shell_exports("warp")


def test_shell_exports_cover_preload_only_settings():
    text = shell_exports("overlap")
    assert "export LD_PRELOAD=" in text  # cannot be applied inside a process
    assert f"export {ALLOC_CONF}=expandable_segments:True" in text
    assert "export CUDA_DEVICE_MAX_CONNECTIONS=1" in text


def test_importing_dryrun_does_not_mutate_environ():
    """The preset applies only under the dry run's ``__main__`` guard, and
    the runtime module imports neither torch nor jax."""
    code = (
        "import os, sys\n"
        "os.environ['PYTORCH_CUDA_ALLOC_CONF'] = 'max_split_size_mb:32'\n"
        "import repro_torch.launch.runtime\n"
        "assert 'torch' not in sys.modules and 'jax' not in sys.modules\n"
        "before = dict(os.environ)\n"
        "import repro_torch.launch.dryrun\n"
        "assert dict(os.environ) == before, 'import mutated os.environ'\n"
        "assert os.environ['PYTORCH_CUDA_ALLOC_CONF'] == 'max_split_size_mb:32'\n"
        "print('OK')\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    assert "OK" in out.stdout
