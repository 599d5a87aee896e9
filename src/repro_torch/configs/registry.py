"""Architecture registry, from ``src/repro/configs/registry.py``: every
architecture of the JAX registry, in its order, and the 40 arch x shape
cells."""
from __future__ import annotations

import importlib
from typing import List, Tuple

from repro_torch.configs.base import SHAPES, ModelConfig

_MODULES = {
    "deepseek-moe-16b": "deepseek_moe_16b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "llava-next-34b": "llava_next_34b",
    "qwen2-1.5b": "qwen2_1_5b",
    "nemotron-4-15b": "nemotron_4_15b",
    "granite-8b": "granite_8b",
    "llama3-8b": "llama3_8b",
    "whisper-medium": "whisper_medium",
    "hymba-1.5b": "hymba_1_5b",
    "mamba2-370m": "mamba2_370m",
}

# long_500k needs sub-quadratic attention: only the SSM and hybrid archs
# run it (DESIGN.md §6); every arch runs the other three shapes.
SUBQUADRATIC = ("hymba-1.5b", "mamba2-370m")


def list_archs() -> List[str]:
    return list(_MODULES)


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    if arch_id not in _MODULES:
        raise ValueError(f"unknown arch {arch_id!r}; have {list(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG


def cells(include_skipped: bool = False) -> List[Tuple[str, str, bool]]:
    """The (arch, shape, runnable) cells in the reference's order: the 40
    of every arch and shape with ``include_skipped``, else the runnable
    ones."""
    out = []
    for arch in _MODULES:
        for shape in SHAPES:
            runnable = shape != "long_500k" or arch in SUBQUADRATIC
            if runnable or include_skipped:
                out.append((arch, shape, runnable))
    return out
