"""Architecture registry, from ``src/repro/configs/registry.py``: every
architecture of the JAX registry, in its order."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ModelConfig

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


def list_archs() -> List[str]:
    return list(_MODULES)


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    if arch_id not in _MODULES:
        raise ValueError(f"unknown arch {arch_id!r}; have {list(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG
