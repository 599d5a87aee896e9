"""Architecture registry, from ``src/repro/configs/registry.py``.

The dense, MoE, SSM and hybrid architectures are ported; the enc-dec and
VLM ones raise a clear error until their families land (ROADMAP queue 1
item 8).
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "deepseek-moe-16b": "deepseek_moe_16b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "qwen2-1.5b": "qwen2_1_5b",
    "nemotron-4-15b": "nemotron_4_15b",
    "granite-8b": "granite_8b",
    "llama3-8b": "llama3_8b",
    "hymba-1.5b": "hymba_1_5b",
    "mamba2-370m": "mamba2_370m",
}

# In the JAX registry, not yet ported: their families (vlm, audio) have no
# model code in this package yet.
NOT_YET_PORTED = (
    "llava-next-34b",
    "whisper-medium",
)


def list_archs() -> List[str]:
    return list(_MODULES)


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    if arch_id in NOT_YET_PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not yet ported to repro_torch (its family "
            f"comes with ROADMAP queue 1 item 8); ported: {list(_MODULES)}"
        )
    if arch_id not in _MODULES:
        raise ValueError(f"unknown arch {arch_id!r}; have {list(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG
