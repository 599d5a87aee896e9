from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config, list_archs

__all__ = ["ModelConfig", "get_config", "list_archs"]
