from repro_torch.configs.base import ModelConfig, make_tiny
from repro_torch.configs.registry import ARCHS, ASSIGNED, get_config, get_tiny_config

__all__ = ["ModelConfig", "make_tiny", "ARCHS", "ASSIGNED", "get_config", "get_tiny_config"]
