from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.configs.registry import ARCHS, get_config

__all__ = ["ARCHS", "ModelConfig", "get_config", "torch_dtype"]
