"""Architecture configs (exact published numbers) + shape cells."""
from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      get_shape, torch_dtype)
from repro_torch.configs.registry import (ARCHS, all_configs, canonical,
                                          get_config)

__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeConfig", "all_configs",
           "canonical", "get_config", "get_shape", "torch_dtype"]
