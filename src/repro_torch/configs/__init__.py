"""Architecture + shape configs."""
from repro_torch.configs.base import (
    ModelConfig, ShapeConfig, SHAPES, get_config, all_configs, cell_is_supported,
)

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "get_config",
           "all_configs", "cell_is_supported"]
