"""Architecture and shape-cell configs."""
from repro_torch.configs.base import (cell_applicable, ModelConfig, MoEConfig,
                                SHAPE_CELLS, ShapeCell)
from repro_torch.configs.registry import (all_configs, ASSIGNED_ARCHS, get_config,
                                    smoke_config)

__all__ = ["ModelConfig", "MoEConfig", "ShapeCell", "SHAPE_CELLS",
           "cell_applicable", "ASSIGNED_ARCHS", "all_configs", "get_config",
           "smoke_config"]
