from .base import (ARCH_IDS, BlockSpec, MLAConfig, ModelConfig, MoEConfig,
                   SHAPE_CELLS, default_blocks, get_config)

__all__ = ["ARCH_IDS", "BlockSpec", "MLAConfig", "ModelConfig", "MoEConfig",
           "SHAPE_CELLS", "default_blocks", "get_config"]
