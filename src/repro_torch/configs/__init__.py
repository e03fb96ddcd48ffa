from .base import ARCH_IDS, BlockSpec, ModelConfig, default_blocks, get_config

__all__ = ["ARCH_IDS", "BlockSpec", "ModelConfig", "default_blocks",
           "get_config"]
