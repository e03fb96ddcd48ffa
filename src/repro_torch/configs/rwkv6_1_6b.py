"""RWKV-6 "Finch" 1.6B: attention-free, data-dependent decay linear
recurrence (time-mix) + channel-mix FFN [arXiv:2404.05892]."""
import dataclasses

from .base import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,            # d_model / rwkv_head_dim
    n_kv_heads=32,
    d_ff=7168,
    vocab=65536,
    blocks=(BlockSpec(count=24, pattern=("rwkv",), ffn=("rwkv_cm",)),),
    rope="none",
    rwkv_head_dim=64,
    subquadratic=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=2, n_kv_heads=2, d_ff=256,
        vocab=512, blocks=(BlockSpec(count=2, pattern=("rwkv",),
                                     ffn=("rwkv_cm",)),),
    )
