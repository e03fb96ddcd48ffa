"""InternLM2-20B: dense GQA decoder [arXiv:2403.17297]."""
import dataclasses

from .base import ModelConfig, default_blocks

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=92544,
    blocks=default_blocks(48),
    rope_theta=1000000.0,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=512, blocks=default_blocks(2),
    )
