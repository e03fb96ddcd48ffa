"""LLaMA 3.2-3B: dense GQA decoder [hf:meta-llama/Llama-3.2-3B]."""
import dataclasses

from .base import ModelConfig, default_blocks

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=128256,
    blocks=default_blocks(28),
    rope_theta=500000.0,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=512, blocks=default_blocks(2),
    )
