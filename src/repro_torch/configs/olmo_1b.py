"""OLMo-1B: dense decoder with non-parametric LayerNorm (no scale, no
bias) and a tied vocabulary [arXiv:2402.00838]."""
import dataclasses

from .base import ModelConfig, default_blocks

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab=50304,
    blocks=default_blocks(16),
    norm="nonparam_ln",
    rope_theta=10000.0,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab=512, blocks=default_blocks(2),
    )
