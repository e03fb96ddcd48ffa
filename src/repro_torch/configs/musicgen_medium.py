"""MusicGen-medium: decoder-only transformer over EnCodec tokens
[arXiv:2306.05284]. The EnCodec frontend is a stub: tokens arrive as
``(B, 4, T)`` ids of 4 codebooks, their embeddings are summed and 4
per-codebook heads predict the next frame (the delay pattern is a data
concern). 48 layers, d 1536, 24 heads (MHA). Served at the model level
only: the serving engine hands the model ``(B, T)`` tokens (ROADMAP C8)."""
import dataclasses

from .base import ModelConfig, default_blocks

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab=2048,
    blocks=default_blocks(48),
    rope_theta=10000.0,
    n_codebooks=4,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab=128, blocks=default_blocks(2),
    )
