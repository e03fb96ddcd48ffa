"""Qwen2-VL-72B language backbone: M-RoPE (temporal / height / width
rotary sections) [arXiv:2409.12191]. The vision tower is a stub:
precomputed patch embeddings (``batch["vision_embeds"]``) are prepended to
the text sequence at the model level; M-RoPE positions arrive as a
``(3, B, T)`` grid, and text positions are the three streams equal."""
import dataclasses

from .base import ModelConfig, default_blocks

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab=152064,
    blocks=default_blocks(80),
    rope="mrope",
    rope_theta=1000000.0,
    mrope_sections=(16, 24, 24),
    vision_stub=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=512, blocks=default_blocks(2),
        mrope_sections=(4, 6, 6),
    )
