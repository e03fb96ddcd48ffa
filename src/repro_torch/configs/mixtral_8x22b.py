"""Mixtral 8x22B: sparse MoE (8 experts, top-2) with sliding-window
attention [arXiv:2401.04088]. The window bounds the decode KV cache to a
ring of ``min(capacity, window)`` slots."""
import dataclasses

from .base import BlockSpec, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=32768,
    blocks=(BlockSpec(count=56, pattern=("local_attn",), ffn=("moe",)),),
    rope_theta=1000000.0,
    window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=16384),
    subquadratic=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=128, vocab=512, window=8,
        blocks=(BlockSpec(count=2, pattern=("local_attn",), ffn=("moe",)),),
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128),
    )
