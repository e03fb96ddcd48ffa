"""RecurrentGemma-2B (Griffin): RG-LRU recurrent blocks + local attention,
2:1 pattern [arXiv:2402.19427]. 26 layers = 8×(rec, rec, attn) + (rec,
rec): two layer groups."""
import dataclasses

from .base import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab=256000,
    blocks=(
        BlockSpec(count=8, pattern=("rglru", "rglru", "local_attn"),
                  ffn=("dense", "dense", "dense")),
        BlockSpec(count=1, pattern=("rglru", "rglru"), ffn=("dense", "dense")),
    ),
    norm="rmsnorm_plus1",
    rope_theta=10000.0,
    window=2048,
    rglru_width=2560,
    conv_width=4,
    tie_embeddings=True,
    subquadratic=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=128, n_heads=4, n_kv_heads=1, head_dim=32,
        d_ff=256, vocab=512, window=8, rglru_width=128,
        blocks=(BlockSpec(count=1, pattern=("rglru", "rglru", "local_attn"),
                          ffn=("dense", "dense", "dense")),),
    )
