"""Gemma-2 2B: alternating local/global attention, attention and logit
soft-capping, post-block norms, gemma-style (1+w) RMSNorm, GELU FFN, tied
256k vocabulary [arXiv:2408.00118]. One layer group of 13 periods of
(local, global); local layers keep a ring of ``min(capacity, window)``
cache slots."""
import dataclasses

from .base import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab=256000,
    blocks=(BlockSpec(count=13, pattern=("local_attn", "attn"),
                      ffn=("dense", "dense")),),
    norm="rmsnorm_plus1",
    post_norm=True,
    rope_theta=10000.0,
    window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=512, window=8,
        blocks=(BlockSpec(count=1, pattern=("local_attn", "attn"),
                          ffn=("dense", "dense")),),
    )
