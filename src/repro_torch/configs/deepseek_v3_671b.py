"""DeepSeek-V3 671B: multi-head latent attention (MLA), 1 shared + 256
routed experts top-8, multi-token prediction [arXiv:2412.19437].

The first 3 layers have a dense FFN (d_ff 18432), the other 58 are MoE
with 2048-wide experts stored as int8 codes (``base_quant_bits=8``). LoRA
is not attached to the 256 routed experts' matrices: attention, the
shared expert, the dense FFN and the router keep adapters.
"""
import dataclasses

from .base import BlockSpec, MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,                       # dense layers; experts are 2048-wide
    vocab=129280,
    blocks=(
        BlockSpec(count=3, pattern=("mla",), ffn=("dense",)),
        BlockSpec(count=58, pattern=("mla",), ffn=("moe",)),
    ),
    rope_theta=10000.0,
    moe=MoEConfig(
        n_experts=256, top_k=8, d_ff_expert=2048, n_shared=1,
        lora_on_experts=False,
    ),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    mtp=True,
    base_quant_bits=8,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab=512,
        blocks=(
            BlockSpec(count=1, pattern=("mla",), ffn=("dense",)),
            BlockSpec(count=2, pattern=("mla",), ffn=("moe",)),
        ),
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64, n_shared=1,
                      lora_on_experts=False),
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, rope_head_dim=8,
                      nope_head_dim=16, v_head_dim=16),
    )
