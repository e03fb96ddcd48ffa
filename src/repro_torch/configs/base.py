"""Model configuration and the ``--arch`` registry (port of
``repro/configs/base.py``).

A config describes the decoder as a sequence of layer groups (runs of
identical blocks whose params are stacked ``(L, ...)``; an alternating
pattern such as gemma2's local/global attention is one group whose block
holds one period). The port serves the dense GQA family and its variants
(gemma2's soft-caps and post-norms, olmo's non-parametric LayerNorm,
qwen2-vl's M-RoPE and vision prefix, musicgen's codebooks), the
sparse-MoE family with sliding-window attention (mixtral) and deepseek's
multi-head latent attention with a shared expert, an int8 frozen expert
base and the multi-token-prediction loss, and the recurrent families:
RWKV-6's attention-free time / channel mix (rwkv6) and RecurrentGemma's
RG-LRU blocks beside local attention. Every architecture of the JAX
package is ported.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 16384
    n_shared: int = 0
    capacity_factor: float = 1.25
    router_noise: float = 0.0
    lora_on_experts: bool = True
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 multi-head latent attention dims."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One layer group: ``count`` repeats of a pattern of sub-blocks.

    ``pattern`` entries: "attn" | "local_attn" | "mla" | "rglru" | "rwkv";
    ``ffn`` entries (parallel list): "dense" | "moe" | "rwkv_cm".
    """

    count: int
    pattern: Tuple[str, ...] = ("attn",)
    ffn: Tuple[str, ...] = ("dense",)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    blocks: Tuple[BlockSpec, ...] = ()
    norm: str = "rmsnorm"            # rmsnorm | rmsnorm_plus1 | nonparam_ln
    post_norm: bool = False          # gemma2 post-block norms
    rope: str = "standard"           # standard | mrope | none
    rope_theta: float = 500000.0
    mrope_sections: Tuple[int, ...] = (16, 24, 24)
    window: int = 4096               # local attention / SWA window
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mtp: bool = False                # deepseek multi-token prediction head
    # rwkv / rglru
    rwkv_head_dim: int = 64
    rglru_width: Optional[int] = None   # recurrence width (defaults d_model)
    conv_width: int = 4
    n_codebooks: int = 0             # musicgen: EnCodec codebooks
    vision_stub: bool = False        # qwen2-vl: precomputed patch embeds
    lora_rank: int = 16
    lora_alpha: float = 32.0
    dtype: Any = torch.bfloat16
    lora_dtype: Any = torch.float32
    # frozen-base weight quantization of the MoE expert stacks: None | 8
    # (per-(expert, out-column) symmetric int8 codes and fp32 scales,
    # dequantized on the fly)
    base_quant_bits: Any = None
    subquadratic: bool = False       # can run long_500k

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def total_layers(self) -> int:
        return sum(b.count * len(b.pattern) for b in self.blocks)


def default_blocks(n_layers: int) -> Tuple[BlockSpec, ...]:
    return (BlockSpec(count=n_layers, pattern=("attn",), ffn=("dense",)),)


ARCH_IDS = ("llama3.2-3b", "internlm2-20b", "gemma2-2b", "olmo-1b",
            "rwkv6-1.6b", "mixtral-8x22b", "deepseek-v3-671b",
            "recurrentgemma-2b", "musicgen-medium", "qwen2-vl-72b")

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(name: str, preset: str = "full") -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    if preset == "full":
        return mod.CONFIG
    if preset == "smoke":
        return mod.smoke_config()
    raise ValueError(f"unknown preset {preset!r}")


SHAPE_CELLS = {
    # name: (seq_len, global_batch, kind)
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}
