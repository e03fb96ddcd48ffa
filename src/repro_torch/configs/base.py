"""Model configuration and the ``--arch`` registry (port of
``repro/configs/base.py``).

A config describes the decoder as a sequence of layer groups (runs of
identical blocks whose params are stacked ``(L, ...)``). The port serves the
dense GQA family; ``get_config`` raises ``NotImplementedError`` for the
architectures whose layers are not ported yet.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One layer group: ``count`` repeats of a pattern of sub-blocks."""

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
    norm: str = "rmsnorm"
    rope: str = "standard"
    rope_theta: float = 500000.0
    tie_embeddings: bool = False
    lora_rank: int = 16
    lora_alpha: float = 32.0
    dtype: Any = torch.bfloat16
    lora_dtype: Any = torch.float32

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def total_layers(self) -> int:
        return sum(b.count * len(b.pattern) for b in self.blocks)


def default_blocks(n_layers: int) -> Tuple[BlockSpec, ...]:
    return (BlockSpec(count=n_layers, pattern=("attn",), ffn=("dense",)),)


ARCH_IDS = ("llama3.2-3b",)

# Architectures of the JAX package whose layers the port does not have yet,
# with the ROADMAP item that ports them.
_NOT_PORTED = {
    "internlm2-20b": "A10",
    "gemma2-2b": "A10",
    "olmo-1b": "A10",
    "rwkv6-1.6b": "A10",
    "mixtral-8x22b": "A10",
    "deepseek-v3-671b": "A10",
    "recurrentgemma-2b": "A10",
    "musicgen-medium": "A10",
    "qwen2-vl-72b": "A10",
}

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(name: str, preset: str = "full") -> ModelConfig:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported to repro_torch yet "
            f"(ROADMAP {_NOT_PORTED[name]}); ported: {list(ARCH_IDS)}")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    if preset == "full":
        return mod.CONFIG
    if preset == "smoke":
        return mod.smoke_config()
    raise ValueError(f"unknown preset {preset!r}")
