"""Dense GLU feed-forward (port of the dense half of
``repro/models/ffn.py``; the MoE layers wait for ROADMAP A10)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .common import init_linear, init_lora, linear


def init_dense_ffn(gen: torch.Generator, cfg, lora_rank: Optional[int],
                   count: int, d_ff: Optional[int] = None):
    """Stacked ``(count, ...)`` gate/up/down weights and LoRA factors."""
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    lead = (count,)
    shapes = {"wg": (d, f), "wu": (d, f), "wd": (f, d)}
    base = {n: init_linear(gen, i, o, cfg.dtype, lead)
            for n, (i, o) in shapes.items()}
    lora = None
    if lora_rank is not None:
        lora = {n: init_lora(gen, i, o, lora_rank, cfg.lora_dtype, lead)
                for n, (i, o) in shapes.items()}
    return base, lora


def dense_ffn(x, base, lora, *, activation: str = "silu",
              scaling: float = 2.0):
    g = linear(x, base["wg"], lora and lora.get("wg"), scaling)
    u = linear(x, base["wu"], lora and lora.get("wu"), scaling)
    # jax.nn.gelu defaults to the tanh approximation
    act = F.silu(g) if activation == "silu" else F.gelu(g, approximate="tanh")
    return linear(act * u, base["wd"], lora and lora.get("wd"), scaling)
