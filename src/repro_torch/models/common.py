"""Shared model building blocks (port of ``repro/models/common.py``):
norms, rotary embeddings, the LoRA-injected linear, embeddings.

Conventions (as in the JAX package): weights are stored ``(in, out)`` and
applied as ``x @ w``; LoRA factors are ``A: (r, in)``, ``B: (out, r)`` and
the update is ``((x @ Aᵀ) @ Bᵀ) * scaling``; parameter trees are plain
nested dicts whose layer stacks carry a leading ``(L, ...)`` axis; norm and
rotary math runs in fp32.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

Params = Dict[str, Any]


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, weight: Optional[torch.Tensor],
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32, cast back to ``x``'s dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    if weight is not None:
        xf = xf * weight.to(torch.float32)
    return xf.to(x.dtype)


def apply_norm(x: torch.Tensor, p: Params, kind: str) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, p["w"])
    raise NotImplementedError(f"norm {kind!r} is not ported yet (ROADMAP A10)")


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Standard RoPE. ``x: (..., T, H, Dh)``, ``positions: (..., T)``."""
    dh = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(dh, theta), dtype=torch.float32,
                            device=x.device)
    angles = positions.to(torch.float32)[..., None] * freqs
    angles = angles[..., None, :]            # broadcast over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# LoRA-injected linear
# --------------------------------------------------------------------------

def init_linear(gen: torch.Generator, d_in: int, d_out: int, dtype,
                lead=()) -> Params:
    """Uniform(±1/√d_in) weights ``(*lead, d_in, d_out)`` on ``gen``'s
    device."""
    scale = 1.0 / np.sqrt(d_in)
    w = torch.empty(tuple(lead) + (d_in, d_out), dtype=torch.float32,
                    device=gen.device)
    w.uniform_(-scale, scale, generator=gen)
    return {"w": w.to(dtype)}


def init_lora(gen: torch.Generator, d_in: int, d_out: int, rank: int,
              dtype, lead=()) -> Params:
    """Paper-standard init: A ~ Kaiming-uniform, B = 0 (ΔW starts at 0)."""
    scale = 1.0 / np.sqrt(d_in)
    a = torch.empty(tuple(lead) + (rank, d_in), dtype=torch.float32,
                    device=gen.device)
    a.uniform_(-scale, scale, generator=gen)
    b = torch.zeros(tuple(lead) + (d_out, rank), dtype=torch.float32,
                    device=gen.device)
    return {"a": a.to(dtype), "b": b.to(dtype)}


def linear(x: torch.Tensor, base: Params, lora=None,
           scaling: float = 2.0) -> torch.Tensor:
    """``x @ W (+ LoRA)``. ``lora`` is an fp ``{'a', 'b'}`` dict (rank-r
    bottleneck in the LoRA dtype) or a
    :class:`~repro_torch.kernels.PackedLoRABatch` (heterogeneous adapters
    applied straight from packed codes by the ``sgmv_fused`` kernel). The
    base product runs in the base dtype; the update is cast to it."""
    y = x @ base["w"]
    if lora is None:
        return y
    from repro_torch.kernels.quant_matmul import (PackedLoRABatch,
                                                   sgmv_apply_packed)

    if isinstance(lora, PackedLoRABatch):
        x2 = x.reshape(-1, x.shape[-1])
        upd = sgmv_apply_packed(x2, lora, scaling=scaling)
        return y + upd.reshape(y.shape).to(y.dtype)
    if not (isinstance(lora, dict) and set(lora) == {"a", "b"}):
        # QuantizedLoRA leaves go through fused_lora (ROADMAP B3),
        # mixed-recipe PackedLoRABuckets through sgmv_apply_buckets (A4)
        raise NotImplementedError(
            f"LoRA leaf {type(lora).__name__} is not served by the port yet "
            f"(fused_lora: ROADMAP B3; PackedLoRABuckets: ROADMAP A4)")
    xl = x.to(lora["a"].dtype)
    upd = (xl @ lora["a"].T) @ lora["b"].T
    return y + (scaling * upd).to(y.dtype)


# --------------------------------------------------------------------------
# embeddings
# --------------------------------------------------------------------------

def init_embedding(gen: torch.Generator, vocab: int, d: int, dtype) -> Params:
    e = torch.empty((vocab, d), dtype=torch.float32, device=gen.device)
    e.normal_(0.0, 1.0, generator=gen)
    return {"e": (e * 0.02).to(dtype)}


def embed(tokens: torch.Tensor, p: Params) -> torch.Tensor:
    return p["e"][tokens]


def unembed(x: torch.Tensor, p: Params) -> torch.Tensor:
    return x @ p["e"].T
