"""Shared model building blocks (port of ``repro/models/common.py``):
norms, rotary embeddings, the LoRA-injected linear, embeddings.

Conventions (as in the JAX package): weights are stored ``(in, out)`` and
applied as ``x @ w``; LoRA factors are ``A: (r, in)``, ``B: (out, r)`` and
the update is ``((x @ Aᵀ) @ Bᵀ) * scaling``; parameter trees are plain
nested dicts whose layer stacks carry a leading ``(L, ...)`` axis; norm and
rotary math runs in fp32.

:func:`linear` runs each LoRA update inside a ``model.lora``
:func:`~repro_torch.spans.profiler_range`, which costs one flag check
while no profiler records.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.spans import profiler_range

Params = Dict[str, Any]


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, weight: Optional[torch.Tensor],
            eps: float = 1e-6, plus_one: bool = False) -> torch.Tensor:
    """RMSNorm in fp32, cast back to ``x``'s dtype. ``plus_one`` is the
    gemma convention (w ≡ 1 + w̃)."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    if weight is not None:
        w = weight.to(torch.float32)
        xf = xf * ((1.0 + w) if plus_one else w)
    return xf.to(x.dtype)


def nonparam_layernorm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """OLMo's non-parametric LayerNorm: standardize (population variance,
    as ``jnp.var``), no scale, no bias."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def apply_norm(x: torch.Tensor, p: Optional[Params],
               kind: str) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, p["w"])
    if kind == "rmsnorm_plus1":
        return rmsnorm(x, p["w"], plus_one=True)
    if kind == "nonparam_ln":
        return nonparam_layernorm(x)
    raise ValueError(kind)


def init_norm(d: int, kind: str, lead=(), device=None) -> Params:
    """A norm's params ``(*lead, d)`` in fp32: none for ``nonparam_ln``,
    zeros for ``rmsnorm_plus1`` (w̃ of 1 + w̃), ones for ``rmsnorm``."""
    if kind == "nonparam_ln":
        return {}
    fill = 0.0 if kind == "rmsnorm_plus1" else 1.0
    return {"w": torch.full(tuple(lead) + (d,), fill, dtype=torch.float32,
                            device=device)}


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma-2 soft-capping ``cap · tanh(x / cap)`` in fp32."""
    if cap is None:
        return x
    return (cap * torch.tanh(x.to(torch.float32) / cap)).to(x.dtype)


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


def apply_mrope(x: torch.Tensor, positions: torch.Tensor,
                sections: Sequence[int],
                theta: float = 1000000.0) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: the rotary half-dims are split into
    ``sections`` (summing to Dh/2), each rotated by its own positional
    stream of ``positions: (3, ..., T)`` (temporal / height / width). For
    text the three streams coincide and M-RoPE is RoPE."""
    dh = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(dh, theta), dtype=torch.float32,
                            device=x.device)
    sec_ids = np.repeat(np.arange(len(sections)), sections)
    if sec_ids.shape[0] != dh // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} must sum to "
                         f"Dh/2 = {dh // 2}")
    pos = positions.to(torch.float32)[torch.as_tensor(sec_ids,
                                                      device=x.device)]
    angles = torch.movedim(pos, 0, -1) * freqs           # (..., T, Dh/2)
    angles = angles[..., None, :]
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
           scaling: float = 2.0, tp=None) -> torch.Tensor:
    """``x @ W (+ LoRA)``. Under tensor parallelism (``tp``, a
    :class:`~repro_torch.parallel.tensor.TensorParallel`) the leaves are
    this rank's blocks, the float LoRA runs column- or row-parallel as its
    specs say (:meth:`~repro_torch.parallel.tensor.TensorParallel.linear`)
    and the output is whole on every rank. ``lora`` is one of:

    * an fp ``{'a', 'b'}`` dict (rank-r bottleneck in the LoRA dtype);
    * a :class:`~repro_torch.core.QuantizedLoRA` — one adapter for the whole
      batch, applied straight from its packed codes by
      :func:`~repro_torch.kernels.lora_apply_quantized` (one ``fused_lora``
      launch);
    * a :class:`~repro_torch.kernels.PackedLoRABatch` — heterogeneous
      adapters applied straight from packed codes by the ``sgmv_fused``
      kernel;
    * a :class:`~repro_torch.kernels.PackedLoRABuckets` — a mixed-recipe
      batch, one ``sgmv_fused`` launch per layout bucket.

    The base product promotes as the reference's does (a bf16 ``x`` times
    the fp32 MoE router gives fp32); the update is cast to its dtype."""
    if tp is not None:
        return tp.rep(*tp.linear(x, base, lora, scaling))
    w = base["w"]
    if x.dtype == w.dtype:
        y = x @ w
    else:
        dt = torch.promote_types(x.dtype, w.dtype)
        y = x.to(dt) @ w.to(dt)
    if lora is None:
        return y
    with profiler_range("model.lora"):
        return _lora_update(x, y, lora, scaling)


def _lora_update(x: torch.Tensor, y: torch.Tensor, lora,
                 scaling: float) -> torch.Tensor:
    """``y`` plus the LoRA update of ``x`` for each leaf form of
    :func:`linear`."""
    from repro_torch.core.loraquant import QuantizedLoRA
    from repro_torch.kernels.quant_matmul import (PackedLoRABatch,
                                                   PackedLoRABuckets,
                                                   lora_apply_quantized,
                                                   sgmv_apply_buckets,
                                                   sgmv_apply_packed)

    if isinstance(lora, QuantizedLoRA):
        x2 = x.reshape(-1, x.shape[-1])
        upd = lora_apply_quantized(x2, lora, scaling=scaling, fused=True)
        return y + upd.reshape(y.shape).to(y.dtype)
    if isinstance(lora, PackedLoRABatch):
        x2 = x.reshape(-1, x.shape[-1])
        upd = sgmv_apply_packed(x2, lora, scaling=scaling)
        return y + upd.reshape(y.shape).to(y.dtype)
    if isinstance(lora, PackedLoRABuckets):
        x2 = x.reshape(-1, x.shape[-1])
        upd = sgmv_apply_buckets(x2, lora, scaling=scaling)
        return y + upd.reshape(y.shape).to(y.dtype)
    if not (isinstance(lora, dict) and set(lora) == {"a", "b"}):
        raise TypeError(f"unsupported LoRA leaf {type(lora).__name__}")
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
