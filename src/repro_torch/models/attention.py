"""GQA attention (port of the GQA half of ``repro/models/attention.py``).

Two modes, as in the JAX package:

* sequence mode (prefill): ``x: (B, T, d)``, causal mask, optional
  ``pad_mask: (B, T)`` (True = real token) so left-padded rows never attend
  to pad slots; with a cache the last ``min(T, cap)`` keys/values are
  written to their ring slots;
* decode mode: ``x: (B, 1, d)`` with a ring-buffer cache written at per-row
  ``cache_pos: (B,)``; ``valid_start: (B,)`` masks each row's pad and stale
  slots.

Unlike the JAX package, which returns new cache arrays, the cache tensors
are updated in place (the engine never reuses a cache it has handed on),
which saves a copy of the whole cache per layer and step.

Not ported yet: the blockwise online-softmax path used above
``BLOCKWISE_THRESHOLD`` tokens, sliding-window (``local_attn``) layers,
M-RoPE, soft-capping and MLA (ROADMAP A5 / A10).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .common import apply_rope, init_linear, init_lora, linear

Params = Dict[str, Any]

NEG_INF = -2.3819763e38  # most-negative bf16-representable; avoids nan softmax
BLOCKWISE_THRESHOLD = 8192


def init_gqa(gen: torch.Generator, cfg, lora_rank: Optional[int], count: int):
    """Stacked ``(count, ...)`` GQA params and (optionally) LoRA factors."""
    d, h, kv, dh = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
    lead = (count,)
    shapes = {"wq": (d, h * dh), "wk": (d, kv * dh), "wv": (d, kv * dh),
              "wo": (h * dh, d)}
    base = {n: init_linear(gen, i, o, cfg.dtype, lead)
            for n, (i, o) in shapes.items()}
    lora = None
    if lora_rank is not None:
        lora = {n: init_lora(gen, i, o, lora_rank, cfg.lora_dtype, lead)
                for n, (i, o) in shapes.items()}
    return base, lora


def _split_heads(x, n, dh):
    return x.reshape(x.shape[:-1] + (n, dh))


def _causal_window_mask(t_q: int, t_kv: int, offset: int,
                        window: Optional[int], device) -> torch.Tensor:
    """(t_q, t_kv) additive mask. ``offset`` = absolute position of query 0."""
    qpos = torch.arange(t_q, device=device)[:, None] + offset
    kpos = torch.arange(t_kv, device=device)[None, :]
    ok = kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def _pad_key_mask(pad_mask: torch.Tensor, extra_dims: int) -> torch.Tensor:
    """(B, S) bool validity → additive (B, 1, ..., 1, S) mask with
    ``extra_dims`` unit axes."""
    m = torch.where(pad_mask, 0.0, NEG_INF).to(torch.float32)
    return m.reshape((m.shape[0],) + (1,) * extra_dims + (m.shape[1],))


def _sdpa(q, k, v, mask) -> torch.Tensor:
    """q: (B,T,H,dh), k/v: (B,S,KV,dh) with H = KV·G. fp32 softmax; the
    probabilities are cast to ``v``'s dtype before the value product."""
    b, t, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    q = q.reshape(b, t, kvh, g, dh)
    scores = torch.einsum("btkgd,bskd->bkgts", q, k).to(torch.float32)
    scores = scores / np.sqrt(dh)
    scores = scores + mask
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v)
    return out.reshape(b, t, h * dh)


def gqa_attention(
    x: torch.Tensor,
    base: Params,
    lora: Optional[Params],
    cfg,
    *,
    positions: torch.Tensor,                   # (B, T)
    cache: Optional[Params] = None,            # {"k","v"}: (B, S, KV, dh)
    cache_pos: Optional[torch.Tensor] = None,  # (B,) padded index
    valid_start: Optional[torch.Tensor] = None,  # (B,) first real index
    pad_mask: Optional[torch.Tensor] = None,     # (B, T) True = real token
    scaling: float = 2.0,
) -> torch.Tensor:
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    b, t, _ = x.shape
    if t > BLOCKWISE_THRESHOLD:
        raise NotImplementedError(
            f"{t} tokens needs the blockwise attention path (above "
            f"{BLOCKWISE_THRESHOLD}), not ported yet (ROADMAP A5)")
    if cfg.rope != "standard":
        raise NotImplementedError(f"rope {cfg.rope!r} is not ported yet "
                                  f"(ROADMAP A10)")

    def proj(name, width):
        return _split_heads(
            linear(x, base[name], lora and lora.get(name), scaling), width, dh)

    q = apply_rope(proj("wq", h), positions, cfg.rope_theta)
    k = apply_rope(proj("wk", kv), positions, cfg.rope_theta)
    v = proj("wv", kv)

    if cache is not None and t == 1:
        # decode: the cache is a ring buffer of ``cap`` slots; per row, slot
        # s holds the newest padded index p' ≤ pos with p' ≡ s (mod cap).
        # Pad slots (p' < valid_start) and stale slots of a previous
        # occupant (p' < 0) are masked.
        cap = cache["k"].shape[1]
        pos_b = cache_pos.to(torch.int64).reshape(-1).expand(b)
        start_b = (torch.zeros((b,), dtype=torch.int64, device=x.device)
                   if valid_start is None
                   else valid_start.to(torch.int64).reshape(-1).expand(b))
        slot = torch.remainder(pos_b, cap)
        rows = torch.arange(b, device=x.device)
        cache["k"][rows, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, slot] = v[:, 0].to(cache["v"].dtype)
        s_idx = torch.arange(cap, device=x.device)
        abs_pos = pos_b[:, None] - torch.remainder(
            pos_b[:, None] - s_idx[None, :], cap)
        mask = _pad_key_mask(abs_pos >= start_b[:, None], 3)
        out = _sdpa(q, cache["k"], cache["v"], mask)
    else:
        mask = _causal_window_mask(t, t, 0, None, x.device)
        if pad_mask is not None:
            mask = mask + _pad_key_mask(pad_mask, 3)
        out = _sdpa(q, k, v, mask)
        if cache is not None:
            # stateful prefill from position 0: write the last min(T, cap)
            # tokens at their ring slots (pad slots too; decode masks them)
            cap = cache["k"].shape[1]
            keep = min(t, cap)
            start = (t - keep) % cap
            wrap = max(start + keep - cap, 0)
            for name, val in (("k", k), ("v", v)):
                src = val[:, t - keep:].to(cache[name].dtype)
                cache[name][:, start:start + keep - wrap] = src[:, :keep - wrap]
                if wrap:
                    cache[name][:, :wrap] = src[:, keep - wrap:]

    return linear(out, base["wo"], lora and lora.get("wo"), scaling)


def init_gqa_cache(cfg, batch: int, capacity: int, dtype, device,
                   count: int) -> Params:
    """Zeroed ``(count, B, capacity, KV, dh)`` key and value caches."""
    shape = (count, batch, capacity, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
