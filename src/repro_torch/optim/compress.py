"""Error-feedback int8 gradient compression (port of
``repro/optim/compress.py``), the standard EF-SGD recipe:

    e ← residual buffer (same tree as grads)
    c = quantize_int8(g + e);  e ← (g + e) − dequant(c)
    all-reduce c across the data group; g ← dequant(mean(c))

Quantization is per-tensor symmetric int8; the residual carries what int8
drops into the next step, making the scheme unbiased over time. The int8
payload crosses the network (carried as int32 so the sum cannot overflow),
fp32 never does. The arithmetic is the reference's, op for op:
``torch.round`` rounds half to even as ``jnp.round`` does, so codes, scales
and residuals are bit-exact.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from .adamw import tree_map

__all__ = ["compress_with_feedback", "compressed_psum_mean",
           "dequantize_int8", "init_error_feedback", "quantize_int8"]


def _scale(x: torch.Tensor) -> torch.Tensor:
    scale = torch.max(torch.abs(x)) / 127.0
    return torch.where(scale <= 0, torch.ones_like(scale), scale).to(
        torch.float32)


def _codes(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = _scale(x)
    return _codes(x, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error_feedback(grads) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def compress_with_feedback(grads, error):
    """Returns (int8 tree, scale tree, new error tree)."""
    corrected = tree_map(lambda g, e: g.to(torch.float32) + e, grads, error)
    scales = tree_map(_scale, corrected)
    q = tree_map(_codes, corrected, scales)
    new_error = tree_map(lambda c, qi, s: c - dequantize_int8(qi, s),
                         corrected, q, scales)
    return q, scales, new_error


def compressed_psum_mean(grads, error, group=None):
    """EF-int8 mean all-reduce over the process ``group`` (the default
    group when None); every rank calls it with its own grads and residual.

    Each rank quantizes with its own scale; the int codes are summed in
    int32 and dequantized with the max scale gathered alongside — one
    extra scalar per tensor on the wire. Returns (mean tree, new error)."""
    import torch.distributed as dist

    q, s, new_error = compress_with_feedback(grads, error)
    n = dist.get_world_size(group)

    def total(qi):
        t = qi.to(torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t

    def smax(si):
        t = si.clone()
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        return t

    reduced = tree_map(lambda t, m: t.to(torch.float32) * m / n,
                       tree_map(total, q), tree_map(smax, s))
    return reduced, new_error
