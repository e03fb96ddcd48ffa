"""Straight-through-estimator refinement of sub-LoRA factors (port of
``repro/core/ste.py``, paper §3.3, Alg. 2).

For every singular pair ``(b_i, a_i)`` the refinement minimizes
``‖b_i a_iᵀ − D(Q(b*)) D(Q(a*))ᵀ‖_F`` by Adam steps whose gradient passes
through the quantizer by the straight-through estimator. Pairs are
independent, so all pairs of a sub-LoRA (and of a whole layer stack) are
one batch of rows; the rank-1 identity
``‖b aᵀ − b̂ âᵀ‖² = ‖b‖²‖a‖² − 2(bᵀb̂)(aᵀâ) + ‖b̂‖²‖â‖²`` keeps each pair's
loss O(m + n).
"""

from __future__ import annotations

import math

import torch

from .quant import (binary_fake_quant, binary_quantize, rtn_fake_quant,
                    rtn_quantize)

__all__ = ["optimize_pairs", "pair_loss", "als_refine_pairs"]


def _fq_rows(v: torch.Tensor, mode: str, bits: int,
             group_size: int) -> torch.Tensor:
    """Fake-quantize every row of ``v (..., k, len)`` with the grouping the
    storage path uses for one column of B' / one row of A'."""
    if mode == "rtn":
        return rtn_fake_quant(v, bits, group_size=group_size, axis=1)
    return binary_fake_quant(v, group_size=group_size, axis=1)


def pair_loss(b_opt, a_opt, b_ref, a_ref, mode: str, bits: int,
              group_size: int) -> torch.Tensor:
    """Rank-1 Frobenius reconstruction loss, one value per pair (row)."""
    bq = _fq_rows(b_opt, mode, bits, group_size)
    aq = _fq_rows(a_opt, mode, bits, group_size)
    bb = (b_ref * b_ref).sum(-1) * (a_ref * a_ref).sum(-1)
    cross = (b_ref * bq).sum(-1) * (a_ref * aq).sum(-1)
    qq = (bq * bq).sum(-1) * (aq * aq).sum(-1)
    return bb - 2.0 * cross + qq


def optimize_pairs(b: torch.Tensor, a: torch.Tensor, *, mode: str, bits: int,
                   group_size: int, steps: int = 100, lr: float = 1e-3):
    """Alg. 2 for all pairs at once: ``b (..., m, k)``, ``a (..., k, n)``.
    Adam-normalized STE descent whose step is relative to each pair's weight
    RMS, as in the JAX package. Returns refined ``(B*, A*)``."""
    if steps <= 0:
        return b, a
    b_ref = b.detach().to(torch.float32).mT      # (..., k, m): row per pair
    a_ref = a.detach().to(torch.float32)         # (..., k, n)
    b1, b2, eps = 0.9, 0.999, 1e-8
    rms_b = torch.sqrt((b_ref**2).mean(-1, keepdim=True) + 1e-12)
    rms_a = torch.sqrt((a_ref**2).mean(-1, keepdim=True) + 1e-12)
    bo, ao = b_ref.clone(), a_ref.clone()
    mb, vb = torch.zeros_like(bo), torch.zeros_like(bo)
    ma, va = torch.zeros_like(ao), torch.zeros_like(ao)
    for t in range(steps):
        bv = bo.requires_grad_(True)
        av = ao.requires_grad_(True)
        with torch.enable_grad():
            loss = pair_loss(bv, av, b_ref, a_ref, mode, bits,
                             group_size).sum()
            gb, ga = torch.autograd.grad(loss, (bv, av))
        with torch.no_grad():
            mb = b1 * mb + (1 - b1) * gb
            vb = b2 * vb + (1 - b2) * gb * gb
            ma = b1 * ma + (1 - b1) * ga
            va = b2 * va + (1 - b2) * ga * ga
            tc = t + 1.0
            corr = math.sqrt(1 - b2**tc) / (1 - b1**tc)
            bo = bv - lr * rms_b * corr * mb / (torch.sqrt(vb) + eps)
            ao = av - lr * rms_a * corr * ma / (torch.sqrt(va) + eps)
    return bo.detach().mT.to(b.dtype), ao.detach().to(a.dtype)


def als_refine_pairs(b: torch.Tensor, a: torch.Tensor, *, mode: str,
                     bits: int, group_size: int, iters: int = 4):
    """Beyond-paper per-pair rank-1 alternating least squares: with the
    dequantized other factor fixed, rescale each pair by its scalar
    projection. ``b (..., m, k)``, ``a (..., k, n)``."""
    b32 = b.to(torch.float32)
    a32 = a.to(torch.float32)

    def deq(x, axis):
        q = (rtn_quantize(x, bits, group_size, axis=axis) if mode == "rtn"
             else binary_quantize(x, group_size, axis=axis))
        return q.dequantize()

    bo, ao = b32, a32
    for _ in range(iters):
        qa = deq(ao, 1)                                       # (..., k, n)
        beta = (a32 * qa).sum(-1) / ((qa * qa).sum(-1) + 1e-12)
        bo = b32 * beta[..., None, :]
        qb = deq(bo, 0)                                       # (..., m, k)
        alpha = (b32 * qb).sum(-2) / ((qb * qb).sum(-2) + 1e-12)
        ao = a32 * alpha[..., :, None]
    return bo.to(b.dtype), ao.to(a.dtype)
