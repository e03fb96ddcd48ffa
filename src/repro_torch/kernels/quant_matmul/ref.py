"""Plain PyTorch oracle for the packed-LoRA kernels (port of
``repro/kernels/quant_matmul/ref.py``) and the plain versions of the CUDA
kernels.

* ``ref_quant_matmul_rhs(x, q)`` = ``x @ dequant(q).T`` for a row-grouped
  ``(R, K)`` factor (the A side, or Bᵀ).
* ``ref_lora_apply(x, qa, qbt)`` = ``(x @ Aᵀ) @ Bᵀ`` from packed factors.
* ``ref_sgmv(x, qas, qbts, seg_ids)`` = per-row adapter selection.
* ``matmul_rhs_ref``, ``matmul_out_ref``, ``fused_lora_ref``,
  ``sgmv_rhs_ref``, ``sgmv_out_ref`` and ``sgmv_fused_ref`` compute, from
  the kernel layout, exactly what their CUDA kernels compute, in fp32:
  ``h = x·dequant(A)ᵀ``, ``y = h·dequant(Bᵀ)`` over the group-padded width,
  one adapter's ``y = (x·A_hiᵀ)·B_hi + (x·A_loᵀ)·B_lo``, and the same
  three per token tile with the tile's adapter. The wrappers in
  ``kernel.py`` take them for CPU tensors; ``chip_smoke.py`` holds the
  kernels against them on the card.

The B factor ``(M, R)`` is quantized column-wise, which is row-wise
quantization of ``Bᵀ (R, M)``: both sides share one ``(R, ·)`` layout.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.quant import QuantizedTensor


def ref_quant_matmul_rhs(x: torch.Tensor, q: QuantizedTensor) -> torch.Tensor:
    """x: (T, K); q: (R, K) row-grouped (axis=1). Returns (T, R) fp32."""
    w = q.dequantize().to(torch.float32)
    return x.to(torch.float32) @ w.T


def ref_quant_matmul_out(h: torch.Tensor, qbt: QuantizedTensor) -> torch.Tensor:
    """h: (T, R); qbt: Bᵀ as (R, M) row-grouped, or the column-grouped
    B (M, R) itself."""
    w = qbt.dequantize().to(torch.float32)
    if qbt.axis == 0:
        w = w.T
    return h.to(torch.float32) @ w


def ref_lora_apply(x: torch.Tensor, qa: QuantizedTensor,
                   qbt: QuantizedTensor) -> torch.Tensor:
    return ref_quant_matmul_out(ref_quant_matmul_rhs(x, qa), qbt)


def ref_sgmv(x: torch.Tensor, qas: Sequence[QuantizedTensor],
             qbts: Sequence[QuantizedTensor], seg_ids) -> torch.Tensor:
    t = x.shape[0]
    qb0 = qbts[0]
    m = qb0.orig_shape[0] if qb0.axis == 0 else qb0.orig_shape[1]
    out = torch.zeros((t, m), dtype=torch.float32, device=x.device)
    seg_ids = np.asarray(seg_ids)
    for a in range(len(qas)):
        rows = np.nonzero(seg_ids == a)[0]
        if rows.size == 0:
            continue
        idx = torch.as_tensor(rows, device=x.device)
        out[idx] = ref_lora_apply(x[idx], qas[a], qbts[a])
    return out


# --------------------------------------------------------------------------
# plain versions of the CUDA kernels
# --------------------------------------------------------------------------

def unpack_dequant_grouped(codes: torch.Tensor, scale: torch.Tensor,
                           zero: Optional[torch.Tensor], bits: int,
                           group: int) -> torch.Tensor:
    """Group-aware unpack (the TPU kernels' ``_unpack_dequant_grouped``):
    codes ``(..., R, NG·Wg)`` → fp32 ``(..., R, NG·group)``. Each group's
    ``Wg`` words hold ``per`` little-endian codes (8/bits per uint8 word, 10
    per int32 word for 3-bit); the per-group word padding is dropped, then
    ``scale·(q − zero)`` (RTN) or ``scale·(2q − 1)`` (binary, ``zero=None``).
    """
    per = 10 if bits == 3 else 8 // bits
    mask = (1 << bits) - 1
    *lead, r, c = codes.shape
    ng = scale.shape[-1]
    wpg = c // ng
    w = codes.reshape(*lead, r, ng, wpg).to(torch.int32)
    planes = [(w >> (bits * i)) & mask for i in range(per)]
    q = torch.stack(planes, dim=-1).reshape(*lead, r, ng, wpg * per)
    q = q[..., :group].to(torch.float32)
    if zero is None:
        deq = scale[..., None] * (q * 2.0 - 1.0)
    else:
        deq = scale[..., None] * (q - zero.to(torch.float32)[..., None])
    return deq.reshape(*lead, r, ng * group)


def matmul_rhs_ref(x, codes, scale, zero, *, bits: int, binary: bool,
                   group: int) -> torch.Tensor:
    """``x (T, K) @ dequant(codes (R, NG·Wg))ᵀ`` → ``(T, R)`` fp32; columns
    of A past K (the last group's padding) are dropped."""
    w = unpack_dequant_grouped(codes, scale, None if binary else zero, bits,
                               group)
    return x.to(torch.float32) @ w[:, :x.shape[1]].T


def matmul_out_ref(h, codes, scale, zero, *, bits: int, binary: bool,
                   group: int) -> torch.Tensor:
    """``h (T, R) @ dequant(codes (R, NG·Wg))`` → ``(T, Mp)`` fp32 with
    ``Mp = NG·group``; callers slice ``[:, :m]``."""
    w = unpack_dequant_grouped(codes, scale, None if binary else zero, bits,
                               group)
    return h.to(torch.float32) @ w


def fused_lora_ref(x, a_hi, b_hi, a_lo=None, b_lo=None, *, m: int,
                   bits_hi: int, binary_hi: bool, bits_lo: int = 1,
                   binary_lo: bool = True, group_ah: int, group_bh: int,
                   group_al: int = 0, group_bl: int = 0) -> torch.Tensor:
    """One adapter's ``(x·A_hiᵀ)·B_hi (+ (x·A_loᵀ)·B_lo)`` → ``(T, m)`` fp32.
    Each side is a ``(codes, scale, zero)`` triple in the kernel layout; the
    output has exactly ``m`` columns whatever B's group padding."""
    def side(a, b, bits, binary, ga, gb):
        h = matmul_rhs_ref(x, *a, bits=bits, binary=binary, group=ga)
        return matmul_out_ref(h, *b, bits=bits, binary=binary,
                              group=gb)[:, :m]

    y = side(a_hi, b_hi, bits_hi, binary_hi, group_ah, group_bh)
    if a_lo is not None:
        y = y + side(a_lo, b_lo, bits_lo, binary_lo, group_al, group_bl)
    return y


def _adapter_rows(seg_map, na: int, tile_t: int):
    """``(adapter, row indices)`` for every adapter the token tiles use;
    tile ``i`` (rows ``[i·tile_t, (i+1)·tile_t)``) uses adapter
    ``seg_map[i]`` clamped to ``[0, NA)`` like the kernels."""
    seg_rows = seg_map.to(torch.int64).clamp(0, na - 1).repeat_interleave(
        tile_t)
    return [(a, torch.nonzero(seg_rows == a).flatten())
            for a in torch.unique(seg_rows).tolist()]


def _deq(codes, scale, zero, a: int, bits: int, binary: bool, group: int):
    """Adapter ``a`` of a stacked side, dequantized: fp32 ``(R, NG·group)``."""
    return unpack_dequant_grouped(codes[a], scale[a],
                                  None if binary else zero[a], bits, group)


def sgmv_rhs_ref(x, codes, scale, zero, seg_map, *, bits: int, binary: bool,
                 group: int, tile_t: int = 8) -> torch.Tensor:
    """Segment-gathered ``h = x·dequant(A[seg])ᵀ`` → ``(T, R)`` fp32: x
    ``(T, K)``, codes ``(NA, R, NG·Wg)``, ``seg_map (T/tile_t,)`` int32.
    Columns of A past K are dropped."""
    t, k = x.shape
    xf = x.to(torch.float32)
    out = torch.empty((t, codes.shape[1]), dtype=torch.float32,
                      device=x.device)
    for a, rows in _adapter_rows(seg_map, codes.shape[0], tile_t):
        w = _deq(codes, scale, zero, a, bits, binary, group)
        out[rows] = xf[rows] @ w[:, :k].T
    return out


def sgmv_out_ref(h, codes, scale, zero, seg_map, *, bits: int, binary: bool,
                 group: int, m: Optional[int] = None,
                 tile_t: int = 8) -> torch.Tensor:
    """Segment-gathered ``y = h·dequant(Bᵀ[seg])[:, :m]`` → ``(T, m)``
    fp32: h ``(T, R)``, codes ``(NA, R, NG·Wg)``; ``m`` defaults to
    ``NG·group``."""
    if m is None:
        m = scale.shape[-1] * group
    hf = h.to(torch.float32)
    out = torch.empty((h.shape[0], m), dtype=torch.float32, device=h.device)
    for a, rows in _adapter_rows(seg_map, codes.shape[0], tile_t):
        w = _deq(codes, scale, zero, a, bits, binary, group)
        out[rows] = hf[rows] @ w[:, :m]
    return out


def sgmv_fused_ref(x, a_codes, a_scale, a_zero, b_codes, b_scale, b_zero,
                   seg_map, *, bits_a: int, binary_a: bool, group_a: int,
                   bits_b: int, binary_b: bool, group_b: int,
                   a_lo=None, b_lo=None, bits_lo: int = 1,
                   binary_lo: bool = True, group_al: int = 0,
                   group_bl: int = 0, m: Optional[int] = None,
                   tile_t: int = 8) -> torch.Tensor:
    """Heterogeneous multi-adapter apply, one adapter per ``tile_t`` rows:
    ``(x·A_hiᵀ)·B_hi (+ (x·A_loᵀ)·B_lo)`` → ``(T, m)`` fp32.

    x ``(T, K)``; the high side codes/scale/zero ``(NA, R, ·)``, A and B
    each with its own bits, format and group; the optional low side
    ``a_lo`` / ``b_lo`` ``(codes, scale, zero)`` triples ``(NA, R_lo, ·)``
    with ``bits_lo`` / ``binary_lo`` and its own groups. ``seg_map
    (T/tile_t,)`` int32 adapter id per token tile (clamped to ``[0, NA)``
    like the kernel). Rows whose zero-scale padding dequantizes to 0
    contribute nothing. ``m`` slices B's last-group padding.
    """
    t, k = x.shape
    if m is None:
        m = b_scale.shape[-1] * group_b
    xf = x.to(torch.float32)
    out = torch.empty((t, m), dtype=torch.float32, device=x.device)
    for a, rows in _adapter_rows(seg_map, a_codes.shape[0], tile_t):
        xa = xf[rows]
        wa = _deq(a_codes, a_scale, a_zero, a, bits_a, binary_a, group_a)
        wb = _deq(b_codes, b_scale, b_zero, a, bits_b, binary_b, group_b)
        acc = (xa @ wa[:, :k].T) @ wb[:, :m]
        if a_lo is not None:
            wal = _deq(*a_lo, a, bits_lo, binary_lo, group_al)
            wbl = _deq(*b_lo, a, bits_lo, binary_lo, group_bl)
            acc = acc + (xa @ wal[:, :k].T) @ wbl[:, :m]
        out[rows] = acc
    return out
