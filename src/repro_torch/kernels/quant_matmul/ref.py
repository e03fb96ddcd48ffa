"""Plain PyTorch oracle for the packed-LoRA kernels (port of
``repro/kernels/quant_matmul/ref.py``) and ``sgmv_fused_ref``, the plain
version of the ``sgmv_fused`` CUDA kernel.

* ``ref_quant_matmul_rhs(x, q)`` = ``x @ dequant(q).T`` for a row-grouped
  ``(R, K)`` factor (the A side, or Bᵀ).
* ``ref_lora_apply(x, qa, qbt)`` = ``(x @ Aᵀ) @ Bᵀ`` from packed factors.
* ``ref_sgmv(x, qas, qbts, seg_ids)`` = per-row adapter selection.
* ``sgmv_fused_ref`` computes, from the kernel layout, exactly what the
  kernel computes: per token tile, the tile's adapter's
  ``y = (x·A_hiᵀ)·B_hi + (x·A_loᵀ)·B_lo`` in fp32. The wrapper in
  ``kernel.py`` takes it for CPU tensors; ``chip_smoke.py`` holds the kernel
  against it on the card.

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
# plain version of the sgmv_fused kernel
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


def sgmv_fused_ref(x, a_codes, a_scale, a_zero, b_codes, b_scale, b_zero,
                   seg_map, *, bits_a: int, binary_a: bool, group_a: int,
                   bits_b: int, binary_b: bool, group_b: int,
                   a_lo=None, b_lo=None, bits_lo: int = 1,
                   binary_lo: bool = True, group_al: int = 0,
                   group_bl: int = 0, m: Optional[int] = None,
                   tile_t: int = 8) -> torch.Tensor:
    """Heterogeneous multi-adapter apply, one adapter per ``tile_t`` rows.

    x ``(T, K)``; codes/scale/zero ``(NA, R, ·)``; ``seg_map (T/tile_t,)``
    int32 adapter id per token tile (clamped to ``[0, NA)`` like the
    kernel). Rows whose zero-scale padding dequantizes to 0 contribute
    nothing. ``m`` slices B's last-group padding. Returns ``(T, m)`` fp32.
    """
    t, k = x.shape
    na = a_codes.shape[0]
    if m is None:
        m = b_scale.shape[-1] * group_b
    xf = x.to(torch.float32)
    seg_rows = seg_map.to(torch.int64).clamp(0, na - 1).repeat_interleave(
        tile_t)
    out = torch.empty((t, m), dtype=torch.float32, device=x.device)
    for a in torch.unique(seg_rows).tolist():
        rows = torch.nonzero(seg_rows == a).flatten()
        xa = xf[rows]
        wa = unpack_dequant_grouped(a_codes[a], a_scale[a],
                                    None if binary_a else a_zero[a],
                                    bits_a, group_a)
        wb = unpack_dequant_grouped(b_codes[a], b_scale[a],
                                    None if binary_b else b_zero[a],
                                    bits_b, group_b)
        acc = (xa @ wa[:, :k].T) @ wb[:, :m]
        if a_lo is not None:
            alc, als, alz = a_lo
            blc, bls, blz = b_lo
            wal = unpack_dequant_grouped(alc[a], als[a],
                                         None if binary_lo else alz[a],
                                         bits_lo, group_al)
            wbl = unpack_dequant_grouped(blc[a], bls[a],
                                         None if binary_lo else blz[a],
                                         bits_lo, group_bl)
            acc = acc + (xa @ wal[:, :k].T) @ wbl[:, :m]
        out[rows] = acc
    return out
