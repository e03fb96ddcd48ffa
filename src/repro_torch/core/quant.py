"""Quantization primitives for LoRAQuant (port of ``repro/core/quant.py``).

Two group-wise quantizers: asymmetric round-to-nearest (``rtn``, fp32 scale
and integer zero-point per group) and sign binarization (``binary``, scale
``mean(|w|)`` per group). Each comes as ``*_quantize`` (packed codes +
scales), ``*_dequantize`` and ``*_fake_quant`` (straight-through estimator,
``w + (fq(w) - w).detach()``).

The operation order of ``_to_groups`` / ``_rtn_params`` follows the JAX
package step by step so that codes, scales and zero-points come out
bit-exact, and ``_abs_mean`` sums each binary group in the order XLA's
CPU backend does, so binary scales are bit-exact too. Unlike the JAX
functions, which take one 2-D factor and are
``vmap``-ed, these accept leading batch dims ``(..., rows, cols)``; ``axis``
then names one of the last two dims.

Storage words: 1/2/4/8-bit codes pack densely into ``uint8``; 3-bit codes
pack 10 per 32-bit word, kept as ``int32`` (torch's ``uint32`` has no
shifts; the payload is at most 30 bits, so the sign bit is never set).
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = [
    "QuantizedTensor",
    "rtn_quantize",
    "rtn_dequantize",
    "rtn_fake_quant",
    "binary_quantize",
    "binary_dequantize",
    "binary_fake_quant",
    "pack_codes",
    "unpack_codes",
    "storage_bits",
    "GROUP_SIZE_DEFAULT",
]

GROUP_SIZE_DEFAULT = 128
# Bits charged per stored scale in the paper's AvgBits accounting.
SCALE_BITS = 16


@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    """A group-wise quantized 2-D tensor (optionally with leading batch
    dims on every array), packed for storage.

    ``codes``  — ``(..., other, n_groups, words)`` uint8, or int32 for 3-bit.
    ``scale``  — ``(..., other, n_groups)`` fp32.
    ``zero``   — ``(..., other, n_groups)`` int32 (all zero for binary).
    ``axis``   — axis of the original 2-D tensor along which groups run
                 (0 = column-wise as for B', 1 = row-wise as for A').
    """

    codes: torch.Tensor
    scale: torch.Tensor
    zero: torch.Tensor
    bits: int
    group_size: int
    axis: int
    orig_shape: tuple
    mode: str

    @property
    def shape(self):
        return self.orig_shape

    def dequantize(self) -> torch.Tensor:
        if self.mode == "rtn":
            return rtn_dequantize(self)
        return binary_dequantize(self)

    def num_params(self) -> int:
        return int(math.prod(self.orig_shape))

    def index(self, i) -> "QuantizedTensor":
        """Entry ``i`` of the leading batch dim (what ``tree_map(x[i])``
        does to a vmapped JAX ``QuantizedTensor``)."""
        return dataclasses.replace(self, codes=self.codes[i],
                                   scale=self.scale[i], zero=self.zero[i])


# --------------------------------------------------------------------------
# packing
# --------------------------------------------------------------------------

def _codes_per_word(bits: int):
    if bits in (1, 2, 4, 8):
        return 8 // bits, torch.uint8
    if bits == 3:
        return 10, torch.int32
    raise ValueError(f"unsupported bitwidth {bits}")


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack integer codes (last axis, values in ``[0, 2**bits)``) into
    little-endian storage words: ``(..., ceil(n / per_word))``."""
    per_word, word_dtype = _codes_per_word(bits)
    n = codes.shape[-1]
    n_words = -(-n // per_word)
    pad = n_words * per_word - n
    codes = codes.to(torch.int64)
    if pad:
        codes = torch.cat(
            [codes, codes.new_zeros(codes.shape[:-1] + (pad,))], dim=-1)
    codes = codes.reshape(codes.shape[:-1] + (n_words, per_word))
    acc = torch.zeros(codes.shape[:-1], dtype=torch.int64, device=codes.device)
    for i in range(per_word):
        acc |= codes[..., i] << (i * bits)
    return acc.to(word_dtype)


def unpack_codes(packed: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_codes`; returns int32 codes of last-dim ``n``."""
    per_word, _ = _codes_per_word(bits)
    mask = (1 << bits) - 1
    words = packed.to(torch.int64)
    cols = [(words >> (i * bits)) & mask for i in range(per_word)]
    out = torch.stack(cols, dim=-1).reshape(packed.shape[:-1] + (-1,))
    return out[..., :n].to(torch.int32)


# --------------------------------------------------------------------------
# group reshaping helpers
# --------------------------------------------------------------------------

def _to_groups(w: torch.Tensor, group_size: int, axis: int):
    """``(groups, n_groups, orig_len, pad)`` with ``groups`` of shape
    ``(..., other, n_groups, group)``, the quantization axis last. Padding
    replicates the last valid element so min/max/mean|.| are unaffected."""
    if w.dim() < 2:
        raise ValueError("quantization operates on 2-D factors")
    if axis == 0:
        w = w.mT
    n = w.shape[-1]
    g = min(group_size, n)
    n_groups = -(-n // g)
    pad = n_groups * g - n
    if pad:
        w = torch.cat([w, w[..., -1:].expand(w.shape[:-1] + (pad,))], dim=-1)
    return w.reshape(w.shape[:-1] + (n_groups, g)), n_groups, n, pad


def _from_groups(groups: torch.Tensor, orig_len: int, axis: int):
    w = groups.reshape(groups.shape[:-2] + (-1,))[..., :orig_len]
    return w.mT if axis == 0 else w


def _factor_len(w: torch.Tensor, axis: int) -> int:
    return w.shape[w.dim() - 2 + axis]


# --------------------------------------------------------------------------
# RTN (paper Eq. 6-7)
# --------------------------------------------------------------------------

def _rtn_params(groups: torch.Tensor, bits: int):
    qmax = float(2**bits - 1)  # qmin = 0 (asymmetric unsigned grid)
    wmin = groups.amin(dim=-1)
    wmax = groups.amax(dim=-1)
    scale = (wmax - wmin) / qmax
    scale = torch.where(scale <= 0, torch.ones_like(scale), scale)
    zero = torch.round(-wmin / scale)
    zero = zero.clamp(0.0, qmax)
    return scale.to(torch.float32), zero, qmax


def rtn_quantize(w: torch.Tensor, bits: int,
                 group_size: int = GROUP_SIZE_DEFAULT,
                 axis: int = 1) -> QuantizedTensor:
    """Asymmetric group-wise RTN. ``axis`` is the grouping axis of ``w``."""
    groups, _, _, _ = _to_groups(w.to(torch.float32), group_size, axis)
    scale, zero, qmax = _rtn_params(groups, bits)
    q = torch.round(groups / scale[..., None]) + zero[..., None]
    q = q.clamp(0.0, qmax).to(torch.int32)
    return QuantizedTensor(
        codes=pack_codes(q, bits),
        scale=scale,
        zero=zero.to(torch.int32),
        bits=bits,
        group_size=min(group_size, _factor_len(w, axis)),
        axis=axis,
        orig_shape=tuple(w.shape[-2:]),
        mode="rtn",
    )


def rtn_dequantize(q: QuantizedTensor) -> torch.Tensor:
    codes = unpack_codes(q.codes, q.bits, q.group_size)
    w = q.scale[..., None] * (codes.to(torch.float32)
                              - q.zero[..., None].to(torch.float32))
    return _from_groups(w, q.orig_shape[q.axis], q.axis)


def rtn_fake_quant(w: torch.Tensor, bits: int,
                   group_size: int = GROUP_SIZE_DEFAULT,
                   axis: int = 1) -> torch.Tensor:
    """Differentiable (STE) simulated RTN on the storage grid."""
    groups, _, orig_len, _ = _to_groups(w, group_size, axis)
    scale, zero, qmax = _rtn_params(groups.detach(), bits)
    q = (torch.round(groups / scale[..., None]) + zero[..., None]).clamp(
        0.0, qmax)
    deq = scale[..., None] * (q - zero[..., None])
    fq = _from_groups(deq, orig_len, axis)
    return w + (fq - w).detach()


# --------------------------------------------------------------------------
# binary / sign quantization (paper Eq. 8)
# --------------------------------------------------------------------------

XLA_REDUCE_WINDOW = 32


def _xla_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim in XLA's CPU order: a row longer than 32 is
    zero-padded evenly on both ends to whole windows of 32, each window is
    summed left to right, and the window sums are reduced the same way."""
    n = v.shape[-1]
    if n > XLA_REDUCE_WINDOW:
        pad = -n % XLA_REDUCE_WINDOW
        v = torch.nn.functional.pad(v, (pad // 2, pad - pad // 2))
        v = _xla_sum(v.reshape(v.shape[:-1] + (-1, XLA_REDUCE_WINDOW)))
        return _xla_sum(v)
    acc = v[..., 0]
    for i in range(1, n):
        acc = acc + v[..., i]
    return acc


def _abs_mean(groups: torch.Tensor) -> torch.Tensor:
    """``mean(|groups|)`` over the last dim, bit-exact against ``jnp.mean``
    on the CPU: the XLA-ordered sum times the fp32 constant ``1/n``."""
    n = groups.shape[-1]
    recip = torch.tensor(1.0, dtype=torch.float32) / n
    return _xla_sum(groups.abs().to(torch.float32)) * recip.to(groups.device)


def binary_quantize(w: torch.Tensor, group_size: int = GROUP_SIZE_DEFAULT,
                    axis: int = 1) -> QuantizedTensor:
    """Sign binarization with the Frobenius-optimal scale ``mean(|w|)``."""
    groups, _, _, _ = _to_groups(w.to(torch.float32), group_size, axis)
    scale = _abs_mean(groups)
    bit = (groups >= 0).to(torch.int32)       # sign(x): 1 if x >= 0 else -1
    return QuantizedTensor(
        codes=pack_codes(bit, 1),
        scale=scale,
        zero=torch.zeros_like(scale, dtype=torch.int32),
        bits=1,
        group_size=min(group_size, _factor_len(w, axis)),
        axis=axis,
        orig_shape=tuple(w.shape[-2:]),
        mode="binary",
    )


def binary_dequantize(q: QuantizedTensor) -> torch.Tensor:
    bit = unpack_codes(q.codes, 1, q.group_size)
    sign = bit.to(torch.float32) * 2.0 - 1.0
    w = q.scale[..., None] * sign
    return _from_groups(w, q.orig_shape[q.axis], q.axis)


def binary_fake_quant(w: torch.Tensor, group_size: int = GROUP_SIZE_DEFAULT,
                      axis: int = 1) -> torch.Tensor:
    groups, _, orig_len, _ = _to_groups(w, group_size, axis)
    scale = _abs_mean(groups.detach()).to(groups.dtype)
    sign = torch.where(groups >= 0, 1.0, -1.0)
    deq = scale[..., None] * sign
    fq = _from_groups(deq, orig_len, axis)
    return w + (fq - w).detach()


# --------------------------------------------------------------------------
# bit accounting (paper Eq. 10 / Appendix C)
# --------------------------------------------------------------------------

def storage_bits(q: QuantizedTensor) -> int:
    """Bits under the paper's accounting: ``bits`` per weight + a 16-bit
    scale per group (+ a ``bits``-wide zero-point per RTN group)."""
    n_params = q.num_params()
    n_groups = int(math.prod(q.scale.shape))
    total = n_params * q.bits + n_groups * SCALE_BITS
    if q.mode == "rtn":
        total += n_groups * q.bits
    return total
