"""Baseline LoRA compression methods of the paper's Table 1 (port of
``repro/core/baselines.py``).

All baselines quantize the LoRA factors ``B`` (m×r) and ``A`` (r×n) directly,
group size 128, and report AvgBits under the same Eq.-10 accounting as
LoRAQuant:

* ``rtn_lora``      — group-wise RTN at 1/2/3 bits (Rows 3, 5).
* ``bin_lora``      — sign binarization (Row 2).
* ``gptq_lora``     — GPTQ with Cholesky error compensation (Row 6).
* ``pbllm_lora``    — PB-LLM: top-|w| salient kept at 8 bits, rest binarized,
                      +1 indicator bit per weight (Row 7).
* ``billm_lora``    — BiLLM: salient columns residual-binarized (~2 bits),
                      non-salient split into two magnitude groups, each
                      binarized with its own scale, +1 membership bit (Row 8).
* ``jd_diagonal``   — Gabrielsson et al. joint-diagonalization sharing:
                      a cluster of K adapters shares U, V; each adapter keeps
                      only an r-vector diagonal (Row 4).

Every function takes tensors and returns tensors on the caller's device.
``gptq_matrix``, ``pbllm_matrix`` and ``billm_matrix`` also take leading
batch dims ``(..., rows, cols)`` (one layer stack per call); each matrix of
the batch is treated as the reference treats one, and the bits are summed.
GPTQ runs in float64 (Hessian, its inverse's Cholesky factor and the column
loop), as the reference's host numpy does; PB-LLM and BiLLM keep the
reference's numpy precisions (float32 data, float64 where numpy promotes).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .quant import (GROUP_SIZE_DEFAULT, SCALE_BITS, binary_quantize,
                    rtn_quantize, storage_bits)
from .svd_split import svd_reparam

__all__ = [
    "QuantizedPair",
    "rtn_lora",
    "bin_lora",
    "gptq_matrix",
    "gptq_lora",
    "pbllm_matrix",
    "pbllm_lora",
    "billm_matrix",
    "billm_lora",
    "jd_diagonal_fit",
    "JDDiagonal",
]


@dataclasses.dataclass
class QuantizedPair:
    """A LoRA whose two factors were quantized independently by a baseline."""

    name: str
    b_deq: torch.Tensor
    a_deq: torch.Tensor
    total_bits: float
    num_params: int

    def delta_w(self) -> torch.Tensor:
        return self.b_deq @ self.a_deq

    def materialize(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.b_deq, self.a_deq

    @property
    def avg_bits(self) -> float:
        return self.total_bits / self.num_params


def _pair(name, b_deq, a_deq, total_bits, b, a) -> QuantizedPair:
    return QuantizedPair(name=name, b_deq=b_deq, a_deq=a_deq,
                         total_bits=float(total_bits),
                         num_params=int(b.numel() + a.numel()))


# --------------------------------------------------------------------------
# RTN / BIN direct baselines
# --------------------------------------------------------------------------

def rtn_lora(b, a, bits: int,
             group_size: int = GROUP_SIZE_DEFAULT) -> QuantizedPair:
    qb = rtn_quantize(b, bits, group_size, axis=0)
    qa = rtn_quantize(a, bits, group_size, axis=1)
    return _pair(f"rtn{bits}", qb.dequantize(), qa.dequantize(),
                 storage_bits(qb) + storage_bits(qa), b, a)


def bin_lora(b, a, group_size: int = GROUP_SIZE_DEFAULT) -> QuantizedPair:
    qb = binary_quantize(b, group_size, axis=0)
    qa = binary_quantize(a, group_size, axis=1)
    return _pair("bin", qb.dequantize(), qa.dequantize(),
                 storage_bits(qb) + storage_bits(qa), b, a)


# --------------------------------------------------------------------------
# GPTQ (Frantar et al., 2023)
# --------------------------------------------------------------------------

def gptq_matrix(w: torch.Tensor, hessian: Optional[torch.Tensor], bits: int,
                group_size: int = GROUP_SIZE_DEFAULT,
                percdamp: float = 0.01) -> Tuple[torch.Tensor, float]:
    """GPTQ a weight matrix ``w`` (out, in), or a batch ``(..., out, in)``:
    quantize input-columns sequentially, compensating the not-yet-quantized
    remainder through the inverse-Hessian Cholesky factor. Returns
    (dequantized w in fp32, total bits).

    ``hessian`` is the (in, in) second-moment of calibration inputs
    (``H = Xᵀ X``; one per matrix of a batch, or one shared); ``None`` means
    identity (data-free GPTQ ≡ optimal per-column compensation under
    isotropic inputs)."""
    w = w.to(torch.float64).clone()
    out_dim, in_dim = w.shape[-2:]
    dev = w.device
    h = (torch.eye(in_dim, dtype=torch.float64, device=dev) if hessian is None
         else hessian.to(device=dev, dtype=torch.float64).clone())
    hd = torch.diagonal(h, dim1=-2, dim2=-1)
    dead = hd == 0
    hd.masked_fill_(dead, 1.0)
    w.masked_fill_(dead[..., None, :], 0.0)
    damp = percdamp * hd.mean(-1, keepdim=True)
    hd += damp
    # Hinv via Cholesky of the inverse (upper factor), as in the reference.
    hinv = torch.linalg.cholesky(torch.linalg.inv(h), upper=True)

    qmax = 2**bits - 1
    g = min(group_size, in_dim)
    q_deq = torch.zeros_like(w)
    n_groups = 0
    scale = zero = None
    for col in range(in_dim):
        if col % g == 0:
            blk = w[..., :, col:col + g]
            wmin = blk.amin(-1)
            wmax = blk.amax(-1)
            scale = (wmax - wmin) / qmax
            scale = torch.where(scale <= 0, torch.ones_like(scale), scale)
            zero = torch.clamp(torch.round(-wmin / scale), 0, qmax)
            n_groups += out_dim
        q = torch.clamp(torch.round(w[..., :, col] / scale) + zero, 0, qmax)
        dq = scale * (q - zero)
        q_deq[..., :, col] = dq
        d = hinv[..., col, col]
        err = (w[..., :, col] - dq) / d[..., None]
        if col + 1 < in_dim:
            w[..., :, col + 1:] -= err[..., :, None] * hinv[..., None, col,
                                                             col + 1:]
    n_mats = math.prod(w.shape[:-2])
    total_bits = n_mats * (out_dim * in_dim * bits
                           + n_groups * (SCALE_BITS + bits))
    return q_deq.to(torch.float32), float(total_bits)


def gptq_lora(b, a, bits: int, hessian_b: Optional[torch.Tensor] = None,
              hessian_a: Optional[torch.Tensor] = None,
              group_size: int = GROUP_SIZE_DEFAULT) -> QuantizedPair:
    """GPTQ both factors. ``hessian_a`` is the (n, n) input second moment of
    the layer; ``hessian_b`` is the (r, r) moment of ``A x`` activations."""
    b32, a32 = b.to(torch.float32), a.to(torch.float32)
    bd, bits_b = gptq_matrix(b32, hessian_b, bits, group_size)
    ad, bits_a = gptq_matrix(a32, hessian_a, bits, group_size)
    return _pair(f"gptq{bits}", bd, ad, bits_b + bits_a, b32, a32)


# --------------------------------------------------------------------------
# PB-LLM (Shang et al., 2024)
# --------------------------------------------------------------------------

def _where_sum_f64(mask, v):
    """``np.where(mask, v, 0.0).sum(axis=-1)`` of float32 ``v`` over
    ``int64`` counts: numpy sums in float32 and divides in float64."""
    return torch.where(mask, v, torch.zeros_like(v)).sum(-1).to(torch.float64)


def pbllm_matrix(w: torch.Tensor, salient_frac: float = 0.1,
                 salient_bits: int = 8,
                 group_size: int = GROUP_SIZE_DEFAULT
                 ) -> Tuple[torch.Tensor, float]:
    """Partially-binarized matrix (or batch ``(..., rows, cols)``): top
    ``salient_frac`` weights by |w| kept at ``salient_bits`` RTN; the rest
    sign-binarized; one indicator bit per weight marks membership."""
    w = w.to(torch.float32)
    rows, cols = w.shape[-2:]
    lead = w.shape[:-2]
    aw = w.abs()
    flat = aw.reshape(lead + (-1,))
    k = max(1, int(round(salient_frac * rows * cols)))
    thresh = torch.topk(flat, k, dim=-1).values[..., -1]   # k-th largest
    salient = aw >= thresh[..., None, None]

    g = min(group_size, cols)
    n_groups_rows = -(-cols // g)
    out = torch.zeros_like(w)
    qmax = 2**salient_bits - 1
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=w.device)
    for gi in range(n_groups_rows):
        sl = slice(gi * g, min((gi + 1) * g, cols))
        blk = w[..., sl]
        mask = salient[..., sl]
        # salient path: RTN on the salient entries (per-row-group grid)
        wmin = torch.where(mask, blk, inf).amin(-1)
        wmax = torch.where(mask, blk, -inf).amax(-1)
        has = mask.any(-1)
        wmin = torch.where(has, wmin, torch.zeros_like(wmin))
        wmax = torch.where(has, wmax, torch.zeros_like(wmax))
        scale = (wmax - wmin) / qmax
        scale = torch.where(scale <= 0, torch.ones_like(scale), scale)
        zero = torch.clamp(torch.round(-wmin / scale), 0, qmax)
        q = torch.clamp(torch.round(blk / scale[..., None]) + zero[..., None],
                        0, qmax)
        deq_s = scale[..., None] * (q - zero[..., None])
        # binary path on the rest
        nb = ~mask
        cnt = torch.clamp(nb.sum(-1), min=1)
        s_bin = _where_sum_f64(nb, blk.abs()) / cnt
        sign = torch.where(blk >= 0, 1.0, -1.0).to(torch.float64)
        deq_b = sign * s_bin[..., None]
        out[..., sl] = torch.where(mask, deq_s.to(torch.float64),
                                   deq_b).to(torch.float32)

    n = rows * cols
    n_sal = salient.reshape(lead + (-1,)).sum(-1).to(torch.float64)
    n_groups = rows * n_groups_rows
    total_bits = (
        n_sal * salient_bits
        + (n - n_sal) * 1
        + n * 1  # indicator bit per weight
        + n_groups * (SCALE_BITS + salient_bits)  # salient scale+zero
        + n_groups * SCALE_BITS  # binary scale
    )
    return out, float(total_bits.sum())


def pbllm_lora(b, a, salient_frac: float = 0.1, **kw) -> QuantizedPair:
    b32, a32 = b.to(torch.float32), a.to(torch.float32)
    bd, bits_b = pbllm_matrix(b32.mT, salient_frac, **kw)   # group along m
    ad, bits_a = pbllm_matrix(a32, salient_frac, **kw)      # group along n
    return _pair("pbllm", bd.mT, ad, bits_b + bits_a, b32, a32)


# --------------------------------------------------------------------------
# BiLLM (Huang et al., 2024)
# --------------------------------------------------------------------------

def _true_median(v: torch.Tensor) -> torch.Tensor:
    """``np.median`` over the last dim: the mean of the two middle values
    of an even count (``torch.median`` returns the lower one)."""
    s = torch.sort(v, dim=-1).values
    n = s.shape[-1]
    if n % 2:
        return s[..., n // 2]
    return (s[..., n // 2 - 1] + s[..., n // 2]) / 2


def billm_matrix(w: torch.Tensor, salient_col_frac: float = 0.1,
                 group_size: int = GROUP_SIZE_DEFAULT
                 ) -> Tuple[torch.Tensor, float]:
    """BiLLM-style (a matrix or a batch ``(..., rows, cols)``):
    structurally-salient columns (by column L2 of w) get *residual
    binarization* (two stacked sign approximations ≈ 2 bits); the remaining
    weights are split into two magnitude groups ("bell split"), each
    binarized with its own scale; +1 membership bit per non-salient weight.
    Column indices cost ~log2 bits each (charged). Columns are ranked by
    numpy's ``argsort`` of the negated norms on the host, which keeps the
    reference's order on ties."""
    w = w.to(torch.float32)
    rows, cols = w.shape[-2:]
    lead = w.shape[:-2]
    n_mats = math.prod(lead)
    col_norm = torch.linalg.vector_norm(w, dim=-2)
    k = max(1, int(round(salient_col_frac * cols)))
    order = np.argsort(-col_norm.detach().cpu().numpy(), axis=-1)[..., :k]
    sal_mask = torch.zeros(lead + (cols,), dtype=torch.bool, device=w.device)
    sal_mask.scatter_(-1, torch.as_tensor(order, device=w.device), True)

    out = torch.zeros(w.shape, dtype=torch.float64, device=w.device)
    total_bits = 0.0
    wt = w.mT                                            # (..., cols, rows)

    def cols_of(mask, n):
        """The ``n`` columns of each matrix that ``mask`` marks, in order:
        ``(..., rows, n)``."""
        return wt[mask].reshape(lead + (n, rows)).mT
    # salient columns: residual binarization, per-row scales
    ws = cols_of(sal_mask, k)
    s1 = ws.abs().mean(-1, keepdim=True)
    b1 = torch.where(ws >= 0, 1.0, -1.0).to(torch.float64) * s1
    res = ws - b1
    s2 = res.abs().mean(-1, keepdim=True)
    b2 = torch.where(res >= 0, 1.0, -1.0).to(torch.float64) * s2
    out.mT[sal_mask] = (b1 + b2).mT.reshape(-1, rows)
    total_bits += n_mats * (rows * k * 2 + rows * 2 * SCALE_BITS)
    # non-salient: bell split by |w| median, each half binarized per row
    nk = cols - k
    if nk:
        wn = cols_of(~sal_mask, nk)
        awn = wn.abs()
        med = _true_median(awn.reshape(lead + (-1,)))
        hi = awn >= med[..., None, None]
        deq = torch.zeros(wn.shape, dtype=torch.float64, device=w.device)
        sign = torch.where(wn >= 0, 1.0, -1.0).to(torch.float64)
        for mask in (hi, ~hi):
            cnt = torch.clamp(mask.sum(-1), min=1)
            s = _where_sum_f64(mask, awn) / cnt
            deq = torch.where(mask, sign * s[..., None], deq)
        out.mT[~sal_mask] = deq.mT.reshape(-1, rows)
        total_bits += n_mats * (rows * nk * (1 + 1)   # sign + membership
                                + rows * 2 * SCALE_BITS)  # two scales per row
    total_bits += n_mats * k * np.ceil(np.log2(max(cols, 2)))
    return out.to(torch.float32), float(total_bits)


def billm_lora(b, a, **kw) -> QuantizedPair:
    b32, a32 = b.to(torch.float32), a.to(torch.float32)
    bd, bits_b = billm_matrix(b32.mT, **kw)
    ad, bits_a = billm_matrix(a32, **kw)
    return _pair("billm", bd.mT, ad, bits_b + bits_a, b32, a32)


# --------------------------------------------------------------------------
# JD-Diagonal (Gabrielsson et al., 2024)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class JDDiagonal:
    """A cluster of K adapters sharing ``u`` (m×r) and ``v`` (r×n); adapter k
    is reconstructed as ``u @ diag(d[k]) @ v``. Per-adapter cost is just the
    r-vector ``d[k]`` in fp16 — but the shared basis must be recomputed
    whenever an adapter joins (the scalability flaw the paper criticizes)."""

    u: torch.Tensor            # (m, r)
    v: torch.Tensor            # (r, n)
    d: torch.Tensor            # (K, r)

    def reconstruct(self, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.u * self.d[k][None, :], self.v

    def avg_bits(self) -> float:
        m, r = self.u.shape
        n = self.v.shape[1]
        kk = self.d.shape[0]
        shared = (m * r + r * n) * SCALE_BITS  # fp16 shared basis
        per = kk * r * SCALE_BITS
        return (shared + per) / (kk * r * (m + n))


def jd_diagonal_fit(loras: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                    rank: Optional[int] = None,
                    iters: int = 25) -> JDDiagonal:
    """Alternating least squares for the shared-basis factorization
    ``B_k A_k ≈ U diag(d_k) V``. Never materializes the m×n products:
    all Gram/cross terms are computed through the skinny factors."""
    bs = [b.to(torch.float32) for b, _ in loras]
    as_ = [a.to(torch.float32) for _, a in loras]
    r = rank or bs[0].shape[1]
    kk = len(loras)
    dev = bs[0].device
    eye = torch.eye(r, dtype=torch.float32, device=dev)

    # init U, V from the SVD of the stacked (factored) sum of products
    rep = svd_reparam(torch.cat(bs, dim=1), torch.cat(as_, dim=0))
    u = rep.b_prime[:, :r]
    v = rep.a_prime[:r, :]
    d = torch.ones((kk, r), dtype=torch.float32, device=dev)

    def diag_ls(u, v, bk, ak):
        gu = u.T @ u                              # (r, r)
        gv = v @ v.T                              # (r, r)
        rhs = torch.diagonal((u.T @ bk) @ (ak @ v.T))
        mat = gu * gv.T
        return torch.linalg.solve(mat + 1e-8 * eye, rhs)

    for _ in range(iters):
        d = torch.stack([diag_ls(u, v, bk, ak) for bk, ak in zip(bs, as_)])
        # U-step: U = (Σ_k B_k (A_k Vᵀ D_k)) (Σ_k D_k V Vᵀ D_k)⁻¹
        gv = v @ v.T
        num = sum(bk @ (ak @ v.T * d[k][None, :])
                  for k, (bk, ak) in enumerate(zip(bs, as_)))
        den = sum(torch.outer(d[k], d[k]) * gv for k in range(kk))
        u = torch.linalg.solve(den + 1e-8 * eye, num.T).T
        # V-step (symmetric)
        gu = u.T @ u
        num_v = sum((d[k][:, None] * (u.T @ bk)) @ ak
                    for k, (bk, ak) in enumerate(zip(bs, as_)))
        den_v = sum(torch.outer(d[k], d[k]) * gu for k in range(kk))
        v = torch.linalg.solve(den_v + 1e-8 * eye, num_v)
    return JDDiagonal(u=u, v=v, d=d)
