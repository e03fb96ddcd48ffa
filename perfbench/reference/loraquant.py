"""LoRAQuant as the paper states it (Alg. 1-2), frozen for the benchmark.

Each adapter linear ``(B, A)`` is reparameterized by the SVD of ``BA``
(``B' = U S^1/2``, ``A' = S^1/2 Vᵀ``), split at the smallest ``h`` whose
leading singular values cover ``rho`` of the variance, each singular pair is
refined by 100 straight-through Adam steps against its quantizer, and the
high part is stored as asymmetric round-to-nearest codes (``bits_high``,
groups of 128 down each column of B' and along each row of A') and the low
part as signs with a mean-|w| scale per group. This copy keeps the order of
every floating-point operation of that recipe (the binary scale's sum in 32-
wide windows included), so that it derives the same codes from the same
factors; it imports nothing of the program.

:func:`read_side` turns the program's stored codes, scales and zero points
back into factors: the reference reads them only to judge them.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

GROUP = 128


# ----- groups -----

def _to_groups(w: torch.Tensor, group: int, axis: int):
    if axis == 0:
        w = w.mT
    n = w.shape[-1]
    g = min(group, n)
    n_groups = -(-n // g)
    pad = n_groups * g - n
    if pad:
        w = torch.cat([w, w[..., -1:].expand(w.shape[:-1] + (pad,))], dim=-1)
    return w.reshape(w.shape[:-1] + (n_groups, g)), n


def _from_groups(groups: torch.Tensor, n: int, axis: int) -> torch.Tensor:
    w = groups.reshape(groups.shape[:-2] + (-1,))[..., :n]
    return w.mT if axis == 0 else w


def _window_sum(v: torch.Tensor) -> torch.Tensor:
    n = v.shape[-1]
    if n > 32:
        pad = -n % 32
        v = torch.nn.functional.pad(v, (pad // 2, pad - pad // 2))
        return _window_sum(_window_sum(v.reshape(v.shape[:-1] + (-1, 32))))
    acc = v[..., 0]
    for i in range(1, n):
        acc = acc + v[..., i]
    return acc


def _abs_mean(groups: torch.Tensor) -> torch.Tensor:
    recip = torch.tensor(1.0, dtype=torch.float32) / groups.shape[-1]
    return _window_sum(groups.abs().to(torch.float32)) * recip.to(
        groups.device)


def _rtn_params(groups: torch.Tensor, bits: int):
    qmax = float(2 ** bits - 1)
    scale = (groups.amax(dim=-1) - groups.amin(dim=-1)) / qmax
    scale = torch.where(scale <= 0, torch.ones_like(scale), scale)
    zero = torch.round(-groups.amin(dim=-1) / scale).clamp(0.0, qmax)
    return scale.to(torch.float32), zero, qmax


def rtn(w: torch.Tensor, bits: int, axis: int) -> torch.Tensor:
    """Dequantized asymmetric RTN of ``w`` (groups along ``axis``)."""
    groups, n = _to_groups(w.to(torch.float32), GROUP, axis)
    scale, zero, qmax = _rtn_params(groups, bits)
    q = (torch.round(groups / scale[..., None]) + zero[..., None]).clamp(
        0.0, qmax)
    return _from_groups(scale[..., None] * (q - zero[..., None]), n, axis)


def binary(w: torch.Tensor, axis: int) -> torch.Tensor:
    """Dequantized sign binarization of ``w`` (groups along ``axis``)."""
    groups, n = _to_groups(w.to(torch.float32), GROUP, axis)
    scale = _abs_mean(groups)
    sign = torch.where(groups >= 0, 1.0, -1.0)
    return _from_groups(scale[..., None] * sign, n, axis)


def _fake(v: torch.Tensor, mode: str, bits: int) -> torch.Tensor:
    """Straight-through fake quantization of every row of ``v``."""
    groups, n = _to_groups(v, GROUP, 1)
    if mode == "rtn":
        scale, zero, qmax = _rtn_params(groups.detach(), bits)
        q = (torch.round(groups / scale[..., None]) + zero[..., None]).clamp(
            0.0, qmax)
        deq = scale[..., None] * (q - zero[..., None])
    else:
        scale = _abs_mean(groups.detach()).to(groups.dtype)
        deq = scale[..., None] * torch.where(groups >= 0, 1.0, -1.0)
    return v + (_from_groups(deq, n, 1) - v).detach()


# ----- Alg. 2: straight-through refinement of each singular pair -----

def _refine(b: torch.Tensor, a: torch.Tensor, mode: str, bits: int,
            steps: int = 100, lr: float = 1e-4):
    b_ref = b.detach().to(torch.float32).mT
    a_ref = a.detach().to(torch.float32)
    b1, b2, eps = 0.9, 0.999, 1e-8
    rms_b = torch.sqrt((b_ref ** 2).mean(-1, keepdim=True) + 1e-12)
    rms_a = torch.sqrt((a_ref ** 2).mean(-1, keepdim=True) + 1e-12)
    bo, ao = b_ref.clone(), a_ref.clone()
    mb, vb = torch.zeros_like(bo), torch.zeros_like(bo)
    ma, va = torch.zeros_like(ao), torch.zeros_like(ao)
    bb = (b_ref * b_ref).sum(-1) * (a_ref * a_ref).sum(-1)
    for t in range(steps):
        bv = bo.requires_grad_(True)
        av = ao.requires_grad_(True)
        with torch.enable_grad():
            bq, aq = _fake(bv, mode, bits), _fake(av, mode, bits)
            cross = (b_ref * bq).sum(-1) * (a_ref * aq).sum(-1)
            qq = (bq * bq).sum(-1) * (aq * aq).sum(-1)
            loss = (bb - 2.0 * cross + qq).sum()
            gb, ga = torch.autograd.grad(loss, (bv, av))
        with torch.no_grad():
            mb = b1 * mb + (1 - b1) * gb
            vb = b2 * vb + (1 - b2) * gb * gb
            ma = b1 * ma + (1 - b1) * ga
            va = b2 * va + (1 - b2) * ga * ga
            tc = t + 1.0
            corr = math.sqrt(1 - b2 ** tc) / (1 - b1 ** tc)
            bo = bv - lr * rms_b * corr * mb / (torch.sqrt(vb) + eps)
            ao = av - lr * rms_a * corr * ma / (torch.sqrt(va) + eps)
    return bo.detach().mT, ao.detach()


# ----- Alg. 1 over a stack of entries -----

def _select_h(s: np.ndarray, rho: float) -> int:
    var = np.asarray(s, np.float64) ** 2
    total = var.sum()
    if total <= 0.0:
        return 1
    h = int(np.searchsorted(np.cumsum(var) / total, rho - 1e-12) + 1)
    return max(1, min(h, s.shape[0]))


def quantize(b: torch.Tensor, a: torch.Tensor, bits_high: int, rho: float,
             precision: str = "fp32") -> List[Tuple[torch.Tensor,
                                                    torch.Tensor, int]]:
    """Quantize a stack ``b (N, out, r)``, ``a (N, r, in)``; returns per
    entry the dequantized ``(B'' (out, r), A'' (r, in), h)`` in fp32.

    ``precision="bf16"`` is the lower-precision control: the SVD's factors
    and the refined pairs are rounded to bfloat16 before they are stored."""
    b = b.to(torch.float32)
    a = a.to(torch.float32)
    qb, rb = torch.linalg.qr(b)
    qa, ra = torch.linalg.qr(a.mT)
    uc, s, vct = torch.linalg.svd(rb @ ra.mT, full_matrices=False)
    sq = torch.sqrt(s)
    bp = (qb @ uc) * sq[..., None, :]
    ap = sq[..., :, None] * (vct @ qa.mT)
    if precision == "bf16":
        bp = bp.to(torch.bfloat16).to(torch.float32)
        ap = ap.to(torch.bfloat16).to(torch.float32)
    r = int(s.shape[-1])
    s_host = s.detach().cpu().numpy()
    hs = [_select_h(s_host[i], rho) for i in range(b.shape[0])]
    out: list = [None] * b.shape[0]
    for h in sorted(set(hs)):
        idx = [i for i in range(len(hs)) if hs[i] == h]
        sel = torch.as_tensor(idx, device=b.device)
        bh, ah = _refine(bp[sel][:, :, :h], ap[sel][:, :h, :], "rtn",
                         bits_high)
        if precision == "bf16":
            bh = bh.to(torch.bfloat16).to(torch.float32)
            ah = ah.to(torch.bfloat16).to(torch.float32)
        bq, aq = rtn(bh, bits_high, 0), rtn(ah, bits_high, 1)
        if h < r:
            bl, al = _refine(bp[sel][:, :, h:], ap[sel][:, h:, :], "binary",
                             1)
            if precision == "bf16":
                bl = bl.to(torch.bfloat16).to(torch.float32)
                al = al.to(torch.bfloat16).to(torch.float32)
            bq = torch.cat([bq, binary(bl, 0)], dim=-1)
            aq = torch.cat([aq, binary(al, 1)], dim=-2)
        for pos, i in enumerate(idx):
            out[i] = (bq[pos], aq[pos], h)
    return out


# ----- the program's stored form, read back -----

def _unpack(words: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    per_word = 10 if bits == 3 else 8 // bits
    mask = (1 << bits) - 1
    w = words.to(torch.int64)
    cols = [(w >> (i * bits)) & mask for i in range(per_word)]
    return torch.stack(cols, dim=-1).reshape(words.shape[:-1] + (-1,))[
        ..., :n].to(torch.float32)


def read_side(codes, scale, zero, bits: int, group: int, axis: int,
              orig_shape: Sequence[int], mode: str) -> torch.Tensor:
    """One stored factor ``(codes (.., other, groups, words), scale,
    zero)`` as fp32 values of ``orig_shape``."""
    q = _unpack(codes, bits, group)
    if mode == "rtn":
        w = scale[..., None] * (q - zero[..., None].to(torch.float32))
    else:
        w = scale[..., None] * (q * 2.0 - 1.0)
    return _from_groups(w, int(orig_shape[axis]), axis)


def delta_gap(p: Tuple[torch.Tensor, torch.Tensor],
              q: Tuple[torch.Tensor, torch.Tensor]) -> float:
    """``‖B₁A₁ − B₂A₂‖_F / ‖B₂A₂‖_F`` from the factors alone (Gram
    matrices of rank size, never the ``out × in`` product)."""
    b = torch.cat([p[0], -q[0]], dim=1).to(torch.float64)
    a = torch.cat([p[1], q[1]], dim=0).to(torch.float64)
    num = torch.sum((b.T @ b) * (a @ a.T))
    b2, a2 = q[0].to(torch.float64), q[1].to(torch.float64)
    den = torch.sum((b2.T @ b2) * (a2 @ a2.T))
    return float(torch.sqrt(num.clamp(min=0.0)) / torch.sqrt(den))
