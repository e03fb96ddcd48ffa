"""SVD reparameterization and sub-LoRA splitting (port of
``repro/core/svd_split.py``, paper §3.1).

``BA = U S Vᵀ`` is computed without forming the ``m×n`` product: QR both
skinny factors and take the SVD of the ``r×r`` core. Every function takes
optional leading batch dims, so one call factorizes a whole layer stack
(the JAX package ``vmap``-s the 2-D version).

QR and SVD signs are free across LAPACK builds: compare two
reparameterizations by ``b' a'`` and ``s``, not factor by factor.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["SVDReparam", "svd_reparam", "svd_reparam_stack", "select_h",
           "split_at"]


class SVDReparam(NamedTuple):
    """``b_prime @ a_prime == B @ A`` with importance sorted by ``s``."""

    b_prime: torch.Tensor  # (..., m, r) = U S^{1/2}
    a_prime: torch.Tensor  # (..., r, n) = S^{1/2} Vᵀ
    s: torch.Tensor        # (..., r) singular values, descending


def svd_reparam(b: torch.Tensor, a: torch.Tensor) -> SVDReparam:
    """Reparameterize ``(B, A)`` to ``(B', A')`` (paper Eq. 1-2):
    ``B = Q_b R_b``, ``Aᵀ = Q_a R_a``, ``SVD(R_b R_aᵀ) = U_c S V_cᵀ``,
    ``U = Q_b U_c``, ``V = Q_a V_c``."""
    b = b.to(torch.float32)
    a = a.to(torch.float32)
    qb, rb = torch.linalg.qr(b)
    qa, ra = torch.linalg.qr(a.mT)
    core = rb @ ra.mT
    uc, s, vct = torch.linalg.svd(core, full_matrices=False)
    sqrt_s = torch.sqrt(s)
    b_prime = (qb @ uc) * sqrt_s[..., None, :]
    a_prime = sqrt_s[..., :, None] * (vct @ qa.mT)
    return SVDReparam(b_prime=b_prime, a_prime=a_prime, s=s)


def svd_reparam_stack(b_stack: torch.Tensor,
                      a_stack: torch.Tensor) -> SVDReparam:
    """:func:`svd_reparam` over a layer stack ``(L, m, r)``, ``(L, r, n)``:
    torch's QR and SVD batch over the leading axis."""
    return svd_reparam(b_stack, a_stack)


def select_h(s, rho: float) -> int:
    """Smallest ``h`` with cumulative variance ratio ≥ rho (paper Eq. 5);
    always ``1 <= h <= r``."""
    if isinstance(s, torch.Tensor):
        s = s.detach().cpu().numpy()
    s = np.asarray(s, dtype=np.float64)
    var = s**2
    total = var.sum()
    if total <= 0.0:
        return 1
    frac = np.cumsum(var) / total
    h = int(np.searchsorted(frac, rho - 1e-12) + 1)
    return max(1, min(h, s.shape[0]))


def split_at(rep: SVDReparam, h: int):
    """``((B_h, A_h), (B_l, A_l))``; the low part is ``None`` when
    ``h == r``."""
    r = rep.s.shape[-1]
    high = (rep.b_prime[..., :, :h], rep.a_prime[..., :h, :])
    low = (None if h >= r
           else (rep.b_prime[..., :, h:], rep.a_prime[..., h:, :]))
    return high, low
