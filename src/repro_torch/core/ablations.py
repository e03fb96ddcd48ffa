"""Ablation variants of LoRAQuant, reproducing the paper's Figs. 2–4 (port of
``repro/core/ablations.py``).

* Fig. 2 — sub-LoRA **split strategies** at a static ``h``:
    ``svd`` (ours) vs ``random`` columns/rows of the *original* B/A vs
    ``norm`` (rank components sorted by ‖b_i a_iᵀ‖_F = ‖b_i‖‖a_i‖).
* Fig. 3 — component ablations: ``no_opt`` (skip Alg. 2), ``prune``
    (drop the low sub-LoRA), ``rtn1_low`` (1-bit RTN instead of sign
    binarization for the low sub-LoRA).
* Fig. 4 — ``static h`` vs the ratio-based dynamic ``h`` (Eq. 5).

The random split draws ``np.random.default_rng(seed).permutation`` and the
norm split ranks by numpy's ``argsort`` on the host, as the reference does,
so both pick the reference's components.
"""

from __future__ import annotations

from typing import Literal, Optional

import numpy as np
import torch

from .loraquant import LoRAQuantConfig, QuantizedLoRA, quantize_lora
from .quant import binary_quantize, rtn_quantize
from .ste import optimize_pairs
from .svd_split import select_h, split_at, svd_reparam

__all__ = ["quantize_lora_variant", "SplitStrategy"]

SplitStrategy = Literal["svd", "random", "norm"]


def _component_norms(b: torch.Tensor, a: torch.Tensor) -> np.ndarray:
    """``‖b_i‖ ‖a_i‖`` per rank component, on the host."""
    norms = torch.linalg.vector_norm(b, dim=0) * torch.linalg.vector_norm(
        a, dim=1)
    return norms.detach().cpu().numpy()


def _split_factors(b, a, h: int, strategy: SplitStrategy, seed: int = 0):
    """Return ((Bh, Ah), (Bl, Al) or None) under the requested strategy."""
    r = b.shape[1]
    h = max(1, min(h, r))
    if strategy == "svd":
        return split_at(svd_reparam(b, a), h)
    if strategy == "random":
        perm = np.random.default_rng(seed).permutation(r)
    elif strategy == "norm":
        perm = np.argsort(-_component_norms(b, a))
    else:
        raise ValueError(strategy)
    hi = torch.as_tensor(perm[:h], device=b.device)
    lo = torch.as_tensor(perm[h:], device=b.device)
    high = (b[:, hi], a[hi, :])
    low = None if h >= r else (b[:, lo], a[lo, :])
    return high, low


def quantize_lora_variant(
    b: torch.Tensor,
    a: torch.Tensor,
    config: LoRAQuantConfig = LoRAQuantConfig(),
    *,
    split_strategy: SplitStrategy = "svd",
    static_h: Optional[int] = None,
    use_opt: bool = True,
    prune_low: bool = False,
    low_quantizer: Literal["binary", "rtn1"] = "binary",
    seed: int = 0,
) -> QuantizedLoRA:
    """Generalized Alg. 1 covering every ablation axis. With all defaults this
    is exactly :func:`repro_torch.core.loraquant.quantize_lora`."""
    if (split_strategy == "svd" and static_h is None and use_opt
            and not prune_low and low_quantizer == "binary"):
        return quantize_lora(b, a, config)

    r = b.shape[1]
    if static_h is not None:
        h = max(1, min(static_h, r))
    elif split_strategy == "svd":
        h = select_h(svd_reparam(b, a).s, config.rho)
    else:
        # dynamic ratio for non-SVD splits: Eq. 5 on the component
        # energies, ranked by the importance proxy
        norms = _component_norms(b, a)
        h = select_h(norms[np.argsort(-norms)], config.rho)

    high, low = _split_factors(b, a, h, split_strategy, seed)
    bh, ah = high
    if prune_low:
        low = None

    steps = config.ste_steps if use_opt else 0
    if steps > 0:
        bh, ah = optimize_pairs(
            bh, ah, mode="rtn", bits=config.bits_high,
            group_size=config.group_size, steps=steps, lr=config.ste_lr)
        if low is not None:
            mode = "binary" if low_quantizer == "binary" else "rtn"
            low = optimize_pairs(
                low[0], low[1], mode=mode, bits=1,
                group_size=config.group_size, steps=steps, lr=config.ste_lr)

    qbh = rtn_quantize(bh, config.bits_high, config.group_size, axis=0)
    qah = rtn_quantize(ah, config.bits_high, config.group_size, axis=1)
    if low is None:
        qbl = qal = None
    elif low_quantizer == "binary":
        qbl = binary_quantize(low[0], config.group_size, axis=0)
        qal = binary_quantize(low[1], config.group_size, axis=1)
    else:  # 1-bit RTN — the paper's Fig. 3 shows this collapses like pruning
        qbl = rtn_quantize(low[0], 1, config.group_size, axis=0)
        qal = rtn_quantize(low[1], 1, config.group_size, axis=1)
    return QuantizedLoRA(b_high=qbh, a_high=qah, b_low=qbl, a_low=qal, h=h,
                         rank=r, config=config)
