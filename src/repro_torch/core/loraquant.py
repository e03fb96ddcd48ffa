"""LoRAQuant pipeline (paper Alg. 1) and the quantized-adapter container
(port of ``repro/core/loraquant.py``).

``quantize_lora`` takes one adapter ``(B, A)``: SVD-reparameterize, pick
``h`` from the variance-coverage ratio ρ, refine every singular pair
against its quantizer, then store ``B_h, A_h`` as RTN at ``bits_high`` and
``B_l, A_l`` as 1-bit signs. ``B'`` is quantized column-wise and ``A'``
row-wise (paper App. B).

``fit_recipe`` / ``LoRAQuantConfig.for_budget`` are not ported yet (ROADMAP
A3).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .quant import (GROUP_SIZE_DEFAULT, QuantizedTensor, binary_quantize,
                    rtn_quantize, storage_bits)
from .ste import als_refine_pairs, optimize_pairs
from .svd_split import select_h, split_at, svd_reparam, svd_reparam_stack

__all__ = [
    "LoRAQuantConfig",
    "QuantRecipe",
    "QuantizedLoRA",
    "quantize_lora",
    "quantize_lora_stack",
    "quantize_lora_stacks",
    "dequantize_lora",
]


@dataclasses.dataclass(frozen=True)
class LoRAQuantConfig:
    """Hyperparameters of the method; doubles as the per-adapter
    quantization recipe (:data:`QuantRecipe`)."""

    rho: float = 0.9               # variance-coverage ratio (Eq. 5)
    bits_high: int = 2             # RTN bitwidth for the important sub-LoRA
    bits_low: int = 1              # sign binarization for the rest
    group_size: int = GROUP_SIZE_DEFAULT
    ste_steps: int = 100           # Alg. 2 iterations
    ste_lr: float = 1e-4           # RMS-relative Adam step (see core/ste.py)
    refine: str = "ste"            # "ste" | "als" | "none"

    @property
    def variant_name(self) -> str:
        return f"loraquant({self.bits_high}@{self.rho:g})"

    @property
    def layout_signature(self) -> tuple:
        """What fixes the packed storage layout: RTN width, group size,
        low-side width. Adapters share one SGMV stack iff these match."""
        return (self.bits_high, self.group_size, self.bits_low)


QuantRecipe = LoRAQuantConfig


@dataclasses.dataclass(frozen=True)
class QuantizedLoRA:
    """One adapter after LoRAQuant. ``b_low/a_low`` are ``None`` iff h == r."""

    b_high: QuantizedTensor
    a_high: QuantizedTensor
    b_low: Optional[QuantizedTensor]
    a_low: Optional[QuantizedTensor]
    h: int
    rank: int
    config: LoRAQuantConfig

    def materialize(self):
        """Dequantized full-rank factors ``(B'', A'')``, ``B''A'' ≈ BA``."""
        b = self.b_high.dequantize()
        a = self.a_high.dequantize()
        if self.b_low is not None:
            b = torch.cat([b, self.b_low.dequantize()], dim=-1)
            a = torch.cat([a, self.a_low.dequantize()], dim=-2)
        return b, a

    def delta_w(self) -> torch.Tensor:
        b, a = self.materialize()
        return b @ a

    def total_bits(self) -> int:
        bits = storage_bits(self.b_high) + storage_bits(self.a_high)
        if self.b_low is not None:
            bits += storage_bits(self.b_low) + storage_bits(self.a_low)
        return bits

    def num_params(self) -> int:
        m = self.b_high.orig_shape[0]
        n = self.a_high.orig_shape[1]
        return self.rank * (m + n)

    def avg_bits(self) -> float:
        return self.total_bits() / self.num_params()

    def index(self, i) -> "QuantizedLoRA":
        """Entry ``i`` of a layer-batched result."""
        lo = (None if self.b_low is None
              else (self.b_low.index(i), self.a_low.index(i)))
        return dataclasses.replace(
            self, b_high=self.b_high.index(i), a_high=self.a_high.index(i),
            b_low=lo and lo[0], a_low=lo and lo[1])


def _refine(bh, ah, low, config: LoRAQuantConfig):
    """Pair refinement: paper STE (Alg. 2), beyond-paper ALS, or none."""
    if config.refine == "none" or config.ste_steps <= 0:
        return bh, ah, low
    if config.refine == "als":
        bh, ah = als_refine_pairs(bh, ah, mode="rtn", bits=config.bits_high,
                                  group_size=config.group_size)
        if low is not None:
            low = als_refine_pairs(low[0], low[1], mode="binary", bits=1,
                                   group_size=config.group_size)
        return bh, ah, low
    if config.refine != "ste":
        raise ValueError(f"unknown refine mode {config.refine!r}")
    bh, ah = optimize_pairs(bh, ah, mode="rtn", bits=config.bits_high,
                            group_size=config.group_size,
                            steps=config.ste_steps, lr=config.ste_lr)
    if low is not None:
        low = optimize_pairs(low[0], low[1], mode="binary", bits=1,
                             group_size=config.group_size,
                             steps=config.ste_steps, lr=config.ste_lr)
    return bh, ah, low


def _quantize_split(bh, ah, low, h: int, r: int,
                    config: LoRAQuantConfig) -> QuantizedLoRA:
    """Refine + storage-quantize one split (optionally layer-batched)."""
    bh, ah, low = _refine(bh, ah, low, config)
    qbh = rtn_quantize(bh, config.bits_high, config.group_size, axis=0)
    qah = rtn_quantize(ah, config.bits_high, config.group_size, axis=1)
    if low is not None:
        qbl = binary_quantize(low[0], config.group_size, axis=0)
        qal = binary_quantize(low[1], config.group_size, axis=1)
    else:
        qbl = qal = None
    return QuantizedLoRA(b_high=qbh, a_high=qah, b_low=qbl, a_low=qal,
                         h=h, rank=r, config=config)


def quantize_lora(b: torch.Tensor, a: torch.Tensor,
                  config: LoRAQuantConfig = LoRAQuantConfig()
                  ) -> QuantizedLoRA:
    """Paper Alg. 1: QUANTIZELORA(B, A, ρ, bits_high, bits_low, T, η)."""
    rep = svd_reparam(b, a)
    r = int(rep.s.shape[-1])
    h = select_h(rep.s, config.rho)
    (bh, ah), low = split_at(rep, h)
    return _quantize_split(bh, ah, low, h, r, config)


def dequantize_lora(q: QuantizedLoRA):
    return q.materialize()


def quantize_lora_stack(b_stack: torch.Tensor, a_stack: torch.Tensor,
                        config: LoRAQuantConfig = LoRAQuantConfig()) -> list:
    """Alg. 1 over a layer stack ``(L, m, r)``, ``(L, r, n)``: one batched
    SVD for all layers, ``h`` per layer on the host, then one batched
    refine + quantize per distinct ``h``. Returns ``L`` entries in layer
    order; the math per layer is :func:`quantize_lora`'s."""
    L = int(b_stack.shape[0])
    if L == 0:
        return []
    rep = svd_reparam_stack(b_stack, a_stack)
    r = int(rep.s.shape[-1])
    s_host = rep.s.detach().cpu().numpy()
    hs = [select_h(s_host[i], config.rho) for i in range(L)]
    out: list = [None] * L
    for h in sorted(set(hs)):
        idx = [i for i in range(L) if hs[i] == h]
        sel = torch.as_tensor(idx, device=rep.s.device)
        bp, ap = rep.b_prime[sel], rep.a_prime[sel]
        low = None if h >= r else (bp[:, :, h:], ap[:, h:, :])
        stacked = _quantize_split(bp[:, :, :h], ap[:, :h, :], low, h, r,
                                  config)
        for pos, i in enumerate(idx):
            out[i] = stacked.index(pos)
    return out


def quantize_lora_stacks(stacks: list,
                         config: LoRAQuantConfig = LoRAQuantConfig()) -> list:
    """Shape-bucketed :func:`quantize_lora_stack` over many layer stacks
    ``[(b (Li, m, r), a (Li, r, n)), ...]``, possibly from different
    adapters: same-shape stacks are concatenated and run as one. Returns one
    ``QuantizedLoRA`` list per input stack, in input order."""
    out: list = [None] * len(stacks)
    buckets: Dict[tuple, list] = {}
    for i, (b, a) in enumerate(stacks):
        buckets.setdefault((tuple(b.shape[1:]), tuple(a.shape[1:])),
                           []).append(i)
    for idx in buckets.values():
        if len(idx) == 1:
            b_cat, a_cat = stacks[idx[0]]
        else:
            b_cat = torch.cat([stacks[i][0] for i in idx])
            a_cat = torch.cat([stacks[i][1] for i in idx])
        qls = quantize_lora_stack(b_cat, a_cat, config)
        off = 0
        for i in idx:
            n = int(stacks[i][0].shape[0])
            out[i] = qls[off:off + n]
            off += n
    return out
