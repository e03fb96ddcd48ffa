"""LoRAQuant pipeline (paper Alg. 1) and the quantized-adapter container
(port of ``repro/core/loraquant.py``).

``quantize_lora`` takes one adapter ``(B, A)``: SVD-reparameterize, pick
``h`` from the variance-coverage ratio ρ, refine every singular pair
against its quantizer, then store ``B_h, A_h`` as RTN at ``bits_high`` and
``B_l, A_l`` as 1-bit signs. ``B'`` is quantized column-wise and ``A'``
row-wise (paper App. B).

``fit_recipe`` / ``LoRAQuantConfig.for_budget`` fit ``(bits_high, rho)``
to an average-bits budget from the adapters' singular values alone.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .quant import (GROUP_SIZE_DEFAULT, SCALE_BITS, QuantizedTensor,
                    binary_quantize, rtn_quantize, storage_bits)
from .ste import als_refine_pairs, optimize_pairs
from .svd_split import select_h, split_at, svd_reparam, svd_reparam_stack

__all__ = [
    "LoRAQuantConfig",
    "QuantRecipe",
    "QuantizedLoRA",
    "quantize_lora",
    "quantize_lora_stack",
    "quantize_lora_stacks",
    "quantize_lora_pairs",
    "quantize_adapter_set",
    "adapter_avg_bits",
    "fit_recipe",
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

    @classmethod
    def for_budget(cls, adapters, target_avg_bits: float,
                   **overrides) -> "LoRAQuantConfig":
        """Fit a recipe to an average-bits budget for a concrete adapter
        (:func:`fit_recipe` with this class's defaults as the base)."""
        return fit_recipe(adapters, target_avg_bits, base=cls(**overrides))


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


def quantize_lora_pairs(pairs: list,
                        config: LoRAQuantConfig = LoRAQuantConfig()) -> list:
    """:func:`quantize_lora_stacks` for loose 2-D ``(B, A)`` pairs: each
    pair is a length-1 stack; same-shape pairs land in one bucket. Returns
    ``QuantizedLoRA`` results in input order."""
    stacks = [(torch.as_tensor(b)[None], torch.as_tensor(a)[None])
              for b, a in pairs]
    return [qs[0] for qs in quantize_lora_stacks(stacks, config)]


def quantize_adapter_set(adapters: Dict[str, tuple],
                         config: LoRAQuantConfig = LoRAQuantConfig()
                         ) -> Dict[str, QuantizedLoRA]:
    """Quantize every adapter of a model: layer name → ``(B, A)``. Adapters
    are independent (no cross-adapter state)."""
    return {k: quantize_lora(b, a, config) for k, (b, a) in adapters.items()}


def adapter_avg_bits(qset: Dict[str, QuantizedLoRA]) -> float:
    """Paper Eq. 10 over a whole adapter set (all layers)."""
    total_bits = sum(q.total_bits() for q in qset.values())
    total_params = sum(q.num_params() for q in qset.values())
    return total_bits / max(total_params, 1)


# --------------------------------------------------------------------------
# budget-fitted recipes (AvgBits as a serving API)
# --------------------------------------------------------------------------

def _collect_ab_pairs(adapters) -> list:
    """Every supported adapter description as a flat list of 2-D
    ``(B (m, r), A (r, n))`` tensors: a LoRA tree (nested dicts / lists
    with ``{'a', 'b'}`` leaves; layer stacks ``(L, ..., r, in)`` flattened
    to per-layer pairs), a list of loose ``(B, A)`` pairs, or one pair."""
    if isinstance(adapters, tuple) and len(adapters) == 2 and not isinstance(
            adapters[0], (dict, list, tuple)):
        adapters = [adapters]
    if isinstance(adapters, (dict, list)) and not (
            isinstance(adapters, dict) and set(adapters.keys()) == {"a", "b"}):
        leaves = []

        def walk(node):
            if isinstance(node, dict):
                if set(node.keys()) == {"a", "b"}:
                    leaves.append(node)
                    return
                for v in node.values():
                    walk(v)
            elif isinstance(node, (list, tuple)):
                for v in node:
                    walk(v)

        walk(adapters)
        if leaves:
            pairs = []
            for leaf in leaves:
                a = torch.as_tensor(leaf["a"])
                b = torch.as_tensor(leaf["b"])
                a2 = a.reshape((-1,) + tuple(a.shape[-2:]))
                b2 = b.reshape((-1,) + tuple(b.shape[-2:]))
                pairs.extend((b2[i], a2[i]) for i in range(a2.shape[0]))
            return pairs
    return [(torch.as_tensor(b), torch.as_tensor(a)) for b, a in adapters]


def _stack_singular_values(pairs) -> list:
    """Per-pair singular values of ``B A`` (float64 numpy), shape-bucketed
    so each distinct ``(B, A)`` shape costs one batched SVD."""
    out: list = [None] * len(pairs)
    buckets: Dict[tuple, list] = {}
    for i, (b, a) in enumerate(pairs):
        buckets.setdefault((tuple(b.shape), tuple(a.shape)), []).append(i)
    for idx in buckets.values():
        b_cat = torch.stack([pairs[i][0] for i in idx])
        a_cat = torch.stack([pairs[i][1] for i in idx])
        s = svd_reparam_stack(b_cat, a_cat).s.detach().cpu().numpy()
        for pos, i in enumerate(idx):
            out[i] = s[pos]
    return out


def _pair_bit_costs(m: int, n: int, r: int, bits_high: int,
                    group_size: int) -> Tuple[int, int, int]:
    """Storage bits charged per high / low singular pair of an ``(m, r) x
    (r, n)`` adapter, as :func:`~repro_torch.core.quant.storage_bits`
    counts them: ``bits`` per weight + a 16-bit scale per group (+ a
    ``bits``-wide zero-point per RTN group). Returns ``(bits_per_high_pair,
    bits_per_low_pair, denom_params)``; ``total_bits(h) = h·hi +
    (r_eff - h)·lo``."""
    g_m = min(group_size, m)
    g_n = min(group_size, n)
    groups = -(-m // g_m) + -(-n // g_n)      # B column-groups + A row-groups
    hi = (m + n) * bits_high + groups * (SCALE_BITS + bits_high)
    lo = (m + n) * 1 + groups * SCALE_BITS    # binary: no zero-point
    return hi, lo, r * (m + n)


def fit_recipe(adapters, target_avg_bits: float, *,
               base: Optional[LoRAQuantConfig] = None,
               bits_high_choices: Tuple[int, ...] = (2, 3, 4),
               rho_resolution: int = 512) -> LoRAQuantConfig:
    """Search ``(bits_high, rho)`` for the recipe whose achieved AvgBits
    (paper Eq. 10, scale and zero-point overhead included) lands closest to
    ``target_avg_bits`` on a concrete adapter.

    Only the adapters' singular values are needed (one batched SVD per
    distinct leaf shape): for every candidate ``rho`` on a dense grid the
    per-layer split ``h`` follows from Eq. 5 and the storage bits follow
    from the shapes, so no candidate is quantized. ``adapters`` is a LoRA
    tree, a list of ``(B, A)`` pairs or one pair; ``base`` supplies every
    field not searched. Returns ``dataclasses.replace(base, bits_high=·,
    rho=·)``.
    """
    base = base if base is not None else LoRAQuantConfig()
    pairs = _collect_ab_pairs(adapters)
    if not pairs:
        raise ValueError("fit_recipe needs at least one (B, A) pair")
    svals = _stack_singular_values(pairs)

    grid = np.linspace(1e-6, 1.0, rho_resolution)
    total_params = 0
    total_bits = np.zeros((len(bits_high_choices), grid.size))
    for (b, a), s in zip(pairs, svals):
        m = b.shape[0]
        n = a.shape[1]
        r_eff = int(s.shape[0])
        var = np.asarray(s, np.float64) ** 2
        tot = var.sum()
        if tot <= 0.0:
            hs = np.ones(grid.size, np.int64)
        else:
            frac = np.cumsum(var) / tot
            hs = np.searchsorted(frac, grid - 1e-12) + 1
            hs = np.clip(hs, 1, r_eff)
        for bi, bits in enumerate(bits_high_choices):
            hi, lo, _ = _pair_bit_costs(m, n, r_eff, bits, base.group_size)
            total_bits[bi] += hs * hi + (r_eff - hs) * lo
        total_params += r_eff * (m + n)

    avg = total_bits / max(total_params, 1)
    err = np.abs(avg - target_avg_bits)
    bi, gi = np.unravel_index(np.argmin(err), err.shape)
    return dataclasses.replace(base, bits_high=int(bits_high_choices[bi]),
                               rho=float(grid[gi]))
