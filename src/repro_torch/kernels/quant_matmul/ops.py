"""Packed-adapter layouts and the apply wrapper of the serving path (port
of ``repro/kernels/quant_matmul/ops.py``).

:class:`PackedLoRABatch` stacks many adapters' LoRAQuant codes for one
LoRA-linear path in the kernel layout; :func:`sgmv_apply_packed` applies a
heterogeneous batch of them straight from the codes through the
``sgmv_fused`` kernel.

Not ported yet: ``lora_apply_quantized`` / ``fused_lora`` and the two-pass
wrappers (ROADMAP B3-B5), ``PackedLoRABuckets`` for mixed recipes (A4). The
JAX package's TPU VMEM guard has no counterpart here: the CUDA wrapper
checks its own shared-memory limit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.core.loraquant import QuantizedLoRA
from repro_torch.core.quant import QuantizedTensor

from .kernel import sgmv_fused

SUBLANE = 8              # rank rows are padded to a multiple of this
TILE_CAP = 2048          # max feature tile considered by _pick_tile


def _pick_tile(n: int, group: int, cap: int = TILE_CAP) -> int:
    """Largest tile ≤ cap that divides ``n`` and is a multiple of the quant
    group size ``group`` (e.g. K = 2112 with 64-wide groups → 704)."""
    if n <= cap:
        return n
    if group <= 0 or n % group:
        raise ValueError(f"feature dim {n} is not a multiple of group {group}")
    ng = n // group
    for t in range(min(cap // group, ng), 0, -1):
        if ng % t == 0:
            return t * group
    return group


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    if rows == t.shape[0]:
        return t
    return torch.cat([t, t.new_zeros((rows - t.shape[0],) + t.shape[1:])])


def _kernel_layout(q: QuantizedTensor, pad_r: Optional[int] = None):
    """QuantizedTensor → ``(codes (Rp, NG·Wg), scale (Rp, NG),
    zero (Rp, NG), R)``. Column-grouped B factors are the same buffers
    viewed as Bᵀ. Rows are zero-padded to ``pad_r`` (default: the next
    multiple of 8); zero-scale rows dequantize to 0."""
    r = q.scale.shape[0]
    rp = pad_r or (-(-r // SUBLANE) * SUBLANE)
    codes = _pad_rows(q.codes.reshape(r, -1), rp)
    return codes, _pad_rows(q.scale, rp), _pad_rows(q.zero, rp), r


@dataclasses.dataclass(frozen=True)
class PackedLoRABatch:
    """One LoRA-linear path, packed for heterogeneous multi-adapter serving.

    Arrays are ``(L, NA·fold, Rp, ·)`` as stacked for the model's layers and
    ``(NA·fold, Rp, ·)`` for one layer (what :func:`sgmv_apply_packed`
    consumes; :meth:`layer` slices). Every adapter's high rows occupy
    ``[0, h)`` and low rows ``[0, r − h)`` of their side, with zero-scale
    padding above, which is what lets adapters with different split indices
    share one stack. The binary low side always exists (all-zero when
    ``h == r``). ``seg`` is the per-token-row adapter index, attached late
    by the model, so the packed codes stay batch-independent.
    """

    ah_codes: torch.Tensor
    ah_scale: torch.Tensor
    ah_zero: torch.Tensor
    bh_codes: torch.Tensor
    bh_scale: torch.Tensor
    bh_zero: torch.Tensor
    al_codes: torch.Tensor
    al_scale: torch.Tensor
    al_zero: torch.Tensor
    bl_codes: torch.Tensor
    bl_scale: torch.Tensor
    bl_zero: torch.Tensor
    seg: Optional[torch.Tensor]
    bits_hi: int
    group_ah: int
    group_bh: int
    group_al: int
    group_bl: int
    k: int
    m: int
    rank: int
    tile_t: int
    fold: int = 1

    def layer(self, i: int) -> "PackedLoRABatch":
        """The per-layer view ``(NA·fold, Rp, ·)`` of stacked layer ``i``."""
        return dataclasses.replace(
            self, **{f: getattr(self, f)[i] for f in _PACKED_ARRAY_FIELDS})

    def nbytes(self) -> int:
        return sum(getattr(self, f).nbytes for f in _PACKED_ARRAY_FIELDS)


_PACKED_ARRAY_FIELDS = (
    "ah_codes", "ah_scale", "ah_zero", "bh_codes", "bh_scale", "bh_zero",
    "al_codes", "al_scale", "al_zero", "bl_codes", "bl_scale", "bl_zero",
)


def _zero_side(rp: int, dim: int, group: int, device):
    """All-zero binary-side layout for layers with ``h == r``: the shapes
    :func:`_kernel_layout` gives a real 1-bit tensor of ``rp`` rows over
    ``dim`` features (zero scales dequantize to 0)."""
    g = min(group, dim)
    ng = -(-dim // g)
    wpg = -(-g // 8)
    return (torch.zeros((rp, ng * wpg), dtype=torch.uint8, device=device),
            torch.zeros((rp, ng), dtype=torch.float32, device=device),
            torch.zeros((rp, ng), dtype=torch.int32, device=device))


def pack_adapter_layers(qls: Sequence[QuantizedLoRA],
                        fold: int = 1) -> PackedLoRABatch:
    """Stack one adapter's per-layer :class:`QuantizedLoRA` list into the
    ``(L, Rp, ·)`` kernel layout (``(L, fold, Rp, ·)`` when each layer has
    ``fold`` sub-entries in row-major order). All layers must share shapes
    and quant config."""
    if not qls:
        raise ValueError("cannot pack an empty layer list")
    if fold < 1 or len(qls) % fold:
        raise ValueError(f"entry count {len(qls)} must be a multiple of "
                         f"fold {fold}")
    q0 = qls[0]
    r = q0.rank
    rp = -(-r // SUBLANE) * SUBLANE
    k = q0.a_high.orig_shape[1]
    m = q0.b_high.orig_shape[0]
    bits = q0.a_high.bits
    group = q0.config.group_size
    device = q0.a_high.codes.device
    sides = {name: [] for name in ("ah", "bh", "al", "bl")}
    for q in qls:
        if (q.rank, q.a_high.orig_shape[1], q.b_high.orig_shape[0],
                q.a_high.bits) != (r, k, m, bits):
            raise ValueError("pack_adapter_layers needs uniform layer shapes "
                             "and quant config")
        sides["ah"].append(_kernel_layout(q.a_high, pad_r=rp)[:3])
        sides["bh"].append(_kernel_layout(q.b_high, pad_r=rp)[:3])
        if q.a_low is not None:
            sides["al"].append(_kernel_layout(q.a_low, pad_r=rp)[:3])
            sides["bl"].append(_kernel_layout(q.b_low, pad_r=rp)[:3])
        else:
            sides["al"].append(_zero_side(rp, k, group, device))
            sides["bl"].append(_zero_side(rp, m, group, device))

    def _stack(layers, i):
        arr = torch.stack([layer[i] for layer in layers])
        if fold > 1:                     # (L·fold, Rp, ·) → (L, fold, Rp, ·)
            arr = arr.reshape((arr.shape[0] // fold, fold) + arr.shape[1:])
        return arr

    stacked = {name: [_stack(layers, i) for i in range(3)]
               for name, layers in sides.items()}
    return PackedLoRABatch(
        *stacked["ah"], *stacked["bh"], *stacked["al"], *stacked["bl"],
        seg=None, bits_hi=bits,
        group_ah=q0.a_high.group_size, group_bh=q0.b_high.group_size,
        group_al=min(group, k), group_bl=min(group, m),
        k=k, m=m, rank=r, tile_t=1, fold=fold,
    )


def stack_packed_adapters(entries: Sequence[PackedLoRABatch],
                          tile_t: int = 8) -> PackedLoRABatch:
    """Stack per-adapter packed entries (``(L, Rp, ·)`` or
    ``(L, fold, Rp, ·)``) along a new adapter axis → ``(L, NA·fold, Rp, ·)``.
    Adapters must share shapes and quant config."""
    e0 = entries[0]
    for e in entries[1:]:
        if (e.bits_hi, e.k, e.m, e.rank, e.group_ah, e.group_bh, e.fold) != (
                e0.bits_hi, e0.k, e0.m, e0.rank, e0.group_ah, e0.group_bh,
                e0.fold):
            raise ValueError(
                "heterogeneous batches require adapters with one shape and "
                "quant config; re-register through a single AdapterStore")

    def _stack(f):
        arr = torch.stack([getattr(e, f) for e in entries], dim=1)
        if e0.fold > 1:            # (L, NA, fold, Rp, ·) → (L, NA·fold, Rp, ·)
            arr = arr.reshape(arr.shape[:1] + (-1,) + arr.shape[3:])
        return arr

    arrays = {f: _stack(f) for f in _PACKED_ARRAY_FIELDS}
    return dataclasses.replace(e0, **arrays, tile_t=tile_t)


def retile_packed(tree, tile_t: int):
    """A copy of a packed lora tree with every leaf's token-tile size
    replaced (prefill tiles whole padded prompts, decode one row each)."""
    if isinstance(tree, PackedLoRABatch):
        return dataclasses.replace(tree, tile_t=tile_t)
    if isinstance(tree, dict):
        return {k: retile_packed(v, tile_t) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(retile_packed(v, tile_t) for v in tree)
    return tree


def sgmv_apply_packed(x: torch.Tensor, pb: PackedLoRABatch, *,
                      scaling: float = 1.0) -> torch.Tensor:
    """Heterogeneous multi-adapter LoRA apply straight from packed codes.

    ``x`` is ``(T_rows, K)``, ``pb`` in its per-layer ``(NA, Rp, ·)`` form
    with ``pb.seg`` the per-row adapter index; the ``pb.tile_t`` rows of a
    tile must share one adapter (the engine pads prompts to a tile
    multiple). Both sub-LoRAs are applied in one ``sgmv_fused`` launch."""
    if pb.seg is None:
        raise ValueError("PackedLoRABatch has no segment ids attached; "
                         "serve through MultiLoRAEngine (or set lora['seg'])")
    t, k = x.shape
    if k != pb.k:
        raise ValueError(f"x features {k} != packed adapter K {pb.k}")
    if t % pb.tile_t or t != pb.seg.shape[0]:
        raise ValueError(
            f"rows {t} must equal len(seg) {pb.seg.shape[0]} and divide into "
            f"tiles of {pb.tile_t}")
    seg_tiles = pb.seg[:: pb.tile_t].to(torch.int32).contiguous()
    y = sgmv_fused(
        x.contiguous(), pb.ah_codes, pb.ah_scale, pb.ah_zero,
        pb.bh_codes, pb.bh_scale, pb.bh_zero, seg_tiles,
        bits_a=pb.bits_hi, binary_a=False, group_a=pb.group_ah,
        bits_b=pb.bits_hi, binary_b=False, group_b=pb.group_bh,
        a_lo=(pb.al_codes, pb.al_scale, pb.al_zero),
        b_lo=(pb.bl_codes, pb.bl_scale, pb.bl_zero),
        bits_lo=1, binary_lo=True,
        group_al=pb.group_al, group_bl=pb.group_bl,
        m=pb.m, tile_t=pb.tile_t)
    return (scaling * y).to(x.dtype)
