"""Packed-adapter layouts and the apply wrappers of the serving path (port
of ``repro/kernels/quant_matmul/ops.py``).

* :func:`lora_apply_quantized` applies one :class:`QuantizedLoRA` (one
  adapter for the whole batch) straight from its packed codes: one
  ``fused_lora`` launch, or the two-pass ``matmul_rhs`` + ``matmul_out``
  per sub-LoRA when ``fused=False`` or the fused kernel's estimated
  footprint exceeds the budget. :func:`quant_matmul_rhs` is the first pass
  alone.
* :func:`sgmv_apply` applies a heterogeneous batch of per-adapter factors
  (one token tile, one adapter): one ``sgmv_fused`` launch, or
  ``sgmv_rhs`` + ``sgmv_out`` when ``fused=False``.
* :class:`PackedLoRABatch` stacks many adapters' codes for one LoRA-linear
  path; :func:`sgmv_apply_packed` applies a heterogeneous batch of them
  through the ``sgmv_fused`` kernel. :class:`PackedLoRABuckets` holds one
  such stack per packed-layout signature (mixed recipes);
  :func:`sgmv_apply_buckets` runs one ``sgmv_fused`` per bucket.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Optional, Sequence

import torch

from repro_torch.core.loraquant import QuantizedLoRA
from repro_torch.core.quant import QuantizedTensor

from .kernel import (fused_lora, matmul_out, matmul_rhs, sgmv_fused,
                     sgmv_out, sgmv_rhs)

SUBLANE = 8              # rank rows are padded to a multiple of this
TILE_CAP = 2048          # max feature tile considered by _pick_tile

# The JAX API's rule for choosing the fused kernel or the two-pass path:
# the fused TPU kernel's per-step VMEM footprint (_fused_vmem_estimate)
# against a 12 MiB budget. The port keeps the estimate and the budget as
# they are, so that it picks the same kernels as the reference for the same
# inputs; the CUDA kernels check their own shared-memory limits and raise.
FUSED_VMEM_BUDGET = 12 << 20


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
    """Zero rows appended along dim -2 up to ``rows``."""
    if rows == t.shape[-2]:
        return t
    pad = t.new_zeros(t.shape[:-2] + (rows - t.shape[-2], t.shape[-1]))
    return torch.cat([t, pad], dim=-2)


def _kernel_layout(q: QuantizedTensor, pad_r: Optional[int] = None):
    """QuantizedTensor → ``(codes (…, Rp, NG·Wg), scale (…, Rp, NG),
    zero (…, Rp, NG), R)``, any leading (layer) axes kept. Column-grouped B
    factors are the same buffers viewed as Bᵀ. Rows are zero-padded to
    ``pad_r`` (default: the next multiple of 8); zero-scale rows dequantize
    to 0."""
    lead = tuple(q.scale.shape[:-1])
    r = lead[-1]
    rp = pad_r or (-(-r // SUBLANE) * SUBLANE)
    codes = _pad_rows(q.codes.reshape(*lead, -1), rp)
    return codes, _pad_rows(q.scale, rp), _pad_rows(q.zero, rp), r


def _sides_of(qlora: QuantizedLoRA) -> tuple:
    return (qlora.a_high, qlora.b_high, qlora.a_low, qlora.b_low)


# The kernel layouts of QuantizedLoRA leaves, keyed by ``id(leaf)`` and
# dropped with the leaf: ``(sides, layers)``, the ``(codes, scale, zero)``
# of A_hi, B_hi, A_lo, B_lo (None for an absent low side) and, for a
# layer-stacked leaf, its per-layer entries by index. A leaf served step
# after step is padded once (the reference pads inside every jitted call).
_LAYOUTS: dict = {}


def _layout_entry(qlora: QuantizedLoRA, sides: Optional[tuple] = None):
    key = id(qlora)
    entry = _LAYOUTS.get(key)
    if entry is None:
        if sides is None:
            sides = tuple(None if q is None else _kernel_layout(q)[:3]
                          for q in _sides_of(qlora))
        entry = _LAYOUTS[key] = (sides, {})
        weakref.finalize(qlora, _LAYOUTS.pop, key, None)
    return entry


def _qlora_layout(qlora: QuantizedLoRA) -> tuple:
    """The kernel layouts ``(codes, scale, zero)`` of ``(A_hi, B_hi, A_lo,
    B_lo)``, built once per leaf; a layer-stacked leaf's are ``(L, …)``."""
    return _layout_entry(qlora)[0]


def qlora_layer(qlora: QuantizedLoRA, i: int) -> QuantizedLoRA:
    """Entry ``i`` of a layer-stacked :class:`QuantizedLoRA`, the same
    object on every call, whose kernel layouts are layer ``i`` of the
    stacked leaf's (views, no copy)."""
    sides, layers = _layout_entry(qlora)
    if i not in layers:
        layer = qlora.index(i)
        _layout_entry(layer, tuple(
            None if side is None else tuple(t[i] for t in side)
            for side in sides))
        layers[i] = layer
    return layers[i]


def _fused_vmem_estimate(qlora: QuantizedLoRA, tile_t: int,
                         tile_k: int) -> int:
    """Bytes the fused TPU kernel keeps VMEM-resident in one grid step: the
    x and A-side K tiles, the full packed B factors plus their fp32
    dequantized forms, the ``(tile_t, M)`` output tile and the fp32 h
    scratch (the reference's estimate, unchanged)."""
    k = qlora.a_high.orig_shape[1]
    m = qlora.b_high.orig_shape[0]
    a_sides = [qlora.a_high] + ([qlora.a_low] if qlora.a_low is not None
                                else [])
    b_sides = [qlora.b_high] + ([qlora.b_low] if qlora.b_low is not None
                                else [])

    def packed_bytes(q):
        return (q.codes.numel() * q.codes.element_size()
                + q.scale.numel() * 4 + q.zero.numel() * 4)

    est = tile_t * tile_k * 4 + tile_t * m * 4        # x tile + output tile
    for q in a_sides:
        est += packed_bytes(q) * tile_k // max(k, 1)  # A-side K tile
        est += tile_t * q.scale.shape[0] * 4          # h scratch row
    for q in b_sides:
        est += packed_bytes(q)                        # full packed B
        est += q.scale.shape[0] * m * 4               # dequantized B (fp32)
    return est


def _pad_tokens(x: torch.Tensor, tile_t: int):
    """Zero rows up to a multiple of ``tile_t``; returns ``(x, T)``."""
    t = x.shape[0]
    return _pad_rows(x, -(-t // tile_t) * tile_t), t


def quant_matmul_rhs(x: torch.Tensor, codes: torch.Tensor,
                     scale: torch.Tensor, zero: torch.Tensor, *, bits: int,
                     binary: bool) -> torch.Tensor:
    """``x @ dequant(A)ᵀ`` from one packed factor in the kernel layout (the
    group size follows from the dense uint8 layout)."""
    return matmul_rhs(x, codes, scale, zero, bits=bits, binary=binary)


def _side(x: torch.Tensor, q: QuantizedTensor, layout) -> torch.Tensor:
    return matmul_rhs(x, *layout, bits=q.bits, binary=q.mode == "binary",
                      group=q.group_size)


def _quant_m(q: QuantizedTensor) -> int:
    """Logical output width of a B factor, whether stored column-grouped
    ``(M, R)`` (axis=0) or as the transposed row-grouped ``(R, M)`` view."""
    return q.orig_shape[0] if q.axis == 0 else q.orig_shape[1]


def _out_side(h: torch.Tensor, q: QuantizedTensor, layout) -> torch.Tensor:
    codes, scale, zero = layout
    if h.shape[1] != codes.shape[0]:
        h = torch.nn.functional.pad(h, (0, codes.shape[0] - h.shape[1]))
    y = matmul_out(h, codes, scale, zero, bits=q.bits,
                   binary=q.mode == "binary", group=q.group_size)
    return y[:, : _quant_m(q)]


def _fused_apply(x: torch.Tensor, qlora: QuantizedLoRA) -> torch.Tensor:
    """One ``fused_lora`` launch for both sub-LoRAs."""
    ah, bh = qlora.a_high, qlora.b_high
    kwargs = dict(m=bh.orig_shape[0],        # B is (M, R) column-grouped
                  bits_hi=ah.bits, binary_hi=ah.mode == "binary",
                  group_ah=ah.group_size, group_bh=bh.group_size)
    if qlora.a_low is not None:
        al, bl = qlora.a_low, qlora.b_low
        kwargs.update(bits_lo=al.bits, binary_lo=al.mode == "binary",
                      group_al=al.group_size, group_bl=bl.group_size)
    return fused_lora(x, *_qlora_layout(qlora), **kwargs)


def lora_apply_quantized(x: torch.Tensor, qlora: QuantizedLoRA, *,
                         scaling: float = 1.0, tile_t: int = 128,
                         fused: bool = True,
                         vmem_budget: Optional[int] = None) -> torch.Tensor:
    """Packed-LoRA application of one adapter: high (RTN) + low (binary)
    sub-LoRAs, ``≈ scaling · x @ qlora.delta_w().T`` in ``x``'s dtype.

    ``fused=True`` issues one ``fused_lora`` launch, unless
    :func:`_fused_vmem_estimate` at ``tile_t`` crosses ``vmem_budget``
    (default :data:`FUSED_VMEM_BUDGET`): then, as with ``fused=False``, the
    two-pass path runs ``matmul_rhs`` + ``matmul_out`` per sub-LoRA, ``h``
    passing through device memory. ``tile_t`` is the reference's token tile:
    x is zero-padded to a multiple of it.
    """
    xp, t = _pad_tokens(x, min(tile_t, max(x.shape[0], 1)))
    tt = min(tile_t, xp.shape[0])
    if fused:
        budget = FUSED_VMEM_BUDGET if vmem_budget is None else vmem_budget
        tk = _pick_tile(x.shape[1], qlora.a_high.group_size)
        if _fused_vmem_estimate(qlora, tt, tk) > budget:
            fused = False                 # large-M guard: two-pass fallback
    xp = xp.contiguous()
    if fused:
        y = _fused_apply(xp, qlora)
    else:
        lay = _qlora_layout(qlora)
        y = _out_side(_side(xp, qlora.a_high, lay[0]), qlora.b_high, lay[1])
        if qlora.a_low is not None:
            y = y + _out_side(_side(xp, qlora.a_low, lay[2]), qlora.b_low,
                              lay[3])
    return (scaling * y[:t]).to(x.dtype)


def stack_adapter_side(qs: Sequence[QuantizedTensor]):
    """Stack per-adapter QuantizedTensors (one shape and quant config) into
    the ``(NA, Rp, ·)`` kernel layout, rank rows padded to a multiple of 8."""
    parts = [_kernel_layout(q) for q in qs]
    return tuple(torch.stack([p[i] for p in parts]) for i in range(3))


def sgmv_apply(x: torch.Tensor, qas: Sequence[QuantizedTensor],
               qbts: Sequence[QuantizedTensor], seg_map: torch.Tensor, *,
               scaling: float = 1.0, tile_t: int = 8,
               fused: bool = True) -> torch.Tensor:
    """Heterogeneous multi-LoRA apply from per-adapter packed factors: A
    ``(R, K)`` row-grouped and Bᵀ ``(R, M)`` (or the column-grouped B);
    ``seg_map (T/tile_t,)`` int32 is the adapter of each tile of ``tile_t``
    rows (the caller pads segments to whole tiles). Returns
    ``scaling · y`` ``(T, M)`` in x's dtype.

    ``fused=True`` is one ``sgmv_fused`` launch for both products;
    ``fused=False`` the two-pass reference, ``sgmv_rhs`` then ``sgmv_out``,
    with ``h`` passing through device memory. Both give exactly M columns.
    (The reference's fused call leaves ``m`` unset and so returns B's
    group-padded width when M is not a multiple of the group, ROADMAP C6.)
    """
    a_codes, a_scale, a_zero = stack_adapter_side(qas)
    b_codes, b_scale, b_zero = stack_adapter_side(qbts)
    qa, qb = qas[0], qbts[0]
    x = x.contiguous()
    seg_map = seg_map.to(torch.int32).contiguous()
    m = _quant_m(qb)
    if fused:
        y = sgmv_fused(
            x, a_codes, a_scale, a_zero, b_codes, b_scale, b_zero, seg_map,
            bits_a=qa.bits, binary_a=qa.mode == "binary",
            group_a=qa.group_size, bits_b=qb.bits,
            binary_b=qb.mode == "binary", group_b=qb.group_size, m=m,
            tile_t=tile_t)
    else:
        h = sgmv_rhs(x, a_codes, a_scale, a_zero, seg_map, bits=qa.bits,
                     binary=qa.mode == "binary", group=qa.group_size,
                     tile_t=tile_t)
        y = sgmv_out(h, b_codes, b_scale, b_zero, seg_map, bits=qb.bits,
                     binary=qb.mode == "binary", group=qb.group_size, m=m,
                     tile_t=tile_t)
    return (scaling * y).to(x.dtype)


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
    if isinstance(tree, PackedLoRABuckets):
        return dataclasses.replace(tree, buckets=tuple(
            dataclasses.replace(b, tile_t=tile_t) for b in tree.buckets))
    if isinstance(tree, dict):
        return {k: retile_packed(v, tile_t) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(retile_packed(v, tile_t) for v in tree)
    return tree


@dataclasses.dataclass(frozen=True)
class PackedLoRABuckets:
    """A mixed-recipe multi-adapter batch for one LoRA-linear path: one
    :class:`PackedLoRABatch` per packed-layout signature (``bits_high``,
    group size, low width; ``LoRAQuantConfig.layout_signature``) and, per
    bucket, an int32 lookup from the batch-global adapter index to the
    bucket's local index (``-1``: the adapter is in another bucket).

    Token rows carry one global ``seg`` space; :func:`sgmv_apply_buckets`
    runs one ``sgmv_fused`` per bucket over all rows and masks the rows of
    other buckets out of the sum, which is exact because LoRA is linear. A
    uniform-recipe batch never builds this container. The buckets' arrays
    and the ``(L, NA_total)`` lookups carry the leading layer axis;
    :meth:`layer` slices them together.
    """

    buckets: tuple                  # of PackedLoRABatch (seg=None inside)
    lookups: tuple                  # of (L?, NA_total) int32, -1 = absent
    seg: Optional[torch.Tensor] = None

    @property
    def fold(self) -> int:
        return self.buckets[0].fold

    @property
    def tile_t(self) -> int:
        return self.buckets[0].tile_t

    def layer(self, i: int) -> "PackedLoRABuckets":
        """The per-layer view of stacked layer ``i``."""
        return dataclasses.replace(
            self, buckets=tuple(b.layer(i) for b in self.buckets),
            lookups=tuple(lut[i] for lut in self.lookups))

    def nbytes(self) -> int:
        return (sum(b.nbytes() for b in self.buckets)
                + sum(lut.nbytes for lut in self.lookups))


def sgmv_apply_buckets(x: torch.Tensor, pbs: PackedLoRABuckets, *,
                       scaling: float = 1.0) -> torch.Tensor:
    """Mixed-recipe heterogeneous LoRA apply: one ``sgmv_fused`` launch per
    layout bucket over all rows, each bucket's rows picked by its lookup of
    the per-row global ``pbs.seg`` (non-members gather local index 0 and
    are masked to zero), the bucket outputs summed in x's dtype. Every
    bucket launches, members or not, as in the reference."""
    if pbs.seg is None:
        raise ValueError("PackedLoRABuckets has no segment ids attached; "
                         "serve through MultiLoRAEngine (or set lora['seg'])")
    seg = pbs.seg.to(torch.int64)
    y = None
    for pb, lut in zip(pbs.buckets, pbs.lookups):
        local = lut[seg]
        member = local >= 0
        yb = sgmv_apply_packed(
            x, dataclasses.replace(pb, seg=local.clamp(min=0)),
            scaling=scaling)
        yb = torch.where(member[:, None], yb, torch.zeros_like(yb))
        y = yb if y is None else y + yb
    return y.to(x.dtype)


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
