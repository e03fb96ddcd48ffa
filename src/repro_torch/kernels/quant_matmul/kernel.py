"""Wrappers of the Hopper kernels that apply LoRAQuant packed codes (ports
of the Pallas kernels in ``repro/kernels/quant_matmul/kernel.py``):

* ``matmul_rhs`` — ``h = x·dequant(A)ᵀ`` (``csrc/matmul_rhs.cu``);
* ``matmul_out`` — ``y = h·dequant(Bᵀ)`` over B's group-padded width
  (``csrc/matmul_out.cu``);
* ``fused_lora`` — one adapter's ``(x·A_hiᵀ)·B_hi + (x·A_loᵀ)·B_lo`` in one
  launch (``csrc/fused_lora.cu``);
* ``sgmv_fused`` — the same per token tile with the tile's adapter
  (``csrc/sgmv_fused.cu``).

The kernels are CUDA C++, built by ``build.py`` at first use. On a CUDA
tensor a wrapper launches its kernel on the current stream (or raises); on a
CPU tensor it returns the plain PyTorch version from ``ref.py``. Both take
the same checks, so the CPU tests hold the layouts the card accepts.

``LAUNCH_COUNTS`` counts kernel launches by name, mirroring the JAX
package's counter: one per CUDA launch and nowhere else. ``PLAIN_CALLS``
counts the wrapper's CPU calls, so the CPU tests can check how often the
model reaches the wrapper.
"""

from __future__ import annotations

import collections
from typing import Optional

import torch

from .ref import fused_lora_ref, matmul_out_ref, matmul_rhs_ref, sgmv_fused_ref

LAUNCH_COUNTS: "collections.Counter[str]" = collections.Counter()
PLAIN_CALLS: "collections.Counter[str]" = collections.Counter()

MAX_TILE_ROWS = 8          # token rows one CUDA block holds (kMaxTileRows)
MAX_RANK_ROWS = 32         # Rp the CUDA block supports (kMaxThreads / 16)
MAX_SMEM_BYTES = 232448    # opt-in shared memory per block on Hopper
MAX_SLOTS = 64             # rank rows one block of the single-adapter
                           # kernels holds (loraquant::kMaxSlots)
BITS = (1, 2, 3, 4, 8)


def reset_launch_counts() -> None:
    LAUNCH_COUNTS.clear()
    PLAIN_CALLS.clear()


def _per_word(bits: int) -> int:
    return 10 if bits == 3 else 8 // bits


def _check_side(name, codes, scale, zero, lead, bits, group, dim):
    """Check one packed factor in the kernel layout: codes
    ``(*lead, NG·Wg)``, scale and zero ``(*lead, NG)``, whose ``NG`` groups of
    ``group`` cover ``dim`` features. Returns ``(NG, Wg)``."""
    want_dtype = torch.int32 if bits == 3 else torch.uint8
    nd = len(lead) + 1
    if codes.dim() != nd or tuple(codes.shape[:-1]) != tuple(lead):
        raise ValueError(f"{name} codes must be ({', '.join(map(str, lead))}"
                         f", words), got {tuple(codes.shape)}")
    if codes.dtype != want_dtype:
        raise ValueError(f"{name} codes of {bits}-bit must be {want_dtype}, "
                         f"got {codes.dtype}")
    ng = scale.shape[-1]
    if (scale.dim() != nd or tuple(scale.shape[:-1]) != tuple(lead)
            or scale.dtype != torch.float32):
        raise ValueError(f"{name} scale must be fp32 (*{tuple(lead)}, NG), "
                         f"got {scale.dtype} {tuple(scale.shape)}")
    if zero is not None and (tuple(zero.shape) != tuple(scale.shape)
                             or zero.dtype != torch.int32):
        raise ValueError(f"{name} zero must be int32 shaped like its scale, "
                         f"got {zero.dtype} {tuple(zero.shape)}")
    wpg = -(-group // _per_word(bits))
    if codes.shape[-1] != ng * wpg:
        raise ValueError(f"{name} codes hold {codes.shape[-1]} words, "
                         f"expected {ng} groups x {wpg} words")
    if not (ng - 1) * group < dim <= ng * group:
        raise ValueError(f"{name}: {ng} groups of {group} do not cover "
                         f"{dim} features")
    for t in (codes, scale) + ((zero,) if zero is not None else ()):
        if not t.is_contiguous():
            raise ValueError(f"{name} arrays must be contiguous")
    return ng, wpg


def _check_format(name, bits, binary):
    if bits not in BITS or (binary and bits != 1):
        raise ValueError(f"{name}: unsupported format bits={bits}, "
                         f"binary={binary}")


def _infer_group(codes, scale, bits: int, group: Optional[int]) -> int:
    """Dense uint8 widths carry exactly ``8/bits`` codes per word, so the
    group size follows from the word/group shape ratio; 3-bit int32 packing
    (10 codes a word, per-group padding) must pass ``group`` explicitly."""
    if group is not None:
        return group
    if bits == 3:
        raise ValueError("3-bit packing needs an explicit quant group size")
    return codes.shape[-1] // scale.shape[-1] * (8 // bits)


def _check_x(name, x, dtypes=(torch.bfloat16, torch.float32)):
    if x.dim() != 2 or x.dtype not in dtypes:
        raise ValueError(f"{name}: input must be 2-D "
                         f"{' or '.join(str(d)[6:] for d in dtypes)}, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")


def _device_of(name, tensors) -> torch.device:
    """The one device all operands share: ``cpu`` (plain version) or
    ``cuda`` (the kernel)."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name} operands must share one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, got {dev}")
    return dev


def _launch(name: str, dev: torch.device, fn, *args) -> None:
    """Call the C launcher ``fn(*args, stream)`` on the current stream of
    ``dev``; raise on a refused launch, else count it."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        from .build import load_library

        msg = load_library().quant_matmul_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")
    LAUNCH_COUNTS[name] += 1


def matmul_rhs(x, codes, scale, zero, *, bits: int, binary: bool,
               group: Optional[int] = None) -> torch.Tensor:
    """``x (T, K) @ dequant(A)ᵀ`` → ``(T, R)`` fp32 straight from one packed
    factor ``A`` (codes ``(R, NG·Wg)``, scale / zero ``(R, NG)``); x bf16 or
    fp32. ``group`` is inferred for the dense uint8 widths."""
    _check_x("matmul_rhs", x)
    _check_format("matmul_rhs", bits, binary)
    t, k = x.shape
    r = codes.shape[0]
    group = _infer_group(codes, scale, bits, group)
    ng, wpg = _check_side("A", codes, scale, zero, (r,), bits, group, k)
    dev = _device_of("matmul_rhs", (x, codes, scale, zero))
    if dev.type == "cpu":
        PLAIN_CALLS["matmul_rhs"] += 1
        return matmul_rhs_ref(x, codes, scale, zero, bits=bits,
                              binary=binary, group=group)
    if r > MAX_SLOTS:
        raise NotImplementedError(f"matmul_rhs holds at most {MAX_SLOTS} "
                                  f"rank rows, got {r}")
    out = torch.empty((t, r), dtype=torch.float32, device=dev)
    from .build import load_library

    _launch("matmul_rhs", dev, load_library().matmul_rhs_launch,
            x.data_ptr(), int(x.dtype == torch.bfloat16), codes.data_ptr(),
            scale.data_ptr(), zero.data_ptr(), out.data_ptr(),
            t, k, r, bits, int(binary), group, ng, wpg)
    return out


def matmul_out(h, codes, scale, zero, *, bits: int, binary: bool,
               group: Optional[int] = None) -> torch.Tensor:
    """``h (T, R) @ dequant(Bᵀ)`` → ``(T, Mp)`` fp32 straight from one packed
    factor ``Bᵀ`` (codes ``(R, NG·Wg)``), over the group-padded width
    ``Mp = NG·group`` as the TPU kernel gives it; callers slice
    ``[:, :m]``. h is fp32 (what ``matmul_rhs`` returns)."""
    _check_x("matmul_out", h, (torch.float32,))
    _check_format("matmul_out", bits, binary)
    t, r = h.shape
    group = _infer_group(codes, scale, bits, group)
    mp = scale.shape[-1] * group
    ng, wpg = _check_side("B", codes, scale, zero, (r,), bits, group, mp)
    dev = _device_of("matmul_out", (h, codes, scale, zero))
    if dev.type == "cpu":
        PLAIN_CALLS["matmul_out"] += 1
        return matmul_out_ref(h, codes, scale, zero, bits=bits,
                              binary=binary, group=group)
    if r > MAX_SLOTS:
        raise NotImplementedError(f"matmul_out holds at most {MAX_SLOTS} "
                                  f"rank rows, got {r}")
    out = torch.empty((t, mp), dtype=torch.float32, device=dev)
    from .build import load_library

    _launch("matmul_out", dev, load_library().matmul_out_launch,
            h.data_ptr(), codes.data_ptr(), scale.data_ptr(),
            zero.data_ptr(), out.data_ptr(), t, r, mp, bits, int(binary),
            group, ng, wpg)
    return out


def fused_lora(x, a_hi, b_hi, a_lo=None, b_lo=None, *, m: int,
               bits_hi: int, binary_hi: bool, bits_lo: int = 1,
               binary_lo: bool = True, group_ah: int, group_bh: int,
               group_al: int = 0, group_bl: int = 0) -> torch.Tensor:
    """Single-adapter apply of both LoRAQuant sub-LoRAs from packed codes,
    one launch per call: ``(x·A_hiᵀ)·B_hi + (x·A_loᵀ)·B_lo`` → ``(T, m)``
    fp32.

    x ``(T, K)`` bf16 or fp32, any T; each side a ``(codes, scale, zero)``
    triple in the kernel layout, A sides ``(R, ·)`` over K and B sides
    (``Bᵀ``) ``(R, ·)`` over m, the high and low sides with their own padded
    rank, bit width and groups. The low side is optional. The output has
    exactly ``m`` columns, whatever B's group padding.
    """
    _check_x("fused_lora", x)
    t, k = x.shape
    sides = [("hi", a_hi, b_hi, bits_hi, binary_hi, group_ah, group_bh)]
    if (a_lo is None) != (b_lo is None):
        raise ValueError("fused_lora: pass both low-side factors or neither")
    if a_lo is not None:
        sides.append(("lo", a_lo, b_lo, bits_lo, binary_lo, group_al,
                      group_bl))
    dims = []
    for tag, a, b, bits, binary, ga, gb in sides:
        _check_format(f"fused_lora {tag}", bits, binary)
        r = a[0].shape[0]
        dims.append((r,) + _check_side(f"A_{tag}", *a, (r,), bits, ga, k)
                    + _check_side(f"B_{tag}", *b, (r,), bits, gb, m))
    tensors = (x,) + tuple(a for s in sides for a in (*s[1], *s[2]))
    dev = _device_of("fused_lora", tensors)
    if dev.type == "cpu":
        PLAIN_CALLS["fused_lora"] += 1
        return fused_lora_ref(
            x, a_hi, b_hi, a_lo, b_lo, m=m, bits_hi=bits_hi,
            binary_hi=binary_hi, bits_lo=bits_lo, binary_lo=binary_lo,
            group_ah=group_ah, group_bh=group_bh, group_al=group_al,
            group_bl=group_bl)
    r_hi, ng_ah, wpg_ah, ng_bh, wpg_bh = dims[0]
    r_lo, ng_al, wpg_al, ng_bl, wpg_bl = dims[1] if a_lo is not None else (
        0, 0, 0, 0, 0)
    if r_hi + r_lo > MAX_SLOTS:
        raise NotImplementedError(f"fused_lora holds at most {MAX_SLOTS} "
                                  f"rank rows, got {r_hi} + {r_lo}")
    out = torch.empty((t, m), dtype=torch.float32, device=dev)
    lo = ([p.data_ptr() for p in (*a_lo, *b_lo)] if a_lo is not None
          else [None] * 6)
    from .build import load_library

    _launch("fused_lora", dev, load_library().fused_lora_launch,
            x.data_ptr(), int(x.dtype == torch.bfloat16),
            *[p.data_ptr() for p in (*a_hi, *b_hi)], *lo, out.data_ptr(),
            t, k, m, r_hi, r_lo, bits_hi, int(binary_hi), bits_lo,
            int(binary_lo), group_ah, ng_ah, wpg_ah, group_bh, ng_bh, wpg_bh,
            group_al, ng_al, wpg_al, group_bl, ng_bl, wpg_bl)
    return out


def sgmv_fused(x, a_codes, a_scale, a_zero, b_codes, b_scale, b_zero,
               seg_map, *, bits_a: int, binary_a: bool, group_a: int,
               bits_b: int, binary_b: bool, group_b: int,
               a_lo=None, b_lo=None, bits_lo: int = 1, binary_lo: bool = True,
               group_al: int = 0, group_bl: int = 0,
               m: Optional[int] = None, tile_t: int = 8) -> torch.Tensor:
    """Heterogeneous multi-adapter apply of both LoRAQuant sub-LoRAs from
    packed codes, one launch per call.

    x ``(T, K)`` bf16 or fp32; ``a_*`` / ``b_*`` the RTN high side
    ``(NA, Rp, ·)``; ``a_lo`` / ``b_lo`` the binary low side as
    ``(codes, scale, zero)`` triples; ``seg_map (T/tile_t,)`` int32 adapter
    id per token tile; ``m`` the output width (slices B's last-group
    padding). Returns ``(T, m)`` fp32.
    """
    t, k = x.shape
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be bf16 or fp32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if binary_a or binary_b or bits_a != bits_b or bits_a not in (2, 3, 4, 8):
        raise NotImplementedError(
            "sgmv_fused serves an RTN high side of one width in {2, 3, 4, 8} "
            f"on both factors; got bits {bits_a}/{bits_b}, binary "
            f"{binary_a}/{binary_b}")
    if a_lo is None or b_lo is None or bits_lo != 1 or not binary_lo:
        raise NotImplementedError(
            "sgmv_fused needs the binary 1-bit low side (all-zero scales "
            "when an adapter has none); the single-side SGMV is ROADMAP B4")
    if group_al != group_a or group_bl != group_b:
        raise NotImplementedError("hi and lo sides must share quant groups")
    na, rp = a_codes.shape[:2]
    if m is None:
        m = b_scale.shape[-1] * group_b
    ng_a, wpg_ah = _check_side("A_hi", a_codes, a_scale, a_zero, (na, rp),
                               bits_a, group_a, k)
    ng_b, wpg_bh = _check_side("B_hi", b_codes, b_scale, b_zero, (na, rp),
                               bits_b, group_b, m)
    _, wpg_al = _check_side("A_lo", a_lo[0], a_lo[1], None, (na, rp), 1,
                            group_a, k)
    _, wpg_bl = _check_side("B_lo", b_lo[0], b_lo[1], None, (na, rp), 1,
                            group_b, m)
    if a_lo[1].shape[-1] != ng_a or b_lo[1].shape[-1] != ng_b:
        raise ValueError("hi and lo sides must have the same group counts")
    if rp > MAX_RANK_ROWS:
        raise NotImplementedError(f"padded rank {rp} > {MAX_RANK_ROWS}")
    if not 1 <= tile_t <= MAX_TILE_ROWS or t % tile_t:
        raise ValueError(f"rows {t} must divide into tiles of {tile_t} rows, "
                         f"1 <= tile_t <= {MAX_TILE_ROWS}")
    if (seg_map.dim() != 1 or seg_map.shape[0] != t // tile_t
            or seg_map.dtype != torch.int32):
        raise ValueError(f"seg_map must be int32 ({t // tile_t},), got "
                         f"{seg_map.dtype} {tuple(seg_map.shape)}")
    dev = _device_of("sgmv_fused", (x, a_codes, a_scale, a_zero, b_codes,
                                    b_scale, b_zero, a_lo[0], a_lo[1],
                                    b_lo[0], b_lo[1], seg_map))
    if dev.type == "cpu":
        PLAIN_CALLS["sgmv_fused"] += 1
        return sgmv_fused_ref(
            x, a_codes, a_scale, a_zero, b_codes, b_scale, b_zero, seg_map,
            bits_a=bits_a, binary_a=False, group_a=group_a,
            bits_b=bits_b, binary_b=False, group_b=group_b,
            a_lo=a_lo, b_lo=b_lo, bits_lo=1, binary_lo=True,
            group_al=group_al, group_bl=group_bl, m=m, tile_t=tile_t)
    chunk = group_a * (1 if group_a >= 256 else 256 // group_a)
    smem = 4 * (tile_t * chunk + 2 * rp * chunk + 2 * rp * tile_t)
    if smem > MAX_SMEM_BYTES:
        raise NotImplementedError(
            f"quant group {group_a} needs {smem} B of shared memory per "
            f"block (> {MAX_SMEM_BYTES})")
    out = torch.empty((t, m), dtype=torch.float32, device=dev)
    from .build import load_library

    _launch("sgmv_fused", dev, load_library().sgmv_fused_launch,
            x.data_ptr(), int(x.dtype == torch.bfloat16),
            a_codes.data_ptr(), a_scale.data_ptr(), a_zero.data_ptr(),
            b_codes.data_ptr(), b_scale.data_ptr(), b_zero.data_ptr(),
            a_lo[0].data_ptr(), a_lo[1].data_ptr(),
            b_lo[0].data_ptr(), b_lo[1].data_ptr(),
            seg_map.data_ptr(), out.data_ptr(),
            t, k, m, na, rp, tile_t, bits_a,
            group_a, ng_a, wpg_ah, wpg_al,
            group_b, ng_b, wpg_bh, wpg_bl)
    return out
