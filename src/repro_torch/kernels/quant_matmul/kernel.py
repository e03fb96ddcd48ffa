"""Wrapper of the ``sgmv_fused`` Hopper kernel (port of the Pallas
``sgmv_fused`` in ``repro/kernels/quant_matmul/kernel.py``).

The kernel itself is CUDA C++ in ``csrc/sgmv_fused.cu``, built by
``build.py`` at first use. On a CUDA tensor the wrapper launches it on the
current stream (or raises); on a CPU tensor it returns ``sgmv_fused_ref``,
the plain PyTorch version. Both take the same checks, so the CPU tests hold
the layouts the card accepts.

``LAUNCH_COUNTS`` counts kernel launches by name, mirroring the JAX
package's counter: one per CUDA launch and nowhere else. ``PLAIN_CALLS``
counts the wrapper's CPU calls, so the CPU tests can check how often the
model reaches the wrapper.
"""

from __future__ import annotations

import collections
from typing import Optional

import torch

from .ref import sgmv_fused_ref

LAUNCH_COUNTS: "collections.Counter[str]" = collections.Counter()
PLAIN_CALLS: "collections.Counter[str]" = collections.Counter()

MAX_TILE_ROWS = 8          # token rows one CUDA block holds (kMaxTileRows)
MAX_RANK_ROWS = 32         # Rp the CUDA block supports (kMaxThreads / 16)
MAX_SMEM_BYTES = 232448    # opt-in shared memory per block on Hopper


def reset_launch_counts() -> None:
    LAUNCH_COUNTS.clear()
    PLAIN_CALLS.clear()


def _per_word(bits: int) -> int:
    return 10 if bits == 3 else 8 // bits


def _check_side(name, codes, scale, zero, na, rp, bits, group, dim):
    want_dtype = torch.int32 if bits == 3 else torch.uint8
    if codes.dim() != 3 or tuple(codes.shape[:2]) != (na, rp):
        raise ValueError(f"{name} codes must be (NA={na}, Rp={rp}, words), "
                         f"got {tuple(codes.shape)}")
    if codes.dtype != want_dtype:
        raise ValueError(f"{name} codes of {bits}-bit must be {want_dtype}, "
                         f"got {codes.dtype}")
    ng = scale.shape[-1]
    if tuple(scale.shape) != (na, rp, ng) or scale.dtype != torch.float32:
        raise ValueError(f"{name} scale must be fp32 (NA, Rp, NG), got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if zero is not None and (tuple(zero.shape) != (na, rp, ng)
                             or zero.dtype != torch.int32):
        raise ValueError(f"{name} zero must be int32 (NA, Rp, NG), got "
                         f"{zero.dtype} {tuple(zero.shape)}")
    wpg = -(-group // _per_word(bits))
    if codes.shape[2] != ng * wpg:
        raise ValueError(f"{name} codes hold {codes.shape[2]} words, expected "
                         f"{ng} groups x {wpg} words")
    if not (ng - 1) * group < dim <= ng * group:
        raise ValueError(f"{name}: {ng} groups of {group} do not cover "
                         f"{dim} features")
    for t in (codes, scale) + ((zero,) if zero is not None else ()):
        if not t.is_contiguous():
            raise ValueError(f"{name} arrays must be contiguous")
    return ng, wpg


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
    ng_a, wpg_ah = _check_side("A_hi", a_codes, a_scale, a_zero, na, rp,
                               bits_a, group_a, k)
    ng_b, wpg_bh = _check_side("B_hi", b_codes, b_scale, b_zero, na, rp,
                               bits_b, group_b, m)
    _, wpg_al = _check_side("A_lo", a_lo[0], a_lo[1], None, na, rp, 1,
                            group_a, k)
    _, wpg_bl = _check_side("B_lo", b_lo[0], b_lo[1], None, na, rp, 1,
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
    tensors = (x, a_codes, a_scale, a_zero, b_codes, b_scale, b_zero,
               a_lo[0], a_lo[1], b_lo[0], b_lo[1], seg_map)
    if any(tt.device != x.device for tt in tensors):
        raise ValueError("sgmv_fused operands must share one device")

    if x.device.type == "cpu":
        PLAIN_CALLS["sgmv_fused"] += 1
        return sgmv_fused_ref(
            x, a_codes, a_scale, a_zero, b_codes, b_scale, b_zero, seg_map,
            bits_a=bits_a, binary_a=False, group_a=group_a,
            bits_b=bits_b, binary_b=False, group_b=group_b,
            a_lo=a_lo, b_lo=b_lo, bits_lo=1, binary_lo=True,
            group_al=group_al, group_bl=group_bl, m=m, tile_t=tile_t)
    if x.device.type != "cuda":
        raise ValueError(f"sgmv_fused runs on cuda or cpu, got {x.device}")

    chunk = group_a * (1 if group_a >= 256 else 256 // group_a)
    smem = 4 * (tile_t * chunk + 2 * rp * chunk + 2 * rp * tile_t)
    if smem > MAX_SMEM_BYTES:
        raise NotImplementedError(
            f"quant group {group_a} needs {smem} B of shared memory per "
            f"block (> {MAX_SMEM_BYTES})")
    out = torch.empty((t, m), dtype=torch.float32, device=x.device)
    from .build import load_library

    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.sgmv_fused_launch(
            x.data_ptr(), int(x.dtype == torch.bfloat16),
            a_codes.data_ptr(), a_scale.data_ptr(), a_zero.data_ptr(),
            b_codes.data_ptr(), b_scale.data_ptr(), b_zero.data_ptr(),
            a_lo[0].data_ptr(), a_lo[1].data_ptr(),
            b_lo[0].data_ptr(), b_lo[1].data_ptr(),
            seg_map.data_ptr(), out.data_ptr(),
            t, k, m, na, rp, tile_t, bits_a,
            group_a, ng_a, wpg_ah, wpg_al,
            group_b, ng_b, wpg_bh, wpg_bl,
            stream)
    if rc != 0:
        msg = lib.sgmv_fused_error_string(rc).decode()
        raise RuntimeError(f"sgmv_fused launch failed: CUDA error {rc} "
                           f"({msg})")
    LAUNCH_COUNTS["sgmv_fused"] += 1
    return out
