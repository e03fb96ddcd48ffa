"""Wrappers of the Hopper kernels that apply LoRAQuant packed codes (ports
of the Pallas kernels in ``repro/kernels/quant_matmul/kernel.py``):

* ``matmul_rhs`` — ``h = x·dequant(A)ᵀ`` (``csrc/matmul_rhs.cu``);
* ``matmul_out`` — ``y = h·dequant(Bᵀ)`` over B's group-padded width
  (``csrc/matmul_out.cu``);
* ``fused_lora`` — one adapter's ``(x·A_hiᵀ)·B_hi + (x·A_loᵀ)·B_lo`` in one
  launch (``csrc/fused_lora.cu``);
* ``sgmv_rhs`` / ``sgmv_out`` — the two passes per token tile with the
  tile's adapter (``csrc/sgmv_rhs.cu``, ``csrc/sgmv_out.cu``);
* ``sgmv_fused`` — both products per token tile with the tile's adapter,
  optionally both sub-LoRAs (``csrc/sgmv_fused.cu``).

All six share ``csrc/cluster_lora.cuh``: ``fused_lora``, ``sgmv_fused``,
``matmul_rhs`` and ``sgmv_rhs`` launch one thread-block cluster per token
tile (one phase-1 path for the four), ``matmul_out`` and ``sgmv_out`` the
fused kernels' phase 2 as plain blocks; :func:`_cluster_plan` cuts each
call into tiles, K and M slices and copy widths, and the C launcher takes
the plan as it is.

The kernels are CUDA C++, built by ``build.py`` at first use. On a CUDA
tensor a wrapper launches its kernel on the current stream (or raises); on a
CPU tensor it returns the plain PyTorch version from ``ref.py``. Both take
the same checks, so the CPU tests hold the layouts the card accepts.

``LAUNCH_COUNTS`` counts kernel launches by name, mirroring the JAX
package's counter: one per CUDA launch and nowhere else. ``PLAIN_CALLS``
counts the wrapper's CPU calls, so the CPU tests can check how often the
model reaches the wrapper.

Launch sinks (:func:`add_launch_sink`) observe the same stream: each is
called with the kernel's name at every CUDA launch and, on the CPU, at
every plain call. The semantics differ from the JAX package's sinks, which
run once per *trace* of a ``pallas_call`` (a jitted step replays without
recording); here every real launch is recorded. The serving telemetry
exports them as ``pallas_launches_total{kernel=...}``.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import math
from typing import Optional, Sequence

import torch

from .build import load_library
from .ref import (fused_lora_ref, matmul_out_ref, matmul_rhs_ref,
                  sgmv_fused_ref, sgmv_out_ref, sgmv_rhs_ref)

LAUNCH_COUNTS: "collections.Counter[str]" = collections.Counter()
PLAIN_CALLS: "collections.Counter[str]" = collections.Counter()

MAX_TILE_ROWS = 8          # token rows of a tile (the largest compiled TR)
BITS = (1, 2, 3, 4, 8)

# The launch plan of every kernel (csrc/cluster_lora.cuh)
MAX_CLUSTER = 8            # blocks per token tile (the portable cluster size)
CHUNK_COLS = 1024          # columns of a K or M slice staged at once
TILE_ROWS = (1, 2, 4, 8)   # compiled token-row counts of a tile
TARGET_BLOCKS = 128        # fused_lora / matmul_* pick their tile rows
                           # to fill ~132 SMs
OUT_BLOCKS = 2 * TARGET_BLOCKS  # an out call's plain blocks at most: about
                                # two per SM, so a prefill runs in one wave


# Registered observers, each called with the kernel name at every launch
# (and every plain call): they must be cheap and must not raise.
_LAUNCH_SINKS: list = []


def reset_launch_counts() -> None:
    LAUNCH_COUNTS.clear()
    PLAIN_CALLS.clear()


def add_launch_sink(sink) -> None:
    """Register a ``sink(name)`` callable observing every kernel launch and
    plain call (idempotent: re-adding a registered sink is a no-op)."""
    if sink not in _LAUNCH_SINKS:
        _LAUNCH_SINKS.append(sink)


def remove_launch_sink(sink) -> None:
    if sink in _LAUNCH_SINKS:
        _LAUNCH_SINKS.remove(sink)


def _notify(name: str) -> None:
    for sink in _LAUNCH_SINKS:
        sink(name)


def _plain_call(name: str) -> None:
    """Count a wrapper's CPU call (the plain version runs instead)."""
    PLAIN_CALLS[name] += 1
    _notify(name)


def _per_word(bits: int) -> int:
    return 10 if bits == 3 else 8 // bits


def _check_side(name, codes, scale, zero, lead, bits, group, dim,
                binary=False):
    """Check one packed factor in the kernel layout: codes
    ``(*lead, NG·Wg)``, scale and zero ``(*lead, NG)``, whose ``NG`` groups of
    ``group`` cover ``dim`` features; only a binary side may come without
    zero-points. Returns ``(NG, Wg)``."""
    if zero is None and not binary:
        raise ValueError(f"{name}: an RTN side needs its zero-points")
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


@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    """How a kernel cuts one launch: ``tiles`` token tiles of ``tile_rows``
    compiled rows, one cluster of ``cluster`` blocks each (``cluster``
    plain blocks each for the out kernels, which read no neighbour's shared
    memory).
    Block b of a cluster owns the K units ``[b·k_units, (b+1)·k_units)`` of
    ``k_unit`` columns (a multiple of every A side's group) and the M units
    likewise, staged ``k_chunk`` / ``m_chunk`` units at a time (an A-only
    plan has ``m_unit`` 1 and no M units, a B-only plan ``k_unit`` 1 and no
    K units).
    ``vec_*`` are the bytes per asynchronous copy (16, 4 or 1) of x and of
    each side's codes ``(A_hi, B_hi, A_lo, B_lo)``; ``vec_y`` is 4 where y is
    written with float4 stores."""

    cluster: int
    tile_rows: int
    tiles: int
    k_unit: int
    k_units: int
    k_chunk: int
    m_unit: int
    m_units: int
    m_chunk: int
    vec_x: int
    vec_y: int
    vec_codes: tuple

    def args(self) -> tuple:
        """The plan in the order of the C launchers' ``plan`` array."""
        return (self.cluster, self.tile_rows, self.k_unit, self.k_units,
                self.k_chunk, self.m_unit, self.m_units, self.m_chunk,
                self.vec_x, self.vec_y, *self.vec_codes)

    @functools.cached_property
    def c_args(self) -> ctypes.Array:
        """:meth:`args` as the int32 array the C launchers take, built once
        per plan (one ctypes argument per call instead of 14)."""
        args = self.args()
        return (ctypes.c_int * len(args))(*args)


def _align16(v: int) -> int:
    return (v + 15) & ~15


def _smem_bytes(tile_rows: int, x_bytes: int, k_cols: int, m_cols: int,
                sides: tuple) -> int:
    """Dynamic shared memory of one block: ``make_layout(...).total`` of
    ``csrc/cluster_lora.cuh``, term for term, for chunks of ``k_cols`` /
    ``m_cols`` columns. ``sides`` as :func:`_cluster_plan` takes them; the
    launcher refuses a plan whose layout exceeds the card's opt-in limit,
    so this mirror and the device layout cannot drift apart unnoticed."""
    ah, bh, al, bl = sides
    slots = next(s[4] for s in (ah, bh) if s is not None) + (
        next((s[4] for s in (al, bl) if s is not None), 0))
    off = _align16(4 * slots * tile_rows)                         # hp
    off = _align16(off + 4 * slots * tile_rows)                   # hf
    off = _align16(off + _align16(k_cols * x_bytes) * tile_rows)  # xs
    off = _align16(off + 4 * ((m_cols + 3) & ~3) * tile_rows)     # ys
    for i, side in enumerate(sides):
        if side is None:
            continue
        group, wpg, word_bytes, _, rows, binary = side
        gpc = (m_cols if i & 1 else k_cols) // group
        off = _align16(off + _align16(gpc * wpg * word_bytes) * rows)
        off = _align16(off + 4 * gpc * rows)                      # scale
        off = _align16(off + (0 if binary else 4 * gpc * rows))   # zero
    return off


def _copy_bytes(ptr: int, steps: Sequence[int]) -> int:
    """Widest asynchronous copy (16 or 4 bytes, else 1) whose every piece
    starts aligned: ``ptr`` (an address, or the address mod 16) and every
    stride in ``steps`` divide by it."""
    for vec in (16, 4):
        if ptr % vec == 0 and all(s % vec == 0 for s in steps):
            return vec
    return 1


@functools.lru_cache(maxsize=1024)
def _cluster_plan(t: int, k: int, m: int, kt: Optional[int], x_ptr: int,
                  x_bytes: int, out_ptr: int, sides: tuple,
                  smem_budget: int) -> ClusterPlan:
    """The launch plan of one ``fused_lora`` / ``matmul_*`` (``kt=None``:
    the plan picks the tile rows) or ``sgmv_*`` call (tiles of ``kt``
    rows). ``sides`` are ``(group, words_per_group, word_bytes, codes_ptr,
    rank_rows, binary)`` of A_hi, B_hi, A_lo, B_lo (:func:`_side_geom`),
    or None for an absent side: the low side, both B sides of an A-only
    call (the rhs kernels, ``m = 0``) or both A sides of a B-only call (the
    out kernels, ``k = 0``, which stage no x). Pointers matter only mod 16,
    which is what the wrappers pass, so a serve loop's calls hit the cache.
    ``smem_budget`` is the dynamic shared memory a block may use (the
    card's opt-in limit, :func:`_smem_budget`).

    K is cut in units of the A sides' common group multiple, M in units of
    the B sides', so that no quant group spans two blocks; the cluster is
    the smallest power of two that gives every unit its own block, at most
    ``MAX_CLUSTER``, and for a B-only call (plain blocks, nothing to
    reduce) halved while the grid exceeds ``OUT_BLOCKS``. A side's codes
    are copied 16 bytes at a time only where every group start is 16-byte
    aligned (a group's bytes and the base pointer divide by 16: so never for
    3-bit groups of 13 words), else 4 bytes at a time where that holds,
    else byte by byte.

    A block stages up to ``CHUNK_COLS`` columns of K and of M at a time;
    where that chunk's layout (:func:`_smem_bytes`, which grows with the
    sides' rank rows) exceeds ``smem_budget``, the K chunk and then the M
    chunk are halved, down to one unit each. A call whose single units do
    not fit raises ``ValueError``."""
    ah, bh, al, bl = sides
    if (bh is None) != (m == 0) or (bh is None and bl is not None):
        raise ValueError("an A-only plan has m = 0 and no B sides")
    if (ah is None) != (k == 0) or (ah is None and al is not None):
        raise ValueError("a B-only plan has k = 0 and no A sides")
    if k == m == 0:
        raise ValueError("a plan needs an A or a B side")
    k_unit = math.lcm(*(s[0] for s in (ah, al) if s is not None))
    m_unit = math.lcm(*(s[0] for s in (bh, bl) if s is not None))
    nu_k, nu_m = -(-k // k_unit), -(-m // m_unit)
    cluster = 1
    while cluster < MAX_CLUSTER and cluster < max(nu_k, nu_m):
        cluster *= 2
    k_units, m_units = -(-nu_k // cluster), -(-nu_m // cluster)
    if kt is None:
        want = min(-(-t * cluster // TARGET_BLOCKS), TILE_ROWS[-1])
        tile_rows = next(r for r in TILE_ROWS if r >= want)
        tiles = -(-t // tile_rows)
    else:
        tile_rows = next(r for r in TILE_ROWS if r >= kt)
        tiles = t // kt
    if k == 0:
        while cluster > 1 and tiles * cluster > OUT_BLOCKS:
            cluster //= 2
        m_units = -(-nu_m // cluster)
    k_chunk = min(k_units, max(1, CHUNK_COLS // k_unit))
    m_chunk = min(m_units, max(1, CHUNK_COLS // m_unit))

    def smem():
        return _smem_bytes(tile_rows, x_bytes, k_chunk * k_unit,
                           m_chunk * m_unit, sides)

    while smem() > smem_budget and max(k_chunk, m_chunk) > 1:
        if k_chunk > 1:
            k_chunk = -(-k_chunk // 2)
        else:
            m_chunk = -(-m_chunk // 2)
    if smem() > smem_budget:
        rows = [s[4] for s in sides if s is not None]
        raise ValueError(
            f"a block of this call needs {smem()} bytes of shared memory "
            f"for one K unit of {k_unit} and one M unit of {m_unit} columns "
            f"at rank rows {rows} and {tile_rows} token rows; the card "
            f"offers {smem_budget}")
    vec_codes = tuple(0 if s is None else _copy_bytes(s[3], [s[1] * s[2]])
                      for s in sides)
    return ClusterPlan(
        cluster=cluster, tile_rows=tile_rows, tiles=tiles,
        k_unit=k_unit, k_units=k_units, k_chunk=k_chunk,
        m_unit=m_unit, m_units=m_units, m_chunk=m_chunk,
        vec_x=_copy_bytes(x_ptr, [k * x_bytes, k_unit * x_bytes]) if k
        else 1,
        vec_y=4 if out_ptr % 16 == 0 and m % 4 == 0 and m_unit % 4 == 0
        else 1,
        vec_codes=vec_codes)


def _side_geom(group: int, wpg: int, bits: int, codes_ptr: int, rows: int,
               binary: bool):
    """``(group, words_per_group, word_bytes, codes address mod 16, rank
    rows, binary)`` of one side for :func:`_cluster_plan`."""
    return (group, wpg, 4 if bits == 3 else 1, codes_ptr % 16, rows,
            bool(binary))


@functools.lru_cache(maxsize=None)
def _smem_budget(index: int) -> int:
    """The dynamic shared memory a block may opt in to on CUDA device
    ``index`` (232448 bytes on an H100), read once per device."""
    return torch.cuda.get_device_properties(index).shared_memory_per_block_optin


def _launch(name: str, dev: torch.device, fn, *args) -> None:
    """Call the C launcher ``fn(*args, stream)`` on the current stream of
    ``dev``; raise on a refused launch, else count it."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        msg = load_library().quant_matmul_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")
    LAUNCH_COUNTS[name] += 1
    _notify(name)


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
        _plain_call("matmul_rhs")
        return matmul_rhs_ref(x, codes, scale, zero, bits=bits,
                              binary=binary, group=group)
    x_ptr, codes_ptr = x.data_ptr(), codes.data_ptr()
    plan = _cluster_plan(t, k, 0, None, x_ptr % 16, x.element_size(), 0,
                         (_side_geom(group, wpg, bits, codes_ptr, r, binary),
                          None, None, None), _smem_budget(dev.index))
    out = torch.empty((t, r), dtype=torch.float32, device=dev)
    _launch("matmul_rhs", dev, load_library().matmul_rhs_launch,
            x_ptr, int(x.dtype == torch.bfloat16), codes_ptr,
            scale.data_ptr(), zero.data_ptr(), out.data_ptr(),
            t, k, r, bits, int(binary), group, ng, wpg, plan.c_args)
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
        _plain_call("matmul_out")
        return matmul_out_ref(h, codes, scale, zero, bits=bits,
                              binary=binary, group=group)
    out = torch.empty((t, mp), dtype=torch.float32, device=dev)
    codes_ptr, out_ptr = codes.data_ptr(), out.data_ptr()
    plan = _cluster_plan(t, 0, mp, None, 0, 4, out_ptr % 16,
                         (None, _side_geom(group, wpg, bits, codes_ptr, r,
                                           binary), None, None),
                         _smem_budget(dev.index))
    _launch("matmul_out", dev, load_library().matmul_out_launch,
            h.data_ptr(), codes_ptr, scale.data_ptr(), zero.data_ptr(),
            out_ptr, t, r, mp, bits, int(binary), group, ng, wpg,
            plan.c_args)
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
        _plain_call("fused_lora")
        return fused_lora_ref(
            x, a_hi, b_hi, a_lo, b_lo, m=m, bits_hi=bits_hi,
            binary_hi=binary_hi, bits_lo=bits_lo, binary_lo=binary_lo,
            group_ah=group_ah, group_bh=group_bh, group_al=group_al,
            group_bl=group_bl)
    r_hi, ng_ah, wpg_ah, ng_bh, wpg_bh = dims[0]
    r_lo, ng_al, wpg_al, ng_bl, wpg_bl = dims[1] if a_lo is not None else (
        0, 0, 0, 0, 0)
    out = torch.empty((t, m), dtype=torch.float32, device=dev)
    ptrs = [p.data_ptr() for p in (*a_hi, *b_hi)] + (
        [p.data_ptr() for p in (*a_lo, *b_lo)] if r_lo else [None] * 6)
    x_ptr, out_ptr = x.data_ptr(), out.data_ptr()
    plan = _cluster_plan(
        t, k, m, None, x_ptr % 16, x.element_size(), out_ptr % 16,
        (_side_geom(group_ah, wpg_ah, bits_hi, ptrs[0], r_hi, binary_hi),
         _side_geom(group_bh, wpg_bh, bits_hi, ptrs[3], r_hi, binary_hi),
         _side_geom(group_al, wpg_al, bits_lo, ptrs[6], r_lo, binary_lo)
         if r_lo else None,
         _side_geom(group_bl, wpg_bl, bits_lo, ptrs[9], r_lo, binary_lo)
         if r_lo else None), _smem_budget(dev.index))
    _launch("fused_lora", dev, load_library().fused_lora_launch,
            x_ptr, int(x.dtype == torch.bfloat16), *ptrs, out_ptr,
            t, k, m, r_hi, r_lo, bits_hi, int(binary_hi), bits_lo,
            int(binary_lo), group_ah, ng_ah, wpg_ah, group_bh, ng_bh, wpg_bh,
            group_al, ng_al, wpg_al, group_bl, ng_bl, wpg_bl, plan.c_args)
    return out


def _check_tiles(name, t: int, tile_t: int, seg_map) -> None:
    """Token tiles of ``tile_t`` rows (one CUDA block or cluster each) and
    their ``(T/tile_t,)`` int32 adapter map."""
    if not 1 <= tile_t <= MAX_TILE_ROWS or t % tile_t:
        raise ValueError(f"{name}: rows {t} must divide into tiles of "
                         f"{tile_t} rows, 1 <= tile_t <= {MAX_TILE_ROWS}")
    if (seg_map.dim() != 1 or seg_map.shape[0] != t // tile_t
            or seg_map.dtype != torch.int32):
        raise ValueError(f"{name}: seg_map must be int32 ({t // tile_t},), "
                         f"got {seg_map.dtype} {tuple(seg_map.shape)}")
    if not seg_map.is_contiguous():
        raise ValueError(f"{name}: seg_map must be contiguous")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def sgmv_rhs(x, codes, scale, zero, seg_map, *, bits: int, binary: bool,
             group: Optional[int] = None, tile_t: int = 8) -> torch.Tensor:
    """Segment-gathered ``h = x·dequant(A[seg])ᵀ`` → ``(T, R)`` fp32, one
    launch: x ``(T, K)`` bf16 or fp32; A a stack of packed factors (codes
    ``(NA, R, NG·Wg)``, scale / zero ``(NA, R, NG)``); ``seg_map
    (T/tile_t,)`` int32, the adapter of each tile of ``tile_t`` rows."""
    _check_x("sgmv_rhs", x)
    _check_format("sgmv_rhs", bits, binary)
    t, k = x.shape
    na, r = codes.shape[:2]
    group = _infer_group(codes, scale, bits, group)
    ng, wpg = _check_side("A", codes, scale, zero, (na, r), bits, group, k,
                          binary)
    _check_tiles("sgmv_rhs", t, tile_t, seg_map)
    dev = _device_of("sgmv_rhs", [v for v in (x, codes, scale, zero, seg_map)
                                  if v is not None])
    if dev.type == "cpu":
        _plain_call("sgmv_rhs")
        return sgmv_rhs_ref(x, codes, scale, zero, seg_map, bits=bits,
                            binary=binary, group=group, tile_t=tile_t)
    x_ptr, codes_ptr = x.data_ptr(), codes.data_ptr()
    plan = _cluster_plan(t, k, 0, tile_t, x_ptr % 16, x.element_size(), 0,
                         (_side_geom(group, wpg, bits, codes_ptr, r, binary),
                          None, None, None), _smem_budget(dev.index))
    out = torch.empty((t, r), dtype=torch.float32, device=dev)
    _launch("sgmv_rhs", dev, load_library().sgmv_rhs_launch,
            x_ptr, int(x.dtype == torch.bfloat16), codes_ptr,
            scale.data_ptr(), _ptr(zero), seg_map.data_ptr(), out.data_ptr(),
            t, k, r, na, tile_t, bits, int(binary), group, ng, wpg,
            plan.c_args)
    return out


def sgmv_out(h, codes, scale, zero, seg_map, *, bits: int, binary: bool,
             group: Optional[int] = None, m: Optional[int] = None,
             tile_t: int = 8) -> torch.Tensor:
    """Segment-gathered ``y = h·dequant(Bᵀ[seg])[:, :m]`` → ``(T, m)``
    fp32, one launch: h ``(T, R)`` fp32 (what :func:`sgmv_rhs` returns); Bᵀ
    a stack of packed factors (codes ``(NA, R, NG·Wg)``); ``m`` defaults to
    ``NG·group``. The kernel writes exactly ``m`` columns."""
    _check_x("sgmv_out", h, (torch.float32,))
    _check_format("sgmv_out", bits, binary)
    t, r = h.shape
    na = codes.shape[0]
    group = _infer_group(codes, scale, bits, group)
    if m is None:
        m = scale.shape[-1] * group
    ng, wpg = _check_side("B", codes, scale, zero, (na, r), bits, group, m,
                          binary)
    _check_tiles("sgmv_out", t, tile_t, seg_map)
    dev = _device_of("sgmv_out", [v for v in (h, codes, scale, zero, seg_map)
                                  if v is not None])
    if dev.type == "cpu":
        _plain_call("sgmv_out")
        return sgmv_out_ref(h, codes, scale, zero, seg_map, bits=bits,
                            binary=binary, group=group, m=m, tile_t=tile_t)
    out = torch.empty((t, m), dtype=torch.float32, device=dev)
    codes_ptr, out_ptr = codes.data_ptr(), out.data_ptr()
    plan = _cluster_plan(t, 0, m, tile_t, 0, 4, out_ptr % 16,
                         (None, _side_geom(group, wpg, bits, codes_ptr, r,
                                           binary), None, None),
                         _smem_budget(dev.index))
    _launch("sgmv_out", dev, load_library().sgmv_out_launch,
            h.data_ptr(), codes_ptr, scale.data_ptr(), _ptr(zero),
            seg_map.data_ptr(), out_ptr, t, r, m, na, tile_t, bits,
            int(binary), group, ng, wpg, plan.c_args)
    return out


def sgmv_fused(x, a_codes, a_scale, a_zero, b_codes, b_scale, b_zero,
               seg_map, *, bits_a: int, binary_a: bool, group_a: int,
               bits_b: int, binary_b: bool, group_b: int,
               a_lo=None, b_lo=None, bits_lo: int = 1, binary_lo: bool = True,
               group_al: int = 0, group_bl: int = 0,
               m: Optional[int] = None, tile_t: int = 8) -> torch.Tensor:
    """Heterogeneous multi-adapter apply of LoRAQuant sub-LoRAs from packed
    codes, one launch per call:
    ``(x·A_hiᵀ)·B_hi (+ (x·A_loᵀ)·B_lo)`` → ``(T, m)`` fp32.

    x ``(T, K)`` bf16 or fp32; ``a_*`` / ``b_*`` the high side
    ``(NA, R, ·)``, A and B each with its own bit width, format (RTN or
    binary; a binary side's zero is never read and may be None) and group;
    ``a_lo`` / ``b_lo`` the optional low side as ``(codes, scale, zero)``
    triples ``(NA, R_lo, ·)`` with ``bits_lo`` / ``binary_lo`` and its own
    groups; ``seg_map (T/tile_t,)`` int32 adapter id per token tile; ``m``
    the output width (default ``NG·group_b``; slices B's last-group
    padding).
    """
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be bf16 or fp32, got {x.dtype}")
    _check_x("sgmv_fused", x)
    t, k = x.shape
    na, r_hi = a_codes.shape[:2]
    if m is None:
        m = b_scale.shape[-1] * group_b
    if (a_lo is None) != (b_lo is None):
        raise ValueError("sgmv_fused: pass both low-side factors or neither")
    sides = [("A_hi", (a_codes, a_scale, a_zero), bits_a, binary_a, group_a,
              k, r_hi),
             ("B_hi", (b_codes, b_scale, b_zero), bits_b, binary_b, group_b,
              m, r_hi)]
    r_lo = 0
    if a_lo is not None:
        r_lo = a_lo[0].shape[1]
        sides += [("A_lo", a_lo, bits_lo, binary_lo, group_al, k, r_lo),
                  ("B_lo", b_lo, bits_lo, binary_lo, group_bl, m, r_lo)]
    dims = []
    for tag, side, bits, binary, group, dim, rows in sides:
        _check_format(f"sgmv_fused {tag}", bits, binary)
        dims += [group, *_check_side(tag, *side, (na, rows), bits, group,
                                     dim, binary)]
    _check_tiles("sgmv_fused", t, tile_t, seg_map)
    tensors = [x, seg_map] + [v for s in sides for v in s[1] if v is not None]
    dev = _device_of("sgmv_fused", tensors)
    if dev.type == "cpu":
        _plain_call("sgmv_fused")
        return sgmv_fused_ref(
            x, a_codes, a_scale, a_zero, b_codes, b_scale, b_zero, seg_map,
            bits_a=bits_a, binary_a=binary_a, group_a=group_a,
            bits_b=bits_b, binary_b=binary_b, group_b=group_b,
            a_lo=a_lo, b_lo=b_lo, bits_lo=bits_lo, binary_lo=binary_lo,
            group_al=group_al, group_bl=group_bl, m=m, tile_t=tile_t)
    dims += [0] * (12 - len(dims))        # no low side: groups never read
    ptrs = [_ptr(v) for _, side, *_ in sides for v in side]
    ptrs += [None] * (12 - len(ptrs))
    out = torch.empty((t, m), dtype=torch.float32, device=dev)
    x_ptr, out_ptr = x.data_ptr(), out.data_ptr()
    geoms = tuple(_side_geom(dims[3 * i], dims[3 * i + 2], side[2],
                             ptrs[3 * i], side[6], side[3])
                  for i, side in enumerate(sides))
    plan = _cluster_plan(t, k, m, tile_t, x_ptr % 16, x.element_size(),
                         out_ptr % 16, geoms + (None,) * (4 - len(geoms)),
                         _smem_budget(dev.index))
    _launch("sgmv_fused", dev, load_library().sgmv_fused_launch,
            x_ptr, int(x.dtype == torch.bfloat16), *ptrs,
            seg_map.data_ptr(), out_ptr, t, k, m, na, r_hi, r_lo,
            tile_t, bits_a, int(binary_a), bits_b, int(binary_b), bits_lo,
            int(binary_lo), *dims, plan.c_args)
    return out
