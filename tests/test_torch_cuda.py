"""Tests of the port that need an NVIDIA GPU: build the kernels
(``sgmv_fused``, ``sgmv_rhs``, ``sgmv_out``, ``fused_lora``, ``matmul_rhs``,
``matmul_out``) with nvcc and hold each against its plain PyTorch version on
the card. They skip
on a machine without CUDA. This file imports no JAX, so it also runs where
JAX is absent:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        -m cuda tests/test_torch_cuda.py -q
"""

import dataclasses

import pytest
import torch

from repro_torch.core import LoRAQuantConfig, quantize_lora
from repro_torch.core.quant import binary_quantize, rtn_quantize
from repro_torch.kernels.quant_matmul import (
    LAUNCH_COUNTS,
    PackedLoRABuckets,
    fused_lora,
    fused_lora_ref,
    lora_apply_quantized,
    matmul_out,
    matmul_out_ref,
    matmul_rhs,
    matmul_rhs_ref,
    pack_adapter_layers,
    ref,
    reset_launch_counts,
    sgmv_apply,
    sgmv_apply_buckets,
    sgmv_apply_packed,
    sgmv_fused,
    sgmv_fused_ref,
    sgmv_out,
    sgmv_out_ref,
    sgmv_rhs,
    sgmv_rhs_ref,
    stack_adapter_side,
    stack_packed_adapters,
)
from repro_torch.kernels.quant_matmul.ops import _kernel_layout

pytestmark = pytest.mark.cuda

# fp32 tolerance: the kernel and the plain version sum the same products in
# different orders (lane-split K chunks vs cuBLAS), so the error is bounded
# relative to the output's magnitude max |y|.
RTOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


def _packed_layer(k, m, r, bits, group, na, device, seed):
    """``na`` random adapters with mixed split h (one with h == r), packed
    as one layer ``(NA, Rp, ·)``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    decay = torch.exp(-0.3 * torch.arange(r, device=device))
    qls = []
    for i in range(na):
        b = torch.randn(m, r, generator=gen, device=device) * decay
        a = torch.randn(r, k, generator=gen, device=device) * decay[:, None]
        rho = (0.5, 0.8, 0.95, 1.0)[i % 4]
        qls.append(quantize_lora(b, a, LoRAQuantConfig(
            rho=rho, bits_high=bits, group_size=group, refine="none")))
    assert any(q.a_low is None for q in qls)
    pb = stack_packed_adapters([pack_adapter_layers([q]) for q in qls])
    return pb.layer(0)


def _call(fn, x, pb, seg_tiles):
    """``fn`` (the kernel wrapper or its plain version) on one packed layer."""
    return fn(
        x, pb.ah_codes, pb.ah_scale, pb.ah_zero, pb.bh_codes, pb.bh_scale,
        pb.bh_zero, seg_tiles,
        bits_a=pb.bits_hi, binary_a=False, group_a=pb.group_ah,
        bits_b=pb.bits_hi, binary_b=False, group_b=pb.group_bh,
        a_lo=(pb.al_codes, pb.al_scale, pb.al_zero),
        b_lo=(pb.bl_codes, pb.bl_scale, pb.bl_zero),
        group_al=pb.group_al, group_bl=pb.group_bl, m=pb.m, tile_t=pb.tile_t)


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("tile_t", [1, 8])
@pytest.mark.parametrize("k,m", [(384, 256), (256, 200), (640, 1152)])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_sgmv_fused_cuda_vs_plain(cuda, bits, tile_t, k, m, xdtype):
    na, n_tiles = 5, 6
    pb = _packed_layer(k, m, 16, bits, 128, na, cuda, seed=bits * 7 + k)
    gen = torch.Generator(device=cuda).manual_seed(tile_t + m)
    seg_tiles = torch.randint(0, na, (n_tiles,), generator=gen, device=cuda,
                              dtype=torch.int32)
    x = torch.randn(n_tiles * tile_t, k, generator=gen,
                    device=cuda).to(xdtype)
    pb = dataclasses.replace(pb, tile_t=tile_t)
    reset_launch_counts()
    got = _call(sgmv_fused, x, pb, seg_tiles)
    torch.cuda.synchronize()
    assert dict(LAUNCH_COUNTS) == {"sgmv_fused": 1}
    assert got.shape == (x.shape[0], m) and got.dtype == torch.float32
    want = _call(sgmv_fused_ref, x, pb, seg_tiles)
    err = (got - want).abs().max().item()
    assert err <= RTOL * want.abs().max().item(), err


@pytest.mark.parametrize("k,m", [(6144, 8), (640, 8), (1024, 2048)])
@pytest.mark.parametrize("rows", [64, 320])
def test_sgmv_fused_folded_moe_rows_cuda_vs_plain(cuda, k, m, rows):
    """The MoE path's call: 4 adapters x 8 experts folded into 32 entries,
    one dispatch row per tile with seg ``adapter·8 + expert``, the router's
    M = 8 (B's groups of 8, most cluster blocks without an M unit)."""
    na, experts = 4, 8
    pb = _packed_layer(k, m, 16, 2, 128, na * experts, cuda, seed=k + m)
    cap = rows // experts
    r = torch.arange(rows, device=cuda)
    seg_tiles = ((r % cap) % na * experts + r // cap).to(torch.int32)
    gen = torch.Generator(device=cuda).manual_seed(rows)
    x = torch.randn(rows, k, generator=gen, device=cuda).to(torch.bfloat16)
    pb = dataclasses.replace(pb, tile_t=1)
    reset_launch_counts()
    got = _call(sgmv_fused, x, pb, seg_tiles)
    again = _call(sgmv_fused, x, pb, seg_tiles)
    torch.cuda.synchronize()
    assert dict(LAUNCH_COUNTS) == {"sgmv_fused": 2}
    assert torch.equal(got, again) and got.shape == (rows, m)
    want = _call(sgmv_fused_ref, x, pb, seg_tiles)
    err = (got - want).abs().max().item()
    assert err <= RTOL * want.abs().max().item(), err


def test_sgmv_apply_packed_cuda_casts_and_counts(cuda):
    """The serving entry: one launch per apply, output in x's dtype."""
    pb = _packed_layer(256, 384, 16, 2, 128, 4, cuda, seed=5)
    seg = torch.tensor([2, 0, 3, 1], dtype=torch.int32, device=cuda)
    x = torch.randn(4, 256, device=cuda, dtype=torch.bfloat16)
    pb = dataclasses.replace(pb, tile_t=1, seg=seg)
    reset_launch_counts()
    y = sgmv_apply_packed(x, pb, scaling=2.0)
    torch.cuda.synchronize()
    assert dict(LAUNCH_COUNTS) == {"sgmv_fused": 1}
    assert y.dtype == torch.bfloat16 and y.shape == (4, 384)
    want = 2.0 * _call(sgmv_fused_ref, x, pb, seg)
    torch.testing.assert_close(y.float(), want.to(torch.bfloat16).float(),
                               rtol=1e-2, atol=1e-2)


def _qlora(k, m, bits, rho, device, seed, r=16):
    gen = torch.Generator(device=device).manual_seed(seed)
    decay = torch.exp(-0.3 * torch.arange(r, device=device))
    b = torch.randn(m, r, generator=gen, device=device) * decay
    a = torch.randn(r, k, generator=gen, device=device) * decay[:, None]
    return quantize_lora(b, a, LoRAQuantConfig(
        rho=rho, bits_high=bits, group_size=128, refine="none"))


def _fused_args(q):
    kw = dict(m=q.b_high.orig_shape[0], bits_hi=q.a_high.bits,
              binary_hi=False, group_ah=q.a_high.group_size,
              group_bh=q.b_high.group_size)
    lo = (None, None)
    if q.a_low is not None:
        lo = (_kernel_layout(q.a_low)[:3], _kernel_layout(q.b_low)[:3])
        kw.update(group_al=q.a_low.group_size, group_bl=q.b_low.group_size)
    return (_kernel_layout(q.a_high)[:3], _kernel_layout(q.b_high)[:3],
            *lo), kw


@pytest.mark.parametrize("bits", [2, 3, 4])
@pytest.mark.parametrize("rho", [0.9, 1.0])
@pytest.mark.parametrize("k,m", [(384, 256), (256, 200), (640, 1152)])
@pytest.mark.parametrize("t", [5, 16])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_fused_lora_cuda_vs_plain(cuda, bits, rho, k, m, t, xdtype):
    """Any row count, with and without a low side, exactly m columns."""
    q = _qlora(k, m, bits, rho, cuda, seed=bits * 11 + k)
    assert (q.a_low is None) == (rho == 1.0)
    sides, kw = _fused_args(q)
    x = torch.randn(t, k, device=cuda).to(xdtype)
    reset_launch_counts()
    got = fused_lora(x, *sides, **kw)
    torch.cuda.synchronize()
    assert dict(LAUNCH_COUNTS) == {"fused_lora": 1}
    assert got.shape == (t, m) and got.dtype == torch.float32
    want = fused_lora_ref(x, *sides, **kw)
    err = (got - want).abs().max().item()
    assert err <= RTOL * want.abs().max().item(), err


@pytest.mark.parametrize("bits", [2, 3, 4])
@pytest.mark.parametrize("k,m", [(384, 256), (256, 200)])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_matmul_rhs_out_cuda_vs_plain(cuda, bits, k, m, xdtype):
    q = _qlora(k, m, bits, 0.9, cuda, seed=bits * 13 + m)
    x = torch.randn(21, k, device=cuda).to(xdtype)
    for qa, qb in ((q.a_high, q.b_high), (q.a_low, q.b_low)):
        binary = qa.mode == "binary"
        a, b = _kernel_layout(qa)[:3], _kernel_layout(qb)[:3]
        kw = dict(bits=qa.bits, binary=binary, group=qa.group_size)
        reset_launch_counts()
        h = matmul_rhs(x, *a, **kw)
        y = matmul_out(h, *b, **{**kw, "group": qb.group_size})
        torch.cuda.synchronize()
        assert dict(LAUNCH_COUNTS) == {"matmul_rhs": 1, "matmul_out": 1}
        h_want = matmul_rhs_ref(x, *a, **kw)
        y_want = matmul_out_ref(h, *b, **{**kw, "group": qb.group_size})
        assert y.shape == y_want.shape == (21, b[1].shape[1] * qb.group_size)
        for got, want in ((h, h_want), (y, y_want)):
            err = (got - want).abs().max().item()
            assert err <= RTOL * want.abs().max().item(), err


def test_lora_apply_quantized_cuda_routes(cuda):
    """Fused: one fused_lora; two-pass: matmul_rhs + matmul_out per side;
    both agree."""
    q = _qlora(384, 256, 2, 0.9, cuda, seed=3)
    x = torch.randn(7, 384, device=cuda, dtype=torch.bfloat16)
    reset_launch_counts()
    y1 = lora_apply_quantized(x, q, scaling=2.0)
    torch.cuda.synchronize()
    assert dict(LAUNCH_COUNTS) == {"fused_lora": 1}
    reset_launch_counts()
    y2 = lora_apply_quantized(x, q, scaling=2.0, fused=False)
    torch.cuda.synchronize()
    assert dict(LAUNCH_COUNTS) == {"matmul_rhs": 2, "matmul_out": 2}
    assert y1.dtype == y2.dtype == torch.bfloat16
    torch.testing.assert_close(y1.float(), y2.float(), rtol=1e-2, atol=1e-2)


# --------------------------------------------------------------------------
# the two-pass SGMV kernels, the single-side and two-sided sgmv_fused forms
# --------------------------------------------------------------------------

def _quantized(w, fmt, group, axis):
    if fmt == "binary":
        return binary_quantize(w, group, axis=axis)
    return rtn_quantize(w, int(fmt[3:]), group, axis=axis)


def _sides(k, m, fmt, r, na, device, seed, group=128):
    """``na`` adapters' A ``(r, K)`` and Bᵀ-view ``(M, r)`` factors of one
    format, as per-adapter QuantizedTensors."""
    gen = torch.Generator(device=device).manual_seed(seed)
    qas = [_quantized(torch.randn(r, k, generator=gen, device=device), fmt,
                      group, 1) for _ in range(na)]
    qbs = [_quantized(torch.randn(m, r, generator=gen, device=device), fmt,
                      group, 0) for _ in range(na)]
    return qas, qbs


def _close(got, want):
    assert got.shape == want.shape and torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= RTOL * want.abs().max().item(), err


@pytest.mark.parametrize("fmt", ["rtn2", "rtn3", "rtn4", "rtn8", "binary"])
@pytest.mark.parametrize("tile_t", [1, 8])
@pytest.mark.parametrize("k,m", [(384, 256), (256, 200), (640, 1152)])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_sgmv_two_pass_and_single_side_cuda_vs_plain(cuda, fmt, tile_t, k,
                                                     m, xdtype):
    """sgmv_rhs, sgmv_out (exactly m columns) and the single-side
    sgmv_fused, one launch each, against their plain versions."""
    na, n_tiles = 5, 6
    qas, qbs = _sides(k, m, fmt, 16, na, cuda, seed=k + m + tile_t)
    a, b = stack_adapter_side(qas), stack_adapter_side(qbs)
    gen = torch.Generator(device=cuda).manual_seed(tile_t + k)
    seg = torch.randint(0, na, (n_tiles,), generator=gen, device=cuda,
                        dtype=torch.int32)
    x = torch.randn(n_tiles * tile_t, k, generator=gen,
                    device=cuda).to(xdtype)
    kw_a = dict(bits=qas[0].bits, binary=fmt == "binary",
                group=qas[0].group_size, tile_t=tile_t)
    kw_b = dict(kw_a, group=qbs[0].group_size, m=m)
    fkw = dict(bits_a=kw_a["bits"], binary_a=kw_a["binary"],
               group_a=kw_a["group"], bits_b=kw_b["bits"],
               binary_b=kw_b["binary"], group_b=kw_b["group"], m=m,
               tile_t=tile_t)
    reset_launch_counts()
    h = sgmv_rhs(x, *a, seg, **kw_a)
    y = sgmv_out(h, *b, seg, **kw_b)
    f = sgmv_fused(x, *a, *b, seg, **fkw)
    torch.cuda.synchronize()
    assert dict(LAUNCH_COUNTS) == {"sgmv_rhs": 1, "sgmv_out": 1,
                                   "sgmv_fused": 1}
    assert y.shape == f.shape == (x.shape[0], m)
    _close(h, sgmv_rhs_ref(x, *a, seg, **kw_a))
    _close(y, sgmv_out_ref(h, *b, seg, **kw_b))
    _close(f, sgmv_fused_ref(x, *a, *b, seg, **fkw))


@pytest.mark.parametrize("tile_t", [1, 8])
@pytest.mark.parametrize("case", [
    # A_hi, B_hi widths; hi binary; lo (bits, binary); groups ah bh al bl
    (3, 4, False, (1, True), (128, 64, 64, 128)),
    (1, 1, True, (2, False), (64, 128, 128, 64)),
    (8, 2, False, (1, True), (128, 128, 128, 128)),
])
def test_sgmv_fused_two_sided_forms_cuda_vs_plain(cuda, tile_t, case, k=640,
                                                  m=192):
    """Separate A/B widths, a binary high side, a low side of another rank
    (8 against 16), format and groups; one launch."""
    bits_a, bits_b, bin_hi, (bits_lo, bin_lo), (ga, gb, gal, gbl) = case
    na = 4
    gen = torch.Generator(device=cuda).manual_seed(tile_t * 31 + bits_a)

    def side(rows, cols, bits, binary, group, axis):
        qs = [(binary_quantize(w, group, axis=axis) if binary
               else rtn_quantize(w, bits, group, axis=axis))
              for w in (torch.randn(rows, cols, generator=gen, device=cuda)
                        for _ in range(na))]
        return stack_adapter_side(qs)

    ah, bh = side(16, k, bits_a, bin_hi, ga, 1), side(m, 16, bits_b, bin_hi,
                                                     gb, 0)
    al, bl = side(8, k, bits_lo, bin_lo, gal, 1), side(m, 8, bits_lo, bin_lo,
                                                      gbl, 0)
    seg = torch.tensor([3, 0, 1, 3, 2], dtype=torch.int32, device=cuda)
    x = torch.randn(5 * tile_t, k, generator=gen, device=cuda)
    kw = dict(bits_a=bits_a, binary_a=bin_hi, group_a=ga, bits_b=bits_b,
              binary_b=bin_hi, group_b=gb, bits_lo=bits_lo,
              binary_lo=bin_lo, group_al=gal, group_bl=gbl, m=m,
              tile_t=tile_t)
    reset_launch_counts()
    got = sgmv_fused(x, *ah, *bh, seg, a_lo=al, b_lo=bl, **kw)
    torch.cuda.synchronize()
    assert dict(LAUNCH_COUNTS) == {"sgmv_fused": 1}
    _close(got, sgmv_fused_ref(x, *ah, *bh, seg, a_lo=al, b_lo=bl, **kw))


# the shared memory one block may opt in to on an H100 (227 KB)
SMEM_LIMIT = "needs [0-9]+ bytes of shared memory.*offers [0-9]+"


def test_sgmv_kernels_cuda_limits(cuda):
    """Rank rows are bounded by shared memory alone: a stack whose one K or
    M unit does not fit a block's opt-in shared memory raises ValueError
    naming the bytes needed and offered, before any launch; 72 rank rows
    (past the old cap of 64) launch."""
    qas, qbs = _sides(256, 256, "rtn2", 8192, 1, cuda, seed=1)
    a, b = stack_adapter_side(qas), stack_adapter_side(qbs)
    seg = torch.zeros(2, dtype=torch.int32, device=cuda)
    x = torch.randn(2, 256, device=cuda)
    h = torch.randn(2, 8192, device=cuda)
    reset_launch_counts()
    with pytest.raises(ValueError, match=SMEM_LIMIT):
        sgmv_rhs(x, *a, seg, bits=2, binary=False, tile_t=1)
    with pytest.raises(ValueError, match=SMEM_LIMIT):
        sgmv_out(h, *b, seg, bits=2, binary=False, tile_t=1)
    with pytest.raises(ValueError, match=SMEM_LIMIT):
        sgmv_fused(x, *a, *b, seg, bits_a=2, binary_a=False, group_a=128,
                   bits_b=2, binary_b=False, group_b=128, tile_t=1)
    assert not LAUNCH_COUNTS
    qas, qbs = _sides(256, 256, "rtn2", 72, 2, cuda, seed=1)
    a, b = stack_adapter_side(qas), stack_adapter_side(qbs)
    kw = dict(bits_a=2, binary_a=False, group_a=128, bits_b=2,
              binary_b=False, group_b=128, tile_t=1)
    _close(sgmv_fused(x, *a, *b, seg, **kw),
           sgmv_fused_ref(x, *a, *b, seg, **kw))


@pytest.mark.parametrize("fused", [True, False])
def test_sgmv_apply_cuda_counts_and_oracle(cuda, fused):
    """sgmv_apply: 1 sgmv_fused, or 1 sgmv_rhs + 1 sgmv_out; against the
    dense oracle ``ref_sgmv``; output in x's dtype."""
    qas, qbs = _sides(384, 200, "rtn3", 16, 3, cuda, seed=8)
    segs = [1, 0, 2, 2]
    x = torch.randn(32, 384, device=cuda)
    reset_launch_counts()
    y = sgmv_apply(x, qas, qbs, torch.tensor(segs, device=cuda), scaling=2.0,
                   tile_t=8, fused=fused)
    torch.cuda.synchronize()
    assert dict(LAUNCH_COUNTS) == ({"sgmv_fused": 1} if fused else
                                   {"sgmv_rhs": 1, "sgmv_out": 1})
    assert y.dtype == torch.float32 and y.shape == (32, 200)
    _close(y, 2.0 * ref.ref_sgmv(x, qas, qbs,
                                 [a for a in segs for _ in range(8)]))


def test_sgmv_apply_buckets_cuda(cuda):
    """Two layout buckets: one launch each over all rows, non-members
    masked; equal to each adapter's own sgmv_apply_packed."""
    pb2 = _packed_layer(256, 384, 16, 2, 128, 4, cuda, seed=21)
    pb4 = _packed_layer(256, 384, 16, 4, 128, 4, cuda, seed=22)
    luts = (torch.tensor([0, -1, 1, 2, -1, 3, -1, -1], dtype=torch.int32,
                         device=cuda),
            torch.tensor([-1, 0, -1, -1, 1, -1, 2, 3], dtype=torch.int32,
                         device=cuda))
    seg = torch.tensor([4, 0, 1, 3, 7, 2, 1], dtype=torch.int32, device=cuda)
    x = torch.randn(7, 256, device=cuda)
    pbs = PackedLoRABuckets(
        buckets=(dataclasses.replace(pb2, tile_t=1),
                 dataclasses.replace(pb4, tile_t=1)), lookups=luts, seg=seg)
    reset_launch_counts()
    y = sgmv_apply_buckets(x, pbs, scaling=2.0)
    torch.cuda.synchronize()
    assert dict(LAUNCH_COUNTS) == {"sgmv_fused": 2}
    for row, g in enumerate(seg.tolist()):
        bucket = 0 if luts[0][g] >= 0 else 1
        pb = pbs.buckets[bucket]
        local = luts[bucket][g].reshape(1)
        want = _call(sgmv_fused_ref, x[row:row + 1],
                     dataclasses.replace(pb, tile_t=1), local)
        _close(y[row:row + 1], 2.0 * want)


# --------------------------------------------------------------------------
# the cluster kernels (sgmv_fused, fused_lora) at the edges of their launch
# plan: K and M off the slice grid, K under one cluster's slices, widths
# 1/2/3/4/8 on every side, small groups (4-byte and byte copies), clamped
# adapter ids, staged chunks, the shared-memory limit, bitwise determinism
# --------------------------------------------------------------------------

def _fmt_side(gen, rows, cols, bits, binary, group, axis, device):
    w = torch.randn(rows, cols, generator=gen, device=device)
    return (binary_quantize(w, group, axis=axis) if binary
            else rtn_quantize(w, bits, group, axis=axis))


def _fmt_stack(gen, na, rows, cols, bits, binary, group, axis, device):
    return stack_adapter_side([_fmt_side(gen, rows, cols, bits, binary,
                                         group, axis, device)
                               for _ in range(na)])


EDGE_CASES = [
    # (K, M), hi (bits_a, bits_b, binary), lo (bits, binary) or None,
    # groups (ah, bh, al, bl), (r_hi, r_lo)
    ((250, 198), (4, 3, False), (1, True), (64, 32, 32, 64), (16, 8)),
    ((256, 3072), (2, 2, False), (1, True), (128, 128, 128, 128), (16, 16)),
    ((100, 60), (2, 2, False), (1, True), (100, 60, 100, 60), (8, 8)),
    ((256, 200), (2, 2, False), (1, True), (32, 32, 32, 32), (16, 16)),
    ((256, 200), (1, 1, True), (1, True), (8, 8, 16, 16), (16, 8)),
    ((384, 256), (1, 1, True), None, (128, 128, 0, 0), (16, 0)),
    ((640, 192), (8, 2, False), (2, False), (128, 64, 64, 128), (24, 16)),
    ((1000, 500), (3, 3, False), (1, True), (128, 128, 128, 128), (24, 16)),
    ((16384, 12288), (2, 2, False), (1, True), (128, 128, 128, 128), (16, 16)),
]


def _edge_args(case, tile_t, n_tiles, device, seed, na=4, seg=None,
               xdtype=torch.float32):
    (k, m), (ba, bb, bin_hi), lo, (ga, gb, gal, gbl), (r_hi, r_lo) = case
    gen = torch.Generator(device=device).manual_seed(seed)
    args = [None] + [*_fmt_stack(gen, na, r_hi, k, ba, bin_hi, ga, 1, device),
                     *_fmt_stack(gen, na, m, r_hi, bb, bin_hi, gb, 0,
                                 device)]
    kw = dict(bits_a=ba, binary_a=bin_hi, group_a=ga, bits_b=bb,
              binary_b=bin_hi, group_b=gb, m=m, tile_t=tile_t)
    if lo is not None:
        kw.update(a_lo=_fmt_stack(gen, na, r_lo, k, *lo, gal, 1, device),
                  b_lo=_fmt_stack(gen, na, m, r_lo, *lo, gbl, 0, device),
                  bits_lo=lo[0], binary_lo=lo[1], group_al=gal,
                  group_bl=gbl)
    if seg is None:
        seg = torch.randint(0, na, (n_tiles,), generator=gen, device=device,
                            dtype=torch.int32)
    args[0] = torch.randn(seg.shape[0] * tile_t, k, generator=gen,
                          device=device).to(xdtype)
    return args + [seg], kw


@pytest.mark.parametrize("tile_t", [1, 3, 8])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_sgmv_fused_cluster_edges_cuda_vs_plain(cuda, tile_t, case):
    args, kw = _edge_args(case, tile_t, 3, cuda, seed=tile_t)
    reset_launch_counts()
    got = sgmv_fused(*args, **kw)
    torch.cuda.synchronize()
    assert dict(LAUNCH_COUNTS) == {"sgmv_fused": 1}
    _close(got, sgmv_fused_ref(*args, **kw))


# every RTN width on A and on B; a binary high side is binary on both
WIDTH_PAIRS = [(a, b) for a in (2, 3, 4, 8) for b in (2, 3, 4, 8)] + [(1, 1)]


@pytest.mark.parametrize("bits_a,bits_b", WIDTH_PAIRS)
def test_sgmv_fused_every_width_pair_cuda_vs_plain(cuda, bits_a, bits_b):
    """Every width on A and on B, a low side of another width (1/2/3/4/8
    across the pairs), bf16 x, decode tiles."""
    lo_bits = {1: 2, 2: 1, 3: 4, 4: 8, 8: 3}[bits_a]
    case = ((640, 1152), (bits_a, bits_b, bits_a == 1),
            (lo_bits, lo_bits == 1), (128, 128, 64, 128), (16, 8))
    args, kw = _edge_args(case, 1, 6, cuda, seed=bits_a * 9 + bits_b,
                          xdtype=torch.bfloat16)
    _close(sgmv_fused(*args, **kw), sgmv_fused_ref(*args, **kw))


def test_sgmv_fused_clamps_adapter_ids_cuda(cuda):
    seg = torch.tensor([-3, 0, 7, 2, 99], dtype=torch.int32, device=cuda)
    args, kw = _edge_args(EDGE_CASES[1], 1, 5, cuda, seed=1, seg=seg)
    got = sgmv_fused(*args, **kw)
    torch.cuda.synchronize()
    _close(got, sgmv_fused_ref(*args, **kw))
    clamped = seg.clamp(0, 3)
    _close(got, sgmv_fused_ref(*args[:-1], clamped, **kw))


def test_cluster_kernels_bitwise_deterministic_cuda(cuda):
    """The cluster sums h in a fixed rank order, with no float atomics: two
    launches on the same inputs give the same bits (sgmv_fused, fused_lora,
    sgmv_rhs, matmul_rhs)."""
    args, kw = _edge_args(EDGE_CASES[-1], 8, 4, cuda, seed=3)
    first = sgmv_fused(*args, **kw)
    assert torch.equal(first, sgmv_fused(*args, **kw))
    rkw = dict(bits=2, binary=False, group=128, tile_t=8)
    h = sgmv_rhs(args[0], *args[1:4], args[-1], **rkw)
    assert torch.equal(h, sgmv_rhs(args[0], *args[1:4], args[-1], **rkw))
    q = _qlora(3072, 8192, 2, 0.9, cuda, seed=4)
    sides, fkw = _fused_args(q)
    for t in (16, 512):
        x = torch.randn(t, 3072, device=cuda, dtype=torch.bfloat16)
        y = fused_lora(x, *sides, **fkw)
        assert torch.equal(y, fused_lora(x, *sides, **fkw))
        h = matmul_rhs(x, *sides[0], bits=2, binary=False, group=128)
        assert torch.equal(h, matmul_rhs(x, *sides[0], bits=2, binary=False,
                                         group=128))


@pytest.mark.parametrize("t", [1, 13, 16, 37, 512])
@pytest.mark.parametrize("case", [c for c in EDGE_CASES  # one high width
                                  if c[1][0] == c[1][1]])
def test_fused_lora_cluster_edges_cuda_vs_plain(cuda, t, case):
    """fused_lora on adapter 0 of each edge case, any T (the plan picks
    tiles of 1..8 rows; the last one short)."""
    args, kw = _edge_args(case, 1, 1, cuda, seed=t, na=1)
    x = torch.randn(t, case[0][0], device=cuda)
    sides = [tuple(a[0] for a in args[1:4]), tuple(a[0] for a in args[4:7])]
    fkw = dict(m=kw["m"], bits_hi=kw["bits_a"], binary_hi=kw["binary_a"],
               group_ah=kw["group_a"], group_bh=kw["group_b"])
    if "a_lo" in kw:
        sides += [tuple(a[0] for a in kw["a_lo"]),
                  tuple(a[0] for a in kw["b_lo"])]
        fkw.update(bits_lo=kw["bits_lo"], binary_lo=kw["binary_lo"],
                   group_al=kw["group_al"], group_bl=kw["group_bl"])
    reset_launch_counts()
    got = fused_lora(x, *sides, **fkw)
    torch.cuda.synchronize()
    assert dict(LAUNCH_COUNTS) == {"fused_lora": 1}
    _close(got, fused_lora_ref(x, *sides, **fkw))


def test_fused_lora_cuda_limits(cuda):
    """48 + 48 rank rows (past the old cap of 64) launch; sides whose one
    K and M unit does not fit a block's opt-in shared memory raise
    ValueError naming the bytes needed and offered (matmul_rhs and
    matmul_out too), before any launch."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    a = _kernel_layout(_fmt_side(gen, 48, 256, 2, False, 128, 1, cuda))[:3]
    b = _kernel_layout(_fmt_side(gen, 256, 48, 2, False, 128, 0, cuda))[:3]
    x = torch.randn(4, 256, device=cuda)
    kw = dict(m=256, bits_hi=2, binary_hi=False, group_ah=128, group_bh=128,
              bits_lo=2, binary_lo=False, group_al=128, group_bl=128)
    _close(fused_lora(x, a, b, a, b, **kw),
           fused_lora_ref(x, a, b, a, b, **kw))
    a = _kernel_layout(_fmt_side(gen, 8192, 256, 2, False, 128, 1, cuda))[:3]
    b = _kernel_layout(_fmt_side(gen, 256, 8192, 2, False, 128, 0,
                                 cuda))[:3]
    skw = dict(bits=2, binary=False, group=128)
    reset_launch_counts()
    with pytest.raises(ValueError, match=SMEM_LIMIT):
        fused_lora(x, a, b, **{k: v for k, v in kw.items()
                               if not k.endswith("lo")
                               and k not in ("group_al", "group_bl")})
    with pytest.raises(ValueError, match=SMEM_LIMIT):
        matmul_rhs(x, *a, **skw)
    with pytest.raises(ValueError, match=SMEM_LIMIT):
        matmul_out(torch.randn(4, 8192, device=cuda), *b, **skw)
    assert not LAUNCH_COUNTS


# --------------------------------------------------------------------------
# the rhs kernels (matmul_rhs, sgmv_rhs) on the cluster path: the fused
# kernels' A sides at their edges (K off the slice grid, K under one
# cluster's slices, 3-bit 13-word groups, groups 8-128 with 4-byte and byte
# copies, staged chunks), R = 1 / 16 / 64, every width, clamped adapter
# ids, CUDA-graph capture
# --------------------------------------------------------------------------

RHS_CASES = [
    # K, bits, binary, group, R (unpadded)
    (250, 4, False, 64, 16),
    (250, 1, True, 32, 8),
    (100, 2, False, 100, 8),
    (256, 2, False, 32, 64),
    (256, 1, True, 16, 8),
    (256, 1, True, 8, 16),
    (640, 8, False, 128, 24),
    (640, 2, False, 64, 16),
    (640, 3, False, 128, 1),
    (1000, 3, False, 128, 24),
    (3072, 2, False, 128, 64),
    (16384, 2, False, 128, 16),
]


def _a_stack(gen, na, case, device):
    """``na`` adapters' A sides of one RHS case, stacked ``(NA, R, ·)`` with
    R unpadded."""
    k, bits, binary, group, r = case
    parts = [_kernel_layout(_fmt_side(gen, r, k, bits, binary, group, 1,
                                      device), pad_r=r)[:3]
             for _ in range(na)]
    return tuple(torch.stack([p[i] for p in parts]) for i in range(3))


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1, 13, 16, 37, 512])
@pytest.mark.parametrize("case", RHS_CASES)
def test_matmul_rhs_cluster_edges_cuda_vs_plain(cuda, case, t, xdtype):
    """Any T (the plan picks tiles of 1..8 rows; the last one short)."""
    k, bits, binary, group, r = case
    gen = torch.Generator(device=cuda).manual_seed(t * 5 + k)
    a = tuple(v[0] for v in _a_stack(gen, 1, case, cuda))
    x = torch.randn(t, k, generator=gen, device=cuda).to(xdtype)
    kw = dict(bits=bits, binary=binary, group=group)
    reset_launch_counts()
    h = matmul_rhs(x, *a, **kw)
    torch.cuda.synchronize()
    assert dict(LAUNCH_COUNTS) == {"matmul_rhs": 1}
    assert h.shape == (t, r) and h.dtype == torch.float32
    _close(h, matmul_rhs_ref(x, *a, **kw))


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile_t,n_tiles", [(1, 16), (3, 13), (8, 64)])
@pytest.mark.parametrize("case", RHS_CASES)
def test_sgmv_rhs_cluster_edges_cuda_vs_plain(cuda, case, tile_t, n_tiles,
                                              xdtype):
    """Tiles of 1 / 3 / 8 rows, each with its adapter; a binary stack
    without zero-points."""
    k, bits, binary, group, r = case
    na = 4
    gen = torch.Generator(device=cuda).manual_seed(tile_t * 7 + k)
    codes, scale, zero = _a_stack(gen, na, case, cuda)
    if binary:
        zero = None
    seg = torch.randint(0, na, (n_tiles,), generator=gen, device=cuda,
                        dtype=torch.int32)
    x = torch.randn(n_tiles * tile_t, k, generator=gen,
                    device=cuda).to(xdtype)
    kw = dict(bits=bits, binary=binary, group=group, tile_t=tile_t)
    reset_launch_counts()
    h = sgmv_rhs(x, codes, scale, zero, seg, **kw)
    torch.cuda.synchronize()
    assert dict(LAUNCH_COUNTS) == {"sgmv_rhs": 1}
    assert h.shape == (x.shape[0], r)
    _close(h, sgmv_rhs_ref(x, codes, scale, zero, seg, **kw))


def test_sgmv_rhs_clamps_adapter_ids_cuda(cuda):
    gen = torch.Generator(device=cuda).manual_seed(6)
    a = _a_stack(gen, 4, RHS_CASES[1], cuda)
    seg = torch.tensor([-3, 0, 7, 2, 99], dtype=torch.int32, device=cuda)
    x = torch.randn(10, 250, generator=gen, device=cuda)
    kw = dict(bits=1, binary=True, group=32, tile_t=2)
    got = sgmv_rhs(x, *a, seg, **kw)
    torch.cuda.synchronize()
    _close(got, sgmv_rhs_ref(x, *a, seg, **kw))
    _close(got, sgmv_rhs_ref(x, *a, seg.clamp(0, 3), **kw))


@pytest.mark.parametrize("name", ["matmul_rhs", "sgmv_rhs"])
def test_rhs_kernels_cuda_graph_replay(cuda, name):
    """The cluster launch (cudaLaunchKernelEx) is captured in a CUDA graph:
    a replay gives the eager result, and follows an in-place change of x."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    codes, scale, zero = _a_stack(gen, 4, RHS_CASES[-2], cuda)
    x = torch.randn(16, 3072, generator=gen, device=cuda,
                    dtype=torch.bfloat16)
    seg = torch.randint(0, 4, (16,), generator=gen, device=cuda,
                        dtype=torch.int32)
    kw = dict(bits=2, binary=False, group=128)

    def call():
        if name == "matmul_rhs":
            return matmul_rhs(x, codes[1], scale[1], zero[1], **kw)
        return sgmv_rhs(x, codes, scale, zero, seg, tile_t=1, **kw)

    eager = call()                       # first launch: build, attributes
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)
    x.copy_(torch.randn(16, 3072, generator=gen, device=cuda))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, call())


# --------------------------------------------------------------------------
# the out kernels (matmul_out, sgmv_out) on the cluster path, a B-only call
# of the fused kernels' phase 2: every width, groups 8-130 (byte, 4-byte and
# 16-byte copies; 3-bit groups of 13 words and the group-padded 3-bit Mp),
# M off the group grid (200, 198) and up to 8192, staged chunks, R = 1 / 16
# / 64, T 1-512, tiles of 1 / 2 / 4 / 8 rows with clamped adapter ids, two
# launches and a CUDA-graph replay bitwise equal, the large-M guard shape
# --------------------------------------------------------------------------

OUT_CASES = [
    # M, bits, binary, group, R (unpadded)
    (200, 2, False, 128, 16),
    (198, 2, False, 32, 8),
    (60, 2, False, 60, 8),
    (100, 1, True, 8, 16),
    (256, 1, True, 32, 8),
    (260, 3, False, 130, 16),
    (384, 3, False, 128, 24),
    (1000, 3, False, 128, 1),
    (640, 8, False, 64, 24),
    (8192, 4, False, 128, 16),
    (3072, 2, False, 128, 64),
]


def _b_stack(gen, na, case, device):
    """``na`` adapters' Bᵀ sides of one OUT case (B ``(M, R)`` grouped along
    M), stacked ``(NA, R, ·)`` with R unpadded."""
    m, bits, binary, group, r = case
    parts = [_kernel_layout(_fmt_side(gen, m, r, bits, binary, group, 0,
                                      device), pad_r=r)[:3]
             for _ in range(na)]
    return tuple(torch.stack([p[i] for p in parts]) for i in range(3))


@pytest.mark.parametrize("t", [1, 13, 16, 37, 512])
@pytest.mark.parametrize("case", OUT_CASES)
def test_matmul_out_cluster_path_cuda_vs_plain(cuda, case, t):
    """Any T (the plan picks tiles of 1..8 rows; the last one short); y over
    the group-padded width Mp = NG·group; two launches give the same
    bits."""
    m, bits, binary, group, r = case
    gen = torch.Generator(device=cuda).manual_seed(t * 3 + m)
    b = tuple(v[0] for v in _b_stack(gen, 1, case, cuda))
    h = torch.randn(t, r, generator=gen, device=cuda)
    kw = dict(bits=bits, binary=binary, group=group)
    reset_launch_counts()
    y = matmul_out(h, *b, **kw)
    torch.cuda.synchronize()
    assert dict(LAUNCH_COUNTS) == {"matmul_out": 1}
    mp = b[1].shape[-1] * group
    assert y.shape == (t, mp) and y.dtype == torch.float32
    _close(y, matmul_out_ref(h, *b, **kw))
    assert torch.equal(y, matmul_out(h, *b, **kw))


@pytest.mark.parametrize("tile_t", [1, 2, 4, 8])
@pytest.mark.parametrize("case", OUT_CASES)
def test_sgmv_out_cluster_path_cuda_vs_plain(cuda, case, tile_t):
    """Tiles of 1 / 2 / 4 / 8 rows, each with its adapter, ids out of range
    clamped; exactly m columns; a binary stack without zero-points; two
    launches give the same bits."""
    m, bits, binary, group, r = case
    na, n_tiles = 4, 13
    gen = torch.Generator(device=cuda).manual_seed(tile_t * 11 + m)
    codes, scale, zero = _b_stack(gen, na, case, cuda)
    if binary:
        zero = None
    seg = torch.randint(-2, na + 2, (n_tiles,), generator=gen, device=cuda,
                        dtype=torch.int32)
    h = torch.randn(n_tiles * tile_t, r, generator=gen, device=cuda)
    kw = dict(bits=bits, binary=binary, group=group, m=m, tile_t=tile_t)
    reset_launch_counts()
    y = sgmv_out(h, codes, scale, zero, seg, **kw)
    torch.cuda.synchronize()
    assert dict(LAUNCH_COUNTS) == {"sgmv_out": 1}
    assert y.shape == (h.shape[0], m)
    _close(y, sgmv_out_ref(h, codes, scale, zero, seg, **kw))
    _close(y, sgmv_out_ref(h, codes, scale, zero, seg.clamp(0, na - 1),
                           **kw))
    assert torch.equal(y, sgmv_out(h, codes, scale, zero, seg, **kw))


def test_out_kernels_large_m_guard_cuda(cuda):
    """The reference's large-M guard shape (M 32768, K 256, r 8, 128 rows):
    lora_apply_quantized takes the two-pass route, 1 matmul_rhs + 1
    matmul_out, and matmul_out stages its M slice chunk by chunk; sgmv_out
    at the same width."""
    q = _qlora(256, 32768, 2, 1.0, cuda, seed=13, r=8)
    x = torch.randn(128, 256, device=cuda)
    reset_launch_counts()
    y = lora_apply_quantized(x, q, scaling=2.0)
    torch.cuda.synchronize()
    assert dict(LAUNCH_COUNTS) == {"matmul_rhs": 1, "matmul_out": 1}
    sides, fkw = _fused_args(q)
    _close(y, 2.0 * fused_lora_ref(x, *sides, **fkw))
    b = _kernel_layout(q.b_high)[:3]
    h = torch.randn(128, b[0].shape[0], device=cuda)
    kw = dict(bits=2, binary=False, group=128)
    y = matmul_out(h, *b, **kw)
    _close(y, matmul_out_ref(h, *b, **kw))
    assert torch.equal(y, matmul_out(h, *b, **kw))
    stack = tuple(v[None] for v in b)
    seg = torch.zeros(16, dtype=torch.int32, device=cuda)
    y = sgmv_out(h, *stack, seg, m=32768, tile_t=8, **kw)
    _close(y, sgmv_out_ref(h, *stack, seg, m=32768, tile_t=8, **kw))


@pytest.mark.parametrize("name", ["matmul_out", "sgmv_out"])
def test_out_kernels_cuda_graph_replay(cuda, name):
    """The plain-block launch (cudaLaunchKernelEx) is captured in a CUDA
    graph: a replay gives the eager result bit for bit, and follows an
    in-place change of h."""
    gen = torch.Generator(device=cuda).manual_seed(14)
    codes, scale, zero = _b_stack(gen, 4, OUT_CASES[-1], cuda)
    h = torch.randn(16, 64, generator=gen, device=cuda)
    seg = torch.randint(0, 4, (16,), generator=gen, device=cuda,
                        dtype=torch.int32)
    kw = dict(bits=2, binary=False, group=128)

    def call():
        if name == "matmul_out":
            return matmul_out(h, codes[1], scale[1], zero[1], **kw)
        return sgmv_out(h, codes, scale, zero, seg, tile_t=1, **kw)

    eager = call()                       # first launch: build, attributes
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)
    h.copy_(torch.randn(16, 64, generator=gen, device=cuda))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, call())


# --------------------------------------------------------------------------
# any rank: all six kernels at 72 (past the old cap of 64), 128, 256 and
# 512 rank rows (a fused call's high + low sides, a one-sided call's one
# side), every width, decode and prefill tiles, against the plain version,
# two launches and a CUDA-graph replay bit for bit
# --------------------------------------------------------------------------

RANK_ROWS = (72, 128, 256, 512)
SIX = ("sgmv_fused", "fused_lora", "sgmv_rhs", "sgmv_out", "matmul_rhs",
       "matmul_out")


def _split(rows):
    """High and low rank rows of a fused call of ``rows`` rows: each a
    multiple of 8, the high side the larger."""
    hi = -(-rows // 16) * 8
    return hi, rows - hi


def _rank_case(name, rows, bits, tile_t, device, seed, k=640, m=1152,
               na=4, n_tiles=6):
    """``(kernel, plain, args, kwargs)`` of one call of ``name`` at ``rows``
    rank rows: RTN ``bits`` (binary for 1) on the high side, a binary low
    side on the fused kernels, group 128, bf16 x."""
    gen = torch.Generator(device=device).manual_seed(seed)
    binary = bits == 1
    t = n_tiles * tile_t
    x = torch.randn(t, k, generator=gen, device=device, dtype=torch.bfloat16)
    seg = torch.randint(0, na, (n_tiles,), generator=gen, device=device,
                        dtype=torch.int32)
    if name in ("sgmv_fused", "fused_lora"):
        hi, lo = _split(rows)
        a = _fmt_stack(gen, na, hi, k, bits, binary, 128, 1, device)
        b = _fmt_stack(gen, na, m, hi, bits, binary, 128, 0, device)
        al = _fmt_stack(gen, na, lo, k, 1, True, 128, 1, device)
        bl = _fmt_stack(gen, na, m, lo, 1, True, 128, 0, device)
        if name == "sgmv_fused":
            return (sgmv_fused, sgmv_fused_ref, (x, *a, *b, seg), dict(
                bits_a=bits, binary_a=binary, group_a=128, bits_b=bits,
                binary_b=binary, group_b=128, a_lo=al, b_lo=bl, bits_lo=1,
                binary_lo=True, group_al=128, group_bl=128, m=m,
                tile_t=tile_t))
        first = [tuple(v[0] for v in side) for side in (a, b, al, bl)]
        return (fused_lora, fused_lora_ref, (x, *first), dict(
            m=m, bits_hi=bits, binary_hi=binary, bits_lo=1, binary_lo=True,
            group_ah=128, group_bh=128, group_al=128, group_bl=128))
    kw = dict(bits=bits, binary=binary, group=128)
    if name.endswith("rhs"):
        a = _a_stack(gen, na, (k, bits, binary, 128, rows), device)
        if name == "matmul_rhs":
            return matmul_rhs, matmul_rhs_ref, (x, *(v[0] for v in a)), kw
        return sgmv_rhs, sgmv_rhs_ref, (x, *a, seg), dict(kw, tile_t=tile_t)
    b = _b_stack(gen, na, (m, bits, binary, 128, rows), device)
    h = torch.randn(t, rows, generator=gen, device=device)
    if name == "matmul_out":
        return matmul_out, matmul_out_ref, (h, *(v[0] for v in b)), kw
    return (sgmv_out, sgmv_out_ref, (h, *b, seg),
            dict(kw, m=m, tile_t=tile_t))


@pytest.mark.parametrize("rows", RANK_ROWS)
@pytest.mark.parametrize("name", SIX)
def test_kernels_any_rank_cuda_vs_plain(cuda, name, rows):
    """Every width on the high side (RTN 2/3/4/8, binary), decode (1-row)
    and prefill (8-row) tiles: one launch each, within RTOL of the plain
    version, and a second launch gives the same bits."""
    for bits in (1, 2, 3, 4, 8):
        for tile_t in (1, 8):
            fn, plain, args, kw = _rank_case(name, rows, bits, tile_t, cuda,
                                             seed=rows + 10 * bits + tile_t)
            reset_launch_counts()
            got = fn(*args, **kw)
            torch.cuda.synchronize()
            assert dict(LAUNCH_COUNTS) == {name: 1}, (bits, tile_t)
            _close(got, plain(*args, **kw))
            assert torch.equal(got, fn(*args, **kw)), (bits, tile_t)


@pytest.mark.parametrize("rows", RANK_ROWS)
@pytest.mark.parametrize("name", SIX)
def test_kernels_any_rank_cuda_graph_replay(cuda, name, rows):
    """At every rank-row count each kernel's launch is captured in a CUDA
    graph after one eager launch: a replay gives the eager bits, and
    follows an in-place change of its input."""
    fn, _, args, kw = _rank_case(name, rows, 2, 8, cuda, seed=rows)
    eager = fn(*args, **kw)                # first launch: attributes
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn(*args, **kw)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)
    args[0].copy_(torch.randn_like(args[0]))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, fn(*args, **kw))


def test_smem_mirror_equals_the_device_layout_cuda(cuda):
    """``kernel.py``'s ``_smem_bytes``, by which the plan sizes its chunks,
    equals the library's ``make_layout(...).total`` (the bytes a launch
    asks for) for every plan of the plan tests' grid: every shape, rank
    rows 2-512, every width."""
    import ctypes

    from test_torch_launch_plan import BIT_WIDTHS, _rank_plans
    from test_torch_launch_plan import RANK_ROWS as PLAN_ROWS
    from test_torch_launch_plan import SHAPES as PLAN_SHAPES

    from repro_torch.kernels.quant_matmul import build
    from repro_torch.kernels.quant_matmul.kernel import _smem_bytes

    lib = build.load_library()
    checked = 0
    for t, k, m, kt, groups in PLAN_SHAPES:
        x_bytes = 2 if k else 4
        for rows, bits, plan, sides in _rank_plans(t, k, m, kt, groups,
                                                    x_bytes):
            geom = []
            for side in sides:
                geom += ([0, 0, 1, 0] if side is None else
                         [bits, int(side[5]), side[0], side[1]])
            r_hi = next(s[4] for s in sides[:2] if s is not None)
            r_lo = next((s[4] for s in sides[2:] if s is not None), 0)
            device = lib.quant_matmul_layout_bytes(
                x_bytes, k, m, r_hi, r_lo, (ctypes.c_int * 16)(*geom),
                plan.c_args)
            mirror = _smem_bytes(plan.tile_rows, x_bytes,
                                 plan.k_chunk * plan.k_unit,
                                 plan.m_chunk * plan.m_unit, sides)
            assert mirror == device, (t, k, m, kt, groups, rows, bits)
            checked += 1
    assert checked == len(PLAN_SHAPES) * len(PLAN_ROWS) * len(BIT_WIDTHS)
