"""Tests of the port that need an NVIDIA GPU: build the kernels
(``sgmv_fused``, ``fused_lora``, ``matmul_rhs``, ``matmul_out``) with nvcc
and hold each against its plain PyTorch version on the card. They skip
on a machine without CUDA. This file imports no JAX, so it also runs where
JAX is absent:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        -m cuda tests/test_torch_cuda.py -q
"""

import dataclasses

import pytest
import torch

from repro_torch.core import LoRAQuantConfig, quantize_lora
from repro_torch.kernels.quant_matmul import (
    LAUNCH_COUNTS,
    fused_lora,
    fused_lora_ref,
    lora_apply_quantized,
    matmul_out,
    matmul_out_ref,
    matmul_rhs,
    matmul_rhs_ref,
    pack_adapter_layers,
    reset_launch_counts,
    sgmv_apply_packed,
    sgmv_fused,
    sgmv_fused_ref,
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
