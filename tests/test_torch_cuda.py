"""Tests of the port that need an NVIDIA GPU: build ``sgmv_fused`` with
nvcc and hold it against its plain PyTorch version on the card. They skip
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
    pack_adapter_layers,
    reset_launch_counts,
    sgmv_apply_packed,
    sgmv_fused,
    sgmv_fused_ref,
    stack_packed_adapters,
)

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
