"""Port vs reference: the LoRAQuant quantization primitives
(``repro_torch.core.quant`` against ``repro.core.quant``), on the CPU.

Bit-exact: packing, RTN codes / scales / zero-points, binary codes and
every dequantized value that follows from them. Binary scales are
``mean(|w|)`` over a group, a float sum whose order is the backend's (XLA on
the CPU sums blocks of 32, then scales by 1/n): they agree to a few fp32
ulps, not bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro_torch.bridge import quantized_tensor
from repro_torch.core import quant as tq


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: torch's intra-op thread pool would only
    contend with the other test workers for the CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# |Δ| of a sum of ≤ 128 positive fp32 terms taken in another order.
BINARY_SCALE_RTOL = 1e-5


def _w(shape, seed, scale=1.0):
    g = np.random.default_rng(seed)
    return (g.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 8])
def test_pack_unpack_bit_exact(bits):
    g = np.random.default_rng(bits)
    codes = g.integers(0, 2**bits, size=(5, 3, 77)).astype(np.int32)
    want = np.asarray(jq.pack_codes(jnp.asarray(codes), bits))
    got = tq.pack_codes(torch.from_numpy(codes), bits)
    assert got.dtype == (torch.int32 if bits == 3 else torch.uint8)
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  want.astype(np.int64))
    back = tq.unpack_codes(got, bits, 77)
    np.testing.assert_array_equal(back.numpy(), codes)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jq.unpack_codes(jnp.asarray(want), bits, 77)))


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("shape,group,axis", [
    ((16, 384), 128, 1), ((200, 16), 128, 0), ((9, 100), 64, 1)])
def test_rtn_quantize_bit_exact(bits, shape, group, axis):
    w = _w(shape, seed=bits + shape[0], scale=0.3)
    jqt = jq.rtn_quantize(jnp.asarray(w), bits, group, axis)
    tqt = tq.rtn_quantize(torch.from_numpy(w), bits, group, axis)
    ref = quantized_tensor(jqt, "cpu")
    for f in ("codes", "scale", "zero"):
        np.testing.assert_array_equal(getattr(tqt, f).numpy(),
                                      getattr(ref, f).numpy(), err_msg=f)
    assert (tqt.group_size, tqt.orig_shape, tqt.mode) == (
        jqt.group_size, jqt.orig_shape, jqt.mode)
    np.testing.assert_array_equal(tqt.dequantize().numpy(),
                                  np.asarray(jqt.dequantize()))
    assert tq.storage_bits(tqt) == jq.storage_bits(jqt)


@pytest.mark.parametrize("shape,group,axis", [
    ((16, 384), 128, 1), ((200, 16), 128, 0), ((9, 100), 64, 1)])
def test_binary_quantize(shape, group, axis):
    w = _w(shape, seed=shape[1])
    jqt = jq.binary_quantize(jnp.asarray(w), group, axis)
    tqt = tq.binary_quantize(torch.from_numpy(w), group, axis)
    np.testing.assert_array_equal(tqt.codes.numpy(), np.asarray(jqt.codes))
    np.testing.assert_array_equal(tqt.zero.numpy(), np.asarray(jqt.zero))
    np.testing.assert_allclose(tqt.scale.numpy(), np.asarray(jqt.scale),
                               rtol=BINARY_SCALE_RTOL, atol=0)
    # fed the reference scales, the dequantized values are bit-exact
    ref = quantized_tensor(jqt, "cpu")
    np.testing.assert_array_equal(ref.dequantize().numpy(),
                                  np.asarray(jqt.dequantize()))
    assert tq.storage_bits(tqt) == jq.storage_bits(jqt)


@pytest.mark.parametrize("mode", ["rtn", "binary"])
def test_fake_quant_matches_and_is_straight_through(mode):
    w = _w((6, 256), seed=3, scale=0.5)
    wt = torch.from_numpy(w).requires_grad_(True)
    if mode == "rtn":
        want = np.asarray(jq.rtn_fake_quant(jnp.asarray(w), 2, 128, 1))
        got = tq.rtn_fake_quant(wt, 2, 128, 1)
        np.testing.assert_array_equal(got.detach().numpy(), want)
    else:
        want = np.asarray(jq.binary_fake_quant(jnp.asarray(w), 128, 1))
        got = tq.binary_fake_quant(wt, 128, 1)
        np.testing.assert_allclose(got.detach().numpy(), want,
                                   rtol=BINARY_SCALE_RTOL, atol=0)
    got.sum().backward()
    np.testing.assert_array_equal(wt.grad.numpy(), np.ones_like(w))


def test_batched_quantize_equals_per_entry():
    """Leading batch dims (the port's stand-in for ``vmap``) give each
    entry exactly what the 2-D call gives."""
    w = torch.from_numpy(_w((3, 16, 256), seed=9))
    qb = tq.rtn_quantize(w, 3, 128, axis=1)
    for i in range(3):
        qi = tq.rtn_quantize(w[i], 3, 128, axis=1)
        for f in ("codes", "scale", "zero"):
            assert torch.equal(getattr(qb.index(i), f), getattr(qi, f))
        assert torch.equal(qb.index(i).dequantize(), qi.dequantize())
