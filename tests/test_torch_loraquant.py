"""Port vs reference: SVD split, STE / ALS refinement and the LoRAQuant
pipeline (``repro_torch.core`` against ``repro.core``), on the CPU.

QR/SVD signs are free across LAPACK builds, so reparameterizations are
compared by ``b'a'`` and ``s``; codes are held bit-exact by feeding the
port the reference's split factors. The Adam STE loop can flip a rounding
after 100 steps, so ``refine="ste"`` is held by reconstruction error.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import decaying_lora
from repro.core import loraquant as jl
from repro.core import svd_split as jsvd
from repro_torch.bridge import quantized_lora
from repro_torch.core import loraquant as tl
from repro_torch.core import svd_split as tsvd


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: torch's intra-op thread pool would only
    contend with the other test workers for the CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# fp32 SVD of a rank-16 product: products and singular values agree to
# fp32 round-off relative to the largest singular value.
SVD_RTOL = 1e-5


def _pair(m=256, n=384, r=16, decay=0.3, seed=0):
    b, a = decaying_lora(m, n, r, decay, seed)
    return np.array(b), np.array(a)


def test_svd_reparam_matches_by_product_and_spectrum():
    b, a = _pair()
    jr = jsvd.svd_reparam(jnp.asarray(b), jnp.asarray(a))
    tr = tsvd.svd_reparam(torch.from_numpy(b), torch.from_numpy(a))
    s0 = float(np.asarray(jr.s)[0])
    np.testing.assert_allclose(tr.s.numpy(), np.asarray(jr.s),
                               atol=SVD_RTOL * s0)
    np.testing.assert_allclose((tr.b_prime @ tr.a_prime).numpy(),
                               np.asarray(jr.b_prime @ jr.a_prime),
                               atol=SVD_RTOL * s0)
    np.testing.assert_allclose((tr.b_prime @ tr.a_prime).numpy(), b @ a,
                               atol=SVD_RTOL * s0)
    # batched over a layer stack = per layer
    bs = torch.from_numpy(np.stack([b, 2 * b]))
    as_ = torch.from_numpy(np.stack([a, a]))
    st = tsvd.svd_reparam_stack(bs, as_)
    np.testing.assert_allclose(st.s[1].numpy(), 2 * tr.s.numpy(),
                               rtol=SVD_RTOL)


@pytest.mark.parametrize("rho", [0.5, 0.9, 0.99, 1.0])
def test_select_h_and_split(rho):
    s = np.exp(-0.3 * np.arange(16)).astype(np.float32)
    h = tsvd.select_h(torch.from_numpy(s), rho)
    assert h == jsvd.select_h(s, rho)
    rep = tsvd.SVDReparam(torch.zeros(8, 16), torch.zeros(16, 4),
                          torch.from_numpy(s))
    (bh, ah), low = tsvd.split_at(rep, h)
    assert bh.shape == (8, h) and ah.shape == (h, 4)
    assert (low is None) == (h == 16)


@pytest.mark.parametrize("bits", [2, 3, 4])
@pytest.mark.parametrize("rho", [0.8, 1.0])
def test_quantize_split_bit_exact_on_reference_factors(bits, rho):
    """refine='none': fed JAX's reparameterized split, the port's storage
    quantization reproduces JAX's QuantizedLoRA bit for bit."""
    b, a = _pair(seed=bits)
    cfg = jl.LoRAQuantConfig(rho=rho, bits_high=bits, refine="none")
    want = jl.quantize_lora(jnp.asarray(b), jnp.asarray(a), cfg)
    rep = jsvd.svd_reparam(jnp.asarray(b), jnp.asarray(a))
    (bh, ah), low = jsvd.split_at(rep, want.h)
    tt = lambda z: torch.from_numpy(np.array(z))
    low = None if low is None else (tt(low[0]), tt(low[1]))
    got = tl._quantize_split(tt(bh), tt(ah), low, want.h, want.rank,
                             tl.LoRAQuantConfig(rho=rho, bits_high=bits,
                                                refine="none"))
    ref = quantized_lora(want, "cpu")
    assert (got.h, got.rank) == (ref.h, ref.rank)
    sides = ["b_high", "a_high"] + (["b_low", "a_low"] if low else [])
    assert (got.b_low is None) == (low is None)
    for side in sides:
        g, r = getattr(got, side), getattr(ref, side)
        np.testing.assert_array_equal(g.codes.numpy(), r.codes.numpy())
        np.testing.assert_array_equal(g.zero.numpy(), r.zero.numpy())
        if g.mode == "rtn":
            np.testing.assert_array_equal(g.scale.numpy(), r.scale.numpy())
        else:
            np.testing.assert_allclose(g.scale.numpy(), r.scale.numpy(),
                                       rtol=1e-5)
    assert got.total_bits() == want.total_bits()
    assert got.avg_bits() == pytest.approx(want.avg_bits())


def _recon_err(q, b, a):
    dw = b @ a
    return float(np.linalg.norm(np.asarray(q.delta_w()) - dw)
                 / np.linalg.norm(dw))


@pytest.mark.parametrize("refine", ["ste", "als", "none"])
def test_quantize_lora_reconstruction_matches_reference(refine):
    """End to end, each side on its own SVD: the port's reconstruction
    error tracks the reference's (STE may flip a few roundings)."""
    b, a = _pair(decay=0.25, seed=11)
    kw = dict(rho=0.9, bits_high=2, refine=refine, ste_steps=100)
    want = jl.quantize_lora(jnp.asarray(b), jnp.asarray(a),
                            jl.LoRAQuantConfig(**kw))
    got = tl.quantize_lora(torch.from_numpy(b), torch.from_numpy(a),
                           tl.LoRAQuantConfig(**kw))
    assert got.h == want.h and got.total_bits() == want.total_bits()
    e_got, e_want = _recon_err(got, b, a), _recon_err(want, b, a)
    assert e_got == pytest.approx(e_want, rel=0.03)


def test_ste_refine_lowers_loss():
    """Alg. 2 descends its own objective from the unrefined start."""
    from repro_torch.core.ste import optimize_pairs, pair_loss

    b, a = _pair(m=128, n=256, r=6, seed=4)
    bt, at = torch.from_numpy(b), torch.from_numpy(a)
    before = pair_loss(bt.T, at, bt.T, at, "rtn", 2, 128).sum()
    bo, ao = optimize_pairs(bt, at, mode="rtn", bits=2, group_size=128,
                            steps=100, lr=1e-3)
    after = pair_loss(bo.T, ao, bt.T, at, "rtn", 2, 128).sum()
    assert float(after) < float(before)


def test_quantize_lora_stacks_equals_per_layer():
    """Batched (shape-bucketed, per-h) pipeline = per-layer quantize_lora."""
    pairs = [_pair(m=128, n=256, decay=d, seed=s)
             for d, s in [(0.2, 1), (0.5, 2), (0.3, 3)]]
    bs = torch.from_numpy(np.stack([p[0] for p in pairs]))
    as_ = torch.from_numpy(np.stack([p[1] for p in pairs]))
    cfg = tl.LoRAQuantConfig(rho=0.9, refine="none")
    stacked = tl.quantize_lora_stacks([(bs[:2], as_[:2]), (bs[2:], as_[2:])],
                                      cfg)
    flat = stacked[0] + stacked[1]
    assert len({q.h for q in flat}) > 1
    for i, q in enumerate(flat):
        ref = tl.quantize_lora(bs[i], as_[i], cfg)
        assert q.h == ref.h
        torch.testing.assert_close(q.delta_w(), ref.delta_w(), rtol=0,
                                   atol=1e-4 * float(ref.delta_w().abs().max()))


def test_recipe_signature():
    r = tl.QuantRecipe(bits_high=3, rho=0.95)
    assert r.layout_signature == (3, 128, 1)
    assert r.variant_name == "loraquant(3@0.95)"
    assert dataclasses.asdict(r).keys() == dataclasses.asdict(
        jl.LoRAQuantConfig()).keys()
