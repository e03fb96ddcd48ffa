"""Port vs reference: the Table-1 baselines (``core/baselines.py``) and the
ablation variants of Figs. 2-4 (``core/ablations.py``) (ROADMAP A7), fp32
on the CPU, every input from a numpy seed.

Bits and parameter counts are held exactly. Dequantized factors are held
to fp32 tolerance: GPTQ runs in float64 on both sides (numpy on the host
in the reference), PB-LLM and BiLLM keep numpy's float32 / float64 mix,
and the two frameworks sum in different orders. SVD splits are compared by
product (QR / SVD signs are free across LAPACK builds).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import decaying_lora
from repro.core import LoRAQuantConfig as JConfig
from repro.core import ablations as jab
from repro.core import baselines as jbl
from repro_torch.bridge import quantized_lora
from repro_torch.core import LoRAQuantConfig as TConfig
from repro_torch.core import ablations as tab
from repro_torch.core import baselines as tbl

# dequantized factors, relative to the factor's max |value|
DEQ_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(m=256, n=384, r=16, decay=0.3, seed=0):
    b, a = decaying_lora(m, n, r, decay, seed)
    return np.array(b), np.array(a)


def tt(x):
    return torch.from_numpy(np.array(x))


def close(got, want, rtol=DEQ_RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def same_pair(got, want):
    assert got.name == want.name
    assert got.total_bits == want.total_bits
    assert got.num_params == want.num_params
    assert got.avg_bits == want.avg_bits
    close(got.b_deq, want.b_deq)
    close(got.a_deq, want.a_deq)
    close(got.delta_w(), want.delta_w())


# --------------------------------------------------------------------------
# baselines
# --------------------------------------------------------------------------

BASELINES = {
    "bin": (lambda m: m.bin_lora, ()),
    "rtn1": (lambda m: m.rtn_lora, (1,)),
    "rtn2": (lambda m: m.rtn_lora, (2,)),
    "rtn3": (lambda m: m.rtn_lora, (3,)),
    "gptq2": (lambda m: m.gptq_lora, (2,)),
    "gptq3": (lambda m: m.gptq_lora, (3,)),
    "pbllm": (lambda m: m.pbllm_lora, ()),
    "billm": (lambda m: m.billm_lora, ()),
}


@pytest.mark.parametrize("shape", [(256, 384, 16), (200, 130, 8)])
@pytest.mark.parametrize("name", sorted(BASELINES))
def test_baseline_matches_reference(name, shape):
    """Every Table-1 baseline on a decaying-spectrum adapter: dequantized
    factors within fp32 tolerance, bits and parameter counts exact (the
    second shape has groups that do not divide the factor)."""
    fn, args = BASELINES[name]
    b, a = _pair(*shape, seed=len(name))
    want = fn(jbl)(jnp.asarray(b), jnp.asarray(a), *args)
    same_pair(fn(tbl)(tt(b), tt(a), *args), want)


def test_gptq_with_hessians_matches_reference():
    """Calibration Hessians for both factors (one of them with a dead input
    column, which GPTQ zeroes)."""
    rng = np.random.default_rng(3)
    b, a = _pair(96, 160, 8, seed=3)
    x = rng.normal(size=(512, 160)).astype(np.float32)
    x[:, 7] = 0.0                                     # a dead input
    ha = (x.T @ x).astype(np.float64)
    xa = x @ a.T
    hb = (xa.T @ xa).astype(np.float64)
    want = jbl.gptq_lora(jnp.asarray(b), jnp.asarray(a), 2, hessian_b=hb,
                         hessian_a=ha)
    got = tbl.gptq_lora(tt(b), tt(a), 2, hessian_b=tt(hb), hessian_a=tt(ha))
    same_pair(got, want)
    assert float(got.a_deq[:, 7].abs().max()) == 0.0


@pytest.mark.parametrize("kind", ["gptq", "pbllm", "billm"])
def test_batched_matrix_equals_per_matrix(kind):
    """A stack ``(L, rows, cols)`` in one call: each matrix as the
    reference quantizes it alone, the bits summed."""
    rng = np.random.default_rng(5)
    ws = rng.normal(size=(3, 16, 300)).astype(np.float32) * 0.1
    fns = {"gptq": (lambda m, w: m.gptq_matrix(w, None, 2)),
           "pbllm": (lambda m, w: m.pbllm_matrix(w)),
           "billm": (lambda m, w: m.billm_matrix(w))}
    got, bits = fns[kind](tbl, tt(ws))
    total = 0.0
    for i in range(3):
        want, wb = fns[kind](jbl, ws[i])
        close(got[i], want)
        total += wb
    assert bits == total


def test_billm_and_pbllm_ties_and_even_median():
    """Repeated magnitudes: PB-LLM's threshold is the k-th largest with
    ties kept salient (``np.partition``), BiLLM's median averages the two
    middle values of an even count (``np.median``) and its salient columns
    follow numpy's argsort."""
    w = np.tile(np.array([[0.5, -0.5, 0.25, -0.25, 0.125, 1.0, -2.0, 0.75]],
                         np.float32), (4, 16))
    w[1] *= 2.0
    for fn in ("pbllm_matrix", "billm_matrix"):
        want, wb = getattr(jbl, fn)(w)
        got, gb = getattr(tbl, fn)(tt(w))
        assert gb == wb, fn
        close(got, want)


def test_jd_diagonal_matches_reference_by_products():
    """The shared basis is only defined up to signs: every adapter's
    reconstructed product and the AvgBits are compared."""
    loras = [_pair(128, 96, 8, seed=s) for s in range(3)]
    want = jbl.jd_diagonal_fit([(jnp.asarray(b), jnp.asarray(a))
                                for b, a in loras], iters=10)
    got = tbl.jd_diagonal_fit([(tt(b), tt(a)) for b, a in loras], iters=10)
    assert got.avg_bits() == want.avg_bits()
    for k in range(3):
        gb, ga = got.reconstruct(k)
        wb, wa = want.reconstruct(k)
        close(gb @ ga, np.asarray(wb) @ np.asarray(wa), 1e-4)


# --------------------------------------------------------------------------
# ablations (Figs. 2-4)
# --------------------------------------------------------------------------

VARIANTS = {
    "random_static": dict(split_strategy="random", static_h=5, use_opt=False,
                          seed=3),
    "norm_static": dict(split_strategy="norm", static_h=4, use_opt=False),
    "random_dynamic": dict(split_strategy="random", use_opt=False, seed=1),
    "norm_dynamic": dict(split_strategy="norm", use_opt=False),
    "norm_prune": dict(split_strategy="norm", static_h=6, use_opt=False,
                       prune_low=True),
    "norm_rtn1_low": dict(split_strategy="norm", static_h=6, use_opt=False,
                          low_quantizer="rtn1"),
    "norm_full_rank": dict(split_strategy="norm", static_h=99, use_opt=False),
}


def _same_codes(got, want):
    assert (got.h, got.rank) == (want.h, want.rank)
    assert got.total_bits() == want.total_bits()
    ref = quantized_lora(want, "cpu")
    assert (got.b_low is None) == (ref.b_low is None)
    sides = ["b_high", "a_high"] + ([] if ref.b_low is None
                                    else ["b_low", "a_low"])
    for side in sides:
        g, r = getattr(got, side), getattr(ref, side)
        assert (g.mode, g.bits) == (r.mode, r.bits), side
        np.testing.assert_array_equal(g.codes.numpy(), r.codes.numpy())
        np.testing.assert_array_equal(g.zero.numpy(), r.zero.numpy())
        np.testing.assert_allclose(g.scale.numpy(), r.scale.numpy(),
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_deterministic_split_bit_exact(variant):
    """Random and norm splits without refinement: the same components are
    picked, so h, codes, zeros and bits are the reference's exactly."""
    kw = VARIANTS[variant]
    b, a = _pair(seed=7)
    want = jab.quantize_lora_variant(jnp.asarray(b), jnp.asarray(a),
                                     JConfig(rho=0.9, bits_high=2), **kw)
    got = tab.quantize_lora_variant(tt(b), tt(a),
                                    TConfig(rho=0.9, bits_high=2), **kw)
    _same_codes(got, want)


@pytest.mark.parametrize("kw", [
    dict(split_strategy="svd", static_h=4, use_opt=False),
    dict(split_strategy="svd", use_opt=False, low_quantizer="rtn1"),
    dict(split_strategy="svd", static_h=3, prune_low=True, use_opt=False),
    dict(split_strategy="svd", use_opt=True),
    dict(split_strategy="norm", static_h=5, use_opt=True),
], ids=["svd_static", "svd_rtn1_low", "svd_prune", "svd_default",
        "norm_ste"])
def test_variant_svd_and_ste_by_product(kw):
    """SVD splits (signs free) and STE-refined variants (Adam can flip a
    rounding): h, bits and layout exact, reconstructed products within
    3 % of the reference's reconstruction error."""
    b, a = _pair(decay=0.25, seed=11)
    cfg = dict(rho=0.9, bits_high=2, ste_steps=40)
    want = jab.quantize_lora_variant(jnp.asarray(b), jnp.asarray(a),
                                     JConfig(**cfg), **kw)
    got = tab.quantize_lora_variant(tt(b), tt(a), TConfig(**cfg), **kw)
    assert (got.h, got.rank, got.total_bits()) == (want.h, want.rank,
                                                    want.total_bits())
    assert (got.b_low is None) == (want.b_low is None)
    dw = b @ a
    e_got = np.linalg.norm(got.delta_w().numpy() - dw) / np.linalg.norm(dw)
    e_want = np.linalg.norm(np.asarray(want.delta_w()) - dw) / np.linalg.norm(
        dw)
    assert e_got == pytest.approx(e_want, rel=0.03)


def test_split_factors_match_reference():
    b, a = _pair(seed=2)
    for strategy in ("random", "norm"):
        (wh, wl) = jab._split_factors(jnp.asarray(b), jnp.asarray(a), 6,
                                      strategy, seed=4)
        (gh, gl) = tab._split_factors(tt(b), tt(a), 6, strategy, seed=4)
        for g, w in zip(gh + gl, wh + wl):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
