"""Port vs reference: the single-adapter apply from packed codes
(``repro_torch.kernels.quant_matmul`` against ``repro.kernels``, whose
Pallas kernels run with ``interpret=True`` on the CPU). On the CPU the
port's ``fused_lora``, ``matmul_rhs`` and ``matmul_out`` wrappers return
their plain versions; the CUDA kernels are held against those on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import LoRAQuantConfig as JConfig
from repro.core import QuantizedLoRA as JQuantizedLoRA
from repro.core import quantize_lora as j_quantize_lora
from repro.core.quant import binary_quantize as j_binary_quantize
from repro.kernels.quant_matmul import kernel as jk
from repro.kernels.quant_matmul import ops as jops
from repro_torch.bridge import quantized_lora
from repro_torch.kernels.quant_matmul import (
    LAUNCH_COUNTS,
    PLAIN_CALLS,
    fused_lora,
    lora_apply_quantized,
    matmul_out,
    matmul_rhs,
    quant_matmul_rhs,
    reset_launch_counts,
)
from repro_torch.kernels.quant_matmul.ops import (
    FUSED_VMEM_BUDGET,
    _fused_vmem_estimate,
    _kernel_layout,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: torch's intra-op thread pool would only
    contend with the other test workers for the CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# fp32 tolerance: the port and JAX sum the same fp32 products in different
# orders; relative to the output's magnitude.
RTOL = 1e-5


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _qlora(m, k, r=16, rho=0.9, bits=2, group=128, binary_hi=False, seed=0):
    """A JAX adapter with a fixed decaying spectrum (``rho`` fixes h).
    ``binary_hi`` builds the high side from 1-bit sign codes instead, with no
    low side (a format the fused kernels accept, though LoRAQuant's pipeline
    never makes it)."""
    rng = np.random.default_rng(seed)
    u = np.linalg.qr(rng.normal(size=(m, r)))[0]
    v = np.linalg.qr(rng.normal(size=(k, r)))[0]
    s = np.exp(-0.4 * np.arange(r))
    b = jnp.asarray((u * np.sqrt(s)).astype(np.float32))
    a = jnp.asarray((np.sqrt(s)[:, None] * v.T).astype(np.float32))
    cfg = JConfig(rho=rho, bits_high=bits, group_size=group, ste_steps=0)
    if binary_hi:
        return JQuantizedLoRA(
            b_high=j_binary_quantize(b, group, axis=0),
            a_high=j_binary_quantize(a, group, axis=1),
            b_low=None, a_low=None, h=r, rank=r, config=cfg)
    return j_quantize_lora(b, a, cfg)


def _x(t, k, seed):
    return np.random.default_rng(seed).normal(size=(t, k)).astype(np.float32)


def _layouts(jq):
    """The kernel layouts of each side, by JAX and by the port (which must
    agree bit for bit)."""
    tq = quantized_lora(jq, "cpu")
    out = {}
    for f in ("a_high", "b_high", "a_low", "b_low"):
        if getattr(jq, f) is None:
            continue
        jl = jops._kernel_layout(getattr(jq, f))[:3]
        tl = _kernel_layout(getattr(tq, f))[:3]
        for j, t in zip(jl, tl):
            np.testing.assert_array_equal(t.numpy().astype(np.int64),
                                          np.asarray(j).astype(np.int64))
        out[f] = (jl, tl)
    return out


# (m, k, r, rho, bits, group, binary_hi): the low side present or not,
# 3-bit padding, binary high side, K = 2112 with 64-wide groups (the
# test_odd_k_apply_regression shape)
CASES = {
    "2bit": (256, 256, 16, 0.9, 2, 128, False),
    "3bit": (256, 256, 16, 0.9, 3, 128, False),
    "4bit": (256, 384, 16, 0.8, 4, 128, False),
    "h_eq_r": (256, 256, 16, 1.0, 2, 128, False),
    "binary_hi": (256, 256, 16, 1.0, 1, 128, True),
    "odd_k": (256, 2112, 8, 0.9, 2, 64, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_lora_vs_pallas(case):
    m, k, r, rho, bits, group, binary_hi = CASES[case]
    jq = _qlora(m, k, r, rho, bits, group, binary_hi)
    assert (jq.a_low is None) == (rho == 1.0)
    lay = _layouts(jq)
    x = _x(8, k, seed=k + bits)
    kw = dict(m=m, bits_hi=jq.a_high.bits, binary_hi=binary_hi,
              group_ah=jq.a_high.group_size, group_bh=jq.b_high.group_size)
    lo_j = lo_t = (None, None)
    if jq.a_low is not None:
        kw.update(bits_lo=1, binary_lo=True, group_al=jq.a_low.group_size,
                  group_bl=jq.b_low.group_size)
        lo_j = (lay["a_low"][0], lay["b_low"][0])
        lo_t = (lay["a_low"][1], lay["b_low"][1])
    want = jk.fused_lora(jnp.asarray(x), lay["a_high"][0], lay["b_high"][0],
                         *lo_j, tile_t=8,
                         tile_k=jops._pick_tile(k, jq.a_high.group_size),
                         interpret=True, **kw)
    reset_launch_counts()
    got = fused_lora(torch.from_numpy(x), lay["a_high"][1],
                     lay["b_high"][1], *lo_t, **kw)
    assert dict(PLAIN_CALLS) == {"fused_lora": 1} and not LAUNCH_COUNTS
    _close(got.numpy(), want)


# (k, r, bits, binary, group): each side format the two-pass path meets
SIDES = {
    "2bit": (256, 16, 2, False, 128),
    "3bit": (384, 8, 3, False, 128),
    "4bit": (256, 16, 4, False, 128),
    "8bit": (256, 8, 8, False, 128),
    "binary": (256, 16, 1, True, 128),
    "odd_k": (2112, 8, 2, False, 64),
}


def _side(k, r, bits, binary, group, seed):
    """One packed ``(R, K)`` row-grouped factor, by JAX and by the port."""
    from repro.core.quant import rtn_quantize as j_rtn
    from repro_torch.bridge import quantized_tensor

    w = jnp.asarray(np.random.default_rng(seed).normal(
        size=(r, k)).astype(np.float32))
    jq = (j_binary_quantize(w, group, axis=1) if binary
          else j_rtn(w, bits, group, axis=1))
    return jops._kernel_layout(jq)[:3], _kernel_layout(
        quantized_tensor(jq, "cpu"))[:3]


@pytest.mark.parametrize("case", sorted(SIDES))
def test_matmul_rhs_vs_pallas(case):
    k, r, bits, binary, group = SIDES[case]
    jl, tl = _side(k, r, bits, binary, group, seed=k + bits)
    x = _x(8, k, seed=bits)
    want = jk.matmul_rhs(jnp.asarray(x), *jl, bits=bits, binary=binary,
                         group=group, tile_t=8,
                         tile_k=jops._pick_tile(k, group), interpret=True)
    reset_launch_counts()
    got = matmul_rhs(torch.from_numpy(x), *tl, bits=bits, binary=binary,
                     group=group)
    assert dict(PLAIN_CALLS) == {"matmul_rhs": 1}
    _close(got.numpy(), want)


@pytest.mark.parametrize("case", sorted(SIDES))
def test_matmul_out_vs_pallas(case):
    """``Bᵀ (R, M)``: the output is the group-padded width, as on the TPU
    (M = 2112 with 64-wide groups is unpadded; M = 384 with 3-bit words
    pads every group's words)."""
    mp, r, bits, binary, group = SIDES[case]
    jl, tl = _side(mp, r, bits, binary, group, seed=mp + bits + 1)
    h = _x(8, tl[0].shape[0], seed=bits + 7)
    want = jk.matmul_out(jnp.asarray(h), *jl, bits=bits, binary=binary,
                         group=group, tile_t=8,
                         tile_m=jops._pick_tile(mp, group), interpret=True)
    reset_launch_counts()
    got = matmul_out(torch.from_numpy(h), *tl, bits=bits, binary=binary,
                     group=group)
    assert dict(PLAIN_CALLS) == {"matmul_out": 1}
    _close(got.numpy(), want)


# (m, k, r, rho, bits, group, t, kwargs): fused, two-pass, the budget
# guard forced on a small shape, and JAX's own large-M guard shape
APPLY = {
    "fused": (256, 256, 16, 0.9, 2, 128, 20, dict(fused=True)),
    "two_pass": (256, 256, 16, 0.9, 3, 128, 20, dict(fused=False)),
    "budget_1": (384, 512, 16, 0.8, 4, 128, 16,
                 dict(fused=True, vmem_budget=1)),
    "large_m_guard": (32768, 256, 8, 1.0, 2, 128, 128, dict(fused=True)),
}


@pytest.mark.parametrize("case", sorted(APPLY))
def test_lora_apply_quantized_vs_reference(case):
    """Same output and the same kernel choice as JAX: the port's plain calls
    per kernel equal JAX's launches for the same call."""
    m, k, r, rho, bits, group, t, kw = APPLY[case]
    jq = _qlora(m, k, r, rho, bits, group)
    tq = quantized_lora(jq, "cpu")
    if case == "large_m_guard":
        assert _fused_vmem_estimate(tq, 128, k) > FUSED_VMEM_BUDGET
    x = _x(t, k, seed=m + t)
    jk.reset_launch_counts()
    want = np.asarray(jops.lora_apply_quantized(
        jnp.asarray(x), jq, scaling=1.5, interpret=True, **kw))
    reset_launch_counts()
    got = lora_apply_quantized(torch.from_numpy(x), tq, scaling=1.5, **kw)
    assert dict(PLAIN_CALLS) == dict(jk.LAUNCH_COUNTS) and not LAUNCH_COUNTS
    assert got.dtype == torch.float32
    _close(got.numpy(), want)


def test_quant_matmul_rhs_vs_reference():
    """JAX's jitted ``quant_matmul_rhs`` traces ``bits`` and raises on every
    call (ROADMAP C5); the port is held against its body, un-jitted."""
    import jax

    jl, tl = _side(256, 16, 2, False, 128, seed=3)
    x = _x(16, 256, seed=4)
    with pytest.raises(jax.errors.TracerBoolConversionError):
        jops.quant_matmul_rhs(jnp.asarray(x), *jl, bits=2, binary=False)
    want = jops.quant_matmul_rhs.__wrapped__(jnp.asarray(x), *jl, bits=2,
                                             binary=False, interpret=True)
    _close(quant_matmul_rhs(torch.from_numpy(x), *tl, bits=2,
                            binary=False).numpy(), want)


def test_fused_lora_exact_m_where_reference_fails():
    """M = 200 is not a multiple of B's group (128): JAX's fused kernel
    writes the group-padded width into an M-wide block and raises (ROADMAP
    C4); the port's fused kernel writes exactly M columns and agrees with
    JAX's two-pass result."""
    m, k = 200, 256
    x = _x(5, k, seed=200)
    for bits in (2, 3):
        jq = _qlora(m, k, 16, 0.9, bits, 128)
        with pytest.raises(ValueError):
            jops.lora_apply_quantized(jnp.asarray(x), jq, interpret=True,
                                      fused=True)
        jk.reset_launch_counts()
        want = np.asarray(jops.lora_apply_quantized(
            jnp.asarray(x), jq, interpret=True, fused=False))
        assert dict(jk.LAUNCH_COUNTS) == {"matmul_rhs": 2, "matmul_out": 2}
        reset_launch_counts()
        got = lora_apply_quantized(torch.from_numpy(x),
                                   quantized_lora(jq, "cpu"), fused=True)
        assert dict(PLAIN_CALLS) == {"fused_lora": 1}
        _close(got.numpy(), want)


def test_wrapper_checks():
    jq = _qlora(256, 256, 16, 0.9, 2, 128)
    lay = {f: v[1] for f, v in _layouts(jq).items()}
    x = torch.randn(4, 256)
    kw = dict(m=256, bits_hi=2, binary_hi=False, group_ah=128, group_bh=128,
              bits_lo=1, binary_lo=True, group_al=128, group_bl=128)
    args = (lay["a_high"], lay["b_high"], lay["a_low"], lay["b_low"])
    assert fused_lora(x, *args, **kw).shape == (4, 256)
    assert fused_lora(torch.randn(3, 256), *args[:2], **kw).shape == (3, 256)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        fused_lora(x.double(), *args, **kw)
    with pytest.raises(ValueError, match="both low-side"):
        fused_lora(x, *args[:3], None, **kw)
    with pytest.raises(ValueError, match="do not cover"):
        fused_lora(torch.randn(4, 384), *args, **kw)
    with pytest.raises(ValueError, match="do not cover"):
        fused_lora(x, *args, **{**kw, "m": 512})
    with pytest.raises(ValueError, match="contiguous"):
        fused_lora(torch.randn(256, 4).T, *args, **kw)
    codes, scale, zero = lay["a_high"]
    with pytest.raises(ValueError, match="must be torch.int32"):
        matmul_rhs(x, codes, scale, zero, bits=3, binary=False, group=128)
    with pytest.raises(ValueError, match="explicit quant group"):
        matmul_rhs(x, codes.to(torch.int32), scale, zero, bits=3,
                   binary=False)
    with pytest.raises(ValueError, match="unsupported format"):
        matmul_rhs(x, codes, scale, zero, bits=2, binary=True)
    with pytest.raises(ValueError, match="float32"):
        matmul_out(torch.randn(4, codes.shape[0]).to(torch.bfloat16),
                   *lay["b_high"], bits=2, binary=False)
    assert matmul_rhs(x, codes, scale, zero, bits=2,
                      binary=False).shape == (4, codes.shape[0])
