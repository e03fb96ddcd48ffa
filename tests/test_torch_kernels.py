"""Port vs reference: the packed layouts and the plain version of the
``sgmv_fused`` kernel (``repro_torch.kernels.quant_matmul`` against
``repro.kernels``, whose Pallas kernel runs with ``interpret=True`` on the
CPU). The CUDA kernel itself is held against ``sgmv_fused_ref`` on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import LoRAQuantConfig as JConfig
from repro.core import quantize_lora as j_quantize_lora
from repro.kernels import pack_adapter_layers as j_pack
from repro.kernels import sgmv_apply_packed as j_apply
from repro.kernels import stack_packed_adapters as j_stack
from repro.kernels.quant_matmul.kernel import sgmv_fused as j_sgmv_fused
from repro.kernels.quant_matmul.ops import _pick_tile as j_pick_tile
from repro_torch.bridge import quantized_lora
from repro_torch.kernels.quant_matmul import (
    LAUNCH_COUNTS,
    PLAIN_CALLS,
    pack_adapter_layers,
    ref,
    reset_launch_counts,
    retile_packed,
    sgmv_apply_packed,
    sgmv_fused,
    sgmv_fused_ref,
    stack_packed_adapters,
)
from repro_torch.kernels.quant_matmul.ops import _pick_tile


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

FIELDS = ("ah_codes", "ah_scale", "ah_zero", "bh_codes", "bh_scale",
          "bh_zero", "al_codes", "al_scale", "al_zero", "bl_codes",
          "bl_scale", "bl_zero")


@functools.lru_cache(maxsize=None)
def _jax_qlora(m, k, bits, rho, seed, r=16, decay=0.3):
    """A JAX-quantized adapter (cached: the tests share a few, which keeps
    JAX's per-shape compiles down)."""
    g = np.random.default_rng(seed)
    d = np.exp(-decay * np.arange(r))
    b = (g.normal(size=(m, r)) * d).astype(np.float32)
    a = (g.normal(size=(r, k)) * d[:, None]).astype(np.float32)
    return j_quantize_lora(jnp.asarray(b), jnp.asarray(a),
                           JConfig(rho=rho, bits_high=bits, ste_steps=0))


def _layers(jqls, tile_t):
    """The same adapters packed as one layer by JAX and by the port."""
    jpb = jax.tree_util.tree_map(
        lambda z: z[0], j_stack([j_pack([q]) for q in jqls], tile_t=tile_t))
    tpb = stack_packed_adapters(
        [pack_adapter_layers([quantized_lora(q, "cpu")]) for q in jqls],
        tile_t=tile_t).layer(0)
    return jpb, tpb


def _assert_layout_equal(jpb, tpb):
    for f in FIELDS:
        want = np.asarray(getattr(jpb, f))
        got = getattr(tpb, f).numpy()
        np.testing.assert_array_equal(got.astype(np.int64) if "codes" in f
                                      else got,
                                      want.astype(np.int64) if "codes" in f
                                      else want, err_msg=f)
    for f in ("bits_hi", "group_ah", "group_bh", "group_al", "group_bl", "k",
              "m", "rank", "tile_t", "fold"):
        assert getattr(tpb, f) == getattr(jpb, f), f


def _three_adapters(bits, m=200, k=256):
    """Split h differs across them; the last keeps every pair high."""
    return [_jax_qlora(m, k, bits, rho, seed=10 * bits + i)
            for i, rho in enumerate((0.5, 0.9, 1.0))]


@pytest.mark.parametrize("n,g", [(2112, 64), (2048, 128), (192, 128),
                                 (4096, 128), (2368, 64), (6144, 128),
                                 (8192, 128), (3072, 128)])
def test_pick_tile_matches_reference(n, g):
    assert _pick_tile(n, g) == j_pick_tile(n, g)


@pytest.mark.parametrize("bits", [2, 3, 4])
@pytest.mark.parametrize("tile_t", [1, 8])
def test_sgmv_fused_ref_vs_pallas(bits, tile_t, k=256, m=200):
    """Mixed split h (one adapter with h == r), both sub-LoRAs, two K
    groups, the m override (M = 200 pads B's second group): the port's
    packed layout is bit-exact and its plain version matches the Pallas
    kernel."""
    jqls = _three_adapters(bits)
    assert len({q.h for q in jqls}) > 1 and jqls[2].a_low is None
    jpb, tpb = _layers(jqls, tile_t)
    _assert_layout_equal(jpb, tpb)
    segs = np.asarray([1, 0, 2, 1], np.int32)
    x = np.random.default_rng(k + tile_t).normal(
        size=(len(segs) * tile_t, k)).astype(np.float32)
    kw = dict(bits_a=bits, binary_a=False, group_a=jpb.group_ah,
              bits_b=bits, binary_b=False, group_b=jpb.group_bh,
              bits_lo=1, binary_lo=True, group_al=jpb.group_al,
              group_bl=jpb.group_bl, m=m, tile_t=tile_t)
    want = np.asarray(j_sgmv_fused(
        jnp.asarray(x), jpb.ah_codes, jpb.ah_scale, jpb.ah_zero,
        jpb.bh_codes, jpb.bh_scale, jpb.bh_zero, jnp.asarray(segs),
        a_lo=(jpb.al_codes, jpb.al_scale, jpb.al_zero),
        b_lo=(jpb.bl_codes, jpb.bl_scale, jpb.bl_zero),
        interpret=True, **kw))
    got = sgmv_fused_ref(
        torch.from_numpy(x), tpb.ah_codes, tpb.ah_scale, tpb.ah_zero,
        tpb.bh_codes, tpb.bh_scale, tpb.bh_zero, torch.from_numpy(segs),
        a_lo=(tpb.al_codes, tpb.al_scale, tpb.al_zero),
        b_lo=(tpb.bl_codes, tpb.bl_scale, tpb.bl_zero), **kw).numpy()
    assert got.shape == want.shape == (x.shape[0], m)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * np.abs(want).max())


def test_sgmv_apply_packed_vs_reference_and_oracle():
    """The serving entry on the CPU: same output as JAX's
    ``sgmv_apply_packed`` and as the per-adapter dense oracle; one wrapper
    call, no kernel launch."""
    m, k, tile = 200, 256, 8
    jqls = _three_adapters(2)
    jpb, tpb = _layers(jqls, tile)
    segs = np.repeat([1, 0, 2, 1, 2], tile).astype(np.int32)
    x = np.random.default_rng(60).normal(size=(len(segs), k)).astype(
        np.float32)
    want = np.asarray(j_apply(jnp.asarray(x), dataclasses.replace(
        jpb, seg=jnp.asarray(segs)), scaling=1.5))
    reset_launch_counts()
    got = sgmv_apply_packed(torch.from_numpy(x), dataclasses.replace(
        tpb, seg=torch.from_numpy(segs)), scaling=1.5).numpy()
    assert dict(PLAIN_CALLS) == {"sgmv_fused": 1} and not LAUNCH_COUNTS
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * np.abs(want).max())
    oracle = np.stack([1.5 * np.asarray(x[i] @ jqls[a].delta_w().T)
                       for i, a in enumerate(segs)])
    np.testing.assert_allclose(got, oracle, rtol=1e-4, atol=1e-4)


def test_packed_stack_and_retile_layouts():
    """Per-adapter (L, Rp, ·) entries stack to (L, NA, Rp, ·) exactly as in
    JAX; retiling changes only the tile size; layer views slice L."""
    a0, a1, a2 = _three_adapters(2)
    jq = [[a0, a1], [a2, _jax_qlora(200, 256, 2, 0.9, seed=23)]]
    jst = j_stack([j_pack(qs) for qs in jq], tile_t=8)
    tst = stack_packed_adapters(
        [pack_adapter_layers([quantized_lora(q, "cpu") for q in qs]) for qs in jq],
        tile_t=8)
    assert tst.ah_codes.shape[:2] == (2, 2)
    _assert_layout_equal(jst, tst)
    tree = {"groups": [{"sub_0": {"mixer": {"wq": tst}}}]}
    one = retile_packed(tree, 1)["groups"][0]["sub_0"]["mixer"]["wq"]
    assert one.tile_t == 1 and one.ah_codes is tst.ah_codes
    _assert_layout_equal(jax.tree_util.tree_map(lambda z: z[1], jst),
                         tst.layer(1))
    # extra lead dim (per-expert adapters): fold=2 entries merge into the
    # adapter axis at index a * fold + e
    jf = j_stack([j_pack(qs, fold=2) for qs in jq], tile_t=1)
    tf = stack_packed_adapters(
        [pack_adapter_layers([quantized_lora(q, "cpu") for q in qs], fold=2)
         for qs in jq], tile_t=1)
    assert tf.ah_codes.shape[:2] == (1, 4) and tf.fold == 2
    _assert_layout_equal(jf, tf)


def test_wrapper_checks():
    m, k = 200, 256
    _, tpb = _layers(_three_adapters(2)[:1], 8)
    x = torch.randn(8, k)
    with pytest.raises(ValueError, match="segment ids"):
        sgmv_apply_packed(x, tpb)
    with pytest.raises(ValueError, match="tiles of"):
        sgmv_apply_packed(torch.randn(6, k), dataclasses.replace(
            tpb, seg=torch.zeros(6, dtype=torch.int32)))
    seg_tiles = torch.zeros(1, dtype=torch.int32)
    args = (x, tpb.ah_codes, tpb.ah_scale, tpb.ah_zero, tpb.bh_codes,
            tpb.bh_scale, tpb.bh_zero, seg_tiles)
    kw = dict(bits_a=2, binary_a=False, group_a=128, bits_b=2,
              binary_b=False, group_b=128, group_al=128, group_bl=128,
              a_lo=(tpb.al_codes, tpb.al_scale, tpb.al_zero),
              b_lo=(tpb.bl_codes, tpb.bl_scale, tpb.bl_zero), tile_t=8,
              m=m)
    with pytest.raises(NotImplementedError, match="low side"):
        sgmv_fused(*args, **{**kw, "a_lo": None})
    with pytest.raises(ValueError, match="bf16 or fp32"):
        sgmv_fused(x.double(), *args[1:], **kw)
    with pytest.raises(ValueError, match="seg_map"):
        sgmv_fused(*args[:7], torch.zeros(1, dtype=torch.int64), **kw)
    with pytest.raises(ValueError, match="tile_t <= 8"):   # one block's rows
        sgmv_fused(torch.randn(16, k), *args[1:], **{**kw, "tile_t": 16})
    assert sgmv_fused(*args, **kw).shape == (8, m)


def test_ref_oracles_match_reference():
    """The dense oracles of ``ref.py`` agree with the JAX package's."""
    from repro.kernels.quant_matmul import ref as jref

    q, q2 = _three_adapters(3)[1::-1]
    x = np.random.default_rng(91).normal(size=(5, 256)).astype(np.float32)
    tq = quantized_lora(q, "cpu")
    want = np.asarray(jref.ref_lora_apply(jnp.asarray(x), q.a_high,
                                          q.b_high))
    got = ref.ref_lora_apply(torch.from_numpy(x), tq.a_high,
                             tq.b_high).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * np.abs(want).max())
    segs = np.asarray([1, 0, 1, 1, 0])
    want = np.asarray(jref.ref_sgmv(jnp.asarray(x), [q.a_high, q2.a_high],
                                    [q.b_high, q2.b_high], segs))
    got = ref.ref_sgmv(torch.from_numpy(x), [tq.a_high,
                                             quantized_lora(q2, "cpu").a_high],
                       [tq.b_high, quantized_lora(q2, "cpu").b_high], segs).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * np.abs(want).max())
