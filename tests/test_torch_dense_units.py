"""Port vs reference: the building blocks of the dense variants
(``repro_torch.models.common`` / ``attention`` against ``repro.models``):
gemma's ``(1+w)`` RMSNorm and soft-cap, olmo's non-parametric LayerNorm,
qwen2-vl's M-RoPE, and soft-capped attention scores in the plain and the
blockwise SDPA. fp32 on the CPU, inputs from numpy seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as j_attn
from repro.models import common as j_common
from repro_torch.models import attention as t_attn
from repro_torch.models import common as t_common

# fp32 elementwise math and one softmax: the two frameworks round rsqrt,
# tanh, cos/sin and exp differently in the last bits
TOL = 1e-5


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1.0))


def _x(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)
            ).astype(np.float32)


@pytest.mark.parametrize("plus_one", [False, True])
def test_rmsnorm_matches_reference(plus_one):
    x, w = _x((3, 5, 64)), _x((64,), 1, 0.3)
    want = j_common.rmsnorm(jnp.asarray(x), jnp.asarray(w),
                            plus_one=plus_one)
    _close(t_common.rmsnorm(torch.from_numpy(x), torch.from_numpy(w),
                            plus_one=plus_one), want)


def test_nonparam_layernorm_is_the_population_standardization():
    """``jnp.var`` is the population variance; ``torch.var`` defaults to
    the unbiased one, which would scale every output by sqrt(n / (n-1))."""
    x = _x((4, 7, 32), 2, 3.0) + 1.5
    want = j_common.nonparam_layernorm(jnp.asarray(x))
    got = t_common.nonparam_layernorm(torch.from_numpy(x))
    _close(got, want)
    unbiased = (torch.from_numpy(x) - torch.from_numpy(x).mean(-1, True)) \
        / torch.sqrt(torch.from_numpy(x).var(-1, keepdim=True) + 1e-5)
    assert not np.allclose(unbiased.numpy(), np.asarray(want), atol=1e-3)


@pytest.mark.parametrize("kind", ["rmsnorm", "rmsnorm_plus1", "nonparam_ln"])
def test_apply_and_init_norm_match_reference(kind):
    jp = j_common.init_norm(64, kind)
    tp = t_common.init_norm(64, kind, lead=(3,))
    assert set(tp) == set(jp)
    if jp:
        np.testing.assert_array_equal(tp["w"][1].numpy(), np.asarray(jp["w"]))
        assert tp["w"].shape == (3, 64) and tp["w"].dtype == torch.float32
    w = _x((64,), 3, 0.2)
    jp = {"w": jnp.asarray(w)} if jp else {}
    tp = {"w": torch.from_numpy(w)} if tp else {}
    x = _x((2, 6, 64), 4)
    _close(t_common.apply_norm(torch.from_numpy(x), tp, kind),
           j_common.apply_norm(jnp.asarray(x), jp, kind))


@pytest.mark.parametrize("cap", [None, 30.0, 50.0])
def test_softcap_matches_reference(cap):
    x = _x((3, 9, 17), 5, 40.0)
    _close(t_common.softcap(torch.from_numpy(x), cap),
           j_common.softcap(jnp.asarray(x), cap))


def test_mrope_matches_reference_and_reduces_to_rope_for_text():
    x = _x((2, 6, 4, 32), 6)
    g = np.random.default_rng(7)
    grid = g.integers(0, 50, size=(3, 2, 6)).astype(np.int32)
    want = j_common.apply_mrope(jnp.asarray(x), jnp.asarray(grid), (4, 6, 6))
    got = t_common.apply_mrope(torch.from_numpy(x), torch.from_numpy(grid),
                               (4, 6, 6))
    _close(got, want)
    text = np.tile(np.arange(6, dtype=np.int32), (2, 1))
    same = t_common.apply_mrope(torch.from_numpy(x),
                                torch.from_numpy(np.stack([text] * 3)),
                                (4, 6, 6), theta=1e6)
    rope = t_common.apply_rope(torch.from_numpy(x), torch.from_numpy(text),
                               theta=1e6)
    torch.testing.assert_close(same, rope, rtol=0, atol=0)
    with pytest.raises(ValueError, match="sum to"):
        t_common.apply_mrope(torch.from_numpy(x), torch.from_numpy(grid),
                             (4, 6, 5))


def _qkv(seed, t=20, h=4, kv=2, dh=16):
    # scores of magnitude ~50 so a cap of 50 bends them
    return (_x((2, t, h, dh), seed, 2.0), _x((2, t, kv, dh), seed + 1, 2.0),
            _x((2, t, kv, dh), seed + 2))


@pytest.mark.parametrize("cap", [None, 50.0])
@pytest.mark.parametrize("window", [None, 5])
def test_sdpa_with_cap_matches_reference(cap, window):
    q, k, v = _qkv(8)
    pad = np.ones((2, 20), bool)
    pad[1, :3] = False
    jmask = (j_attn._causal_window_mask(20, 20, 0, window)
             + j_attn._pad_key_mask(jnp.asarray(pad), 3))
    want = j_attn._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jmask, cap)
    tmask = (t_attn._causal_window_mask(20, 20, 0, window, "cpu")
             + t_attn._pad_key_mask(torch.from_numpy(pad), 3))
    got = t_attn._sdpa(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), tmask, cap)
    _close(got, want)


@pytest.mark.parametrize("cap", [None, 50.0])
@pytest.mark.parametrize("window", [None, 7])
def test_sdpa_blockwise_with_cap_matches_reference(cap, window):
    """Chunks of 8 over 20 keys (a padded last chunk), with a pad mask."""
    q, k, v = _qkv(11)
    pad = np.ones((2, 20), bool)
    pad[0, :4] = False
    want = j_attn._sdpa_blockwise(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), 0, window, cap, chunk=8,
                                  pad_mask=jnp.asarray(pad))
    got = t_attn._sdpa_blockwise(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), 0, window, cap,
                                 chunk=8, pad_mask=torch.from_numpy(pad))
    _close(got, want)
    plain = t_attn._sdpa(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        t_attn._causal_window_mask(20, 20, 0, window, "cpu")
        + t_attn._pad_key_mask(torch.from_numpy(pad), 3), cap)
    # rows whose every key is masked differ by design (the blockwise walk
    # masks to NEG_INF exactly); the others are the plain attention's
    torch.testing.assert_close(got[:, 4:], plain[:, 4:], rtol=0,
                               atol=TOL * 4)
