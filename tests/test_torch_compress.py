"""Port vs reference: error-feedback int8 gradient compression
(``optim/compress.py``). Codes, scales and residuals are bit-exact over
random trees, ties round half to even on both sides, and the reference's
own compression tests (``tests/test_substrate.py``) are ported. The
all-reduce across 4 ranks is held in ``tests/test_torch_moe_mesh.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compress as jc
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim import compress as tc
from repro_torch.optim.adamw import tree_leaves


def rand_tree(rng, scale):
    r = lambda *s: (rng.normal(size=s) * scale).astype(np.float32)
    return {"z": {"b": r(3, 4), "a": r(5)}, "groups": [{"w": r(2, 3, 4)},
                                                       {"w": r(7)}],
            "zero": np.zeros((2, 2), np.float32), "m": r(1, 6)}


def t_tree(tree):
    if isinstance(tree, dict):
        return {k: t_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [t_tree(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def same(got, want):
    want = jax.tree_util.tree_leaves(want)
    got = tree_leaves(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("scale", [1e-4, 1.0, 1e3])
def test_compress_with_feedback_bit_exact(seed, scale):
    rng = np.random.default_rng(seed)
    g, e = rand_tree(rng, scale), rand_tree(rng, scale * 1e-3)
    jq, js, je = jc.compress_with_feedback(
        jax.tree_util.tree_map(jnp.asarray, g),
        jax.tree_util.tree_map(jnp.asarray, e))
    tq, ts, te = tc.compress_with_feedback(t_tree(g), t_tree(e))
    same(tq, jq)
    same(ts, js)
    same(te, je)
    # a second round feeds the residual back
    jq2, js2, je2 = jc.compress_with_feedback(
        jax.tree_util.tree_map(jnp.asarray, g), je)
    tq2, ts2, te2 = tc.compress_with_feedback(t_tree(g), te)
    same(tq2, jq2)
    same(te2, je2)


def test_ties_round_half_to_even():
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5],
                 np.float32)
    jq, js = jc.quantize_int8(jnp.asarray(x))
    tq, ts = tc.quantize_int8(torch.from_numpy(x))
    assert float(ts) == float(js) == 1.0
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tq.tolist() == [127, 0, 2, 2, 0, -2, -2, 126]
    np.testing.assert_array_equal(tc.dequantize_int8(tq, ts).numpy(),
                                  np.asarray(jc.dequantize_int8(jq, js)))


def test_init_error_feedback():
    g = rand_tree(np.random.default_rng(0), 1.0)
    g["groups"][0]["w"] = g["groups"][0]["w"].astype(np.float16)
    same(tc.init_error_feedback(t_tree(g)),
         jc.init_error_feedback(jax.tree_util.tree_map(jnp.asarray, g)))


# ----- the reference's compression tests -----

@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("scale", [1e-4, 3e-2, 1.0, 37.0, 1e3])
def test_int8_roundtrip_error_bound(seed, scale):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=64).astype(np.float32) * scale)
    q, s = tc.quantize_int8(x)
    err = float(torch.max(torch.abs(tc.dequantize_int8(q, s) - x)))
    assert err <= float(s) / 2 + 1e-6


def test_error_feedback_accumulates_residual():
    g = {"w": torch.tensor([1e-4, 2.0, -1.0])}
    e = tc.init_error_feedback(g)
    q, s, e2 = tc.compress_with_feedback(g, e)
    recon = tc.dequantize_int8(q["w"], s["w"]) + e2["w"]
    np.testing.assert_allclose(recon.numpy(), g["w"].numpy(), rtol=1e-6)


def test_compressed_psum_single_rank():
    mesh = make_host_mesh("cpu")
    try:
        g = {"w": torch.tensor([0.5, -0.25, 3.0])}
        e = tc.init_error_feedback(g)
        out, e2 = tc.compressed_psum_mean(g, e, mesh.fsdp_group())
        np.testing.assert_allclose(out["w"].numpy(), g["w"].numpy(),
                                   atol=float(g["w"].abs().max()) / 120)
        # one rank: the mean is the dequantized codes, the residual the rest
        q, s, _ = tc.compress_with_feedback(g, e)
        assert torch.equal(out["w"], tc.dequantize_int8(q["w"], s["w"]))
        assert torch.equal(out["w"] + e2["w"], g["w"])
    finally:
        mesh.close()
