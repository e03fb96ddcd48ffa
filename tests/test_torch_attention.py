"""Port vs reference: sliding-window and blockwise GQA attention
(``repro_torch.models.attention`` against ``repro.models.attention``), in
fp32 on the CPU.

``_sdpa_blockwise`` (the online-softmax path every prompt above
``BLOCKWISE_THRESHOLD`` tokens takes) is held against the reference's with
small chunks, windows, soft-caps, pad masks and key lengths that are no
multiple of the chunk; the windowed ring cache at the model level against
the reference's full forward (``tests/test_models.py``'s decode and ring
tests mirrored on mixtral's smoke size).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke_cfg
from repro.models import attention as j_attn
from repro.models import build_model as j_build_model
from repro_torch.bridge import to_torch
from repro_torch.configs import get_config
from repro_torch.models import attention as t_attn
from repro_torch.models import build_model

ARCH = "mixtral-8x22b"
RTOL = 2e-5         # fp32, relative to max |out|


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=rtol * np.abs(want).max())


def _qkv(b, t, s, h, kv, dh, seed):
    g = np.random.default_rng(seed)
    return [g.normal(size=shape).astype(np.float32)
            for shape in ((b, t, h, dh), (b, s, kv, dh), (b, s, kv, dh))]


@pytest.mark.parametrize("window", [None, 5, 24])
@pytest.mark.parametrize("cap", [None, 3.0])
@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("chunk", [4, 7, 64])
def test_sdpa_blockwise_matches_reference(window, cap, padded, chunk):
    """Chunks of 4 and 7 over 19 keys (the last chunk partial), and one
    chunk larger than the keys; left-pad rows whose first chunks are
    masked whole stay finite and equal the reference's."""
    q, k, v = _qkv(2, 19, 19, 4, 2, 8, seed=chunk)
    pm = None
    if padded:
        pm = np.arange(19)[None, :] >= np.asarray([0, 9])[:, None]
    want = j_attn._sdpa_blockwise(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0, window, cap,
        chunk=chunk, pad_mask=None if pm is None else jnp.asarray(pm))
    got = t_attn._sdpa_blockwise(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 0,
        window, cap, chunk=chunk,
        pad_mask=None if pm is None else torch.from_numpy(pm))
    assert torch.isfinite(got).all()
    _close(got, want)


def test_sdpa_blockwise_offset_and_bf16():
    """Queries that start past key 0 (``offset``), and bf16 inputs cast
    back to bf16 as the reference does."""
    q, k, v = _qkv(1, 6, 20, 4, 1, 16, seed=3)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        want = j_attn._sdpa_blockwise(
            jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
            14, 8, None, chunk=8)
        got = t_attn._sdpa_blockwise(
            torch.from_numpy(q).to(dt), torch.from_numpy(k).to(dt),
            torch.from_numpy(v).to(dt), 14, 8, None, chunk=8)
        assert got.dtype == dt
        _close(got.float(), np.asarray(want, np.float32),
               RTOL if dt == torch.float32 else 1e-2)


@pytest.fixture(scope="module")
def layer():
    """Layer 0's attention params of mixtral's smoke model in both
    packages."""
    jcfg = smoke_cfg(ARCH)
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    jb = jax.tree_util.tree_map(
        lambda a: a[0], jparams["base"]["groups"][0]["sub_0"]["mixer"])
    tcfg = dataclasses.replace(get_config(ARCH, "smoke"),
                               dtype=torch.float32)
    return jcfg, jb, tcfg, to_torch(jb, "cpu")


@pytest.mark.parametrize("force", [None, True, False])
@pytest.mark.parametrize("window", [None, 8])
def test_gqa_attention_paths_match_reference(layer, force, window):
    """Prefill attention of a left-padded batch with a cache: plain and
    blockwise (forced, in small chunks), windowed or not, against the
    reference's output and ring cache."""
    jcfg, jb, tcfg, tb = layer
    g = np.random.default_rng(2)
    x = g.normal(size=(2, 13, tcfg.d_model)).astype(np.float32)
    start = np.asarray([0, 4])
    pm = np.arange(13)[None, :] >= start[:, None]
    pos = np.maximum(np.arange(13)[None, :] - start[:, None], 0)
    jcache = j_attn.init_gqa_cache(jcfg, 2, 8, jnp.float32)
    want, wc = j_attn.gqa_attention(
        jnp.asarray(x), jb, None, jcfg, positions=jnp.asarray(pos),
        window=window, cache=jcache, cache_pos=0, pad_mask=jnp.asarray(pm),
        force_blockwise=force, kv_chunk=5)
    tcache = {n: torch.zeros((2, 8, tcfg.n_kv_heads, tcfg.resolved_head_dim))
              for n in ("k", "v")}
    got = t_attn.gqa_attention(
        torch.from_numpy(x), tb, None, tcfg, positions=torch.from_numpy(pos),
        window=window, cache=tcache, cache_pos=0,
        pad_mask=torch.from_numpy(pm), force_blockwise=force, kv_chunk=5)
    _close(got, want)
    _close(tcache["k"], wc["k"])


def test_blockwise_above_threshold(layer, monkeypatch):
    """Above ``BLOCKWISE_THRESHOLD`` tokens ``gqa_attention`` takes the
    blockwise path (it used to raise): 8193 tokens of a 1-head layer."""
    _, _, tcfg, _ = layer
    cfg = dataclasses.replace(tcfg, d_model=8, n_heads=1, n_kv_heads=1,
                              head_dim=8)
    g = torch.Generator().manual_seed(0)
    base = {n: {"w": torch.randn(8, 8, generator=g) * 0.3}
            for n in ("wq", "wk", "wv", "wo")}
    t = t_attn.BLOCKWISE_THRESHOLD + 1
    x = torch.randn(1, t, 8, generator=g)
    calls = []
    real = t_attn._sdpa_blockwise
    monkeypatch.setattr(t_attn, "_sdpa_blockwise",
                        lambda *a, **kw: calls.append(kw["chunk"])
                        or real(*a, **kw))
    y = t_attn.gqa_attention(x, base, None, cfg,
                             positions=torch.arange(t)[None], window=4096)
    assert calls == [t_attn.KV_CHUNK] and y.shape == (1, t, 8)
    assert torch.isfinite(y).all()
    # the threshold's own length stays on the plain path
    calls.clear()
    t_attn.gqa_attention(x[:, :16], base, None, cfg,
                         positions=torch.arange(16)[None])
    assert not calls


def _models(window=None, cf=8.0):
    """Both packages' smoke mixtral (capacity factor raised so no token is
    dropped: a prefill and a decode step then route alike)."""
    jcfg = smoke_cfg(ARCH)
    tcfg = dataclasses.replace(get_config(ARCH, "smoke"), dtype=torch.float32)
    over = {} if window is None else {"window": window}
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=cf), **over)
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=cf), **over)
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    return jcfg, jmodel, jparams, build_model(tcfg), to_torch(jparams, "cpu")


def test_decode_after_prefill_matches_reference_forward():
    """``tests/test_models.py::test_decode_matches_forward`` for mixtral:
    prefill of 63 tokens then one decode step equals the reference's full
    forward at the last position."""
    jcfg, jmodel, jparams, tmodel, tparams = _models()
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 64))
    full, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)})
    _, caches = tmodel.prefill(tparams, {"tokens": torch.from_numpy(
        toks[:, :63])}, 128)
    assert caches[0]["sub_0"]["k"].shape[2] == jcfg.window
    ld, _ = tmodel.decode_step(tparams, torch.from_numpy(toks[:, 63:]),
                               caches, torch.tensor(63))
    ref = np.asarray(full[:, -1:])
    assert np.abs(ld.numpy() - ref).max() < 1e-3 * max(np.abs(ref).max(), 1)
    _close(ld, ref, 1e-4)


def test_ring_buffer_decode_past_the_window():
    """``tests/test_models.py::test_local_attention_ring_buffer_decode``:
    window 16, prefill 32 into a 16-slot ring, 16 decode steps; the last
    logits equal the reference's windowed full forward, and every step's
    the reference's own decode."""
    jcfg, jmodel, jparams, tmodel, tparams = _models(window=16)
    t = 48
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (2, t))
    full, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)})
    _, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :32])},
                           16)
    _, tc = tmodel.prefill(tparams, {"tokens": torch.from_numpy(
        toks[:, :32])}, 16)
    assert tc[0]["sub_0"]["k"].shape[2] == 16
    for pos in range(32, t):
        jl, jc = jmodel.decode_step(jparams, jnp.asarray(toks[:, pos:pos + 1]),
                                    jc, jnp.int32(pos))
        tl, tc = tmodel.decode_step(tparams, torch.from_numpy(
            toks[:, pos:pos + 1]), tc, torch.tensor(pos))
        _close(tl, jl, 1e-4)
    err = np.abs(tl.numpy() - np.asarray(full[:, -1:])).max()
    assert err < 1e-3, err
