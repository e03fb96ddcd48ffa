"""Port vs reference at LoRA ranks past 32: every apply path from packed
codes at ranks 20 and 24 (rank rows padded to 24, and none padded), 64 and
128, and a smoke-size llama engine serving rank-64 adapters.

The reference pads each sub-LoRA to ``rp = ceil(r / 8)·8`` rank rows, so a
rank-r adapter reaches ``fused_lora`` / ``sgmv_fused`` with ``2·rp`` rows
and the rhs / out kernels with ``rp`` rows per call. The port's Hopper
kernels take any rank whose one staging unit fits a block's shared memory
(``_cluster_plan``); here, on the CPU, the wrappers run their plain
versions, so these tests hold the port's layouts, routing and arithmetic at
those ranks against JAX (Pallas in interpret mode). Adapters are quantized
by JAX and carried over by ``repro_torch.bridge``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke_cfg
from repro.core import LoRAQuantConfig as JConfig
from repro.core import quantize_lora as j_quantize_lora
from repro.kernels.quant_matmul import kernel as jk
from repro.kernels.quant_matmul import ops as jops
from repro.launch.serve import random_trained_lora as j_random_lora
from repro.models import build_model as j_build_model
from repro.serving.engine import AdapterStore as JStore
from repro_torch.bridge import quantized_lora, to_torch
from repro_torch.configs import get_config
from repro_torch.kernels.quant_matmul import (LAUNCH_COUNTS, PLAIN_CALLS,
                                               lora_apply_quantized,
                                               pack_adapter_layers,
                                               reset_launch_counts,
                                               sgmv_apply_buckets,
                                               sgmv_apply_packed,
                                               stack_packed_adapters)
from repro_torch.kernels.quant_matmul.ops import (_PACKED_ARRAY_FIELDS,
                                                   PackedLoRABuckets)
from repro_torch.models import build_model
from repro_torch.serving import Request
from test_torch_continuous import _lockstep, jax_request
from test_torch_memory import (Models, assert_pools_equal, bridge_store,
                               trace_paging)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: torch's intra-op thread pool would only
    contend with the other test workers for the CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# fp32: the port and JAX sum the same products in different orders;
# relative to the output's magnitude
RTOL = 1e-5
# fp32 logits of two engines after 2 layers, relative to max |logit|
LOGIT_RTOL = 1e-4
RANKS = (20, 24, 64, 128)


def _close(got, want):
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * np.abs(want).max())


def _jq(m, k, r, rho, bits=2, seed=0):
    """A JAX adapter of rank ``r`` with a decaying spectrum (``rho`` fixes
    its split h)."""
    rng = np.random.default_rng(seed)
    u = np.linalg.qr(rng.normal(size=(m, r)))[0]
    v = np.linalg.qr(rng.normal(size=(k, r)))[0]
    s = np.exp(-8.0 * np.arange(r) / r)
    b = jnp.asarray((u * np.sqrt(s)).astype(np.float32))
    a = jnp.asarray((np.sqrt(s)[:, None] * v.T).astype(np.float32))
    return j_quantize_lora(b, a, JConfig(rho=rho, bits_high=bits,
                                         group_size=128, ste_steps=0))


def _x(t, k, seed):
    return np.random.default_rng(seed).normal(size=(t, k)).astype(np.float32)


# --------------------------------------------------------------------------
# the single-adapter apply: fused_lora, or matmul_rhs + matmul_out
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("r", RANKS)
def test_lora_apply_quantized_any_rank(r, fused, m=256, k=384, t=20):
    """Both sub-LoRAs (``2·rp`` rank rows through ``fused_lora``, ``rp`` per
    rhs / out call): JAX's output within RTOL, and the same kernels called
    as often as JAX launches them."""
    jq = _jq(m, k, r, rho=0.9, seed=r)
    assert jq.a_low is not None and jq.h < r
    x = _x(t, k, seed=r + fused)
    jk.reset_launch_counts()
    want = np.asarray(jops.lora_apply_quantized(
        jnp.asarray(x), jq, scaling=1.5, interpret=True, fused=fused))
    reset_launch_counts()
    got = lora_apply_quantized(torch.from_numpy(x), quantized_lora(jq, "cpu"),
                               scaling=1.5, fused=fused)
    assert dict(PLAIN_CALLS) == dict(jk.LAUNCH_COUNTS)
    assert not LAUNCH_COUNTS
    assert dict(PLAIN_CALLS) == ({"fused_lora": 1} if fused else
                                 {"matmul_rhs": 2, "matmul_out": 2})
    _close(got.numpy(), want)


# --------------------------------------------------------------------------
# the multi-adapter apply: sgmv_apply_packed, sgmv_apply_buckets
# --------------------------------------------------------------------------

def _layer0(pb):
    """The per-layer ``(NA, Rp, ·)`` view of a one-layer packed batch (JAX's
    has no ``layer()``)."""
    return dataclasses.replace(pb, **{f: getattr(pb, f)[0]
                                      for f in _PACKED_ARRAY_FIELDS})


def _packed(jqs, tile_t):
    """One layer of ``jqs`` packed by JAX and by the port (from the bridged
    adapters), whose arrays must agree bit for bit."""
    jpb = _layer0(jops.stack_packed_adapters(
        [jops.pack_adapter_layers([q]) for q in jqs], tile_t=tile_t))
    tpb = stack_packed_adapters(
        [pack_adapter_layers([quantized_lora(q, "cpu")]) for q in jqs],
        tile_t=tile_t).layer(0)
    for f in _PACKED_ARRAY_FIELDS:         # 3-bit words: uint32 / int32
        ja = np.ascontiguousarray(np.asarray(getattr(jpb, f)))
        ta = np.ascontiguousarray(getattr(tpb, f).numpy())
        assert ta.shape == ja.shape, f
        np.testing.assert_array_equal(ta.view(np.uint8), ja.view(np.uint8),
                                      err_msg=f)
    return jpb, tpb


def _seg(tile_t, na, seed):
    """Per-row adapter ids: one tile per adapter, in a shuffled order."""
    tiles = np.random.default_rng(seed).permutation(na)
    return np.repeat(tiles, tile_t).astype(np.int32)


@pytest.mark.parametrize("tile_t", [1, 8])
@pytest.mark.parametrize("r", RANKS)
def test_sgmv_apply_packed_any_rank(r, tile_t, m=256, k=384):
    """Four adapters of rank r with different split h (one with h == r:
    an all-zero low side) in one stack of ``2·rp`` rank rows per tile: one
    ``sgmv_fused`` call, JAX's output within RTOL."""
    jqs = [_jq(m, k, r, rho, seed=10 * r + i)
           for i, rho in enumerate((0.5, 0.8, 0.95, 1.0))]
    assert len({q.h for q in jqs}) >= 3 and jqs[-1].a_low is None
    jpb, tpb = _packed(jqs, tile_t)
    assert tpb.ah_codes.shape[1] == -(-r // 8) * 8
    seg = _seg(tile_t, len(jqs), seed=r + tile_t)
    x = _x(seg.shape[0], k, seed=r * tile_t)
    want = jops.sgmv_apply_packed(
        jnp.asarray(x), dataclasses.replace(jpb, seg=jnp.asarray(seg)),
        scaling=2.0)
    reset_launch_counts()
    got = sgmv_apply_packed(torch.from_numpy(x), dataclasses.replace(
        tpb, seg=torch.from_numpy(seg)), scaling=2.0)
    assert dict(PLAIN_CALLS) == {"sgmv_fused": 1}
    _close(got.numpy(), want)


@pytest.mark.parametrize("r", RANKS)
def test_sgmv_apply_buckets_any_rank(r, m=256, k=384, tile_t=4):
    """Two recipes of one rank (``2@0.9`` and ``3@0.8``: two layout
    buckets), four adapters in one global seg space: one ``sgmv_fused`` per
    bucket, JAX's output within RTOL."""
    groups = [[_jq(m, k, r, 0.9, bits=2, seed=100 + r + i) for i in range(2)],
              [_jq(m, k, r, 0.8, bits=3, seed=200 + r + i)
               for i in range(2)]]
    packs = [_packed(g, tile_t) for g in groups]
    luts = [np.array([0, 1, -1, -1], np.int32),
            np.array([-1, -1, 0, 1], np.int32)]
    seg = _seg(tile_t, 4, seed=r)
    x = _x(seg.shape[0], k, seed=r + 1)
    want = jops.sgmv_apply_buckets(jnp.asarray(x), jops.PackedLoRABuckets(
        buckets=tuple(p[0] for p in packs),
        lookups=tuple(jnp.asarray(lut) for lut in luts),
        seg=jnp.asarray(seg)), scaling=0.5)
    reset_launch_counts()
    got = sgmv_apply_buckets(torch.from_numpy(x), PackedLoRABuckets(
        buckets=tuple(p[1] for p in packs),
        lookups=tuple(torch.from_numpy(lut) for lut in luts),
        seg=torch.from_numpy(seg)), scaling=0.5)
    assert dict(PLAIN_CALLS) == {"sgmv_fused": 2}
    _close(got.numpy(), want)


# --------------------------------------------------------------------------
# a rank-64 engine: continuous, bounded, against the reference's
# --------------------------------------------------------------------------

RANK = 64


class RankModels(Models):
    """The reference model and the port's at the smoke size of llama3.2-3b
    with ``lora_rank`` 64 (above d_kv = 64 of wk / wv: B is square there)."""

    def __init__(self):
        self.jcfg = smoke_cfg("llama3.2-3b", lora_rank=RANK)
        self.jmodel = j_build_model(self.jcfg)
        self.jparams = self.jmodel.init(jax.random.PRNGKey(0))
        self.tmodel = build_model(dataclasses.replace(
            get_config("llama3.2-3b", "smoke"), dtype=torch.float32,
            lora_rank=RANK))
        self.tparams = to_torch(self.jparams, "cpu")
        self._jits = {}


@pytest.fixture(scope="module")
def rank_models():
    return RankModels()


@pytest.fixture(scope="module")
def rank_store(rank_models):
    jstore = JStore(JConfig(rho=0.9, ste_steps=0))
    jstore.register_many({
        f"user_{i}": j_random_lora(rank_models.jparams["lora"],
                                   jax.random.PRNGKey(40 + i))
        for i in range(4)})
    return jstore, bridge_store(jstore)


def _record_logits(fn, sink):
    """Wrap a prefill / decode callable: append each forward's
    last-position logits ``(rows, V)`` as numpy."""
    def call(*args, **kw):
        out = fn(*args, **kw)
        logits = out[0][:, -1]
        sink.append(logits.numpy() if isinstance(logits, torch.Tensor)
                    else np.asarray(logits))
        return out
    return call


@pytest.mark.parametrize("slots", [None, 2])
def test_rank64_engine_matches_reference(rank_models, rank_store, slots):
    """Rank-64 adapters (64 + 64 rank rows per ``sgmv_fused`` call) served
    continuously, all-resident and bounded to 2 of 4 slots, 2 rows: the
    reference's greedy tokens, schedule and paging bit for bit, every
    forward's fp32 logits within LOGIT_RTOL of max |logit|, and one
    ``sgmv_fused`` per LoRA linear per forward."""
    jstore, tstore = rank_store
    rm = rank_models
    jeng, teng = rm.engines(jstore, tstore, capacity=32, max_rows=2,
                            hbm_slots=slots)
    jlog, tlog = trace_paging(jeng.memory), trace_paging(teng.memory)
    jl, tl = [], []
    jeng._prefill = _record_logits(jeng._prefill, jl)
    jeng._decode = _record_logits(jeng._decode, jl)
    rm.tmodel.prefill = _record_logits(type(rm.tmodel).prefill.__get__(
        rm.tmodel), tl)
    rm.tmodel.decode_step = _record_logits(type(rm.tmodel).decode_step
                                           .__get__(rm.tmodel), tl)
    rng = np.random.default_rng(64)
    ids = ["user_0", "user_2", "user_1", "user_3", "user_0", "user_2"]
    prompts = [rng.integers(0, rm.jcfg.vocab, size=n).astype(np.int32)
               for n in (5, 8, 6, 8, 7, 5)]
    jreqs = [jax_request(request_id=i, adapter_id=a, prompt=p.copy(),
                         max_new_tokens=3)
             for i, (a, p) in enumerate(zip(ids, prompts))]
    treqs = [Request(request_id=i, adapter_id=a, prompt=p.copy(),
                     max_new_tokens=3)
             for i, (a, p) in enumerate(zip(ids, prompts))]
    reset_launch_counts()
    try:
        _lockstep(jeng, teng, jreqs, treqs)
    finally:
        del rm.tmodel.prefill, rm.tmodel.decode_step
    assert len(tl) == len(jl) == teng._wave + teng._step_count
    assert dict(PLAIN_CALLS) == {"sgmv_fused": 2 * 7 * len(tl)}
    assert not LAUNCH_COUNTS
    scale = max(np.abs(a).max() for a in jl)
    for got, want in zip(tl, jl):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=LOGIT_RTOL * scale)
    assert tlog == jlog
    assert teng.memory_stats() == jeng.memory_stats()
    assert_pools_equal(jeng.memory, teng.memory)
    pool = next(iter(teng.memory._pools.values()))
    rows = {a.shape[-2] for fields in pool.arrays.values()
            for f, a in fields.items() if f.endswith("codes")}
    assert rows == {RANK}          # each side's rank rows, unpadded at 64
    if slots is not None:
        mem = teng.memory_stats()
        assert mem["slots"] == slots and mem["evictions"] > 0
