"""Port vs reference: the paged adapter memory (``repro_torch.serving.memory``
against ``repro.serving.memory``) behind the continuous engine, at the
smoke size of llama3.2-3b, fp32 on the CPU.

Mirrors the 8 tests of ``tests/test_memory.py`` and the three paged-memory
tests of ``tests/test_recipes.py``. Adapters are quantized by JAX and
carried across with the bridge, so both sides page the same codes; the
reference runs its Pallas kernel in interpret mode. Held bit for bit:
greedy tokens, every ``acquire`` / ``prefetch`` of the paging sequence
(hit or miss, slot id, evictions, swap-ins and their bytes, per-pool
counters), the managers' stats, and every pool tensor against the
reference's pool arrays after the run.
"""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from conftest import smoke_cfg
from repro.core import LoRAQuantConfig as JConfig
from repro.launch.serve import random_trained_lora as j_random_lora
from repro.models import build_model as j_build_model
from repro.serving.engine import AdapterStore as JStore
from repro.serving.engine import MultiLoRAEngine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.memory import AdapterMemoryManager as JMemory
from repro_torch.bridge import quantized_adapter, to_torch
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serving import (AdapterMemoryManager, AdapterStore,
                                 MultiLoRAEngine, Request)

N_ADAPTERS = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: torch's intra-op thread pool would only
    contend with the other test workers for the CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _aid(i: int) -> str:
    return f"u{i:02d}"


# --------------------------------------------------------------------------
# shared helpers (also used by test_torch_continuous.py)
# --------------------------------------------------------------------------

class Models:
    """The reference model and the port's over the same (bridged) params.
    Reference engines share one set of jitted prefill / decode / scatter
    functions per cache capacity, so each shape compiles once per module
    instead of once per engine (the engine's own jits are closures)."""

    def __init__(self):
        self.jcfg = smoke_cfg("llama3.2-3b")
        self.jmodel = j_build_model(self.jcfg)
        self.jparams = self.jmodel.init(jax.random.PRNGKey(0))
        self.tmodel = build_model(dataclasses.replace(
            get_config("llama3.2-3b", "smoke"), dtype=torch.float32))
        self.tparams = to_torch(self.jparams, "cpu")
        self._jits = {}

    def jits(self, capacity):
        if capacity not in self._jits:
            model = self.jmodel
            self._jits[capacity] = (
                jax.jit(lambda p, b: model.prefill(p, b, capacity)),
                jax.jit(model.decode_step),
                jax.jit(lambda g, r, idx: jax.tree_util.tree_map(
                    lambda gg, rr: gg.at[:, idx].set(rr.astype(gg.dtype)),
                    g, r)))
        return self._jits[capacity]

    def engines(self, jstore, tstore, capacity=32, **kw):
        jeng = JEngine(self.jmodel, self.jparams, jstore,
                       cache_capacity=capacity, **kw)
        jeng._prefill, jeng._decode, jeng._scatter_rows = self.jits(capacity)
        teng = MultiLoRAEngine(self.tmodel, self.tparams, tstore,
                               cache_capacity=capacity, **kw)
        return jeng, teng


def bridge_store(jstore, budget=None, ids=None):
    """The port's store over the reference store's quantized adapters (in
    the reference's registration order)."""
    tstore = AdapterStore(hbm_budget_bytes=budget)
    for aid in (ids or list(jstore.quantized)):
        tstore.register_quantized(aid, quantized_adapter(
            jstore.quantized[aid], "cpu"))
    return tstore


def requests(vocab, seq, seed=0, max_new=2, plen=6):
    """The same requests for both engines: ``(reference, port)`` lists."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, size=plen).astype(np.int32)
               for _ in seq]
    mk = [[cls(request_id=i, adapter_id=aid, prompt=p.copy(),
               max_new_tokens=max_new)
           for i, (aid, p) in enumerate(zip(seq, prompts))]
          for cls in (JRequest, Request)]
    return mk[0], mk[1]


def trace_paging(mgr):
    """Record every ``acquire`` / ``prefetch`` of a memory manager (either
    package's): the call, its slot ids, and the counters after it."""
    log = []
    acquire, prefetch = mgr.acquire, mgr.prefetch

    def counters():
        return (mgr.hits, mgr.misses, mgr.evictions, mgr.swap_ins,
                mgr.swap_in_bytes, dict(mgr.prefetch_counts),
                sorted((tuple(int(x) for x in sig), sorted(c.items()))
                       for sig, c in mgr._per_pool.items()))

    def traced_acquire(aid, pin=True):
        slot = acquire(aid, pin=pin)
        log.append(("acquire", aid, slot) + counters())
        return slot

    def traced_prefetch(ids):
        prefetch(ids)
        slots = tuple(mgr.slot_of(a) if a in mgr._where else None
                      for a in ids)
        log.append(("prefetch", tuple(ids), slots) + counters())

    mgr.acquire, mgr.prefetch = traced_acquire, traced_prefetch
    return log


def assert_pools_equal(jmgr, tmgr):
    """Same pools in the same order, the same owners, and every pool tensor
    bit for bit the reference's array (3-bit words: uint32 there, int32
    here, compared as bytes)."""
    assert [tuple(int(x) for x in s) for s in jmgr._pools] == \
        [tuple(int(x) for x in s) for s in tmgr._pools]
    for (sig, jp), tp in zip(jmgr._pools.items(), tmgr._pools.values()):
        assert (jp.capacity, jp.owners, jp.page_bytes) == \
            (tp.capacity, tp.owners, tp.page_bytes), sig
        if jp.arrays is None:
            assert tp.arrays is None
            continue
        assert jp.arrays.keys() == tp.arrays.keys()
        for path, fields in jp.arrays.items():
            for f, ja in fields.items():
                ja = np.ascontiguousarray(np.asarray(ja))
                ta = np.ascontiguousarray(tp.arrays[path][f].numpy())
                assert ja.shape == ta.shape, (path, f)
                assert ja.dtype.itemsize == ta.dtype.itemsize, (path, f)
                np.testing.assert_array_equal(ta.view(np.uint8),
                                              ja.view(np.uint8),
                                              err_msg=f"{sig} {path} {f}")


def serve_both(models, jstore, tstore, seq, *, seed=0, max_new=2, plen=6,
               capacity=32, **kw):
    """Serve one request stream on both engines; returns the port's outputs
    and engine after checking tokens, the paging sequence, the stats and
    the pools against the reference."""
    jeng, teng = models.engines(jstore, tstore, capacity=capacity, **kw)
    jreqs, treqs = requests(models.jcfg.vocab, seq, seed, max_new, plen)
    jlog, tlog = trace_paging(jeng.memory), trace_paging(teng.memory)
    for jr, tr in zip(jreqs, treqs):
        jeng.submit(jr)
        teng.submit(tr)
    want = {r.request_id: r.output for r in jeng.run()}
    got = {r.request_id: r.output for r in teng.run()}
    assert got.keys() == want.keys()
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert tlog == jlog
    assert teng.memory_stats() == jeng.memory_stats()
    assert (teng._step_count, teng._wave) == (jeng._step_count, jeng._wave)
    assert_pools_equal(jeng.memory, teng.memory)
    return got, teng, tlog


# --------------------------------------------------------------------------
# fixtures
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    return Models()


@pytest.fixture(scope="module")
def served(models):
    """16 adapters quantized by the reference in one bucketed dispatch and
    carried across (the reference's ``served`` fixture)."""
    jstore = JStore(JConfig(rho=0.9, ste_steps=0))
    jstore.register_many({_aid(i): j_random_lora(
        models.jparams["lora"], jax.random.PRNGKey(100 + i), scale=0.05)
        for i in range(N_ADAPTERS)})
    return jstore, bridge_store(jstore)


# --------------------------------------------------------------------------
# tests/test_memory.py
# --------------------------------------------------------------------------

def test_budget_constrained_matches_all_resident(models, served):
    """slots = ceil(NA / 4): the reference's paging sequence, tokens and
    pools, forced evictions and re-faults, the pool bounded by the slot
    budget, and tokens equal to the all-resident run."""
    jstore, tstore = served
    seq = [_aid(i) for i in range(N_ADAPTERS)] + [_aid(3), _aid(7), _aid(0)]
    slots = math.ceil(N_ADAPTERS / 4)
    got, eng, log = serve_both(models, jstore, tstore, seq, seed=1,
                               max_rows=4, hbm_slots=slots)
    ref_eng = MultiLoRAEngine(models.tmodel, models.tparams, tstore,
                              cache_capacity=32, max_rows=4)
    for r in requests(models.jcfg.vocab, seq, seed=1)[1]:
        ref_eng.submit(r)
    ref = {r.request_id: r.output for r in ref_eng.run()}
    for rid in ref:
        np.testing.assert_array_equal(got[rid], ref[rid])
    mem = eng.memory_stats()
    page = eng.memory.page_bytes
    assert mem["slots"] == slots
    assert eng.memory.hbm_bytes() == slots * page
    assert mem["evictions"] > 0 and mem["swap_ins"] >= N_ADAPTERS
    assert ref_eng.memory_stats()["evictions"] == 0
    assert ref_eng.memory.hbm_bytes() >= N_ADAPTERS * page
    assert tstore.fp_resident_bytes() == 0
    assert any(e[0] == "prefetch" for e in log)


def test_single_slot_eviction_and_refault(models, served):
    jstore, tstore = served
    seq = [_aid(0), _aid(1), _aid(0)]
    _, eng, log = serve_both(models, jstore, tstore, seq, seed=2,
                             max_rows=1, hbm_slots=1)
    mem = eng.memory_stats()
    assert mem["slots"] == 1
    assert mem["misses"] == 3 and mem["hits"] == 0
    assert mem["evictions"] == 2
    assert [e[2] for e in log if e[0] == "acquire"] == [0, 0, 0]


def test_pinned_slot_never_evicted_while_row_live(models, served):
    """A long row pins its slot while four short requests churn the other
    one; both engines stepped in lock-step agree after every step."""
    jstore, tstore = served
    jeng, teng = models.engines(jstore, tstore, max_rows=2, hbm_slots=2)
    jlog, tlog = trace_paging(jeng.memory), trace_paging(teng.memory)
    vocab = models.jcfg.vocab
    jl, tl = requests(vocab, [_aid(0)], seed=3, max_new=10)
    js, ts = requests(vocab, [_aid(i) for i in (1, 2, 3, 4)], seed=4,
                      max_new=1)
    for r in js + ts:
        r.request_id += 1
    jeng.submit(jl[0])
    teng.submit(tl[0])
    assert [r.request_id for r in teng.step()] == \
        [r.request_id for r in jeng.step()]
    s_long = teng.memory.slot_of(_aid(0))
    assert teng.memory.pinned(_aid(0))
    for jr, tr in zip(js, ts):
        jeng.submit(jr)
        teng.submit(tr)
    jdone, tdone = [], []
    while teng.pending or teng.active_rows:
        jdone += jeng.step()
        tdone += teng.step()
        assert [r.request_id for r in tdone] == [r.request_id for r in jdone]
        if tl[0].output is None:
            assert teng.memory.slot_of(_aid(0)) == s_long
            assert teng.memory._slot_owner[s_long] == _aid(0)
    assert not jeng.pending and not jeng.active_rows
    for jr, tr in zip(jdone, tdone):
        np.testing.assert_array_equal(tr.output, jr.output)
    assert tlog == jlog
    assert teng.memory_stats() == jeng.memory_stats()
    assert teng.memory_stats()["evictions"] >= 3
    assert not teng.memory.pinned(_aid(0))
    assert_pools_equal(jeng.memory, teng.memory)


def test_zipf_churn_smoke(models, served):
    jstore, tstore = served
    rng = np.random.default_rng(7)
    p = 1.0 / np.arange(1, N_ADAPTERS + 1)
    seq = [_aid(i) for i in rng.choice(N_ADAPTERS, size=12, p=p / p.sum())]
    got, eng, _ = serve_both(models, jstore, tstore, seq, seed=8,
                             max_rows=4, hbm_slots=N_ADAPTERS // 4)
    assert len(got) == len(seq)
    assert all(v.shape == (2,) for v in got.values())
    mem = eng.memory_stats()
    assert mem["hits"] + mem["misses"] == len(seq)
    assert mem["swap_ins"] >= mem["misses"] > 0


# ----- manager unit semantics (no engine) -----

def _mini(served, n=4, budget=None):
    """Both packages' stores over the first ``n`` adapters."""
    jstore0, tstore0 = served
    jstore = JStore(JConfig(rho=0.9, ste_steps=0), hbm_budget_bytes=budget)
    tstore = AdapterStore(hbm_budget_bytes=budget)
    for aid in [_aid(i) for i in range(n)]:
        jstore.register_quantized(aid, jstore0.quantized[aid])
        tstore.register_quantized(aid, tstore0.quantized[aid])
    return jstore, tstore


def _managers(models, jstore, tstore, **kw):
    return (JMemory(jstore, models.jparams["lora"], **kw),
            AdapterMemoryManager(tstore, models.tparams["lora"],
                                 device="cpu", **kw))


def _both(mgrs, fn):
    """``fn`` applied to both managers; the results must agree."""
    want, got = (fn(m) for m in mgrs)
    assert got == want
    return got


def test_acquire_pin_evict_semantics(models, served):
    mgrs = _managers(models, *_mini(served), num_slots=2)
    s0 = _both(mgrs, lambda m: m.acquire(_aid(0)))
    s1 = _both(mgrs, lambda m: m.acquire(_aid(1)))
    assert {s0, s1} == {0, 1}
    assert _both(mgrs, lambda m: m.acquire(_aid(2))) is None
    _both(mgrs, lambda m: m.unpin(_aid(1)))
    assert _both(mgrs, lambda m: m.acquire(_aid(2))) == s1
    assert _both(mgrs, lambda m: (m.resident(_aid(1)),
                                  m.resident(_aid(2)))) == (False, True)
    st = _both(mgrs, lambda m: m.stats())
    assert st["evictions"] == 1 and st["misses"] == 3
    assert _both(mgrs, lambda m: m.acquire(_aid(0))) == s0
    assert _both(mgrs, lambda m: m.stats())["hits"] == 1
    assert_pools_equal(*mgrs)


def test_prefetch_reserves_staged_pages(models, served):
    mgrs = _managers(models, *_mini(served), num_slots=2)
    _both(mgrs, lambda m: m.acquire(_aid(0)))
    _both(mgrs, lambda m: m.prefetch([_aid(1)]))
    assert _both(mgrs, lambda m: (m.resident(_aid(1)),
                                  m.pinned(_aid(1)))) == (True, False)
    assert _both(mgrs, lambda m: m.acquire(_aid(2))) is None
    slot = _both(mgrs, lambda m: m.acquire(_aid(1)))
    assert slot == mgrs[1].slot_of(_aid(1))
    assert _both(mgrs, lambda m: m.stats())["hits"] == 1
    _both(mgrs, lambda m: m.unpin(_aid(1)))
    assert _both(mgrs, lambda m: m.acquire(_aid(2))) == slot
    assert_pools_equal(*mgrs)


def test_hbm_budget_derives_slot_count(models, served):
    probe = _managers(models, *_mini(served, n=1), num_slots=1)
    page = _both(probe, lambda m: m.page_bytes)
    mgrs = _managers(models, *_mini(served, budget=2 * page + page // 2))
    assert _both(mgrs, lambda m: m.num_slots) == 2
    assert _both(mgrs, lambda m: m.hbm_bytes()) == 2 * page
    assert_pools_equal(*mgrs)


def test_unbounded_pool_grows_for_new_registrations(models, served):
    jstore, tstore = _mini(served, n=2)
    mgrs = _managers(models, jstore, tstore)
    _both(mgrs, lambda m: m.acquire(_aid(0), pin=False))
    _both(mgrs, lambda m: m.acquire(_aid(1), pin=False))
    assert _both(mgrs, lambda m: m.num_slots) == 2
    jstore.register_quantized(_aid(9), served[0].quantized[_aid(9)])
    tstore.register_quantized(_aid(9), served[1].quantized[_aid(9)])
    _both(mgrs, lambda m: m.refresh())
    _both(mgrs, lambda m: (m.pin(_aid(0)), m.pin(_aid(1))))
    s0, s1 = _both(mgrs, lambda m: (m.slot_of(_aid(0)), m.slot_of(_aid(1))))
    s9 = _both(mgrs, lambda m: m.acquire(_aid(9)))
    assert mgrs[1].num_slots > 2 and s9 not in (s0, s1)
    assert _both(mgrs, lambda m: (m.slot_of(_aid(0)),
                                  m.slot_of(_aid(1)))) == (s0, s1)
    assert _both(mgrs, lambda m: m.stats())["evictions"] == 0
    assert_pools_equal(*mgrs)


# --------------------------------------------------------------------------
# tests/test_recipes.py: per-signature pools
# --------------------------------------------------------------------------

RECIPES = {
    "u0": dict(rho=0.95, bits_high=4, ste_steps=0),
    "u1": dict(rho=0.9, bits_high=3, ste_steps=0),
    "u2": dict(rho=0.9, bits_high=2, ste_steps=0),
    "u3": dict(rho=1e-6, bits_high=2, ste_steps=0),
}


def _mixed_reqs(vocab, seq, seed=30, max_new=4, plen=8):
    """The reference recipe tests' requests: one prompt seed per request."""
    out = []
    for cls in (JRequest, Request):
        out.append([cls(request_id=i, adapter_id=a,
                        prompt=np.random.default_rng(seed + i).integers(
                            0, vocab, size=plen).astype(np.int32),
                        max_new_tokens=max_new)
                    for i, a in enumerate(seq)])
    return out


def test_paged_memory_budget_with_unequal_page_sizes(models):
    """2-bit and 4-bit pools under a byte budget of 2 small + 1.5 large
    pages: the reference's paging and pools, real page bytes in the
    ledger, evictions, and tokens equal to the all-resident run."""
    r2, r4 = (JConfig(rho=0.9, bits_high=b, ste_steps=0) for b in (2, 4))
    jstore = JStore(r2)
    jstore.register_many(
        {f"m{i}": j_random_lora(models.jparams["lora"],
                                jax.random.PRNGKey(40 + i), scale=0.05)
         for i in range(6)},
        recipes={f"m{i}": (r2 if i % 2 == 0 else r4) for i in range(6)})
    tstore = bridge_store(jstore)
    mgrs = _managers(models, jstore, tstore)
    p2, p4 = _both(mgrs, lambda m: (m.page_bytes_of("m0"),
                                    m.page_bytes_of("m1")))
    assert p2 < p4
    with pytest.raises(RuntimeError, match="mixed recipe"):
        mgrs[1].page_bytes
    budget = 2 * p2 + p4 + p4 // 2
    jstore.hbm_budget_bytes = tstore.hbm_budget_bytes = budget
    seq = [f"m{i}" for i in range(6)] + ["m0", "m1"]
    got, eng, _ = serve_both(models, jstore, tstore, seq, seed=50,
                             max_new=3, plen=8, capacity=64, max_rows=2)
    assert eng.memory.hbm_bytes() <= budget
    assert eng.memory_stats()["evictions"] > 0
    assert eng.memory_stats()["pools"] == 2
    tstore.hbm_budget_bytes = None
    ref_eng = MultiLoRAEngine(models.tmodel, models.tparams, tstore,
                              cache_capacity=64, max_rows=2)
    for r in requests(models.jcfg.vocab, seq, 50, 3, 8)[1]:
        ref_eng.submit(r)
    for r in ref_eng.run():
        np.testing.assert_array_equal(got[r.request_id], r.output)


def test_reregister_with_new_recipe_reconciles_all_tiers(models):
    """Re-registering an id under another recipe moves its page to the new
    signature's pool, as in the reference, and serves the new codes."""
    r2 = JConfig(rho=0.9, bits_high=2, ste_steps=0)
    r4 = JConfig(rho=0.95, bits_high=4, ste_steps=0)
    tree = j_random_lora(models.jparams["lora"], jax.random.PRNGKey(77),
                         scale=0.05)
    jstore = JStore(r2)
    jstore.register("u", tree)
    tstore = bridge_store(jstore)
    jeng, teng = models.engines(jstore, tstore, capacity=64)
    vocab = models.jcfg.vocab
    outs = []
    for recipe in (None, r4):
        if recipe is not None:
            jstore.register("u", tree, recipe=recipe)
            tstore.register_quantized("u", quantized_adapter(
                jstore.quantized["u"], "cpu"))
        jr, tr = _mixed_reqs(vocab, ["u"], seed=9)
        jeng.submit(jr[0])
        teng.submit(tr[0])
        want, got = jeng.run()[0].output, teng.run()[0].output
        np.testing.assert_array_equal(got, want)
        outs.append(got)
    assert teng.memory.resident("u")
    assert teng.memory._where["u"][0] == tuple(r4.layout_signature)
    assert teng.memory_stats() == jeng.memory_stats()
    assert_pools_equal(jeng.memory, teng.memory)
    fresh = bridge_store(jstore)
    feng = MultiLoRAEngine(models.tmodel, models.tparams, fresh,
                           cache_capacity=64)
    feng.submit(_mixed_reqs(vocab, ["u"], seed=9)[1][0])
    np.testing.assert_array_equal(outs[1], feng.run()[0].output)


@pytest.fixture(scope="module")
def mixed_store(models):
    jstore = JStore(JConfig(ste_steps=0))
    jstore.register_many(
        {k: j_random_lora(models.jparams["lora"],
                          jax.random.PRNGKey(20 + i), scale=0.05)
         for i, k in enumerate(RECIPES)},
        recipes={k: JConfig(**v) for k, v in RECIPES.items()})
    return jstore, bridge_store(jstore)


def test_mixed_recipe_mid_decode_admission(models, mixed_store):
    """A request of another bucket admitted while the first is mid-decode:
    both engines stepped in lock-step give the same tokens, paging and
    pools, and the port's tokens equal solo materialize runs."""
    jstore, tstore = mixed_store
    jeng, teng = models.engines(jstore, tstore, capacity=64, max_rows=2)
    jlog, tlog = trace_paging(jeng.memory), trace_paging(teng.memory)
    (j0, j1), (t0, t1) = _mixed_reqs(models.jcfg.vocab, ["u0", "u3"],
                                     max_new=6)
    jeng.submit(j0)
    teng.submit(t0)
    jdone = jeng.step() + jeng.step()
    tdone = teng.step() + teng.step()
    assert teng.active_rows == jeng.active_rows == 1
    jeng.submit(j1)
    teng.submit(t1)
    while jeng.pending or jeng.active_rows:
        jdone += jeng.step()
        tdone += teng.step()
    assert not teng.pending and not teng.active_rows
    assert [r.request_id for r in tdone] == [r.request_id for r in jdone]
    for jr, tr in zip(jdone, tdone):
        np.testing.assert_array_equal(tr.output, jr.output)
    assert tlog == jlog
    assert teng.memory_stats() == jeng.memory_stats()
    assert teng.memory_stats()["pools"] == 2
    assert_pools_equal(jeng.memory, teng.memory)
    for i, aid in enumerate(["u0", "u3"]):
        solo = MultiLoRAEngine(models.tmodel, models.tparams, tstore,
                               cache_capacity=64)
        r = _mixed_reqs(models.jcfg.vocab, [aid], seed=30 + i, max_new=6)[1][0]
        solo.submit(r)
        np.testing.assert_array_equal(
            solo.run("materialize")[0].output, tdone[[
                q.request_id for q in tdone].index(i)].output)


def test_chip_smoke_stream_paging_is_the_reference(models, served):
    """``chip_smoke.py`` holds its bounded continuous serve (phase 13) to
    ``ZIPF_BOUNDED``: the paging and schedule of its Zipf stream at 8 rows
    and 4 slots, which depend on neither width nor depth nor the codes.
    Here the reference engine gives exactly those numbers on that stream
    (and the port the reference's paging, tokens and pools)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    jstore0, tstore0 = served
    jstore = JStore(JConfig(rho=0.9, ste_steps=0))
    tstore = AdapterStore()
    for i in range(cs.N_ADAPTERS):
        jstore.register_quantized(f"user_{i}", jstore0.quantized[_aid(i)])
        tstore.register_quantized(f"user_{i}", tstore0.quantized[_aid(i)])
    ids, _ = cs.zipf_stream(models.jcfg.vocab)
    _, eng, _ = serve_both(models, jstore, tstore, ids, seed=19,
                           max_new=cs.MAX_NEW, plen=cs.PROMPT, capacity=64,
                           max_rows=cs.CONT_ROWS, hbm_slots=cs.CONT_SLOTS)
    mem, st = eng.memory_stats(), eng.stats()
    got = {k: mem[k] for k in ("hits", "misses", "evictions", "swap_ins")}
    got.update({k: st[k] for k in ("decode_steps", "admission_waves")})
    assert got == cs.ZIPF_BOUNDED
