"""Port vs reference: the continuous-batching scheduler
(``MultiLoRAEngine.step`` in ``repro_torch.serving.engine`` against
``repro.serving.engine``) over the paged adapter memory, at the smoke size
of llama3.2-3b, fp32 on the CPU.

Mirrors the continuous-mode tests of ``tests/test_serving.py`` and adds
the Zipf(α=1) churn and the mixed-recipe churn of
``benchmarks/bench_serving.py`` at smoke size: tokens, the paging sequence
and the pools bit for bit, the same schedule (prefill groups, decode
steps, completion order), and ``sgmv_fused`` called exactly as often as
the reference records it (it records a launch per traced kernel call, so
each distinct program it runs is traced once more with ``jax.disable_jit``,
which unrolls its layer scan, and counted once per run of it). It also
holds the three rules that make the port's in-place page writes give the
reference's tokens.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import LoRAQuantConfig as JConfig
from repro.kernels.quant_matmul import kernel as jk
from repro.launch.serve import random_trained_lora as j_random_lora
from repro.serving.engine import AdapterStore as JStore
from repro_torch.kernels.quant_matmul import (LAUNCH_COUNTS, PLAIN_CALLS,
                                               reset_launch_counts)
from repro_torch.kernels.quant_matmul.ops import _LAYOUTS
from repro_torch.serving import MultiLoRAEngine, Request
from test_torch_memory import (Models, assert_pools_equal, bridge_store,
                               requests, trace_paging)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: torch's intra-op thread pool would only
    contend with the other test workers for the CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def models():
    return Models()


@pytest.fixture(scope="module")
def served_store(models):
    """Two adapters registered one by one (the reference's fixture)."""
    jstore = JStore(JConfig(rho=0.9, ste_steps=0))
    for i in range(2):
        jstore.register(f"u{i}", j_random_lora(
            models.jparams["lora"], jax.random.PRNGKey(90 + i), scale=0.05))
    return jstore, bridge_store(jstore)


@pytest.fixture(scope="module")
def cont(models, served_store):
    """One engine pair shared by the scheduler tests, as the reference
    shares one engine (max_rows=2: 4-request workloads reuse rows)."""
    return models.engines(*served_store, capacity=64, max_rows=2)


def _sched(models, **kw):
    """The reference's 4 scheduler requests, for both engines."""
    g = np.random.default_rng(21)
    out = ([], [])
    for rid, (plen, n) in enumerate(zip([5, 8, 11, 8], [6, 2, 6, 2])):
        p = g.integers(0, models.jcfg.vocab, size=plen).astype(np.int32)
        for reqs, cls in zip(out, (jax_request, Request)):
            reqs.append(cls(request_id=rid, adapter_id=f"u{rid % 2}",
                            prompt=p.copy(), max_new_tokens=n, **kw))
    return out


def jax_request(**kw):
    from repro.serving.engine import Request as JRequest

    kw.pop("keep_logits", None)
    return JRequest(**kw)


def _lockstep(jeng, teng, jreqs=(), treqs=()):
    """Submit and step both engines until both drain, checking the same
    requests finish in the same step; returns both finished lists."""
    for jr, tr in zip(jreqs, treqs):
        jeng.submit(jr)
        teng.submit(tr)
    jdone, tdone = [], []
    while jeng.pending or jeng.active_rows:
        jdone += jeng.step()
        tdone += teng.step()
        assert [r.request_id for r in tdone] == [r.request_id for r in jdone]
    assert not teng.pending and not teng.active_rows
    for jr, tr in zip(jdone, tdone):
        np.testing.assert_array_equal(tr.output, jr.output)
    return jdone, tdone


# --------------------------------------------------------------------------
# tests/test_serving.py: continuous mode
# --------------------------------------------------------------------------

def test_continuous_matches_static_packed(models, served_store, cont):
    """All requests up front through 2 rows: the reference's tokens and
    schedule, equal to the port's static packed batch; kept logits equal
    the packed ones to fp32 rounding."""
    jeng, teng = cont
    jreqs, treqs = _sched(models, keep_logits=True)
    _, tdone = _lockstep(jeng, teng, jreqs, treqs)
    assert served_store[1].fp_resident_bytes() == 0
    static = MultiLoRAEngine(models.tmodel, models.tparams, served_store[1],
                             cache_capacity=64, mode="packed")
    for r in _sched(models, keep_logits=True)[1]:
        static.submit(r)
    ref = {r.request_id: r for r in static.run()}
    tol = 1e-4 * max(np.abs(r.logits).max() for r in ref.values())
    for r in tdone:
        np.testing.assert_array_equal(r.output, ref[r.request_id].output)
        assert r.logits.shape == (len(r.output), models.jcfg.vocab)
        np.testing.assert_allclose(r.logits, ref[r.request_id].logits,
                                   rtol=0, atol=tol)


def test_mid_decode_admission_matches_solo(models, cont):
    jeng, teng = cont
    (jbg, _, jnew, _), (tbg, _, tnew, _) = _sched(models)
    _, (solo,) = _lockstep(jeng, teng, [dataclasses.replace(jnew)],
                           [dataclasses.replace(tnew)])
    jeng.submit(jbg)
    teng.submit(tbg)
    for _ in range(2):
        assert [r.request_id for r in teng.step()] == \
            [r.request_id for r in jeng.step()]
    assert teng.active_rows == jeng.active_rows == 1
    _, tdone = _lockstep(jeng, teng, [jnew], [tnew])
    got = {r.request_id: r.output for r in tdone}
    np.testing.assert_array_equal(got[tnew.request_id], solo.output)


def test_early_finish_frees_slot_for_pending(models, cont):
    jeng, teng = cont
    jreqs, treqs = _sched(models)
    _, tdone = _lockstep(jeng, teng, jreqs, treqs)
    order = [r.request_id for r in tdone]
    assert sorted(order) == [0, 1, 2, 3]
    assert teng.active_rows == 0
    assert order.index(1) < order.index(0)
    for r in treqs:
        assert r.output.shape == (r.max_new_tokens,)


def test_eos_retires_row_early(models, served_store, cont):
    jeng, teng = cont
    jbase, tbase = (reqs[0] for reqs in _sched(models))
    _, (free,) = _lockstep(jeng, teng, [dataclasses.replace(jbase)],
                           [dataclasses.replace(tbase)])
    eos = int(free.output[1])
    first = int(np.nonzero(free.output == eos)[0][0])
    expect = free.output[: first + 1]
    _, (got,) = _lockstep(jeng, teng, [dataclasses.replace(jbase, eos_id=eos)],
                          [dataclasses.replace(tbase, eos_id=eos)])
    np.testing.assert_array_equal(got.output, expect)
    static = MultiLoRAEngine(models.tmodel, models.tparams, served_store[1],
                             cache_capacity=64)
    static.submit(dataclasses.replace(tbase, eos_id=eos))
    np.testing.assert_array_equal(static.run(mode="packed")[0].output, expect)


def test_mid_decode_register_keeps_row_adapters(models, served_store, cont):
    """A registration mid-decode grows the (unbounded) pool; the live row
    keeps its adapter and its solo tokens, and the pools stay the
    reference's."""
    jeng, teng = cont
    jstore, tstore = served_store
    jreq, treq = (reqs[2] for reqs in _sched(models))
    _, (solo,) = _lockstep(jeng, teng, [dataclasses.replace(jreq)],
                           [dataclasses.replace(treq)])
    jeng.submit(dataclasses.replace(jreq))
    teng.submit(dataclasses.replace(treq))
    for _ in range(2):
        jeng.step()
        teng.step()
    jstore.register("a_first", j_random_lora(
        models.jparams["lora"], jax.random.PRNGKey(99), scale=0.05))
    tstore.register_quantized("a_first", bridge_store(
        jstore, ids=["a_first"]).quantized["a_first"])
    jdone, tdone = _lockstep(jeng, teng)
    np.testing.assert_array_equal(tdone[-1].output, solo.output)
    assert teng.memory_stats() == jeng.memory_stats()
    assert_pools_equal(jeng.memory, teng.memory)


# --------------------------------------------------------------------------
# bench_serving.py's churn streams at smoke size
# --------------------------------------------------------------------------

CHURN_ADAPTERS = 8
CHURN_REQUESTS = 16
CHURN_ROWS = 2


def _churn_ids():
    zrng = np.random.default_rng(17)
    pz = 1.0 / np.arange(1, CHURN_ADAPTERS + 1)       # Zipf α=1, truncated
    return [f"user_{i}" for i in zrng.choice(
        CHURN_ADAPTERS, size=CHURN_REQUESTS, p=pz / pz.sum())]


def _churn_reqs(vocab, max_new):
    rng = np.random.default_rng(19)
    prompts = [rng.integers(0, vocab, size=8).astype(np.int32)
               for _ in range(CHURN_REQUESTS)]
    return ([jax_request(request_id=i, adapter_id=a, prompt=p.copy(),
                         max_new_tokens=max_new)
             for i, (a, p) in enumerate(zip(_churn_ids(), prompts))],
            [Request(request_id=i, adapter_id=a, prompt=p.copy(),
                     max_new_tokens=max_new)
             for i, (a, p) in enumerate(zip(_churn_ids(), prompts))])


def _buckets(params) -> int:
    """``sgmv_fused`` launches per LoRA linear of a forward over these
    params: one per bucket of a mixed tree, else one."""
    leaf = params["lora"]["groups"][0]["sub_0"]["mixer"]["wq"]
    return len(getattr(leaf, "buckets", (leaf,)))


def _count_reference(models, jeng, capacity):
    """Count the kernel launches of every forward the reference engine
    runs: each distinct program (tree structure and shapes, what its jit
    compiles once) is traced once more with its layer scan unrolled
    (``jax.disable_jit``), and its recorded launches are added per call.
    Returns the running counter."""
    counts, per_program = {}, {}
    model = models.jmodel
    prefill, decode = jeng._prefill, jeng._decode

    def traced(fn, jitted):
        def call(*args):
            leaves, tree = jax.tree_util.tree_flatten(args)
            key = (fn, tree, tuple((np.shape(x), str(np.result_type(x)))
                                   for x in leaves))
            if key not in per_program:
                before = dict(jk.LAUNCH_COUNTS)
                with jax.disable_jit():
                    jax.make_jaxpr(lambda *a: fn(*a))(*args)
                per_program[key] = {
                    k: v - before.get(k, 0)
                    for k, v in jk.LAUNCH_COUNTS.items()
                    if v != before.get(k, 0)}
            for k, v in per_program[key].items():
                counts[k] = counts.get(k, 0) + v
            return jitted(*args)
        return call

    prefill_fn = lambda p, b: model.prefill(p, b, capacity)  # noqa: E731
    jeng._prefill = traced(prefill_fn, prefill)
    jeng._decode = traced(model.decode_step, decode)
    return counts


def _churn(models, jstore, tstore, slots, max_new=4, reference=True):
    """The churn stream on the port's engine and, with ``reference``, on
    the reference's in lock-step: tokens, schedule, paging, pools and
    launch counts against it. Returns the port's outputs and engine."""
    jeng, teng = models.engines(jstore, tstore, capacity=64,
                                max_rows=CHURN_ROWS, hbm_slots=slots)
    jcounts = _count_reference(models, jeng, 64)
    jlog, tlog = trace_paging(jeng.memory), trace_paging(teng.memory)
    forwards = []
    orig_prefill, orig_decode = models.tmodel.prefill, models.tmodel.decode_step

    def count_prefill(params, *a, **kw):
        forwards.append(_buckets(params))
        return orig_prefill(params, *a, **kw)

    def count_decode(params, *a, **kw):
        forwards.append(_buckets(params))
        return orig_decode(params, *a, **kw)

    jreqs, treqs = _churn_reqs(models.jcfg.vocab, max_new)
    layouts = len(_LAYOUTS)
    reset_launch_counts()
    models.tmodel.prefill, models.tmodel.decode_step = (count_prefill,
                                                        count_decode)
    try:
        if reference:
            _, tdone = _lockstep(jeng, teng, jreqs, treqs)
        else:
            for r in treqs:
                teng.submit(r)
            tdone = teng.run()
    finally:
        del models.tmodel.prefill, models.tmodel.decode_step
    assert len(forwards) == teng._wave + teng._step_count
    assert len(_LAYOUTS) == layouts   # no pool went through the layout cache
    # every forward: 2 layers x 7 LoRA linears x one launch per bucket
    assert dict(PLAIN_CALLS) == {"sgmv_fused": 2 * 7 * sum(forwards)}
    assert not LAUNCH_COUNTS
    if reference:
        assert tlog == jlog
        assert teng.memory_stats() == jeng.memory_stats()
        assert_pools_equal(jeng.memory, teng.memory)
        assert (teng._wave, teng._step_count) == (jeng._wave,
                                                  jeng._step_count)
        assert dict(PLAIN_CALLS) == jcounts
    return {r.request_id: r.output for r in tdone}, teng


@pytest.fixture(scope="module")
def churn_store(models):
    jstore = JStore(JConfig(rho=0.9, ste_steps=0))
    jstore.register_many({
        f"user_{i}": j_random_lora(models.jparams["lora"],
                                   jax.random.PRNGKey(30 + i))
        for i in range(CHURN_ADAPTERS)})
    return jstore, bridge_store(jstore)


def test_zipf_churn_matches_reference(models, churn_store):
    """Zipf(α=1) over 8 adapters, 16 requests, 2 rows, at 50 % residency
    (4 slots): the reference's tokens, paging, pools and launches; the
    bounded pool evicts and gives the port's all-resident tokens."""
    jstore, tstore = churn_store
    bounded, eng = _churn(models, jstore, tstore, CHURN_ADAPTERS // 2)
    mem = eng.memory_stats()
    assert mem["evictions"] > 0 and mem["misses"] > 0
    assert mem["slots"] == 4
    assert eng.memory.hbm_bytes() == 4 * eng.memory.page_bytes
    resident, _ = _churn(models, jstore, tstore, None, reference=False)
    for rid in resident:
        np.testing.assert_array_equal(bounded[rid], resident[rid])


@pytest.fixture(scope="module")
def mixed_churn_store(models):
    recipes = {f"user_{i}": (JConfig(rho=0.95, bits_high=3, ste_steps=0)
                             if i < CHURN_ADAPTERS // 2
                             else JConfig(rho=1e-6, bits_high=2, ste_steps=0))
               for i in range(CHURN_ADAPTERS)}
    jstore = JStore(JConfig(rho=0.9, ste_steps=0))
    jstore.register_many({
        f"user_{i}": j_random_lora(models.jparams["lora"],
                                   jax.random.PRNGKey(30 + i))
        for i in range(CHURN_ADAPTERS)}, recipes=recipes)
    return jstore, bridge_store(jstore)


def test_mixed_recipe_churn_matches_reference(models, mixed_churn_store):
    """The same stream over a 3-bit head and a near-1-bit tail (two
    per-signature pools) at 25 % residency (2 slots; the benchmark's 50 %
    gives this stream 7 distinct reference programs to compile, 25 %
    gives 4 and more evictions): the reference's tokens, paging, pools
    and launches (one per bucket per linear); the port's all-resident run
    gives the same tokens."""
    jstore, tstore = mixed_churn_store
    bounded, eng = _churn(models, jstore, tstore, CHURN_ADAPTERS // 4)
    assert eng.memory_stats()["pools"] == 2
    assert eng.memory_stats()["evictions"] > 0
    resident, _ = _churn(models, jstore, tstore, None, reference=False)
    for rid in resident:
        np.testing.assert_array_equal(bounded[rid], resident[rid])


# --------------------------------------------------------------------------
# the in-place page writes
# --------------------------------------------------------------------------

def test_prefetch_overwrites_evicted_slot_under_live_row(models,
                                                          churn_store):
    """One row, two slots: while a row decodes from its pinned slot, the
    next request's page is prefetched into the other slot, evicting its
    owner and overwriting it in place. The live row's tokens, the paging
    and the pools stay the reference's."""
    jstore, tstore = churn_store
    jeng, teng = models.engines(jstore, tstore, capacity=64, max_rows=1,
                                hbm_slots=2)
    jlog, tlog = trace_paging(jeng.memory), trace_paging(teng.memory)
    seq = ["user_0", "user_1", "user_2", "user_3", "user_0"]
    jreqs, treqs = requests(models.jcfg.vocab, seq, seed=5, max_new=4)
    overwrites = []
    mgr = teng.memory
    prefetch = mgr.prefetch

    def watch(ids):
        owners = list(mgr._slot_owner)
        live = {r.req.adapter_id for r in teng._rows if r is not None}
        prefetch(ids)
        overwrites.extend(
            (slot, old, new) for slot, (old, new)
            in enumerate(zip(owners, mgr._slot_owner))
            if old is not None and new != old and live and old not in live)

    mgr.prefetch = watch
    _lockstep(jeng, teng, jreqs, treqs)
    assert overwrites, "no prefetch overwrote an evicted slot"
    assert tlog == jlog
    assert_pools_equal(jeng.memory, teng.memory)
    assert teng.memory_stats()["prefetch"]["staged"] >= len(overwrites)


def test_pool_growth_leaves_earlier_view_intact(models, served_store):
    """Two adapters registered while two long rows decode make the
    unbounded pool grow mid-decode: the resize allocates new tensors and
    leaves the old ones, which the decode view of that step reads, byte
    for byte as they were; the tokens stay the reference's."""
    jstore, tstore = served_store
    jeng, teng = models.engines(jstore, tstore, capacity=64, max_rows=2)
    jreqs, treqs = requests(models.jcfg.vocab, ["u0", "u1"], seed=6,
                            max_new=8)
    jeng.submit(jreqs[0])
    teng.submit(treqs[0])
    jeng.step()
    teng.step()
    mgr = teng.memory
    resizes = []
    resize = mgr._resize_pool

    def watch(pool, capacity):
        old, view = pool.arrays, teng._dec_groups
        snap = {p: {f: t.clone() for f, t in fs.items()}
                for p, fs in (old or {}).items()}
        resize(pool, capacity)
        resizes.append((old, snap, pool.arrays, view, teng.active_rows))

    mgr._resize_pool = watch
    new_ids = ["grow_0", "grow_1"]
    for i, aid in enumerate(new_ids):
        jstore.register(aid, j_random_lora(
            models.jparams["lora"], jax.random.PRNGKey(500 + i), scale=0.05))
        tstore.register_quantized(aid, bridge_store(
            jstore, ids=[aid]).quantized[aid])
    more_j, more_t = requests(models.jcfg.vocab, new_ids, seed=7, max_new=2)
    for r in more_j + more_t:
        r.request_id += 10
    _lockstep(jeng, teng, [jreqs[1]] + more_j, [treqs[1]] + more_t)
    path = "/groups/0/sub_0/mixer/wq"
    grown = [r for r in resizes if r[0] is not None and r[4]
             and r[3] is not None
             and r[3][0]["sub_0"]["mixer"]["wq"].ah_codes is r[0][path][
                 "ah_codes"]]
    assert grown, "the pool did not grow under a live decode view"
    for old, snap, new, view, _ in grown:
        for p, fields in old.items():
            for f, t in fields.items():
                assert torch.equal(t, snap[p][f])         # never written
                assert new[p][f].data_ptr() != t.data_ptr()
    assert teng.memory_stats() == jeng.memory_stats()
    assert_pools_equal(jeng.memory, teng.memory)


# --------------------------------------------------------------------------
# the failure contract that step() applies
# --------------------------------------------------------------------------

class _Clock:
    """A manual clock (seconds) for both engines."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_deadlines_match_reference(models, served_store):
    """A queued request past its TTFT budget and a live row past its total
    budget retire TIMED_OUT (the row with its partial output) in the same
    step and with the same tokens as in the reference."""
    from repro.serving.engine import MultiLoRAEngine as JEngine
    from repro_torch.serving import DeadlineExceeded, RequestStatus

    jstore, tstore = served_store
    jclock, tclock = _Clock(), _Clock()
    jeng = JEngine(models.jmodel, models.jparams, jstore, cache_capacity=64,
                   max_rows=1, clock=jclock)
    jeng._prefill, jeng._decode, jeng._scatter_rows = models.jits(64)
    teng = MultiLoRAEngine(models.tmodel, models.tparams, tstore,
                           cache_capacity=64, max_rows=1)
    teng.clock = tclock
    jreqs, treqs = requests(models.jcfg.vocab, ["u0", "u1"], seed=12,
                            max_new=6)
    for reqs in (jreqs, treqs):
        reqs[0].deadline_ms = 25.0            # total budget of the row
        reqs[1].ttft_deadline_ms = 15.0       # waits behind it in queue
    for t in (0.0, 0.010, 0.020, 0.030):
        jclock.t = tclock.t = t
        if t == 0.0:
            for jr, tr in zip(jreqs, treqs):
                jeng.submit(jr)
                teng.submit(tr)
        jd, td = jeng.step(), teng.step()
        assert [r.request_id for r in td] == [r.request_id for r in jd]
    for jr, tr in zip(jreqs, treqs):
        assert tr.status is RequestStatus.TIMED_OUT
        assert tr.status.value == jr.status.value
        assert isinstance(tr.error, DeadlineExceeded)
        np.testing.assert_array_equal(tr.output, jr.output)
    assert len(treqs[0].output) == 4 and len(treqs[1].output) == 0
    assert not teng.pending and not teng.active_rows
    assert not teng.memory.pinned("u0")


def test_poisoned_page_quarantines_adapter(models, served_store):
    """A page whose scales are not finite fails its request (the adapter is
    quarantined) while a co-batched healthy request gets its solo tokens;
    a re-register with healthy codes clears the quarantine."""
    from repro_torch.serving import PoisonedAdapter, RequestStatus

    _, tstore = served_store
    bad = tstore.quantized["u1"]
    path = next(iter(bad.entries))
    q0 = bad.entries[path][0]
    poisoned = dataclasses.replace(bad, entries={
        **bad.entries, path: [dataclasses.replace(q0, a_high=dataclasses.
                                                  replace(q0.a_high, scale=
                                                          q0.a_high.scale *
                                                          float("nan")))]
        + bad.entries[path][1:]})
    tstore.register_quantized("sick", poisoned)
    eng = MultiLoRAEngine(models.tmodel, models.tparams, tstore,
                          cache_capacity=64, max_rows=2)
    _, treqs = requests(models.jcfg.vocab, ["u0", "sick"], seed=13,
                        max_new=3)
    for r in treqs:
        eng.submit(r)
    done = {r.request_id: r for r in eng.run()}
    assert done[1].status is RequestStatus.FAILED
    assert isinstance(done[1].error, PoisonedAdapter)
    assert "sick" in eng.quarantined
    solo = MultiLoRAEngine(models.tmodel, models.tparams, tstore,
                           cache_capacity=64, mode="packed")
    solo.submit(requests(models.jcfg.vocab, ["u0"], seed=13, max_new=3)[1][0])
    np.testing.assert_array_equal(done[0].output, solo.run()[0].output)
    again = eng.submit(requests(models.jcfg.vocab, ["sick"], seed=14)[1][0])
    assert again.status is RequestStatus.FAILED
    tstore.register_quantized("sick", bad)
    healed = eng.submit(requests(models.jcfg.vocab, ["sick"], seed=14)[1][0])
    assert healed.status is RequestStatus.PENDING
    assert eng.run()[0].status is RequestStatus.DONE
    tstore.unregister("sick")
