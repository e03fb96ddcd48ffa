"""Port vs reference: the serving failure contract and fault injection
(``repro_torch.serving.faults`` and the engine / paged memory's failure
paths against ``repro.serving``), at the smoke size of llama3.2-3b, fp32 on
the CPU.

Mirrors each of the 21 cases of ``tests/test_faults.py``. Every case runs
as one scenario on each package's stack (the same JAX-quantized adapters,
carried across with the bridge; the reference runs its Pallas kernel in
interpret mode); the scenario applies the reference test's own checks to
both, and the two packages' observations must be equal: statuses, error
types and kinds, tokens, ``FaultPlan.stats()``, transport and memory
stats. Adds ``benchmarks/bench_chaos.py``'s storm on a ``ManualClock``:
its four checks on both packages, the two runs equal, and equal to
``chip_smoke.CHAOS_STORM``, which the card's phase 16 holds.
"""

import dataclasses
import importlib.util
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import LoRAQuantConfig as JConfig
from repro.launch.serve import random_trained_lora as j_random_lora
from repro.serving import faults as jfaults
from repro.serving.engine import AdapterStore as JStore
from repro.serving.engine import MultiLoRAEngine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.memory import AdapterMemoryManager as JMemory
from repro_torch.bridge import quantized_adapter, to_torch
from repro_torch.kernels.quant_matmul import PLAIN_CALLS, reset_launch_counts
from repro_torch.serving import (AdapterMemoryManager, AdapterStore,
                                 MultiLoRAEngine, Request)
from repro_torch.serving import faults as tfaults
from test_torch_memory import Models

N_ADAPTERS = 4          # the reference test's fleet (u0..u3)
N_QUANTIZED = 6         # bench_chaos's fleet reuses u0..u5 as user_0..5
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: torch's intra-op thread pool would only
    contend with the other test workers for the CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _aid(i: int) -> str:
    return f"u{i}"


def load(name: str, path: Path):
    """A module from a file of the repo that is not on the import path
    (``chip_smoke.py``, ``benchmarks/bench_chaos.py``)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Side:
    """One package's serving stack over the shared model and the shared
    JAX-quantized adapters: stores, engines, memory managers, requests and
    the failure taxonomy (``self.f``), so one scenario runs on both."""

    def __init__(self, name, models, jqa):
        self.name, self.models = name, models
        self.jax = name == "jax"
        self.f = jfaults if self.jax else tfaults
        self.Request = JRequest if self.jax else Request
        self.vocab = models.jcfg.vocab
        self._qa = (jqa if self.jax else
                    {aid: quantized_adapter(qa, "cpu")
                     for aid, qa in jqa.items()})

    def qa(self, aid, jqa=None):
        """This side's form of ``jqa`` (default: the fixture's ``aid``)."""
        if jqa is None:
            return self._qa[aid]
        return jqa if self.jax else quantized_adapter(jqa, "cpu")

    def store(self, n=N_ADAPTERS, faults=None, poisoned=None, names=_aid):
        """A store of adapters u0..u(n-1) (registered as ``names(i)``), with
        ``poisoned`` (a JAX ``QuantizedAdapter``) in place of u1."""
        store = (JStore(JConfig(rho=0.9, ste_steps=0), faults=faults)
                 if self.jax else AdapterStore(faults=faults))
        for i in range(n):
            qa = (self.qa(None, poisoned) if poisoned is not None and i == 1
                  else self.qa(_aid(i)))
            store.register_quantized(names(i), qa)
        return store

    def engine(self, store, capacity=32, max_rows=4, **kw):
        m = self.models
        if not self.jax:
            return MultiLoRAEngine(m.tmodel, m.tparams, store,
                                   cache_capacity=capacity,
                                   max_rows=max_rows, **kw)
        eng = JEngine(m.jmodel, m.jparams, store, cache_capacity=capacity,
                      max_rows=max_rows, **kw)
        eng._prefill, eng._decode, eng._scatter_rows = m.jits(capacity)
        return eng

    def memory(self, store, **kw):
        if self.jax:
            return JMemory(store, self.models.jparams["lora"], **kw)
        return AdapterMemoryManager(store, self.models.tparams["lora"],
                                    device="cpu", **kw)

    def plan(self, **kw):
        return self.f.FaultPlan(**kw)

    def requests(self, seq, seed=0, max_new=2, plen=6, **kw):
        rng = np.random.default_rng(seed)
        return [self.Request(request_id=i, adapter_id=aid,
                             prompt=rng.integers(0, self.vocab, size=plen
                                                 ).astype(np.int32),
                             max_new_tokens=max_new, **kw)
                for i, aid in enumerate(seq)]


def obs(reqs):
    """What both packages must agree on for each request."""
    return [(r.request_id, r.adapter_id, r.status.value,
             None if r.error is None else (type(r.error).__name__,
                                           r.error.kind, r.error.adapter_id),
             None if r.output is None else r.output.tolist())
            for r in reqs]


def poison(jqa):
    """A copy of a JAX ``QuantizedAdapter`` whose first entry's high-B
    scales are NaN (a corrupt at-rest copy that the upload screen could
    not catch; the reference test's ``_poison_store``)."""
    path = next(iter(jqa.entries))
    q0 = jqa.entries[path][0]
    hi = q0.b_high
    bad_hi = dataclasses.replace(hi, scale=jnp.full(
        np.shape(hi.scale), np.nan, hi.scale.dtype))
    entries = dict(jqa.entries)
    entries[path] = ([dataclasses.replace(q0, b_high=bad_hi)]
                     + list(jqa.entries[path][1:]))
    return dataclasses.replace(jqa, entries=entries)


@pytest.fixture(scope="module")
def models():
    return Models()


@pytest.fixture(scope="module")
def sides(models):
    """The reference and the port over the same quantized adapters (one
    bucketed reference dispatch, as the reference test registers them)."""
    jstore = JStore(JConfig(rho=0.9, ste_steps=0))
    jstore.register_many({
        _aid(i): j_random_lora(models.jparams["lora"],
                               jax.random.PRNGKey(200 + i), scale=0.05)
        for i in range(N_QUANTIZED)})
    jqa = dict(jstore.quantized)
    return Side("jax", models, jqa), Side("torch", models, jqa)


def both(sides, scenario):
    """Run ``scenario(side)`` on both packages; their observations must be
    equal. Returns the port's."""
    want = scenario(sides[0])
    got = scenario(sides[1])
    assert got == want
    return got


# ----- unknown adapter at submit -----


def test_submit_unknown_adapter_rejected(sides):
    def run(s):
        eng = s.engine(s.store())
        req = s.requests(["nobody"])[0]
        assert eng.submit(req) is req
        assert req.status.value == "rejected" and req.status.terminal
        assert isinstance(req.error, s.f.UnknownAdapter)
        assert req.error.kind == "unknown_adapter"
        assert req.error.adapter_id == "nobody"
        assert req.output is not None and req.output.size == 0
        assert not eng.pending
        assert eng.step() == []
        return obs([req])
    both(sides, run)


# ----- unregister mid-decode (deferred reap) -----


def test_unregister_mid_decode_deferred_reap(sides):
    def run(s):
        store = s.store(n=2)
        solo_eng = s.engine(store)
        solo = solo_eng.submit(s.requests([_aid(0)], seed=3, max_new=6)[0])
        solo_eng.run()
        eng = s.engine(store, hbm_slots=2)
        req = s.requests([_aid(0)], seed=3, max_new=6)[0]
        eng.submit(req)
        eng.step()                              # admitted, page pinned
        assert eng.memory.pinned(_aid(0))
        store.unregister(_aid(0))
        done = []
        while eng.pending or eng.active_rows:
            done += eng.step()
        assert [r.request_id for r in done] == [req.request_id]
        assert req.status.value == "done"
        np.testing.assert_array_equal(req.output, solo.output)
        mem = eng.memory
        assert not mem.resident(_aid(0)) and _aid(0) not in mem._host
        assert not mem.pinned(_aid(0)) and mem.stats()["dead"] == 0
        rej = eng.submit(s.requests([_aid(0)], seed=4)[0])
        assert isinstance(rej.error, s.f.UnknownAdapter)
        return obs([solo, req, rej]), mem.stats()
    both(sides, run)


# ----- onboarding screens -----


def test_register_screens_nan_and_shape(sides, models):
    good_j = j_random_lora(models.jparams["lora"], jax.random.PRNGKey(9),
                           scale=0.05)
    bad_j = jax.tree_util.tree_map(lambda x: np.array(x), good_j)
    next(iter(jax.tree_util.tree_leaves(bad_j))).flat[0] = np.nan

    def run(s):
        good, bad = ((good_j, bad_j) if s.jax else
                     (to_torch(good_j, "cpu"), to_torch(bad_j, "cpu")))
        store = s.store(n=0)
        msgs = []
        with pytest.raises(s.f.AdapterValidationError,
                           match="non-finite") as e:
            store.register("bad", bad)
        msgs.append(str(e.value))
        assert "bad" not in store.quantized
        with pytest.raises(s.f.AdapterValidationError,
                           match="no .* LoRA") as e:
            store.register("empty", {"not_lora": 1})
        msgs.append(str(e.value))
        plan = s.plan(onboard_fail=frozenset({"u7"}))
        store_f = s.store(n=0, faults=plan)
        with pytest.raises(s.f.AdapterValidationError,
                           match="injected") as e:
            store_f.register("u7", good)
        msgs.append(str(e.value))
        out = store.register_many({"ok": good, "bad": bad}, on_error="skip")
        assert set(out) == {"ok"} and "ok" in store.quantized
        assert "bad" in store.onboard_errors
        return msgs, plan.stats(), sorted(store.onboard_errors.items())
    both(sides, run)


# ----- deadlines -----


def test_queue_ttft_deadline_times_out(sides):
    def run(s):
        eng = s.engine(s.store())
        req = s.requests([_aid(0)], ttft_deadline_ms=0.0)[0]
        eng.submit(req)
        assert req.status.value == "pending"
        time.sleep(0.002)
        assert eng.step() == [req]
        assert req.status.value == "timed_out"
        assert isinstance(req.error, s.f.DeadlineExceeded)
        assert req.output.size == 0
        return obs([req])
    both(sides, run)


def test_total_deadline_mid_decode_keeps_partial_output(sides):
    def run(s):
        eng = s.engine(s.store())
        req = s.requests([_aid(0)], max_new=64)[0]
        eng.submit(req)
        eng.step()                              # prefill: 1 token emitted
        assert req.status.value == "running"
        req.deadline_ms = 0.0                   # expires immediately
        assert eng.step() == [req]
        assert req.status.value == "timed_out"
        assert isinstance(req.error, s.f.DeadlineExceeded)
        assert 1 <= req.output.size < 64        # partial output kept
        assert not eng.memory.pinned(_aid(0))
        return obs([req])
    both(sides, run)


def test_default_deadline_applied_at_submit(sides):
    def run(s):
        eng = s.engine(s.store(), default_deadline_ms=1e6)
        req = eng.submit(s.requests([_aid(0)])[0])
        assert req.deadline_ms == 1e6
        named = eng.submit(s.requests([_aid(1)], deadline_ms=5.0)[0])
        return req.deadline_ms, named.deadline_ms
    both(sides, run)


# ----- backpressure -----


def test_queue_limit_reject_policy(sides):
    def run(s):
        eng = s.engine(s.store(), queue_limit=2)
        reqs = s.requests([_aid(0), _aid(1), _aid(2)])
        assert eng.submit(reqs[0]).status.value == "pending"
        assert eng.submit(reqs[1]).status.value == "pending"
        third = eng.submit(reqs[2])
        assert third.status.value == "rejected"
        assert isinstance(third.error, s.f.QueueFull)
        assert [r.request_id for r in eng.pending] == [0, 1]
        done = eng.run()
        assert {r.request_id for r in done} == {0, 1}
        assert all(r.status.value == "done" for r in done)
        return obs(reqs), [r.request_id for r in done]
    both(sides, run)


def test_queue_limit_shed_oldest_policy(sides):
    def run(s):
        eng = s.engine(s.store(), queue_limit=2, queue_policy="shed_oldest")
        reqs = s.requests([_aid(0), _aid(1), _aid(2)])
        eng.submit(reqs[0]), eng.submit(reqs[1])
        assert eng.submit(reqs[2]).status.value == "pending"
        assert reqs[0].status.value == "rejected"
        assert isinstance(reqs[0].error, s.f.QueueFull)
        assert [r.request_id for r in eng.pending] == [1, 2]
        done = eng.run()
        assert {r.request_id for r in done} == {0, 1, 2}
        assert reqs[1].status.value == reqs[2].status.value == "done"
        return obs(reqs), [r.request_id for r in done]
    both(sides, run)
    with pytest.raises(ValueError, match="queue_policy"):
        sides[1].engine(sides[1].store(), queue_policy="drop_newest")


# ----- all-pinned pool: HOL bypass and no deadlock -----


def test_all_pinned_pool_never_deadlocks(sides):
    def run(s):
        eng = s.engine(s.store(), hbm_slots=1, max_rows=2, stall_limit=2)
        mgr = eng.memory
        mgr.acquire(_aid(0))                    # hold the only slot
        victim, ok = s.requests([_aid(1), _aid(2)], max_new=1)
        eng.submit(victim), eng.submit(ok)
        done, spins = [], 0
        while (eng.pending or eng.active_rows) and spins < 50:
            done += eng.step()
            spins += 1
            if victim.status.terminal and mgr.pinned(_aid(0)):
                mgr.unpin(_aid(0))              # release the episode
        assert spins < 50
        assert isinstance(victim.error, s.f.MemoryExhausted)
        assert ok.status.value == "done" and ok.output.size == 1
        return obs([victim, ok]), spins, mgr.stats()
    both(sides, run)


def test_hol_bypass_admits_resident_adapter(sides):
    def run(s):
        eng = s.engine(s.store(), hbm_slots=1, max_rows=2)
        mgr = eng.memory
        mgr.acquire(_aid(0))                    # u0 resident and pinned
        blocked, rider = s.requests([_aid(1), _aid(0)], max_new=3)
        eng.submit(blocked), eng.submit(rider)
        eng.step()
        assert rider.status.value == "running"  # bypassed the stuck head
        assert blocked.status.value == "pending"
        mgr.unpin(_aid(0))
        done = eng.run()
        assert {r.request_id for r in done} == {0, 1}
        assert blocked.status.value == "done"

        eng2 = s.engine(s.store(), hbm_slots=1, max_rows=2,
                        hol_bypass=False, stall_limit=100)
        mgr2 = eng2.memory
        mgr2.acquire(_aid(0))
        b2, r2 = s.requests([_aid(1), _aid(0)], max_new=1)
        eng2.submit(b2), eng2.submit(r2)
        eng2.step()
        assert r2.status.value == "pending"     # strict FIFO: waits
        mgr2.unpin(_aid(0))
        return obs([blocked, rider, b2, r2])
    both(sides, run)


# ----- host-tier transport: retry, recovery, degradation -----


def test_transient_failures_recover_via_retry(sides):
    def run(s):
        plan = s.plan(seed=3, transient_fail_prob=0.4)
        calls, slept = [], []
        tr = s.f.HostTransport(faults=plan, max_retries=8,
                               sleep=slept.append)
        out = tr.read("a", lambda: calls.append(1) or "page")
        assert out == "page" and len(calls) == 1
        assert tr.stats()["failures"] == 0      # the budget absorbed it
        return tr.stats(), plan.stats(), slept
    both(sides, run)


def test_permanent_failure_exhausts_retries(sides):
    def run(s):
        plan = s.plan(fail_adapters=frozenset({"a"}))
        tr = s.f.HostTransport(faults=plan, max_retries=2,
                               sleep=lambda t: None)
        with pytest.raises(s.f.HostReadError) as ei:
            tr.read("a", lambda: "page")
        assert ei.value.adapter_id == "a" and ei.value.attempts == 3
        assert tr.stats()["failures"] == 1 and tr.stats()["retries"] == 2
        return str(ei.value), tr.stats(), plan.stats()
    both(sides, run)


def test_latency_over_timeout_counts_as_failure(sides):
    def run(s):
        plan = s.plan(read_latency_s=10.0, read_latency_prob=1.0)
        tr = s.f.HostTransport(faults=plan, timeout_s=0.01, max_retries=1,
                               sleep=lambda t: None)
        with pytest.raises(s.f.HostReadError, match="timeout") as ei:
            tr.read("a", lambda: "page")
        assert tr.stats()["timeouts"] == 2
        return str(ei.value), tr.stats(), plan.stats()
    both(sides, run)


def test_stale_resident_page_served_on_read_failure(sides):
    def run(s):
        store = s.store(n=1)
        plan = s.plan(fail_reads_from={_aid(0): 1})   # read #0 ok, then die
        mgr = s.memory(store, num_slots=2, faults=plan)
        mgr.transport.sleep = lambda t: None
        s0 = mgr.acquire(_aid(0))
        assert s0 is not None
        mgr.unpin(_aid(0))
        # re-register (bumps the version): the reload's host read fails
        store.register_quantized(_aid(0), s.qa(_aid(0)))
        s1 = mgr.acquire(_aid(0))
        assert s1 == s0                         # same slot, stale codes
        assert mgr.stats()["stale_serves"] >= 1
        assert mgr.stats()["host_read_failures"] >= 1
        return s0, s1, mgr.stats(), plan.stats()
    both(sides, run)


def test_acquire_propagates_hostreaderror_without_stale_page(sides):
    def run(s):
        store = s.store(n=2)
        plan = s.plan(fail_adapters=frozenset({_aid(1)}))
        mgr = s.memory(store, num_slots=2, faults=plan)
        mgr.transport.sleep = lambda t: None
        assert mgr.acquire(_aid(0)) is not None  # healthy neighbour fine
        with pytest.raises(s.f.HostReadError) as ei:
            mgr.acquire(_aid(1))
        assert not mgr.resident(_aid(1))
        return str(ei.value), mgr.stats(), plan.stats()
    both(sides, run)


def test_engine_rejects_memory_exhausted_on_permanent_read_failure(sides):
    def run(s):
        plan = s.plan(fail_adapters=frozenset({_aid(1)}))
        eng = s.engine(s.store(n=2), faults=plan)
        eng.memory.transport.sleep = lambda t: None
        bad, good = s.requests([_aid(1), _aid(0)], max_new=1)
        eng.submit(bad), eng.submit(good)
        done = eng.run()
        assert {r.request_id for r in done} == {0, 1}
        assert isinstance(bad.error, s.f.MemoryExhausted)
        assert good.status.value == "done"
        return obs([bad, good]), eng.memory_stats(), plan.stats()
    both(sides, run)


# ----- poison isolation -----


@pytest.mark.parametrize("mode", ["continuous", "packed"])
def test_poison_isolation_healthy_rows_token_identical(sides, mode):
    """A NaN-poisoned adapter co-batched with healthy ones: its requests
    FAIL (quarantine: the page check in continuous mode, the integrity
    screen in packed mode), healthy rows match a solo run token for
    token."""
    bad = _aid(1)
    jbad = poison(sides[0].qa(bad))

    def run(s):
        store = s.store(poisoned=jbad)
        solo_store = s.store()
        solo_store.unregister(bad)
        seq = [_aid(0), bad, _aid(2), _aid(3)]
        reqs = s.requests(seq, seed=11, max_new=3)
        solo_reqs = [r for r in s.requests(seq, seed=11, max_new=3)
                     if r.adapter_id != bad]
        solo_eng = s.engine(solo_store, mode=mode)
        for r in solo_reqs:
            solo_eng.submit(r)
        ref = {r.request_id: r.output for r in solo_eng.run()}
        eng = s.engine(store, mode=mode)
        for r in reqs:
            eng.submit(r)
        done = eng.run()
        assert {r.request_id for r in done} == {0, 1, 2, 3}
        for r in reqs:
            if r.adapter_id == bad:
                assert r.status.value == "failed"
                assert isinstance(r.error, s.f.PoisonedAdapter)
            else:
                assert r.status.value == "done"
                np.testing.assert_array_equal(r.output, ref[r.request_id])
        assert store.check_integrity(bad) is False
        assert store.check_integrity(_aid(0)) is True
        late = eng.submit(s.requests([bad], seed=12)[0])
        assert isinstance(late.error, s.f.PoisonedAdapter)
        return obs(reqs + [late]), [r.request_id for r in done]
    both(sides, run)


def test_quarantine_clears_on_reregister(sides):
    bad = _aid(1)
    jbad = poison(sides[0].qa(bad))

    def run(s):
        store = s.store(poisoned=jbad)
        eng = s.engine(store)
        r0 = eng.submit(s.requests([bad], max_new=1)[0])
        eng.run()
        assert r0.status.value == "failed" and eng._is_quarantined(bad)
        store.register_quantized(bad, s.qa(bad))      # fixed upload
        assert not eng._is_quarantined(bad)
        r1 = eng.submit(s.requests([bad], max_new=1)[0])
        done = eng.run()
        assert done == [r1] and r1.status.value == "done"
        assert r1.output.size == 1
        return obs([r0, r1])
    both(sides, run)


def test_integrity_screen_cached_per_version(sides):
    """The static screen reads the codes once per registration version:
    a re-register with other codes is screened again."""
    bad = _aid(1)
    jbad = poison(sides[0].qa(bad))

    def run(s):
        store = s.store()
        verdicts = [store.check_integrity(bad)]
        cached = store._integrity[bad]
        verdicts.append(store.check_integrity(bad))
        assert store._integrity[bad] is cached          # no second scan
        store.register_quantized(bad, s.qa(None, jbad))
        verdicts.append(store.check_integrity(bad))
        store.register_quantized(bad, s.qa(bad))
        verdicts.append(store.check_integrity(bad))
        return verdicts
    assert both(sides, run) == [True, True, False, True]


# ----- fault-plan determinism -----


def test_fault_plan_determinism(sides):
    def trace(plan):
        out = []
        for aid in ("a", "b", "a", "c", "a"):
            for attempt in range(2):
                out.append(plan.host_read(aid, attempt))
        return out

    def run(s):
        mk = lambda seed: s.plan(seed=seed, read_latency_s=0.004,  # noqa
                                 read_latency_prob=0.5,
                                 transient_fail_prob=0.3)
        assert trace(mk(7)) == trace(mk(7))      # same seed, same faults
        assert trace(mk(7)) != trace(mk(8))
        assert s.f.named_plan("none") is None
        storm = s.f.named_plan("storm", seed=5)
        assert storm.seed == 5 and storm.transient_fail_prob > 0
        with pytest.raises(ValueError, match="unknown fault plan"):
            s.f.named_plan("hurricane")
        plan = mk(7)
        return (trace(plan), trace(mk(8)), plan.stats(),
                dataclasses.asdict(storm))
    both(sides, run)


# ----- chaos mini-integration -----


def test_chaos_mini_storm_healthy_requests_token_identical(sides):
    """Seeded storm (latency spikes, transient read failures, one poisoned
    adapter) over a slot-constrained engine: healthy requests DONE with the
    fault-free run's tokens, the poisoned ones FAILED, no deadlock."""
    bad = _aid(3)
    seq = [_aid(i % N_ADAPTERS) for i in range(8)]

    def run(s):
        jbad = poison(sides[0].qa(bad))

        def drive(faults):
            store = s.store()
            store.register_quantized(bad, s.qa(None, jbad))
            eng = s.engine(store, hbm_slots=2, max_rows=2, faults=faults)
            if eng.memory.transport.faults is not None:
                eng.memory.transport.sleep = lambda t: None
            reqs = s.requests(seq, seed=21, max_new=2)
            for r in reqs:
                eng.submit(r)
            steps, done = 0, []
            while eng.pending or eng.active_rows or eng._terminated:
                done += eng.step()
                steps += 1
                assert steps < 200, "scheduler deadlocked under faults"
            return reqs, done, eng

        plan = s.plan(seed=13, read_latency_s=0.002, read_latency_prob=0.3,
                      transient_fail_prob=0.3)
        base_reqs, _, _ = drive(None)
        chaos_reqs, done, eng = drive(plan)
        assert len(done) == len(seq)
        for b, c in zip(base_reqs, chaos_reqs):
            if c.adapter_id == bad:
                assert isinstance(c.error, s.f.PoisonedAdapter)
                assert b.status.value == "failed"
            else:
                assert c.status.value == "done"
                np.testing.assert_array_equal(c.output, b.output)
        return (obs(base_reqs), obs(chaos_reqs), plan.stats(),
                eng.memory_stats())
    both(sides, run)


# ----- bench_chaos's storm: the reference's run is CHAOS_STORM -----


def test_chaos_storm_matches_reference(sides, models, monkeypatch):
    """``benchmarks/bench_chaos.py``'s storm and baseline on a
    ``ManualClock`` at smoke size: the reference's run (its own ``_drive``)
    and the port's (``chip_smoke.chaos_drive``, phase 16's driver) give
    the same tokens, statuses, injected faults, transport and paging stats,
    schedule and virtual time; both pass bench_chaos's four checks; and
    the run is ``chip_smoke.CHAOS_STORM``."""
    bench_chaos = load("bench_chaos", ROOT / "benchmarks" / "bench_chaos.py")
    cs = load("chip_smoke", ROOT / "chip_smoke.py")
    jside, tside = sides
    assert (cs.CHAOS_ADAPTERS, cs.CHAOS_REQUESTS, cs.CHAOS_PROMPT,
            cs.CHAOS_NEW, cs.CHAOS_SLOTS, cs.CHAOS_ROWS, cs.CHAOS_BAD,
            cs.CHAOS_DEADLINE_MS, cs.CHAOS_PIN_AT, cs.CHAOS_PIN_STEPS,
            cs.CHAOS_STEP_CAP, cs.CHAOS_STEP_S, cs.GOODPUT_BOUND) == (
        bench_chaos.N_ADAPTERS, bench_chaos.N_REQUESTS,
        bench_chaos.PROMPT_LEN, bench_chaos.MAX_NEW, bench_chaos.SLOTS,
        bench_chaos.ROWS, bench_chaos.BAD, bench_chaos.DEADLINE_MS,
        bench_chaos.PIN_AT, bench_chaos.PIN_STEPS, bench_chaos.STEP_CAP,
        bench_chaos.STEP_S, bench_chaos.GOODPUT_BOUND)
    assert dataclasses.asdict(cs.chaos_plan()) == dataclasses.asdict(
        bench_chaos._storm_plan())

    def user(i):
        return f"user_{i}"

    # the reference engine, built by bench_chaos itself, on shared jits
    def j_engine(model, params, store, cache_capacity, **kw):
        eng = JEngine(model, params, store, cache_capacity=cache_capacity,
                      **kw)
        eng._prefill, eng._decode, eng._scatter_rows = models.jits(
            cache_capacity)
        return eng

    monkeypatch.setattr(bench_chaos, "MultiLoRAEngine", j_engine)
    jstore = jside.store(n=cs.CHAOS_ADAPTERS, names=user)
    tstore = tside.store(n=cs.CHAOS_ADAPTERS, names=user)
    runs = {}
    for name, jplan, tplan in (("baseline", None, None),
                               ("storm", bench_chaos._storm_plan(),
                                cs.chaos_plan())):
        jrun = bench_chaos._drive(models.jcfg, models.jmodel, models.jparams,
                                  jstore, jplan)
        jrun.update(transport=jrun["eng"].memory.transport.stats(),
                    stats=jrun["eng"].stats())
        reset_launch_counts()
        trun = cs.chaos_drive(models.tmodel, models.tparams, tstore,
                              models.jcfg.vocab, tplan, device="cpu")
        assert dict(PLAIN_CALLS) == {"sgmv_fused": 2 * 7 * (
            trun["stats"]["decode_steps"] + trun["stats"]["admission_waves"])}
        assert obs(trun["reqs"]) == obs(jrun["reqs"])
        assert [r.request_id for r in trun["done"]] == \
            [r.request_id for r in jrun["done"]]
        assert trun["mem"] == jrun["mem"]
        np.testing.assert_array_equal(trun["lats"], jrun["lats"])
        jsum = cs.chaos_summary(jrun, jplan)
        assert cs.chaos_summary(trun, tplan) == jsum
        runs[name] = (jrun, trun, jsum)
    cs.chaos_checks(runs["baseline"][0], runs["storm"][0])
    cs.chaos_checks(runs["baseline"][1], runs["storm"][1])
    assert {name: r[2] for name, r in runs.items()} == cs.CHAOS_STORM
