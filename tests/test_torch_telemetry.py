"""Port vs reference: serving telemetry (``repro_torch.serving.telemetry``
and the engine / paged memory's hooks against ``repro.serving``), at the
smoke size of llama3.2-3b, fp32 on the CPU.

Mirrors each of the 12 cases of ``tests/test_telemetry.py``. The
primitives (clock, histograms, registry, exposition, event schema) run the
same calls on both packages and must give the same values and text. The
engine-driven cases serve one request stream on both engines, each with a
``Telemetry`` on its own ``ManualClock`` that ticks at every read, so every
timestamp records where the engine read its clock: the JSONL event log
must equal the reference's line for line, the Chrome trace after
``json.loads``, and the Prometheus exposition line for line except
``pallas_launches_total``, which the reference records per trace and the
port per call: it must equal the port's ``PLAIN_CALLS`` delta exactly.
Also runs the serve driver on the CPU with every fault and telemetry flag,
and holds both packages' ``--no-quant`` to an error (ROADMAP C7).
"""

import json

import jax
import numpy as np
import pytest
import torch

from repro.core import LoRAQuantConfig as JConfig
from repro.launch import serve as j_serve
from repro.launch.serve import random_trained_lora as j_random_lora
from repro.serving import telemetry as jtel
from repro.serving.engine import AdapterStore as JStore
from repro.serving.engine import MultiLoRAEngine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch.kernels.quant_matmul import PLAIN_CALLS
from repro_torch.launch import serve as t_serve
from repro_torch.serving import MultiLoRAEngine, Request
from repro_torch.serving import telemetry as ttel
from test_torch_memory import Models, bridge_store

PACKAGES = {"jax": jtel, "torch": ttel}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def on_both(scenario):
    """``scenario(telemetry_module)`` on both packages: equal results."""
    want = scenario(jtel)
    got = scenario(ttel)
    assert got == want
    return got


# ---------------------------------------------------------------- primitives


def test_manual_clock():
    def run(t):
        c = t.ManualClock(start=2.0)
        seen = [c()]
        c.advance(0.5)
        seen.append(c())
        c.sleep(1.5)
        seen.append(c())
        c.sleep(-1.0)                      # a sleep never goes back
        seen.append(c())
        with pytest.raises(ValueError):
            c.advance(-1.0)
        return seen
    assert on_both(run) == [2.0, 2.5, 4.0, 4.0]


def test_histogram_percentiles_known_values():
    def run(t):
        h = t.Histogram("lat", buckets=(1.0, 2.0, 4.0, 8.0))
        assert h.percentile(50) is None and h.mean is None
        for v in (0.5, 1.5, 3.0, 3.0, 7.0):
            h.observe(v)
        assert h.count == 5 and h.sum == pytest.approx(15.0)
        assert h.min == 0.5 and h.max == 7.0
        assert h.percentile(50) == pytest.approx(2.5)
        assert h.percentile(99) == pytest.approx(7.0)
        assert h.percentile(0) == pytest.approx(0.5)
        assert h.percentile(100) == pytest.approx(7.0)
        assert h.mean == pytest.approx(3.0)
        return ([h.percentile(q) for q in range(0, 101, 5)], h.summary(),
                h.counts)
    on_both(run)


def test_histogram_rejects_bad_buckets():
    def run(t):
        for bad in ((), (2.0, 1.0), (1.0, 1.0)):
            with pytest.raises(ValueError):
                t.Histogram("h", buckets=bad)
        return True
    on_both(run)


def test_registry_labels_types_and_buckets():
    def run(t):
        reg = t.MetricsRegistry()
        reg.counter("reqs_total", status="done").inc(3)
        reg.counter("reqs_total", status="failed").inc()
        assert reg.value("reqs_total") == 4
        assert reg.value("reqs_total", status="done") == 3
        assert reg.counter("reqs_total", status="done") is reg.counter(
            "reqs_total", status="done")
        with pytest.raises(ValueError):
            reg.gauge("reqs_total")
        h1 = reg.histogram("lat", buckets=(1.0, 2.0), status="a")
        h2 = reg.histogram("lat", buckets=(9.0,), status="b")
        assert h1.bounds == h2.bounds == (1.0, 2.0)
        with pytest.raises(ValueError):
            reg.counter("ok_total").inc(-1)
        return reg.snapshot(), reg.to_prometheus()
    on_both(run)


def test_prometheus_exposition_format():
    def run(t):
        reg = t.MetricsRegistry()
        reg.counter("toks_total", help="tokens").inc(7)
        reg.gauge("depth").set(3)
        h = reg.histogram("lat_seconds", buckets=(0.1, 1.0), status="done")
        for v in (0.05, 0.5, 5.0):
            h.observe(v)
        text = reg.to_prometheus()
        lines = text.strip().splitlines()
        for want in ("# HELP toks_total tokens", "# TYPE toks_total counter",
                     "toks_total 7", "depth 3",
                     'lat_seconds_bucket{status="done",le="0.1"} 1',
                     'lat_seconds_bucket{status="done",le="1"} 2',
                     'lat_seconds_bucket{status="done",le="+Inf"} 3',
                     'lat_seconds_count{status="done"} 3'):
            assert want in lines, want
        assert any(l.startswith('lat_seconds_sum{status="done"}')
                   for l in lines)
        return text
    on_both(run)


def test_default_latency_buckets_ascending():
    b = ttel.DEFAULT_LATENCY_BUCKETS
    assert all(x < y for x, y in zip(b, b[1:]))
    assert b == jtel.DEFAULT_LATENCY_BUCKETS


def test_event_schema_enforced():
    def run(t):
        tel = t.Telemetry(clock=t.ManualClock())
        with pytest.raises(ValueError):
            tel.event("submit", request_id=0)
        with pytest.raises(ValueError):
            tel.event("submit", request_id=0, adapter_id="u", extra=1)
        tel.event("submit", request_id=0, adapter_id="u")
        tel.event("custom_event", anything="goes")
        assert len(tel.events) == 2
        return tel.to_jsonl(), dict(t.EVENT_SCHEMA)
    on_both(run)


# ------------------------------------------------------------- engine-driven


@pytest.fixture(scope="module")
def models():
    return Models()


@pytest.fixture(scope="module")
def stores(models):
    """The reference test's 3 adapters, registered one by one."""
    jstore = JStore(JConfig(rho=0.9, ste_steps=0))
    for i in range(3):
        jstore.register(f"u{i}", j_random_lora(models.jparams["lora"],
                                               jax.random.PRNGKey(30 + i)))
    return jstore, bridge_store(jstore)


def ticking(t):
    """A ``ManualClock`` of package ``t`` that moves 1 ms at every read: the
    timestamps then record the order of the engine's clock reads."""
    class Ticking(t.ManualClock):
        def __call__(self):
            return self.advance(1e-3)
    return Ticking()


def _requests(vocab, cls, n=5, seed=7, max_new=3):
    rng = np.random.default_rng(seed)
    return [cls(request_id=rid, adapter_id=f"u{rid % 3}",
                prompt=rng.integers(0, vocab, size=8).astype(np.int32),
                max_new_tokens=max_new)
            for rid in range(n)]


def run_engine(models, stores, pkg, telemetry=None, clock=None, n=5):
    """The reference test's ``_run`` on one package: 5 requests over 3
    adapters, 2 rows, 2 slots, capacity 64."""
    if pkg == "jax":
        eng = JEngine(models.jmodel, models.jparams, stores[0],
                      cache_capacity=64, max_rows=2, hbm_slots=2,
                      telemetry=telemetry, clock=clock)
        eng._prefill, eng._decode, eng._scatter_rows = models.jits(64)
        cls = JRequest
    else:
        eng = MultiLoRAEngine(models.tmodel, models.tparams, stores[1],
                              cache_capacity=64, max_rows=2, hbm_slots=2,
                              telemetry=telemetry, clock=clock)
        cls = Request
    for r in _requests(models.jcfg.vocab, cls, n=n):
        eng.submit(r)
    return eng, eng.run()


@pytest.fixture(scope="module")
def traced(models, stores):
    """One instrumented run per package, each on a ticking clock, and the
    port's ``PLAIN_CALLS`` delta over its run."""
    out = {}
    for pkg, t in PACKAGES.items():
        tel = t.Telemetry(clock=ticking(t))
        before = dict(PLAIN_CALLS)
        try:
            eng, done = run_engine(models, stores, pkg, telemetry=tel)
            mem = eng.memory_stats()               # mirror the pool gauges
        finally:
            tel.uninstall_kernel_counter()
        delta = {k: v - before.get(k, 0) for k, v in PLAIN_CALLS.items()
                 if v != before.get(k, 0)}
        out[pkg] = {"tel": tel, "eng": eng, "done": done, "mem": mem,
                    "plain": delta}
    return out


def without_launch_series(text: str):
    return [l for l in text.splitlines() if "pallas_launches_total" not in l]


GOLDEN_SCHEMA = {
    "submit": {"request_id", "adapter_id"},
    "admit": {"request_id", "adapter_id", "queue_wait_s", "wave", "row"},
    "prefill": {"wave", "rows", "request_ids", "tpad", "dur_s"},
    "decode_step": {"step", "dur_s", "active_rows", "max_rows", "queued"},
    "first_token": {"request_id", "ttft_s"},
    "retire": {"request_id", "adapter_id", "status", "cause", "tokens",
               "e2e_s", "decode_steps"},
}


def test_trace_schema_golden(traced):
    """The event log is the reference's, line for line (timestamps
    included: both engines read their clocks at the same points), and
    every event carries exactly the golden fields in lifecycle order."""
    assert {k: set(v) for k, v in ttel.EVENT_SCHEMA.items()} == GOLDEN_SCHEMA
    tel, jt = traced["torch"]["tel"], traced["jax"]["tel"]
    assert len(traced["torch"]["done"]) == 5
    assert tel.to_jsonl().splitlines() == jt.to_jsonl().splitlines()
    events = [json.loads(l) for l in tel.to_jsonl().splitlines()]
    by_req = {}
    for ev in events:
        name, ts = ev.pop("event"), ev.pop("ts")
        assert isinstance(ts, float) and ts > 0
        assert set(ev) == GOLDEN_SCHEMA[name], (name, sorted(ev))
        if "request_id" in ev:
            by_req.setdefault(ev["request_id"], []).append(name)
    assert set(by_req) == {0, 1, 2, 3, 4}
    for rid, seq in by_req.items():
        assert seq[0] == "submit" and seq[-1] == "retire", (rid, seq)
        assert seq.index("admit") < seq.index("first_token"), (rid, seq)
    for tr in tel.traces.values():
        assert tr.status == "done" and tr.cause == "ok"
        assert tr.tokens == 3 and tr.e2e_s >= 0 and tr.queue_wait_s >= 0
    assert json.loads(json.dumps(tel.chrome_trace())) == \
        json.loads(json.dumps(jt.chrome_trace()))


def test_histograms_under_fake_clock(traced):
    """The three request-latency histograms fill as the reference's do, and
    the engine's ``stats()`` view over the registry equals the
    reference's."""
    tel, eng = traced["torch"]["tel"], traced["torch"]["eng"]
    lat = tel.latency_summary()
    for name in ("serving_ttft_seconds", "serving_e2e_seconds",
                 "serving_queue_wait_seconds"):
        assert lat[name]["count"] == 5, name
        assert lat[name]["p99"] is not None
    assert lat == traced["jax"]["tel"].latency_summary()
    st = eng.stats()
    assert st == traced["jax"]["eng"].stats()
    assert st["submitted"] == 5 and st["tokens"] == 15
    assert st["finished"] == {"done": 5}
    assert st["retire_causes"] == {"ok": 5}
    reg = tel.registry
    assert reg.value("serving_requests_total", status="done") == 5
    assert reg.value("serving_decode_steps_total") == st["decode_steps"]
    assert reg.value("serving_admission_waves_total") == st["admission_waves"]


def test_memory_stats_hit_rate_and_per_pool(models, stores):
    """A manager with no lookups reports ``hit_rate`` None; after traffic a
    real ratio with the per-pool breakdown, equal to the reference's."""
    got = {}
    for pkg in PACKAGES:
        eng, _ = run_engine(models, stores, pkg, n=0)
        assert eng.memory_stats() == {}        # manager not built yet
        fresh = eng.memory.stats()
        assert fresh["lookups"] == 0 and fresh["hit_rate"] is None
        eng, _ = run_engine(models, stores, pkg, n=4)
        st = eng.memory_stats()
        assert st["lookups"] > 0 and 0.0 <= st["hit_rate"] <= 1.0
        assert st["hits"] + st["misses"] == st["lookups"]
        assert st["per_pool"]
        for label, pool in st["per_pool"].items():
            for key in ("hits", "misses", "lookups", "hit_rate",
                        "evictions", "swap_ins", "swap_in_bytes", "capacity",
                        "resident", "pinned", "page_bytes"):
                assert key in pool, (label, key)
            assert pool["lookups"] == pool["hits"] + pool["misses"]
        assert st["swap_in_bytes"] > 0
        assert set(st["prefetch"]) == {"hit", "staged", "failed", "no_slot"}
        got[pkg] = (fresh, st)
    assert got["torch"] == got["jax"]


def test_parity_tokens_and_launches(models, stores):
    """Telemetry only observes: with it the port gives the same tokens and
    exactly the same kernel calls as without, both the reference's
    tokens; and the registry's launch series equals the calls made while
    it was installed, exactly (the port counts per call, the reference
    per trace)."""
    def measured(telemetry):
        before = dict(PLAIN_CALLS)
        _, done = run_engine(models, stores, "torch", telemetry=telemetry)
        delta = {k: v - before.get(k, 0) for k, v in PLAIN_CALLS.items()
                 if v != before.get(k, 0)}
        return {r.request_id: r.output.tolist() for r in done}, delta

    toks_off, calls_off = measured(None)
    tel = ttel.Telemetry(clock=ttel.ManualClock())
    try:
        toks_on, calls_on = measured(tel)
    finally:
        tel.uninstall_kernel_counter()
    assert calls_on == calls_off and calls_on
    assert toks_on == toks_off
    _, jdone = run_engine(models, stores, "jax")
    assert toks_on == {r.request_id: r.output.tolist() for r in jdone}
    mirrored = {dict(m.labels)["kernel"]: m.value
                for m in tel.registry.series("pallas_launches_total")}
    assert mirrored == calls_on
    # uninstalled: later calls are not recorded
    measured(None)
    assert {dict(m.labels)["kernel"]: m.value for m in
            tel.registry.series("pallas_launches_total")} == mirrored


def test_exports_parse_and_are_nonempty(traced, tmp_path):
    """All three exports parse and carry the latency histograms, per-pool
    memory counters and the launch series; the exposition is the
    reference's line for line except the launch series, which is the
    port's ``PLAIN_CALLS`` delta."""
    tel = traced["torch"]["tel"]
    prom, trace, jsonl = (tmp_path / "metrics.prom",
                          tmp_path / "trace.json", tmp_path / "events.jsonl")
    tel.write_prometheus(str(prom))
    tel.write_chrome_trace(str(trace))
    tel.write_jsonl(str(jsonl))

    text = prom.read_text()
    for needle in ("serving_ttft_seconds_bucket", "serving_e2e_seconds_sum",
                   "serving_queue_wait_seconds_count",
                   "adapter_memory_hits_total{pool=",
                   "adapter_memory_swap_ins_total{pool=",
                   "pallas_launches_total{kernel="):
        assert needle in text, needle
    for line in text.strip().splitlines():
        if not line.startswith("#"):
            _, value = line.rsplit(" ", 1)
            float(value)
    assert without_launch_series(text) == without_launch_series(
        traced["jax"]["tel"].to_prometheus())
    plain = traced["torch"]["plain"]
    assert plain == {"sgmv_fused": 2 * 7 * (
        traced["torch"]["eng"]._step_count + traced["torch"]["eng"]._wave)}
    assert {f'pallas_launches_total{{kernel="{k}"}} {v}'
            for k, v in plain.items()} <= set(text.splitlines())

    doc = json.loads(trace.read_text())
    names = {ev.get("name") for ev in doc["traceEvents"]}
    assert {"prefill", "decode_step", "queue", "decode"} <= names
    spans = [ev for ev in doc["traceEvents"] if ev.get("ph") == "X"]
    assert spans and all(ev["dur"] >= 0 and ev["ts"] >= 0 for ev in spans)

    lines = jsonl.read_text().strip().splitlines()
    assert len(lines) == len(tel.events)
    assert all(json.loads(l) for l in lines)


# ------------------------------------------------------------- serve driver


def test_serve_driver_fault_and_telemetry_flags(tmp_path, capsys):
    """The port's serve driver on the CPU with every fault and telemetry
    flag: the storm quarantines user_1, the bounded queue sheds, and the
    three files parse."""
    paths = {k: tmp_path / k for k in ("metrics.prom", "trace.json",
                                       "events.jsonl")}
    done = t_serve.main([
        "--device", "cpu", "--adapters", "3", "--requests", "6",
        "--prompt-len", "8", "--max-new", "3", "--slots", "2",
        "--inject", "storm", "--queue-limit", "4",
        "--queue-policy", "shed_oldest", "--deadline-ms", "600000",
        "--stats-every", "2",
        "--metrics-out", str(paths["metrics.prom"]),
        "--trace-out", str(paths["trace.json"]),
        "--events-out", str(paths["events.jsonl"])])
    out = capsys.readouterr().out
    assert "[serve] quarantined adapters: ['user_1']" in out
    assert "[serve] latency[done]: ttft p50=" in out
    assert "[serve] step 2:" in out
    status = {r.request_id: (r.status.value, r.error and r.error.kind)
              for r in done}
    assert status == {0: ("rejected", "queue_full"),
                      1: ("rejected", "queue_full"),
                      2: ("done", None), 3: ("done", None),
                      4: ("failed", "poisoned_adapter"), 5: ("done", None)}
    lines = paths["metrics.prom"].read_text().strip().splitlines()
    assert 'serving_requests_total{cause="queue_full",status="rejected"} 2' \
        in lines
    for line in lines:
        if not line.startswith("#"):
            float(line.rsplit(" ", 1)[1])
    doc = json.loads(paths["trace.json"].read_text())
    assert any(ev.get("name") == "decode_step" for ev in doc["traceEvents"])
    events = [json.loads(l) for l in
              paths["events.jsonl"].read_text().splitlines()]
    assert sum(ev["event"] == "retire" for ev in events) == 6


def test_no_quant_rejected_by_both_packages():
    """ROADMAP C7: the reference's ``--no-quant`` sets ``bits_high=16``,
    which its quantizer cannot pack, so its driver crashes in the
    quantizer; the port refuses the flag before building anything."""
    with pytest.raises(ValueError, match="unsupported bitwidth 16"):
        j_serve.main(["--adapters", "2", "--requests", "2",
                      "--prompt-len", "8", "--max-new", "2", "--no-quant"])
    with pytest.raises(ValueError, match="C7"):
        t_serve.main(["--device", "cpu", "--no-quant"])
