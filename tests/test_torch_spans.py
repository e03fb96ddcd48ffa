"""The raw span log (``repro_torch.spans``: ``SpanLog``, ``SPANS``,
``profiler_range``) and the spans the port records with it, at the smoke
size of llama3.2-3b, fp32 on the CPU.

The ring keeps order, wraps, counts what it overwrote and cuts a window by
end time; a span costs about a microsecond with the profiler off. A
continuous serve with a ``Telemetry`` records one ``engine.step`` per decode
step whose phases nest inside it and add up to it, and each swap-in's
copies inside its span; without one the engine records none, and
onboarding never does. Under ``torch.profiler`` every raw engine span is
also a host range of the same name, nesting and duration, and the model's
forward is cut into ``model.*`` ranges. No JAX: the golden event log and
exports are held against the reference by ``test_torch_telemetry.py``.
"""

import dataclasses
import time
import timeit

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import LoRAQuantConfig
from repro_torch.launch.serve import random_trained_lora
from repro_torch.models import build_model
from repro_torch.serving import (AdapterStore, ManualClock, MultiLoRAEngine,
                                 Request, Telemetry)
from repro_torch.serving.telemetry import SPANS, Span, SpanLog
from repro_torch.spans import profiler_range

PHASES = ("engine.sweep", "engine.admit", "engine.decode.prep",
          "engine.decode.launch", "engine.decode.sync", "engine.retire")
N_REQUESTS = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------------------ the ring


def _fill(log, name, ends):
    for k, e in enumerate(ends):
        log.add(name, e - 5, e, k)


def test_ring_keeps_end_order_and_cuts_a_window():
    log = SpanLog(capacity=8)
    a, b = log.name_id("a"), log.name_id("b")
    assert log.name_id("a") == a != b
    _fill(log, a, [100, 200, 300])
    log.add(b, 150, 400, 9)
    assert log.overflow == 0
    got = log.between(150e-9, 300e-9)
    assert got == [Span("a", 195, 200, 1), Span("a", 295, 300, 2)]
    assert log.between(0.0, 1.0) == [Span("a", 95, 100, 0),
                                     Span("a", 195, 200, 1),
                                     Span("a", 295, 300, 2),
                                     Span("b", 150, 400, 9)]
    assert log.between(401e-9, 1.0) == []


def test_ring_wraps_and_counts_what_it_overwrote():
    log = SpanLog(capacity=4)
    a = log.name_id("a")
    _fill(log, a, [10, 20, 30, 40, 50, 60])
    assert log.overflow == 2
    # records ending at 10 and 20 are gone: a window that could hold
    # them is refused, one after them is whole
    assert log.between(0.0, 1.0) is None
    assert log.between(25e-9, 1.0) is None
    assert [s.end for s in log.between(31e-9, 1.0)] == [40, 50, 60]
    assert [s.arg for s in log.between(31e-9, 55e-9)] == [3, 4]
    log.reset()
    assert log.overflow == 0 and log.between(0.0, 1.0) == []
    _fill(log, a, [70])
    assert log.between(0.0, 1.0) == [Span("a", 65, 70, 0)]


def test_ring_capacity_is_a_power_of_two_and_the_default_holds_2_18():
    with pytest.raises(ValueError):
        SpanLog(capacity=6)
    assert SPANS.capacity >= 1 << 18
    assert Telemetry().spans is SPANS


def test_a_span_costs_a_microsecond_or_less_with_the_profiler_off():
    log = SpanLog()
    name = log.name_id("x")

    def span():
        t = log.begin(name)
        log.end(name, t, 1)

    # the best of many short batches: the span's own cost, not the time
    # slices other processes took from a batch
    n = 500
    best = min(timeit.repeat(span, number=n, repeat=200)) / n
    assert not torch.autograd.profiler._is_profiler_enabled
    assert best <= 1.0e-6, f"{best * 1e6:.3f} us per span"
    assert log._open == []


def test_a_profiler_range_is_a_record_function_only_while_it_records():
    off = profiler_range("t.off")
    assert not isinstance(off, torch.autograd.profiler.record_function)
    assert off is profiler_range("t.other")
    with off:
        pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        on = profiler_range("t.on")
        assert isinstance(on, torch.autograd.profiler.record_function)
        with on:
            torch.ones(4).sum()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("t.on") == 1 and "t.off" not in names


def test_spans_are_profiler_ranges_only_while_it_records():
    log = SpanLog()
    outer, inner = log.name_id("t.outer"), log.name_id("t.inner")
    t = log.begin(outer)
    log.end(outer, t, 0)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        t0 = log.begin(outer)
        t1 = log.begin(inner)
        torch.ones(4).sum()
        log.end(inner, t1, 2)
        # a span whose code raised leaves its range open: the enclosing
        # span's end closes it too
        log.begin(inner)
        log.end(outer, t0, 1)
    assert log._open == []
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.name().startswith("t.")]
    assert sorted(names) == ["t.inner", "t.inner", "t.outer"]
    assert [s.name for s in log.between(0.0, time.perf_counter())] == [
        "t.outer", "t.inner", "t.outer"]


# --------------------------------------------------------- the engine's spans


@pytest.fixture(scope="module")
def served():
    """A smoke model and three adapters quantized by the port (the spans
    that ended while they onboarded kept), paged through two device
    slots."""
    cfg = dataclasses.replace(get_config("llama3.2-3b", "smoke"),
                              dtype=torch.float32)
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    store = AdapterStore(LoRAQuantConfig(rho=0.9, ste_steps=4))
    gen = torch.Generator().manual_seed(3)
    ups = {f"u{i}": random_trained_lora(params["lora"], gen, scale=0.05)
           for i in range(3)}
    t0 = time.perf_counter()
    store.register_many(ups)
    onboard = SPANS.between(t0, time.perf_counter())
    return cfg, model, params, store, onboard


def _serve(served, telemetry, profile=False, spans=True):
    """A continuous serve of ``N_REQUESTS`` over two slots: ``(outputs,
    raw spans of the run, profile or None)``. ``spans=False``: the engine
    and its memory record none, the telemetry all the rest."""
    cfg, model, params, store, _ = served
    eng = MultiLoRAEngine(model, params, store, cache_capacity=48,
                          max_rows=3, hbm_slots=2, telemetry=telemetry)
    if not spans:
        eng._spans = eng.memory._spans = None
    g = np.random.default_rng(11)
    for rid in range(N_REQUESTS):
        eng.submit(Request(request_id=rid, adapter_id=f"u{rid % 3}",
                           prompt=g.integers(0, cfg.vocab, size=5 + 2 * rid
                                             ).astype(np.int32),
                           max_new_tokens=3 + rid % 3))
    prof = None
    t0 = time.perf_counter()
    if profile:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            done = eng.run()
    else:
        done = eng.run()
    spans = SPANS.between(t0, time.perf_counter())
    return {r.request_id: r.output.tolist() for r in done}, spans, prof


@pytest.fixture(scope="module")
def traced(served):
    tel = Telemetry()
    out, spans, _ = _serve(served, tel)
    return tel, out, spans


def _by_step(spans):
    steps = {}
    for s in spans:
        if s.name.startswith("engine.") and s.name not in (
                "engine.admit.select", "engine.prefill", "engine.cache_copy",
                "engine.decode.view"):
            steps.setdefault(s.arg, []).append(s)
    return steps


def _inside(inner, outer):
    return outer.start <= inner.start and inner.end <= outer.end


def test_every_decode_step_has_one_step_span_whose_phases_sum_to_it(traced):
    tel, _, spans = traced
    decodes = [e["step"] for e in tel.events if e["event"] == "decode_step"]
    assert decodes == list(range(1, len(decodes) + 1))
    steps = _by_step(spans)
    for n in decodes:
        mine = steps[n]
        launch = [s for s in mine if s.name == "engine.decode.launch"]
        assert len(launch) == 1
        step = [s for s in mine if s.name == "engine.step"
                and _inside(launch[0], s)]
        assert len(step) == 1
        phases = [s for s in mine if _inside(s, step[0])
                  and s.name != "engine.step"]
        assert sorted(s.name for s in phases) == sorted(PHASES)
        # in order, not overlapping
        ordered = sorted(phases, key=lambda s: s.start)
        assert [s.name for s in ordered] == list(PHASES)
        assert all(a.end <= b.start for a, b in zip(ordered, ordered[1:]))
        total = sum(s.end - s.start for s in phases)
        dur = step[0].end - step[0].start
        assert abs(dur - total) <= 0.05 * dur, (n, dur, total)


def test_admission_spans_carry_their_wave_and_nest_in_the_admit_phase(traced):
    tel, _, spans = traced
    waves = [e["wave"] for e in tel.events if e["event"] == "prefill"]
    pre = [s for s in spans if s.name == "engine.prefill"]
    copies = [s for s in spans if s.name == "engine.cache_copy"]
    assert [s.arg for s in pre] == waves == [s.arg for s in copies]
    admits = [s for s in spans if s.name == "engine.admit"]
    selects = [s for s in spans if s.name == "engine.admit.select"]
    for s in pre + copies + selects:
        assert sum(_inside(s, a) for a in admits) == 1, s
    for p, c in zip(pre, copies):
        assert p.end <= c.start
    # every wave was selected by a select span carrying its number
    assert set(waves) <= {s.arg for s in selects}


def test_swap_ins_are_spans_with_their_copies_timed_inside(traced):
    tel, _, spans = traced
    swaps = [s for s in spans if s.name == "memory.swap_in"]
    n = tel.registry.value("adapter_memory_swap_ins_total")
    assert n >= 3 and len(swaps) == n
    assert all(s.arg > 0 for s in swaps)
    # on the CPU the copies run as they are called, timed on the host
    copies = [s for s in spans if s.name == "memory.page_copy"]
    assert len(copies) == n
    for c, s in zip(copies, swaps):
        assert _inside(c, s) and c.arg == s.arg


def test_without_a_telemetry_the_engine_records_no_span(served, traced):
    _, want, _ = traced
    got, spans, _ = _serve(served, None)
    assert got == want
    assert not [s for s in spans if s.name.startswith(("engine.",
                                                       "memory."))]


def test_spans_leave_the_event_log_on_a_ticking_clock_as_it_was(served):
    """On a clock that ticks at every read each timestamp counts the
    engine's reads before it: a span that read the clock, or logged an
    event, would change the log. Spans switched off give the same log."""
    logs = []
    for spans in (True, False):
        clock = ManualClock()
        tel = Telemetry(clock=lambda: clock.advance(1.0))
        _serve(served, tel, spans=spans)
        logs.append((tel.to_jsonl(), tel.chrome_trace(), tel.to_prometheus()))
    assert logs[0] == logs[1]


def test_onboarding_records_no_span(served):
    *_, onboard = served
    assert onboard == []


# ------------------------------------------------------------ under a profile


def _kineto_ranges(prof, prefix):
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith(prefix)), key=lambda r: r[1])


def test_each_raw_engine_span_is_a_profiler_range_of_its_name(served,
                                                              traced):
    _, want, _ = traced
    got, spans, prof = _serve(served, Telemetry(), profile=True)
    assert got == want
    raw = [s for s in spans if s.name.startswith("engine.")]
    host = _kineto_ranges(prof, "engine.")
    assert sorted(s.name for s in raw) == sorted(h[0] for h in host)
    raw = sorted(raw, key=lambda s: s.start)
    # the ranges open in the raw spans' order, last the same and nest the
    # same way
    assert [s.name for s in raw] == [h[0] for h in host]
    for s, h in zip(raw, host):
        dur, kin = s.end - s.start, h[2] - h[1]
        assert abs(kin - dur) <= 0.1 * dur + 50_000, (s.name, dur, kin)
    for i, s in enumerate(raw):
        for j, t in enumerate(raw):
            if i != j and _inside(s, t):
                assert host[j][1] <= host[i][1] and host[i][2] <= host[j][2]


def test_the_forward_is_cut_into_model_ranges_under_a_profile(served):
    cfg, model, params, _, _ = served
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model.prefill(params, {"tokens": tokens}, 8)
    ranges = _kineto_ranges(prof, "model.")
    names = [r[0] for r in ranges]
    layers = cfg.n_layers
    assert names.count("model.embed") == 1
    assert names.count("model.logits") == 1
    assert names.count("model.layer") == layers
    assert names.count("model.attn") == layers
    assert names.count("model.ffn") == layers
    # every LoRA linear of every layer
    assert names.count("model.lora") == layers * 7
    # a layer's mixer, FFN and LoRA linears run inside its range
    spans = [r for r in ranges if r[0] == "model.layer"]
    for name, s, e in ranges:
        if name in ("model.attn", "model.ffn", "model.lora"):
            assert sum(a <= s and e <= b for _, a, b in spans) == 1
