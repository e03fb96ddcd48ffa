"""Serving telemetry: metrics registry, request traces, exportable profiles
(port of ``repro/serving/telemetry.py``).

The serving stack (engine, paged adapter memory, kernel wrappers) records
into one dependency-free layer:

* :class:`MetricsRegistry` — counters, gauges and **fixed-bucket
  histograms** with p50/p95/p99 estimation. Metrics are identified by
  ``(name, sorted labels)`` like Prometheus series; the registry renders
  the standard text exposition format (:meth:`MetricsRegistry.to_prometheus`).
* :class:`RequestTrace` — one span record per request over its lifecycle:
  submit → queue wait → admission → prefill → per-step decode → terminal
  status. Traces feed a **JSONL event log** (one JSON object per lifecycle
  event, schema ``EVENT_SCHEMA``) and a **Chrome-trace JSON**
  (``chrome://tracing`` / Perfetto) of spans.
* :class:`Telemetry` — the facade the serving layers talk to: it owns the
  registry, the trace table, the event log and the **injectable monotonic
  clock** (:class:`ManualClock` under test, ``time.perf_counter``
  otherwise) that makes every timestamp deterministic in tests.

Every metric and event name is the reference's, so the two packages'
exports compare series for series. One series differs in meaning:
``pallas_launches_total{kernel=...}`` counts every CUDA launch of a kernel
(every plain call on the CPU), where the reference counts one per trace.

Nothing here imports torch, numpy or a serving module. The serving layers
accept ``telemetry=None`` and then skip every hook; instrumentation is
host-side bookkeeping that changes no token and launches no kernel. The
engine reads its clock after the step's one host synchronization, so wall
times on the card include the device work.
"""

from __future__ import annotations

import bisect
import json
import math
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "ManualClock", "MetricsRegistry",
    "RequestTrace", "Telemetry", "DEFAULT_LATENCY_BUCKETS", "EVENT_SCHEMA",
]


# Log-spaced seconds: 100 µs … 2 min: from a fast decode step to a slow
# CPU run's whole request.
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)


class ManualClock:
    """A deterministic monotonic clock for tests and CI-stable benchmarks.

    Calling the instance returns the current virtual time; :meth:`advance`
    moves it forward, and :meth:`sleep` is an alias so the clock can be
    plugged straight into ``HostTransport(sleep=clock.sleep)`` — injected
    fault latency then advances virtual time instead of wall time.
    """

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"clock cannot go backwards (dt={dt})")
        self.t += dt
        return self.t

    # drop-in for time.sleep in transports / fault plans
    def sleep(self, dt: float) -> None:
        self.advance(max(dt, 0.0))


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_labels(items: Tuple[Tuple[str, str], ...], extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in items]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class Counter:
    """Monotonic counter (one labeled series)."""

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name} cannot decrease by {v}")
        self.value += v


class Gauge:
    """Point-in-time value (one labeled series)."""

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Histogram:
    """Fixed-bucket histogram with percentile estimation.

    ``buckets`` are the finite upper bounds (ascending); an implicit +inf
    bucket catches the tail. Percentiles interpolate linearly inside the
    bucket containing the target rank, clamped by the observed min/max —
    exact at the resolution of the bucket grid, O(#buckets) memory, no
    sample retention (the registry stays cheap at millions of requests).
    """

    def __init__(self, name: str,
                 buckets: Iterable[float] = DEFAULT_LATENCY_BUCKETS,
                 labels: Tuple[Tuple[str, str], ...] = ()):
        bs = tuple(float(b) for b in buckets)
        if not bs or any(b2 <= b1 for b1, b2 in zip(bs, bs[1:])):
            raise ValueError(f"histogram {name}: buckets must be ascending "
                             f"and non-empty, got {bs}")
        self.name = name
        self.labels = labels
        self.bounds = bs
        self.counts = [0] * (len(bs) + 1)     # +1: the +inf tail bucket
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def percentile(self, q: float) -> Optional[float]:
        """Estimated q-th percentile (q in [0, 100]); None when empty."""
        if self.count == 0:
            return None
        rank = q / 100.0 * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            lo = self.bounds[i - 1] if i > 0 else (
                self.min if self.min is not None else 0.0)
            hi = self.bounds[i] if i < len(self.bounds) else (
                self.max if self.max is not None else self.bounds[-1])
            if cum + c >= rank:
                frac = (rank - cum) / c
                est = lo + (hi - lo) * max(0.0, min(frac, 1.0))
                return max(self.min, min(est, self.max))
            cum += c
        return self.max

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    def summary(self) -> Dict[str, Optional[float]]:
        return {
            "count": self.count, "sum": self.sum, "mean": self.mean,
            "min": self.min, "max": self.max,
            "p50": self.percentile(50), "p95": self.percentile(95),
            "p99": self.percentile(99),
        }


class MetricsRegistry:
    """Get-or-create registry of labeled metric series.

    ``counter(name, **labels)`` / ``gauge`` / ``histogram`` return the
    existing series for ``(name, labels)`` or create it — callers hold no
    state, metric identity lives here. A ``name`` must keep one type
    across the registry (Prometheus contract).
    """

    def __init__(self):
        self._metrics: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], Any] = {}
        self._types: Dict[str, str] = {}
        self._help: Dict[str, str] = {}
        self._buckets: Dict[str, Tuple[float, ...]] = {}

    def _get(self, kind: str, name: str, labels: Dict[str, str],
             factory: Callable[[], Any]):
        if self._types.setdefault(name, kind) != kind:
            raise ValueError(f"metric {name!r} is a "
                             f"{self._types[name]}, not a {kind}")
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            m = self._metrics[key] = factory()
        return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        if help:
            self._help.setdefault(name, help)
        return self._get("counter", name, labels,
                         lambda: Counter(name, _label_key(labels)))

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        if help:
            self._help.setdefault(name, help)
        return self._get("gauge", name, labels,
                         lambda: Gauge(name, _label_key(labels)))

    def histogram(self, name: str,
                  buckets: Optional[Iterable[float]] = None,
                  help: str = "", **labels) -> Histogram:
        if help:
            self._help.setdefault(name, help)
        # one bucket grid per histogram family: series of one name must
        # aggregate across labels, so the first declaration wins
        if name not in self._buckets:
            self._buckets[name] = tuple(buckets if buckets is not None
                                        else DEFAULT_LATENCY_BUCKETS)
        bs = self._buckets[name]
        return self._get("histogram", name, labels,
                         lambda: Histogram(name, bs, _label_key(labels)))

    # ----- read side -----

    def series(self, name: str) -> List[Any]:
        """Every labeled series registered under ``name``."""
        return [m for (n, _), m in self._metrics.items() if n == name]

    def value(self, name: str, **labels) -> float:
        """Sum of matching counter/gauge values (0.0 when none exist).
        With no labels this is the family total across every series."""
        want = dict(labels)
        total = 0.0
        for m in self.series(name):
            have = dict(m.labels)
            if all(have.get(k) == str(v) for k, v in want.items()):
                total += m.value
        return total

    def snapshot(self) -> Dict[str, Any]:
        """Plain-dict view of every series (the ``stats()`` substrate):
        ``{name: {label_str: value_or_summary}}``; the unlabeled series
        uses the empty-string key."""
        out: Dict[str, Any] = {}
        for (name, labels), m in sorted(self._metrics.items()):
            key = ",".join(f"{k}={v}" for k, v in labels)
            val = m.summary() if isinstance(m, Histogram) else m.value
            out.setdefault(name, {})[key] = val
        return out

    def to_prometheus(self) -> str:
        """Standard Prometheus text exposition (counters get the
        ``_total``-as-written name; histograms emit cumulative ``_bucket``
        series plus ``_sum``/``_count``)."""
        by_name: Dict[str, List[Any]] = {}
        for (name, _), m in sorted(self._metrics.items()):
            by_name.setdefault(name, []).append(m)
        lines: List[str] = []
        for name, series in by_name.items():
            if name in self._help:
                lines.append(f"# HELP {name} {self._help[name]}")
            lines.append(f"# TYPE {name} {self._types[name]}")
            for m in series:
                if isinstance(m, Histogram):
                    cum = 0
                    for bound, c in zip(m.bounds, m.counts):
                        cum += c
                        le = 'le="%g"' % bound
                        lines.append(
                            f"{name}_bucket{_fmt_labels(m.labels, le)} {cum}")
                    inf = 'le="+Inf"'
                    lines.append(
                        f"{name}_bucket{_fmt_labels(m.labels, inf)} "
                        f"{m.count}")
                    lines.append(
                        f"{name}_sum{_fmt_labels(m.labels)} {m.sum:g}")
                    lines.append(
                        f"{name}_count{_fmt_labels(m.labels)} {m.count}")
                else:
                    lines.append(
                        f"{name}{_fmt_labels(m.labels)} {m.value:g}")
        return "\n".join(lines) + "\n"


# JSONL event schema: event name -> exactly these fields (beyond the
# common ``ts``/``event``), the reference's golden contract; extend by
# ADDING events or fields, never renaming.
EVENT_SCHEMA: Dict[str, Tuple[str, ...]] = {
    "submit":      ("request_id", "adapter_id"),
    "admit":       ("request_id", "adapter_id", "queue_wait_s", "wave",
                    "row"),
    "prefill":     ("wave", "rows", "request_ids", "tpad", "dur_s"),
    "decode_step": ("step", "dur_s", "active_rows", "max_rows", "queued"),
    "first_token": ("request_id", "ttft_s"),
    "retire":      ("request_id", "adapter_id", "status", "cause",
                    "tokens", "e2e_s", "decode_steps"),
}


class RequestTrace:
    """Lifecycle span record of one request (all timestamps are the
    telemetry clock's). ``decode_steps`` counts the scheduler steps that
    advanced this request; the static modes count their whole greedy loop
    once per emitted token."""

    __slots__ = ("request_id", "adapter_id", "submit_ts", "admit_ts",
                 "first_token_ts", "end_ts", "status", "cause",
                 "decode_steps", "tokens", "wave", "row")

    def __init__(self, request_id: int, adapter_id: str, submit_ts: float):
        self.request_id = request_id
        self.adapter_id = adapter_id
        self.submit_ts = submit_ts
        self.admit_ts: Optional[float] = None
        self.first_token_ts: Optional[float] = None
        self.end_ts: Optional[float] = None
        self.status: Optional[str] = None
        self.cause: Optional[str] = None
        self.decode_steps = 0
        self.tokens = 0
        self.wave: Optional[int] = None
        self.row: Optional[int] = None

    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.admit_ts is None:
            return None
        return self.admit_ts - self.submit_ts

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_ts is None:
            return None
        return self.first_token_ts - self.submit_ts

    @property
    def e2e_s(self) -> Optional[float]:
        if self.end_ts is None:
            return None
        return self.end_ts - self.submit_ts


class Telemetry:
    """The facade the serving layers record into.

    One instance spans the whole serving stack: the engine, the paged
    adapter memory, and (via :meth:`install_kernel_counter`) the kernel
    wrappers' launch sink all write to ``self.registry``; per-request lifecycle
    lands in ``self.traces`` and the append-only ``self.events`` log.

    Exports:

    * :meth:`to_prometheus` / :meth:`write_prometheus` — metrics text,
    * :meth:`to_jsonl` / :meth:`write_jsonl` — the event log,
    * :meth:`chrome_trace` / :meth:`write_chrome_trace` — a
      ``chrome://tracing`` / Perfetto span profile (request rows show
      queue/decode spans, the scheduler row shows prefill/step spans).
    """

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self.clock = clock if clock is not None else time.perf_counter
        self.registry = MetricsRegistry()
        self.traces: Dict[int, RequestTrace] = {}
        self.events: List[Dict[str, Any]] = []
        self._kernel_sink: Optional[Callable[[str], None]] = None

    def now(self) -> float:
        return self.clock()

    # ----- event log -----

    def event(self, name: str, **fields) -> Dict[str, Any]:
        want = EVENT_SCHEMA.get(name)
        if want is not None and set(fields) != set(want):
            raise ValueError(
                f"event {name!r}: fields {sorted(fields)} != schema "
                f"{sorted(want)}")
        ev = {"ts": self.now(), "event": name, **fields}
        self.events.append(ev)
        return ev

    # ----- lifecycle hooks (called by the engine) -----

    def on_submit(self, request_id: int, adapter_id: str) -> RequestTrace:
        tr = RequestTrace(request_id, adapter_id, self.now())
        self.traces[request_id] = tr
        self.event("submit", request_id=request_id, adapter_id=adapter_id)
        self.registry.counter(
            "serving_requests_submitted_total",
            help="requests accepted into the pending queue").inc()
        return tr

    def on_admit(self, request_id: int, wave: int, row: int) -> None:
        tr = self.traces.get(request_id)
        if tr is None:
            return
        tr.admit_ts = self.now()
        tr.wave, tr.row = wave, row
        wait = tr.queue_wait_s or 0.0
        self.event("admit", request_id=request_id, adapter_id=tr.adapter_id,
                   queue_wait_s=wait, wave=wave, row=row)
        self.registry.histogram(
            "serving_queue_wait_seconds",
            help="submit -> admission wait").observe(wait)

    def on_prefill(self, wave: int, request_ids: List[int], tpad: int,
                   dur_s: float) -> None:
        self.event("prefill", wave=wave, rows=len(request_ids),
                   request_ids=list(request_ids), tpad=tpad, dur_s=dur_s)
        self.registry.counter(
            "serving_admission_waves_total",
            help="admission prefill batches dispatched").inc()
        self.registry.histogram(
            "serving_admission_wave_size",
            buckets=(1, 2, 4, 8, 16, 32, 64),
            help="requests per admission wave").observe(len(request_ids))
        self.registry.histogram(
            "serving_prefill_seconds",
            help="admission prefill dispatch latency").observe(dur_s)

    def on_first_token(self, request_id: int) -> None:
        tr = self.traces.get(request_id)
        if tr is None or tr.first_token_ts is not None:
            return
        tr.first_token_ts = self.now()
        self.event("first_token", request_id=request_id, ttft_s=tr.ttft_s)

    def on_decode_step(self, step: int, dur_s: float, active_rows: int,
                       max_rows: int, queued: int,
                       request_ids: Iterable[int] = ()) -> None:
        self.event("decode_step", step=step, dur_s=dur_s,
                   active_rows=active_rows, max_rows=max_rows, queued=queued)
        self.registry.counter(
            "serving_decode_steps_total",
            help="scheduler decode steps dispatched").inc()
        self.registry.histogram(
            "serving_step_seconds",
            help="scheduler step latency (sweep+admit+decode)"
        ).observe(dur_s)
        self.registry.histogram(
            "serving_batch_occupancy",
            buckets=tuple(range(0, max(max_rows, 1) + 1)),
            help="active rows per decode step").observe(active_rows)
        self.registry.gauge(
            "serving_queue_depth", help="pending requests").set(queued)
        for rid in request_ids:
            tr = self.traces.get(rid)
            if tr is not None:
                tr.decode_steps += 1

    def on_retire(self, request_id: int, status: str, cause: str,
                  tokens: int) -> None:
        tr = self.traces.get(request_id)
        if tr is None:
            return
        tr.end_ts = self.now()
        tr.status, tr.cause, tr.tokens = status, cause, tokens
        self.event("retire", request_id=request_id, adapter_id=tr.adapter_id,
                   status=status, cause=cause, tokens=tokens, e2e_s=tr.e2e_s,
                   decode_steps=tr.decode_steps)
        self.registry.counter(
            "serving_requests_total",
            help="terminal requests by status and cause",
            status=status, cause=cause).inc()
        self.registry.counter(
            "serving_tokens_total",
            help="tokens emitted by terminal requests").inc(tokens)
        self.registry.histogram(
            "serving_e2e_seconds", help="submit -> terminal latency",
            status=status).observe(tr.e2e_s)
        if tr.ttft_s is not None:
            self.registry.histogram(
                "serving_ttft_seconds", help="submit -> first token",
                status=status).observe(tr.ttft_s)

    # ----- kernel launch accounting -----

    def install_kernel_counter(self) -> None:
        """Mirror the kernel wrappers' launch sink into a counter: every
        CUDA launch (every plain call on the CPU) made while installed
        increments ``pallas_launches_total{kernel=...}``, so the series
        equals the ``LAUNCH_COUNTS`` (``PLAIN_CALLS``) delta exactly."""
        if self._kernel_sink is not None:
            return
        from repro_torch.kernels.quant_matmul.kernel import add_launch_sink

        def sink(name: str) -> None:
            self.registry.counter(
                "pallas_launches_total",
                help="kernel launches (CUDA launches on the card, plain "
                     "calls on the CPU)",
                kernel=name).inc()

        self._kernel_sink = sink
        add_launch_sink(sink)

    def uninstall_kernel_counter(self) -> None:
        if self._kernel_sink is None:
            return
        from repro_torch.kernels.quant_matmul.kernel import remove_launch_sink

        remove_launch_sink(self._kernel_sink)
        self._kernel_sink = None

    # ----- exports -----

    def to_prometheus(self) -> str:
        return self.registry.to_prometheus()

    def write_prometheus(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_prometheus())

    def to_jsonl(self) -> str:
        return "\n".join(json.dumps(ev, sort_keys=True)
                         for ev in self.events) + ("\n" if self.events else "")

    def write_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_jsonl())

    def chrome_trace(self) -> Dict[str, Any]:
        """Span profile in the Chrome trace-event format (JSON object with
        ``traceEvents``; open in Perfetto / ``chrome://tracing``).

        pid 1 ("scheduler") carries the engine's prefill and decode-step
        spans on tid 0; pid 2 ("requests") gives each request its own tid
        with a ``queue`` span (submit → admit) and a ``decode`` span
        (admit → terminal) annotated with status/cause/tokens.
        """
        t0 = min((ev["ts"] for ev in self.events), default=0.0)
        for tr in self.traces.values():
            t0 = min(t0, tr.submit_ts)

        def us(t: float) -> float:
            return (t - t0) * 1e6

        evs: List[Dict[str, Any]] = [
            {"ph": "M", "pid": 1, "name": "process_name",
             "args": {"name": "scheduler"}},
            {"ph": "M", "pid": 2, "name": "process_name",
             "args": {"name": "requests"}},
        ]
        for ev in self.events:
            if ev["event"] == "decode_step":
                evs.append({"name": "decode_step", "ph": "X", "pid": 1,
                            "tid": 0, "ts": us(ev["ts"] - ev["dur_s"]),
                            "dur": ev["dur_s"] * 1e6,
                            "args": {"step": ev["step"],
                                     "active_rows": ev["active_rows"],
                                     "queued": ev["queued"]}})
            elif ev["event"] == "prefill":
                evs.append({"name": "prefill", "ph": "X", "pid": 1,
                            "tid": 0, "ts": us(ev["ts"] - ev["dur_s"]),
                            "dur": ev["dur_s"] * 1e6,
                            "args": {"wave": ev["wave"], "rows": ev["rows"],
                                     "tpad": ev["tpad"]}})
        for tr in self.traces.values():
            tid = tr.request_id
            evs.append({"ph": "M", "pid": 2, "tid": tid,
                        "name": "thread_name",
                        "args": {"name": f"req {tr.request_id} "
                                         f"({tr.adapter_id})"}})
            admit = tr.admit_ts if tr.admit_ts is not None else tr.end_ts
            if admit is not None:
                evs.append({"name": "queue", "ph": "X", "pid": 2, "tid": tid,
                            "ts": us(tr.submit_ts),
                            "dur": max(admit - tr.submit_ts, 0.0) * 1e6,
                            "args": {"adapter": tr.adapter_id}})
            if tr.admit_ts is not None and tr.end_ts is not None:
                evs.append({"name": "decode", "ph": "X", "pid": 2,
                            "tid": tid, "ts": us(tr.admit_ts),
                            "dur": (tr.end_ts - tr.admit_ts) * 1e6,
                            "args": {"adapter": tr.adapter_id,
                                     "status": tr.status, "cause": tr.cause,
                                     "tokens": tr.tokens,
                                     "decode_steps": tr.decode_steps}})
            if tr.first_token_ts is not None:
                evs.append({"name": "first_token", "ph": "i", "pid": 2,
                            "tid": tid, "ts": us(tr.first_token_ts),
                            "s": "t"})
        return {"traceEvents": evs, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)

    # ----- summaries -----

    def latency_summary(self) -> Dict[str, Dict[str, Optional[float]]]:
        """``{metric: {p50, p95, p99, mean, count, ...}}`` aggregated
        across label values for the three request-latency histograms."""
        out: Dict[str, Dict[str, Optional[float]]] = {}
        for name in ("serving_ttft_seconds", "serving_e2e_seconds",
                     "serving_queue_wait_seconds"):
            series = self.registry.series(name)
            if not series:
                continue
            agg = Histogram(name, series[0].bounds)
            for h in series:
                agg.counts = [a + b for a, b in zip(agg.counts, h.counts)]
                agg.count += h.count
                agg.sum += h.sum
                for v in (h.min, h.max):
                    if v is not None:
                        agg.min = v if agg.min is None else min(agg.min, v)
                        agg.max = v if agg.max is None else max(agg.max, v)
            out[name] = agg.summary()
        return out
