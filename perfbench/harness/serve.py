"""One run of one cell: set-up, the open or backlog loop, the window.

The harness builds what ``repro_torch.launch.serve`` builds, onboards the
fleet through ``AdapterStore.register_many``, warms the cell's shapes up,
ramps the traffic until the rows are full, and then measures for
``seconds``. Arrivals are submitted at the step boundary at which they are
due; each keeps its due time, from which its time to first token is taken.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import inputs, program, traffic
from .record import Recorder
from .stats import Window, percentile

WARM_ID = 1 << 40             # request ids of the warm-up requests
STRETCH_S = 1.5               # profiled stretch after a traced window


def log(msg: str):
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class Outcome:
    """What a run leaves for the metric readers and the check."""
    cfg: Dict[str, Any]
    mix: Dict[str, Any]
    seed: int
    setup_s: float
    window: Window
    due: Dict[int, float]
    prompt_len: Dict[int, int]
    adapter_of: Dict[int, int]
    memory: Dict[str, float]            # the paged memory's window deltas
    onboard_s: float
    adapters: int
    memory_peak_bytes: int
    trace: Optional[dict] = None
    stretch: Optional[List[Any]] = None  # forwards of the profiled stretch
    entry_h: Optional[Dict[int, Dict[str, List[int]]]] = None
    attempted: int = 0
    failed: int = 0


class CellRun:
    def __init__(self, cfg, mix, seed: int, seconds: float, trace: bool,
                 device, t_process: float):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.seconds, self.trace = float(seconds), trace
        self.device = torch.device(device)
        self.t_process = t_process
        self.cuda = self.device.type == "cuda"
        self.moe = bool(cfg.get("num_local_experts"))
        self.gen = traffic.Generator(mix, cfg["vocab_size"], seed)
        self.requests: Dict[int, Any] = {}       # id -> Request
        self.due: Dict[int, float] = {}
        self.lateness: List[float] = []
        self.done: List[Any] = []
        self.prof = None
        self.stretch_end = None

    # ----- set-up -----

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def setup(self):
        self.build()
        self.onboard()
        self.start_engine()

    def build(self):
        cfg = self.cfg
        t = time.perf_counter()
        self.model, self.params = program.build(cfg, self.seed, self.device)
        self._sync()
        log(f"weights drawn in {time.perf_counter() - t:.2f} s")
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)

    def onboard(self):
        cfg, fleet = self.cfg, self.mix["fleet"]
        self.store = program.make_store(fleet["recipe"])
        n, chunk = int(fleet["adapters"]), int(fleet.get("onboard_chunk", 8))
        self.onboard_s = 0.0
        for lo in range(0, n, chunk):
            ups = {f"a{i}": inputs.nest(inputs.adapter_factors(
                cfg, self.seed, i, self.device))
                for i in range(lo, min(n, lo + chunk))}
            self._sync()
            t = time.perf_counter()
            self.store.register_many(ups)
            self._sync()
            self.onboard_s += time.perf_counter() - t
            del ups
        self.adapters = n
        log(f"{n} adapters quantized in {self.onboard_s:.2f} s")
        if self.cuda:
            # memory_peak_bytes is serving's: onboarding is over, and its
            # working set goes back to the device before the engine starts
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)

    def start_engine(self, warm: bool = True):
        self.engine, self.telemetry = program.make_engine(
            self.model, self.params, self.store, self.mix["engine"])
        self.rec = Recorder(self.engine, self.telemetry, self.moe,
                            self._watched)
        self.rec.install()
        if warm:
            t = time.perf_counter()
            self._warm()
            log(f"warm-up took {time.perf_counter() - t:.2f} s")

    def _warm(self):
        """Every adapter's host page built, prompts spread over the mix's
        lengths (the clip included) prefilled once, a few decode steps."""
        mem = self.engine.memory
        for i in range(self.adapters):
            mem.acquire(f"a{i}", pin=False)
        plen = self.gen.warm_lengths("prompt_tokens")
        rows = int(self.mix["engine"]["max_rows"])
        for j, p in enumerate(plen[:rows]):
            self.engine.submit(program.Request(
                request_id=WARM_ID + j, adapter_id=f"a{j % self.adapters}",
                prompt=np.zeros(int(p), np.int32), max_new_tokens=4))
        self.engine.run()
        self._sync()

    # ----- the loop -----

    def _submit(self, i: int, due: float):
        d = self.gen.get(i)
        req = program.Request(request_id=i, adapter_id=f"a{d.adapter}",
                              prompt=d.prompt, max_new_tokens=d.max_new)
        self.requests[i] = req
        self.due[i] = due
        self.lateness.append(time.perf_counter() - due)
        self.engine.submit(req)

    def _watched(self, rid: int) -> bool:
        """Whether the check may sample request ``rid``: drawn from the
        seed and the request's number when it is admitted."""
        if rid >= WARM_ID:
            return False
        u = np.random.default_rng([self.seed, 0xC4EC, rid]).random()
        return u < self.mix["check"]["candidate_share"]

    def _step(self):
        self.done.extend(self.engine.step())

    def loop(self):
        """The ramp, then the window; with ``trace`` a profiled stretch of
        the same traffic right after the window's close."""
        self.t0 = time.perf_counter()
        self.nxt = 0
        self._run_until(self.t0 + float(self.mix["ramp_s"]))
        self.t_w0 = time.perf_counter()
        self.mem0 = dict(self.engine.memory_stats())
        self.setup_s = self.t_w0 - self.t_process
        self._run_until(self.t_w0 + self.seconds)
        self._sync()
        self.t_close = time.perf_counter()
        self.mem1 = dict(self.engine.memory_stats())
        self.peak = (torch.cuda.max_memory_allocated(self.device)
                     if self.cuda else 0)
        if self.trace:
            self._start_stretch()
            self._run_until(time.perf_counter() + STRETCH_S)
            self._stop_stretch()

    def _run_until(self, t_end: float):
        """Submit what is due at each step boundary and step the engine
        until ``t_end``."""
        eng = self.engine
        backlog = self.mix["arrival"]["process"] == "backlog"
        depth = int(self.mix["arrival"].get("depth", 0))
        while True:
            now = time.perf_counter()
            if now >= t_end:
                return
            with self._range("bench.submit"):
                if backlog:
                    while len(eng.pending) < depth:
                        self._submit(self.nxt, time.perf_counter())
                        self.nxt += 1
                else:
                    while self.gen.get(self.nxt).offset_s + self.t0 <= now:
                        self._submit(self.nxt,
                                     self.gen.get(self.nxt).offset_s
                                     + self.t0)
                        self.nxt += 1
            if not eng.pending and not eng.active_rows:
                wake = min(self.gen.get(self.nxt).offset_s + self.t0, t_end)
                time.sleep(max(0.0, wake - time.perf_counter()))
                continue
            with self._range("bench.step"):
                self._step()

    # ----- the profiled stretch -----

    def _range(self, name):
        if self.prof is None or self.stretch_end is not None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def _start_stretch(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self.rec.route_all = True
        self.stretch_first = len(self.rec.forwards)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._frame = torch.profiler.record_function("bench.stretch")
        self._frame.__enter__()
        self._sync()
        self.stretch_end = None

    def _stop_stretch(self):
        self._sync()
        self._frame.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.stretch_end = len(self.rec.forwards)
        self.rec.route_all = False

    # ----- after the window -----

    def finished_in_window(self) -> List[Any]:
        """Watched requests served wholly inside the window: the first
        token at or after its start, retired by its close."""
        first, retired = {}, {}
        for e in self.telemetry.events:
            if e["event"] == "first_token":
                first[e["request_id"]] = e["ts"]
            elif e["event"] == "retire":
                retired[e["request_id"]] = e["ts"]
        return [r for r in self.done
                if r.request_id in self.rec.watch
                and r.status.name == "DONE"
                and self.t_w0 <= first.get(r.request_id, -1.0)
                and retired.get(r.request_id, math.inf) <= self.t_close]

    def outcome(self) -> Outcome:
        prompt_len = {i: len(r.prompt) for i, r in self.requests.items()}
        win = Window(self.telemetry.events, self.rec.forwards, self.t_w0,
                     self.t_close, prompt_len)
        mem = {k: self.mem1.get(k, 0) - self.mem0.get(k, 0)
               for k in ("hits", "misses", "lookups", "swap_ins",
                         "swap_in_bytes", "evictions")}
        due_in = [i for i, t in self.due.items() if win.t0 <= t < win.t1]
        status = {r.request_id: r.status.name for r in self.done}
        out = Outcome(
            cfg=self.cfg, mix=self.mix, seed=self.seed, setup_s=self.setup_s,
            window=win, due=self.due, prompt_len=prompt_len,
            adapter_of={i: int(r.adapter_id[1:])
                        for i, r in self.requests.items()},
            memory=mem, onboard_s=self.onboard_s, adapters=self.adapters,
            memory_peak_bytes=int(self.peak),
            attempted=len(due_in),
            failed=sum(1 for i in due_in
                       if status.get(i, "DONE") not in ("DONE",)))
        if self.prof is not None:
            from . import trace

            out.trace = trace.read(self.prof)
            self.rec.routing_to_host()
            out.stretch = self.rec.forwards[self.stretch_first:
                                            self.stretch_end]
            served = {out.adapter_of.get(rid, -1) for f in out.stretch
                      for rid in _rids(f)}
            out.entry_h = {a: self._entry_h(a) for a in served if a >= 0}
        return out

    def _entry_h(self, a: int) -> Dict[str, List[int]]:
        qa = self.store.quantized[f"a{a}"]
        names = {path: name for path, name, *_ in inputs.linears(self.cfg)}
        return {names[p]: [q.h for q in qs] for p, qs in qa.entries.items()}

    def release(self):
        """Drop the program's state before the reference runs."""
        self.rec.uninstall()
        self.telemetry.uninstall_kernel_counter()
        self.rec.engine = self.rec.telemetry = None
        for name in ("engine", "telemetry", "store", "model", "params",
                     "prof"):
            setattr(self, name, None)
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()


def _rids(fwd) -> List[int]:
    return [r[0] for r in fwd.rows] if fwd.kind == "prefill" else [
        r[1] for r in fwd.rows]


def lateness_line(lateness: List[float]) -> str:
    ms = [x * 1e3 for x in lateness]
    return (f"generator lateness: p50 {percentile(ms, 50)} ms, p95 "
            f"{percentile(ms, 95)} ms, max {max(ms) if ms else None} ms "
            f"over {len(ms)} submits")
