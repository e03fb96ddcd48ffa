"""Failure contract and fault-injection harness of multi-LoRA serving
(port of ``repro/serving/faults.py``).

* :class:`RequestStatus` — the request lifecycle: every request ends in
  exactly one terminal state (DONE / REJECTED / TIMED_OUT / FAILED) and
  carries the tokens it produced so far, and, unless DONE, a structured
  :class:`RequestError` (:class:`UnknownAdapter`, :class:`PoisonedAdapter`,
  :class:`DeadlineExceeded`, :class:`QueueFull`, :class:`MemoryExhausted`).
* :class:`AdapterValidationError` — onboarding screen failures (NaN/Inf
  weights, rank-mismatched factors, injected upload errors).
* :class:`HostTransport` — the host tier's page-read path with a timeout,
  bounded exponential-backoff retry and fault injection; without a
  :class:`FaultPlan` a straight pass-through.
* :class:`FaultPlan` — seeded, **deterministic** injection of host-read
  latency, transient and permanent read failures, page corruption and
  onboarding errors. Every draw comes from an RNG keyed by ``(seed,
  adapter_id, op, event_index)`` through numpy, as in the reference, so
  the same plan and call sequence inject exactly the reference's faults.

Nothing here imports the engine or the memory manager at module level:
both import this module.
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import time
from typing import Callable, Dict, FrozenSet, Optional, Tuple

import numpy as np
import torch


class RequestStatus(str, enum.Enum):
    """PENDING → RUNNING → DONE is the happy path; REJECTED (never ran),
    TIMED_OUT and FAILED are the terminal failure states. Terminal requests
    always carry ``output`` (possibly empty) and, except DONE, an error."""

    PENDING = "pending"
    RUNNING = "running"
    DONE = "done"
    REJECTED = "rejected"
    TIMED_OUT = "timed_out"
    FAILED = "failed"

    @property
    def terminal(self) -> bool:
        return self not in (RequestStatus.PENDING, RequestStatus.RUNNING)


class RequestError(Exception):
    """Base of the structured per-request error taxonomy; ``kind`` is the
    stable machine-readable tag."""

    kind = "error"

    def __init__(self, message: str, adapter_id: Optional[str] = None):
        super().__init__(message)
        self.adapter_id = adapter_id


class UnknownAdapter(RequestError):
    """The request names an adapter id that is not (or no longer)
    registered in the AdapterStore."""

    kind = "unknown_adapter"


class PoisonedAdapter(RequestError):
    """The adapter's codes failed an integrity check (NaN/Inf scales). The
    adapter is quarantined; its requests fail without touching co-batched
    healthy rows."""

    kind = "poisoned_adapter"


class DeadlineExceeded(RequestError):
    """The request's wall-clock budget (TTFT or total) expired, while
    queued (no tokens) or mid-decode (partial output is kept)."""

    kind = "deadline_exceeded"


class QueueFull(RequestError):
    """Backpressure: the bounded pending queue was full at submit time
    (``reject`` rejects the new arrival, ``shed_oldest`` the oldest queued
    request instead)."""

    kind = "queue_full"


class MemoryExhausted(RequestError):
    """The paged adapter memory could not produce a usable page: every slot
    pinned with no prospect of progress, or the host tier failed with no
    stale resident page to fall back to."""

    kind = "memory_exhausted"


class HostReadError(Exception):
    """A host-tier page read failed after its retry budget. Internal to the
    memory layer; the engine surfaces it as :class:`MemoryExhausted`."""

    def __init__(self, adapter_id: str, attempts: int, cause: str = ""):
        super().__init__(
            f"host-tier read for adapter {adapter_id!r} failed after "
            f"{attempts} attempt(s){': ' + cause if cause else ''}")
        self.adapter_id = adapter_id
        self.attempts = attempts


def _stable_rng(seed: int, *key) -> np.random.Generator:
    """An RNG keyed by (seed, *key), stable across processes (md5, not
    Python's salted ``hash``), so fault plans replay identically."""
    digest = hashlib.md5(
        ("|".join(str(k) for k in (seed,) + key)).encode()).digest()
    return np.random.default_rng(int.from_bytes(digest[:8], "little"))


@dataclasses.dataclass
class FaultPlan:
    """Seeded deterministic fault injection for the serving stack. Every
    knob defaults to "no faults".

    Host-read faults (drawn by :class:`HostTransport` per *attempt*):

    * ``read_latency_s`` with probability ``read_latency_prob``: an
      injected sleep before the read (slower than the transport's
      ``timeout_s``: a failed attempt).
    * ``transient_fail_prob``: each attempt fails independently; retries
      draw again.
    * ``fail_adapters``: these ids fail every attempt.
    * ``fail_reads_from``: id → k: the id's k-th and later read events
      fail (a host copy that goes bad mid-serve).

    ``corrupt_adapters``: these ids' pages come back with NaN scales (the
    memory layer applies it after a successful read). ``onboard_fail``:
    registering these ids raises :class:`AdapterValidationError`.

    Draws are keyed by ``(seed, adapter_id, op, event_index)``, with
    ``event_index`` a per-(id, op) call counter.
    """

    seed: int = 0
    read_latency_s: float = 0.0
    read_latency_prob: float = 0.0
    transient_fail_prob: float = 0.0
    fail_adapters: FrozenSet[str] = frozenset()
    fail_reads_from: Optional[Dict[str, int]] = None
    corrupt_adapters: FrozenSet[str] = frozenset()
    onboard_fail: FrozenSet[str] = frozenset()

    def __post_init__(self):
        self.fail_adapters = frozenset(self.fail_adapters)
        self.corrupt_adapters = frozenset(self.corrupt_adapters)
        self.onboard_fail = frozenset(self.onboard_fail)
        self._counters: Dict[Tuple[str, str], int] = {}
        self.injected: Dict[str, int] = {}     # op -> injected events

    def _event(self, adapter_id: str, op: str) -> int:
        n = self._counters.get((adapter_id, op), 0)
        self._counters[(adapter_id, op)] = n + 1
        return n

    def _note(self, op: str):
        self.injected[op] = self.injected.get(op, 0) + 1

    def host_read(self, adapter_id: str, attempt: int) -> Tuple[bool, float]:
        """Outcome of one read attempt: ``(ok, injected_latency_s)``,
        called by the transport once per attempt (retries included)."""
        event = self._event(adapter_id, "read")
        latency = 0.0
        if self.read_latency_prob > 0.0:
            rng = _stable_rng(self.seed, adapter_id, "latency", event)
            if rng.random() < self.read_latency_prob:
                latency = self.read_latency_s
                self._note("read_latency")
        if adapter_id in self.fail_adapters:
            self._note("read_fail_permanent")
            return False, latency
        start = (self.fail_reads_from or {}).get(adapter_id)
        if start is not None and event >= start:
            self._note("read_fail_permanent")
            return False, latency
        if self.transient_fail_prob > 0.0:
            rng = _stable_rng(self.seed, adapter_id, "transient", event,
                              attempt)
            if rng.random() < self.transient_fail_prob:
                self._note("read_fail_transient")
                return False, latency
        return True, latency

    def corrupt_page(self, adapter_id: str, arrays):
        """For ids in ``corrupt_adapters``, a copy of the just-read host
        page ``{path: {field: tensor}}`` whose first float field per path
        has a NaN first element; ``arrays`` itself otherwise. The page is
        never modified in place."""
        if adapter_id not in self.corrupt_adapters:
            return arrays
        self._note("page_corruption")
        out = {}
        for path, fields in arrays.items():
            out[path] = dict(fields)
            for name, arr in fields.items():
                if arr.is_floating_point():
                    bad = arr.clone()
                    bad.view(-1)[0] = float("nan")
                    out[path][name] = bad
                    break                      # one NaN per path is plenty
        return out

    def check_onboard(self, adapter_id: str):
        """Raise the injected onboarding error for ids in ``onboard_fail``
        (called by ``AdapterStore.register``)."""
        if adapter_id in self.onboard_fail:
            self._note("onboard_fail")
            raise AdapterValidationError(
                f"injected onboarding failure for adapter {adapter_id!r}")

    def stats(self) -> Dict[str, int]:
        """Injected events by op (``read_latency``, ``read_fail_transient``,
        ``read_fail_permanent``, ``page_corruption``, ``onboard_fail``)."""
        return dict(self.injected)


def named_plan(name: str, **overrides) -> Optional[FaultPlan]:
    """The named fault plans of ``launch/serve.py --inject`` and the chaos
    storm; ``none`` → ``None`` (no injection layer at all)."""
    presets: Dict[str, dict] = {
        "none": None,
        "latency": dict(read_latency_s=0.005, read_latency_prob=0.5),
        "transient": dict(transient_fail_prob=0.4),
        "poison": dict(corrupt_adapters=frozenset({"user_1"})),
        "storm": dict(read_latency_s=0.003, read_latency_prob=0.3,
                      transient_fail_prob=0.3,
                      corrupt_adapters=frozenset({"user_1"})),
    }
    if name not in presets:
        raise ValueError(f"unknown fault plan {name!r}; "
                         f"choose from {sorted(presets)}")
    if presets[name] is None:
        return None
    return FaultPlan(**{**presets[name], **overrides})


class HostTransport:
    """The host tier's page-read path: timeout and bounded
    exponential-backoff retry around the memory manager's page builder,
    with :class:`FaultPlan` injection. The memory manager only calls
    :meth:`read`, so a subclass can back the host tier with another store.

    With ``faults=None`` a read is exactly one ``builder()`` call. Real
    exceptions raised by the builder propagate at once (they are bugs, not
    transport weather); only injected faults consume the retry budget.
    ``sleep`` takes the injected latency and backoff (a
    ``ManualClock.sleep`` makes them virtual time)."""

    def __init__(self, faults: Optional[FaultPlan] = None,
                 timeout_s: float = 0.25, max_retries: int = 3,
                 backoff_s: float = 1e-3, backoff_mult: float = 2.0,
                 sleep: Callable[[float], None] = time.sleep):
        self.faults = faults
        self.timeout_s = timeout_s
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.backoff_mult = backoff_mult
        self.sleep = sleep
        self.reads = 0
        self.retries = 0
        self.timeouts = 0
        self.failures = 0

    def read(self, adapter_id: str, builder):
        """Return ``builder()`` under the retry / timeout policy; raise
        :class:`HostReadError` once the retry budget is spent."""
        self.reads += 1
        if self.faults is None:
            return builder()
        delay = self.backoff_s
        cause = ""
        for attempt in range(self.max_retries + 1):
            ok, latency = self.faults.host_read(adapter_id, attempt)
            if latency > 0.0:
                if latency > self.timeout_s:
                    ok, cause = False, "timeout"
                    self.timeouts += 1
                else:
                    self.sleep(latency)
            if ok:
                return builder()
            if attempt < self.max_retries:
                self.retries += 1
                self.sleep(delay)
                delay *= self.backoff_mult
        self.failures += 1
        raise HostReadError(adapter_id, self.max_retries + 1, cause)

    def stats(self) -> Dict[str, int]:
        return {"reads": self.reads, "retries": self.retries,
                "timeouts": self.timeouts, "failures": self.failures}


def page_arrays_finite(arrays) -> bool:
    """Integrity check of a host page's ``{path: {field: tensor}}``: every
    float field (scales) must be finite. Integer code words cannot encode
    NaN, so the float side-channel is where poison shows."""
    for fields in arrays.values():
        for arr in fields.values():
            if arr.is_floating_point() and not bool(torch.isfinite(arr).all()):
                return False
    return True


class AdapterValidationError(Exception):
    """Onboarding screen failure: the uploaded adapter tree is rejected
    before registration."""


def validate_lora_tree(lora_tree, adapter_id: str = "?"):
    """Every ``{'a','b'}`` LoRA linear must be finite and rank-consistent;
    raises :class:`AdapterValidationError` otherwise (called before
    quantization so a poisoned upload never enters the registry)."""
    from repro_torch.serving.engine import iter_lora_linears

    leaves = iter_lora_linears(lora_tree)
    if not leaves:
        raise AdapterValidationError(
            f"adapter {adapter_id!r}: upload contains no {{'a','b'}} LoRA "
            f"linears")
    for path, leaf in leaves:
        a, b = leaf["a"], leaf["b"]
        if a.dim() < 2 or b.dim() < 2:
            raise AdapterValidationError(
                f"adapter {adapter_id!r} at {path}: LoRA factors must be "
                f"at least 2-D, got a{tuple(a.shape)} b{tuple(b.shape)}")
        if a.shape[-2] != b.shape[-1]:
            raise AdapterValidationError(
                f"adapter {adapter_id!r} at {path}: rank mismatch between "
                f"a{tuple(a.shape)} (rank {a.shape[-2]}) and "
                f"b{tuple(b.shape)} (rank {b.shape[-1]})")
        if not (bool(torch.isfinite(a).all()) and
                bool(torch.isfinite(b).all())):
            raise AdapterValidationError(
                f"adapter {adapter_id!r} at {path}: non-finite values in "
                f"upload (NaN/Inf)")
