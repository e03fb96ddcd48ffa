"""The part of the serving failure contract that the engine and the paged
adapter memory use (port of ``repro/serving/faults.py:43-126``, ``:286-382``).

Request lifecycle states, the structured per-request errors (unknown,
poisoned and quarantined adapters, deadlines, exhausted adapter memory),
the host tier's read path with its integrity check, and the onboarding
screen for uploaded LoRA trees. Queue backpressure (``QueueFull``) and
seeded fault injection (``FaultPlan``, ``named_plan``) come with ROADMAP
A3.
"""

from __future__ import annotations

import enum
from typing import Dict, Optional

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


class HostTransport:
    """The host-tier page-read path the memory manager calls
    (:meth:`read`). Without a fault plan a read is exactly one
    ``builder()`` call; the reference's retry / timeout policy acts only
    on injected faults, which come with ROADMAP A3."""

    def __init__(self, faults=None):
        if faults is not None:
            raise NotImplementedError(
                "fault injection (FaultPlan) is not ported yet (ROADMAP A3)")
        self.faults = faults
        self.reads = 0
        self.retries = 0
        self.timeouts = 0
        self.failures = 0

    def read(self, adapter_id: str, builder):
        """Return ``builder()``; exceptions it raises propagate (they are
        bugs, not transport weather)."""
        self.reads += 1
        return builder()

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
