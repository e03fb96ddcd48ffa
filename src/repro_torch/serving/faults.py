"""The part of the serving failure contract that the static engine paths use
(port of ``repro/serving/faults.py:43-118``, ``:344``).

Request lifecycle states, the structured per-request error base, the
unknown-adapter rejection, and the onboarding screen for uploaded LoRA
trees. Deadlines, queue backpressure, quarantine, the host transport and
fault injection come with ROADMAP A8.
"""

from __future__ import annotations

import enum
from typing import Optional

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
