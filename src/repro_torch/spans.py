"""Raw spans and profiler ranges: where the port's host time goes.

* :func:`profiler_range` — a ``record_function`` range of a name while
  ``torch.profiler`` records, else a context that does nothing. It costs
  one flag check while no profiler records; the model names its forward's
  parts with it (``model.*``).
* :class:`SpanLog` — ``(name, start, end, argument)`` records on
  ``time.perf_counter_ns`` in a bounded ring. :data:`SPANS` is the one log
  of the process, exposed as ``serving.telemetry.Telemetry.spans``: the
  engine and its paged memory write their step's phases there when they
  hold a ``Telemetry``.

The module sits below ``core/``, ``models/`` and ``serving/`` so each may
import it, and it imports torch's profiler at first use only.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

__all__ = ["Span", "SpanLog", "SPANS", "profiler_range"]

_now_ns = time.perf_counter_ns
_profiler = None                 # torch.autograd.profiler, at first use
_NO_RANGE = contextlib.nullcontext()


def _look_up_profiler():
    global _profiler
    import torch.autograd.profiler as profiler

    _profiler = profiler
    return profiler


def profiler_range(name: str):
    """A ``record_function`` range ``name`` while ``torch.profiler``
    records, else a context that does nothing."""
    prof = _profiler or _look_up_profiler()
    if prof._is_profiler_enabled:
        return prof.record_function(name)
    return _NO_RANGE


class Span(NamedTuple):
    """One raw record of the :class:`SpanLog`: ``start`` / ``end`` in
    ``time.perf_counter_ns`` nanoseconds."""

    name: str
    start: int
    end: int
    arg: int


class SpanLog:
    """Raw spans in a preallocated list used as a bounded ring.

    A span is :meth:`begin` (returns its start) then :meth:`end` (writes
    the record); :meth:`add` writes a finished record, such as a device
    time resolved later. Records are written at their end, so the ring is
    ordered by end time; once more than ``capacity`` have been written the
    oldest are overwritten and :attr:`overflow` counts them. No histograms:
    readers take percentiles from the raw records (:meth:`between`).

    While ``torch.profiler`` records, every span is also a
    :func:`profiler_range` of the same name, opened before its start is
    read and closed after its end is, so the profile's host ranges name
    what the process was doing; otherwise a span costs one flag check, two
    clock reads and one slot of the ring.
    """

    def __init__(self, capacity: int = 1 << 18):
        if capacity < 1 or capacity & (capacity - 1):
            raise ValueError(f"capacity must be a power of two, "
                             f"got {capacity}")
        self.capacity = capacity
        self._mask = capacity - 1
        # (name id, start ns, end ns, argument) per slot
        self._ring: List[Optional[Tuple[int, int, int, int]]] = (
            [None] * capacity)
        self._n = 0                          # records ever written
        self.names: List[str] = []
        self._ids: Dict[str, int] = {}
        self._open: List[Tuple[int, Any]] = []   # (name id, open range)

    def name_id(self, name: str) -> int:
        """The id of ``name``, registered on first use."""
        i = self._ids.get(name)
        if i is None:
            i = self._ids[name] = len(self.names)
            self.names.append(name)
        return i

    @property
    def overflow(self) -> int:
        """Records overwritten by the ring so far."""
        return max(0, self._n - self.capacity)

    def begin(self, name: int) -> int:
        if (_profiler or _look_up_profiler())._is_profiler_enabled:
            rf = profiler_range(self.names[name])
            rf.__enter__()
            self._open.append((name, rf))
        return _now_ns()

    def end(self, name: int, start: int, arg: int = 0) -> None:
        end = _now_ns()
        if self._open:
            self._close(name)
        self.add(name, start, end, arg)

    def add(self, name: int, start: int, end: int, arg: int = 0) -> None:
        n = self._n
        self._ring[n & self._mask] = (name, start, end, arg)
        self._n = n + 1

    def _close(self, name: int) -> None:
        """Close the newest open range of ``name`` and any opened after it
        (a span whose code raised leaves its range open)."""
        for k in range(len(self._open) - 1, -1, -1):
            if self._open[k][0] == name:
                for _, rf in reversed(self._open[k:]):
                    rf.__exit__(None, None, None)
                del self._open[k:]
                return

    def reset(self) -> None:
        """Forget every record (the names stay registered)."""
        self._n = 0
        self._open.clear()

    def _end_of(self, j: int) -> int:
        return self._ring[j & self._mask][2]

    def _first_ending_at(self, lo: int, t: int) -> int:
        """The first record index in ``[lo, n)`` that ends at or after
        ``t`` (records are in end order)."""
        hi = self._n
        while lo < hi:
            mid = (lo + hi) // 2
            if self._end_of(mid) < t:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def between(self, t0: float, t1: float) -> Optional[List[Span]]:
        """The records that end in ``[t0, t1]`` (``time.perf_counter``
        seconds), in end order; None when the ring has overwritten a record
        that might have ended in it."""
        lo = self._n - min(self._n, self.capacity)
        a, b = int(t0 * 1e9), int(t1 * 1e9)
        if lo > 0 and self._end_of(lo) >= a:
            return None
        first = self._first_ending_at(lo, a)
        last = self._first_ending_at(first, b + 1)
        out = []
        for j in range(first, last):
            name, start, end, arg = self._ring[j & self._mask]
            out.append(Span(self.names[name], start, end, arg))
        return out


# One log per process: every engine's spans land here.
SPANS = SpanLog()
