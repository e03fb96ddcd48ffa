"""Reading a ``torch.profiler`` stretch: device spans, busy time, idle gaps.

The profiled stretch is a run of whole engine steps inside the traced
window, framed by the harness's own ``bench.stretch`` range (which ends
after a device synchronization), with ``bench.step`` and ``bench.submit``
ranges around its calls into the engine. Device time is the union of the
card's kernel, copy and memset spans inside the frame.
"""

from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Tuple

Span = Tuple[str, int, int]          # name, start ns, end ns

TOP = 10


def spans(prof) -> Tuple[List[Span], List[Span]]:
    """``(device spans, host spans)`` of a finished profile, in ns."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        item = (e.name(), s, s + e.duration_ns())
        on_dev = e.device_type() == cuda
        if on_dev and (e.is_user_annotation() or
                       e.name().startswith("bench.")):
            continue                # a host range mirrored on the stream
        (dev if on_dev else host).append(item)
    return dev, host


def frame(host: List[Span], name: str = "bench.stretch") -> Tuple[int, int]:
    found = [(s, e) for n, s, e in host if n == name]
    if len(found) != 1:
        raise RuntimeError(f"{len(found)} '{name}' ranges in the trace")
    return found[0]


def clip(dev: List[Span], lo: int, hi: int) -> List[Span]:
    return [(n, max(s, lo), min(e, hi)) for n, s, e in dev
            if e > lo and s < hi]


def union(dev: List[Span]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for _, s, e in sorted(dev, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(a, b) for a, b in out]


def busy_ns(dev: List[Span]) -> int:
    return sum(b - a for a, b in union(dev))


def by_name(dev: List[Span]) -> Dict[str, Tuple[float, int]]:
    """Seconds and launches per device operation name."""
    acc: Dict[str, List[float]] = collections.defaultdict(lambda: [0.0, 0])
    for n, s, e in dev:
        acc[n][0] += (e - s) / 1e9
        acc[n][1] += 1
    return {n: (t, c) for n, (t, c) in acc.items()}


def top_ops(dev: List[Span]) -> List[list]:
    ops = sorted(by_name(dev).items(), key=lambda kv: -kv[1][0])[:TOP]
    return [[n[:96], t] for n, (t, _) in ops]


def idle_gaps(dev: List[Span], host: List[Span], lo: int,
              hi: int) -> List[list]:
    """Idle device time inside ``[lo, hi]``, summed by what the host was
    doing at each gap's middle: the innermost host range then, under the
    harness's own ``bench.*`` range around it."""
    busy = union(dev)
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    host = sorted((h for h in host if h[0] != "bench.stretch"),
                  key=lambda h: h[1])
    starts = [h[1] for h in host]
    bench = [h for h in host if h[0].startswith("bench.")]
    acc: Dict[str, float] = collections.defaultdict(float)
    for a, b in gaps:
        mid = (a + b) // 2
        inner = "none"
        i = bisect.bisect_right(starts, mid)
        for j in range(i - 1, max(i - 4096, -1), -1):
            n, s, e = host[j]
            if e >= mid and not n.startswith("bench."):
                inner = n
                break
        outer = next((n for n, s, e in bench if s <= mid <= e), "outside")
        acc[f"{outer} > {inner}"[:96]] += (b - a) / 1e9
    return [[n, t] for n, t in sorted(acc.items(), key=lambda kv: -kv[1])
            [:TOP]]


def read(prof) -> dict:
    """What the metric readers and the result line take from a stretch."""
    dev, host = spans(prof)
    lo, hi = frame(host)
    dev = clip(dev, lo, hi)
    return {"window_s": (hi - lo) / 1e9, "busy_s": busy_ns(dev) / 1e9,
            "by_name": by_name(dev), "device_ops": top_ops(dev),
            "idle_gaps": idle_gaps(dev, host, lo, hi),
            "device_events": len(dev)}
