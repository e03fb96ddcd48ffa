"""Window arithmetic over the telemetry's raw event log.

Every number here is taken from raw per-request and per-step timestamps
(the engine reads its clock after each step's host synchronization, so they
include the device work), never from the telemetry's bucketed histograms.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np


def percentile(values: Iterable[float], q: float) -> Optional[float]:
    v = np.asarray(list(values), dtype=np.float64)
    if v.size == 0:
        return None
    return float(np.percentile(v, q))


class Window:
    """The events of one run, cut to the window ``[t0, t1]``.

    ``forwards``: the recorder's forwards; the i-th decode forward is the
    i-th ``decode_step`` event and the i-th prefill forward the i-th
    ``prefill`` event."""

    def __init__(self, events: List[dict], forwards, t0: float, t1: float,
                 prompt_len: Dict[int, int]):
        self.t0, self.t1 = t0, t1
        self.seconds = t1 - t0
        self.prompt_len = prompt_len
        dec = [e for e in events if e["event"] == "decode_step"]
        pre = [e for e in events if e["event"] == "prefill"]
        fd = [f for f in forwards if f.kind == "decode"]
        fp = [f for f in forwards if f.kind == "prefill"]
        if len(dec) != len(fd) or len(pre) != len(fp):
            raise RuntimeError(f"{len(dec)} decode events for {len(fd)} "
                               f"decodes, {len(pre)} prefill events for "
                               f"{len(fp)} prefills")
        self.decodes = list(zip(dec, fd))
        self.prefills = list(zip(pre, fp))
        self.first = {e["request_id"]: e["ts"] for e in events
                      if e["event"] == "first_token"}
        self.admits = [e for e in events if e["event"] == "admit"]

    def inside(self, ts: float) -> bool:
        return self.t0 <= ts <= self.t1

    def decodes_in(self):
        return [(e, f) for e, f in self.decodes if self.inside(e["ts"])]

    def prefills_in(self):
        return [(e, f) for e, f in self.prefills if self.inside(e["ts"])]

    def tokens(self) -> Dict[str, int]:
        """Prompt tokens prefilled and tokens generated in the window."""
        prompt = gen = 0
        for e, _ in self.prefills_in():
            prompt += sum(self.prompt_len[r] for r in e["request_ids"])
            gen += len(e["request_ids"])
        for e, _ in self.decodes_in():
            gen += e["active_rows"]
        return {"prompt": prompt, "generated": gen}

    def ttfts(self, due: Dict[int, float]) -> List[float]:
        """Seconds from due to first token of every request due in the
        window; one still waiting at the close counts its wait so far."""
        out = []
        for rid, t in due.items():
            if not self.t0 <= t < self.t1:
                continue
            ft = self.first.get(rid)
            out.append((ft if ft is not None and ft <= self.t1 else self.t1)
                       - t)
        return out

    def token_gaps(self) -> List[float]:
        """Gaps between consecutive output tokens of each request, for
        every gap that ends in the window: the first from its first token
        to the decode step that gave its second."""
        last: Dict[int, float] = dict(self.first)
        gaps = []
        for e, f in self.decodes:
            ts = e["ts"]
            for _, rid, _ in f.rows:
                prev = last.get(rid)
                if prev is not None and self.inside(ts):
                    gaps.append(ts - prev)
                last[rid] = ts
        return gaps

    def queue_waits(self) -> List[float]:
        return [e["queue_wait_s"] for e in self.admits
                if self.inside(e["ts"])]
