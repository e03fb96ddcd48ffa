"""What the harness notes about each forward the engine runs.

The engine calls ``model.prefill`` once per admission group and
``model.decode_step`` once per decode step. The recorder wraps both on the
model instance and notes, in order, which requests each one served: the
group's request ids (the ``admit`` events just before the prefill) or each
active row's request and the index of the token it feeds (the engine's rows
when the decode is called). Nothing of this waits for the device.

For a model with experts it also wraps the port's dispatch (the function
that sorts a layer's token-to-expert assignments and decides which fit the
capacity) and keeps, for the forwards that serve a request under check or
fall in the profiled stretch, each layer's assignments and kept flags as
the device holds them; they are read after the window has closed.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Set

import numpy as np


@dataclasses.dataclass
class Forward:
    kind: str                          # "prefill" | "decode"
    # prefill: (request id, None) per batch row; tpad the padded length
    # decode: (row, request id, index of the fed token in its sequence)
    rows: List[tuple]
    tpad: int = 1
    # per layer (assignments, capacity, order, kept): device tensors, then
    # (assignments, capacity, kept) numpy arrays after ``routing_to_host``
    routing: Optional[List[tuple]] = None


class Recorder:
    def __init__(self, engine, telemetry, moe: bool, watch_fn=None):
        self.engine = engine
        self.telemetry = telemetry
        self.forwards: List[Forward] = []
        # request ids under check, chosen by ``watch_fn`` at admission
        self.watch: Set[int] = set()
        self._watch_fn = watch_fn
        self.route_all = False             # keep every forward's routing
        self._current: Optional[Forward] = None
        self._moe = moe
        self._restore: List[tuple] = []

    def install(self):
        model = self.engine.model
        pre, dec = model.prefill, model.decode_step

        def prefill(params, batch, capacity):
            b, tpad = batch["tokens"].shape[:2]
            admits = []
            for e in reversed(self.telemetry.events):
                if e["event"] == "admit":
                    admits.append(e)
                    if len(admits) == b:
                        break
            rows = [(e["request_id"], None) for e in reversed(admits)]
            if self._watch_fn is not None:
                self.watch.update(r for r, _ in rows if self._watch_fn(r))
            return self._run(Forward("prefill", rows, int(tpad)),
                             pre, params, batch, capacity)

        def decode_step(params, tokens, caches, pos, start=None):
            rows = []
            for i, row in enumerate(self.engine._rows):
                if row is not None:
                    rows.append((i, row.req.request_id,
                                 row.prompt_len + len(row.emitted) - 1))
            return self._run(Forward("decode", rows),
                             dec, params, tokens, caches, pos, start)

        model.prefill, model.decode_step = prefill, decode_step
        self._restore.append((model, "prefill", None))
        self._restore.append((model, "decode_step", None))
        if self._moe:
            from repro_torch.models import ffn

            orig = ffn._dispatch_indices

            def dispatch(expert_ids, n_experts, capacity):
                out = orig(expert_ids, n_experts, capacity)
                cur = self._current
                if cur is not None and cur.routing is not None:
                    cur.routing.append((expert_ids, capacity, out[0], out[3]))
                return out

            ffn._dispatch_indices = dispatch
            self._restore.append((ffn, "_dispatch_indices", orig))

    def uninstall(self):
        for obj, name, orig in reversed(self._restore):
            if orig is None:
                delattr(obj, name)          # back to the class's method
            else:
                setattr(obj, name, orig)
        self._restore = []

    def _run(self, fwd: Forward, fn, *args):
        if self._moe and (self.route_all or any(
                r[0 if fwd.kind == "prefill" else 1] in self.watch
                for r in fwd.rows)):
            fwd.routing = []
        self.forwards.append(fwd)
        self._current = fwd
        try:
            return fn(*args)
        finally:
            self._current = None

    def routing_to_host(self):
        """Copy every kept routing record to numpy (after the window)."""
        for fwd in self.forwards:
            if not fwd.routing or isinstance(fwd.routing[0][0], np.ndarray):
                continue
            host = []
            for e, cap, order, keep in fwd.routing:
                e = e.reshape(-1).cpu().numpy()
                order = order.cpu().numpy()
                kept = np.empty(e.shape[0], dtype=bool)
                kept[order] = keep.cpu().numpy()
                host.append((e, int(cap), kept))
            fwd.routing = host

