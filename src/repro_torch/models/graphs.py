"""The continuous decode forward replayed from CUDA graphs.

A decode step of the serving engine runs the same forward on the same
tensors every step: the engine's persistent input rows, its caches, the
base params and the decode view of the slot pools, all rewritten in place.
Enqueued op by op from Python it keeps the card waiting on the host, so
:class:`DecodeGraphs` captures it once and replays it.

The capture is piecewise. It breaks at each MoE layer's dispatch, the call
of :func:`~repro_torch.models.ffn._dispatch_indices`, which stays eager: a
layer's graph ends where its flattened expert assignments are ready; on
replay an **island** clones them, calls the dispatch (looked up at call
time, so whatever wraps it sees every forward's routing, in tensors no
later replay overwrites) and copies its plan into the buffers that the next
graph reads. A dense forward is one graph, an MoE forward of L layers L + 1
graphs around L islands; all share one memory pool and are replayed in
order on the current stream. While capturing, an island fills its buffers
with a valid plan instead (the segment's outputs are not written yet).

The engine drives it (:meth:`DecodeGraphs.prepare` before each decode
call): a set of inputs is served eagerly the first time it is seen, which
warms every kernel, captured the next time, and replayed from then on;
``Model.decode_step`` replays only the call it was prepared for and runs
eagerly otherwise. The inputs are keyed by every tensor's address, shape,
strides and dtype and every other leaf's value, so a swap-in (an in-place
page write) keeps the graphs and a pool resize (new tensors) recaptures;
the engine keeps one tuple of arguments while its decode view and caches
stand, and the key is computed only when that tuple is new.

A capture is kept only if it checks out:

- **Launches.** The wrappers' launches made while capturing are recorded,
  not counted (``recording_launches``); the captured graphs' kernel nodes
  are read back through the driver API, and each wrapper's kernel must
  appear there exactly as often as the wrapper launched it. Each replay
  then counts those launches (``LAUNCH_COUNTS`` and the launch sinks), so
  the counts per forward are the eager ones and stand for kernels the
  graphs hold.
- **Room.** The graphs' memory pool keeps the forward's transients for as
  long as the graphs live, where an eager forward hands them back after
  each step. The capture is dropped unless the card's free memory and the
  allocator's cache outside every graph pool still hold the pool's size
  again, so that the eager work beside the replays (prefills, resizes, an
  eager forward of new inputs) keeps at least the room the forward took.

The forward stays eager off the card, under a mesh, and where a capture
fails or does not check out (logged once per architecture and error,
counted).

With a span log the runner writes ``engine.decode.capture`` (one per
capture) and ``engine.decode.replay`` (inside the engine's
``engine.decode.launch``), both with the engine's decode step as argument;
with a ``Telemetry`` it counts ``decode_graph_captures_total``,
``decode_graph_replays_total`` and ``decode_graph_capture_failures_total``.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import itertools
import logging
from typing import Any, List, Optional, Tuple

import torch

from repro_torch.kernels.quant_matmul.kernel import (KERNELS, count_launches,
                                                      recording_launches)
from repro_torch.spans import SPANS

from . import ffn

_CAPTURE = SPANS.name_id("engine.decode.capture")
_REPLAY = SPANS.name_id("engine.decode.replay")

_log = logging.getLogger(__name__)
_WARNED: set = set()            # (architecture, error type) logged so far


@functools.lru_cache(maxsize=None)
def _fields(cls) -> Tuple[str, ...]:
    return tuple(f.name for f in dataclasses.fields(cls))


def inputs_key(tree) -> tuple:
    """What a captured forward depends on: every tensor's address, shape,
    strides and dtype, every other leaf's value and the tree's structure."""
    out: List[Any] = []

    def walk(node):
        if isinstance(node, torch.Tensor):
            out.append((node.data_ptr(), node.shape, node.stride(),
                        node.dtype))
        elif isinstance(node, dict):
            for k, v in node.items():
                out.append(k)
                walk(v)
        elif isinstance(node, (list, tuple)):
            out.append(len(node))
            for v in node:
                walk(v)
        elif dataclasses.is_dataclass(node):
            out.append(type(node))
            for f in _fields(type(node)):
                walk(getattr(node, f))
        else:
            out.append(node)

    walk(tree)
    return tuple(out)


class _NodeParams(ctypes.Structure):
    """The driver API's ``CUDA_KERNEL_NODE_PARAMS_v2``."""

    _fields_ = ([("func", ctypes.c_void_p)]
                + [(f, ctypes.c_uint) for f in ("grid_x", "grid_y", "grid_z",
                                                "block_x", "block_y",
                                                "block_z", "shared")]
                + [(f, ctypes.c_void_p) for f in ("params", "extra", "kern",
                                                  "ctx")])


_KERNEL_NODE = 0                        # CU_GRAPH_NODE_TYPE_KERNEL


@functools.lru_cache(maxsize=None)
def _driver():
    return ctypes.CDLL("libcuda.so.1")


def _call(fn, *args):
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA driver error {rc}")


def kernel_names(graph) -> List[str]:
    """The symbol names of the kernel nodes of ``graph``, a
    ``torch.cuda.CUDAGraph`` captured with ``keep_graph=True``."""
    cu = _driver()
    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _call(cu.cuGraphGetNodes, g, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    _call(cu.cuGraphGetNodes, g, nodes, ctypes.byref(n))
    kind, name, out = ctypes.c_int(), ctypes.c_char_p(), []
    for node in map(ctypes.c_void_p, nodes[:n.value]):
        _call(cu.cuGraphNodeGetType, node, ctypes.byref(kind))
        if kind.value != _KERNEL_NODE:
            continue
        p = _NodeParams()
        _call(cu.cuGraphKernelNodeGetParams_v2, node, ctypes.byref(p))
        if p.func:
            _call(cu.cuFuncGetName, ctypes.byref(name),
                  ctypes.c_void_p(p.func))
        else:
            _call(cu.cuKernelGetName, ctypes.byref(name),
                  ctypes.c_void_p(p.kern))
        out.append(name.value.decode())
    return out


def wrapper_nodes(names) -> collections.Counter:
    """How many of the kernel names ``names`` are each wrapper's kernel
    (``<wrapper>_kernel`` within the symbol), by wrapper."""
    return collections.Counter(w for n in names for w in KERNELS
                               if f"{w}_kernel" in n)


def graph_pool_bytes(pool, device) -> Tuple[int, int]:
    """``(bytes reserved in the graph memory pool `pool`, bytes free for
    allocations outside every graph pool)`` on ``device``: the card's free
    memory and the cached, unallocated bytes of the allocator's own pool."""
    dev = torch.device(device)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    mine = cached = 0
    for seg in torch.cuda.memory_snapshot():
        if seg["device"] != idx:
            continue
        owner = tuple(seg["segment_pool_id"])
        if owner == tuple(pool):
            mine += seg["total_size"]
        elif owner == (0, 0):
            cached += seg["total_size"] - seg["allocated_size"]
    return mine, torch.cuda.mem_get_info(dev)[0] + cached


class CaptureRefused(RuntimeError):
    """A capture that completed but did not check out (launches or room)."""


@dataclasses.dataclass
class _Island:
    """One MoE layer's eager dispatch between two graph segments."""

    ids: torch.Tensor         # the segment's flattened assignments (T·k,)
    n_experts: int
    capacity: int
    plan: tuple               # (order, sorted_e, pos_in_e, keep) buffers

    @classmethod
    def at(cls, ids, n_experts: int, capacity: int) -> "_Island":
        """Buffers holding the plan of all-zero assignments: valid indices
        for whatever reads them before the first real dispatch."""
        ar = torch.arange(ids.shape[0], device=ids.device)
        plan = (ar, torch.zeros_like(ids), ar.clone(), ar < capacity)
        return cls(ids, n_experts, capacity, plan)

    def run(self):
        """This forward's dispatch on a copy of its assignments, its plan
        copied into the buffers the next segment reads."""
        fresh = ffn._dispatch_indices(self.ids.clone(), self.n_experts,
                                      self.capacity)
        for dst, src in zip(self.plan, fresh):
            dst.copy_(src)


class DecodeGraphs:
    """Piecewise CUDA graphs of one engine's decode forward (see the
    module's docstring). ``spans``: the engine's span log or None;
    ``telemetry``: its ``Telemetry`` or None."""

    def __init__(self, model, spans=None, telemetry=None):
        self.model = model
        self._spans = spans
        self._registry = (telemetry.registry if telemetry is not None
                          else None)
        self._stream = None
        self._pool = None
        self._graphs: List[Any] = []
        self._islands: List[_Island] = []
        self._capturing = False         # a segment's capture is open
        self._out: Optional[torch.Tensor] = None
        self._launches: dict = {}
        self._key = None                # the captured inputs
        self._args = None               # the last arguments and their key
        self._seen = None               # inputs served eagerly once
        self._failed = None             # inputs whose capture failed
        self._ready = None              # (args, step) of the prepared call
        self.captures = self.replays = self.failures = 0

    @staticmethod
    def supported(model, device) -> bool:
        """Whether decode graphs apply: on the card, without a mesh (and so
        without tensor parallelism)."""
        return torch.device(device).type == "cuda" and model.mesh is None

    # ----- the engine's side -----

    def prepare(self, step: int, args):
        """Called before the engine's ``model.decode_step(*args)``: captures
        the arguments if they were served eagerly at the last step, and arms
        the model to replay the call. The engine passes the same tuple while
        the inputs stand; its key is computed when the tuple is new."""
        if self._args is None or self._args[0] is not args:
            self._args = (args, inputs_key(args))
        key = self._args[1]
        if key != self._key:
            if key == self._failed:
                return
            if key != self._seen:
                self._seen = key
                return
            if not self._capture(step, args):
                self._failed = key
                return
            self._key = key
        self._ready = (args, step)
        self.model._armed = self

    def replay(self, params, tokens, caches, pos, start):
        """The logits of the prepared call, replayed; None (run it eagerly)
        for any other call."""
        ready, self._ready = self._ready, None
        if ready is None or any(
                a is not b for a, b in zip(ready[0], (params, tokens, caches,
                                                      pos, start))):
            return None
        sp = self._spans
        t = sp and sp.begin(_REPLAY)
        for g, isl in itertools.zip_longest(self._graphs, self._islands):
            g.replay()
            if isl is not None:
                isl.run()
        count_launches(self._launches)
        self.replays += 1
        if self._registry is not None:
            self._registry.counter(
                "decode_graph_replays_total",
                help="decode forwards replayed from CUDA graphs").inc()
        if sp:
            sp.end(_REPLAY, t, ready[1])
        return self._out

    # ----- capture -----

    def _begin(self):
        g = torch.cuda.CUDAGraph(keep_graph=True)   # its nodes are read
        g.capture_begin(pool=self._pool, capture_error_mode="thread_local")
        self._graphs.append(g)
        self._capturing = True

    def _end(self):
        self._capturing = False
        self._graphs[-1].capture_end()
        self._graphs[-1].instantiate()

    def _break(self, ids, n_experts: int, capacity: int):
        """``ffn._ISLAND``: end the segment at a layer's dispatch, open the
        next one, and hand back the island's plan buffers."""
        self._end()
        isl = _Island.at(ids, n_experts, capacity)
        self._islands.append(isl)
        self._begin()
        return isl.plan

    def _release(self):
        """Drop the captured graphs and their buffers."""
        if self._graphs:
            torch.cuda.synchronize()
        self._graphs, self._islands, self._out = [], [], None
        self._key = None

    def _capture(self, step: int, args) -> bool:
        sp = self._spans
        t = sp and sp.begin(_CAPTURE)
        self._release()
        dev = args[1].device
        torch.cuda.synchronize(dev)
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        self._pool = torch.cuda.graph_pool_handle()
        ok = False
        with torch.cuda.stream(self._stream):
            try:
                with recording_launches() as launches, torch.no_grad():
                    ffn._ISLAND = self._break
                    try:
                        self._begin()
                        self._out = self.model._decode(*args)
                        self._end()
                    finally:
                        ffn._ISLAND = None
                self._check(launches, dev)
                self._launches = dict(launches)
                ok = True
            except Exception as e:      # noqa: BLE001 - stays eager
                # on the capture stream: a capture ends where it began
                self._abort(e)
        torch.cuda.current_stream(dev).wait_stream(self._stream)
        if not ok:
            # the failed capture's memory, freed with its traceback, goes
            # back for the eager forward
            torch.cuda.empty_cache()
        else:
            self.captures += 1
            if self._registry is not None:
                self._registry.counter(
                    "decode_graph_captures_total",
                    help="captures of the decode forward's CUDA graphs"
                ).inc()
        if sp:
            sp.end(_CAPTURE, t, step)
        return ok

    def _check(self, launches, dev):
        """Refuse a capture whose graphs do not hold the recorded launches,
        or whose pool would leave the eager work less room than it takes."""
        nodes = wrapper_nodes(n for g in self._graphs
                              for n in kernel_names(g))
        if nodes != +collections.Counter(launches):
            raise CaptureRefused(
                f"the graphs hold {dict(nodes)} kernel nodes of the "
                f"wrappers, the capture launched {dict(launches)}")
        pool, room = graph_pool_bytes(self._pool, dev)
        if room < pool:
            raise CaptureRefused(
                f"the graph pool takes {pool / 2**30:.2f} GiB and would "
                f"leave {room / 2**30:.2f} GiB outside the graph pools")

    def _abort(self, err: Exception):
        """Close a capture that raised and drop its graphs (none of them
        ever ran)."""
        if self._capturing:
            self._capturing = False
            try:
                self._graphs[-1].capture_end()
            except Exception:           # noqa: BLE001 - the capture is void
                pass
        self._graphs, self._islands, self._out = [], [], None
        self.failures += 1
        if self._registry is not None:
            self._registry.counter(
                "decode_graph_capture_failures_total",
                help="decode graph captures that failed (served eagerly)"
            ).inc()
        what = (self.model.cfg.name, type(err).__name__)
        if what not in _WARNED:
            _WARNED.add(what)
            _log.warning("decode graphs of %s: the capture failed (%s: %s); "
                         "these inputs are served eagerly", what[0],
                         what[1], err, exc_info=err)
