"""Paged adapter memory: per-recipe device slot pools, a host tier and
prefetch (port of ``repro/serving/memory.py``).

The continuous scheduler reads packed codes through this module. A bounded
set of device **slots** holds the hot set of adapters; every registered
adapter's packed codes live in a host tier (CPU tensors, pinned when the
pools are on the card, so a swap-in is an asynchronous copy); admission
faults the long tail in on demand.

Slots live in one pool per packed-layout signature
(``recipe.layout_signature``): inside a pool every page is a fixed-size
slice of the pool's persistent stacks ``(L, capacity·fold, Rp, ·)``.
Budget accounting uses each signature's real ``page_bytes``; pools under a
byte budget grow slot by slot against a shared ledger and reclaim from
each other's cold tails when it runs dry.

* **Slot ids are segment ids.** A row's seg id is the global slot id: the
  pool's base offset (pools concatenate in creation order) plus the local
  slot. With several pools the serving tree is a
  :class:`~repro_torch.kernels.PackedLoRABuckets` whose lookups map global
  ids back to pool-local ones.
* **Pinning.** A slot read by a live batch row is pinned (refcounted) and
  never evicted; the unpinned rest of the pools churns LRU.
* **In-place page writes.** The reference's page write is functional: a
  decode step already dispatched keeps reading the old buffers. Here a
  swap-in copies into the pool tensors in place, ordered on one stream
  before the next forward, so that forward sees the new bytes. That gives
  the reference's tokens because (1) a swap-in only ever writes a slot no
  live row pins, (2) the engine reads its rows' seg ids before it
  prefetches, and (3) a pool resize allocates new tensors and copies the
  kept slots, never changing a tensor an earlier view still reads.

The manager is policy and bookkeeping; it owns no kernel code.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import (PackedLoRABatch, PackedLoRABuckets,
                                 pack_adapter_layers)
from repro_torch.kernels.quant_matmul.ops import (
    _PACKED_ARRAY_FIELDS as _ARRAY_FIELDS,
)
from repro_torch.serving.faults import (
    FaultPlan,
    HostReadError,
    HostTransport,
    PoisonedAdapter,
    page_arrays_finite,
)
from repro_torch.serving.telemetry import SPANS

# raw spans (argument: the page's bytes): a swap-in on the host, and the
# time to its last copy's end from the start of its copies (on the card
# the stream's, enqueue gaps included, resolved after the engine's next
# host read; on the CPU, whose copies are synchronous, the host's)
_SWAP_IN = SPANS.name_id("memory.swap_in")
_PAGE_COPY = SPANS.name_id("memory.page_copy")

# page meta = everything that is not a packed array, the late-attached seg
# or the per-view tile size, derived from the dataclass so a new field of
# PackedLoRABatch cannot go un-copied
_META_FIELDS = tuple(
    f.name for f in dataclasses.fields(PackedLoRABatch)
    if f.name not in _ARRAY_FIELDS + ("seg", "tile_t"))

_EMPTY_COUNTS = {"hits": 0, "misses": 0, "swap_ins": 0, "swap_in_bytes": 0,
                 "evictions": 0}


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host numpy array as a tensor on ``device``. On the card the copy
    goes through pinned memory without a stream synchronization (PyTorch's
    host allocator keeps the pinned block until the copy has run)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


@dataclasses.dataclass
class _HostPage:
    """One adapter's packed codes in the host tier: per path, per packed
    field, a CPU tensor ``(L, fold, Rp, ·)`` (fold 1 for plain leaves).
    ``version`` is the store epoch the page was built from and ``sig`` the
    recipe's packed-layout signature (its pool key)."""

    arrays: Dict[str, Dict[str, torch.Tensor]]
    version: int
    nbytes: int
    sig: tuple


@dataclasses.dataclass
class _Pool:
    """One signature's device slot pool: persistent per-path stacks
    ``(L, capacity·fold, Rp, ·)`` and the local slot-owner table."""

    sig: tuple
    arrays: Optional[Dict[str, Dict[str, torch.Tensor]]]   # None at cap 0
    capacity: int
    owners: List[Optional[str]]
    page_bytes: int

    def nbytes(self) -> int:
        if self.arrays is None:
            return 0
        return sum(arr.nbytes for fields in self.arrays.values()
                   for arr in fields.values())


class AdapterMemoryManager:
    """Two-tier adapter memory for the continuous scheduler.

    * **Device tier**: one :class:`_Pool` per recipe layout signature;
      global slot ids concatenate the pools in creation order and are the
      decode seg ids.
    * **Host tier**: every registered adapter's packed codes as CPU tensors
      (:class:`_HostPage`), built lazily per adapter from its quantized
      entries on the card and rebuilt when the store re-registers the id.

    Capacity: ``num_slots`` bounds the total slot count across pools;
    ``store.hbm_budget_bytes`` bounds the total pool bytes at each
    signature's real ``page_bytes``; neither → growable (all-resident). A
    store whose adapters share one signature pre-allocates its single pool
    up front; mixed-recipe stores grow pools slot by slot against the
    shared ledger and reclaim cold slots from other pools' tails.

    Eviction is LRU over resident, unpinned, unreserved slots. ``pin`` /
    ``unpin`` are refcounted per adapter id (one count per live row);
    ``prefetch`` reserves its slots until the next prefetch call.

    Host reads go through ``transport`` (default: a
    :class:`HostTransport` injecting ``faults``); ``faults`` also corrupts
    pages after the read, before the integrity check. With a
    ``telemetry``, every counter is mirrored into its registry
    (``adapter_memory_<counter>_total{pool=...}``), each swap-in is a
    ``memory.swap_in`` span and its copies a ``memory.page_copy`` one (on
    the card by a pair of CUDA events, :meth:`resolve_copy_timers`).
    """

    def __init__(self, store, like_tree, num_slots: Optional[int] = None,
                 tile_t: int = 8, device="cuda",
                 transport: Optional[HostTransport] = None,
                 faults: Optional[FaultPlan] = None, telemetry=None):
        if num_slots is not None and num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.store = store
        self.like_tree = like_tree
        self.requested_slots = num_slots
        self.tile_t = tile_t
        self.device = resolve_device(device)
        self.faults = faults
        self.transport = (transport if transport is not None
                          else HostTransport(faults=faults))
        self.telemetry = telemetry
        self._spans = telemetry.spans if telemetry is not None else None
        # (start event, end event, page bytes) of page copies not yet read
        self._copy_timers: List[Tuple[Any, Any, int]] = []

        self._leaf_info: Optional[List[Tuple[str, int, int]]] = None
        self._host: Dict[str, _HostPage] = {}
        self._pools: "collections.OrderedDict[tuple, _Pool]" = (
            collections.OrderedDict())
        self._page_bytes_by_sig: Dict[tuple, int] = {}
        self._meta_by_sig: Dict[tuple, Dict[str, Dict[str, Any]]] = {}
        # per-sig (tail shape, dtype) of every leaf field: lets pools resize
        # after their last host page is gone (deferred unregister)
        self._ref_by_sig: Dict[tuple, Dict[str, Dict[str, tuple]]] = {}

        self._where: Dict[str, Tuple[tuple, int]] = {}   # aid -> (sig, local)
        self._slot_version: Dict[str, int] = {}
        self._pins: Dict[str, int] = {}
        self._reserved: Set[str] = set()
        self._lru: "collections.OrderedDict[str, None]" = (
            collections.OrderedDict())
        # deferred unregister: ids whose store entry is gone but whose slot
        # is pinned by live rows, reaped on the last unpin
        self._dead: Set[str] = set()
        # ids whose page failed the integrity check, keyed to the store
        # version that failed; the engine drains this into its quarantine
        self.poisoned: Dict[str, Optional[int]] = {}

        self._tree = None                  # cached serving tree (dirty=None)
        self._seen_mutations = None
        self.hits = 0
        self.misses = 0
        self.swap_ins = 0
        self.swap_in_bytes = 0
        self.evictions = 0
        self.stale_serves = 0
        # per-pool (per recipe signature) breakdown of the counters above
        self._per_pool: Dict[tuple, Dict[str, int]] = {}
        # prefetch outcomes, kept apart from the admission hit rate
        self.prefetch_counts: Dict[str, int] = {
            "hit": 0, "staged": 0, "failed": 0, "no_slot": 0}

    # ----- counters -----

    @staticmethod
    def _sig_label(sig: tuple) -> str:
        """Stable label of one signature's pool, e.g. ``2-64-1``."""
        return "-".join(str(x) for x in sig)

    def _count(self, sig: tuple, key: str, n: int = 1):
        """Bump one per-pool counter, mirrored into the telemetry registry
        (``adapter_memory_<key>_total{pool=...}``) when attached."""
        pool = self._per_pool.setdefault(sig, dict(_EMPTY_COUNTS))
        pool[key] += n
        if self.telemetry is not None:
            self.telemetry.registry.counter(
                f"adapter_memory_{key}_total",
                pool=self._sig_label(sig)).inc(n)

    def _count_prefetch(self, outcome: str):
        self.prefetch_counts[outcome] += 1
        if self.telemetry is not None:
            self.telemetry.registry.counter(
                "adapter_memory_prefetch_total",
                help="prefetch staging outcomes",
                outcome=outcome).inc()

    def _count_stale(self):
        self.stale_serves += 1
        if self.telemetry is not None:
            self.telemetry.registry.counter(
                "adapter_memory_stale_serves_total",
                help="degraded serves from a stale resident page").inc()

    # ----- layout -----

    def _leaves(self) -> List[Tuple[str, int, int]]:
        """``(path, L, fold)`` for every {'a','b'} leaf of the template;
        ``fold`` multiplies out extra lead dims (MoE experts)."""
        if self._leaf_info is None:
            from repro_torch.serving.engine import (_leaf_folds,
                                                    iter_lora_linears)

            folds = _leaf_folds(self.like_tree)
            info = []
            for path, leaf in iter_lora_linears(self.like_tree):
                shape = tuple(leaf["a"].shape)
                if len(shape) < 3:
                    raise NotImplementedError(
                        f"paged packed serving needs stacked (L, ..., r, in) "
                        f"leaves; {path} has shape {shape}")
                info.append((path, int(shape[0]), folds[path]))
            self._leaf_info = info
        return self._leaf_info

    def _sig_of(self, adapter_id: str) -> tuple:
        return self.store.signature_of(adapter_id)

    def _host_page(self, adapter_id: str) -> _HostPage:
        """Host-tier page of one adapter, (re)built from the store's
        quantized entries when absent or stale (weights or recipe changed).

        The page is packed where the entries live (the card) and moved to
        the host: one synchronization per page build, none per swap-in.
        The build runs through the :class:`HostTransport` (retry, timeout,
        injection); an injected corruption applies to the host copy, which
        is integrity-checked before it is cached or copied into any slot:
        non-finite scales raise :class:`PoisonedAdapter` (recorded in
        :attr:`poisoned`), a read that keeps failing
        :class:`HostReadError`."""
        version = self.store.version(adapter_id)
        if version is None:
            raise KeyError(f"adapter {adapter_id!r} is not registered")
        page = self._host.get(adapter_id)
        if page is not None and page.version == version:
            return page
        qa = self.store.quantized[adapter_id]
        sig = self._sig_of(adapter_id)
        pin = self.device.type == "cuda"

        def build():
            arrays: Dict[str, Dict[str, torch.Tensor]] = {}
            meta: Dict[str, Dict[str, Any]] = {}
            nbytes = 0
            src = None
            for path, n_layers, fold in self._leaves():
                pb = pack_adapter_layers(qa.entries[path], fold=fold)
                meta[path] = {f: getattr(pb, f) for f in _META_FIELDS}
                fields = {}
                for f in _ARRAY_FIELDS:
                    arr = getattr(pb, f)
                    src = arr.device
                    # normalize to an explicit fold axis: (L, fold, Rp, ·)
                    arr = arr.reshape((n_layers, fold) + tuple(arr.shape[-2:]))
                    host = torch.empty(arr.shape, dtype=arr.dtype,
                                       pin_memory=pin)
                    host.copy_(arr, non_blocking=src.type == "cuda")
                    fields[f] = host
                    nbytes += host.nbytes
                arrays[path] = fields
            if src is not None and src.type == "cuda":
                torch.cuda.current_stream(src).synchronize()
            return arrays, meta, nbytes

        arrays, meta, nbytes = self.transport.read(adapter_id, build)
        if self.faults is not None:        # bad bytes at rest
            arrays = self.faults.corrupt_page(adapter_id, arrays)
        # layout facts are value-independent: record them even for a page
        # that fails the integrity check, so pool geometry survives
        self._page_bytes_by_sig.setdefault(sig, nbytes)
        self._meta_by_sig.setdefault(sig, meta)
        self._ref_by_sig.setdefault(sig, {
            path: {f: (tuple(arr.shape[-2:]), arr.dtype)
                   for f, arr in fields.items()}
            for path, fields in arrays.items()})
        if not page_arrays_finite(arrays):
            self.poisoned[adapter_id] = version
            raise PoisonedAdapter(
                f"adapter {adapter_id!r}: page integrity check failed "
                f"(non-finite scales)", adapter_id)
        self.poisoned.pop(adapter_id, None)
        page = _HostPage(arrays=arrays, version=version, nbytes=nbytes,
                         sig=sig)
        self._host[adapter_id] = page
        return page

    def page_bytes_of(self, adapter_id: str) -> int:
        """Device bytes one slot of this adapter's signature pool takes."""
        sig = self._sig_of(adapter_id)
        if sig not in self._page_bytes_by_sig:
            self._host_page(adapter_id)
        return self._page_bytes_by_sig[sig]

    def _sig_page_bytes(self, sig: tuple) -> int:
        """Page bytes of a signature, probing a registered adapter of it if
        not yet known; a probe that fails its read or integrity check tries
        the next adapter of the signature instead."""
        if sig not in self._page_bytes_by_sig:
            for aid in list(self.store.quantized):
                if self._sig_of(aid) != sig:
                    continue
                try:
                    self._host_page(aid)
                except (HostReadError, PoisonedAdapter):
                    if sig in self._page_bytes_by_sig:
                        break
                    continue
                break
        if sig not in self._page_bytes_by_sig:
            raise RuntimeError(f"no adapter of signature {sig} registered: "
                               "page size unknown")
        return self._page_bytes_by_sig[sig]

    @property
    def page_bytes(self) -> int:
        """Device bytes of one slot, while every registered adapter shares
        one recipe signature (:meth:`page_bytes_of` otherwise)."""
        sigs = self._registered_sigs()
        if not sigs:
            raise RuntimeError("no adapter registered yet: page size "
                               "unknown")
        if len(sigs) > 1:
            raise RuntimeError("mixed recipe signatures: page size is "
                               "per-adapter (use page_bytes_of)")
        return self._sig_page_bytes(next(iter(sigs)))

    def _registered_sigs(self) -> Set[tuple]:
        return {qa.signature for qa in self.store.quantized.values()}

    # ----- ledger -----

    @property
    def _growable(self) -> bool:
        return (self.requested_slots is None
                and getattr(self.store, "hbm_budget_bytes", None) is None)

    def _cost(self, sig: tuple) -> int:
        """Ledger cost of one slot of ``sig``: a slot under ``num_slots``,
        its real page bytes under ``hbm_budget_bytes``."""
        if self.requested_slots is not None:
            return 1
        return self._sig_page_bytes(sig)

    def _limit(self) -> Optional[int]:
        if self.requested_slots is not None:
            return self.requested_slots
        budget = getattr(self.store, "hbm_budget_bytes", None)
        return None if budget is None else int(budget)

    def _used(self) -> int:
        if self.requested_slots is not None:
            return sum(p.capacity for p in self._pools.values())
        return sum(p.capacity * self._sig_page_bytes(p.sig)
                   for p in self._pools.values())

    def _headroom(self, sig: tuple, n: int = 1) -> bool:
        limit = self._limit()
        if limit is None:
            return True
        if self._used() == 0:
            return True            # progress guarantee: a first slot always
        return self._used() + n * self._cost(sig) <= limit

    # ----- pools -----

    def _pool(self, sig: tuple) -> _Pool:
        pool = self._pools.get(sig)
        if pool is not None:
            return pool
        page_bytes = self._sig_page_bytes(sig)
        pool = _Pool(sig=sig, arrays=None, capacity=0, owners=[],
                     page_bytes=page_bytes)
        self._pools[sig] = pool
        # the first pool of a one-signature store is allocated at the full
        # allowance (num_slots, or max(1, budget // page_bytes)); growable
        # pools start at their signature's registry size
        sigs = self._registered_sigs()
        if self._growable:
            n = max(1, sum(1 for aid in self.store.quantized
                           if self._sig_of(aid) == sig))
            self._resize_pool(pool, n)
        elif len(self._pools) == 1 and sigs == {sig}:
            if self.requested_slots is not None:
                self._resize_pool(pool, self.requested_slots)
            else:
                budget = int(self.store.hbm_budget_bytes)
                self._resize_pool(pool, max(1, budget // max(page_bytes, 1)))
        return pool

    def _resize_pool(self, pool: _Pool, capacity: int):
        """(Re)allocate a pool's slot stacks at ``capacity`` slots, keeping
        resident pages (growth keeps local slot ids; a shrink drops only
        free tail slots). New tensors are allocated and the kept slots
        copied: a view built over the old tensors keeps reading them."""
        if capacity == pool.capacity:
            return
        if capacity == 0:
            pool.arrays = None
            pool.capacity = 0
            pool.owners = []
            self._tree = None
            return
        # field shapes come from the per-sig template recorded at the first
        # host-page build, not from a live host page, which may be gone
        ref = self._ref_by_sig.get(pool.sig)
        assert ref is not None, "pool resize before any host page"
        old, old_cap = pool.arrays, pool.capacity
        arrays: Dict[str, Dict[str, torch.Tensor]] = {}
        for path, n_layers, fold in self._leaves():
            fields = {}
            for f in _ARRAY_FIELDS:
                tail, dtype = ref[path][f]
                z = torch.zeros((n_layers, capacity * fold) + tail,
                                dtype=dtype, device=self.device)
                if old is not None and old_cap:
                    keep = min(old_cap, capacity) * fold
                    z[:, :keep].copy_(old[path][f][:, :keep])
                fields[f] = z
            arrays[path] = fields
        pool.arrays = arrays
        pool.capacity = capacity
        if capacity > len(pool.owners):
            pool.owners.extend([None] * (capacity - len(pool.owners)))
        else:
            assert all(o is None for o in pool.owners[capacity:])
            del pool.owners[capacity:]
        self._tree = None

    def _base(self, sig: tuple) -> int:
        """Global slot id of the pool's local slot 0."""
        base = 0
        for s, pool in self._pools.items():
            if s == sig:
                return base
            base += pool.capacity
        raise KeyError(sig)

    # ----- slot accounting -----

    @property
    def num_slots(self) -> int:
        """Total slot capacity across pools (creating the default pool of a
        store that has adapters but no pool yet)."""
        self._ensure_default_pool()
        return sum(p.capacity for p in self._pools.values())

    def _ensure_default_pool(self):
        if self._pools or not self.store.quantized:
            if not self._pools and not self.store.quantized:
                raise RuntimeError("no adapter registered yet: page size "
                                   "unknown")
            return
        self._pool(self._sig_of(next(iter(self.store.quantized))))

    @property
    def _slot_owner(self) -> List[Optional[str]]:
        """Global owner table (pools concatenated in base order)."""
        out: List[Optional[str]] = []
        for pool in self._pools.values():
            out.extend(pool.owners)
        return out

    def resident(self, adapter_id: str) -> bool:
        """True when the adapter's current codes (weight version and recipe
        signature) occupy a slot."""
        loc = self._where.get(adapter_id)
        if loc is None:
            return False
        return (self._slot_version.get(adapter_id)
                == self.store.version(adapter_id)
                and loc[0] == self._sig_of(adapter_id))

    def slot_of(self, adapter_id: str) -> int:
        sig, local = self._where[adapter_id]
        return self._base(sig) + local

    def pin(self, adapter_id: str):
        self._pins[adapter_id] = self._pins.get(adapter_id, 0) + 1

    def unpin(self, adapter_id: str):
        n = self._pins.get(adapter_id, 0) - 1
        if n <= 0:
            self._pins.pop(adapter_id, None)
            if adapter_id in self._dead:
                # deferred unregister: the last live row just retired
                self._dead.discard(adapter_id)
                if adapter_id in self._where:
                    self._free_slot(adapter_id)
                self._host.pop(adapter_id, None)
        else:
            self._pins[adapter_id] = n

    def pinned(self, adapter_id: str) -> bool:
        return self._pins.get(adapter_id, 0) > 0

    def _free_slot(self, adapter_id: str):
        sig, local = self._where.pop(adapter_id)
        self._pools[sig].owners[local] = None
        self._slot_version.pop(adapter_id, None)
        self._lru.pop(adapter_id, None)
        self._reserved.discard(adapter_id)

    def _evictable(self, adapter_id: str) -> bool:
        return (not self.pinned(adapter_id)
                and adapter_id not in self._reserved)

    def _find_slot(self, sig: tuple) -> Optional[int]:
        """A local slot in ``sig``'s pool: a free slot, else the pool's LRU
        victim, else growth within the ledger (reclaiming other pools' cold
        tails if it is dry), else None."""
        pool = self._pool(sig)
        for slot, owner in enumerate(pool.owners):
            if owner is None:
                return slot
        for aid in self._lru:              # least-recent first
            loc = self._where.get(aid)
            if loc is None or loc[0] != sig or not self._evictable(aid):
                continue
            slot = loc[1]
            self._free_slot(aid)
            self.evictions += 1
            self._count(sig, "evictions")
            return slot
        if self._growable:
            slot = pool.capacity
            self._resize_pool(pool, max(2 * pool.capacity, 1))
            return slot
        if not self._headroom(sig):
            self._reclaim(sig)
        if self._headroom(sig):
            # geometric growth clamped to the ledger's headroom: each
            # resize copies the whole pool
            room = (self._limit() - self._used()) // self._cost(sig)
            slot = pool.capacity
            self._resize_pool(pool, min(max(2 * pool.capacity, 1),
                                        pool.capacity + max(int(room), 1)))
            return slot
        return None

    def _reclaim(self, need_sig: tuple):
        """Free ledger room for one ``need_sig`` slot by evicting cold pages
        of OTHER pools and shrinking those pools' tails; stops as soon as
        the ledger has headroom."""
        for aid in list(self._lru):
            if self._headroom(need_sig):
                return
            loc = self._where.get(aid)
            if loc is None or loc[0] == need_sig or not self._evictable(aid):
                continue
            sig = loc[0]
            self._free_slot(aid)
            self.evictions += 1
            self._count(sig, "evictions")
            self._shrink_tail(self._pools[sig])
        # final pass: tails freed by earlier evictions in any order
        for pool in self._pools.values():
            if self._headroom(need_sig):
                return
            if pool.sig != need_sig:
                self._shrink_tail(pool)

    def _shrink_tail(self, pool: _Pool):
        """Drop the pool's trailing free slots. A tail held by an unpinned,
        unreserved owner above a free slot migrates down first (one
        host-tier swap-in into the free slot); the tensors are reallocated
        once, at the final capacity."""
        cap = pool.capacity
        migrated = []
        while cap:
            owner = pool.owners[cap - 1]
            if owner is None:
                cap -= 1
                continue
            hole = next((i for i, o in enumerate(pool.owners[:cap - 1])
                         if o is None), None)
            if hole is None or not self._evictable(owner):
                break
            pool.owners[cap - 1] = None
            pool.owners[hole] = owner
            self._where[owner] = (pool.sig, hole)
            migrated.append((owner, hole))
            cap -= 1
        for owner, hole in migrated:       # data follows the owner table
            try:
                self._swap_in(owner, pool.sig, hole, migrate=True)
            except (HostReadError, PoisonedAdapter):
                self._free_slot(owner)
                self.evictions += 1
                self._count(pool.sig, "evictions")
        if cap != pool.capacity:
            self._resize_pool(pool, cap)

    def _swap_in(self, adapter_id: str, sig: tuple, slot: int,
                 migrate: bool = False):
        """Copy one host page into ``sig``'s pool at local ``slot``: one
        copy per leaf field, asynchronous from pinned memory.

        The write is in place, into tensors the current decode view may be
        reading. Only a slot no live row pins is ever written (``slot`` is
        free, evicted or re-owned by this adapter), and the engine reads
        its rows' seg ids before it prefetches, so no active row reads the
        bytes that change. An inactive row decodes with seg 0 and
        ``start = capacity``: it may read a slot being written, which is
        harmless only because every one of its keys is masked with a
        finite ``NEG_INF`` (``models/attention.py``) and its output is
        discarded."""
        sp = self._spans
        t = sp and sp.begin(_SWAP_IN)
        page = self._host_page(adapter_id)
        pool = self._pools[sig]
        on_card = sp is not None and self.device.type == "cuda"
        if on_card:
            stream = torch.cuda.current_stream(self.device)
            ev0 = torch.cuda.Event(enable_timing=True)
            ev0.record(stream)
        elif sp:
            t_copy = time.perf_counter_ns()
        for path, _, fold in self._leaves():
            dst, src = pool.arrays[path], page.arrays[path]
            for f in _ARRAY_FIELDS:
                dst[f][:, slot * fold:(slot + 1) * fold].copy_(
                    src[f], non_blocking=True)
        if on_card:
            ev1 = torch.cuda.Event(enable_timing=True)
            ev1.record(stream)
            self._copy_timers.append((ev0, ev1, page.nbytes))
        elif sp:
            sp.add(_PAGE_COPY, t_copy, time.perf_counter_ns(), page.nbytes)
        pool.owners[slot] = adapter_id
        self._where[adapter_id] = (sig, slot)
        self._slot_version[adapter_id] = page.version
        if not migrate:
            self._lru[adapter_id] = None
            self._lru.move_to_end(adapter_id)
        self.swap_ins += 1
        self.swap_in_bytes += page.nbytes
        self._count(sig, "swap_ins")
        self._count(sig, "swap_in_bytes", page.nbytes)
        self._tree = None
        if sp:
            sp.end(_SWAP_IN, t, page.nbytes)

    def resolve_copy_timers(self):
        """Log the stream time of every timed swap-in whose copies have
        run (from the stream reaching it to the end of its last copy, the
        gaps in which the stream waited for the host to enqueue the next
        copy included) as a ``memory.page_copy`` record ending now, its
        bytes the argument. The engine calls it right after a host read,
        which has waited for the stream; a copy not yet run stays pending:
        this never waits."""
        if not self._copy_timers:
            return
        pending = []
        for ev0, ev1, nbytes in self._copy_timers:
            if ev1.query():
                now = time.perf_counter_ns()
                ns = int(ev0.elapsed_time(ev1) * 1e6)
                self._spans.add(_PAGE_COPY, now - ns, now, nbytes)
            else:
                pending.append((ev0, ev1, nbytes))
        self._copy_timers = pending

    # ----- engine-facing operations -----

    def acquire(self, adapter_id: str, pin: bool = True) -> Optional[int]:
        """Map an adapter to a resident slot for admission; returns the
        GLOBAL slot id (the decode seg id), or ``None`` when no slot can be
        claimed (everything pinned or reserved and the ledger dry: the
        caller retries next step).

        A hit touches the LRU; a miss claims a free or evictable slot of
        the adapter's signature pool and swaps the page in. A swap-in whose
        host read fails falls back to a stale resident page of the same
        adapter when there is one (``stale_serves``), else
        :class:`HostReadError` propagates; a page failing its integrity
        check raises :class:`PoisonedAdapter`. The global id is stable only
        until another pool grows: re-read :meth:`slot_of` per step."""
        sig = self._sig_of(adapter_id)
        if self.resident(adapter_id):
            self.hits += 1
            self._count(sig, "hits")
            local = self._where[adapter_id][1]
        else:
            loc = self._where.get(adapter_id)
            stale_local = (loc[1] if loc is not None and loc[0] == sig
                           else None)
            if stale_local is not None:
                local = stale_local            # stale codes: reload in place
            else:
                if loc is not None:            # recipe changed pools
                    self._free_slot(adapter_id)
                local = self._find_slot(sig)
                if local is None:
                    return None                # retried next step, not
            self.misses += 1                   # charged as a miss
            self._count(sig, "misses")
            try:
                self._swap_in(adapter_id, sig, local)
            except HostReadError:
                if stale_local is None:
                    raise
                self._count_stale()
        self._lru[adapter_id] = None
        self._lru.move_to_end(adapter_id)
        self._reserved.discard(adapter_id)
        if pin:
            self.pin(adapter_id)
        return self._base(sig) + local

    def prefetch(self, adapter_ids: Sequence[str]):
        """Stage the next admission wave's pages one step ahead.

        The engine calls it after reading this step's seg ids and building
        the decode view, before the decode: the page copies are enqueued
        ahead of the decode on the same stream and write only unpinned
        slots. Staged slots are reserved (not evictable) until the next
        prefetch call; misses here are not charged to the hit rate."""
        reserved: Set[str] = set()
        for aid in adapter_ids:
            if self.store.version(aid) is None:
                continue
            sig = self._sig_of(aid)
            if not self.resident(aid):
                loc = self._where.get(aid)
                if loc is not None and loc[0] == sig:
                    slot = loc[1]
                else:
                    if loc is not None:
                        self._free_slot(aid)
                    self._reserved = reserved      # protect earlier stages
                    slot = self._find_slot(sig)
                    if slot is None:
                        self._count_prefetch("no_slot")
                        continue
                try:
                    self._swap_in(aid, sig, slot)
                except (HostReadError, PoisonedAdapter):
                    self._count_prefetch("failed")
                    continue       # opportunistic: admission surfaces it
                self._count_prefetch("staged")
            else:
                self._count_prefetch("hit")
            self._lru[aid] = None
            self._lru.move_to_end(aid)
            reserved.add(aid)
        self._reserved = reserved

    def refresh(self):
        """Reconcile with the store's mutations since the last call.
        Unregistered adapters lose their host page at once and their slot
        once unpinned; re-registered pinned adapters are reloaded, in place
        when the recipe signature is unchanged, into their new signature's
        pool otherwise, so live rows serve the newest weights."""
        mutations = self.store.mutation_count()
        if mutations == self._seen_mutations:
            return
        self._seen_mutations = mutations
        for aid in list(self._where):
            version = self.store.version(aid)
            if version is None:
                self._host.pop(aid, None)
                if not self.pinned(aid):
                    self._free_slot(aid)
                    self._dead.discard(aid)
                else:
                    self._dead.add(aid)      # reaped by the last unpin
            elif version != self._slot_version.get(aid):
                self._dead.discard(aid)        # re-registered while dying
                sig_now = self._sig_of(aid)
                sig_was = self._where[aid][0]
                if not self.pinned(aid):
                    self._free_slot(aid)
                elif sig_now == sig_was:
                    try:
                        self._swap_in(aid, sig_was, self._where[aid][1])
                    except (HostReadError, PoisonedAdapter):
                        self._count_stale()
                else:
                    # read the new page FIRST: a failed read must leave the
                    # old placement serving
                    try:
                        self._host_page(aid)
                    except (HostReadError, PoisonedAdapter):
                        self._count_stale()
                        continue
                    local = self._find_slot(sig_now)
                    old_sig, old_local = self._where[aid]
                    if local is None:
                        raise RuntimeError(
                            f"adapter {aid!r} re-registered with a new "
                            f"recipe while pinned, but its new pool has no "
                            f"free slot")
                    self._pools[old_sig].owners[old_local] = None
                    self._where[aid] = (sig_now, local)
                    self._swap_in(aid, sig_now, local)
        for aid in list(self._host):
            if self.store.version(aid) is None:
                self._host.pop(aid, None)

    # ----- the device view -----

    def serving_tree(self):
        """The LoRA tree the engine feeds the model: ``like_tree`` mirrored
        with :class:`PackedLoRABatch` leaves over the slot stacks (one pool)
        or :class:`PackedLoRABuckets` leaves (one bucket per live pool,
        lookups from global slot ids to pool-local ones). Rebuilt only after
        a swap-in or a resize (views over the same tensors; an unchanged
        tree keeps its identity)."""
        self._ensure_default_pool()
        if self._tree is not None:
            return self._tree

        live = [p for p in self._pools.values() if p.capacity > 0]
        total = sum(p.capacity for p in self._pools.values())
        luts = []
        for pool in live:
            lut = np.full((total,), -1, np.int32)
            base = self._base(pool.sig)
            lut[base:base + pool.capacity] = np.arange(pool.capacity,
                                                       dtype=np.int32)
            luts.append(upload(lut, self.device))

        def leaf_of(pool: _Pool, path: str):
            meta = self._meta_by_sig[pool.sig][path]
            return PackedLoRABatch(**pool.arrays[path], seg=None, **meta,
                                   tile_t=self.tile_t)

        def rebuild(node, path):
            if isinstance(node, dict):
                if set(node.keys()) == {"a", "b"}:
                    n_layers = next(L for p, L, _ in self._leaves()
                                    if p == path)
                    if len(live) == 1 and total == live[0].capacity:
                        return leaf_of(live[0], path)
                    return PackedLoRABuckets(
                        buckets=tuple(leaf_of(p, path) for p in live),
                        lookups=tuple(lut.expand(n_layers, total)
                                      for lut in luts),
                        seg=None)
                return {k: rebuild(v, f"{path}/{k}") for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return type(node)(rebuild(v, f"{path}/{i}")
                                  for i, v in enumerate(node))
            return node

        self._tree = rebuild(self.like_tree, "")
        return self._tree

    # ----- accounting -----

    def hbm_bytes(self) -> int:
        """Bytes of the device slot pools: a function of the slot
        capacities, not of how many adapters are registered."""
        return sum(p.nbytes() for p in self._pools.values())

    def host_bytes(self) -> int:
        return sum(p.nbytes for p in self._host.values())

    def stats(self) -> Dict[str, Any]:
        """Counters and per-tier bytes, plus a per-pool breakdown.
        ``hit_rate`` is ``None`` before the first :meth:`acquire`;
        ``per_pool`` keys each signature's label to its own counters,
        capacity and occupancy."""
        lookups = self.hits + self.misses
        t = self.transport.stats()
        per_pool: Dict[str, Dict[str, Any]] = {}
        for sig, pool in self._pools.items():
            counts = self._per_pool.get(sig, dict(_EMPTY_COUNTS))
            pl = counts["hits"] + counts["misses"]
            per_pool[self._sig_label(sig)] = {
                **counts,
                "lookups": pl,
                "hit_rate": counts["hits"] / pl if pl else None,
                "capacity": pool.capacity,
                "resident": sum(o is not None for o in pool.owners),
                "pinned": sum(1 for aid, (s, _) in self._where.items()
                              if s == sig and self.pinned(aid)),
                "page_bytes": pool.page_bytes,
            }
        if self.telemetry is not None:
            # the reference's series and help texts, so that the two
            # packages' expositions compare line for line
            reg = self.telemetry.registry
            reg.gauge("adapter_memory_slots",
                      help="total HBM slot capacity").set(
                sum(p.capacity for p in self._pools.values()))
            reg.gauge("adapter_memory_resident",
                      help="resident pages").set(len(self._where))
            reg.gauge("adapter_memory_pinned",
                      help="pinned adapters").set(len(self._pins))
            reg.gauge("adapter_memory_hbm_bytes").set(self.hbm_bytes())
            reg.gauge("adapter_memory_host_bytes").set(self.host_bytes())
        return {
            "slots": sum(p.capacity for p in self._pools.values()),
            "pools": len(self._pools),
            "resident": len(self._where),
            "pinned": len(self._pins),
            "hits": self.hits,
            "misses": self.misses,
            "lookups": lookups,
            "hit_rate": self.hits / lookups if lookups else None,
            "swap_ins": self.swap_ins,
            "swap_in_bytes": self.swap_in_bytes,
            "evictions": self.evictions,
            "stale_serves": self.stale_serves,
            "prefetch": dict(self.prefetch_counts),
            "dead": len(self._dead),
            "poisoned": len(self.poisoned),
            "host_reads": t["reads"],
            "host_read_retries": t["retries"],
            "host_read_failures": t["failures"],
            "hbm_slot_mb": self.hbm_bytes() / 1e6,
            "host_tier_mb": self.host_bytes() / 1e6,
            "per_pool": per_pool,
        }
