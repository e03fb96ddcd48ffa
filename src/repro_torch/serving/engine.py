"""Multi-LoRA serving engine (port of ``repro/serving/engine.py``).

* :class:`AdapterStore` holds many adapters LoRAQuant-quantized, each under
  its own recipe, and serves them in two forms: **packed**
  (:meth:`AdapterStore.pack_batch`, a LoRA tree whose leaves are
  :class:`~repro_torch.kernels.PackedLoRABatch` stacks — or, for a
  mixed-recipe batch, :class:`~repro_torch.kernels.PackedLoRABuckets` of
  one stack per layout — read straight from the codes by the ``sgmv_fused``
  kernel) and
  **materialize** (:meth:`AdapterStore.materialize`, dequantized fp trees
  through a byte-budgeted LRU — the reference path).
* :class:`MultiLoRAEngine` is a step-based continuous-batching scheduler
  (``mode="continuous"``, the default): requests are admitted into free
  batch rows mid-decode, finished rows retire at once, and per-row seg ids
  over the paged adapter memory
  (:class:`~repro_torch.serving.memory.AdapterMemoryManager`) let one
  fixed-shape decode step serve a churning mix of users from packed codes.
  ``mode="packed"`` keeps the static one-shot heterogeneous batch
  (prefill at ``tile_t = SEG_TILE = 8``, decode at ``tile_t = 1``) and
  ``mode="materialize"`` the per-adapter loop over dequantized fp trees,
  as references. All modes mask pad slots and use real rotary positions,
  so they agree token for token (attention architectures; recurrent
  states carry pad tokens, see :class:`MultiLoRAEngine`).

The engine honours the reference's failure contract
(``repro_torch.serving.faults``): deadlines, a bounded queue with
``reject`` / ``shed_oldest`` backpressure, quarantine of poisoned
adapters (the paged memory's page check in continuous mode, the store's
integrity screen in the static modes) and seeded fault injection. With a
:class:`~repro_torch.serving.telemetry.Telemetry` it records request
traces, latency histograms and kernel launches, and its step's phases as
raw spans (:data:`~repro_torch.spans.SPANS`).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import (
    LoRAQuantConfig,
    QuantRecipe,
    QuantizedLoRA,
    quantize_lora,
    quantize_lora_stacks,
)
from repro_torch.kernels import (
    PackedLoRABatch,
    PackedLoRABuckets,
    pack_adapter_layers,
    retile_packed,
    stack_packed_adapters,
)
from repro_torch.serving.faults import (
    AdapterValidationError,
    DeadlineExceeded,
    FaultPlan,
    HostReadError,
    HostTransport,
    MemoryExhausted,
    PoisonedAdapter,
    QueueFull,
    RequestError,
    RequestStatus,
    UnknownAdapter,
    validate_lora_tree,
)
from repro_torch.serving.memory import upload
from repro_torch.serving.telemetry import SPANS, Telemetry

# Raw spans of the continuous step (argument: the number of the decode
# step the call makes, or the admission wave for ``engine.admit.select`` /
# ``engine.prefill`` / ``engine.cache_copy``).
(_STEP, _SWEEP, _ADMIT, _SELECT, _PREFILL, _CACHE_COPY, _PREP, _VIEW,
 _LAUNCH, _SYNC, _RETIRE) = (
    SPANS.name_id(n) for n in (
        "engine.step", "engine.sweep", "engine.admit", "engine.admit.select",
        "engine.prefill", "engine.cache_copy", "engine.decode.prep",
        "engine.decode.view", "engine.decode.launch", "engine.decode.sync",
        "engine.retire"))

# Prefill token-tile rows: prompts are padded to a multiple of this so every
# tile holds one adapter; it is the most rows one sgmv_fused block holds.
SEG_TILE = 8


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of a LoRA leaf (the port's ``ShapeDtypeStruct``)."""

    shape: tuple
    dtype: torch.dtype


def iter_lora_linears(lora_tree) -> List[Tuple[str, Any]]:
    """(path, leaf_dict) for every {'a','b'} LoRA linear in a tree."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            if set(node.keys()) == {"a", "b"}:
                out.append((path, node))
                return
            for k, v in node.items():
                walk(v, f"{path}/{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")

    walk(lora_tree, "")
    return out


def _template(tree):
    if isinstance(tree, dict):
        return {k: _template(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_template(v) for v in tree)
    return TensorSpec(tuple(tree.shape), tree.dtype)


@dataclasses.dataclass
class QuantizedAdapter:
    """One user's adapter, LoRAQuant-compressed, layer-path keyed: a leaf
    ``a: (L, r, in)``, ``b: (L, out, r)`` becomes ``L`` independent
    :class:`QuantizedLoRA` entries. ``recipe`` is the recipe it was
    quantized under."""

    entries: Dict[str, List[QuantizedLoRA]]
    template: Any                       # lora tree of TensorSpec
    recipe: Optional[QuantRecipe] = None

    @property
    def signature(self) -> tuple:
        if self.recipe is not None:
            return self.recipe.layout_signature
        q = next(q for qs in self.entries.values() for q in qs)
        return q.config.layout_signature

    def total_bits(self) -> int:
        return sum(q.total_bits() for qs in self.entries.values() for q in qs)

    def num_params(self) -> int:
        return sum(q.num_params() for qs in self.entries.values() for q in qs)

    def avg_bits(self) -> float:
        return self.total_bits() / max(self.num_params(), 1)


def _leaf_pairs(leaf) -> Tuple[torch.Tensor, torch.Tensor]:
    """One {'a','b'} leaf → flattened per-layer 3-D stacks (Ln, ·, ·)."""
    a, b = leaf["a"], leaf["b"]
    if a.dim() == 2:
        a, b = a[None], b[None]
    return (a.reshape((-1,) + tuple(a.shape[-2:])),
            b.reshape((-1,) + tuple(b.shape[-2:])))


def quantize_adapter_tree(lora_tree, config: LoRAQuantConfig,
                          batched: bool = True) -> QuantizedAdapter:
    """Quantize every LoRA linear of an adapter tree. ``batched=True``
    buckets all paths' layer stacks by shape (one stacked pipeline per
    bucket); ``batched=False`` is the per-layer reference loop."""
    entries: Dict[str, List[QuantizedLoRA]] = {}
    if batched:
        order, stacks = [], []
        for path, leaf in iter_lora_linears(lora_tree):
            a2, b2 = _leaf_pairs(leaf)
            order.append(path)
            stacks.append((b2, a2))
        for path, qls in zip(order, quantize_lora_stacks(stacks, config)):
            entries[path] = qls
    else:
        for path, leaf in iter_lora_linears(lora_tree):
            a2, b2 = _leaf_pairs(leaf)
            entries[path] = [quantize_lora(b2[i], a2[i], config)
                             for i in range(a2.shape[0])]
    return QuantizedAdapter(entries=entries, template=_template(lora_tree),
                            recipe=config)


def dequantize_adapter(qa: QuantizedAdapter, like_tree) -> Any:
    """Materialize a fp LoRA tree shaped like ``like_tree`` (tensors or
    :class:`TensorSpec` leaves)."""

    def rebuild(node, path):
        if isinstance(node, dict):
            if set(node.keys()) == {"a", "b"}:
                bs, as_ = zip(*(q.materialize() for q in qa.entries[path]))
                # the SVD caps the factor rank at min(out, r): zero-pad the
                # rank dim back to the template (zeros add nothing to BA)
                r = node["a"].shape[-2]
                bs = [torch.nn.functional.pad(b_i, (0, r - b_i.shape[1]))
                      for b_i in bs]
                as_ = [torch.nn.functional.pad(a_i, (0, 0, 0, r - a_i.shape[0]))
                       for a_i in as_]
                a = torch.stack(as_).reshape(node["a"].shape)
                b = torch.stack(bs).reshape(node["b"].shape)
                return {"a": a.to(node["a"].dtype), "b": b.to(node["b"].dtype)}
            return {k: rebuild(v, f"{path}/{k}") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(v, f"{path}/{i}")
                              for i, v in enumerate(node))
        return node

    return rebuild(like_tree, "")


def _leaf_folds(template) -> Dict[str, int]:
    """Per-path fold factor: lead dims beyond the layer axis (MoE
    per-expert adapters ``(L, E, r, in)`` → E); plain leaves fold 1."""
    folds: Dict[str, int] = {}
    for path, leaf in iter_lora_linears(template):
        shape = tuple(leaf["a"].shape)
        folds[path] = (int(np.prod(shape[1:-2], dtype=np.int64))
                       if len(shape) > 3 else 1)
    return folds


def _float_leaves(q: QuantizedLoRA):
    """The float tensors of one quantized entry (its sides' scales)."""
    for side in (q.b_high, q.a_high, q.b_low, q.a_low):
        if side is None:
            continue
        for f in dataclasses.fields(side):
            v = getattr(side, f.name)
            if isinstance(v, torch.Tensor) and v.is_floating_point():
                yield v


def _tree_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.nbytes
    if isinstance(tree, (PackedLoRABatch, PackedLoRABuckets)):
        return tree.nbytes()
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return 0


class AdapterStore:
    """Quantized-at-rest adapter registry with per-adapter recipes.

    :meth:`pack_batch` builds packed device-resident stacks for the
    heterogeneous SGMV path (per-adapter layouts cached in ``_packed``,
    stacked batches in ``_batch_cache``); :meth:`materialize` builds fp
    LoRA trees through a byte-budgeted LRU (``fp_cache_bytes``).
    Re-registering an id invalidates both caches; :meth:`unregister` drops
    an adapter outright. Every mutation bumps a per-id version and a
    store-wide mutation counter, against which the paged adapter memory
    reconciles.

    ``hbm_budget_bytes`` caps the device bytes of the continuous path's
    slot pools (the memory manager prices each slot at its recipe's real
    page bytes); ``None`` means unbounded (all-resident).
    """

    def __init__(self, default_recipe: Optional[QuantRecipe] = None,
                 fp_cache_bytes: int = 1 << 30,
                 batched_quantize: bool = True,
                 hbm_budget_bytes: Optional[int] = None,
                 faults: Optional[FaultPlan] = None):
        self.default_recipe = (default_recipe if default_recipe is not None
                               else QuantRecipe())
        self.quantized: Dict[str, QuantizedAdapter] = {}
        self.fp_cache_bytes = fp_cache_bytes
        self.batched_quantize = batched_quantize
        self.hbm_budget_bytes = hbm_budget_bytes
        self._lru: "collections.OrderedDict[str, Any]" = \
            collections.OrderedDict()
        self._packed: Dict[str, Dict[str, PackedLoRABatch]] = {}
        self._batch_cache: Dict[tuple, Any] = {}
        self._versions: Dict[str, int] = {}
        self._mutations = 0
        self.faults = faults               # onboarding fault injection
        self._integrity: Dict[str, Tuple[int, bool]] = {}   # aid -> (ver, ok)
        self.onboard_errors: Dict[str, str] = {}   # last register_many skips

    def _invalidate(self, adapter_id: str):
        self._lru.pop(adapter_id, None)
        self._packed.pop(adapter_id, None)
        self._batch_cache.clear()

    def _bump(self, adapter_id: str):
        self._mutations += 1
        self._versions[adapter_id] = self._mutations

    def version(self, adapter_id: str) -> Optional[int]:
        """Monotonic per-id registration epoch; ``None`` if unregistered."""
        return self._versions.get(adapter_id)

    def mutation_count(self) -> int:
        """Store-wide mutation counter (register, re-register and
        unregister all bump it): a cheap change signal for caches."""
        return self._mutations

    def recipe_of(self, adapter_id: str) -> QuantRecipe:
        qa = self.quantized[adapter_id]
        if qa.recipe is not None:
            return qa.recipe
        return next(q for qs in qa.entries.values() for q in qs).config

    def signature_of(self, adapter_id: str) -> tuple:
        return self.quantized[adapter_id].signature

    def register(self, adapter_id: str, lora_tree,
                 recipe: Optional[QuantRecipe] = None,
                 validate: bool = True) -> QuantizedAdapter:
        """Quantize and register one adapter under ``recipe`` (default: the
        store's). ``validate`` screens the upload first (NaN/Inf, rank
        mismatch, an injected onboarding fault →
        :class:`AdapterValidationError`)."""
        if validate:
            if self.faults is not None:
                self.faults.check_onboard(adapter_id)
            validate_lora_tree(lora_tree, adapter_id)
        qa = quantize_adapter_tree(lora_tree, recipe or self.default_recipe,
                                   batched=self.batched_quantize)
        self.register_quantized(adapter_id, qa)
        return qa

    def register_quantized(self, adapter_id: str, qa: QuantizedAdapter):
        self._invalidate(adapter_id)
        self.quantized[adapter_id] = qa
        self._bump(adapter_id)

    def unregister(self, adapter_id: str):
        """Drop an adapter and every cache entry of it; new requests for the
        id are rejected with :class:`UnknownAdapter`."""
        if adapter_id not in self.quantized:
            raise KeyError(f"adapter {adapter_id!r} is not registered")
        del self.quantized[adapter_id]
        self._invalidate(adapter_id)
        self._versions.pop(adapter_id, None)
        self._mutations += 1

    def register_many(self, trees: Dict[str, Any],
                      recipes: Optional[Dict[str, QuantRecipe]] = None,
                      validate: bool = True, on_error: str = "raise",
                      ) -> Dict[str, QuantizedAdapter]:
        """Onboard many adapters: every same-shape LoRA linear across all
        trees sharing one recipe lands in one ``quantize_lora_stacks``
        bucket. ``on_error="skip"`` registers the healthy uploads and
        records rejects in :attr:`onboard_errors`."""
        if on_error not in ("raise", "skip"):
            raise ValueError(f"on_error must be 'raise' or 'skip', "
                             f"got {on_error!r}")
        recipes = recipes or {}
        self.onboard_errors = {}
        accepted = list(trees)
        if validate:
            accepted = []
            for adapter_id in trees:
                try:
                    if self.faults is not None:
                        self.faults.check_onboard(adapter_id)
                    validate_lora_tree(trees[adapter_id], adapter_id)
                except AdapterValidationError as e:
                    if on_error == "raise":
                        raise
                    self.onboard_errors[adapter_id] = str(e)
                else:
                    accepted.append(adapter_id)
        by_recipe: Dict[QuantRecipe, List[str]] = {}
        for adapter_id in accepted:
            rec = recipes.get(adapter_id, self.default_recipe)
            by_recipe.setdefault(rec, []).append(adapter_id)
        out: Dict[str, QuantizedAdapter] = {}
        for rec, adapter_ids in by_recipe.items():
            order, stacks = [], []
            for adapter_id in adapter_ids:
                for path, leaf in iter_lora_linears(trees[adapter_id]):
                    a2, b2 = _leaf_pairs(leaf)
                    order.append((adapter_id, path))
                    stacks.append((b2, a2))
            results = quantize_lora_stacks(stacks, rec)
            for (adapter_id, path), qls in zip(order, results):
                qa = out.get(adapter_id)
                if qa is None:
                    qa = out[adapter_id] = QuantizedAdapter(
                        entries={}, template=_template(trees[adapter_id]),
                        recipe=rec)
                qa.entries[path] = qls
        for adapter_id in accepted:                  # preserve upload order
            self.register_quantized(adapter_id, out[adapter_id])
        return out

    def check_integrity(self, adapter_id: str) -> bool:
        """True iff the adapter's quantized entries are finite (the float
        fields, scales: integer codes cannot encode NaN). Reduced where
        the entries live and read once per adapter, cached per
        registration version: one scan per (re-)register, not per step."""
        ver = self._versions.get(adapter_id, -1)
        cached = self._integrity.get(adapter_id)
        if cached is not None and cached[0] == ver:
            return cached[1]
        finite = [torch.isfinite(t).all()
                  for qs in self.quantized[adapter_id].entries.values()
                  for q in qs for t in _float_leaves(q)]
        ok = not finite or bool(torch.stack(finite).all())
        self._integrity[adapter_id] = (ver, ok)
        return ok

    def materialize(self, adapter_id: str, like_tree) -> Any:
        if adapter_id in self._lru:
            self._lru.move_to_end(adapter_id)
            return self._lru[adapter_id]
        tree = dequantize_adapter(self.quantized[adapter_id], like_tree)
        self._lru[adapter_id] = tree
        while (sum(_tree_bytes(t) for t in self._lru.values())
               > self.fp_cache_bytes and len(self._lru) > 1):
            self._lru.popitem(last=False)
        return tree

    # ----- packed (serve-from-codes) form -----

    def packed_entries(self, adapter_id: str) -> Dict[str, PackedLoRABatch]:
        """Per-path packed kernel layouts ``(L, Rp, ·)`` of one adapter,
        built once from the quantized codes and cached."""
        if adapter_id not in self._packed:
            qa = self.quantized[adapter_id]
            folds = _leaf_folds(qa.template)
            self._packed[adapter_id] = {
                path: pack_adapter_layers(qs, fold=folds.get(path, 1))
                for path, qs in qa.entries.items()}
        return self._packed[adapter_id]

    def pack_batch(self, adapter_ids: Sequence[str], like_tree,
                   tile_t: int = 8) -> Any:
        """A LoRA tree for a heterogeneous batch over ``adapter_ids``: every
        {'a','b'} leaf becomes a :class:`PackedLoRABatch` ``(L, NA, Rp, ·)``
        in adapter order — or, when the adapters' recipes span several
        packed-layout signatures, a :class:`PackedLoRABuckets` of one stack
        per signature (in ``sorted`` signature order) with int32 lookups
        ``(L, NA)`` from the batch-global adapter index to each bucket's
        local index (-1: another bucket). Attach per-row global adapter
        indices at ``lora["seg"]``. Cached per id tuple; any re-register
        invalidates the cache."""
        key = (tuple(adapter_ids), tile_t)
        cached = self._batch_cache.get(key)
        if cached is not None:
            return cached
        per = [self.packed_entries(a) for a in adapter_ids]
        sigs = [self.signature_of(a) for a in adapter_ids]
        buckets = sorted(set(sigs))
        na = len(adapter_ids)
        # per bucket: member positions in batch order + the global→local map
        members = [[i for i in range(na) if sigs[i] == sig]
                   for sig in buckets]
        luts = []
        for idx in members:
            lut = np.full((na,), -1, np.int32)
            lut[np.asarray(idx, np.int64)] = np.arange(len(idx),
                                                       dtype=np.int32)
            luts.append(lut)

        def rebuild(node, path):
            if isinstance(node, dict):
                if set(node.keys()) == {"a", "b"}:
                    if len(node["a"].shape) < 3:
                        raise NotImplementedError(
                            f"packed serving needs stacked (L, ..., r, in) "
                            f"layer leaves; {path} has 2-D shape "
                            f"{tuple(node['a'].shape)} — serve it with "
                            f"mode='materialize'")
                    if len(buckets) == 1:       # uniform recipes: one stack
                        return stack_packed_adapters([p[path] for p in per],
                                                     tile_t=tile_t)
                    stacks = [stack_packed_adapters([per[i][path]
                                                     for i in idx],
                                                    tile_t=tile_t)
                              for idx in members]
                    n_layers = stacks[0].ah_codes.shape[0]
                    dev = stacks[0].ah_codes.device
                    return PackedLoRABuckets(
                        buckets=tuple(stacks),
                        lookups=tuple(
                            torch.as_tensor(lut, device=dev).expand(
                                n_layers, na).contiguous()
                            for lut in luts),
                        seg=None)
                return {k: rebuild(v, f"{path}/{k}") for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return type(node)(rebuild(v, f"{path}/{i}")
                                  for i, v in enumerate(node))
            return node

        tree = rebuild(like_tree, "")
        self._batch_cache[key] = tree
        return tree

    # ----- accounting -----

    def resident_bits(self) -> int:
        return sum(qa.total_bits() for qa in self.quantized.values())

    def fp_resident_bytes(self) -> int:
        """Bytes of dequantized fp LoRA trees held by the LRU (0 whenever
        serving runs purely from packed codes)."""
        return sum(_tree_bytes(t) for t in self._lru.values())

    def packed_cache_bytes(self) -> int:
        return (sum(_tree_bytes(v) for v in self._packed.values())
                + sum(_tree_bytes(v) for v in self._batch_cache.values()))

    def stats(self) -> Dict[str, float]:
        bits = self.resident_bits()
        params = sum(qa.num_params() for qa in self.quantized.values())
        return {
            "adapters": len(self.quantized),
            "recipes": len({qa.signature for qa in self.quantized.values()}),
            "avg_bits": bits / max(params, 1),
            "quantized_mb": bits / 8 / 1e6,
            "fp16_equiv_mb": params * 2 / 1e6,
            "fp_lru_mb": self.fp_resident_bytes() / 1e6,
            "packed_cache_mb": self.packed_cache_bytes() / 1e6,
            "hbm_budget_mb": (self.hbm_budget_bytes / 1e6
                              if self.hbm_budget_bytes is not None
                              else float("inf")),
        }

    def adapter_stats(self) -> Dict[str, Dict[str, Any]]:
        return {aid: {"avg_bits": qa.avg_bits(),
                      "recipe": self.recipe_of(aid).variant_name}
                for aid, qa in self.quantized.items()}




@dataclasses.dataclass
class Request:
    """One generation request with its lifecycle state. ``deadline_ms`` is
    the total wall-clock budget from submit and ``ttft_deadline_ms`` the
    budget to the first token; the continuous scheduler checks both every
    step."""

    request_id: int
    adapter_id: str
    prompt: np.ndarray          # (T,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    deadline_ms: Optional[float] = None       # total budget (submit → done)
    ttft_deadline_ms: Optional[float] = None  # budget to the first token
    keep_logits: bool = False   # fill ``logits`` (parity checks across modes)
    output: Optional[np.ndarray] = None
    logits: Optional[np.ndarray] = None   # (len(output), vocab) fp32
    t_first: Optional[float] = None
    t_submit: Optional[float] = None
    status: RequestStatus = RequestStatus.PENDING
    error: Optional[RequestError] = None


@dataclasses.dataclass
class _Row:
    """One live batch row of the continuous scheduler. The row does not
    cache its adapter's slot id: the page is pinned for the row's
    lifetime, but its global id shifts when an earlier pool grows, so
    decode re-reads ``memory.slot_of`` every step."""

    req: Request
    start: int                  # left-pad count (first real cache index)
    prompt_len: int
    emitted: List[int]          # generated tokens so far (≥ 1 after prefill)
    logits: Optional[List[np.ndarray]] = None   # per token, if kept


def _copy_rows(dst, src, idx: torch.Tensor):
    """Copy the batch rows of every cache leaf of ``src`` into rows ``idx``
    (axis 1) of ``dst``'s, walking nested dicts and lists."""
    if isinstance(dst, torch.Tensor):
        dst.index_copy_(1, idx, src.to(dst.dtype))
    elif isinstance(dst, dict):
        for k, v in dst.items():
            _copy_rows(v, src[k], idx)
    else:
        for d, s in zip(dst, src):
            _copy_rows(d, s, idx)


class MultiLoRAEngine:
    """Step-based continuous-batching scheduler over many users' adapters.

    ``mode="continuous"`` (default): the engine owns ``max_rows`` batch
    rows backed by one persistent decode cache. :meth:`step` admits
    pending requests into free rows mid-decode (bursts of equal padded
    length prefill as one batch, their cache rows copied into the
    persistent cache), advances every active row by one greedy decode step
    at a fixed ``max_rows`` shape (inactive rows fully masked), and retires
    rows at ``max_new_tokens`` or ``eos_id``. Per-row adapter choice is the
    per-step seg ids over the paged adapter memory
    (:class:`~repro_torch.serving.memory.AdapterMemoryManager`): device
    slots hold the hot adapters (seg ids are slot ids), the registry stays
    in a host tier, and admission faults pages in, with the next wave
    prefetched one step ahead. ``hbm_slots`` (or
    ``store.hbm_budget_bytes``) bounds the pools; ``None`` keeps every
    adapter resident.

    ``mode="packed"``: all pending requests as one heterogeneous batch
    straight from packed codes (prefill at ``tile_t = SEG_TILE``, decode at
    ``tile_t = 1``). ``mode="materialize"``: the per-adapter loop over
    dequantized fp trees (the reference). All three mask pad slots and use
    real rotary positions, so they agree token for token for attention
    architectures. The recurrent mixers (RWKV, RG-LRU) carry pad tokens
    through their states, as the reference's do (the pad masks cover
    attention only): a left-padded row's tokens depend on its padded
    length, so the modes agree only where no request is padded. Inactive
    rows of the continuous decode advance junk states; admission
    overwrites a row's states. The engine runs on the device of
    ``base_params``.

    **Failure contract.** ``queue_limit`` bounds the pending queue
    (``queue_policy``: ``"reject"`` the new arrival or ``"shed_oldest"``
    queued request, with :class:`QueueFull`); ``default_deadline_ms`` is
    the total budget of requests that name none; ``faults`` /
    ``transport`` inject host-read faults and page corruption into the
    paged memory. ``telemetry`` records every lifecycle event, and
    ``clock`` (default: the telemetry's clock, else ``perf_counter``) is
    the one clock of deadlines and traces. Timestamps are taken after the
    step's host synchronization, so they include the device work.
    """

    MODES = ("continuous", "packed", "materialize")

    def __init__(self, model, base_params, store: AdapterStore,
                 cache_capacity: int = 512, mode: str = "continuous",
                 max_rows: int = 8, hbm_slots: Optional[int] = None,
                 queue_limit: Optional[int] = None,
                 queue_policy: str = "reject",
                 hol_bypass: bool = True, stall_limit: int = 3,
                 default_deadline_ms: Optional[float] = None,
                 faults: Optional[FaultPlan] = None,
                 transport: Optional[HostTransport] = None,
                 telemetry: Optional[Telemetry] = None,
                 clock=None):
        self._check_mode(mode)
        if queue_policy not in ("reject", "shed_oldest"):
            raise ValueError(f"queue_policy must be 'reject' or "
                             f"'shed_oldest', got {queue_policy!r}")
        self.model = model
        self.params = base_params         # {"base", "lora"(template)}
        self.store = store
        self.capacity = cache_capacity
        self.mode = mode
        self.max_rows = max_rows
        self.hbm_slots = hbm_slots
        self.queue_limit = queue_limit
        self.queue_policy = queue_policy
        self.hol_bypass = hol_bypass
        self.stall_limit = stall_limit
        self.default_deadline_ms = default_deadline_ms
        self.faults = faults
        self.transport = transport
        self.telemetry = telemetry
        self._spans = telemetry.spans if telemetry is not None else None
        base = base_params["base"]
        # the embedding table: every model has one (olmo's norms have no
        # weight)
        self.device = base["embed_tied" if "embed_tied" in base
                           else "embed"]["e"].device
        if clock is not None:
            self.clock = clock
        elif telemetry is not None:
            self.clock = telemetry.clock
        else:
            self.clock = time.perf_counter
        if telemetry is not None:
            telemetry.install_kernel_counter()
        self.pending: List[Request] = []
        # adapters quarantined at fault time: id -> store version then (a
        # re-register bumps the version and clears it)
        self.quarantined: Dict[str, Optional[int]] = {}
        # requests terminated outside step() (queue shedding), returned by
        # the next step so callers see every terminal request
        self._terminated: List[Request] = []
        self._wave = 0                    # prefill groups (admission waves)
        self._step_count = 0              # decode steps
        self._stalled_steps = 0
        self._rows: List[Optional[_Row]] = [None] * max_rows
        self._caches = None               # persistent (max_rows)-row caches
        self._memory = None               # paged adapter memory (lazy)
        self._dec_groups = None           # decode-retiled view of the pools
        self._dec_src = None              # the serving tree it was built from

    @staticmethod
    def _check_mode(mode: str):
        if mode not in MultiLoRAEngine.MODES:
            raise ValueError(f"unknown serving mode {mode!r}")

    # ----- request lifecycle -----

    def _finalize(self, req: Request, status: RequestStatus,
                  error: Optional[RequestError] = None) -> Request:
        """Move a request to a terminal state (with ``output`` set, possibly
        empty): the one place every terminal transition, and so the
        telemetry's retire event, goes through."""
        req.status = status
        req.error = error
        if req.output is None:
            req.output = np.zeros((0,), np.int32)
        if self.telemetry is not None:
            cause = error.kind if error is not None else "ok"
            self.telemetry.on_retire(req.request_id, status.name.lower(),
                                     cause, len(req.output))
        return req

    def _quarantine(self, adapter_id: str):
        self.quarantined[adapter_id] = self.store.version(adapter_id)

    def _is_quarantined(self, adapter_id: str) -> bool:
        """Quarantine is keyed to the registration version at fault time:
        a re-register (fixed upload) bumps the version and clears it."""
        if adapter_id not in self.quarantined:
            return False
        ver = self.store.version(adapter_id)
        if ver is not None and ver != self.quarantined[adapter_id]:
            del self.quarantined[adapter_id]
            return False
        return True

    @staticmethod
    def _queue_expired(req: Request,
                       now: float) -> Optional[DeadlineExceeded]:
        """Deadline check of a request still queued (no tokens yet): both
        the TTFT and the total budget bound the wait."""
        if req.t_submit is None:
            return None
        waited_ms = (now - req.t_submit) * 1e3
        for name, budget in (("ttft", req.ttft_deadline_ms),
                             ("total", req.deadline_ms)):
            if budget is not None and waited_ms > budget:
                return DeadlineExceeded(
                    f"request {req.request_id}: {name} deadline "
                    f"({budget:g} ms) expired after {waited_ms:.1f} ms in "
                    f"queue", adapter_id=req.adapter_id)
        return None

    def _unknown(self, req: Request) -> Request:
        return self._finalize(req, RequestStatus.REJECTED, UnknownAdapter(
            f"request {req.request_id}: adapter {req.adapter_id!r} is not "
            f"registered in the AdapterStore", adapter_id=req.adapter_id))

    def _poisoned(self, req: Request, why: str) -> Request:
        return self._finalize(req, RequestStatus.FAILED, PoisonedAdapter(
            f"request {req.request_id}: adapter {req.adapter_id!r} {why}",
            adapter_id=req.adapter_id))

    def _reject_now(self, req: Request) -> Optional[Request]:
        """Submit-time screening: a quarantined adapter FAILS, an unknown
        one is REJECTED; neither is enqueued."""
        if self._is_quarantined(req.adapter_id):
            return self._poisoned(req, "is quarantined")
        if req.adapter_id not in self.store.quantized:
            return self._unknown(req)
        return None

    def submit(self, req: Request) -> Request:
        """Enqueue a request, returning it with its (possibly already
        terminal) status. An unknown adapter id is REJECTED at once
        (:class:`UnknownAdapter`), a quarantined one FAILS
        (:class:`PoisonedAdapter`). With ``queue_limit`` a full queue
        rejects the new arrival (``"reject"``) or the oldest queued
        request (``"shed_oldest"``, returned by the next :meth:`step`)
        with :class:`QueueFull`."""
        if req.t_submit is None:
            req.t_submit = self.clock()
        if req.deadline_ms is None:
            req.deadline_ms = self.default_deadline_ms
        if self.telemetry is not None:
            self.telemetry.on_submit(req.request_id, req.adapter_id)
        if self._reject_now(req) is not None:
            return req
        if (self.queue_limit is not None
                and len(self.pending) >= self.queue_limit):
            if self.queue_policy == "reject":
                return self._finalize(req, RequestStatus.REJECTED, QueueFull(
                    f"request {req.request_id}: pending queue full "
                    f"({self.queue_limit})", adapter_id=req.adapter_id))
            shed = self.pending.pop(0)           # shed_oldest
            self._terminated.append(self._finalize(
                shed, RequestStatus.REJECTED, QueueFull(
                    f"request {shed.request_id}: shed by newer arrival "
                    f"under shed_oldest backpressure",
                    adapter_id=shed.adapter_id)))
        req.status = RequestStatus.PENDING
        self.pending.append(req)
        return req

    def _segments(self, reqs: Sequence[Request]) -> Dict[str, List[Request]]:
        segs: Dict[str, List[Request]] = collections.defaultdict(list)
        for r in reqs:
            segs[r.adapter_id].append(r)
        return segs

    def _tmax(self, reqs: Sequence[Request]) -> int:
        t = max(len(r.prompt) for r in reqs)
        return -(-t // SEG_TILE) * SEG_TILE

    # ----- static paths (one batch, drained to completion) -----

    def _generate(self, params_prefill, params_decode,
                  reqs: Sequence[Request], tmax: int) -> None:
        """Static greedy loop: left-pad to ``tmax`` (per-row ``start`` masks
        pad slots and shifts rotary positions), prefill once, decode to the
        longest request, slice each output."""
        dev = self.device
        toks = np.stack([np.pad(r.prompt, (tmax - len(r.prompt), 0))
                         for r in reqs]).astype(np.int64)
        starts = torch.as_tensor([tmax - len(r.prompt) for r in reqs],
                                 dtype=torch.int64, device=dev)
        logits, caches = self.model.prefill(
            params_prefill, {"tokens": torch.as_tensor(toks, device=dev),
                             "start": starts}, self.capacity)
        last = torch.argmax(logits[:, -1, :], dim=-1)
        if self.telemetry is not None and dev.type == "cuda":
            # TTFT is the first token's, not its enqueue's: the static
            # loop has no host read until the end
            torch.cuda.current_stream(dev).synchronize()
        now = self.clock()
        for r in reqs:
            r.t_first = now
            r.status = RequestStatus.RUNNING
            if self.telemetry is not None:
                self.telemetry.on_first_token(r.request_id)
        n_new = max(r.max_new_tokens for r in reqs)
        keep = [i for i, r in enumerate(reqs) if r.keep_logits]
        outs = [last]
        kept = [logits[keep, -1, :].float()] if keep else []
        b = len(reqs)
        for k in range(n_new - 1):
            pos = torch.full((b,), tmax + k, dtype=torch.int64, device=dev)
            logits, caches = self.model.decode_step(
                params_decode, last[:, None], caches, pos, starts)
            last = torch.argmax(logits[:, -1, :], dim=-1)
            outs.append(last)
            if keep:
                kept.append(logits[keep, -1, :].float())
        gen = torch.stack(outs, dim=1).cpu().numpy()      # (B, n_new)
        kept = torch.stack(kept, dim=1).cpu().numpy() if keep else None
        for i, r in enumerate(reqs):
            out = gen[i, : r.max_new_tokens].astype(np.int32)
            if r.eos_id is not None:
                hits = np.nonzero(out == r.eos_id)[0]
                if hits.size:
                    out = out[: hits[0] + 1]
            r.output = out
            if r.keep_logits:
                r.logits = kept[keep.index(i), : len(out)]
            self._finalize(r, RequestStatus.DONE)

    def _run_packed(self, reqs: List[Request]) -> List[Request]:
        """One heterogeneous batch decoded straight from packed codes."""
        ids = sorted({r.adapter_id for r in reqs})   # canonical → cache-stable
        aidx = torch.as_tensor([ids.index(r.adapter_id) for r in reqs],
                               dtype=torch.int32, device=self.device)
        tmax = self._tmax(reqs)
        packed = self.store.pack_batch(ids, self.params["lora"],
                                       tile_t=SEG_TILE)
        # prefill: each padded prompt is tmax rows (whole SEG_TILE tiles of
        # one adapter); decode: one row per sequence, tile_t = 1
        pre = {"base": self.params["base"],
               "lora": {"groups": packed["groups"],
                        "seg": aidx.repeat_interleave(tmax)}}
        dec = {"base": self.params["base"],
               "lora": {"groups": retile_packed(packed, 1)["groups"],
                        "seg": aidx}}
        self._generate(pre, dec, reqs, tmax)
        return reqs

    def _run_materialize(self, reqs: List[Request]) -> List[Request]:
        """Reference segment loop over dequantized fp trees (LRU-cached)."""
        tmax = self._tmax(reqs)
        for adapter_id, seg_reqs in self._segments(reqs).items():
            lora = self.store.materialize(adapter_id, self.params["lora"])
            params = {"base": self.params["base"], "lora": lora}
            self._generate(params, params, seg_reqs, tmax)
        return reqs

    # ----- continuous scheduler -----

    @property
    def memory(self):
        """The paged adapter memory behind continuous mode (built on first
        use, so a static-only engine never allocates a pool)."""
        if self._memory is None:
            from repro_torch.serving.memory import AdapterMemoryManager

            self._memory = AdapterMemoryManager(
                self.store, self.params["lora"], num_slots=self.hbm_slots,
                tile_t=SEG_TILE, device=self.device,
                transport=self.transport, faults=self.faults,
                telemetry=self.telemetry)
        return self._memory

    def memory_stats(self) -> Dict[str, Any]:
        """Hit / miss / swap / eviction counters and per-tier bytes of the
        paged adapter memory (empty before the first continuous step)."""
        return self._memory.stats() if self._memory is not None else {}

    def stats(self) -> Dict[str, Any]:
        """Scheduler counters as a view over the telemetry registry.

        Always the live state: queue depth, active rows, quarantined
        adapters, decode steps and prefill groups (admission waves) so far.
        With a :class:`Telemetry` also the submitted and token totals,
        terminal counts by status and by cause, and the p50/p95/p99
        summaries of TTFT, E2E and queue wait (``None`` percentiles while a
        histogram is empty); the engine keeps no shadow counters."""
        out: Dict[str, Any] = {
            "pending": len(self.pending),
            "active_rows": self.active_rows,
            "quarantined": len(self.quarantined),
            "decode_steps": self._step_count,
            "admission_waves": self._wave,
        }
        if self.telemetry is None:
            return out
        reg = self.telemetry.registry
        out["submitted"] = int(reg.value("serving_requests_submitted_total"))
        out["tokens"] = int(reg.value("serving_tokens_total"))
        by_status: Dict[str, int] = {}
        by_cause: Dict[str, int] = {}
        for m in reg.series("serving_requests_total"):
            labels = dict(m.labels)
            st, cause = labels.get("status", ""), labels.get("cause", "")
            by_status[st] = by_status.get(st, 0) + int(m.value)
            by_cause[cause] = by_cause.get(cause, 0) + int(m.value)
        out["finished"] = by_status
        out["retire_causes"] = by_cause
        out["latency"] = self.telemetry.latency_summary()
        return out

    def _tpad(self, req: Request) -> int:
        return max(SEG_TILE, -(-len(req.prompt) // SEG_TILE) * SEG_TILE)

    def _admit_group(self, reqs: List[Request], rows: List[int],
                     slots: List[int]) -> List[_Row]:
        """Prefill a group of same-padded-length requests as one batch and
        copy their cache rows into the persistent batch cache. ``slots``
        are the requests' (pinned) global slot ids, the SGMV seg ids; a
        page swapped in for this group is ordered before the prefill on the
        stream. One host synchronization: the first tokens' read."""
        dev = self.device
        tpad = self._tpad(reqs[0])
        sidx = np.asarray(slots, np.int64)
        starts = np.asarray([tpad - len(r.prompt) for r in reqs], np.int64)
        toks = np.stack([np.pad(np.asarray(r.prompt), (tpad - len(r.prompt), 0))
                         for r in reqs]).astype(np.int64)
        self._wave += 1
        tel, sp = self.telemetry, self._spans
        if tel is not None:
            for req, row_idx in zip(reqs, rows):
                tel.on_admit(req.request_id, self._wave, row_idx)
        t_pre = self.clock()
        t = sp and sp.begin(_PREFILL)
        # fetch the tree AFTER the acquires: this group's swap-ins are in it
        packed = self.memory.serving_tree()
        pre = {"base": self.params["base"],
               "lora": {"groups": packed["groups"],
                        "seg": upload(np.repeat(sidx, tpad), dev)}}
        logits, grp = self.model.prefill(
            pre, {"tokens": upload(toks, dev), "start": upload(starts, dev)},
            self.capacity)
        keep = any(r.keep_logits for r in reqs)
        firsts = torch.argmax(logits[:, -1, :], dim=-1).cpu().numpy()
        first_logits = logits[:, -1, :].float().cpu().numpy() if keep else None
        now = self.clock()
        if sp:
            sp.end(_PREFILL, t, self._wave)
        if tel is not None:
            self.memory.resolve_copy_timers()
            tel.on_prefill(self._wave, [r.request_id for r in reqs],
                           int(tpad), now - t_pre)
        # cache rows land on axis 1 of every (count, B, ...) leaf (rwkv's
        # nest a level deeper, under "tmix" / "cmix"); the group's caches
        # have this engine's capacity, so ring slots line up with the
        # persistent cache's
        t = sp and sp.begin(_CACHE_COPY)
        _copy_rows(self._caches, grp, upload(np.asarray(rows, np.int64), dev))
        if sp:
            sp.end(_CACHE_COPY, t, self._wave)
        out = []
        for b, (req, row_idx) in enumerate(zip(reqs, rows)):
            req.t_first = now
            req.status = RequestStatus.RUNNING
            if tel is not None:
                tel.on_first_token(req.request_id)
            row = _Row(req=req, start=int(starts[b]),
                       prompt_len=len(req.prompt), emitted=[int(firsts[b])],
                       logits=[first_logits[b]] if req.keep_logits else None)
            self._rows[row_idx] = row
            out.append(row)
        return out

    @staticmethod
    def _row_done(row: _Row) -> bool:
        r = row.req
        return (len(row.emitted) >= r.max_new_tokens
                or (r.eos_id is not None and row.emitted[-1] == r.eos_id))

    def _retire(self, row_idx: int,
                status: RequestStatus = RequestStatus.DONE,
                error: Optional[RequestError] = None) -> Request:
        row = self._rows[row_idx]
        self._rows[row_idx] = None
        self.memory.unpin(row.req.adapter_id)   # slot becomes evictable
        # prefill always seeds one token; cap at the budget so that
        # max_new_tokens <= 0 matches the static modes' empty output
        n = max(row.req.max_new_tokens, 0)
        row.req.output = np.asarray(row.emitted[:n], np.int32)
        if row.logits is not None:
            row.req.logits = np.stack(row.logits[:len(row.req.output)])
        return self._finalize(row.req, status, error)

    def _prefetch_upcoming(self):
        """Stage the next admission wave's pages one step ahead: called
        after this step's seg ids and decode view, before the decode."""
        upcoming: List[str] = []
        seen = set()
        for r in self.pending[: self.max_rows]:
            if (r.adapter_id not in seen
                    and r.adapter_id in self.store.quantized
                    and not self._is_quarantined(r.adapter_id)):
                seen.add(r.adapter_id)
                upcoming.append(r.adapter_id)
        if upcoming:
            self.memory.prefetch(upcoming)

    def _select_admissions(self, n_free: int,
                           finished: List[Request]) -> List[Request]:
        """This step's admission group from the pending queue: FIFO, with
        quarantined adapters FAILED and unregistered ones REJECTED (neither
        takes a row); requests padding to another length than the group's
        first wait for the next wave. ``memory.acquire`` pins each admitted
        adapter's page: a poisoned page quarantines the adapter and FAILS
        the request, a failed host read REJECTS it
        (:class:`MemoryExhausted`), and an all-pinned pool stalls the wave
        (with ``hol_bypass``, requests for resident adapters may pass the
        stalled head). Slot ids are read after the whole group's acquires
        (a later acquire may grow a pool and shift earlier global ids)."""
        mgr = self.memory
        group: List[Request] = []
        rest: List[Request] = []
        tpad0: Optional[int] = None
        stalled = False
        for k, r in enumerate(self.pending):
            if len(group) >= n_free:
                rest.extend(self.pending[k:])
                break
            if self._is_quarantined(r.adapter_id):
                finished.append(self._poisoned(r, "is quarantined"))
                continue
            if r.adapter_id not in self.store.quantized:
                finished.append(self._unknown(r))
                continue
            if tpad0 is not None and self._tpad(r) != tpad0:
                rest.append(r)
                continue
            if stalled and not (self.hol_bypass
                                and mgr.resident(r.adapter_id)):
                rest.append(r)
                continue
            try:
                slot = mgr.acquire(r.adapter_id)
            except PoisonedAdapter as e:
                self._quarantine(r.adapter_id)
                finished.append(self._finalize(r, RequestStatus.FAILED, e))
                continue
            except HostReadError as e:
                finished.append(self._finalize(
                    r, RequestStatus.REJECTED, MemoryExhausted(
                        str(e), adapter_id=r.adapter_id)))
                continue
            if slot is None:
                stalled = True             # every slot pinned right now
                rest.append(r)
                continue
            if tpad0 is None:
                tpad0 = self._tpad(r)
            group.append(r)
        self.pending = rest
        return group

    def step(self) -> List[Request]:
        """Advance the continuous scheduler by one decode step.

        0. **Sweep**: requests shed at submit time are returned; queued
           requests past their TTFT or total deadline retire TIMED_OUT;
           adapters whose pages failed the integrity check are quarantined
           and their live rows retire FAILED; live rows past their total
           deadline retire TIMED_OUT with their partial output.
        1. **Admit** pending requests into free rows
           (:meth:`_select_admissions`; each group is one prefill; a
           request done at admission frees its row at once). If nothing is
           live to ever unpin a slot, ``stall_limit`` fruitless steps
           reject the queue's head with :class:`MemoryExhausted`.
        2. **Decode** one step for all ``max_rows`` rows: per-row cache
           positions and validity, per-row global slot ids as seg ids,
           inactive rows fully masked. The next wave's pages are prefetched
           after the seg ids are read and before the decode is enqueued.
           One host synchronization: the argmax read.
        3. **Retire** rows at ``max_new_tokens`` / ``eos_id``: the row and
           its adapter's pin are released.

        Returns the requests that reached a terminal state in this step,
        in completion order. With a telemetry each phase is a raw span
        (``engine.sweep``, ``engine.admit``, ``engine.decode.prep`` /
        ``.launch`` / ``.sync``, ``engine.retire``) inside ``engine.step``,
        all with the number of the decode step this call makes (a call
        that decodes nothing shares it with the next); a call with nothing
        to do records none."""
        finished: List[Request] = list(self._terminated)
        self._terminated = []
        if not self.pending and all(r is None for r in self._rows):
            return finished
        sp = self._spans
        n_step = self._step_count + 1
        t_whole = sp and sp.begin(_STEP)
        t = sp and sp.begin(_SWEEP)
        mgr = self.memory
        mgr.refresh()                      # reconcile store mutations
        t_step = now = self.clock()
        still: List[Request] = []
        for r in self.pending:
            err = self._queue_expired(r, now)
            if err is not None:
                finished.append(
                    self._finalize(r, RequestStatus.TIMED_OUT, err))
            else:
                still.append(r)
        self.pending = still
        # drain the memory layer's integrity failures into quarantine,
        # skipping adapters re-registered since, and fail their live rows
        while mgr.poisoned:
            aid, ver = mgr.poisoned.popitem()
            if self.store.version(aid) == ver:
                self.quarantined[aid] = ver
        for i in range(self.max_rows):
            row = self._rows[i]
            if row is None:
                continue
            req = row.req
            if self._is_quarantined(req.adapter_id):
                finished.append(self._retire(
                    i, RequestStatus.FAILED, PoisonedAdapter(
                        f"request {req.request_id}: adapter "
                        f"{req.adapter_id!r} was quarantined mid-decode",
                        adapter_id=req.adapter_id)))
                continue
            if (req.deadline_ms is not None and req.t_submit is not None
                    and (now - req.t_submit) * 1e3 > req.deadline_ms):
                finished.append(self._retire(
                    i, RequestStatus.TIMED_OUT, DeadlineExceeded(
                        f"request {req.request_id}: total deadline "
                        f"({req.deadline_ms:g} ms) expired mid-decode",
                        adapter_id=req.adapter_id)))
        if self._caches is None:
            self._caches = self.model.init_cache(self.max_rows, self.capacity,
                                                 device=self.device)
        if sp:
            sp.end(_SWEEP, t, n_step)
            t = sp.begin(_ADMIT)
        admitted_any = False
        while self.pending:
            free = [i for i in range(self.max_rows) if self._rows[i] is None]
            if not free:
                break
            t_sel = sp and sp.begin(_SELECT)
            group = self._select_admissions(len(free), finished)
            if sp:
                sp.end(_SELECT, t_sel, self._wave + 1)
            if not group:
                break
            admitted_any = True
            slots = [mgr.slot_of(r.adapter_id) for r in group]
            rows = free[:len(group)]
            for row_idx, row in zip(rows,
                                    self._admit_group(group, rows, slots)):
                if self._row_done(row):
                    finished.append(self._retire(row_idx))
        if sp:
            sp.end(_ADMIT, t, n_step)
        active = [i for i in range(self.max_rows) if self._rows[i] is not None]
        if not active:
            if self.pending and not admitted_any and not finished:
                # nothing live to ever unpin a slot: bounded patience, then
                # shed the head so run() never spins forever
                self._stalled_steps += 1
                if self._stalled_steps >= self.stall_limit:
                    head = self.pending.pop(0)
                    finished.append(self._finalize(
                        head, RequestStatus.REJECTED, MemoryExhausted(
                            f"request {head.request_id}: no device slot "
                            f"became available after {self._stalled_steps} "
                            f"stalled steps (pool fully pinned)",
                            adapter_id=head.adapter_id)))
                    self._stalled_steps = 0
            else:
                self._stalled_steps = 0
            self._prefetch_upcoming()
            if sp:
                sp.end(_STEP, t_whole, n_step)
            return finished
        self._stalled_steps = 0
        t = sp and sp.begin(_PREP)
        # rows of (tokens, pos, start, seg), one upload; inactive rows:
        # start == capacity masks every cache slot, seg 0
        inp = np.zeros((4, self.max_rows), np.int64)
        inp[2] = self.capacity
        for i in active:
            row = self._rows[i]
            inp[0, i] = row.emitted[-1]
            inp[1, i] = row.start + row.prompt_len + len(row.emitted) - 1
            inp[2, i] = row.start
            # seg ids ARE global slot ids, re-read every step (an earlier
            # pool's growth shifts them) and BEFORE the prefetch below
            inp[3, i] = mgr.slot_of(row.req.adapter_id)
        packed = mgr.serving_tree()
        # the tile_t = 1 view is rebuilt only when the tree changed (a
        # swap-in or resize drops the cached tree; the strong reference in
        # _dec_src makes identity a safe key)
        if self._dec_src is not packed:
            t_view = sp and sp.begin(_VIEW)
            self._dec_groups = retile_packed(packed, 1)["groups"]
            self._dec_src = packed
            if sp:
                sp.end(_VIEW, t_view, n_step)
        buf = upload(inp, self.device)
        dec = {"base": self.params["base"],
               "lora": {"groups": self._dec_groups, "seg": buf[3]}}
        # stage the next wave now: its page copies go on the stream before
        # the decode and touch only slots no active row reads
        self._prefetch_upcoming()
        if sp:
            sp.end(_PREP, t, n_step)
            t = sp.begin(_LAUNCH)
        logits, self._caches = self.model.decode_step(
            dec, buf[0][:, None], self._caches, buf[1], buf[2])
        if sp:
            sp.end(_LAUNCH, t, n_step)
            t = sp.begin(_SYNC)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).cpu().numpy()
        kept = None
        if any(self._rows[i].logits is not None for i in active):
            kept = logits[:, -1, :].float().cpu().numpy()
        if sp:
            sp.end(_SYNC, t, n_step)
            t = sp.begin(_RETIRE)
        self._step_count += 1
        if self.telemetry is not None:
            mgr.resolve_copy_timers()
            self.telemetry.on_decode_step(
                self._step_count, self.clock() - t_step, len(active),
                self.max_rows, len(self.pending),
                request_ids=[self._rows[i].req.request_id for i in active])
        for i in active:
            row = self._rows[i]
            row.emitted.append(int(nxt[i]))
            if row.logits is not None:
                row.logits.append(kept[i])
            if self._row_done(row):
                finished.append(self._retire(i))
        if sp:
            sp.end(_RETIRE, t, n_step)
            sp.end(_STEP, t_whole, n_step)
        return finished

    @property
    def active_rows(self) -> int:
        return sum(r is not None for r in self._rows)

    def _screen_static(self, reqs: List[Request],
                       done: List[Request]) -> List[Request]:
        """The failure contract of a static batch, before decoding: unknown
        adapters REJECT, quarantined ones FAIL, expired deadlines TIME OUT;
        and, since the static paths read codes straight from the store (no
        page check), each adapter's codes are integrity-screened once: a
        poisoned adapter is quarantined and its requests FAIL without
        touching the rest of the batch."""
        now = self.clock()
        healthy: List[Request] = []
        for r in reqs:
            if self._reject_now(r) is not None:
                done.append(r)
                continue
            err = self._queue_expired(r, now)
            if err is not None:
                done.append(self._finalize(r, RequestStatus.TIMED_OUT, err))
                continue
            healthy.append(r)
        for aid in sorted({r.adapter_id for r in healthy}):
            if not self.store.check_integrity(aid):
                self._quarantine(aid)
        out: List[Request] = []
        for r in healthy:
            if self._is_quarantined(r.adapter_id):
                done.append(self._poisoned(r, "failed the integrity screen"))
            else:
                out.append(r)
        return out

    def run(self, mode: Optional[str] = None) -> List[Request]:
        """Process all pending requests to a terminal state and return them
        (continuous mode in completion order, static modes in submission
        order after the screened-out ones)."""
        mode = mode or self.mode
        self._check_mode(mode)
        done: List[Request] = []
        if mode == "continuous":
            while self.pending or self.active_rows or self._terminated:
                done.extend(self.step())
            return done
        done.extend(self._terminated)      # queue-shed before a static run
        self._terminated = []
        if self.active_rows:
            # a static run must not strand requests mid-decode in the
            # scheduler's rows: drain them first, without admitting the
            # pending batch, which belongs to the static run
            held, self.pending = self.pending, []
            while self.active_rows:
                done.extend(self.step())
            self.pending = held
        reqs, self.pending = self.pending, []
        healthy = self._screen_static(reqs, done)
        if not healthy:
            return done
        if mode == "packed":
            return done + self._run_packed(healthy)
        return done + self._run_materialize(healthy)
