"""Multi-LoRA serving engine (port of ``repro/serving/engine.py``, static
modes).

* :class:`AdapterStore` holds many adapters LoRAQuant-quantized, each under
  its own recipe, and serves them in two forms: **packed**
  (:meth:`AdapterStore.pack_batch`, a LoRA tree whose leaves are
  :class:`~repro_torch.kernels.PackedLoRABatch` stacks — or, for a
  mixed-recipe batch, :class:`~repro_torch.kernels.PackedLoRABuckets` of
  one stack per layout — read straight from the codes by the ``sgmv_fused``
  kernel) and
  **materialize** (:meth:`AdapterStore.materialize`, dequantized fp trees
  through a byte-budgeted LRU — the reference path).
* :class:`MultiLoRAEngine` serves all pending requests as one batch:
  ``mode="packed"`` runs one heterogeneous left-padded batch from packed
  codes (prefill at ``tile_t = SEG_TILE = 8``, decode at ``tile_t = 1``);
  ``mode="materialize"`` loops over adapters with dequantized fp trees.
  Both mask pad slots and use real rotary positions, so they agree token
  for token.

Not ported yet: ``mode="continuous"`` with the paged adapter memory
(ROADMAP A7); telemetry, deadlines, queue limits and quarantine (A8).
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
    RequestError,
    RequestStatus,
    UnknownAdapter,
    validate_lora_tree,
)

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
    an adapter outright.
    """

    def __init__(self, default_recipe: Optional[QuantRecipe] = None,
                 fp_cache_bytes: int = 1 << 30,
                 batched_quantize: bool = True):
        self.default_recipe = (default_recipe if default_recipe is not None
                               else QuantRecipe())
        self.quantized: Dict[str, QuantizedAdapter] = {}
        self.fp_cache_bytes = fp_cache_bytes
        self.batched_quantize = batched_quantize
        self._lru: "collections.OrderedDict[str, Any]" = \
            collections.OrderedDict()
        self._packed: Dict[str, Dict[str, PackedLoRABatch]] = {}
        self._batch_cache: Dict[tuple, Any] = {}
        self._versions: Dict[str, int] = {}
        self._mutations = 0
        self.onboard_errors: Dict[str, str] = {}   # last register_many skips

    def _invalidate(self, adapter_id: str):
        self._lru.pop(adapter_id, None)
        self._packed.pop(adapter_id, None)
        self._batch_cache.clear()

    def _bump(self, adapter_id: str):
        self._mutations += 1
        self._versions[adapter_id] = self._mutations

    def version(self, adapter_id: str) -> Optional[int]:
        return self._versions.get(adapter_id)

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
        mismatch → :class:`AdapterValidationError`)."""
        if validate:
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
        }

    def adapter_stats(self) -> Dict[str, Dict[str, Any]]:
        return {aid: {"avg_bits": qa.avg_bits(),
                      "recipe": self.recipe_of(aid).variant_name}
                for aid, qa in self.quantized.items()}


@dataclasses.dataclass
class Request:
    """One generation request with its lifecycle state."""

    request_id: int
    adapter_id: str
    prompt: np.ndarray          # (T,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    keep_logits: bool = False   # fill ``logits`` (parity checks across modes)
    output: Optional[np.ndarray] = None
    logits: Optional[np.ndarray] = None   # (len(output), vocab) fp32
    t_first: Optional[float] = None
    t_submit: Optional[float] = None
    status: RequestStatus = RequestStatus.PENDING
    error: Optional[RequestError] = None


class MultiLoRAEngine:
    """Serves many users' adapters in one batch (the static modes of the
    JAX engine). ``mode="packed"`` decodes straight from packed codes;
    ``mode="materialize"`` is the per-adapter fp reference; the JAX
    default ``mode="continuous"`` raises until ROADMAP A7 ports it.
    The engine runs on the device of ``base_params``."""

    MODES = ("packed", "materialize")

    def __init__(self, model, base_params, store: AdapterStore,
                 cache_capacity: int = 512, mode: str = "packed"):
        self._check_mode(mode)
        self.model = model
        self.params = base_params         # {"base", "lora"(template)}
        self.store = store
        self.capacity = cache_capacity
        self.mode = mode
        self.pending: List[Request] = []
        self.device = base_params["base"]["final_norm"]["w"].device

    @staticmethod
    def _check_mode(mode: str):
        if mode == "continuous":
            raise NotImplementedError(
                "mode='continuous' (the continuous-batching scheduler over "
                "the paged adapter memory) is not ported yet (ROADMAP A7); "
                "use mode='packed' or 'materialize'")
        if mode not in MultiLoRAEngine.MODES:
            raise ValueError(f"unknown serving mode {mode!r}")

    def _finalize(self, req: Request, status: RequestStatus,
                  error: Optional[RequestError] = None) -> Request:
        req.status = status
        req.error = error
        if req.output is None:
            req.output = np.zeros((0,), np.int32)
        return req

    def submit(self, req: Request) -> Request:
        """Enqueue a request; an unknown adapter id is REJECTED at once with
        :class:`UnknownAdapter`."""
        if req.t_submit is None:
            req.t_submit = time.perf_counter()
        if req.adapter_id not in self.store.quantized:
            return self._finalize(req, RequestStatus.REJECTED, UnknownAdapter(
                f"request {req.request_id}: adapter {req.adapter_id!r} is "
                f"not registered in the AdapterStore",
                adapter_id=req.adapter_id))
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
        now = time.perf_counter()
        for r in reqs:
            r.t_first = now
            r.status = RequestStatus.RUNNING
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

    def run(self, mode: Optional[str] = None) -> List[Request]:
        """Process all pending requests to a terminal state and return them
        in submission order."""
        mode = mode or self.mode
        self._check_mode(mode)
        reqs, self.pending = self.pending, []
        done: List[Request] = []
        healthy = []
        for r in reqs:        # an adapter unregistered since submit
            if r.adapter_id in self.store.quantized:
                healthy.append(r)
            else:
                done.append(self._finalize(
                    r, RequestStatus.REJECTED, UnknownAdapter(
                        f"request {r.request_id}: adapter {r.adapter_id!r} "
                        f"is not registered", adapter_id=r.adapter_id)))
        if not healthy:
            return done
        if mode == "packed":
            return done + self._run_packed(healthy)
        return done + self._run_materialize(healthy)
