"""Decoder-LM assembly (port of ``repro/models/model.py``) for the dense
GQA family and its variants, the sparse-MoE family with sliding-window
attention, deepseek's MLA with its shared expert and int8 expert base,
and the recurrent families (``attn`` / ``local_attn`` / ``mla`` /
``rglru`` / ``rwkv`` mixers, ``dense`` / ``moe`` / ``rwkv_cm``
feed-forwards): stacked ``(L, ...)`` layer params walked by a Python loop
over layers, LoRA trees mirroring every targeted linear, and the prefill /
decode-with-cache modes the serving engine drives.

Parameter tree, as in the JAX package::

    {"base": {"embed": {"e"}, "head": {"e"}, "final_norm": {"w"},
              "groups": [{"sub_0": {"mixer": {"wq": {"w"}, ...},
                                    "mixer_norm": {"w"},
                                    "ffn": {"wg": {"w"}, ...},
                                    "ffn_norm": {"w"}}}]},
     "lora": {"groups": [{"sub_0": {"mixer": {"wq": {"a", "b"}, ...},
                                    "ffn": {"wg": {"a", "b"}, ...}}}]}}

The dense variants change it as the reference does: a tied table is
``"embed_tied"`` (no ``"head"``); a norm is ``{}`` for olmo's
``nonparam_ln`` and ``{"w": 0}`` for gemma2's ``rmsnorm_plus1``, whose
sub-blocks also carry ``post_mixer_norm`` / ``post_ffn_norm``; musicgen's
``n_codebooks`` tables and heads are stacked ``{"e": (K, V, d)}``.

An ``moe`` feed-forward has ``{"router": {"w"} (fp32), "experts": {"wg":
{"w"}, ...}}`` with expert stacks ``(L, E, ·, ·)``, and LoRA leaves
``"router"`` ``(L, r, ·)`` and ``"experts"`` ``{"wg": {"a", "b"}, ...}``
``(L, E, r, ·)``. deepseek's MoE also has a ``"shared"`` dense expert
(base and LoRA), its expert stacks are ``{"w": int8, "scale": fp32 (L, E,
1, ·)}``, an ``mla`` mixer has ``wq_down`` / ``wq_up`` / ``wkv_down`` /
``wk_rope`` / ``wk_up`` / ``wv_up`` / ``wo`` and the ``q_norm`` /
``kv_norm`` norms (LoRA on ``wq_down``, ``wq_up``, ``wkv_down``, ``wo``),
and ``base["mtp"]`` holds the multi-token-prediction head's ``norm`` and
``proj`` ``(2d, d)``.

The recurrent mixers (``models/recurrent.py``) have their own leaves: an
``rwkv`` time mix ``mu_base``, ``mu``, ``ddlerp_w1`` / ``ddlerp_w2``,
``decay_base`` / ``decay_w1`` / ``decay_w2``, ``bonus``, ``gn_w`` /
``gn_b`` (fp32) and ``wr`` / ``wk`` / ``wv`` / ``wg`` / ``wo`` with LoRA;
an ``rwkv_cm`` channel mix ``mu_k`` / ``mu_r`` and ``wk`` / ``wv`` /
``wr`` with LoRA; an ``rglru`` block ``w_in`` / ``w_gate`` / ``w_out``
with LoRA and the fp32 ``conv_w`` / ``conv_b`` / ``lambda_p`` / ``w_ix``
/ ``w_ax``.

Three execution modes, as in the reference: the sequence forward and
training loss (:meth:`Model.forward`, :meth:`Model.train_loss`; autograd on,
each layer optionally recomputed on the backward pass when ``remat``) and
the prefill / decode-with-cache modes the serving engine drives (no
autograd).

Under a mesh (``Model.mesh``: data parallelism over its data axes, tensor
parallelism over ``model``) each rank holds its rows of the batch and every
leaf as ``local_block`` of the reference's rule table
(:meth:`Model.param_specs`), and runs the explicit program
(``parallel.tensor``): each linear column- or row-parallel as its spec
says, the frozen base all-gathered over the data axes before use, attention
and the recurrent mixers on their heads or channels, each moe layer on the
expert path of ``ffn.moe_ffn``, the embedding a masked lookup in the
rank's vocab rows plus an all-reduce, and the logits and the CE
vocab-parallel. Decode caches are held as ``cache_specs`` places them. The
reference's ``_constrain_act`` is not ported: it only hints XLA where to
lay activations out (``with_sharding_constraint``); a rank here holds its
rows by construction.

A LoRA leaf may also be applied straight from packed codes: a
layer-stacked :class:`~repro_torch.core.QuantizedLoRA` (one adapter for the
whole batch; every array carries the leading ``(L,)`` axis and all layers
share one split ``h``), a :class:`~repro_torch.kernels.PackedLoRABatch`
stack of many adapters, or a :class:`~repro_torch.kernels.PackedLoRABuckets`
of such stacks, one per recipe layout; a serving engine puts the per-row
adapter index of the last two at ``lora["seg"]``.

While ``torch.profiler`` records, the forward's parts are host ranges
(:func:`~repro_torch.spans.profiler_range`): ``model.embed``, each layer's
``model.layer`` holding its ``model.attn`` and ``model.ffn``, and
``model.logits``; a profile's idle gaps fall under them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.core.loraquant import QuantizedLoRA
from repro_torch.kernels.quant_matmul import (PackedLoRABatch,
                                               PackedLoRABuckets)
from repro_torch.kernels.quant_matmul.ops import qlora_layer
from repro_torch.optim.adamw import (tree_map, tree_map_with_path,
                                     tree_paths)
from repro_torch.parallel.collectives import (all_reduce_max,
                                              copy_to_region,
                                              gather_from_region,
                                              reduce_from_region)
from repro_torch.parallel.sharding import (cache_specs, live, local_block,
                                           spec_for)
from repro_torch.parallel.tensor import TensorParallel, annotate
from repro_torch.spans import profiler_range

from . import attention as attn_mod
from . import ffn as ffn_mod
from . import recurrent as rec_mod
from .common import (apply_norm, embed, init_embedding, init_linear,
                     init_norm, softcap, unembed)

Params = Dict[str, Any]


def _init_mixer(gen, cfg, kind: str, lora_rank, count: int):
    if kind in ("attn", "local_attn"):
        return attn_mod.init_gqa(gen, cfg, lora_rank, count)
    if kind == "mla":
        return attn_mod.init_mla(gen, cfg, lora_rank, count)
    if kind == "rglru":
        return rec_mod.init_rglru(gen, cfg, lora_rank, count)
    if kind == "rwkv":
        return rec_mod.init_rwkv_tmix(gen, cfg, lora_rank, count)
    raise ValueError(kind)


def _init_ffn(gen, cfg, kind: str, lora_rank, count: int):
    if kind == "dense":
        return ffn_mod.init_dense_ffn(gen, cfg, lora_rank, count)
    if kind == "moe":
        return ffn_mod.init_moe(gen, cfg, lora_rank, count)
    if kind == "rwkv_cm":
        return rec_mod.init_rwkv_cmix(gen, cfg, lora_rank, count)
    raise ValueError(kind)


def _write_state(dst, src):
    """Copy a recurrent mixer's new state into the cache views it was
    handed (the caches are updated in place)."""
    for k, v in src.items():
        if isinstance(v, dict):
            _write_state(dst[k], v)
        else:
            dst[k].copy_(v)


def _spec_layer(specs):
    """A stacked group's spec tree as one layer's leaves have it."""
    if isinstance(specs, dict):
        return {k: _spec_layer(v) for k, v in specs.items()}
    return specs[1:]


def _layer_slice(tree, i: int):
    """Layer ``i`` of a stacked tree: every tensor ``t[i]``, every packed
    leaf (buckets and their lookups included) its per-layer view (its
    ``seg`` stays per row), every ``QuantizedLoRA`` entry ``i`` of each
    array, its metadata and kernel layouts kept (what ``lax.scan``
    hands the JAX model's layer body)."""
    if isinstance(tree, (PackedLoRABatch, PackedLoRABuckets)):
        return tree.layer(i)
    if isinstance(tree, QuantizedLoRA):
        return qlora_layer(tree, i)
    if isinstance(tree, dict):
        return {k: _layer_slice(v, i) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return tree


class _MetaGenerator(torch.Generator):
    """A CPU generator that reports the meta device, so the init functions
    (which allocate on ``gen.device``) build meta tensors; random fills of
    a meta tensor are no-ops."""

    @property
    def device(self):
        return torch.device("meta")


@dataclasses.dataclass
class Model:
    cfg: Any
    # recompute each layer's activations on the backward pass (train
    # memory: store only layer-boundary activations)
    remat: bool = False
    # the attention algorithm: None picks blockwise above
    # ``attention.BLOCKWISE_THRESHOLD`` tokens, True / False force it
    force_blockwise: Any = None
    # RWKV's sequence-mode chunk (a prefill of T tokens needs T % min(
    # rwkv_chunk, T) == 0, as in the reference)
    rwkv_chunk: int = 64
    # a mesh (``repro_torch.launch.mesh.HostMesh``) over ("data", "model")
    # or ("pod", "data", "model"), or None: a single device
    mesh: Any = None

    def __post_init__(self):
        self._tp = None
        self._spec_table = None
        # the decode graphs armed for the next decode_step call, or None
        self._armed = None

    @property
    def tp(self):
        """This rank's :class:`~repro_torch.parallel.tensor.TensorParallel`
        under a mesh of more than one rank, else None."""
        if self.mesh is None or int(np.prod(list(
                self.mesh.shape.values()))) == 1:
            return None
        if self._tp is None:
            self._tp = TensorParallel(self.mesh)
        return self._tp

    @property
    def scaling(self) -> float:
        return self.cfg.lora_alpha / self.cfg.lora_rank

    # ----- init -----

    def init(self, seed: int = 0, device="cuda") -> Params:
        """Random params from a ``torch.Generator`` seeded with ``seed`` on
        ``device`` (the card unless the caller asks for the CPU); on
        ``"meta"`` the tree's paths, shapes and dtypes without storage."""
        cfg = self.cfg
        dev = resolve_device(device)
        gen = (_MetaGenerator() if dev.type == "meta"
               else torch.Generator(device=dev))
        gen.manual_seed(seed)
        embed_key = "embed_tied" if cfg.tie_embeddings else "embed"
        base: Params = {embed_key: self._init_table(gen),
                        "final_norm": init_norm(cfg.d_model, cfg.norm,
                                                device=dev)}
        if not cfg.tie_embeddings:
            base["head"] = self._init_table(gen)
        if cfg.mtp:
            base["mtp"] = {"norm": init_norm(cfg.d_model, cfg.norm,
                                             device=dev),
                           "proj": init_linear(gen, 2 * cfg.d_model,
                                               cfg.d_model, cfg.dtype)}
        base["groups"] = []
        lora: Params = {"groups": []}
        for block in cfg.blocks:
            gb, gl = {}, {}
            for j, (mk, fk) in enumerate(zip(block.pattern, block.ffn)):
                mb, ml = _init_mixer(gen, cfg, mk, cfg.lora_rank,
                                     block.count)
                fb, fl = _init_ffn(gen, cfg, fk, cfg.lora_rank, block.count)
                names = ["mixer_norm", "ffn_norm"] + (
                    ["post_mixer_norm", "post_ffn_norm"] if cfg.post_norm
                    else [])
                gb[f"sub_{j}"] = {"mixer": mb, "ffn": fb, **{
                    n: init_norm(cfg.d_model, cfg.norm, (block.count,), dev)
                    for n in names}}
                gl[f"sub_{j}"] = {"mixer": ml, "ffn": fl}
            base["groups"].append(gb)
            lora["groups"].append(gl)
        return {"base": base, "lora": lora}

    def _init_table(self, gen) -> Params:
        """One embedding table, or ``n_codebooks`` of them stacked."""
        cfg = self.cfg
        if not cfg.n_codebooks:
            return init_embedding(gen, cfg.vocab, cfg.d_model, cfg.dtype)
        return {"e": torch.stack([
            init_embedding(gen, cfg.vocab, cfg.d_model, cfg.dtype)["e"]
            for _ in range(cfg.n_codebooks)])}

    # ----- placement under a mesh -----

    def param_specs(self, tree):
        """The spec of every leaf of a params tree (or of its LoRA or
        gradient subtree, whose paths are looked up under ``['lora']``)
        under :attr:`mesh`: the reference's rule table on the leaf's
        global shape, without the axes of size 1. Every leaf is placed so,
        the expert stacks as the reference's ``shard_map`` takes them."""
        if self.mesh is None:
            return tree_map(lambda t: (None,) * t.dim(), tree)
        if self._spec_table is None:
            self._spec_table = {
                p: live(spec_for(p, tuple(t.shape), self.mesh), self.mesh)
                for p, t in tree_paths(self.init(device="meta"))}
        table = self._spec_table

        def one(path, leaf):
            for p in (path, "['lora']" + path):
                if p in table:
                    return table[p]
            return live(spec_for(path, tuple(leaf.shape), self.mesh),
                        self.mesh)

        return tree_map_with_path(one, tree)

    def local_params(self, params):
        """This rank's blocks (copies) of a global params tree."""
        if self.tp is None:
            return params
        return tree_map(
            lambda t, s: local_block(t, s, self.mesh, self.mesh.coords
                                     ).clone(),
            params, self.param_specs(params))

    # ----- caches -----

    def init_cache(self, batch: int, capacity: int, device="cuda") -> list:
        """Per group and sub-block, zeroed caches: ``{"k", "v"}`` ``(L, B,
        cap, KV, dh)`` for attention (a ring of ``min(capacity, window)``
        slots for ``local_attn``), ``{"c", "kr"}`` ``(L, B, cap, ·)`` for
        ``mla``, ``{"h", "conv"}`` for ``rglru`` and ``{"x_prev", "s"}``
        for ``rwkv``; a sub-block whose feed-forward is ``rwkv_cm`` nests
        its mixer's cache under ``"tmix"`` beside the channel mix's
        ``{"x_prev"}`` under ``"cmix"``."""
        caches = self._init_cache(batch, capacity, resolve_device(device))
        tp = self.tp
        if tp is None or tp.m == 1:
            return caches
        # this rank's block of each cache over 'model' (the batch rows are
        # already this rank's)
        meta = self._init_cache(batch, capacity, torch.device("meta"))
        specs = cache_specs(meta, self.mesh)

        def block(t, spec):
            shape = [n // tp.m if e == "model" else n
                     for n, e in zip(t.shape, spec)]
            return torch.zeros(shape, dtype=t.dtype, device=t.device)

        return tree_map(block, caches, specs)

    def _init_cache(self, batch, capacity, dev):
        cfg = self.cfg

        def one(mk, count):
            if mk == "mla":
                return attn_mod.init_mla_cache(cfg, batch, capacity,
                                               cfg.dtype, dev, count=count)
            if mk == "rglru":
                return rec_mod.init_rglru_state(cfg, batch, dev, count)
            if mk == "rwkv":
                return rec_mod.init_rwkv_state(cfg, batch, dev,
                                               count)["tmix"]
            if mk not in ("attn", "local_attn"):
                raise ValueError(mk)
            cap = (min(capacity, cfg.window) if mk == "local_attn"
                   else capacity)
            return attn_mod.init_gqa_cache(cfg, batch, cap, cfg.dtype, dev,
                                           count=count)

        def sub(mk, fk, count):
            cache = one(mk, count)
            if fk == "rwkv_cm":
                cmix = rec_mod.init_rwkv_state(cfg, batch, dev,
                                               count)["cmix"]
                cache = {"tmix": cache, "cmix": cmix}
            return cache

        return [{f"sub_{j}": sub(mk, fk, block.count)
                 for j, (mk, fk) in enumerate(zip(block.pattern, block.ffn))}
                for block in cfg.blocks]

    # ----- sub-block forward -----

    def _run_mixer(self, kind, x, bparams, lparams, *, cache, **kw):
        """The mixer's output; a recurrent mixer's new state is written
        into ``cache`` in place (attention writes its own)."""
        cfg = self.cfg
        tp = self.tp
        if kind in ("rglru", "rwkv"):
            if kind == "rglru":
                out, new = rec_mod.rglru_block(x, bparams, lparams, cfg,
                                               state=cache,
                                               scaling=self.scaling, tp=tp)
            else:
                out, new = rec_mod.rwkv_tmix(x, bparams, lparams, cfg,
                                             state=cache,
                                             chunk=self.rwkv_chunk,
                                             scaling=self.scaling, tp=tp)
            if cache is not None:
                _write_state(cache, new)
            return out
        if kind == "mla":
            return attn_mod.mla_attention(
                x, bparams, lparams, cfg, scaling=self.scaling,
                force_blockwise=self.force_blockwise, cache=cache, tp=tp,
                **kw)
        if kind not in ("attn", "local_attn"):
            raise ValueError(kind)
        return attn_mod.gqa_attention(
            x, bparams, lparams, cfg,
            window=cfg.window if kind == "local_attn" else None,
            scaling=self.scaling, force_blockwise=self.force_blockwise,
            cache=cache, tp=tp, **kw)

    def _run_ffn(self, kind, x, bparams, lparams, state=None):
        """``(output, aux)``: an MoE's load-balance loss, 0 otherwise. The
        RWKV channel mix's new ``state`` is written in place."""
        tp = self.tp
        if kind == "moe":
            return ffn_mod.moe_ffn(x, bparams, lparams, self.cfg,
                                   scaling=self.scaling, mesh=self.mesh,
                                   tp=tp)
        if kind == "rwkv_cm":
            out, new = rec_mod.rwkv_cmix(x, bparams, lparams, self.cfg,
                                         state=state, scaling=self.scaling,
                                         tp=tp)
            if state is not None:
                _write_state(state, new)
            return out, 0.0
        if kind != "dense":
            raise ValueError(kind)
        act = "gelu" if self.cfg.norm == "rmsnorm_plus1" else "silu"
        return ffn_mod.dense_ffn(x, bparams, lparams, activation=act,
                                 scaling=self.scaling, tp=tp), 0.0

    # ----- backbone -----

    @staticmethod
    def _attach_seg(group_lora, seg):
        """Put the batch-level per-row adapter index ``seg`` into every
        packed multi-adapter leaf of one layer group."""
        if isinstance(group_lora, (PackedLoRABatch, PackedLoRABuckets)):
            return dataclasses.replace(group_lora, seg=seg)
        if isinstance(group_lora, dict):
            return {k: Model._attach_seg(v, seg) for k, v in group_lora.items()}
        return group_lora

    def _layer(self, block, x, aux, lb, ll, sc, **kw):
        """One layer's sub-blocks. Returns ``(x, aux)``, each sub-block's
        MoE aux loss added to ``aux`` in order (the reference's scan
        carry) unless ``aux`` is None."""
        cfg = self.cfg
        for j, (mk, fk) in enumerate(zip(block.pattern, block.ffn)):
            sb, sl = lb[f"sub_{j}"], ll[f"sub_{j}"]
            cache = None if sc is None else sc[f"sub_{j}"]
            cm_state = None
            if cache is not None and "cmix" in cache:
                cache, cm_state = cache["tmix"], cache["cmix"]
            hin = apply_norm(x, sb["mixer_norm"], cfg.norm)
            with profiler_range("model.attn"):
                out = self._run_mixer(mk, hin, sb["mixer"], sl["mixer"],
                                      cache=cache, **kw)
            if cfg.post_norm:
                out = apply_norm(out, sb["post_mixer_norm"], cfg.norm)
            x = x + out
            fin = apply_norm(x, sb["ffn_norm"], cfg.norm)
            with profiler_range("model.ffn"):
                out, aux_j = self._run_ffn(fk, fin, sb["ffn"], sl["ffn"],
                                           state=cm_state)
            if cfg.post_norm:
                out = apply_norm(out, sb["post_ffn_norm"], cfg.norm)
            x = x + out
            if aux is not None:
                aux = aux + aux_j
        return x, aux

    def _backbone(self, params, x, positions, caches, cache_pos,
                  pad_mask=None, valid_start=None):
        """Run all layers; ``caches`` (updated in place) is None in pure
        sequence mode. Returns ``(final-normed hidden states, aux)``: in
        sequence mode aux is the MoE load-balance losses summed over layers
        in order (an fp32 scalar); the cached serve modes drop it (None).
        With ``remat`` and autograd on, each layer of a sequence forward
        runs under ``torch.utils.checkpoint``. The recurrent mixers
        (rglru / rwkv) ignore ``pad_mask`` and ``valid_start``: their
        states accumulate pad tokens, so only attention architectures are
        position-exact under left-padding, as in the reference."""
        cfg = self.cfg
        base, lora = params["base"], params["lora"]
        seg = lora.get("seg") if isinstance(lora, dict) else None
        aux = (torch.zeros((), dtype=torch.float32, device=x.device)
               if caches is None else None)
        remat = (self.remat and caches is None and torch.is_grad_enabled())
        kw = dict(positions=positions, cache_pos=cache_pos,
                  valid_start=valid_start, pad_mask=pad_mask)
        specs = self._annotated(params)
        for gi, block in enumerate(cfg.blocks):
            gb, gl = base["groups"][gi], lora["groups"][gi]
            if seg is not None:
                gl = self._attach_seg(gl, seg)
            for li in range(block.count):
                with profiler_range("model.layer"):
                    lb, ll = _layer_slice(gb, li), _layer_slice(gl, li)
                    if specs is not None:
                        annotate(lb, specs[0][gi])
                        annotate(ll, specs[1][gi])
                    sc = (None if caches is None
                          else _layer_slice(caches[gi], li))
                    if remat:
                        x, aux = checkpoint(
                            functools.partial(self._layer, block, **kw),
                            x, aux, lb, ll, sc, use_reentrant=False)
                    else:
                        x, aux = self._layer(block, x, aux, lb, ll, sc,
                                             **kw)
        return apply_norm(x, base["final_norm"], cfg.norm), aux

    def _annotated(self, params):
        """Under a mesh: each group's per-layer spec trees ``(base,
        lora)`` for :func:`annotate` (None without one)."""
        if self.tp is None:
            return None
        lora = {k: v for k, v in params["lora"].items() if k != "seg"}
        bspec = self.param_specs({"base": params["base"]})["base"]
        lspec = self.param_specs({"lora": lora})["lora"]
        return ([_spec_layer(g) for g in bspec["groups"]],
                [_spec_layer(g) for g in lspec["groups"]])

    def _annotate_top(self, base):
        """Under a mesh: set the spec of every base leaf outside the layer
        groups (the tables, the final norm, the MTP head)."""
        if self.tp is None:
            return
        top = {k: v for k, v in base.items() if k != "groups"}
        annotate(top, self.param_specs({"base": top})["base"])

    # ----- embedding / unembedding -----

    def _embed(self, base, batch):
        """Token embeddings (musicgen: the sum over its codebooks of
        ``(B, K, T)`` tokens), qwen2-vl's ``vision_embeds`` prepended, and
        gemma's ``sqrt(d_model)`` scale, in the reference's order."""
        with profiler_range("model.embed"):
            cfg = self.cfg
            self._annotate_top(base)
            table = base["embed_tied" if cfg.tie_embeddings else "embed"]
            tokens = batch["tokens"]
            if cfg.n_codebooks:
                if tokens.dim() != 3:
                    raise ValueError(
                        f"{cfg.name} takes (B, {cfg.n_codebooks}, T) "
                        f"codebook tokens, got shape {tuple(tokens.shape)}: "
                        f"the serving engine hands the model (B, T) tokens, "
                        f"which the reference cannot embed either "
                        f"(ROADMAP C8)")
                x = sum(self._lookup(tokens[:, k], table["e"], k)
                        for k in range(cfg.n_codebooks))
            else:
                x = self._lookup(tokens, table["e"])
            if cfg.vision_stub and "vision_embeds" in batch:
                x = torch.cat([batch["vision_embeds"].to(x.dtype), x], dim=1)
            if cfg.norm == "rmsnorm_plus1":
                # gemma-family scale; the reference multiplies by a numpy
                # scalar, which promotes to fp32 before the cast back
                x = x.to(torch.float32) * torch.tensor(np.sqrt(cfg.d_model),
                                                       dtype=torch.float32)
            return x.to(cfg.dtype)

    def _vocab_block(self, e):
        """``[lo, hi)`` of the vocab rows this rank holds of the table
        ``e`` (``(V, d)`` or stacked ``(K, V, d)``), or None when whole."""
        tp = self.tp
        spec = getattr(e, "tp_spec", None)
        if tp is None or tp.m == 1 or spec is None or spec[-2] != "model":
            return None
        return tp.block(e.shape[-2] * tp.m)

    def _lookup(self, tokens, e, k=None):
        """``e[tokens]`` (codebook ``k`` of a stacked table); a table split
        over ``model`` by vocab rows is looked up where the rank holds the
        token, zeros elsewhere, and the rows all-reduced."""
        blk = self._vocab_block(e)
        if k is not None:
            e = e[k]
        if blk is None:
            return embed(tokens, {"e": e})
        lo, hi = blk
        local = tokens.to(torch.int64) - lo
        ok = (local >= 0) & (local < hi - lo)
        x = torch.where(ok[..., None], e[local.clamp(0, hi - lo - 1)],
                        torch.zeros((), dtype=e.dtype, device=e.device))
        return reduce_from_region(x, self.tp.group)

    def _logits(self, base, x, gather: bool = True):
        """The (soft-capped) logits; a head split over ``model`` gives the
        rank's vocab columns, gathered unless ``gather`` is False."""
        with profiler_range("model.logits"):
            cfg = self.cfg
            head = base["embed_tied"] if cfg.tie_embeddings else base["head"]
            blk = self._vocab_block(head["e"])
            if blk is not None:
                x = copy_to_region(x, self.tp.group)
            if cfg.n_codebooks:                         # (B, K, T, V)
                logits = torch.stack([unembed(x, {"e": head["e"][k]})
                                      for k in range(cfg.n_codebooks)], dim=1)
            else:
                logits = unembed(x, head)
            logits = softcap(logits, cfg.logit_softcap)
            if blk is not None and gather:
                logits = gather_from_region(logits, -1, self.tp.group)
            return logits

    def _rope_streams(self, pos):
        """``(B, T)`` positions as the rotary embedding takes them: the
        three M-RoPE streams equal (text) for ``mrope``."""
        if self.cfg.rope == "mrope":
            return pos[None].expand((3,) + tuple(pos.shape))
        return pos

    def _positions(self, batch, t: int, b: int):
        """``batch["positions"]`` if given, else ``0..T-1`` per row (the
        three equal M-RoPE streams for ``mrope``)."""
        if "positions" in batch:
            return batch["positions"]
        dev = batch["tokens"].device
        return self._rope_streams(
            torch.arange(t, device=dev)[None, :].expand(b, t))

    # ----- public API -----

    def forward(self, params, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sequence mode: full causal forward. Returns ``(logits, aux)``."""
        x = self._embed(params["base"], batch)
        b, t = x.shape[0], x.shape[1]
        h, aux = self._backbone(params, x, self._positions(batch, t, b),
                                None, None)
        return self._logits(params["base"], h), aux

    def _ce(self, logits, targets, blk=None) -> torch.Tensor:
        """Mean fp32 cross-entropy over the targets ``>= 0``. With ``blk``
        the logits are the rank's vocab columns ``[lo, hi)``: the max and
        the sum of exponentials are all-reduced over ``model`` and the
        target's logit comes from the rank that holds it."""
        lf = logits.to(torch.float32)
        tgt = torch.clamp(targets, min=0).to(torch.int64)
        if blk is None:
            lse = torch.logsumexp(lf, dim=-1)
            gold = torch.gather(lf, -1, tgt[..., None])[..., 0]
        else:
            group = self.tp.group
            lo, hi = blk
            mx = all_reduce_max(lf.amax(dim=-1), group)
            se = reduce_from_region(
                torch.sum(torch.exp(lf - mx[..., None]), dim=-1), group)
            lse = mx + torch.log(se)
            local = tgt - lo
            ok = (local >= 0) & (local < hi - lo)
            gold = torch.gather(lf, -1, local.clamp(0, hi - lo - 1)[..., None]
                                )[..., 0]
            gold = reduce_from_region(
                torch.where(ok, gold, torch.zeros_like(gold)), group)
        mask = (targets >= 0).to(torch.float32)
        return torch.sum((lse - gold) * mask) / torch.clamp(torch.sum(mask),
                                                            min=1.0)

    def train_loss(self, params, batch):
        """``(loss, {"ce", "aux"})`` of a batch of ``tokens`` / ``targets``
        (``(B, K, T)`` with codebooks, whose ``(B, K, T, V)`` logits go
        into one CE); a vision stub's ``vision_embeds`` positions are
        sliced off the logits (and the states) before the CE. With
        ``cfg.mtp`` (deepseek) the loss adds 0.3 x the CE of the
        multi-token-prediction head, which predicts token t+2 from the
        trunk's output at t joined with the embedding of token t+1 (the
        reference's single-projection MTP module). Autograd stays on."""
        cfg = self.cfg
        base = params["base"]
        x = self._embed(base, batch)
        b, t = x.shape[0], x.shape[1]
        h, aux = self._backbone(params, x, self._positions(batch, t, b),
                                None, None)
        head = base["embed_tied"] if cfg.tie_embeddings else base["head"]
        blk = self._vocab_block(head["e"])
        logits = self._logits(base, h, gather=False)
        targets = batch["targets"]
        if cfg.vision_stub and "vision_embeds" in batch:
            tv = batch["vision_embeds"].shape[1]
            logits, h, x = logits[:, tv:], h[:, tv:], x[:, tv:]
        ce = self._ce(logits, targets, blk)
        loss = ce + aux
        if cfg.mtp:
            nxt = torch.cat([x[:, 1:], torch.zeros_like(x[:, :1])], dim=1)
            hn = torch.cat([h, nxt], dim=-1)
            if self.tp is None:
                h2 = hn @ base["mtp"]["proj"]["w"]
            else:
                h2, _ = self.tp.linear(hn, base["mtp"]["proj"], None, 1.0)
            h2 = apply_norm(h2, base["mtp"]["norm"], cfg.norm)
            t2 = torch.cat([targets[:, 1:],
                            -torch.ones_like(targets[:, :1])], dim=-1)
            loss = loss + 0.3 * self._ce(
                self._logits(base, h2, gather=False), t2, blk)
        return loss, {"ce": ce, "aux": aux}

    @torch.no_grad()
    def prefill(self, params, batch, capacity: int):
        """Sequence forward that also fills the decode caches. Returns
        ``(logits (B, T, V), caches)``.

        ``batch["start"]`` (optional, ``(B,)``) is each row's left-pad
        count: real tokens sit at padded indices ``start..T-1`` with
        positions ``0..len-1`` and pad slots are masked out of attention.
        ``batch["positions"]`` (optional; ``(3, B, T)`` for M-RoPE) replaces
        the positions, ``batch["vision_embeds"]`` (``(B, Tv, d)``, qwen2-vl)
        is prepended to the tokens' embeddings, and musicgen's tokens are
        ``(B, K, T)``, its logits ``(B, K, T, V)``."""
        x = self._embed(params["base"], batch)
        b, t = x.shape[0], x.shape[1]
        pad_mask = None
        ar = torch.arange(t, device=x.device)
        if "positions" in batch:
            positions = batch["positions"]
        elif "start" in batch:
            pos = ar[None, :] - batch["start"].to(torch.int64)[:, None]
            pad_mask = pos >= 0
            positions = self._rope_streams(torch.clamp(pos, min=0))
        else:
            positions = self._rope_streams(ar[None, :].expand(b, t))
        caches = self.init_cache(b, capacity, device=x.device)
        h, _ = self._backbone(params, x, positions, caches, 0,
                              pad_mask=pad_mask)
        return self._logits(params["base"], h), caches

    @torch.no_grad()
    def decode_step(self, params, tokens, caches, pos, start=None):
        """One token per sequence. ``tokens: (B, 1)`` (musicgen: ``(B, K,
        1)``); ``pos``: ``(B,)`` padded cache index of the incoming token;
        ``start``: optional ``(B,)`` left-pad count. Rotary positions are
        ``pos - start``.
        Returns ``(logits, caches)`` (the caches updated in place). A call
        that a serving engine prepared (``models/graphs.py``) is replayed
        from its CUDA graphs; the logits are then the graphs' output
        buffer, rewritten by the next replay."""
        graphs, self._armed = self._armed, None
        if graphs is not None:
            logits = graphs.replay(params, tokens, caches, pos, start)
            if logits is not None:
                return logits, caches
        return self._decode(params, tokens, caches, pos, start), caches

    def _decode(self, params, tokens, caches, pos, start):
        """The logits of :meth:`decode_step`'s forward (what a decode graph
        captures)."""
        x = self._embed(params["base"], {"tokens": tokens})
        b = x.shape[0]
        pos_b = torch.as_tensor(pos, device=x.device).to(
            torch.int64).reshape(-1).expand(b)
        start_b = (torch.zeros((b,), dtype=torch.int64, device=x.device)
                   if start is None
                   else torch.as_tensor(start, device=x.device).to(
                       torch.int64).reshape(-1).expand(b))
        positions = self._rope_streams((pos_b - start_b)[:, None])
        h, _ = self._backbone(params, x, positions, caches, pos_b,
                              valid_start=start_b)
        return self._logits(params["base"], h)


def build_model(cfg, remat: bool = False, mesh=None, **overrides) -> Model:
    return Model(cfg, remat=remat, mesh=mesh, **overrides)
