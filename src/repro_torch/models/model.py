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

A LoRA leaf may also be applied straight from packed codes: a
layer-stacked :class:`~repro_torch.core.QuantizedLoRA` (one adapter for the
whole batch; every array carries the leading ``(L,)`` axis and all layers
share one split ``h``), a :class:`~repro_torch.kernels.PackedLoRABatch`
stack of many adapters, or a :class:`~repro_torch.kernels.PackedLoRABuckets`
of such stacks, one per recipe layout; a serving engine puts the per-row
adapter index of the last two at ``lora["seg"]``.
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

    @property
    def scaling(self) -> float:
        return self.cfg.lora_alpha / self.cfg.lora_rank

    # ----- init -----

    def init(self, seed: int = 0, device="cuda") -> Params:
        """Random params from a ``torch.Generator`` seeded with ``seed`` on
        ``device`` (the card unless the caller asks for the CPU)."""
        cfg = self.cfg
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
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

    # ----- caches -----

    def init_cache(self, batch: int, capacity: int, device="cuda") -> list:
        """Per group and sub-block, zeroed caches: ``{"k", "v"}`` ``(L, B,
        cap, KV, dh)`` for attention (a ring of ``min(capacity, window)``
        slots for ``local_attn``), ``{"c", "kr"}`` ``(L, B, cap, ·)`` for
        ``mla``, ``{"h", "conv"}`` for ``rglru`` and ``{"x_prev", "s"}``
        for ``rwkv``; a sub-block whose feed-forward is ``rwkv_cm`` nests
        its mixer's cache under ``"tmix"`` beside the channel mix's
        ``{"x_prev"}`` under ``"cmix"``."""
        cfg = self.cfg
        dev = resolve_device(device)

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
        if kind in ("rglru", "rwkv"):
            if kind == "rglru":
                out, new = rec_mod.rglru_block(x, bparams, lparams, cfg,
                                               state=cache,
                                               scaling=self.scaling)
            else:
                out, new = rec_mod.rwkv_tmix(x, bparams, lparams, cfg,
                                             state=cache,
                                             chunk=self.rwkv_chunk,
                                             scaling=self.scaling)
            if cache is not None:
                _write_state(cache, new)
            return out
        if kind == "mla":
            return attn_mod.mla_attention(
                x, bparams, lparams, cfg, scaling=self.scaling,
                force_blockwise=self.force_blockwise, cache=cache, **kw)
        if kind not in ("attn", "local_attn"):
            raise ValueError(kind)
        return attn_mod.gqa_attention(
            x, bparams, lparams, cfg,
            window=cfg.window if kind == "local_attn" else None,
            scaling=self.scaling, force_blockwise=self.force_blockwise,
            cache=cache, **kw)

    def _run_ffn(self, kind, x, bparams, lparams, state=None):
        """``(output, aux)``: an MoE's load-balance loss, 0 otherwise. The
        RWKV channel mix's new ``state`` is written in place."""
        if kind == "moe":
            return ffn_mod.moe_ffn(x, bparams, lparams, self.cfg,
                                   scaling=self.scaling)
        if kind == "rwkv_cm":
            out, new = rec_mod.rwkv_cmix(x, bparams, lparams, self.cfg,
                                         state=state, scaling=self.scaling)
            if state is not None:
                _write_state(state, new)
            return out, 0.0
        if kind != "dense":
            raise ValueError(kind)
        act = "gelu" if self.cfg.norm == "rmsnorm_plus1" else "silu"
        return ffn_mod.dense_ffn(x, bparams, lparams, activation=act,
                                 scaling=self.scaling), 0.0

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
            out = self._run_mixer(mk, hin, sb["mixer"], sl["mixer"],
                                  cache=cache, **kw)
            if cfg.post_norm:
                out = apply_norm(out, sb["post_mixer_norm"], cfg.norm)
            x = x + out
            fin = apply_norm(x, sb["ffn_norm"], cfg.norm)
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
        for gi, block in enumerate(cfg.blocks):
            gb, gl = base["groups"][gi], lora["groups"][gi]
            if seg is not None:
                gl = self._attach_seg(gl, seg)
            for li in range(block.count):
                lb, ll = _layer_slice(gb, li), _layer_slice(gl, li)
                sc = (None if caches is None
                      else _layer_slice(caches[gi], li))
                if remat:
                    x, aux = checkpoint(
                        functools.partial(self._layer, block, **kw),
                        x, aux, lb, ll, sc, use_reentrant=False)
                else:
                    x, aux = self._layer(block, x, aux, lb, ll, sc, **kw)
        return apply_norm(x, base["final_norm"], cfg.norm), aux

    # ----- embedding / unembedding -----

    def _embed(self, base, batch):
        """Token embeddings (musicgen: the sum over its codebooks of
        ``(B, K, T)`` tokens), qwen2-vl's ``vision_embeds`` prepended, and
        gemma's ``sqrt(d_model)`` scale, in the reference's order."""
        cfg = self.cfg
        table = base["embed_tied" if cfg.tie_embeddings else "embed"]
        tokens = batch["tokens"]
        if cfg.n_codebooks:
            if tokens.dim() != 3:
                raise ValueError(
                    f"{cfg.name} takes (B, {cfg.n_codebooks}, T) codebook "
                    f"tokens, got shape {tuple(tokens.shape)}: the serving "
                    f"engine hands the model (B, T) tokens, which the "
                    f"reference cannot embed either (ROADMAP C8)")
            x = sum(embed(tokens[:, k], {"e": table["e"][k]})
                    for k in range(cfg.n_codebooks))
        else:
            x = embed(tokens, table)
        if cfg.vision_stub and "vision_embeds" in batch:
            x = torch.cat([batch["vision_embeds"].to(x.dtype), x], dim=1)
        if cfg.norm == "rmsnorm_plus1":
            # gemma-family scale; the reference multiplies by a numpy
            # scalar, which promotes to fp32 before the cast back
            x = x.to(torch.float32) * torch.tensor(np.sqrt(cfg.d_model),
                                                   dtype=torch.float32)
        return x.to(cfg.dtype)

    def _logits(self, base, x):
        cfg = self.cfg
        head = base["embed_tied"] if cfg.tie_embeddings else base["head"]
        if cfg.n_codebooks:                         # (B, K, T, V)
            logits = torch.stack([unembed(x, {"e": head["e"][k]})
                                  for k in range(cfg.n_codebooks)], dim=1)
        else:
            logits = unembed(x, head)
        return softcap(logits, cfg.logit_softcap)

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

    @staticmethod
    def _ce(logits, targets) -> torch.Tensor:
        """Mean fp32 cross-entropy over the targets ``>= 0``."""
        lf = logits.to(torch.float32)
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, torch.clamp(targets, min=0).to(
            torch.int64)[..., None])[..., 0]
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
        logits = self._logits(base, h)
        targets = batch["targets"]
        if cfg.vision_stub and "vision_embeds" in batch:
            tv = batch["vision_embeds"].shape[1]
            logits, h, x = logits[:, tv:], h[:, tv:], x[:, tv:]
        ce = self._ce(logits, targets)
        loss = ce + aux
        if cfg.mtp:
            nxt = torch.cat([x[:, 1:], torch.zeros_like(x[:, :1])], dim=1)
            h2 = torch.cat([h, nxt], dim=-1) @ base["mtp"]["proj"]["w"]
            h2 = apply_norm(h2, base["mtp"]["norm"], cfg.norm)
            t2 = torch.cat([targets[:, 1:],
                            -torch.ones_like(targets[:, :1])], dim=-1)
            loss = loss + 0.3 * self._ce(self._logits(base, h2), t2)
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
        Returns ``(logits, caches)`` (the caches updated in place)."""
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
        return self._logits(params["base"], h), caches


def build_model(cfg, remat: bool = False, **overrides) -> Model:
    return Model(cfg, remat=remat, **overrides)
