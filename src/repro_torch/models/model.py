"""Decoder-LM assembly (port of ``repro/models/model.py``) for the dense
GQA family: stacked ``(L, ...)`` layer params walked by a Python loop over
layers, LoRA trees mirroring every targeted linear, and the prefill /
decode-with-cache modes the serving engine drives.

Parameter tree, as in the JAX package::

    {"base": {"embed": {"e"}, "head": {"e"}, "final_norm": {"w"},
              "groups": [{"sub_0": {"mixer": {"wq": {"w"}, ...},
                                    "mixer_norm": {"w"},
                                    "ffn": {"wg": {"w"}, ...},
                                    "ffn_norm": {"w"}}}]},
     "lora": {"groups": [{"sub_0": {"mixer": {"wq": {"a", "b"}, ...},
                                    "ffn": {"wg": {"a", "b"}, ...}}}]}}

A serving engine may replace LoRA leaves by
:class:`~repro_torch.kernels.PackedLoRABatch` stacks and put the per-row
adapter index at ``lora["seg"]``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch import resolve_device
from repro_torch.kernels.quant_matmul import PackedLoRABatch

from . import attention as attn_mod
from . import ffn as ffn_mod
from .common import apply_norm, embed, init_embedding, unembed

Params = Dict[str, Any]


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP A10)")


def _layer_slice(tree, i: int):
    """Layer ``i`` of a stacked tree: every tensor ``t[i]``, every packed
    leaf its per-layer view (its ``seg`` stays per row)."""
    if isinstance(tree, PackedLoRABatch):
        return tree.layer(i)
    if isinstance(tree, dict):
        return {k: _layer_slice(v, i) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return tree


@dataclasses.dataclass
class Model:
    cfg: Any

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
        base: Params = {
            embed_key: init_embedding(gen, cfg.vocab, cfg.d_model, cfg.dtype),
            "final_norm": {"w": torch.ones((cfg.d_model,), device=dev)}}
        if not cfg.tie_embeddings:
            base["head"] = init_embedding(gen, cfg.vocab, cfg.d_model,
                                          cfg.dtype)
        base["groups"] = []
        lora: Params = {"groups": []}
        for block in cfg.blocks:
            gb, gl = {}, {}
            for j, (mk, fk) in enumerate(zip(block.pattern, block.ffn)):
                if mk != "attn" or fk != "dense":
                    raise _not_ported(f"layer kind {mk}/{fk}")
                mb, ml = attn_mod.init_gqa(gen, cfg, cfg.lora_rank,
                                           block.count)
                fb, fl = ffn_mod.init_dense_ffn(gen, cfg, cfg.lora_rank,
                                                block.count)
                ones = torch.ones((block.count, cfg.d_model), device=dev)
                gb[f"sub_{j}"] = {"mixer": mb, "mixer_norm": {"w": ones},
                                  "ffn": fb, "ffn_norm": {"w": ones.clone()}}
                gl[f"sub_{j}"] = {"mixer": ml, "ffn": fl}
            base["groups"].append(gb)
            lora["groups"].append(gl)
        return {"base": base, "lora": lora}

    # ----- caches -----

    def init_cache(self, batch: int, capacity: int, device="cuda") -> list:
        cfg = self.cfg
        dev = resolve_device(device)
        return [{f"sub_{j}": attn_mod.init_gqa_cache(
                    cfg, batch, capacity, cfg.dtype, dev, count=block.count)
                 for j in range(len(block.pattern))}
                for block in cfg.blocks]

    # ----- backbone -----

    @staticmethod
    def _attach_seg(group_lora, seg):
        """Put the batch-level per-row adapter index ``seg`` into every
        packed multi-adapter leaf of one layer group."""
        if isinstance(group_lora, PackedLoRABatch):
            return dataclasses.replace(group_lora, seg=seg)
        if isinstance(group_lora, dict):
            return {k: Model._attach_seg(v, seg) for k, v in group_lora.items()}
        return group_lora

    def _backbone(self, params, x, positions, caches, cache_pos,
                  pad_mask=None, valid_start=None):
        """Run all layers; ``caches`` (updated in place) is None in pure
        sequence mode. Returns the final-normed hidden states."""
        cfg = self.cfg
        base, lora = params["base"], params["lora"]
        seg = lora.get("seg") if isinstance(lora, dict) else None
        for gi, block in enumerate(cfg.blocks):
            gb, gl = base["groups"][gi], lora["groups"][gi]
            if seg is not None:
                gl = self._attach_seg(gl, seg)
            for li in range(block.count):
                lb, ll = _layer_slice(gb, li), _layer_slice(gl, li)
                for j in range(len(block.pattern)):
                    sb, sl = lb[f"sub_{j}"], ll[f"sub_{j}"]
                    sc = (None if caches is None
                          else _layer_slice(caches[gi][f"sub_{j}"], li))
                    hin = apply_norm(x, sb["mixer_norm"], cfg.norm)
                    x = x + attn_mod.gqa_attention(
                        hin, sb["mixer"], sl["mixer"], cfg,
                        positions=positions, cache=sc, cache_pos=cache_pos,
                        valid_start=valid_start, pad_mask=pad_mask,
                        scaling=self.scaling)
                    fin = apply_norm(x, sb["ffn_norm"], cfg.norm)
                    x = x + ffn_mod.dense_ffn(fin, sb["ffn"], sl["ffn"],
                                              scaling=self.scaling)
        return apply_norm(x, base["final_norm"], cfg.norm)

    # ----- embedding / unembedding -----

    def _embed(self, base, tokens):
        cfg = self.cfg
        table = base["embed_tied" if cfg.tie_embeddings else "embed"]
        return embed(tokens, table).to(cfg.dtype)

    def _logits(self, base, x):
        cfg = self.cfg
        return unembed(x, base["embed_tied"] if cfg.tie_embeddings
                       else base["head"])

    # ----- public API -----

    @torch.no_grad()
    def prefill(self, params, batch, capacity: int):
        """Sequence forward that also fills the decode caches. Returns
        ``(logits (B, T, V), caches)``.

        ``batch["start"]`` (optional, ``(B,)``) is each row's left-pad
        count: real tokens sit at padded indices ``start..T-1`` with
        positions ``0..len-1`` and pad slots are masked out of attention."""
        tokens = batch["tokens"]
        x = self._embed(params["base"], tokens)
        b, t = x.shape[0], x.shape[1]
        pad_mask = None
        ar = torch.arange(t, device=x.device)
        if "start" in batch:
            pos = ar[None, :] - batch["start"].to(torch.int64)[:, None]
            pad_mask = pos >= 0
            positions = torch.clamp(pos, min=0)
        else:
            positions = ar[None, :].expand(b, t)
        caches = self.init_cache(b, capacity, device=x.device)
        h = self._backbone(params, x, positions, caches, 0,
                           pad_mask=pad_mask)
        return self._logits(params["base"], h), caches

    @torch.no_grad()
    def decode_step(self, params, tokens, caches, pos, start=None):
        """One token per sequence. ``tokens: (B, 1)``; ``pos``: ``(B,)``
        padded cache index of the incoming token; ``start``: optional
        ``(B,)`` left-pad count. Rotary positions are ``pos - start``.
        Returns ``(logits, caches)`` (the caches updated in place)."""
        x = self._embed(params["base"], tokens)
        b = x.shape[0]
        pos_b = torch.as_tensor(pos, device=x.device).to(
            torch.int64).reshape(-1).expand(b)
        start_b = (torch.zeros((b,), dtype=torch.int64, device=x.device)
                   if start is None
                   else torch.as_tensor(start, device=x.device).to(
                       torch.int64).reshape(-1).expand(b))
        positions = (pos_b - start_b)[:, None]
        h = self._backbone(params, x, positions, caches, pos_b,
                           valid_start=start_b)
        return self._logits(params["base"], h), caches


def build_model(cfg) -> Model:
    return Model(cfg)
