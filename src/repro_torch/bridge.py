"""Carry the JAX package's objects across to the port.

Every function here reads its input by duck typing: array fields go through
``np.asarray`` (a JAX array, a numpy array or anything else with the array
protocol) and metadata is copied by attribute name. The bridge therefore
imports neither JAX nor ``repro``; the tests hand it JAX objects (or their
``np.asarray`` views) and compare the port against them.

Covered: nested-dict parameter trees with stacked ``(L, ...)`` leaves
(``repro/models/model.py``; an MoE layer's expert stacks ``(L, E, ·, ·)``,
its fp32 router and per-expert LoRA ``(L, E, r, ·)`` keep their shapes
and dtypes, as do deepseek's int8 expert codes with their fp32 ``(L, E, 1,
·)`` scales, its MLA leaves and its ``mtp`` head; the dense variants'
empty ``{}`` norms, post-block norms and stacked ``(K, V, d)`` codebook
tables; the recurrent trees: RWKV-6's fp32 mixing, decay and group-norm
leaves with the raw ``ddlerp_w2 (L, 5, 32, d)``, the RG-LRU's fp32
``conv_w`` / ``conv_b`` / ``lambda_p`` / ``w_ix`` / ``w_ax`` beside its
bf16 projections, and their caches' fp32 states — all come across as
they are),
``QuantizedTensor``, ``QuantizedLoRA`` (one
layer's, or layer-stacked with a leading ``(L,)`` on every array, which
the arrays keep), trees whose leaves are ``QuantizedLoRA``, and the serving
engine's ``QuantizedAdapter``.

Like every entry point of the port, each function places its tensors on the
card unless the caller passes ``device="cpu"``, and raises when CUDA is asked
for but absent.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.loraquant import LoRAQuantConfig, QuantizedLoRA
from repro_torch.core.quant import QuantizedTensor
from repro_torch.serving.engine import QuantizedAdapter, TensorSpec

__all__ = ["to_torch", "quantized_tensor", "quantized_lora",
           "quantized_adapter", "recipe"]


def _tensor(arr, device, dtype=None) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":          # ml_dtypes bf16: reinterpret bits
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def _torch_dtype(np_dtype) -> torch.dtype:
    name = np.dtype(np_dtype).name
    if name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.zeros((), dtype=np_dtype)).dtype


def to_torch(tree, device="cuda"):
    """Nested dicts / lists / tuples of arrays → the same structure of
    tensors on ``device`` (dtypes kept; bf16 included). ``QuantizedLoRA``
    leaves become the port's (see :func:`quantized_lora`)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        if hasattr(node, "a_high") and hasattr(node, "b_high"):
            return quantized_lora(node, dev)
        return _tensor(node, dev)

    return conv(tree)


def quantized_tensor(q, device="cuda") -> QuantizedTensor:
    """A JAX ``QuantizedTensor`` → the port's. 3-bit words (uint32 in JAX)
    become int32: the payload is at most 30 bits."""
    device = resolve_device(device)
    codes = np.asarray(q.codes)
    if q.bits == 3:
        codes = codes.astype(np.int32)
    return QuantizedTensor(
        codes=_tensor(codes, device),
        scale=_tensor(q.scale, device, torch.float32),
        zero=_tensor(q.zero, device, torch.int32),
        bits=int(q.bits), group_size=int(q.group_size), axis=int(q.axis),
        orig_shape=tuple(int(d) for d in q.orig_shape), mode=str(q.mode))


def recipe(cfg) -> LoRAQuantConfig:
    """A JAX ``LoRAQuantConfig`` → the port's (same field names)."""
    names = [f.name for f in dataclasses.fields(LoRAQuantConfig)]
    return LoRAQuantConfig(**{n: getattr(cfg, n) for n in names})


def quantized_lora(q, device="cuda") -> QuantizedLoRA:
    """A JAX ``QuantizedLoRA`` → the port's; a layer-stacked one (every
    array with a leading ``(L,)``) stays stacked, and the model slices
    it per layer."""
    device = resolve_device(device)
    low = q.b_low is not None
    return QuantizedLoRA(
        b_high=quantized_tensor(q.b_high, device),
        a_high=quantized_tensor(q.a_high, device),
        b_low=quantized_tensor(q.b_low, device) if low else None,
        a_low=quantized_tensor(q.a_low, device) if low else None,
        h=int(q.h), rank=int(q.rank), config=recipe(q.config))


def _template(tree):
    if isinstance(tree, dict):
        return {k: _template(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_template(v) for v in tree)
    return TensorSpec(tuple(int(d) for d in tree.shape),
                      _torch_dtype(tree.dtype))


def quantized_adapter(qa, device="cuda"):
    """A JAX ``QuantizedAdapter`` (serving engine) → the port's."""
    device = resolve_device(device)
    return QuantizedAdapter(
        entries={path: [quantized_lora(q, device) for q in qs]
                 for path, qs in qa.entries.items()},
        template=_template(qa.template),
        recipe=None if qa.recipe is None else recipe(qa.recipe))
