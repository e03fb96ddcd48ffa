"""Carry the JAX package's objects across to the port.

Every function here reads its input by duck typing: array fields go through
``np.asarray`` (a JAX array, a numpy array or anything else with the array
protocol) and metadata is copied by attribute name. The bridge therefore
imports neither JAX nor ``repro``; the tests hand it JAX objects (or their
``np.asarray`` views) and compare the port against them.

Covered: nested-dict parameter trees with stacked ``(L, ...)`` leaves
(``repro/models/model.py``), ``QuantizedTensor``, ``QuantizedLoRA`` and the
serving engine's ``QuantizedAdapter``.

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
    tensors on ``device`` (dtypes kept; bf16 included)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
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
