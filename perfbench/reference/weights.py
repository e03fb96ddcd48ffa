"""The base weights of a configuration, drawn from the run's seed.

The benchmark hands the program only the seed of its base weights, and the
program draws them on the card by its own init. This module draws the same
numbers again for the reference: the same generator calls, in the same order
and at the same shapes (embedding tables from a normal, every linear and
expert matrix from a uniform of bound 1/sqrt(fan-in), the LoRA templates'
``a`` factors drawn and dropped, since the adapters come from the benchmark),
so that both sides hold one set of weights without the reference taking any
tensor from the program. It imports nothing of the program.

A configuration here is the dict of a ``configs/*.json`` file.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dims(cfg: Dict[str, Any]) -> Dict[str, int]:
    """The sizes the reference works with, from a configuration file."""
    d = cfg["hidden_size"]
    h = cfg["num_attention_heads"]
    out = {"d": d, "h": h, "kv": cfg["num_key_value_heads"],
           "dh": cfg.get("head_dim") or d // h,
           "f": cfg["intermediate_size"], "v": cfg["vocab_size"],
           "layers": cfg["num_hidden_layers"], "r": cfg["lora_rank"]}
    if cfg.get("num_local_experts"):
        out["e"] = cfg["num_local_experts"]
        out["k"] = cfg["num_experts_per_tok"]
    return out


def _uniform(gen, shape, fan_in: int) -> torch.Tensor:
    bound = 1.0 / math.sqrt(fan_in)
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return w.uniform_(-bound, bound, generator=gen)


def _table(gen, v: int, d: int, dtype) -> torch.Tensor:
    e = torch.empty((v, d), dtype=torch.float32, device=gen.device)
    e.normal_(0.0, 1.0, generator=gen)
    return (e * 0.02).to(dtype)


def attention_shapes(n: Dict[str, int]) -> Dict[str, tuple]:
    d, h, kv, dh = n["d"], n["h"], n["kv"], n["dh"]
    return {"wq": (d, h * dh), "wk": (d, kv * dh), "wv": (d, kv * dh),
            "wo": (h * dh, d)}


def ffn_shapes(n: Dict[str, int]) -> Dict[str, tuple]:
    d, f = n["d"], n["f"]
    return {"wg": (d, f), "wu": (d, f), "wd": (f, d)}


def draw(cfg: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """``{"embed", "head", "layers": [per-layer dict]}``; matrices are
    ``(in, out)`` in the configuration's dtype, the router in fp32, each
    layer's tensors views of one stacked draw."""
    n = dims(cfg)
    dtype = DTYPES[cfg["dtype"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    layers_n, r = n["layers"], n["r"]
    out: Dict[str, Any] = {"embed": _table(gen, n["v"], n["d"], dtype),
                           "head": _table(gen, n["v"], n["d"], dtype)}
    stacks: Dict[str, torch.Tensor] = {}
    for name, (i, o) in attention_shapes(n).items():
        stacks[name] = _uniform(gen, (layers_n, i, o), i).to(dtype)
    for i, _ in attention_shapes(n).values():
        _uniform(gen, (layers_n, r, i), i)          # LoRA template, dropped
    if "e" in n:
        e = n["e"]
        stacks["router"] = _uniform(gen, (layers_n, n["d"], e), n["d"])
        for name, (i, o) in ffn_shapes(n).items():
            w = torch.empty((layers_n, e, i, o), dtype=dtype, device=device)
            tmp = torch.empty((i, o), dtype=torch.float32, device=device)
            bound = 1.0 / math.sqrt(i)
            for li in range(layers_n):
                for ei in range(e):
                    tmp.uniform_(-bound, bound, generator=gen)
                    w[li, ei].copy_(tmp)
            stacks["x" + name] = w
        _uniform(gen, (layers_n, r, n["d"]), n["d"])
        for i, _ in ffn_shapes(n).values():
            _uniform(gen, (layers_n, e, r, i), i)
    else:
        for name, (i, o) in ffn_shapes(n).items():
            stacks[name] = _uniform(gen, (layers_n, i, o), i).to(dtype)
        for i, _ in ffn_shapes(n).values():
            _uniform(gen, (layers_n, r, i), i)
    layers: List[Dict[str, torch.Tensor]] = [
        {k: v[li] for k, v in stacks.items()} for li in range(layers_n)]
    out["layers"] = layers
    return out
