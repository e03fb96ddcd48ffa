"""The yardstick: the chip's peaks and the work a cell's steps do.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit: 989
TFLOP/s dense in bf16, 3.35 TB/s of HBM. Work is counted from the model's
shapes and the tokens served, whichever kernels do it, so a later kernel of
any design is judged against the same numbers. This file is not a metric:
the readers beside it import it.

Model FLOPs of one token: 2 x every parameter it uses (attention, the dense
FFN or the router and its top-k experts, the LM head; not the embedding
lookup), 2 r (in + out) for each LoRA linear it passes, and 4 heads
head_dim x the positions it attends per layer. No pad token, masked row or
empty capacity slot counts.

LoRA bytes of one call: each adapter entry it serves read once at the
paper's storage accounting (codes at their width, a 16-bit scale per group,
a zero point of the code width per RTN group), and each active row's input
read and output written once in bf16.
"""

from __future__ import annotations

import math
from typing import Any, Dict

PEAK_FLOPS = 989e12          # bf16 dense, tensor cores
PEAK_BYTES = 3.35e12         # HBM3
GROUP = 128
ACT_BYTES = 2                # bf16 activations

ATTN = ("wq", "wk", "wv", "wo")


def shapes(cfg: Dict[str, Any]) -> Dict[str, tuple]:
    """LoRA linear name → (in, out), the reference's names."""
    d, h, kv = (cfg["hidden_size"], cfg["num_attention_heads"],
                cfg["num_key_value_heads"])
    dh = cfg.get("head_dim") or d // h
    f = cfg["intermediate_size"]
    out = {"wq": (d, h * dh), "wk": (d, kv * dh), "wv": (d, kv * dh),
           "wo": (h * dh, d)}
    if cfg.get("num_local_experts"):
        out["router"] = (d, cfg["num_local_experts"])
        out.update(xwg=(d, f), xwu=(d, f), xwd=(f, d))
    else:
        out.update(wg=(d, f), wu=(d, f), wd=(f, d))
    return out


def per_token(cfg: Dict[str, Any]) -> float:
    """FLOPs of one token outside its attention scores, all layers and
    the LM head."""
    r = cfg["lora_rank"]
    k = cfg.get("num_experts_per_tok", 1)
    layer = 0.0
    for name, (i, o) in shapes(cfg).items():
        uses = k if name.startswith("x") else 1
        layer += uses * (2 * i * o + 2 * r * (i + o))
    return (cfg["num_hidden_layers"] * layer
            + 2 * cfg["hidden_size"] * cfg["vocab_size"])


def attention(cfg: Dict[str, Any], attended: float) -> float:
    """Score and value FLOPs of one token attending ``attended`` positions,
    all layers."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    dh = cfg.get("head_dim") or d // h
    return 4.0 * h * dh * attended * cfg["num_hidden_layers"]


def prompt_flops(cfg: Dict[str, Any], n: int) -> float:
    """A prompt of ``n`` tokens, token j attending j + 1 positions."""
    return n * per_token(cfg) + attention(cfg, n * (n + 1) / 2)


def entry_bytes(out_dim: int, in_dim: int, rank: int, h: int,
                bits: int) -> float:
    """Stored bytes of one quantized adapter entry split at ``h``."""
    r = min(rank, out_dim, in_dim)
    gb = math.ceil(out_dim / min(GROUP, out_dim))     # groups down a column
    ga = math.ceil(in_dim / min(GROUP, in_dim))       # groups along a row
    hi = h * (out_dim + in_dim) * bits / 8 + h * (gb + ga) * (2 + bits / 8)
    lo = (r - h) * ((out_dim + in_dim) / 8 + (gb + ga) * 2)
    return hi + lo


def lora_call(rows: float, in_dim: int, out_dim: int, rank: int,
              adapter_bytes: float) -> float:
    """Least time of one LoRA call over ``rows`` active rows."""
    nbytes = adapter_bytes + rows * (in_dim + out_dim) * ACT_BYTES
    flops = 2.0 * rows * rank * (in_dim + out_dim)
    return max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS)
