"""Plain PyTorch forward of the benchmark's decoders, one sequence at a time.

The architecture is the published one (a pre-norm decoder with RMSNorm,
rotary embeddings of the rotate-half form, grouped-query attention, a SiLU
GLU feed-forward, or a softmax top-k router over GLU experts whose k gates
are renormalized), with each adapter's LoRA update ``scaling * (x Aᵀ) Bᵀ``
on every targeted linear. It keeps no cache and batches nothing: the whole
sequence goes through every layer at once, in float32 (TF32 off), with the
weights' stored values upcast at each product.

``precision="fp8"`` is the lower-precision control: every base product
takes both operands through float8 e4m3 (a scale per activation row and
per weight column, the usual fp8 serving recipe), the rest unchanged.

It imports nothing of the program. Where the program's model departs from
the published configuration (its RMSNorm epsilon, a capacity factor on the
experts), the configuration file says so and this forward follows the file.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .weights import dims

FP8_MAX = 448.0


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    s = amax / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class Forward:
    """One configuration's reference forward over drawn weights.

    ``lora``: name → list over flat entries (layer, or layer·E + expert for
    the expert linears) of dequantized ``(B (out, r), A (r, in))`` in fp32;
    names ``wq wk wv wo`` and ``wg wu wd`` (dense) or ``router xwg xwu
    xwd`` (experts)."""

    def __init__(self, cfg: Dict[str, Any], weights: Dict[str, Any],
                 precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.cfg = cfg
        self.n = dims(cfg)
        self.w = weights
        self.precision = precision
        self.eps = float(cfg["rms_norm_eps"])
        self.scaling = cfg["lora_alpha"] / cfg["lora_rank"]
        self.window = cfg.get("assumed", {}).get("window")

    # ----- pieces -----

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        wf = w.to(torch.float32)
        if self.precision == "fp8":
            return _fp8(x, -1) @ _fp8(wf, 0)
        return x @ wf

    def _lora(self, x, entry) -> torch.Tensor:
        b, a = entry
        return ((x @ a.T) @ b.T) * self.scaling

    def _linear(self, x, w, entry) -> torch.Tensor:
        y = self._mm(x, w)
        return y if entry is None else y + self._lora(x, entry)

    def _norm(self, x: torch.Tensor) -> torch.Tensor:
        var = torch.mean(x * x, dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.eps)

    def _rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        dh = x.shape[-1]
        half = torch.arange(0, dh, 2, dtype=torch.float64) / dh
        freqs = (1.0 / (float(self.cfg["rope_theta"]) ** half)).to(
            torch.float32).to(x.device)
        ang = (pos.to(torch.float32)[:, None] * freqs)[:, None, :]
        cos, sin = torch.cos(ang), torch.sin(ang)
        x1, x2 = torch.chunk(x, 2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def _attention(self, h, lw, lora, li):
        n = self.n
        t = h.shape[0]
        ent = (lambda name: lora[name][li]) if lora else (lambda name: None)
        q = self._linear(h, lw["wq"], ent("wq")).view(t, n["h"], n["dh"])
        k = self._linear(h, lw["wk"], ent("wk")).view(t, n["kv"], n["dh"])
        v = self._linear(h, lw["wv"], ent("wv")).view(t, n["kv"], n["dh"])
        pos = torch.arange(t, device=h.device)
        q, k = self._rope(q, pos), self._rope(k, pos)
        g = n["h"] // n["kv"]
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
        scores = torch.einsum("thd,shd->hts", q, k) / math.sqrt(n["dh"])
        ok = pos[None, :] <= pos[:, None]
        if self.window is not None:
            ok &= pos[None, :] > pos[:, None] - self.window
        scores = scores.masked_fill(~ok[None], float("-inf"))
        out = torch.einsum("hts,shd->thd", torch.softmax(scores, -1), v)
        return self._linear(out.reshape(t, -1), lw["wo"], ent("wo"))

    def _dense(self, h, lw, lora, li):
        ent = (lambda name: lora[name][li]) if lora else (lambda name: None)
        g = self._linear(h, lw["wg"], ent("wg"))
        u = self._linear(h, lw["wu"], ent("wu"))
        return self._linear(F.silu(g) * u, lw["wd"], ent("wd"))

    def router_probs(self, h, lw, lora, li) -> torch.Tensor:
        """fp32 router probabilities ``(T, E)`` (the router's weights are
        fp32, so the control keeps them)."""
        logits = h @ lw["router"].to(torch.float32)
        if lora:
            logits = logits + self._lora(h, lora["router"][li])
        return torch.softmax(logits, dim=-1)

    def _moe(self, h, lw, lora, li, route):
        n = self.n
        e, k = n["e"], n["k"]
        probs = self.router_probs(h, lw, lora, li)
        experts, keep = route(li, probs)                   # (T, k) each
        gate = torch.gather(probs, 1, experts)
        gate = gate / gate.sum(dim=-1, keepdim=True)
        y = torch.zeros_like(h)
        for ei in range(e):
            tok, slot = torch.nonzero((experts == ei) & keep, as_tuple=True)
            if tok.numel() == 0:
                continue
            xe = h[tok]
            ent = ((lambda name: lora[name][li * e + ei]) if lora
                   else (lambda name: None))
            g = self._linear(xe, lw["xwg"][ei], ent("xwg"))
            u = self._linear(xe, lw["xwu"][ei], ent("xwu"))
            out = self._linear(F.silu(g) * u, lw["xwd"][ei], ent("xwd"))
            y.index_add_(0, tok, out * gate[tok, slot][:, None])
        return y

    # ----- whole sequence -----

    def logits(self, tokens: Sequence[int], lora: Optional[Dict] = None,
               route: Optional[Callable] = None,
               from_pos: int = 0) -> torch.Tensor:
        """fp32 logits ``(T - from_pos, V)`` of positions ``from_pos..T-1``
        of one sequence. ``route(layer, probs)`` gives each token's ``(T,
        k)`` experts and which of them its expert rows kept; by default
        each token's own top k, all kept (no capacity)."""
        dev = self.w["embed"].device
        tok = torch.as_tensor(list(tokens), dtype=torch.int64, device=dev)
        x = self.w["embed"][tok].to(torch.float32)
        if route is None:
            route = self.top_k_route
        for li, lw in enumerate(self.w["layers"]):
            x = x + self._attention(self._norm(x), lw, lora, li)
            h = self._norm(x)
            x = x + (self._moe(h, lw, lora, li, route) if "e" in self.n
                     else self._dense(h, lw, lora, li))
        x = self._norm(x[from_pos:])
        return self._mm(x, self.w["head"].T)

    def top_k_route(self, li, probs) -> Tuple[torch.Tensor, torch.Tensor]:
        """Each token's k most probable experts, ties toward the lower
        index, all kept."""
        _, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        idx = idx[:, : self.n["k"]]
        return idx, torch.ones_like(idx, dtype=torch.bool)

