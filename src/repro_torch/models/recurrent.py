"""Recurrent token mixers (port of ``repro/models/recurrent.py``): RWKV-6
"Finch" time-mix / channel-mix and the RG-LRU block of
RecurrentGemma / Griffin.

Both are linear recurrences with O(1) decode state.

* RWKV-6 time-mix holds a matrix state ``S: (H, dk, dv)`` per layer:
      S_t = diag(w_t) S_{t-1} + k_t v_tᵀ
      y_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ)
  with data-dependent decay ``w_t``. Sequence mode is the reference's
  chunked scan: a Python loop over chunks carries the state, and within a
  chunk the earlier tokens' terms are batched products with the same
  exact block factorization (bounded factors off the diagonal, small
  ``(sub, sub, dh)`` tiles on it).
* RG-LRU is a diagonal gated linear recurrence:
      h_t = a_t ⊙ h_{t-1} + √(1−a_t²) ⊙ (i_t ⊙ x_t)
  evaluated over time by :func:`associative_scan`, the odd / even
  recursion of ``jax.lax.associative_scan`` in its combine order
  (O(log T) levels of elementwise ops).

Parameters are stacked ``(count, ...)`` per layer group, as the other
``init_*`` functions stack them. The arithmetic is the reference's:
fp32 decays and states, ``log(clip(w, 1e-12, 1))`` in the scan, the tanh
GELU, ``softplus`` as ``logaddexp(x, 0)``, population variance in the
group norm, and the causal conv's taps summed in order in fp32. Pad
tokens of a left-padded row flow through the states, as in the
reference (its pad masks cover attention only).

Under tensor parallelism (``tp``) the per-head and per-channel leaves the
rule table leaves whole (RWKV's decay, bonus, mus and group norm; RG-LRU's
conv taps and decay) are cut to the rank's heads or channels on the rank;
the chunked scan and the odd / even scan keep the reference's order, which
is local per channel.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.parallel.collectives import (gather_from_region,
                                              reduce_from_region)

from .common import init_linear, init_lora, linear

Params = Dict[str, Any]

RWKV_LORA_DIM = 32      # ddlerp bottleneck
RWKV_DECAY_DIM = 64


# ==========================================================================
# RWKV-6
# ==========================================================================

def _full(lead, shape, value, device) -> torch.Tensor:
    return torch.full(tuple(lead) + tuple(shape), value, dtype=torch.float32,
                      device=device)


def _stacked(row: np.ndarray, lead, device) -> torch.Tensor:
    """A per-channel fp32 constant (computed by numpy, as the reference
    does) broadcast to ``(*lead, n)``."""
    t = torch.from_numpy(row.astype(np.float32)).to(device)
    return t.expand(tuple(lead) + t.shape).clone()


def init_rwkv_tmix(gen: torch.Generator, cfg, lora_rank: Optional[int],
                   count: int):
    """Stacked ``(count, ...)`` RWKV-6 time-mix params (fp32 mixing,
    decay and norm params; ``wr`` / ``wk`` / ``wv`` / ``wg`` / ``wo`` in
    ``cfg.dtype``) and LoRA factors on those five."""
    d = cfg.d_model
    h = d // cfg.rwkv_head_dim
    lead = (count,)
    dev = gen.device
    w2 = torch.empty(lead + (5, RWKV_LORA_DIM, d), dtype=torch.float32,
                     device=dev)
    w2.normal_(0.0, 1.0, generator=gen)
    names = ("wr", "wk", "wv", "wg", "wo")
    base = {
        "mu_base": _full(lead, (d,), 0.5, dev),
        "mu": _full(lead, (5, d), 0.5, dev),              # r,k,v,w,g lerp
        "ddlerp_w1": init_linear(gen, d, 5 * RWKV_LORA_DIM, torch.float32,
                                 lead),
        "ddlerp_w2": w2 * 0.01,
        "decay_base": _stacked(np.linspace(-6.0, -0.5, d, dtype=np.float32),
                               lead, dev),                # w0 per channel
        "decay_w1": init_linear(gen, d, RWKV_DECAY_DIM, torch.float32, lead),
        "decay_w2": init_linear(gen, RWKV_DECAY_DIM, d, torch.float32, lead),
        "bonus": _full(lead, (h, cfg.rwkv_head_dim), 0.0, dev),   # u
        **{n: init_linear(gen, d, d, cfg.dtype, lead) for n in names},
        "gn_w": _full(lead, (d,), 1.0, dev),
        "gn_b": _full(lead, (d,), 0.0, dev),
    }
    lora = None
    if lora_rank is not None:
        lora = {n: init_lora(gen, d, d, lora_rank, cfg.lora_dtype, lead)
                for n in names}
    return base, lora


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]):
    """x_{t-1}, the step before the sequence supplied by ``prev`` (zeros
    at t = 0 in sequence mode, the carried state in decode)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


def _lora(lora, name):
    return lora.get(name) if lora else None


def _rwkv_projections(x, base, lora, scaling, x_prev):
    """r, k, v, g and the decay w of a ``(B, T, d)`` slab."""
    xf = x.to(torch.float32)
    sx = _token_shift(xf, x_prev) - xf
    xxx = xf + sx * base["mu_base"]
    mix = torch.tanh(xxx @ base["ddlerp_w1"]["w"])
    b, t, _ = x.shape
    mix = mix.reshape(b, t, 5, RWKV_LORA_DIM)
    adj = torch.einsum("btfk,fkd->btfd", mix, base["ddlerp_w2"])
    mus = base["mu"][None, None] + adj                     # (B,T,5,d)
    xr, xk, xv, xw, xg = [xf + sx * mus[:, :, i] for i in range(5)]

    r = linear(xr.to(x.dtype), base["wr"], _lora(lora, "wr"), scaling)
    k = linear(xk.to(x.dtype), base["wk"], _lora(lora, "wk"), scaling)
    v = linear(xv.to(x.dtype), base["wv"], _lora(lora, "wv"), scaling)
    g = F.silu(linear(xg.to(x.dtype), base["wg"], _lora(lora, "wg"),
                      scaling))
    decay = (base["decay_base"]
             + torch.tanh(xw @ base["decay_w1"]["w"]) @ base["decay_w2"]["w"])
    w = torch.exp(-torch.exp(decay.to(torch.float32)))     # (B,T,d) in (0,1)
    return r, k, v, g, w


def _rwkv_heads(z, h, dh):
    b, t, _ = z.shape
    return z.reshape(b, t, h, dh)


def _chunk_step(s, rc, kc, vc, lw, u, sub):
    """One chunk of the sequence scan (the reference's ``chunk_step``):
    ``rc``, ``kc``, ``vc``, ``lw`` are ``(B, H, c, dh)``, ``s`` the
    ``(B, H, dk, dv)`` state entering the chunk. Returns the state at its
    end and the chunk's outputs."""
    bq, hq, c, dh = rc.shape
    nsub = c // sub
    dev = rc.device
    cum = torch.cumsum(lw, dim=2)                          # inclusive logs
    cumx = F.pad(cum, (0, 0, 1, 0))[:, :, :-1]
    dec_to_end = torch.exp(cum[:, :, -1:] - cum)           # Π_{j>i} w_j
    # inter-chunk: r_i · exp(cumx_i) · S
    y_inter = torch.einsum("bhik,bhkv->bhiv", rc * torch.exp(cumx), s)

    # intra-chunk pairwise coefficient exp(cumx_i − cum_j), j < i, by the
    # exact block factorization: for query block I with boundary offset
    # m_I = cumx[I·sub], exp(cumx_i − m_I) ≤ 1 and exp(m_I − cum_j) ≤ 1
    # for j before block I, and their product is the exact coefficient;
    # within-block pairs use (sub, sub, dh) diagonal tiles
    m = cumx[:, :, ::sub]                                  # (B,H,nsub,dh)
    rb = rc.reshape(bq, hq, nsub, sub, dh)
    cumxb = cumx.reshape(bq, hq, nsub, sub, dh)
    cumb = cum.reshape(bq, hq, nsub, sub, dh)
    r2 = rb * torch.exp(cumxb - m[:, :, :, None])          # (B,H,nsub,sub,dh)
    k2 = kc[:, :, None] * torch.exp(
        torch.clamp(m[:, :, :, None] - cum[:, :, None], max=0.0))
    att_off = torch.einsum("bhnik,bhnjk->bhnij", r2, k2)   # (B,H,nsub,sub,c)
    ci = torch.arange(c, device=dev)
    blk_start = (torch.arange(nsub, device=dev) * sub)[:, None, None]
    off_mask = ci[None, None, :] < blk_start               # j before block
    att_off = torch.where(off_mask[None, None], att_off, 0.0)
    y_off = torch.einsum("bhnij,bhjv->bhniv", att_off, vc)

    # diagonal tiles: exact within-block decays
    dmat = torch.exp(cumxb[:, :, :, :, None] - cumb[:, :, :, None])
    si = torch.arange(sub, device=dev)
    strict = si[None, :] < si[:, None]                     # j < i in block
    att_diag = torch.einsum(
        "bhnik,bhnijk,bhnjk->bhnij", rb,
        torch.where(strict[None, None, None, :, :, None], dmat, 0.0),
        kc.reshape(bq, hq, nsub, sub, dh))
    y_diag = torch.einsum("bhnij,bhnjv->bhniv", att_diag,
                          vc.reshape(bq, hq, nsub, sub, dh))

    att_self = torch.einsum("bhik,hk,bhik->bhi", rc, u, kc)
    y_intra = ((y_off + y_diag).reshape(bq, hq, c, dh)
               + att_self[..., None] * vc)
    # state update to the end of the chunk
    s_new = torch.exp(cum[:, :, -1])[..., None] * s + torch.einsum(
        "bhik,bhiv->bhkv", kc * dec_to_end, vc)
    return s_new, y_inter + y_intra


def rwkv_tmix(
    x: torch.Tensor,
    base: Params,
    lora: Optional[Params],
    cfg,
    *,
    state: Optional[Params] = None,   # {"x_prev": (B,1,d), "s": (B,H,dk,dv)}
    chunk: int = 64,
    scaling: float = 2.0,
    tp=None,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """RWKV-6 time-mix of ``x: (B, T, d)``: one recurrence step at T = 1,
    else the chunked scan (T must be a multiple of ``min(chunk, T)``, as
    in the reference). Returns ``(out, new_state)``; the state is None in
    sequence mode without ``state``."""
    if tp is not None:
        return _rwkv_tmix_tp(x, base, lora, cfg, tp, state, chunk, scaling)
    d = cfg.d_model
    dh = cfg.rwkv_head_dim
    h = d // dh
    b, t, _ = x.shape
    x_prev = state["x_prev"] if state is not None else None
    r, k, v, g, w = _rwkv_projections(x, base, lora, scaling, x_prev)
    r = _rwkv_heads(r.to(torch.float32), h, dh)
    k = _rwkv_heads(k.to(torch.float32), h, dh)
    v = _rwkv_heads(v.to(torch.float32), h, dh)
    w = _rwkv_heads(w, h, dh)                              # (B,T,H,dh)
    u = base["bonus"]                                      # (H, dh)

    s0 = (state["s"] if state is not None
          else torch.zeros((b, h, dh, dh), dtype=torch.float32,
                           device=x.device))

    if t == 1:
        # decode: one recurrence step
        kv = torch.einsum("bhk,bhv->bhkv", k[:, 0], v[:, 0])
        out = torch.einsum("bhk,bhkv->bhv", r[:, 0],
                           s0 + u[None, :, :, None] * kv)
        s1 = w[:, 0][..., None] * s0 + kv
        y = out[:, None]                                   # (B,1,H,dh)
        new_state = {"x_prev": x[:, -1:], "s": s1}
    else:
        c = min(chunk, t)
        if t % c:
            raise ValueError(f"seq len {t} must be divisible by chunk {c}")
        nc = t // c

        def resh(z):                                       # (nc,B,H,c,dh)
            return z.reshape(b, nc, c, h, dh).permute(1, 0, 3, 2, 4)

        rs, ks, vs, ws = map(resh, (r, k, v, w))
        logw = torch.log(torch.clamp(ws, 1e-12, 1.0))
        sub = 16 if c % 16 == 0 else c                     # diagonal tile
        s, ys = s0, []
        for i in range(nc):
            s, yc = _chunk_step(s, rs[i], ks[i], vs[i], logw[i], u, sub)
            ys.append(yc)
        y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(b, t, h, dh)
        new_state = ({"x_prev": x[:, -1:], "s": s} if state is not None
                     else None)

    # per-head group norm, then gate and output projection
    yf = y.reshape(b, -1, h, dh)
    mu = torch.mean(yf, dim=-1, keepdim=True)
    var = torch.var(yf, dim=-1, keepdim=True, correction=0)
    yf = (yf - mu) * torch.rsqrt(var + 64e-5)
    yf = yf.reshape(b, -1, d) * base["gn_w"] + base["gn_b"]
    out = linear((yf * g.to(torch.float32)).to(x.dtype), base["wo"],
                 _lora(lora, "wo"), scaling)
    return out, new_state


def init_rwkv_cmix(gen: torch.Generator, cfg, lora_rank: Optional[int],
                   count: int):
    """Stacked ``(count, ...)`` RWKV-6 channel-mix params and LoRA factors
    on ``wk`` ``(d, d_ff)``, ``wv`` ``(d_ff, d)`` and ``wr`` ``(d, d)``."""
    d, f = cfg.d_model, cfg.d_ff
    lead = (count,)
    dev = gen.device
    shapes = {"wk": (d, f), "wv": (f, d), "wr": (d, d)}
    base = {"mu_k": _full(lead, (d,), 0.5, dev),
            "mu_r": _full(lead, (d,), 0.5, dev),
            **{n: init_linear(gen, i, o, cfg.dtype, lead)
               for n, (i, o) in shapes.items()}}
    lora = None
    if lora_rank is not None:
        lora = {n: init_lora(gen, i, o, lora_rank, cfg.lora_dtype, lead)
                for n, (i, o) in shapes.items()}
    return base, lora


def rwkv_cmix(
    x: torch.Tensor,
    base: Params,
    lora: Optional[Params],
    cfg,
    *,
    state: Optional[Params] = None,   # {"x_prev": (B,1,d)}
    scaling: float = 2.0,
    tp=None,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """RWKV-6 channel mix: ``sigmoid(r) · wv(relu(wk(x_k))²)`` over
    token-shifted inputs. Returns ``(out, new_state)``."""
    if tp is not None:
        return _rwkv_cmix_tp(x, base, lora, cfg, tp, state, scaling)
    xf = x.to(torch.float32)
    prev = state["x_prev"] if state is not None else None
    sx = _token_shift(xf, prev) - xf
    xk = (xf + sx * base["mu_k"]).to(x.dtype)
    xr = (xf + sx * base["mu_r"]).to(x.dtype)
    k = linear(xk, base["wk"], _lora(lora, "wk"), scaling)
    k = torch.square(torch.relu(k))
    kv = linear(k, base["wv"], _lora(lora, "wv"), scaling)
    r = torch.sigmoid(linear(xr, base["wr"], _lora(lora, "wr"), scaling))
    out = r * kv
    new_state = {"x_prev": x[:, -1:]} if state is not None else None
    return out, new_state


def init_rwkv_state(cfg, batch: int, device=None, count: int = 1):
    """Zeroed ``(count, B, ...)`` RWKV states: the time mix's ``x_prev``
    (``cfg.dtype``) and fp32 ``s``, the channel mix's ``x_prev``."""
    d = cfg.d_model
    dh = cfg.rwkv_head_dim
    h = d // dh
    lead = (count, batch)
    return {
        "tmix": {
            "x_prev": torch.zeros(lead + (1, d), dtype=cfg.dtype,
                                  device=device),
            "s": torch.zeros(lead + (h, dh, dh), dtype=torch.float32,
                             device=device),
        },
        "cmix": {"x_prev": torch.zeros(lead + (1, d), dtype=cfg.dtype,
                                       device=device)},
    }


# ==========================================================================
# RG-LRU (RecurrentGemma / Griffin)
# ==========================================================================

RGLRU_C = 8.0


def init_rglru(gen: torch.Generator, cfg, lora_rank: Optional[int],
               count: int):
    """Stacked ``(count, ...)`` RG-LRU params (``w_in`` / ``w_gate`` /
    ``w_out`` in ``cfg.dtype``; the conv, decay and gate params fp32) and
    LoRA factors on ``w_in``, ``w_gate`` and ``w_out``."""
    d = cfg.d_model
    width = cfg.rglru_width or d
    cw = cfg.conv_width
    lead = (count,)
    dev = gen.device
    conv_w = torch.empty(lead + (cw, width), dtype=torch.float32, device=dev)
    conv_w.normal_(0.0, 1.0, generator=gen)
    base = {
        "w_in": init_linear(gen, d, width, cfg.dtype, lead),
        "w_gate": init_linear(gen, d, width, cfg.dtype, lead),
        "conv_w": conv_w * 0.02,
        "conv_b": _full(lead, (width,), 0.0, dev),
        # softplus parameter of the per-channel decay rate; the linspace
        # spreads the decay horizons across channels (Griffin init)
        "lambda_p": _stacked(np.linspace(0.5, 4.0, width), lead, dev),
        "w_ix": init_linear(gen, width, width, torch.float32, lead),
        "w_ax": init_linear(gen, width, width, torch.float32, lead),
        "w_out": init_linear(gen, width, d, cfg.dtype, lead),
    }
    lora = None
    if lora_rank is not None:
        shapes = {"w_in": (d, width), "w_gate": (d, width),
                  "w_out": (width, d)}
        lora = {n: init_lora(gen, i, o, lora_rank, cfg.lora_dtype, lead)
                for n, (i, o) in shapes.items()}
    return base, lora


def _causal_conv(y, conv_w, conv_b, prev: Optional[torch.Tensor]):
    """Depthwise causal conv over time in fp32, its ``cw`` taps summed in
    order; ``prev`` holds the last ``cw - 1`` inputs in decode mode.
    Returns the output in ``y``'s dtype and the fp32 conv state."""
    cw = conv_w.shape[0]
    yf = y.to(torch.float32)
    if prev is None:
        pad = torch.zeros_like(yf[:, : cw - 1])
    else:
        pad = prev.to(torch.float32)
    ypad = torch.cat([pad, yf], dim=1)
    t = yf.shape[1]
    out = ypad[:, 0:t] * conv_w[0]
    for i in range(1, cw):
        out = out + ypad[:, i:i + t] * conv_w[i]
    return (out + conv_b).to(y.dtype), ypad[:, -(cw - 1):]


def associative_scan(combine, elems, dim: int = 1):
    """``jax.lax.associative_scan`` over ``dim`` of the tensors in the
    list ``elems``: combine adjacent pairs, recurse on the half, combine
    the results with ``elems[2::2]`` and interleave — the reference's
    recursion and combine order. ``combine(a, b)`` takes and returns
    lists."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def sl(e, start, stop=None, step=1):
        idx = [slice(None)] * e.dim()
        idx[dim] = slice(start, stop, step)
        return e[tuple(idx)]

    reduced = combine([sl(e, 0, n - 1, 2) for e in elems],
                      [sl(e, 1, None, 2) for e in elems])
    odd = associative_scan(combine, reduced, dim)
    if n % 2 == 0:
        even = combine([sl(e, 0, -1) for e in odd],
                       [sl(e, 2, None, 2) for e in elems])
    else:
        even = combine(odd, [sl(e, 2, None, 2) for e in elems])
    even = [torch.cat([sl(e, 0, 1), r], dim=dim)
            for e, r in zip(elems, even)]
    out = []
    for a, o in zip(even, odd):
        shape = list(a.shape)
        shape[dim] = n
        z = torch.empty(shape, dtype=a.dtype, device=a.device)
        sl(z, 0, None, 2).copy_(a)
        sl(z, 1, None, 2).copy_(o)
        out.append(z)
    return out


def _lru_combine(c1, c2):
    a1, b1 = c1
    a2, b2 = c2
    return [a1 * a2, a2 * b1 + b2]


def rglru_block(
    x: torch.Tensor,
    base: Params,
    lora: Optional[Params],
    cfg,
    *,
    state: Optional[Params] = None,   # {"h": (B,width), "conv": (B,cw-1,width)}
    scaling: float = 2.0,
    tp=None,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Griffin's recurrent block: a tanh-GELU gate branch times the RG-LRU
    over the causally convolved input branch, then ``w_out``. One step at
    T = 1 with a state, else the associative scan with ``h0`` folded into
    step 0. Returns ``(out, new_state)``; the new conv state is in ``x``'s
    dtype, as the reference rounds it."""
    if tp is not None:
        return _rglru_block_tp(x, base, lora, cfg, tp, state, scaling)
    gate = F.gelu(linear(x, base["w_gate"], _lora(lora, "w_gate"), scaling),
                  approximate="tanh")
    y = linear(x, base["w_in"], _lora(lora, "w_in"), scaling)
    y, conv_state = _causal_conv(
        y, base["conv_w"], base["conv_b"],
        state["conv"] if state is not None else None)

    yf = y.to(torch.float32)
    i_gate = torch.sigmoid(yf @ base["w_ix"]["w"])
    a_gate = torch.sigmoid(yf @ base["w_ax"]["w"])
    softplus = torch.logaddexp(base["lambda_p"],
                               torch.zeros_like(base["lambda_p"]))
    log_a = -RGLRU_C * softplus * a_gate                   # (B,T,w)
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp(1.0 - a * a, 1e-12, 1.0)) * (
        i_gate * yf)

    h0 = state["h"] if state is not None else None
    if y.shape[1] == 1 and h0 is not None:
        new_h = a[:, 0] * h0 + gated_in[:, 0]
        hs = new_h[:, None]
    else:
        if h0 is not None:
            gated_in = torch.cat([gated_in[:, :1] + (a[:, 0] * h0)[:, None],
                                  gated_in[:, 1:]], dim=1)
        _, hs = associative_scan(_lru_combine, [a, gated_in], dim=1)
        new_h = hs[:, -1]

    out = linear((hs * gate.to(torch.float32)).to(x.dtype), base["w_out"],
                 _lora(lora, "w_out"), scaling)
    new_state = ({"h": new_h, "conv": conv_state.to(x.dtype)}
                 if state is not None else None)
    return out, new_state


def init_rglru_state(cfg, batch: int, device=None, count: int = 1):
    """Zeroed ``(count, B, ...)`` RG-LRU states: fp32 ``h`` and the conv
    window in ``cfg.dtype``."""
    width = cfg.rglru_width or cfg.d_model
    lead = (count, batch)
    return {
        "h": torch.zeros(lead + (width,), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros(lead + (cfg.conv_width - 1, width),
                            dtype=cfg.dtype, device=device),
    }


# ==========================================================================
# tensor parallelism
# ==========================================================================

def _state_cols(tp, t, n: int, lo: int, hi: int):
    """Columns ``[lo, hi)`` of a state whose last dim holds all ``n`` or
    this rank's block of them (as ``cache_specs`` places it)."""
    if t.shape[-1] != n:
        t = gather_from_region(t, -1, tp.group)
    return t[..., lo:hi]


def _state_back(tp, t, n: int, lo: int, hi: int, held: int):
    """A state computed on columns ``[lo, hi)`` in the layout its cache
    holds: all ``n`` columns, or (``held < n``) this rank's block."""
    if (lo, hi) != (0, n):
        if (lo, hi) == tp.block(n) and held == hi - lo:
            return t
        t = gather_from_region(t, -1, tp.group)
    if held == n:
        return t
    b0, b1 = tp.block(n)
    return t[..., b0:b1]


def _rwkv_tmix_tp(x, base, lora, cfg, tp, state, chunk, scaling):
    """RWKV-6 time mix over this rank's heads: the token shift and decay
    whole on every rank, ``wr`` / ``wk`` / ``wv`` / ``wg`` column- and
    ``wo`` row-parallel, the scan on the heads of the rank's block of
    ``wo``'s input. The decode step runs in the state's cache layout (key
    dim split over ``model``): every head's partial output over the rank's
    key rows, summed over the ranks."""
    d = cfg.d_model
    dh = cfg.rwkv_head_dim
    h = d // dh
    b, t, _ = x.shape
    la = lora or {}
    x_prev = None
    if state is not None:
        x_prev = _state_cols(tp, state["x_prev"], d, 0, d)
    xf = x.to(torch.float32)
    sx = _token_shift(xf, x_prev) - xf
    xxx = xf + sx * base["mu_base"]
    mix = torch.tanh(xxx @ base["ddlerp_w1"]["w"]).reshape(b, t, 5,
                                                           RWKV_LORA_DIM)
    adj = torch.einsum("btfk,fkd->btfd", mix, base["ddlerp_w2"])
    mus = base["mu"][None, None] + adj
    xr, xk, xv, xw, xg = [xf + sx * mus[:, :, i] for i in range(5)]
    r, rs = tp.linear(xr.to(x.dtype), base["wr"], la.get("wr"), scaling)
    k, ks = tp.linear(xk.to(x.dtype), base["wk"], la.get("wk"), scaling)
    v, vs = tp.linear(xv.to(x.dtype), base["wv"], la.get("wv"), scaling)
    g, gs = tp.linear(xg.to(x.dtype), base["wg"], la.get("wg"), scaling)
    g = F.silu(g)
    decay = (base["decay_base"]
             + torch.tanh(xw @ base["decay_w1"]["w"]) @ base["decay_w2"]["w"])
    w = torch.exp(-torch.exp(decay.to(torch.float32)))     # (B,T,d), whole

    if t == 1 and state is not None:
        rf, kf, vf = (tp.rep(z, zs).to(torch.float32).reshape(b, h, dh)
                      for z, zs in ((r, rs), (k, ks), (v, vs)))
        s0 = state["s"]                                    # (B,H,dkl,dv)
        k0, k1 = tp.block(dh) if s0.shape[2] < dh else (0, dh)
        kv = torch.einsum("bhk,bhv->bhkv", kf[..., k0:k1], vf)
        u = base["bonus"][:, k0:k1]
        out = torch.einsum("bhk,bhkv->bhv", rf[..., k0:k1],
                           s0 + u[None, :, :, None] * kv)
        if k1 - k0 < dh:
            out = reduce_from_region(out, tp.group)
        s1 = w.reshape(b, h, dh)[..., k0:k1][..., None] * s0 + kv
        y = out[:, None]                                   # (B,1,H,dh)
        c0, c1, h0, h1 = 0, d, 0, h
        gg = tp.rep(g, gs)
        distinct = False
        new_state = {"s": s1}
    else:
        distinct, c0, c1, h0, h1 = tp.heads(base["wo"], h, dh)
        nh = h1 - h0
        rr, kk, vv = (tp.cols(z, zs, h0 * dh, h1 * dh, distinct).to(
            torch.float32).reshape(b, t, nh, dh)
            for z, zs in ((r, rs), (k, ks), (v, vs)))
        ww = tp.cols(w, False, h0 * dh, h1 * dh, distinct).reshape(
            b, t, nh, dh)
        gg = tp.cols(g, gs, h0 * dh, h1 * dh, distinct)
        u = base["bonus"][h0:h1]
        if state is not None:
            s_all = state["s"]
            if s_all.shape[2] < dh:
                s_all = gather_from_region(s_all, 2, tp.group)
            s0 = s_all[:, h0:h1]
        else:
            s0 = torch.zeros((b, nh, dh, dh), dtype=torch.float32,
                             device=x.device)
        cc = min(chunk, t)
        if t % cc:
            raise ValueError(f"seq len {t} must be divisible by chunk {cc}")
        nc = t // cc

        def resh(z):                                       # (nc,B,H,c,dh)
            return z.reshape(b, nc, cc, nh, dh).permute(1, 0, 3, 2, 4)

        rs_, ks_, vs_, ws_ = map(resh, (rr, kk, vv, ww))
        logw = torch.log(torch.clamp(ws_, 1e-12, 1.0))
        sub = 16 if cc % 16 == 0 else cc
        s, ys = s0, []
        for i in range(nc):
            s, yc = _chunk_step(s, rs_[i], ks_[i], vs_[i], logw[i], u, sub)
            ys.append(yc)
        y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(b, t, nh, dh)
        new_state = None
        if state is not None:
            if nh != h:
                if nh * tp.m != h or (h0, h1) != (tp.j * nh, tp.j * nh + nh):
                    raise NotImplementedError(
                        f"an RWKV state over {h} heads split unevenly over "
                        f"{tp.m} 'model' ranks")
                s = gather_from_region(s, 1, tp.group)
            if state["s"].shape[2] < dh:
                kb0, kb1 = tp.block(dh)
                s = s[:, :, kb0:kb1]
            new_state = {"s": s}

    nh = h1 - h0
    yf = y.reshape(b, -1, nh, dh)
    mu = torch.mean(yf, dim=-1, keepdim=True)
    var = torch.var(yf, dim=-1, keepdim=True, correction=0)
    yf = (yf - mu) * torch.rsqrt(var + 64e-5)
    yf = (yf.reshape(b, -1, nh * dh) * base["gn_w"][h0 * dh:h1 * dh]
          + base["gn_b"][h0 * dh:h1 * dh])
    out = (yf * gg.to(torch.float32)).to(x.dtype)
    out = out[..., c0 - h0 * dh:c1 - h0 * dh]
    if new_state is not None:
        held = state["x_prev"].shape[-1]
        new_state["x_prev"] = _state_back(tp, x[:, -1:], d, 0, d, held)
    y, ysh = tp.linear(out, base["wo"], la.get("wo"), scaling, distinct)
    return tp.rep(y, ysh), new_state


def _rwkv_cmix_tp(x, base, lora, cfg, tp, state, scaling):
    """RWKV-6 channel mix over this rank's blocks, each linear as its
    spec says."""
    d = cfg.d_model
    la = lora or {}
    xf = x.to(torch.float32)
    prev = (None if state is None
            else _state_cols(tp, state["x_prev"], d, 0, d))
    sx = _token_shift(xf, prev) - xf
    xk = (xf + sx * base["mu_k"]).to(x.dtype)
    xr = (xf + sx * base["mu_r"]).to(x.dtype)
    k, ks = tp.linear(xk, base["wk"], la.get("wk"), scaling)
    k = torch.square(torch.relu(k))
    kv, kvs = tp.linear(k, base["wv"], la.get("wv"), scaling, ks)
    r, rs = tp.linear(xr, base["wr"], la.get("wr"), scaling)
    r = torch.sigmoid(r)
    if kvs != rs:
        r, kv, rs = tp.shard(r, rs), tp.shard(kv, kvs), True
    out = tp.rep(r * kv, rs)
    new_state = None
    if state is not None:
        new_state = {"x_prev": _state_back(tp, x[:, -1:], d, 0, d,
                                           state["x_prev"].shape[-1])}
    return out, new_state


def _rglru_block_tp(x, base, lora, cfg, tp, state, scaling):
    """Griffin's recurrent block over this rank's channels (the block of
    ``w_out``'s input): ``w_in`` / ``w_gate`` column-parallel, the conv,
    gates and scan per channel, ``w_out`` row-parallel; ``w_ix`` / ``w_ax``
    (column-parallel) take the whole width."""
    width = cfg.rglru_width or cfg.d_model
    la = lora or {}
    (gate, gs), (y, ys) = tp.linears(
        x, [(base[n], la.get(n)) for n in ("w_gate", "w_in")], scaling)
    gate = F.gelu(gate, approximate="tanh")
    distinct = tp.splits_in(base["w_out"])
    c0, c1 = tp.block(width) if distinct else (0, width)
    gate = tp.cols(gate, gs, c0, c1, distinct)
    y = tp.cols(y, ys, c0, c1, distinct)
    prev = (None if state is None
            else _state_cols(tp, state["conv"], width, c0, c1))
    y, conv_state = _causal_conv(y, base["conv_w"][:, c0:c1],
                                 base["conv_b"][c0:c1], prev)
    yf = y.to(torch.float32)
    gates = []
    for name in ("w_ix", "w_ax"):
        z, zs = tp.linear(yf, base[name], None, 1.0, distinct)
        gates.append(torch.sigmoid(tp.cols(z, zs, c0, c1, distinct)))
    i_gate, a_gate = gates
    lam = base["lambda_p"][c0:c1]
    softplus = torch.logaddexp(lam, torch.zeros_like(lam))
    a = torch.exp(-RGLRU_C * softplus * a_gate)
    gated_in = torch.sqrt(torch.clamp(1.0 - a * a, 1e-12, 1.0)) * (
        i_gate * yf)
    h0 = (None if state is None
          else _state_cols(tp, state["h"], width, c0, c1))
    if y.shape[1] == 1 and h0 is not None:
        new_h = a[:, 0] * h0 + gated_in[:, 0]
        hs = new_h[:, None]
    else:
        if h0 is not None:
            gated_in = torch.cat([gated_in[:, :1] + (a[:, 0] * h0)[:, None],
                                  gated_in[:, 1:]], dim=1)
        _, hs = associative_scan(_lru_combine, [a, gated_in], dim=1)
        new_h = hs[:, -1]
    out, osh = tp.linear((hs * gate.to(torch.float32)).to(x.dtype),
                         base["w_out"], la.get("w_out"), scaling, distinct)
    new_state = None
    if state is not None:
        new_state = {
            "h": _state_back(tp, new_h, width, c0, c1,
                             state["h"].shape[-1]),
            "conv": _state_back(tp, conv_state.to(x.dtype), width, c0, c1,
                                state["conv"].shape[-1])}
    return tp.rep(out, osh), new_state
