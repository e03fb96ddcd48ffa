"""Attention (port of ``repro/models/attention.py``): GQA (full or
sliding-window, optional soft-cap) and DeepSeek-V3's multi-head latent
attention (MLA) with its compressed KV cache.

Two modes, as in the JAX package:

* sequence mode (prefill): ``x: (B, T, d)``, causal mask (and the sliding
  window of ``local_attn`` layers), optional ``pad_mask: (B, T)`` (True =
  real token) so left-padded rows never attend to pad slots; with a cache
  the last ``min(T, cap)`` keys/values are written to their ring slots.
  Above ``BLOCKWISE_THRESHOLD`` tokens (or with ``force_blockwise``) the
  scores are never formed whole: :func:`_sdpa_blockwise` walks the keys in
  chunks with an online softmax;
* decode mode: ``x: (B, 1, d)`` with a ring-buffer cache written at per-row
  ``cache_pos: (B,)``; ``valid_start: (B,)`` masks each row's pad and stale
  slots. A windowed layer's ring holds at most ``window`` slots, so the
  window needs no mask at decode.

Unlike the JAX package, which returns new cache arrays, the cache tensors
are updated in place (the engine never reuses a cache it has handed on),
which saves a copy of the whole cache per layer and step.

Under tensor parallelism (``tp``) each rank runs the heads its block of
``wo``'s input needs: its own heads where the projections split on head
boundaries, else the heads overlapping its columns, their q / k / v
columns gathered from the ranks that hold them. Decode caches are held as
``cache_specs`` places them: by kv heads, where a rank attends its own;
else by head dim (or whole), where the ranks' partial scores are summed.
MLA's latent and rotary-key caches are split by their feature dims, so its
absorbed decode sums the ranks' partial scores too.

Rotary positions are standard RoPE, qwen2-vl's M-RoPE (``positions: (3, B,
T)``) or none, as ``cfg.rope`` says; gemma2 soft-caps the fp32 scores
(``cfg.attn_softcap``) before the mask.

MLA (:func:`mla_attention`) caches one compressed latent ``c`` and one
shared rotary key ``kr`` per token. Its sequence mode decompresses them
into per-head keys and values; its decode attends in the compressed space
with the key and value up-projections absorbed into the query and the
context. Its cache is linear, not a ring: slot index == padded index.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.parallel.collectives import (copy_to_region,
                                              gather_from_region,
                                              reduce_from_region)

from .common import (apply_mrope, apply_rope, init_linear, init_lora, linear,
                     rmsnorm)

Params = Dict[str, Any]

NEG_INF = -2.3819763e38  # most-negative bf16-representable; avoids nan softmax
BLOCKWISE_THRESHOLD = 8192   # switch to online-softmax attention above this
KV_CHUNK = 1024


def init_gqa(gen: torch.Generator, cfg, lora_rank: Optional[int], count: int):
    """Stacked ``(count, ...)`` GQA params and (optionally) LoRA factors."""
    d, h, kv, dh = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
    lead = (count,)
    shapes = {"wq": (d, h * dh), "wk": (d, kv * dh), "wv": (d, kv * dh),
              "wo": (h * dh, d)}
    base = {n: init_linear(gen, i, o, cfg.dtype, lead)
            for n, (i, o) in shapes.items()}
    lora = None
    if lora_rank is not None:
        lora = {n: init_lora(gen, i, o, lora_rank, cfg.lora_dtype, lead)
                for n, (i, o) in shapes.items()}
    return base, lora


def _split_heads(x, n, dh):
    return x.reshape(x.shape[:-1] + (n, dh))


def _causal_window_mask(t_q: int, t_kv: int, offset: int,
                        window: Optional[int], device) -> torch.Tensor:
    """(t_q, t_kv) additive mask. ``offset`` = absolute position of query 0."""
    qpos = torch.arange(t_q, device=device)[:, None] + offset
    kpos = torch.arange(t_kv, device=device)[None, :]
    ok = kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def _pad_key_mask(pad_mask: torch.Tensor, extra_dims: int) -> torch.Tensor:
    """(B, S) bool validity → additive (B, 1, ..., 1, S) mask with
    ``extra_dims`` unit axes."""
    m = torch.where(pad_mask, 0.0, NEG_INF).to(torch.float32)
    return m.reshape((m.shape[0],) + (1,) * extra_dims + (m.shape[1],))


def _sdpa(q, k, v, mask, cap: Optional[float] = None) -> torch.Tensor:
    """q, k: (B,T,H,dh), (B,S,KV,dh) with H = KV·G; v: (B,S,KV,dv). fp32
    softmax of the scores scaled by 1/√dh, soft-capped by ``cap`` before
    the mask; the probabilities are cast to ``v``'s dtype before the value
    product. Returns (B, T, H·dv)."""
    b, t, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    q = q.reshape(b, t, kvh, g, dh)
    scores = torch.einsum("btkgd,bskd->bkgts", q, k).to(torch.float32)
    scores = scores / np.sqrt(dh)
    if cap is not None:
        scores = cap * torch.tanh(scores / cap)
    scores = scores + mask
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v)
    return out.reshape(b, t, -1)


def _row_positions(cache_pos, valid_start, b: int, device):
    """Per-row ``(B,)`` int64 cache index of the incoming token and first
    real cache index (0 without ``valid_start``)."""
    pos = cache_pos.to(torch.int64).reshape(-1).expand(b)
    start = (torch.zeros((b,), dtype=torch.int64, device=device)
             if valid_start is None
             else valid_start.to(torch.int64).reshape(-1).expand(b))
    return pos, start


def _sdpa_blockwise(q, k, v, offset: int, window: Optional[int],
                    cap: Optional[float], chunk: int = KV_CHUNK,
                    pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flash-attention-style SDPA in plain PyTorch: a loop over KV chunks
    with an online softmax (running max and denominator) in fp32, so peak
    memory is O(B·H·T·chunk) instead of O(B·H·T·S). ``offset`` is the
    absolute position of query 0; masked scores are ``NEG_INF``, which
    keeps a chunk masked for a whole row finite (a later real key wipes
    its terms through ``alpha = 0``)."""
    b, t, h, dh = q.shape
    s, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    nchunks = -(-s // chunk)
    pad = nchunks * chunk - s
    dev = q.device
    q5 = q.reshape(b, t, kvh, g, dh).to(torch.float32)
    qpos = torch.arange(t, device=dev) + offset
    scale = 1.0 / np.sqrt(dh)
    m = torch.full((b, kvh, g, t), -torch.inf, dtype=torch.float32,
                   device=dev)
    den = torch.zeros((b, kvh, g, t), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kvh, g, t, dh), dtype=torch.float32, device=dev)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    for ci in range(nchunks):
        lo, hi = ci * chunk, min((ci + 1) * chunk, s)
        kc = k[:, lo:hi].to(torch.float32)
        vc = v[:, lo:hi].to(torch.float32)
        if pad and hi - lo < chunk:          # the last chunk, zero-padded
            kc = torch.nn.functional.pad(kc, (0, 0, 0, 0, 0, chunk - hi + lo))
            vc = torch.nn.functional.pad(vc, (0, 0, 0, 0, 0, chunk - hi + lo))
        scores = torch.einsum("btkgd,bskd->bkgts", q5, kc) * scale
        if cap is not None:
            scores = cap * torch.tanh(scores / cap)
        kpos = lo + torch.arange(chunk, device=dev)
        ok = kpos[None, :] <= qpos[:, None]
        if window is not None:
            ok &= kpos[None, :] > qpos[:, None] - window
        if pad:
            ok &= (kpos < s)[None, :]
        if pad_mask is not None:                          # (B, t, chunk)
            pm = pad_mask[:, lo:hi]
            if hi - lo < chunk:
                pm = torch.nn.functional.pad(pm, (0, chunk - hi + lo))
            okb = ok[None] & pm[:, None, :]
            scores = torch.where(okb[:, None, None], scores, neg)
        else:
            scores = torch.where(ok[None, None, None], scores, neg)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        den = den * alpha + p.sum(dim=-1)
        pv = torch.einsum("bkgts,bskd->bkgtd", p, vc)
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(den, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, t, h * dh)
    return out.to(q.dtype)


def gqa_attention(
    x: torch.Tensor,
    base: Params,
    lora: Optional[Params],
    cfg,
    *,
    positions: torch.Tensor,                   # (B, T); (3, B, T) mrope
    window: Optional[int] = None,
    cache: Optional[Params] = None,            # {"k","v"}: (B, S, KV, dh)
    cache_pos: Optional[torch.Tensor] = None,  # (B,) padded index
    valid_start: Optional[torch.Tensor] = None,  # (B,) first real index
    pad_mask: Optional[torch.Tensor] = None,     # (B, T) True = real token
    scaling: float = 2.0,
    force_blockwise: Optional[bool] = None,
    kv_chunk: int = KV_CHUNK,
    tp=None,
) -> torch.Tensor:
    if tp is not None:
        return _gqa_attention_tp(
            x, base, lora, cfg, tp, positions=positions, window=window,
            cache=cache, cache_pos=cache_pos, valid_start=valid_start,
            pad_mask=pad_mask, scaling=scaling,
            force_blockwise=force_blockwise, kv_chunk=kv_chunk)
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    b, t, _ = x.shape
    use_blockwise = (t > BLOCKWISE_THRESHOLD if force_blockwise is None
                     else force_blockwise and t > 1)
    def proj(name, width):
        return _split_heads(
            linear(x, base[name], lora and lora.get(name), scaling), width, dh)

    q, k, v = proj("wq", h), proj("wk", kv), proj("wv", kv)
    if cfg.rope == "standard":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope == "mrope":
        q = apply_mrope(q, positions, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, positions, cfg.mrope_sections, cfg.rope_theta)

    if cache is not None and t == 1:
        # decode: the cache is a ring buffer of ``cap`` slots; per row, slot
        # s holds the newest padded index p' ≤ pos with p' ≡ s (mod cap).
        # Pad slots (p' < valid_start) and stale slots of a previous
        # occupant (p' < 0) are masked; the window is free (cap ≤ window).
        cap = cache["k"].shape[1]
        pos_b, start_b = _row_positions(cache_pos, valid_start, b, x.device)
        slot = torch.remainder(pos_b, cap)
        rows = torch.arange(b, device=x.device)
        cache["k"][rows, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, slot] = v[:, 0].to(cache["v"].dtype)
        s_idx = torch.arange(cap, device=x.device)
        abs_pos = pos_b[:, None] - torch.remainder(
            pos_b[:, None] - s_idx[None, :], cap)
        mask = _pad_key_mask(abs_pos >= start_b[:, None], 3)
        out = _sdpa(q, cache["k"], cache["v"], mask, cfg.attn_softcap)
    else:
        if use_blockwise:
            out = _sdpa_blockwise(q, k, v, 0, window, cfg.attn_softcap,
                                  chunk=kv_chunk, pad_mask=pad_mask)
        else:
            mask = _causal_window_mask(t, t, 0, window, x.device)
            if pad_mask is not None:
                mask = mask + _pad_key_mask(pad_mask, 3)
            out = _sdpa(q, k, v, mask, cfg.attn_softcap)
        if cache is not None:
            _ring_write(cache, k, v)

    return linear(out, base["wo"], lora and lora.get("wo"), scaling)


def _ring_write(cache, k, v):
    """A stateful prefill from position 0: write the last min(T, cap)
    tokens at their ring slots (pad slots too; decode masks them)."""
    t = k.shape[1]
    cap = cache["k"].shape[1]
    keep = min(t, cap)
    start = (t - keep) % cap
    wrap = max(start + keep - cap, 0)
    for name, val in (("k", k), ("v", v)):
        src = val[:, t - keep:].to(cache[name].dtype)
        cache[name][:, start:start + keep - wrap] = src[:, :keep - wrap]
        if wrap:
            cache[name][:, :wrap] = src[:, keep - wrap:]


def _rotate(z, positions, cfg):
    if cfg.rope == "standard":
        return apply_rope(z, positions, cfg.rope_theta)
    if cfg.rope == "mrope":
        return apply_mrope(z, positions, cfg.mrope_sections, cfg.rope_theta)
    return z


def _cache_split(tp, cache_t, kv: int, dh: int):
    """The kv-head and head-dim ranges ``[lo, hi)`` a rank's ``(B, S,
    KVl, dhl)`` cache block holds (whole where not split)."""
    kvr = tp.block(kv) if cache_t.shape[2] < kv else (0, kv)
    dhr = tp.block(dh) if cache_t.shape[3] < dh else (0, dh)
    return kvr, dhr


def _gqa_attention_tp(x, base, lora, cfg, tp, *, positions, window, cache,
                      cache_pos, valid_start, pad_mask, scaling,
                      force_blockwise, kv_chunk):
    """GQA over this rank's blocks (see the module notes)."""
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    g = h // kv
    b, t, _ = x.shape
    la = lora or {}
    (q, qs), (k, ks), (v, vs) = tp.linears(
        x, [(base[n], la.get(n)) for n in ("wq", "wk", "wv")], scaling)
    if cache is not None and t == 1:
        out, osh = _gqa_decode_tp(tp, cfg, q, qs, k, ks, v, vs, cache,
                                  positions, cache_pos, valid_start)
        y, ysh = tp.linear(out, base["wo"], la.get("wo"), scaling, osh)
        return tp.rep(y, ysh)
    distinct, c0, c1, h0, h1 = tp.heads(base["wo"], h, dh)
    k0, k1 = h0 // g, (h1 - 1) // g + 1
    qh = tp.cols(q, qs, h0 * dh, h1 * dh, distinct).reshape(b, t, h1 - h0,
                                                              dh)
    kh = tp.cols(k, ks, k0 * dh, k1 * dh, distinct).reshape(b, t, k1 - k0,
                                                              dh)
    vh = tp.cols(v, vs, k0 * dh, k1 * dh, distinct).reshape(b, t, k1 - k0,
                                                              dh)
    qh, kh = _rotate(qh, positions, cfg), _rotate(kh, positions, cfg)
    ka, va = kh, vh
    if h0 % g or (h1 - h0) % g:
        # the rank's heads do not start or end on a kv group: give each
        # query head its own copy of its kv head
        idx = torch.arange(h0, h1, device=x.device) // g - k0
        ka, va = kh[:, :, idx], vh[:, :, idx]
    use_blockwise = (t > BLOCKWISE_THRESHOLD if force_blockwise is None
                     else force_blockwise and t > 1)
    if use_blockwise:
        out = _sdpa_blockwise(qh, ka, va, 0, window, cfg.attn_softcap,
                              chunk=kv_chunk, pad_mask=pad_mask)
    else:
        mask = _causal_window_mask(t, t, 0, window, x.device)
        if pad_mask is not None:
            mask = mask + _pad_key_mask(pad_mask, 3)
        out = _sdpa(qh, ka, va, mask, cfg.attn_softcap)
    out = out[..., c0 - h0 * dh:c1 - h0 * dh]
    if cache is not None:
        (a0, a1), (d0, d1) = _cache_split(tp, cache["k"], kv, dh)
        kc = _rotate(tp.cols(k, ks, a0 * dh, a1 * dh, False).reshape(
            b, t, a1 - a0, dh), positions, cfg)
        vc = tp.cols(v, vs, a0 * dh, a1 * dh, False).reshape(b, t, a1 - a0,
                                                              dh)
        _ring_write(cache, kc[..., d0:d1], vc[..., d0:d1])
    y, ysh = tp.linear(out, base["wo"], la.get("wo"), scaling, distinct)
    return tp.rep(y, ysh)


def _gqa_decode_tp(tp, cfg, q, qs, k, ks, v, vs, cache, positions,
                   cache_pos, valid_start):
    """One decode step against this rank's cache block; returns the
    attention output and whether it is the rank's block of columns."""
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    g = h // kv
    b = q.shape[0]
    qf = _rotate(tp.rep(q, qs).reshape(b, 1, h, dh), positions, cfg)
    kf = _rotate(tp.rep(k, ks).reshape(b, 1, kv, dh), positions, cfg)
    vf = tp.rep(v, vs).reshape(b, 1, kv, dh)
    ck, cv = cache["k"], cache["v"]
    (a0, a1), (d0, d1) = _cache_split(tp, ck, kv, dh)
    cap = ck.shape[1]
    pos_b, start_b = _row_positions(cache_pos, valid_start, b, q.device)
    slot = torch.remainder(pos_b, cap)
    rows = torch.arange(b, device=q.device)
    ck[rows, slot] = kf[:, 0, a0:a1, d0:d1].to(ck.dtype)
    cv[rows, slot] = vf[:, 0, a0:a1, d0:d1].to(cv.dtype)
    s_idx = torch.arange(cap, device=q.device)
    abs_pos = pos_b[:, None] - torch.remainder(
        pos_b[:, None] - s_idx[None, :], cap)
    mask = _pad_key_mask(abs_pos >= start_b[:, None], 3)
    if a1 - a0 < kv:
        # the rank's kv heads: its query heads attend them whole
        return _sdpa(qf[:, :, a0 * g:a1 * g], ck, cv, mask,
                     cfg.attn_softcap), True
    # split (or whole) head dim: every head's partial scores over the
    # rank's columns, summed over the ranks
    qg = qf[..., d0:d1].reshape(b, 1, kv, g, d1 - d0)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, ck).to(torch.float32)
    if d1 - d0 < dh:
        scores = reduce_from_region(scores, tp.group)
    scores = scores / np.sqrt(dh)
    if cfg.attn_softcap is not None:
        cap_ = cfg.attn_softcap
        scores = cap_ * torch.tanh(scores / cap_)
    probs = torch.softmax(scores + mask, dim=-1).to(cv.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs, cv)
    if d1 - d0 < dh:
        out = gather_from_region(out, -1, tp.group)
    return out.reshape(b, 1, h * dh), False


def init_gqa_cache(cfg, batch: int, capacity: int, dtype, device,
                   count: int) -> Params:
    """Zeroed ``(count, B, capacity, KV, dh)`` key and value caches."""
    shape = (count, batch, capacity, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# --------------------------------------------------------------------------
# MLA (DeepSeek-V3)
# --------------------------------------------------------------------------

def init_mla(gen: torch.Generator, cfg, lora_rank: Optional[int],
             count: int):
    """Stacked ``(count, ...)`` MLA params: the query's low-rank pair
    ``wq_down`` / ``wq_up`` with ``q_norm`` between them, the KV latent's
    ``wkv_down`` and ``kv_norm``, the shared rotary key ``wk_rope``, the
    up-projections ``wk_up`` / ``wv_up`` and ``wo``; LoRA on ``wq_down``,
    ``wq_up``, ``wkv_down`` and ``wo``."""
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qd = m.nope_head_dim + m.rope_head_dim
    lead = (count,)
    shapes = {"wq_down": (d, m.q_lora_rank),
              "wq_up": (m.q_lora_rank, h * qd),
              "wkv_down": (d, m.kv_lora_rank),
              "wk_rope": (d, m.rope_head_dim),
              "wk_up": (m.kv_lora_rank, h * m.nope_head_dim),
              "wv_up": (m.kv_lora_rank, h * m.v_head_dim),
              "wo": (h * m.v_head_dim, d)}
    base = {n: init_linear(gen, i, o, cfg.dtype, lead)
            for n, (i, o) in shapes.items()}
    for name, width in (("q_norm", m.q_lora_rank),
                        ("kv_norm", m.kv_lora_rank)):
        base[name] = {"w": torch.ones(lead + (width,), dtype=torch.float32,
                                      device=gen.device)}
    lora = None
    if lora_rank is not None:
        lora = {n: init_lora(gen, *shapes[n], lora_rank, cfg.lora_dtype,
                             lead)
                for n in ("wq_down", "wq_up", "wkv_down", "wo")}
    return base, lora


def mla_attention(
    x: torch.Tensor,
    base: Params,
    lora: Optional[Params],
    cfg,
    *,
    positions: torch.Tensor,                   # (B, T)
    cache: Optional[Params] = None,  # {"c": (B,S,kv_rank), "kr": (B,S,rd)}
    cache_pos: Optional[torch.Tensor] = None,  # (B,) padded index
    valid_start: Optional[torch.Tensor] = None,  # (B,) first real index
    pad_mask: Optional[torch.Tensor] = None,     # (B, T) True = real token
    scaling: float = 2.0,
    force_blockwise: Optional[bool] = None,
    kv_chunk: int = KV_CHUNK,
    tp=None,
) -> torch.Tensor:
    """MLA over one layer's params. Sequence mode decompresses the latent
    into 192-wide keys (``[k_nope, kr]``, ``kr`` shared by the heads) and
    128-wide values; a prefill then writes the last ``min(T, cap)``
    latents to slots ``[0, keep)``. Decode (``T == 1`` with a cache)
    writes the token at ``min(cache_pos, cap - 1)`` and attends in the
    compressed space: keys ``kpos <= cache_pos`` and ``kpos >=
    valid_start`` count, ``W_uk`` is absorbed into the query and ``W_uv``
    into the context."""
    if tp is not None:
        return _mla_attention_tp(
            x, base, lora, cfg, tp, positions=positions, cache=cache,
            cache_pos=cache_pos, valid_start=valid_start, pad_mask=pad_mask,
            scaling=scaling, force_blockwise=force_blockwise,
            kv_chunk=kv_chunk)
    m = cfg.mla
    h = cfg.n_heads
    b, t, _ = x.shape
    nd, rd, vd = m.nope_head_dim, m.rope_head_dim, m.v_head_dim
    dev = x.device

    # queries (low rank)
    cq = linear(x, base["wq_down"], lora and lora.get("wq_down"), scaling)
    cq = rmsnorm(cq, base["q_norm"]["w"])
    q = linear(cq, base["wq_up"], lora and lora.get("wq_up"), scaling)
    q = q.reshape(b, t, h, nd + rd)
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    # compressed KV latent and the shared rotary key (no LoRA)
    c = linear(x, base["wkv_down"], lora and lora.get("wkv_down"), scaling)
    c = rmsnorm(c, base["kv_norm"]["w"])                  # (B, T, kv_rank)
    kr = linear(x, base["wk_rope"], None)                 # (B, T, rd)
    kr = apply_rope(kr[..., None, :], positions, cfg.rope_theta)[..., 0, :]

    wk_up = base["wk_up"]["w"].reshape(m.kv_lora_rank, h, nd)
    wv_up = base["wv_up"]["w"].reshape(m.kv_lora_rank, h, vd)

    if cache is None or t > 1:
        k_nope = torch.einsum("btc,chd->bthd", c, wk_up)
        v = torch.einsum("btc,chd->bthd", c, wv_up)
        kfull = torch.cat([k_nope, kr[:, :, None, :].expand(b, t, h, rd)],
                          dim=-1)
        qfull = torch.cat([q_nope, q_rope], dim=-1)
        use_blockwise = (t > BLOCKWISE_THRESHOLD if force_blockwise is None
                         else force_blockwise and t > 1)
        if use_blockwise:
            # v's head dim is not the qk one: pad it for the blockwise
            # SDPA and slice the output back
            vp = torch.nn.functional.pad(v, (0, nd + rd - vd))
            out = _sdpa_blockwise(qfull, kfull, vp, 0, None, None,
                                  chunk=kv_chunk, pad_mask=pad_mask)
            out = out.reshape(b, t, h, nd + rd)[..., :vd]
        else:
            mask = _causal_window_mask(t, t, 0, None, dev)
            if pad_mask is not None:
                mask = mask + _pad_key_mask(pad_mask, 3)
            out = _sdpa(qfull, kfull, v, mask)
        if cache is not None:
            # prefill: the latents are small, write the prefix
            keep = min(t, cache["c"].shape[1])
            cache["c"][:, :keep] = c[:, t - keep:].to(cache["c"].dtype)
            cache["kr"][:, :keep] = kr[:, t - keep:].to(cache["kr"].dtype)
    else:
        # absorbed decode on the linear cache: a row past capacity keeps
        # overwriting the last slot, as the reference's clamped write does
        cc, ckr = cache["c"], cache["kr"]
        s = cc.shape[1]
        pos_b, start_b = _row_positions(cache_pos, valid_start, b, dev)
        rows = torch.arange(b, device=dev)
        wpos = torch.clamp(pos_b, max=s - 1)
        cc[rows, wpos] = c[:, 0].to(cc.dtype)
        ckr[rows, wpos] = kr[:, 0].to(ckr.dtype)
        q_abs = torch.einsum("bthd,chd->bthc", q_nope, wk_up)
        scores = (torch.einsum("bthc,bsc->bhts", q_abs, cc)
                  + torch.einsum("bthd,bsd->bhts", q_rope, ckr))
        scores = scores.to(torch.float32) / np.sqrt(nd + rd)
        kpos = torch.arange(s, device=dev)
        ok = ((kpos[None, :] <= pos_b[:, None])
              & (kpos[None, :] >= start_b[:, None]))
        probs = torch.softmax(scores + _pad_key_mask(ok, 2),
                              dim=-1).to(cc.dtype)
        ctx = torch.einsum("bhts,bsc->bthc", probs, cc)
        out = torch.einsum("bthc,chd->bthd", ctx, wv_up)

    return linear(out.reshape(b, t, h * vd), base["wo"],
                  lora and lora.get("wo"), scaling)


def _mla_attention_tp(x, base, lora, cfg, tp, *, positions, cache,
                      cache_pos, valid_start, pad_mask, scaling,
                      force_blockwise, kv_chunk):
    """MLA over this rank's blocks: ``wq_up`` / ``wk_up`` / ``wv_up``
    column-parallel over heads, the down-projections and the latent whole
    on every rank, ``wo`` row-parallel (see the module notes)."""
    m = cfg.mla
    h = cfg.n_heads
    b, t, _ = x.shape
    nd, rd, vd = m.nope_head_dim, m.rope_head_dim, m.v_head_dim
    qd = nd + rd
    dev = x.device
    la = lora or {}
    cq = linear(x, base["wq_down"], la.get("wq_down"), scaling, tp=tp)
    cq = rmsnorm(cq, base["q_norm"]["w"])
    q, qs = tp.linear(cq, base["wq_up"], la.get("wq_up"), scaling)
    c = linear(x, base["wkv_down"], la.get("wkv_down"), scaling, tp=tp)
    c = rmsnorm(c, base["kv_norm"]["w"])                  # (B, T, kv_rank)
    kr = linear(x, base["wk_rope"], None, tp=tp)          # (B, T, rd)
    kr = apply_rope(kr[..., None, :], positions, cfg.rope_theta)[..., 0, :]

    distinct, c0, c1, h0, h1 = tp.heads(base["wo"], h, vd)
    nh = h1 - h0
    ups = {}
    for name, width in (("wk_up", nd), ("wv_up", vd)):
        w, wd = tp.weight(base[name])
        ups[name] = tp.frozen_cols(w, -1, wd == -1, h0 * width,
                                   h1 * width).reshape(m.kv_lora_rank, nh,
                                                       width)
    wk_up, wv_up = ups["wk_up"], ups["wv_up"]
    q = tp.cols(q, qs, h0 * qd, h1 * qd, distinct).reshape(b, t, nh, qd)
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    if cache is None or t > 1:
        cd = copy_to_region(c, tp.group) if distinct else c
        krd = copy_to_region(kr, tp.group) if distinct else kr
        k_nope = torch.einsum("btc,chd->bthd", cd, wk_up)
        v = torch.einsum("btc,chd->bthd", cd, wv_up)
        kfull = torch.cat([k_nope, krd[:, :, None, :].expand(b, t, nh, rd)],
                          dim=-1)
        qfull = torch.cat([q_nope, q_rope], dim=-1)
        use_blockwise = (t > BLOCKWISE_THRESHOLD if force_blockwise is None
                         else force_blockwise and t > 1)
        if use_blockwise:
            vp = torch.nn.functional.pad(v, (0, qd - vd))
            out = _sdpa_blockwise(qfull, kfull, vp, 0, None, None,
                                  chunk=kv_chunk, pad_mask=pad_mask)
            out = out.reshape(b, t, nh, qd)[..., :vd]
        else:
            mask = _causal_window_mask(t, t, 0, None, dev)
            if pad_mask is not None:
                mask = mask + _pad_key_mask(pad_mask, 3)
            out = _sdpa(qfull, kfull, v, mask)
        if cache is not None:
            (cb0, cb1), (rb0, rb1) = _mla_cache_split(tp, cache, m)
            keep = min(t, cache["c"].shape[1])
            cache["c"][:, :keep] = c[:, t - keep:, cb0:cb1].to(
                cache["c"].dtype)
            cache["kr"][:, :keep] = kr[:, t - keep:, rb0:rb1].to(
                cache["kr"].dtype)
    else:
        out = _mla_decode_tp(tp, cfg, q_nope, q_rope, c, kr, wk_up, wv_up,
                             cache, cache_pos, valid_start, nh, distinct)
    out = out.reshape(b, t, nh * vd)[..., c0 - h0 * vd:c1 - h0 * vd]
    y, ysh = tp.linear(out, base["wo"], la.get("wo"), scaling, distinct)
    return tp.rep(y, ysh)


def _mla_cache_split(tp, cache, m):
    """The latent and rotary-key columns ``[lo, hi)`` a rank's cache
    blocks hold."""
    cl, rl = cache["c"].shape[-1], cache["kr"].shape[-1]
    return ((tp.block(m.kv_lora_rank) if cl < m.kv_lora_rank
             else (0, m.kv_lora_rank)),
            tp.block(m.rope_head_dim) if rl < m.rope_head_dim
            else (0, m.rope_head_dim))


def _mla_decode_tp(tp, cfg, q_nope, q_rope, c, kr, wk_up, wv_up, cache,
                   cache_pos, valid_start, nh, distinct):
    """The absorbed decode against this rank's latent / rotary-key columns:
    every head's partial scores over them, summed over the ranks; the
    context's columns gathered back for the rank's heads."""
    m = cfg.mla
    h = cfg.n_heads
    b = q_nope.shape[0]
    dev = q_nope.device
    cc, ckr = cache["c"], cache["kr"]
    (cb0, cb1), (rb0, rb1) = _mla_cache_split(tp, cache, m)
    c_sh, r_sh = cb1 - cb0 < m.kv_lora_rank, rb1 - rb0 < m.rope_head_dim
    s = cc.shape[1]
    pos_b, start_b = _row_positions(cache_pos, valid_start, b, dev)
    rows = torch.arange(b, device=dev)
    wpos = torch.clamp(pos_b, max=s - 1)
    cc[rows, wpos] = c[:, 0, cb0:cb1].to(cc.dtype)
    ckr[rows, wpos] = kr[:, 0, rb0:rb1].to(ckr.dtype)
    q_abs = torch.einsum("bthd,chd->bthc", q_nope, wk_up)
    if (c_sh or r_sh) and distinct:
        if nh * tp.m != h:
            raise NotImplementedError(
                f"MLA decode with {h} heads over {tp.m} 'model' ranks and a "
                f"split latent cache")
        q_abs = gather_from_region(q_abs, 2, tp.group)
        q_rope = gather_from_region(q_rope, 2, tp.group)
    s_c = torch.einsum("bthc,bsc->bhts", q_abs[..., cb0:cb1], cc)
    s_r = torch.einsum("bthd,bsd->bhts", q_rope[..., rb0:rb1], ckr)
    if c_sh or r_sh:
        part = ((s_c if c_sh else 0) + (s_r if r_sh else 0)).to(
            torch.float32)
        scores = reduce_from_region(part, tp.group)
        if not c_sh:
            scores = scores + s_c.to(torch.float32)
        if not r_sh:
            scores = scores + s_r.to(torch.float32)
    else:
        scores = (s_c + s_r).to(torch.float32)
    scores = scores / np.sqrt(m.nope_head_dim + m.rope_head_dim)
    kpos = torch.arange(s, device=dev)
    ok = ((kpos[None, :] <= pos_b[:, None])
          & (kpos[None, :] >= start_b[:, None]))
    probs = torch.softmax(scores + _pad_key_mask(ok, 2), dim=-1).to(cc.dtype)
    ctx = torch.einsum("bhts,bsc->bthc", probs, cc)
    if c_sh:
        ctx = gather_from_region(ctx, -1, tp.group)
    if ctx.shape[2] != nh:
        h0 = tp.j * nh
        ctx = ctx[:, :, h0:h0 + nh]
    return torch.einsum("bthc,chd->bthd", ctx, wv_up)


def init_mla_cache(cfg, batch: int, capacity: int, dtype, device,
                   count: int) -> Params:
    """Zeroed ``(count, B, capacity, kv_rank)`` latent and ``(count, B,
    capacity, rope_dim)`` rotary-key caches."""
    m = cfg.mla
    lead = (count, batch, capacity)
    return {"c": torch.zeros(lead + (m.kv_lora_rank,), dtype=dtype,
                             device=device),
            "kr": torch.zeros(lead + (m.rope_head_dim,), dtype=dtype,
                              device=device)}
