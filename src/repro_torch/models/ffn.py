"""Feed-forward variants (port of ``repro/models/ffn.py``): dense GLU and
the sparse Mixture-of-Experts of the single-device path.

The MoE dispatch is gather based, as in the reference: the ``(T·k,)``
expert assignments are sorted by expert (stably), each expert takes at
most ``cap`` of them into its contiguous rows of an ``(E, cap, d)``
buffer, the experts run as batched matmuls, and the outputs are gathered
back and summed with their gates. Token choice drops the assignments past
an expert's capacity. Per-expert LoRA leaves are ``(L, E, r, ·)`` stacks
in fp form, or packed stacks whose expert axis is folded into the adapter
axis (``fold == E``), applied by one ``sgmv_fused`` launch per linear at
``tile_t = 1`` with folded ``adapter·E + expert`` seg ids per buffer row.

deepseek's MoE adds two things, as the reference has them: a frozen
expert base stored as int8 codes with per-(expert, out-column) fp32
scales (``base_quant_bits=8``), dequantized in the compute dtype right
before each batched product, and a shared expert (a dense GLU of width
``d_ff_expert · n_shared`` over every token, with its own LoRA under
``"shared"``) added after the dispatch.

Under a mesh whose data axis has S > 1 ranks (:func:`moe_ffn`'s
``mesh``), each rank holds its rows of the batch and the expert path is
the reference's ``shard_map`` one (``_moe_shard_map``), in one of its two
weight layouts, chosen by divisibility (:func:`expert_layout`):

* **EP** (``E % S == 0``): each rank holds E/S experts (base and LoRA),
  dispatches its own tokens at the per-shard capacity ``cap_loc``, and an
  ``all_to_all`` moves the capacity slots to the experts' owners and back;
* **weight-FSDP** (otherwise): each rank holds a d-slice of every expert's
  base weights, all-gathers them per layer and dispatches its own tokens
  over all experts.

Too few tokens per rank (``n_tok // S < 8``) fall back to one dispatch over
all tokens at the global capacity, as the reference's ``s_count = 1``
does: the ranks all-gather rows and experts and keep their own rows. The
load-balance loss is global: the sums of the router probabilities and of
the routed counts are all-reduced over the data group. Collectives carry
gradients (``repro_torch.parallel.collectives``).

Under a ``model`` axis the expert width f is split over it in both layouts
(``wg`` / ``wu`` column-parallel, ``wd`` row-parallel, the partial outputs
all-reduced in the compute dtype where the reference ``psum``s them), and
each leaf is the block of the rule table's spec. Where that table gives an
EP expert LoRA ``b`` the whole f while ``w`` has its f-slice (ROADMAP C11:
the reference's expert FFN cannot add the two), the port applies ``b``'s
rows of the rank's slice, which computes what the mesh without a ``model``
axis computes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.kernels.quant_matmul import (PackedLoRABatch,
                                               PackedLoRABuckets,
                                               sgmv_apply_packed)
from repro_torch.parallel.collectives import (all_gather, all_reduce_sum,
                                              all_to_all)
from repro_torch.parallel.sharding import data_ranks

from .common import init_linear, init_lora, linear

_PACKED = (PackedLoRABatch, PackedLoRABuckets)


def init_dense_ffn(gen: torch.Generator, cfg, lora_rank: Optional[int],
                   count: int, d_ff: Optional[int] = None):
    """Stacked ``(count, ...)`` gate/up/down weights and LoRA factors."""
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    lead = (count,)
    shapes = {"wg": (d, f), "wu": (d, f), "wd": (f, d)}
    base = {n: init_linear(gen, i, o, cfg.dtype, lead)
            for n, (i, o) in shapes.items()}
    lora = None
    if lora_rank is not None:
        lora = {n: init_lora(gen, i, o, lora_rank, cfg.lora_dtype, lead)
                for n, (i, o) in shapes.items()}
    return base, lora


def dense_ffn(x, base, lora, *, activation: str = "silu",
              scaling: float = 2.0, tp=None):
    if tp is not None:
        return _dense_ffn_tp(x, base, lora, activation, scaling, tp)
    g = linear(x, base["wg"], lora and lora.get("wg"), scaling)
    u = linear(x, base["wu"], lora and lora.get("wu"), scaling)
    # jax.nn.gelu defaults to the tanh approximation
    act = F.silu(g) if activation == "silu" else F.gelu(g, approximate="tanh")
    return linear(act * u, base["wd"], lora and lora.get("wd"), scaling)


def _act(g, activation):
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(g) if activation == "silu" else F.gelu(g, approximate="tanh")


def _dense_ffn_tp(x, base, lora, activation, scaling, tp, x_sharded=False):
    """The GLU over this rank's blocks: ``wg`` / ``wu`` column-parallel,
    ``wd`` row-parallel where the rules split them (each linear as its
    spec says otherwise). Returns the whole output."""
    la = lora or {}
    (g, gs), (u, us) = tp.linears(
        x, [(base[n], la.get(n)) for n in ("wg", "wu")], scaling, x_sharded)
    if gs != us:
        g, u, gs = tp.shard(g, gs), tp.shard(u, us), True
    y, ys = tp.linear(_act(g, activation) * u, base["wd"], la.get("wd"),
                      scaling, gs)
    return tp.rep(y, ys)


# --------------------------------------------------------------------------
# Mixture of Experts
# --------------------------------------------------------------------------

def _expert_stack(gen: torch.Generator, d_in: int, d_out: int, dtype,
                  lead, quant_bits=None) -> dict:
    """Uniform(±1/√d_in) ``(*lead, d_in, d_out)`` weights drawn one
    ``(d_in, d_out)`` matrix at a time, so a bf16 stack never has an fp32
    copy of itself beside it. With ``quant_bits`` each matrix is stored
    as the reference quantizes its stacks: symmetric codes
    ``round(w / scale)`` clipped to ``±qmax`` (int8) with one scale per
    out-column, ``max |w| / qmax`` over the column in ``dtype`` (1 where
    the column is 0), kept in fp32."""
    bound = 1.0 / np.sqrt(d_in)
    dev = gen.device
    # a meta stack has shapes only: nothing to draw per matrix
    mats = () if dev.type == "meta" else np.ndindex(*lead)
    tmp = torch.empty((d_in, d_out), dtype=torch.float32, device=dev)
    if not quant_bits:
        w = torch.empty(tuple(lead) + (d_in, d_out), dtype=dtype, device=dev)
        for idx in mats:
            tmp.uniform_(-bound, bound, generator=gen)
            w[idx].copy_(tmp)
        return {"w": w}
    qmax = 2 ** (quant_bits - 1) - 1
    codes = torch.empty(tuple(lead) + (d_in, d_out), dtype=torch.int8,
                        device=dev)
    scales = torch.empty(tuple(lead) + (1, d_out), dtype=torch.float32,
                         device=dev)
    for idx in mats:
        tmp.uniform_(-bound, bound, generator=gen)
        w = tmp.to(dtype)
        sc = w.abs().amax(dim=0, keepdim=True) / qmax
        sc = torch.where(sc <= 0, torch.ones_like(sc), sc).to(torch.float32)
        codes[idx] = torch.clamp(torch.round(w / sc), -qmax, qmax).to(
            torch.int8)
        scales[idx] = sc
    return {"w": codes, "scale": scales}


def init_moe(gen: torch.Generator, cfg, lora_rank: Optional[int],
             count: int):
    """Stacked MoE params: an fp32 router ``(count, d, E)``, expert
    stacks ``(count, E, ·, ·)`` (int8 codes and ``(count, E, 1, ·)`` fp32
    scales under ``base_quant_bits``) and, with ``n_shared``, a dense
    ``"shared"`` expert of width ``d_ff_expert · n_shared``; LoRA on the
    router, on the shared expert and, with ``lora_on_experts``, per expert
    on ``wg`` / ``wu`` / ``wd`` (``(count, E, r, ·)``)."""
    mc = cfg.moe
    d, f, e = cfg.d_model, mc.d_ff_expert, mc.n_experts
    lead = (count, e)
    shapes = {"wg": (d, f), "wu": (d, f), "wd": (f, d)}
    base = {"router": init_linear(gen, d, e, torch.float32, (count,)),
            "experts": {n: _expert_stack(gen, i, o, cfg.dtype, lead,
                                         cfg.base_quant_bits)
                        for n, (i, o) in shapes.items()}}
    shared_lora = None
    if mc.n_shared:
        base["shared"], shared_lora = init_dense_ffn(
            gen, cfg, lora_rank, count, d_ff=f * mc.n_shared)
    lora = None
    if lora_rank is not None:
        lora = {"router": init_lora(gen, d, e, lora_rank, cfg.lora_dtype,
                                    (count,))}
        if mc.n_shared:
            lora["shared"] = shared_lora
        if mc.lora_on_experts:
            lora["experts"] = {
                n: init_lora(gen, i, o, lora_rank, cfg.lora_dtype, lead)
                for n, (i, o) in shapes.items()}
    return base, lora


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last axis, ties broken toward
    the lower index (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch_indices(expert_ids: torch.Tensor, n_experts: int,
                      capacity: int):
    """Sort the ``(T·k,)`` assignments by expert (stably); return for each
    sorted slot its source assignment index, expert, position in the expert
    and whether it fits the capacity."""
    n = expert_ids.shape[0]
    order = torch.argsort(expert_ids, stable=True)
    sorted_e = expert_ids[order]
    # per-expert counts (a scatter-add, not bincount: its output size
    # would depend on the data, which a shape-only run cannot know)
    ids = expert_ids.to(torch.int64)
    counts = torch.zeros((n_experts,), dtype=torch.int64,
                         device=ids.device).scatter_add_(
                             0, ids, torch.ones_like(ids))
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(n, device=expert_ids.device) - starts[sorted_e]
    keep = pos_in_e < capacity
    return order, sorted_e, pos_in_e, keep


def moe_capacity(n_tok: int, mc) -> int:
    """Rows per expert of the dispatch buffer."""
    return max(int(np.ceil(n_tok * mc.top_k / mc.n_experts
                           * mc.capacity_factor)), 8)


def expert_layout(cfg, mesh):
    """``None`` (single device), ``"ep"`` or ``"fsdp"``: how the expert
    stacks are spread over the data ranks (the reference's ``ep = e %
    s_count == 0``)."""
    s = data_ranks(mesh)
    if s == 1:
        return None
    return "ep" if cfg.moe.n_experts % s == 0 else "fsdp"


def _map_leaves(fn, tree):
    return {k: _map_leaves(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _own_experts(t):
    """An EP-held expert leaf ``(E/S, ·, ·)`` as the rank's experts: its
    expert dim's data entry dropped from the spec (the all-to-all, not a
    gather, brings the tokens to them)."""
    out = t.view_as(t)
    out.tp_spec = (None,) + tuple(t.tp_spec[1:])
    return out


def moe_ffn(x: torch.Tensor, base, lora, cfg, *, scaling: float = 2.0,
            mesh=None, tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-choice top-k MoE with capacity drops. ``x: (B, T, d)`` (this
    rank's rows under a ``mesh``, with ``tp`` its
    :class:`~repro_torch.parallel.tensor.TensorParallel`); returns ``(y,
    aux_load_balance_loss)``. Under a ``model`` axis each expert's width f
    is split over it (f-TP: ``wg`` / ``wu`` column-, ``wd`` row-parallel,
    the partial outputs summed in the compute dtype, as the reference's
    ``psum`` over ``model``)."""
    mc = cfg.moe
    b, t, d = x.shape
    e, k = mc.n_experts, mc.top_k
    xf = x.reshape(b * t, d)
    s_count = data_ranks(mesh)
    group = mesh.fsdp_group() if s_count > 1 else None
    n_tok = b * t * s_count                             # the global tokens

    logits = linear(xf, base["router"], lora and lora.get("router"), scaling,
                    tp=tp)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    gate, top_idx = _top_k(probs, k)                     # (n_tok, k)
    gate = gate / gate.sum(dim=-1, keepdim=True)         # renormalize top-k

    # Switch-style aux loss: mean routed fraction × mean router prob, over
    # the global tokens
    routed = F.one_hot(top_idx, e).to(torch.float32).sum(dim=1)
    if group is None:
        me, ce = probs.mean(dim=0), routed.mean(dim=0) / k
    else:
        me = all_reduce_sum(probs.sum(dim=0), group) / n_tok
        ce = all_reduce_sum(routed.sum(dim=0), group) / n_tok / k
    aux = mc.aux_loss_weight * e * torch.sum(me * ce)

    lex = lora.get("experts") if (lora and mc.lora_on_experts) else None
    if group is None:
        y = _moe_dense_dispatch(xf, gate, top_idx, base["experts"], lex, e,
                                k, moe_capacity(n_tok, mc), scaling, tp)
    else:
        y = _moe_shard_map(xf, gate, top_idx, base, lex, cfg, mesh, group,
                           scaling, tp)
    if mc.n_shared:
        y = y + dense_ffn(xf, base["shared"], lora and lora.get("shared"),
                          scaling=scaling, tp=tp)
    return y.reshape(b, t, d), aux


def _moe_shard_map(xf, gate, top_idx, base, lex, cfg, mesh, group, scaling,
                   tp):
    """The expert path over S data ranks (the reference's ``_moe_shard_map``
    and its ``s_count = 1`` fallback); each rank's ``xf`` is its own rows,
    each expert leaf its block of the rule table's spec."""
    mc = cfg.moe
    e, k = mc.n_experts, mc.top_k
    s_count = data_ranks(mesh)
    tok_loc = xf.shape[0]
    layout = expert_layout(cfg, mesh)
    if lex is not None and any(isinstance(l, _PACKED) for l in lex.values()):
        raise NotImplementedError(
            "packed multi-adapter expert LoRA is a serving-path feature "
            "(no mesh); under a mesh serve with mode='materialize'")
    ex = base["experts"]
    if tok_loc < 8:
        # the reference's fallback: one dispatch over all the tokens
        rank = dist.get_rank(group)
        n_tok = tok_loc * s_count
        ex = _map_leaves(lambda t: tp.data_gathered(t, grad=False), ex)
        lx = (None if lex is None
              else _map_leaves(lambda t: tp.data_gathered(t, grad=True), lex))
        y = _moe_dense_dispatch(
            all_gather(xf, 0, group), all_gather(gate, 0, group),
            all_gather(top_idx, 0, group), ex, lx, e, k,
            moe_capacity(n_tok, mc), scaling, tp)
        return y.narrow(0, rank * tok_loc, tok_loc)
    cap_loc = moe_capacity(tok_loc, mc)
    if layout == "fsdp":
        # ZeRO-3: the d-sliced expert weights are gathered per layer
        return _moe_dense_dispatch(xf, gate, top_idx, ex, lex, e, k,
                                   cap_loc, scaling, tp)
    ex = _map_leaves(_own_experts, ex)
    lx = None if lex is None else _map_leaves(_own_experts, lex)
    buf, plan = _dispatch(xf, top_idx, e, k, cap_loc)
    d = xf.shape[1]
    # slots → expert owners (split E, concat capacity in rank order)
    buf = all_to_all(buf, group).reshape(s_count, e // s_count, cap_loc, d)
    buf = buf.transpose(0, 1).reshape(e // s_count, s_count * cap_loc, d)
    out = _experts(ex, lx, buf, scaling, tp=tp)          # (E/S, S·cap, d)
    out = out.reshape(e // s_count, s_count, cap_loc, d).transpose(0, 1)
    out = all_to_all(out, group).reshape(e, cap_loc, d)
    return _combine(out, gate, plan)


def expert_weight(leaf, dtype) -> torch.Tensor:
    """An expert stack in the compute ``dtype``: an int8 ``{"w",
    "scale"}`` leaf dequantized as the reference does it, ``w.to(dtype) *
    scale.to(dtype)`` (the scale rounded to ``dtype`` first), into one
    transient the size of the stack; a float leaf as it is."""
    w = leaf["w"]
    if w.dtype != torch.int8:
        return w
    return w.to(dtype).mul_(leaf["scale"].to(dtype))


def _expert_ffw(ex, lex, name, inp, scaling, buf_seg=None):
    """Batched expert matmul ``(E, C, ·)`` with optional per-expert LoRA:
    an fp ``{a, b}`` stack ``(E, r, ·)`` (batched products), a packed
    :class:`~repro_torch.kernels.PackedLoRABatch` whose expert axis is
    folded into the adapter axis (one ``sgmv_fused`` launch at
    ``tile_t = 1`` over folded ``buf_seg·fold + expert`` seg ids), or a
    :class:`~repro_torch.kernels.PackedLoRABuckets` (one launch per bucket,
    the expert folded in bucket-locally, non-member rows masked out). An
    int8 stack is dequantized first (:func:`expert_weight`)."""
    y = torch.bmm(inp, expert_weight(ex[name], inp.dtype))
    if lex is None:
        return y
    leaf = lex[name]
    e, c, _ = inp.shape
    rows = inp.reshape(e * c, -1)
    if isinstance(leaf, _PACKED):
        expert_of_row = torch.arange(e, dtype=torch.int32,
                                     device=inp.device).repeat_interleave(c)
        seg = buf_seg.to(torch.int32)
    if isinstance(leaf, PackedLoRABatch):
        pb = dataclasses.replace(leaf, seg=seg * leaf.fold + expert_of_row,
                                 tile_t=1)
        upd = sgmv_apply_packed(rows, pb, scaling=scaling)
        return y + upd.reshape(y.shape).to(y.dtype)
    if isinstance(leaf, PackedLoRABuckets):
        upd = None
        for pb, lut in zip(leaf.buckets, leaf.lookups):
            local = lut[seg.to(torch.int64)]
            member = local >= 0
            folded = local.clamp(min=0) * pb.fold + expert_of_row
            u = sgmv_apply_packed(
                rows, dataclasses.replace(pb, seg=folded, tile_t=1),
                scaling=scaling)
            u = torch.where(member[:, None], u, torch.zeros_like(u))
            upd = u if upd is None else upd + u
        return y + upd.reshape(y.shape).to(y.dtype)
    la, lb = leaf["a"], leaf["b"]                 # (E, r, in), (E, out, r)
    upd = torch.bmm(torch.bmm(inp.to(la.dtype), la.transpose(1, 2)),
                    lb.transpose(1, 2))
    return y + (scaling * upd).to(y.dtype)


# Set by the decode graph runner (``models/graphs.py``) while it captures a
# forward: called in place of :func:`_dispatch_indices`, it ends the graph
# segment there and hands back the buffers its replay fills. Both names are
# looked up at each call.
_ISLAND = None


def _dispatch(x_loc, idx_loc, e, k, cap):
    """Sort the ``(tok·k,)`` assignments by expert and scatter the kept
    ones into an ``(E, cap, d)`` buffer; returns it with the plan
    :func:`_combine` needs."""
    tok, d = x_loc.shape
    dev = x_loc.device
    flat_e = idx_loc.reshape(-1)                          # (tok·k,)
    src_tok = torch.arange(tok * k, device=dev) // k
    order, sorted_e, pos_in_e, keep = (_ISLAND or _dispatch_indices)(
        flat_e, e, cap)
    # dropped assignments land on a sentinel row, sliced off
    dest = torch.where(keep, sorted_e * cap + pos_in_e,
                       torch.full_like(sorted_e, e * cap))
    src = src_tok[order]
    buf = torch.zeros((e * cap + 1, d), dtype=x_loc.dtype, device=dev)
    buf[dest] = x_loc[src]
    plan = dict(order=order, sorted_e=sorted_e, pos_in_e=pos_in_e,
                keep=keep, dest=dest, src=src, k=k)
    return buf[:-1].reshape(e, cap, d), plan


def _experts(ex, lex, buf, scaling, buf_seg=None, tp=None):
    """The experts' GLU over their ``(E, C, d)`` buffer rows; under ``tp``
    over this rank's blocks of the expert leaves, the output whole."""
    if tp is not None:
        return _dense_ffn_tp(buf, ex, lex, "silu", scaling, tp)
    g = _expert_ffw(ex, lex, "wg", buf, scaling, buf_seg)
    u = _expert_ffw(ex, lex, "wu", buf, scaling, buf_seg)
    h = F.silu(g) * u
    return _expert_ffw(ex, lex, "wd", h, scaling, buf_seg)


def _combine(out, gate_loc, plan):
    """Each token's kept expert outputs times their gates, summed."""
    e, cap, d = out.shape
    k, order, sorted_e = plan["k"], plan["order"], plan["sorted_e"]
    tok = gate_loc.shape[0]
    dev = out.device
    out_flat = out.reshape(e * cap, d)
    slot = torch.where(
        plan["keep"][:, None],
        out_flat[torch.clamp(sorted_e * cap + plan["pos_in_e"], 0,
                             e * cap - 1)],
        torch.zeros((), dtype=out_flat.dtype, device=dev))
    # combine in the compute dtype, as the reference does: its scatter-add
    # takes each token's k terms in sorted order (by expert), rounding after
    # every add. The adds go in that order here too, one per rank of a
    # term within its token, so the sum does not depend on the order in
    # which the card's atomics would land (top-8 terms in bf16 do)
    contrib = gate_loc.reshape(-1)[order].to(out.dtype)[:, None] * slot
    rank = torch.empty_like(order)
    rank[order] = torch.arange(tok * k, device=dev)
    seq = rank.view(tok, k).sort(dim=1).values      # (tok, k) sorted slots
    y = torch.zeros((tok, d), dtype=out.dtype, device=dev)
    for j in range(k):
        y = y + contrib[seq[:, j]]
    return y


def _moe_dense_dispatch(x_loc, gate_loc, idx_loc, ex, lex, e, k, cap,
                        scaling, tp=None):
    """Sort-gather-scatter token-choice dispatch of one device's tokens."""
    buf, plan = _dispatch(x_loc, idx_loc, e, k, cap)
    if tp is not None:
        return _combine(_experts(ex, lex, buf, scaling, tp=tp), gate_loc,
                        plan)
    buf_seg = None
    if lex is not None and any(isinstance(l, _PACKED) for l in lex.values()):
        # the per-token adapter ids ride the packed leaves (attached by the
        # model); they go through the same scatter, so every buffer row
        # knows its adapter. Empty capacity slots keep seg 0 with zero x
        # rows, which adds nothing (LoRA is linear).
        seg_tok = next(l.seg for l in lex.values() if isinstance(l, _PACKED))
        buf_seg = torch.zeros((e * cap + 1,), dtype=torch.int32,
                              device=x_loc.device)
        buf_seg[plan["dest"]] = seg_tok[plan["src"]].to(torch.int32)
        buf_seg = buf_seg[:-1]
    return _combine(_experts(ex, lex, buf, scaling, buf_seg), gate_loc, plan)
