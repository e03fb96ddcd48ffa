"""The comparison that decides ``correct``.

Once the window has closed, the harness draws from the seed a sample of the
requests that the program served wholly inside the window (the longest
among them) from a few adapters drawn from the seed, and keeps what the
program served them: the greedy tokens, each adapter's stored codes, and,
for a model with experts, what the dispatch did with their tokens. The
program's state is then freed, and the reference (``reference/``) works
everything out again from the seed alone: it draws the base weights and
the adapters' float factors, quantizes the adapters, and runs each sampled
sequence (prompt and served tokens) through its plain float32 forward.

Numbers compared, each against the cell's limit (``limits/<cell>.json``):

* ``logit_gap``: the widest gap by which a served token's logit lies below
  the reference's best logit at its position (greedy tokens);
* ``delta_gap``: the worst ``‖ΔW_program − ΔW_reference‖_F / ‖ΔW_ref‖_F``
  over the sampled adapters' entries (the codes made in set-up);
* with experts, ``route_margin``: where the program routed a sampled token
  to an expert outside the reference's top k, how far that expert's
  reference probability lies below the reference's k-th; and
  ``drop_mismatches``: assignments whose kept flag differs from the
  capacity rule (``max(ceil(tokens·k/E·factor), 8)`` slots per expert,
  filled in token order) applied to the whole batch's assignments, over
  every layer of every forward that served a sampled request.

With experts the reference follows the program's assignments and kept
flags for the sampled tokens (the batch that decided a drop is the
program's), after checking both as above; everything else it computes.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from reference import loraquant as rq
from reference import model as rm
from reference import weights as rw

from . import inputs
from .serve import log

ADAPTERS = 3                  # the most adapters one check re-quantizes


# ----- before the program is freed -----

def sample(run, out) -> List[Any]:
    """The requests under check: from the watched requests served wholly
    inside the window, up to ``ADAPTERS`` adapters drawn from the seed (the
    longest request's first), then up to the mix's ``check.requests`` of
    their requests, the longest first."""
    want = int(out.mix["check"]["requests"])
    done = run.finished_in_window()
    log(f"{len(done)} of {len(run.rec.watch)} watched requests served "
        f"wholly in the window")
    if not done:
        return []
    rng = np.random.default_rng([out.seed, 0x5A3])
    done = sorted(done, key=lambda r: r.request_id)
    longest = max(done, key=lambda r: (len(r.output), -r.request_id))
    adapters = [longest.adapter_id]
    others = sorted({r.adapter_id for r in done} - set(adapters))
    rng.shuffle(others)
    adapters += others[:ADAPTERS - 1]
    pool = [r for r in done if r.adapter_id in adapters and r is not longest]
    rng.shuffle(pool)
    return [longest] + pool[:want - 1]


def stored_codes(store, adapter_ids) -> Dict[str, Dict[str, list]]:
    """The program's stored sides of each entry, copied to the host."""
    out = {}
    for aid in adapter_ids:
        per = {}
        for path, qs in store.quantized[aid].entries.items():
            per[path] = [[_side(s) for s in (q.b_high, q.a_high, q.b_low,
                                              q.a_low)] for q in qs]
        out[aid] = per
    return out


def _side(qt):
    if qt is None:
        return None
    return dict(codes=qt.codes.cpu(), scale=qt.scale.cpu(),
                zero=qt.zero.cpu(), bits=qt.bits, group=qt.group_size,
                axis=qt.axis, shape=tuple(qt.orig_shape), mode=qt.mode)


def routes(forwards, req, k: int, layers: int):
    """Per layer ``(experts (T, k), kept (T, k))`` of a sampled request's
    fed tokens (prompt, then each served token but the last), from the
    recorded forwards."""
    p = len(req.prompt)
    t = p + len(req.output) - 1
    experts = np.full((layers, t, k), -1, np.int64)
    kept = np.zeros((layers, t, k), bool)
    for f in forwards:
        if f.kind == "prefill":
            hit = [b for b, (rid, _) in enumerate(f.rows)
                   if rid == req.request_id]
            if not hit:
                continue
            b = hit[0]
            toks = b * f.tpad + (f.tpad - p) + np.arange(p)
            pos = np.arange(p)
        else:
            hit = [(i, idx) for i, rid, idx in f.rows
                   if rid == req.request_id]
            if not hit:
                continue
            toks, pos = np.array([hit[0][0]]), np.array([hit[0][1]])
        if not f.routing or len(f.routing) != layers:
            raise RuntimeError(f"request {req.request_id}: a forward "
                               f"that served it kept no routing")
        for li, (e, _, kp) in enumerate(f.routing):
            a = (toks[:, None] * k + np.arange(k)).reshape(-1)
            experts[li, pos] = e[a].reshape(-1, k)
            kept[li, pos] = kp[a].reshape(-1, k)
    if (experts < 0).any():
        raise RuntimeError(f"request {req.request_id}: tokens with no "
                           f"recorded routing")
    return experts, kept


def drop_mismatches(forwards, rids, n_experts: int, k: int,
                    factor: float) -> int:
    """Kept flags that differ from the capacity rule, over every layer of
    every forward that served one of ``rids``."""
    bad = 0
    for f in forwards:
        ids = ([r[0] for r in f.rows] if f.kind == "prefill"
               else [r[1] for r in f.rows])
        if not f.routing or not set(ids) & rids:
            continue
        for e, cap, kp in f.routing:
            n_tok = e.shape[0] // k
            want_cap = max(int(math.ceil(n_tok * k / n_experts * factor)), 8)
            seen = np.zeros(n_experts, np.int64)
            ref = np.empty_like(kp)
            for j, x in enumerate(e):
                ref[j] = seen[x] < want_cap
                seen[x] += 1
            bad += int((ref != kp).sum()) + int(cap != want_cap)
    return bad


# ----- after the program is freed -----

def _program_factors(side_list):
    """An entry's program factors ``(B'' (out, r), A'' (r, in))``."""
    dq = [None if s is None else rq.read_side(
        s["codes"], s["scale"], s["zero"], s["bits"], s["group"], s["axis"],
        s["shape"], s["mode"]) for s in side_list]
    b, a = dq[0], dq[1]
    if dq[2] is not None:
        b = torch.cat([b, dq[2]], dim=-1)
        a = torch.cat([a, dq[3]], dim=-2)
    return b, a


def reference_adapters(cfg, seed: int, indices: List[int], device,
                       recipe: str, precision: str = "fp32"):
    """name → per adapter index → list over flat entries of the
    reference's dequantized ``(B'', A'')``."""
    bits, rho = recipe.split("@")
    r = cfg["lora_rank"]
    draws = {i: inputs.adapter_factors(cfg, seed, i, device)
             for i in indices}
    out: Dict[str, Dict[int, list]] = {}
    for path, name, lead, i_dim, o_dim in inputs.linears(cfg):
        n = int(np.prod(lead))
        b = torch.cat([draws[i][path]["b"].reshape(n, o_dim, r)
                       for i in indices])
        a = torch.cat([draws[i][path]["a"].reshape(n, r, i_dim)
                       for i in indices])
        q = rq.quantize(b, a, int(bits), float(rho), precision)
        out[name] = {idx: [(bb, aa) for bb, aa, _ in q[j * n:(j + 1) * n]]
                     for j, idx in enumerate(indices)}
    return out


def compare(cfg, seed: int, device, recipe: str, sampled: List[dict],
            codes: Dict[str, Dict[str, list]], moe_rule: Optional[dict],
            control: bool = False) -> Dict[str, float]:
    """The numbers compared. ``sampled``: per request ``prompt``,
    ``output``, ``adapter`` (index) and, with experts, ``experts`` /
    ``kept``. ``control`` puts the reference in the program's place at the
    next lower precision: bf16 in the quantizer, fp8 in the forward."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    names = {path: name for path, name, *_ in inputs.linears(cfg)}
    indices = sorted({s["adapter"] for s in sampled})
    with torch.no_grad():
        weights = rw.draw(cfg, seed, device)
    ref = reference_adapters(cfg, seed, indices, device, recipe)
    nums: Dict[str, float] = {}
    if control:
        low = reference_adapters(cfg, seed, indices, device, recipe, "bf16")
        nums["delta_gap"] = max(
            rq.delta_gap(p, q)
            for name in ref for i in indices
            for p, q in zip(low[name][i], ref[name][i]))
    else:
        gaps = []
        for i in indices:
            for path, entries in codes[f"a{i}"].items():
                mine = ref[names[path]][i]
                for j, (side_list, q) in enumerate(zip(entries, mine)):
                    p = _program_factors(side_list)
                    gaps.append((rq.delta_gap(
                        (p[0].to(device), p[1].to(device)), q),
                        names[path], i, j))
        worst = max(gaps)
        nums["delta_gap"] = worst[0]
        log(f"delta_gap: worst {worst}, median "
             f"{float(np.median([g[0] for g in gaps]))} over {len(gaps)} "
             f"entries, {sum(g[0] > 1e-3 for g in gaps)} above 1e-3")
    fwd = rm.Forward(cfg, weights)
    low_fwd = rm.Forward(cfg, weights, precision="fp8") if control else None
    k = cfg.get("num_experts_per_tok", 0)
    worst, margin = 0.0, 0.0
    with torch.no_grad():
        for s in sampled:
            lora = {name: ref[name][s["adapter"]] for name in ref}
            seq = list(s["prompt"]) + list(s["output"][:-1])
            p = len(s["prompt"])
            route, probs_at = None, {}
            if k:
                route, margins = _follow(s, k, probs_at)
            logits = fwd.logits(seq, lora, route, from_pos=p - 1)
            if control:
                lroute = None
                if k:
                    lroute, margins = _own(s, k, probs_at)
                tok = low_fwd.logits(seq, lora, lroute,
                                     from_pos=p - 1).argmax(-1)
            else:
                tok = torch.as_tensor(np.asarray(s["output"]),
                                      device=logits.device)
            gap = logits.max(-1).values - logits.gather(
                1, tok[:, None])[:, 0]
            worst = max(worst, float(gap.max()))
            if k:
                margin = max([margin] + margins)
            del logits
    nums["logit_gap"] = worst
    if k:
        nums["route_margin"] = margin
        if moe_rule is not None:
            nums["drop_mismatches"] = float(moe_rule["mismatches"])
    return nums


def _follow(s, k, probs_at):
    """The check's routing: the program's experts and kept flags for the
    sampled tokens, each checked against the reference's probabilities."""
    margins: List[float] = []
    ex = torch.as_tensor(s["experts"])
    kp = torch.as_tensor(s["kept"])

    def route(li, probs):
        probs_at[li] = probs
        e = ex[li].to(probs.device)
        top = torch.sort(probs, dim=-1, descending=True).values
        chosen = torch.gather(probs, 1, e)
        margins.append(float((top[:, k - 1:k] - chosen).clamp(min=0).max()))
        return e, kp[li].to(probs.device)

    return route, margins


def _own(s, k, probs_at):
    """The control's routing: its own top k, the program's kept flags, and
    each choice's margin under the float32 reference's probabilities."""
    margins: List[float] = []
    kp = torch.as_tensor(s["kept"])

    def route(li, probs):
        _, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        e = idx[:, :k]
        ref = probs_at[li]
        top = torch.sort(ref, dim=-1, descending=True).values
        chosen = torch.gather(ref, 1, e)
        margins.append(float((top[:, k - 1:k] - chosen).clamp(min=0).max()))
        return e, kp[li].to(probs.device)

    return route, margins
