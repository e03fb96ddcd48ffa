"""lora_roofline: over the profiled stretch, the least time the LoRA work
could take (``_work.lora_call`` summed over every LoRA linear of every
forward: each served adapter entry read once, active rows only) over the
device time of the LoRA kernels below, in %."""

from collections import Counter

import numpy as np

from metrics import _work

KERNELS = ("sgmv_fused", "sgmv_rhs", "sgmv_out", "fused_lora",
           "matmul_rhs", "matmul_out")


def read(out):
    if out.trace is None or not out.stretch:
        return None
    spent = sum(t for n, (t, _) in out.trace["by_name"].items()
                if any(k in n for k in KERNELS))
    if spent <= 0:
        return None
    cfg = out.cfg
    r, layers = cfg["lora_rank"], cfg["num_hidden_layers"]
    bits = int(out.mix["fleet"]["recipe"].split("@")[0])
    shapes = _work.shapes(cfg)
    experts = cfg.get("num_local_experts", 0)
    k = cfg.get("num_experts_per_tok", 1)
    bound = 0.0
    for f in out.stretch:
        if f.kind == "prefill":
            toks = [(out.adapter_of[rid], out.prompt_len[rid])
                    for rid, _ in f.rows]
        else:
            toks = [(out.adapter_of[rid], 1) for _, rid, _ in f.rows]
        rows = sum(n for _, n in toks)
        served = {a for a, _ in toks}
        for li in range(layers):
            for name, (i, o) in shapes.items():
                if name.startswith("x"):
                    continue
                byt = sum(_work.entry_bytes(o, i, r, out.entry_h[a][name][li],
                                            bits) for a in served)
                bound += _work.lora_call(rows, i, o, min(r, i, o), byt)
            if experts:
                bound += _experts(f, li, out, shapes, r, bits, experts, k)
    return 100.0 * bound / spent


def _experts(f, li, out, shapes, r, bits, n_exp, k):
    e, _, kept = f.routing[li]
    owner = np.full(e.shape[0] // k, -1)
    if f.kind == "prefill":
        for b, (rid, _) in enumerate(f.rows):
            p = out.prompt_len[rid]
            owner[b * f.tpad + f.tpad - p:(b + 1) * f.tpad] = \
                out.adapter_of[rid]
    else:
        for i, rid, _ in f.rows:
            owner[i] = out.adapter_of[rid]
    who = np.repeat(owner, k)
    real = kept & (who >= 0)
    pairs = Counter(zip(who[real].tolist(), e[real].tolist()))
    total = 0.0
    for name in ("xwg", "xwu", "xwd"):
        i, o = shapes[name]
        byt = sum(_work.entry_bytes(o, i, r,
                                    out.entry_h[a][name][li * n_exp + x],
                                    bits) for a, x in pairs)
        total += _work.lora_call(sum(pairs.values()), i, o, r, byt)
    return total
