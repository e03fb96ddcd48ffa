"""Time the quant_matmul kernels on the card at llama3.2-3b's LoRA shapes
(and ``sgmv_fused`` at mixtral-8x22b's).

    python3 src/repro_torch/launch/bench_kernels.py [--src DIR] [--label NAME]
                                                    [--rank R]

Each kernel is timed three ways, at every (K, M) of the model's LoRA
linears, at decode (16 rows) and prefill (512 rows), bits 2, adapters of
LoRA rank ``--rank`` (16, the configs' default; the fused kernels meet
``2·rp`` rank rows, ``rp = ceil(R / 8)·8``, the rhs / out kernels ``rp``;
mixtral's shapes only at rank 16):

* device time: ``CALLS`` wrapper calls captured in one CUDA graph, the graph
  replayed and timed with CUDA events (the inputs stay in L2);
* cold-L2 device time: the same, the calls rotating over distinct copies
  of the inputs, at least ``LAYERS`` = 28 (one per layer) and at least
  twice the 50 MB L2 in bytes, so each call finds its inputs evicted, as
  on the serve path, where each layer's base weights pass through L2
  between two LoRA calls;
* host time: the wrapper's wall time per call on the host (its checks, the
  launch plan, the launch), without waiting for the card.

It prints one line per case and a last JSON line with each kernel's
main-path mix (every linear once at prefill and ``MAX_NEW - 1`` times at
decode) and the mix's bound (:func:`call_bound`: the bytes a call must
move over the HBM peak or its fp32 operations over the fp32 peak, the
larger). ``sgmv_fused_moe`` is ``sgmv_fused`` at mixtral-8x22b's five
(K, M) with the MoE path's folded seg ids: 8 adapters x 8 experts stacked
as 64 entries, tile_t 1, over the dispatch buffer's rows (8 experts x
capacity: 64 rows at decode, 1280 at prefill of 16 x 32 tokens). ``--src`` imports ``repro_torch`` from another checkout's ``src``
(e.g. an unpacked ``git archive`` of a parent commit), so two versions of
the kernels are timed by the same code, one process each. The builders and
timers here are also used by ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

LAYERS = 28
LINEARS = {"wq": (3072, 3072), "wk": (3072, 1024), "wv": (3072, 1024),
           "wo": (3072, 3072), "wg": (3072, 8192), "wu": (3072, 8192),
           "wd": (8192, 3072)}
SHAPES = [(3072, 3072), (3072, 1024), (3072, 8192), (8192, 3072)]
N_REQ, PROMPT, MAX_NEW, N_ADAPTERS = 16, 32, 8, 8
PHASES = {"decode": (1, N_REQ), "prefill": (8, N_REQ * PROMPT)}  # tile, rows
# mixtral-8x22b: every LoRA linear of a layer, the router (M = 8 experts)
# and the expert linears (one launch over all experts' dispatch rows)
MOE_LINEARS = {"wq": (6144, 6144), "wk": (6144, 1024), "wv": (6144, 1024),
               "wo": (6144, 6144), "router": (6144, 8),
               "wg": (6144, 16384), "wu": (6144, 16384),
               "wd": (16384, 6144)}
MOE_SHAPES = [(6144, 6144), (6144, 1024), (6144, 16384), (16384, 6144),
              (6144, 8)]
MOE_EXPERTS = 8
# dispatch rows E·cap, cap = max(ceil(tokens·2/8·1.25), 8): 8 decode rows
# give cap 8, 16 x 32 prefill tokens cap 160; every tile is one row
MOE_PHASES = {"decode": (1, MOE_EXPERTS * 8),
              "prefill": (1, MOE_EXPERTS * 160)}
CALLS = 20                  # wrapper calls per captured graph
L2_BYTES = 50 << 20         # H100 L2
MAX_COPIES = 512
RANK = 16                   # the configs' lora_rank
HBM_BYTES_PER_S = 3.35e12   # H100 SXM published peaks
FP32_FLOPS_PER_S = 67e12


# --------------------------------------------------------------------------
# inputs
# --------------------------------------------------------------------------

def packed_layer(k, m, bits, group, na, seed, r=RANK):
    """``na`` random adapters of rank ``r`` quantized by the port (refine
    off), packed as one layer ``(NA, Rp, ·)``; rho cycles so split h differs
    per adapter and one adapter keeps every pair high (h == r). The
    spectrum decays over the rank as rank 16's ``exp(-0.3 i)`` does."""
    import torch
    from repro_torch.core import LoRAQuantConfig, quantize_lora
    from repro_torch.kernels.quant_matmul import (pack_adapter_layers,
                                                   stack_packed_adapters)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    decay = torch.exp(-0.3 * RANK / r * torch.arange(r, device="cuda"))
    qls = []
    for i in range(na):
        b = torch.randn(m, r, generator=gen, device="cuda") * decay
        a = torch.randn(r, k, generator=gen, device="cuda") * decay[:, None]
        rho = (0.5, 0.8, 0.9, 1.0)[i % 4]
        qls.append(quantize_lora(b, a, LoRAQuantConfig(
            rho=rho, bits_high=bits, group_size=group, refine="none")))
    hs = {q.h for q in qls}
    if len(hs) < 2 or all(q.a_low is not None for q in qls):
        raise AssertionError(f"adapters do not mix split h: {sorted(hs)}")
    pb = stack_packed_adapters([pack_adapter_layers([q]) for q in qls])
    return pb.layer(0)


def moe_seg_for(phase):
    """Folded seg ids of the MoE dispatch rows: row r belongs to expert
    ``r // cap`` and carries adapter ``(r mod cap) mod 8``, so the tile's
    entry is ``adapter·8 + expert`` in the ``(8·8, Rp, ·)`` stack."""
    import torch

    _, rows = MOE_PHASES[phase]
    cap = rows // MOE_EXPERTS
    r = torch.arange(rows, device="cuda")
    return ((r % cap) % N_ADAPTERS * MOE_EXPERTS + r // cap).to(torch.int32)


def packed_args(pb, x, seg_tiles, tile_t):
    """``(args, kwargs)`` of ``sgmv_fused`` (or its plain version) on one
    packed layer: both sides, as the serve path calls it."""
    return ((x, pb.ah_codes, pb.ah_scale, pb.ah_zero, pb.bh_codes,
             pb.bh_scale, pb.bh_zero, seg_tiles),
            dict(bits_a=pb.bits_hi, binary_a=False, group_a=pb.group_ah,
                 bits_b=pb.bits_hi, binary_b=False, group_b=pb.group_bh,
                 a_lo=(pb.al_codes, pb.al_scale, pb.al_zero),
                 b_lo=(pb.bl_codes, pb.bl_scale, pb.bl_zero),
                 group_al=pb.group_al, group_bl=pb.group_bl, m=pb.m,
                 tile_t=tile_t))


def seg_for(phase):
    """Token tiles and their adapters: request r uses adapter r mod 8; a
    prompt spans PROMPT / tile_t tiles."""
    import torch

    tile_t, rows = PHASES[phase]
    n_tiles = rows // tile_t
    per_req = max(1, n_tiles // N_REQ)
    return ((torch.arange(n_tiles, device="cuda") // per_req)
            % N_ADAPTERS).to(torch.int32)


def decayed_pairs(n, m, k, r, seed, scale=1.0, device="cuda"):
    """``n`` adapters ``b (n, m, r)``, ``a (n, r, k)`` with orthonormal
    factors and one fixed singular spectrum ``scale·exp(-0.4 i)``, so
    ``select_h`` gives every one the same split h."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u = torch.linalg.qr(torch.randn(n, m, r, generator=gen,
                                    device=device))[0]
    v = torch.linalg.qr(torch.randn(n, k, r, generator=gen,
                                    device=device))[0]
    s = scale * torch.exp(-0.4 * torch.arange(r, device=device))
    return u * s.sqrt(), s.sqrt()[:, None] * v.mT


def single_qlora(k, m, bits, rho, seed, r=RANK):
    from repro_torch.core import LoRAQuantConfig, quantize_lora

    b, a = decayed_pairs(1, m, k, r, seed)
    return quantize_lora(b[0], a[0], LoRAQuantConfig(
        rho=rho, bits_high=bits, group_size=128, refine="none"))


def side_layout(q):
    from repro_torch.kernels.quant_matmul.ops import _kernel_layout

    return _kernel_layout(q)[:3]


def fused_args(q):
    """``(sides, kwargs)`` of ``fused_lora`` (or its plain version) for one
    adapter, laid out once so that a timed call times the wrapper and its
    kernel only."""
    kw = dict(m=q.b_high.orig_shape[0], bits_hi=q.a_high.bits,
              binary_hi=False, group_ah=q.a_high.group_size,
              group_bh=q.b_high.group_size)
    lo = (None, None)
    if q.a_low is not None:
        lo = (side_layout(q.a_low), side_layout(q.b_low))
        kw.update(group_al=q.a_low.group_size, group_bl=q.b_low.group_size)
    return (side_layout(q.a_high), side_layout(q.b_high), *lo), kw


def sgmv_sides(k, m, fmt, seed, na=N_ADAPTERS, r=RANK):
    """``na`` adapters' A ``(r, K)`` and Bᵀ-view ``(M, r)`` factors quantized
    per side in one format (group 128): the per-adapter QuantizedTensors
    and their ``(NA, Rp, ·)`` stacks."""
    import torch
    from repro_torch.core.quant import binary_quantize, rtn_quantize
    from repro_torch.kernels.quant_matmul import stack_adapter_side

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    decay = torch.exp(-0.3 * RANK / r * torch.arange(r, device="cuda"))

    def q(w, axis):
        if fmt == "binary":
            return binary_quantize(w, 128, axis=axis)
        return rtn_quantize(w, int(fmt[3:]), 128, axis=axis)

    qas = [q(torch.randn(r, k, generator=gen, device="cuda")
             * decay[:, None], 1) for _ in range(na)]
    qbs = [q(torch.randn(m, r, generator=gen, device="cuda") * decay, 0)
           for _ in range(na)]
    return qas, qbs, stack_adapter_side(qas), stack_adapter_side(qbs)


# --------------------------------------------------------------------------
# timers
# --------------------------------------------------------------------------

def _tensors(v):
    import torch

    if isinstance(v, torch.Tensor):
        return [v]
    if isinstance(v, (tuple, list)):
        return [t for x in v for t in _tensors(x)]
    if isinstance(v, dict):
        return [t for x in v.values() for t in _tensors(x)]
    return []


def _clone(v):
    import torch

    if isinstance(v, torch.Tensor):
        return v.clone()
    if isinstance(v, (tuple, list)):
        return type(v)(_clone(t) for t in v)
    if isinstance(v, dict):
        return {k: _clone(t) for k, t in v.items()}
    return v


def _graph_ms(calls, reps: int = 5) -> float:
    """Device time per call of ``calls`` captured in one CUDA graph, the
    graph replayed ``reps`` times between CUDA events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # first use: build, attributes
        for f in calls[:2]:
            f()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for f in calls:
            f()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / (reps * len(calls))
    del graph
    return ms


def device_times(fn, args, kwargs) -> dict:
    """``{"ms"}``: the device time per call of ``fn(*args, **kwargs)`` with
    its inputs in L2 alone (the first of :func:`kernel_times`)."""
    return {"ms": _graph_ms([lambda: fn(*args, **kwargs)] * CALLS)}


def host_ms(fn, iters: int = CALLS) -> float:
    """Host wall time per call of ``fn`` (no wait for the card)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e3 / iters


def kernel_times(fn, args, kwargs) -> dict:
    """``{"ms", "cold_ms", "host_ms"}`` of ``fn(*args, **kwargs)``: device
    time with the inputs in L2, device time rotating over copies of the
    inputs (at least ``LAYERS``, at least twice the L2 in bytes), and the
    host's time per call."""
    def call(a=args):
        return fn(*a, **kwargs)

    warm = _graph_ms([call] * CALLS)
    nbytes = sum(t.nbytes for t in _tensors((args, kwargs)))
    n = min(MAX_COPIES, max(LAYERS, -(-2 * L2_BYTES // max(nbytes, 1))))
    copies = [(_clone(args), _clone(kwargs)) for _ in range(n)]
    cold = _graph_ms([lambda a=a, kw=kw: fn(*a, **kw) for a, kw in copies]
                     * 2)
    del copies
    return {"ms": warm, "cold_ms": cold, "host_ms": host_ms(call)}


# --------------------------------------------------------------------------
# the bound
# --------------------------------------------------------------------------

def _side_bytes(side, binary, used=None) -> int:
    """Packed bytes of one side ``(codes, scale, zero)`` (a binary side's
    zero-points are never read); of ``used`` adapters of a stack."""
    codes, scale, zero = side
    arrays = [codes, scale] + ([] if binary or zero is None else [zero])
    if used is None:
        return sum(t.nbytes for t in arrays)
    return used * sum(t[0].nbytes for t in arrays)


def call_bound(name, args, kw) -> tuple:
    """``(t_bytes, t_ops)`` in ms of one call of kernel ``name``: the bytes
    it must move (x or h, the packed sides of the adapters its tiles use,
    the seg map, its fp32 output) over the HBM peak, and its fp32
    operations (a multiply and an add per rank row per input and output
    column per row) over the fp32 peak. The bound is the larger."""
    x = args[0]
    t = x.shape[0]
    if name in ("sgmv_fused", "sgmv_fused_moe"):
        seg, m = args[7], kw["m"]
        used = len(set(seg.tolist()))
        sides = [(args[1:4], kw["binary_a"]), (args[4:7], kw["binary_b"])]
        if kw.get("a_lo") is not None:
            lo_binary = kw.get("binary_lo", True)
            sides += [(kw["a_lo"], lo_binary), (kw["b_lo"], lo_binary)]
        rows = sum(side[0].shape[1] for side, _ in sides[::2])
        nbytes = (x.nbytes + seg.nbytes + t * m * 4
                  + sum(_side_bytes(s, b, used) for s, b in sides))
        ops = 2 * t * rows * (x.shape[1] + m)
    elif name == "fused_lora":
        m = kw["m"]
        sides = [(args[1], kw["binary_hi"]), (args[2], kw["binary_hi"])]
        if len(args) > 3 and args[3] is not None:
            sides += [(args[3], kw.get("binary_lo", True)),
                      (args[4], kw.get("binary_lo", True))]
        rows = sum(side[0].shape[0] for side, _ in sides[::2])
        nbytes = (x.nbytes + t * m * 4
                  + sum(_side_bytes(s, b) for s, b in sides))
        ops = 2 * t * rows * (x.shape[1] + m)
    else:
        side = args[1:4]
        stacked = name.startswith("sgmv")
        seg = args[4] if stacked else None
        used = len(set(seg.tolist())) if stacked else None
        rows = side[0].shape[-2]
        if name.endswith("rhs"):
            cols, out_cols = x.shape[1], rows
        else:
            cols = out_cols = (kw["m"] if stacked else
                               side[1].shape[-1] * kw["group"])
        nbytes = (x.nbytes + t * out_cols * 4
                  + _side_bytes(side, kw["binary"], used)
                  + (seg.nbytes if stacked else 0))
        ops = 2 * t * rows * cols
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS_PER_S * 1e3


# --------------------------------------------------------------------------
# the benchmark
# --------------------------------------------------------------------------

def mix(per_case: dict, key: str, linears=None) -> float:
    """Mean per launch over the main path: every linear once at prefill and
    ``MAX_NEW - 1`` times at decode (llama3.2-3b's ``LINEARS``, or
    ``MOE_LINEARS``)."""
    tot = n = 0
    for k, m in (linears or LINEARS).values():
        for phase, count in (("prefill", 1), ("decode", MAX_NEW - 1)):
            tot += count * per_case[(k, m), phase][key]
            n += count
    return tot / n


def cases(rank=RANK, moe=None):
    """``{kernel: {((k, m), phase): (fn, args, kwargs)}}`` at bits 2 and
    LoRA rank ``rank``: the two-sided ``sgmv_fused`` on 8 packed adapters;
    ``fused_lora`` on one rho-0.9 adapter; ``sgmv_rhs`` / ``sgmv_out`` on
    RTN-2 sides of 8 adapters at ``rp`` rank rows and ``matmul_rhs`` /
    ``matmul_out`` on adapter 0 of them; ``sgmv_fused_moe`` too where
    ``moe`` (by default at the configs' rank 16)."""
    import torch
    from repro_torch.kernels import quant_matmul as qm

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    if moe is None:
        moe = rank == RANK
    out = {n: {} for n in ("sgmv_fused", "fused_lora", "matmul_rhs",
                           "matmul_out", "sgmv_rhs", "sgmv_out")
           + (("sgmv_fused_moe",) if moe else ())}
    for k, m in MOE_SHAPES if moe else ():
        pb = packed_layer(k, m, 2, 128, N_ADAPTERS * MOE_EXPERTS,
                          seed=k + m + 2, r=rank)
        for phase, (tile_t, rows) in MOE_PHASES.items():
            x = torch.randn(rows, k, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            out["sgmv_fused_moe"][(k, m), phase] = (
                qm.sgmv_fused, *packed_args(pb, x, moe_seg_for(phase),
                                            tile_t))
    for k, m in SHAPES:
        pb = packed_layer(k, m, 2, 128, N_ADAPTERS, seed=k + m + 2, r=rank)
        q = single_qlora(k, m, 2, 0.9, seed=k + m + 2, r=rank)
        sides, fkw = fused_args(q)
        kw = dict(bits=2, binary=False, group=128)
        _, _, sa, sb = sgmv_sides(k, m, "rtn2", seed=k + 7 * m,
                                  r=-(-rank // 8) * 8)
        a, b = (tuple(t[0] for t in s) for s in (sa, sb))
        for phase, (tile_t, rows) in PHASES.items():
            x = torch.randn(rows, k, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            seg = seg_for(phase)
            key = (k, m), phase
            out["sgmv_fused"][key] = (qm.sgmv_fused,
                                      *packed_args(pb, x, seg, tile_t))
            out["fused_lora"][key] = (qm.fused_lora, (x, *sides), fkw)
            h = qm.matmul_rhs(x, *a, **kw)
            out["matmul_rhs"][key] = (qm.matmul_rhs, (x, *a), kw)
            out["matmul_out"][key] = (qm.matmul_out, (h, *b), kw)
            skw = dict(kw, tile_t=tile_t)
            hs = qm.sgmv_rhs(x, *sa, seg, **skw)
            out["sgmv_rhs"][key] = (qm.sgmv_rhs, (x, *sa, seg), skw)
            out["sgmv_out"][key] = (qm.sgmv_out, (hs, *sb, seg),
                                    dict(skw, m=m))
    return out


# the times a timer gives, as the lines print them
TIME_KEYS = (("ms", "device", "ms"), ("cold_ms", "cold-L2", "ms"),
             ("host_ms", "host", "ms/call"))


def _times(t: dict, sep: str, prefix: str = "") -> str:
    return sep.join(f"{label} {t[prefix + key]:.4f} {unit}"
                    for key, label, unit in TIME_KEYS if prefix + key in t)


def bench(rank=RANK, label="this tree", timer=kernel_times,
          moe=None) -> dict:
    """Times every case of :func:`cases` at LoRA rank ``rank`` with
    ``timer`` (:func:`kernel_times`, or :func:`device_times` for the device
    time alone) and bounds it (:func:`call_bound`); prints a line per case
    and per kernel's main-path mix. Returns ``{kernel: {"mix_<key>"}`` for
    each time the timer gives, ``"mix_bound_ms"``, ``"bound_by"`` and the
    ``"cases"``}."""
    kernels = {}
    for name, per in cases(rank, moe).items():
        times = {}
        for key, (fn, a, kw) in per.items():
            t = times[key] = timer(fn, a, kw)
            t["bytes"], t["ops"] = call_bound(name, a, kw)
            print(f"[bench] {label} {name:10s} K={key[0][0]:5d} "
                  f"M={key[0][1]:5d} {key[1]:7s} {_times(t, '  ')}  bound "
                  f"{max(t['bytes'], t['ops']):.5f} ms", flush=True)
        lin = MOE_LINEARS if name == "sgmv_fused_moe" else LINEARS
        t_bytes, t_ops = mix(times, "bytes", lin), mix(times, "ops", lin)
        timed = next(iter(times.values()))
        r = kernels[name] = {
            **{f"mix_{key}": mix(times, key, lin) for key, _, _ in TIME_KEYS
               if key in timed},
            "mix_bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "cases": {f"{k[0][0]}x{k[0][1]} {k[1]}": v
                      for k, v in times.items()}}
        print(f"[bench] {label} {name} mix: {_times(r, ', ', 'mix_')}, bound "
              f"{r['mix_bound_ms']:.5f} ms ({r['bound_by']})", flush=True)
    return kernels


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]),
                    help="import repro_torch from this src directory "
                         "(default: this checkout's)")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--rank", type=int, default=RANK,
                    help="LoRA rank of the adapters (default %(default)s; "
                         "mixtral's shapes are timed at the default only)")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    import torch

    if not torch.cuda.is_available():
        print("bench_kernels: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    import repro_torch

    print(f"[bench] {args.label}: repro_torch from "
          f"{repro_torch.__file__}; card {card()}; rank {args.rank}",
          flush=True)
    result = {"label": args.label, "card": card(), "rank": args.rank,
              "kernels": bench(args.rank, args.label)}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
