"""Time the quant_matmul kernels on the card at llama3.2-3b's LoRA shapes
(and ``sgmv_fused`` at mixtral-8x22b's).

    python3 src/repro_torch/launch/bench_kernels.py [--src DIR] [--label NAME]

Each kernel is timed three ways, at every (K, M) of the model's LoRA
linears, at decode (16 rows) and prefill (512 rows), bits 2:

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
decode). ``sgmv_fused_moe`` is ``sgmv_fused`` at mixtral-8x22b's five
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


# --------------------------------------------------------------------------
# inputs
# --------------------------------------------------------------------------

def packed_layer(k, m, bits, group, na, seed):
    """``na`` random adapters quantized by the port (refine off), packed as
    one layer ``(NA, Rp, ·)``; rho cycles so split h differs per adapter and
    one adapter keeps every pair high (h == r)."""
    import torch
    from repro_torch.core import LoRAQuantConfig, quantize_lora
    from repro_torch.kernels.quant_matmul import (pack_adapter_layers,
                                                   stack_packed_adapters)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    r = 16
    decay = torch.exp(-0.3 * torch.arange(r, device="cuda"))
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


def decayed_pairs(n, m, k, r, seed, scale=1.0):
    """``n`` adapters ``b (n, m, r)``, ``a (n, r, k)`` with orthonormal
    factors and one fixed singular spectrum ``scale·exp(-0.4 i)``, so
    ``select_h`` gives every one the same split h."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    u = torch.linalg.qr(torch.randn(n, m, r, generator=gen,
                                    device="cuda"))[0]
    v = torch.linalg.qr(torch.randn(n, k, r, generator=gen,
                                    device="cuda"))[0]
    s = scale * torch.exp(-0.4 * torch.arange(r, device="cuda"))
    return u * s.sqrt(), s.sqrt()[:, None] * v.mT


def single_qlora(k, m, bits, rho, seed, r=16):
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


def sgmv_sides(k, m, fmt, seed, na=N_ADAPTERS, r=16):
    """``na`` adapters' A ``(r, K)`` and Bᵀ-view ``(M, r)`` factors quantized
    per side in one format (group 128): the per-adapter QuantizedTensors
    and their ``(NA, Rp, ·)`` stacks."""
    import torch
    from repro_torch.core.quant import binary_quantize, rtn_quantize
    from repro_torch.kernels.quant_matmul import stack_adapter_side

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    decay = torch.exp(-0.3 * torch.arange(r, device="cuda"))

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


def cases():
    """``{kernel: {((k, m), phase): (fn, args, kwargs)}}`` at bits 2: the
    two-sided ``sgmv_fused`` on 8 packed adapters; ``fused_lora`` on one
    rho-0.9 adapter and ``matmul_rhs`` / ``matmul_out`` on its high side;
    ``sgmv_rhs`` / ``sgmv_out`` on RTN-2 sides of 8 adapters."""
    import torch
    from repro_torch.kernels import quant_matmul as qm

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    out = {n: {} for n in ("sgmv_fused", "fused_lora", "matmul_rhs",
                           "matmul_out", "sgmv_rhs", "sgmv_out",
                           "sgmv_fused_moe")}
    for k, m in MOE_SHAPES:
        pb = packed_layer(k, m, 2, 128, N_ADAPTERS * MOE_EXPERTS,
                          seed=k + m + 2)
        for phase, (tile_t, rows) in MOE_PHASES.items():
            x = torch.randn(rows, k, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            out["sgmv_fused_moe"][(k, m), phase] = (
                qm.sgmv_fused, *packed_args(pb, x, moe_seg_for(phase),
                                            tile_t))
    for k, m in SHAPES:
        pb = packed_layer(k, m, 2, 128, N_ADAPTERS, seed=k + m + 2)
        q = single_qlora(k, m, 2, 0.9, seed=k + m + 2)
        sides, fkw = fused_args(q)
        a, b = side_layout(q.a_high), side_layout(q.b_high)
        kw = dict(bits=2, binary=False)
        _, _, sa, sb = sgmv_sides(k, m, "rtn2", seed=k + 7 * m)
        for phase, (tile_t, rows) in PHASES.items():
            x = torch.randn(rows, k, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            seg = seg_for(phase)
            key = (k, m), phase
            out["sgmv_fused"][key] = (qm.sgmv_fused,
                                      *packed_args(pb, x, seg, tile_t))
            out["fused_lora"][key] = (qm.fused_lora, (x, *sides), fkw)
            h = qm.matmul_rhs(x, *a, group=q.a_high.group_size, **kw)
            out["matmul_rhs"][key] = (qm.matmul_rhs, (x, *a),
                                      dict(kw, group=q.a_high.group_size))
            out["matmul_out"][key] = (qm.matmul_out, (h, *b),
                                      dict(kw, group=q.b_high.group_size))
            skw = dict(kw, group=128, tile_t=tile_t)
            hs = qm.sgmv_rhs(x, *sa, seg, **skw)
            out["sgmv_rhs"][key] = (qm.sgmv_rhs, (x, *sa, seg), skw)
            out["sgmv_out"][key] = (qm.sgmv_out, (hs, *sb, seg),
                                    dict(skw, m=m))
    return out


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
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    import torch

    if not torch.cuda.is_available():
        print("bench_kernels: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    import repro_torch

    print(f"[bench] {args.label}: repro_torch from "
          f"{repro_torch.__file__}; card {card()}", flush=True)
    result = {"label": args.label, "card": card(), "kernels": {}}
    for name, per in cases().items():
        times = {}
        for key, (fn, a, kw) in per.items():
            times[key] = kernel_times(fn, a, kw)
            t = times[key]
            print(f"[bench] {args.label} {name:10s} K={key[0][0]:5d} "
                  f"M={key[0][1]:5d} {key[1]:7s} device {t['ms']:.4f} ms  "
                  f"cold-L2 {t['cold_ms']:.4f} ms  host {t['host_ms']:.4f} "
                  f"ms/call", flush=True)
        lin = MOE_LINEARS if name == "sgmv_fused_moe" else LINEARS
        result["kernels"][name] = {
            "mix_ms": mix(times, "ms", lin),
            "mix_cold_ms": mix(times, "cold_ms", lin),
            "mix_host_ms": mix(times, "host_ms", lin),
            "cases": {f"{k[0][0]}x{k[0][1]} {k[1]}": v
                      for k, v in times.items()}}
        r = result["kernels"][name]
        print(f"[bench] {args.label} {name} mix: device {r['mix_ms']:.4f} ms,"
              f" cold-L2 {r['mix_cold_ms']:.4f} ms, host "
              f"{r['mix_host_ms']:.4f} ms/call", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
