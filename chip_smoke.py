#!/usr/bin/env python3
"""Drive the PyTorch/H100 port of LoRAQuant serving on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (a failure raises and the script exits non-zero):

1. Environment: torch / CUDA versions, the card's name and power limit, and
   the nvcc build of every kernel in
   ``src/repro_torch/kernels/quant_matmul/csrc/`` (timed; ptxas registers
   and spills per kernel, and a failure if a kernel has no report).
2. Kernel vs plain: ``sgmv_fused`` against ``sgmv_fused_ref`` (TF32 off) at
   the four (K, M) shapes of llama3.2-3b's LoRA linears, Rp = 16, group 128,
   8 adapters with mixed split h (one with h == r), bits_hi 2/3/4, decode
   (tile_t = 1, 16 rows) and prefill (tile_t = 8, 512 rows), plus a small
   shape whose M is not a multiple of the group. Each case prints the
   kernel's time, the plain version's time and the bound.
3. Serve: ``repro_torch.launch.serve.main`` for llama3.2-3b at full width
   in bf16, 8 adapters ``2@0.9``, 16 requests, prompt 32, 8 new tokens,
   ``--mode packed``; the kernel must have launched 28 layers x 7 LoRA
   linears x 8 forwards = 1568 times.
4. Parity: the same requests at full width in fp32, packed vs materialize
   (dequantized fp adapters): identical greedy tokens, and every step's
   logits within ``LOGIT_RTOL`` of each other. A control run serves 9
   adapters, so requests 8-15 meet another adapter than before (request r
   uses adapter r mod the count): their logits must move by far more than
   the tolerance, which shows the parity check would catch a wrong adapter
   per row, a wrong seg map or a lost LoRA update.
5. Single-adapter kernels vs plain: ``fused_lora``, ``matmul_rhs`` and
   ``matmul_out`` against their plain versions (TF32 off) at the same four
   shapes, rank 16, group 128, bits_hi 2/3/4, one adapter with a low side
   (rho 0.9) and one with h == r (rho 1.0), decode (16 rows) and prefill
   (512 rows) with x bf16, plus (K, M) = (256, 200) in fp32 (3-bit padding,
   and an M that is not a multiple of B's group). ``fused_lora``,
   ``matmul_rhs`` and ``matmul_out`` must give the same bits on two
   launches.
6. The two-pass route: ``lora_apply_quantized(fused=False)`` and
   ``vmem_budget=1`` at every full-width shape (2 ``matmul_rhs`` + 2
   ``matmul_out`` each), and the reference's large-M guard shape (M 32768,
   K 256, r 8, rho 1.0: 1 + 1 and no ``fused_lora``), each held against
   the fused kernel and the plain version.
7. Single-adapter serve: llama3.2-3b full width in bf16, ONE adapter whose
   every LoRA linear is a layer-stacked ``QuantizedLoRA`` (``2@0.9``, one
   split h for all 28 layers), 16 requests, prompt 32, 8 new greedy tokens
   through ``Model.prefill`` / ``Model.decode_step``; ``fused_lora`` must
   have launched exactly 1568 times and no other kernel.
8. Three-way parity in fp32: the same codes served as ``QuantizedLoRA``
   leaves (``fused_lora``), as a one-adapter ``PackedLoRABatch``
   (``sgmv_fused``) and as materialized fp factors: identical greedy tokens
   and every step's logits within ``LOGIT_RTOL``; an adapter from another
   seed must move every request's logits by ``CONTROL_MARGIN`` tolerances.
9. Multi-adapter kernels vs plain (TF32 off): ``sgmv_rhs``, ``sgmv_out``
   and the single-side ``sgmv_fused`` at the four full-width shapes, 8
   adapters of rank 16 quantized per side with ``rtn_quantize`` at 2/3/4
   bits and with ``binary_quantize`` (group 128), decode (tile_t 1, 16
   rows) and prefill (tile_t 8, 512 rows) with x bf16, plus (256, 200) in
   fp32, and one two-sided ``sgmv_fused`` whose low side has another rank
   (8) than the high side (16). ``sgmv_rhs`` and ``sgmv_out`` must give the
   same bits on two launches.
10. ``sgmv_apply`` at every full-width shape, decode and prefill:
    ``fused=True`` launches exactly one ``sgmv_fused``, ``fused=False``
    exactly one ``sgmv_rhs`` and one ``sgmv_out``; both held against the
    dense oracle ``ref_sgmv``.
11. Mixed-recipe serve: llama3.2-3b at full width in bf16, 8 adapters, two
    ``4@0.95``, two ``3@0.9`` and four ``2@0.9`` (3 layout buckets), 16
    requests, prompt 32, 8 new tokens, ``--mode packed``: exactly 3 x 1568
    = 4704 ``sgmv_fused`` launches and no other kernel.
12. fp32 parity of the same mixed-recipe fleet: packed vs materialize,
    identical greedy tokens and every step's logits within ``LOGIT_RTOL``;
    a control in which every request meets another adapter must move every
    request's logits by ``CONTROL_MARGIN`` tolerances.
13. Continuous serve (the serve driver's default mode): the uniform
    ``2@0.9`` fleet at full width in bf16, ``MultiLoRAEngine`` with 8 rows
    over the paged adapter memory, 16 requests drawn Zipf(α=1) over the 8
    adapters as ``benchmarks/bench_serving.py`` draws them, prompt 32, 8
    new tokens; all-resident and bounded to 4 slots: identical tokens, the
    reference's paging of this stream (``ZIPF_BOUNDED``), the pool at 4
    pages, and exactly 196 ``sgmv_fused`` per forward (prefill groups plus
    decode steps) and no other kernel. A third, profiled run times one
    engine step under ``torch.profiler``.
14. fp32 parity of the bounded continuous serve against materialize:
    identical tokens, every step's logits within ``LOGIT_RTOL``, and a
    control in which every request meets another adapter moving them by
    ``CONTROL_MARGIN`` tolerances.
15. Phase 11's three-recipe fleet served continuously under a device
    budget of half the fleet's summed page bytes: at least 2 live pools,
    evictions, and exactly 196 ``sgmv_fused`` per live pool per forward.
    In bf16 a second budgeted run (one engine step profiled) must repeat
    the first's tokens and paging; in fp32 the budgeted serve must give
    the all-resident serve's tokens and logits within ``LOGIT_RTOL``.
16. Chaos storm: ``benchmarks/bench_chaos.py``'s stream (6 adapters
    ``2@0.9``, 12 requests plus one with an impossible TTFT budget, 3
    rows over 3 slots, an all-pinned episode) at full width in fp32,
    under its ``FaultPlan`` (latency spikes, transient read failures,
    ``user_1``'s pages corrupted) on a ``ManualClock``, and fault-free:
    every healthy request's tokens identical, exact statuses, no
    deadlock, virtual goodput within ``GOODPUT_BOUND``, both runs equal to
    the reference's (``CHAOS_STORM``: statuses, injected faults, transport
    and paging stats, schedule, virtual time), and exactly one
    ``sgmv_fused`` per LoRA linear per live pool per forward. Real
    tokens/s of both runs are reported.
17. Telemetry: phase 13's bounded bf16 serve without and with
    ``Telemetry()`` on the real clock, in the order off, on, on, off:
    identical tokens and launches, each registry's
    ``pallas_launches_total{kernel="sgmv_fused"}`` equal to the launches
    (4704), every request's submit → admit → first_token → retire in the
    event log under ``EVENT_SCHEMA``, the three exports parse; TTFT / E2E
    / queue-wait / step percentiles, tokens/s and the engine step per
    run, and the launch sink's host time per call are reported. Then
    ``repro_torch.launch.serve.main`` at full width with ``--inject
    storm``, a queue limit, ``shed_oldest``, a deadline, ``--stats-every``
    and the three exports: the files parse and ``user_1`` is quarantined.

The phases' total time is logged last. The last three lines are the card (nvidia-smi), a ``{"kernels": [...]}``
summary and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
if not (ROOT / "src" / "repro_torch").is_dir():
    sys.exit(f"chip_smoke: no src/repro_torch next to {__file__}; run it "
             f"from a checkout of the repository")
sys.path.insert(0, str(ROOT / "src"))

# The workload (llama3.2-3b's LoRA linears, the serve's requests, decode and
# prefill tiles) and its main-path mix: one definition, shared with the
# kernel benchmark.
from repro_torch.launch.bench_kernels import (  # noqa: E402
    LAYERS, LINEARS, MAX_NEW, N_ADAPTERS, N_REQ, PHASES, PROMPT, SHAPES, mix)

# fp32 tolerance of the kernel against its plain version: both sum the same
# fp32 products in different orders (lane-split K chunks vs cuBLAS), so the
# error is bounded relative to the output's magnitude max |y|.
RTOL = 1e-4
# fp32 tolerance of packed vs materialize logits, relative to max |logit|:
# the two modes run the same weights through differently shaped batches and
# a different LoRA order (kernel vs dequantized factors) for 28 layers.
LOGIT_RTOL = 1e-4
# the control's logits must move by at least this many tolerances
CONTROL_MARGIN = 10
HBM_BYTES_PER_S = 3.35e12      # H100 SXM published peak
FP32_FLOPS_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores


def log(msg: str):
    print(f"[chip_smoke] {msg}", flush=True)


def time_ms(fn, iters: int = 20) -> float:
    """Mean time of ``fn()`` on the card: CUDA events around ``iters`` calls
    after a warm-up (inputs stay in L2 between calls)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound(pb, x, seg_tiles, m):
    """``(t_bytes, t_ops)`` in ms for one call: the bytes it must move (x,
    the packed codes/scales/zeros of the adapters the tiles use — the binary
    sides' zeros are never read —, the seg map, the fp32 output) over the HBM
    peak, and its fp32 operations over the fp32 peak. The bound is the
    larger."""
    used = sorted(set(seg_tiles.tolist()))
    per_adapter = 0
    for f in ("ah_codes", "ah_scale", "ah_zero", "bh_codes", "bh_scale",
              "bh_zero", "al_codes", "al_scale", "bl_codes", "bl_scale"):
        per_adapter += getattr(pb, f)[0].nbytes
    nbytes = (x.nbytes + seg_tiles.nbytes + x.shape[0] * m * 4
              + len(used) * per_adapter)
    rp = pb.ah_codes.shape[1]
    flops = 2 * x.shape[0] * 2 * rp * (x.shape[1] + m)
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3


def timed(name, tag, fn, args, kwargs, plain, t_bytes, t_ops, err):
    """Time one kernel case and log it: device time (CUDA-graph replay) with
    the inputs in L2 and rotating over 28 layer copies (cold L2), the
    wrapper's host time per call, the plain version's time (CUDA events
    around eager calls) and the bound. Returns the numbers as a dict."""
    from repro_torch.launch.bench_kernels import kernel_times

    t = kernel_times(fn, args, kwargs)
    t.update(plain_ms=time_ms(lambda: plain(*args, **kwargs), iters=3),
             bytes=t_bytes, ops=t_ops)
    log(f"{name:10s} {tag} max|err|={err:.2e}  kernel {t['ms']:.4f} ms "
        f"(cold-L2 {t['cold_ms']:.4f}, host {t['host_ms']:.4f} ms/call)  "
        f"plain {t['plain_ms']:.4f} ms  bound {max(t_bytes, t_ops):.5f} ms "
        f"(bytes {t_bytes:.5f}, ops {t_ops:.5f})")
    return t


def phase_kernel():
    import torch
    from repro_torch.kernels.quant_matmul import sgmv_fused, sgmv_fused_ref
    from repro_torch.launch.bench_kernels import (packed_args, packed_layer,
                                                  seg_for)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cases = [((k, m), bits, phase, torch.bfloat16)
             for (k, m) in SHAPES for bits in (2, 3, 4) for phase in PHASES]
    cases += [((256, 200), bits, phase, torch.float32)
              for bits in (2, 3, 4) for phase in PHASES]
    timings = {}
    max_err = 0.0
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    packs = {}
    for (k, m), bits, phase, xdtype in cases:
        if ((k, m), bits) not in packs:
            packs[(k, m), bits] = packed_layer(k, m, bits, 128, N_ADAPTERS,
                                               seed=k + m + bits)
        pb = packs[(k, m), bits]
        tile_t, rows = PHASES[phase]
        seg_tiles = seg_for(phase)
        x = (torch.randn(rows, k, generator=gen, device="cuda")).to(xdtype)
        args, kw = packed_args(pb, x, seg_tiles, tile_t)
        got = sgmv_fused(*args, **kw)
        torch.cuda.synchronize()
        want = sgmv_fused_ref(*args, **kw)
        if got.shape != (rows, m) or not torch.isfinite(got).all():
            raise AssertionError(f"bad kernel output {tuple(got.shape)}")
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        if err > RTOL * scale:
            raise AssertionError(
                f"sgmv_fused K={k} M={m} bits={bits} {phase}: max |err| "
                f"{err:.3e} > {RTOL:g} x {scale:.3e}")
        again = sgmv_fused(*args, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"sgmv_fused K={k} M={m} bits={bits} "
                                 f"{phase}: two launches differ")
        max_err = max(max_err, err)
        timings[(k, m), bits, phase] = timed(
            "sgmv_fused", f"K={k:5d} M={m:5d} bits={bits} {phase:7s} "
            f"T={rows:3d} x={str(xdtype)[6:]:8s}", sgmv_fused, args, kw,
            sgmv_fused_ref, *bound(pb, x, seg_tiles, m), err)
    return timings, max_err


MIX_KEYS = ("ms", "cold_ms", "host_ms", "plain_ms")


def main_path_mix(per_case):
    """Each timing of ``per_case`` (``{((k, m), phase): timings}`` at
    bits_hi 2) per launch over the main path (:func:`mix`: every layer runs
    each of its 7 LoRA linears once at prefill and once per decode step),
    and the mix's bound: the larger of its byte time and its operation
    time."""
    out = {key: mix(per_case, key) for key in MIX_KEYS}
    t_bytes, t_ops = mix(per_case, "bytes"), mix(per_case, "ops")
    out.update(bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    return out


def mix_line(name, x) -> str:
    return (f"{name} mix per launch: kernel {x['ms']:.4f} ms (cold-L2 "
            f"{x['cold_ms']:.4f}, host {x['host_ms']:.4f} ms/call), plain "
            f"{x['plain_ms']:.4f} ms, bound {x['bound_ms']:.5f} ms "
            f"({x['bound_by']})")


LORA_KERNELS = ("sgmv_fused_kernel", "fused_lora_kernel")
KERNELS = ("sgmv_fused", "sgmv_rhs", "sgmv_out", "fused_lora", "matmul_rhs",
           "matmul_out")


def profile_step(step):
    """Run ``step()`` (one decode step) under ``torch.profiler``; returns its
    result and the window: host wall time (synchronized), device busy time
    (the union of the card's kernel and copy spans), the LoRA kernels' share
    and launches, the rest, and the idle share of the window. Falls back to
    CUDA events (no split) if the profiler records no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        start.record()
        out = step()
        stop.record()
        torch.cuda.synchronize()
        window = (time.perf_counter() - t0) * 1e3
    spans, lora, n_lora = [], 0.0, 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        if any(n in e.name for n in LORA_KERNELS):
            lora += e.time_range.end - e.time_range.start
            n_lora += 1
    res = {"window_ms": window, "source": "torch.profiler",
           "events_ms": start.elapsed_time(stop)}
    if not spans:
        res.update(source="CUDA events (the profiler recorded no device "
                          "time)", device_ms=None, lora_ms=None,
                   other_ms=None, idle=None, lora_launches=None, kernels=0)
        return out, res
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):               # union of the spans, in µs
        if b > end:
            busy += b - max(a, end)
            end = b
    total = sum(b - a for a, b in spans)
    res.update(device_ms=busy / 1e3, lora_ms=lora / 1e3,
               other_ms=(total - lora) / 1e3, idle=1 - busy / 1e3 / window,
               lora_launches=n_lora, kernels=len(spans))
    return out, res


@contextlib.contextmanager
def profiled_call(cls, name: str, step: int = 4):
    """While active, call ``step`` of ``cls.name`` (any instance) runs under
    :func:`profile_step` and the next call is timed unprofiled
    (synchronized). Yields the dict that receives both."""
    import torch

    orig = getattr(cls, name)
    res = {"calls": 0}

    def wrapped(self, *a, **kw):
        res["calls"] += 1
        if res["calls"] == step:
            out, res["window"] = profile_step(lambda: orig(self, *a, **kw))
            return out
        if res["calls"] == step + 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(self, *a, **kw)
            torch.cuda.synchronize()
            res["unprofiled_ms"] = (time.perf_counter() - t0) * 1e3
            return out
        return orig(self, *a, **kw)

    setattr(cls, name, wrapped)
    try:
        yield res
    finally:
        setattr(cls, name, orig)


def profiled_decode(step: int = 4):
    """Decode step ``step`` of the model (any caller: ``Model.decode_step``)
    under :func:`profile_step`, the next one timed unprofiled."""
    from repro_torch.models.model import Model

    return profiled_call(Model, "decode_step", step)


def window_line(label, res, what: str = "decode-step") -> str:
    w = res["window"]
    head = (f"{label} {what} profile ({w['source']}): window "
            f"{w['window_ms']:.3f} ms (CUDA events {w['events_ms']:.3f} ms; "
            f"the next step unprofiled {res.get('unprofiled_ms', 0):.3f} ms)")
    if w["device_ms"] is None:
        return head
    return (f"{head}; device busy {w['device_ms']:.3f} ms: LoRA kernels "
            f"{w['lora_ms']:.3f} ms in {w['lora_launches']} launches, other "
            f"device work {w['other_ms']:.3f} ms in "
            f"{w['kernels'] - w['lora_launches']} kernels/copies; idle share "
            f"{w['idle']:.3f} of the window, "
            f"{1 - w['device_ms'] / res.get('unprofiled_ms', w['window_ms']):.3f}"
            f" of the unprofiled step")


def serve(dtype: str, mode: str, adapters: int = N_ADAPTERS,
          keep_logits: bool = False, recipes=()):
    from repro_torch.launch import serve as serve_mod

    return serve_mod.main([
        "--arch", "llama3.2-3b", "--preset", "full", "--dtype", dtype,
        "--adapters", str(adapters), "--variant", "2@0.9",
        "--requests", str(N_REQ), "--prompt-len", str(PROMPT),
        "--max-new", str(MAX_NEW), "--mode", mode, "--seed", "0"]
        + [a for r in recipes for a in ("--recipe", r)]
        + (["--keep-logits"] if keep_logits else []))


def logit_gap(a, b) -> dict:
    """Per request id, max |a.logits - b.logits| over steps and vocab."""
    import numpy as np

    lb = {r.request_id: r.logits for r in b}
    return {r.request_id: float(np.abs(r.logits - lb[r.request_id]).max())
            for r in a}


def check_outputs(done, vocab: int):
    from repro_torch.serving import RequestStatus

    if len(done) != N_REQ:
        raise AssertionError(f"{len(done)} requests finished, want {N_REQ}")
    for r in done:
        if (r.status is not RequestStatus.DONE or r.output.shape != (MAX_NEW,)
                or not ((0 <= r.output) & (r.output < vocab)).all()):
            raise AssertionError(f"request {r.request_id}: {r.status} "
                                 f"{r.output}")
    return {r.request_id: r.output.tolist() for r in done}


# --------------------------------------------------------------------------
# single-adapter apply (fused_lora, matmul_rhs, matmul_out)
# --------------------------------------------------------------------------

SINGLE_PHASES = {phase: rows for phase, (_, rows) in PHASES.items()}
GUARD = (32768, 256, 8, 128)          # M, K, rank, rows: the large-M guard


def side_bytes(side, binary):
    codes, scale, zero = side
    return codes.nbytes + scale.nbytes + (0 if binary else zero.nbytes)


def single_bounds(q, x, m):
    """``{kernel: (t_bytes, t_ops)}`` in ms for one call of each kernel on
    this adapter and x: the bytes it must move (x or h, the packed sides it
    reads — a binary side's zeros are never read —, its fp32 output) over
    the HBM peak, and its fp32 operations over the fp32 peak. ``matmul_*``
    count the high side, as they are timed."""
    from repro_torch.launch.bench_kernels import side_layout

    t, k = x.shape
    sides = [(q.a_high, q.b_high)] + ([(q.a_low, q.b_low)]
                                      if q.a_low is not None else [])
    rows = [side_layout(a)[0].shape[0] for a, _ in sides]
    fused_bytes = (x.nbytes + t * m * 4 + sum(
        side_bytes(side_layout(a), a.mode == "binary")
        + side_bytes(side_layout(b), b.mode == "binary") for a, b in sides))
    rh = rows[0]
    mp = side_layout(q.b_high)[1].shape[1] * q.b_high.group_size
    rhs_bytes = x.nbytes + side_bytes(side_layout(q.a_high), False) + t * rh * 4
    out_bytes = t * rh * 4 + side_bytes(side_layout(q.b_high), False) + t * mp * 4
    ms = 1e3
    return {
        "fused_lora": (fused_bytes / HBM_BYTES_PER_S * ms,
                       2 * t * sum(rows) * (k + m) / FP32_FLOPS_PER_S * ms),
        "matmul_rhs": (rhs_bytes / HBM_BYTES_PER_S * ms,
                       2 * t * rh * k / FP32_FLOPS_PER_S * ms),
        "matmul_out": (out_bytes / HBM_BYTES_PER_S * ms,
                       2 * t * rh * mp / FP32_FLOPS_PER_S * ms),
    }


def check_close(name, got, want):
    """Kernel output against its plain version within RTOL · max |y|;
    returns the max abs error."""
    import torch

    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: bad kernel output {tuple(got.shape)}"
                             f" (want {tuple(want.shape)})")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    if err > RTOL * scale:
        raise AssertionError(f"{name}: max |err| {err:.3e} > {RTOL:g} x "
                             f"{scale:.3e}")
    return err


def phase_single_kernels():
    """fused_lora / matmul_rhs / matmul_out against their plain versions;
    returns ``{(kernel, (k, m), bits, rho, phase): timings}`` (see
    :func:`timed`) and the max error per kernel."""
    import torch
    from repro_torch.kernels.quant_matmul import (
        fused_lora, fused_lora_ref, matmul_out, matmul_out_ref, matmul_rhs,
        matmul_rhs_ref)
    from repro_torch.launch.bench_kernels import (fused_args, side_layout,
                                                  single_qlora)

    cases = [((k, m), bits, rho, phase, torch.bfloat16)
             for (k, m) in SHAPES for bits in (2, 3, 4) for rho in (0.9, 1.0)
             for phase in SINGLE_PHASES]
    cases += [((256, 200), bits, rho, phase, torch.float32)
              for bits in (2, 3, 4) for rho in (0.9, 1.0)
              for phase in SINGLE_PHASES]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    timings, max_err = {}, {"fused_lora": 0.0, "matmul_rhs": 0.0,
                            "matmul_out": 0.0}
    adapters = {}
    for (k, m), bits, rho, phase, xdtype in cases:
        if ((k, m), bits, rho) not in adapters:
            adapters[(k, m), bits, rho] = single_qlora(k, m, bits, rho,
                                                       seed=k + m + bits)
        q = adapters[(k, m), bits, rho]
        if (q.a_low is None) != (rho == 1.0):
            raise AssertionError(f"rho {rho} gave h = {q.h} of {q.rank}")
        rows = SINGLE_PHASES[phase]
        x = torch.randn(rows, k, generator=gen, device="cuda").to(xdtype)
        tag = f"K={k:5d} M={m:5d} bits={bits} rho={rho} {phase:7s} T={rows:3d}"
        sides, fkw = fused_args(q)
        got = fused_lora(x, *sides, **fkw)
        torch.cuda.synchronize()
        errs = {"fused_lora": check_close(f"fused_lora {tag}", got,
                                          fused_lora_ref(x, *sides, **fkw))}
        if not torch.equal(got, fused_lora(x, *sides, **fkw)):
            raise AssertionError(f"fused_lora {tag}: two launches differ")
        # both sides of the two-pass path; the high side is timed
        pairs = [(q.a_high, q.b_high)] + ([(q.a_low, q.b_low)]
                                          if q.a_low is not None else [])
        for qa, qb in pairs:
            kw = dict(bits=qa.bits, binary=qa.mode == "binary")
            a, b = side_layout(qa), side_layout(qb)
            h = matmul_rhs(x, *a, group=qa.group_size, **kw)
            y = matmul_out(h, *b, group=qb.group_size, **kw)
            torch.cuda.synchronize()
            if not torch.equal(h, matmul_rhs(x, *a, group=qa.group_size,
                                             **kw)):
                raise AssertionError(f"matmul_rhs {tag}: two launches "
                                     f"differ")
            if not torch.equal(y, matmul_out(h, *b, group=qb.group_size,
                                             **kw)):
                raise AssertionError(f"matmul_out {tag}: two launches "
                                     f"differ")
            for name, g, w in (
                    ("matmul_rhs", h, matmul_rhs_ref(x, *a, group=qa.group_size,
                                                     **kw)),
                    ("matmul_out", y, matmul_out_ref(h, *b,
                                                     group=qb.group_size,
                                                     **kw))):
                errs[name] = max(errs.get(name, 0.0),
                                 check_close(f"{name} {tag}", g, w))
        for name, e in errs.items():
            max_err[name] = max(max_err[name], e)
        a, b = side_layout(q.a_high), side_layout(q.b_high)
        kw = dict(bits=bits, binary=False)
        h = matmul_rhs(x, *a, group=q.a_high.group_size, **kw)
        runs = {
            "fused_lora": (fused_lora, fused_lora_ref, (x, *sides), fkw),
            "matmul_rhs": (matmul_rhs, matmul_rhs_ref, (x, *a),
                           dict(kw, group=q.a_high.group_size)),
            "matmul_out": (matmul_out, matmul_out_ref, (h, *b),
                           dict(kw, group=q.b_high.group_size)),
        }
        bounds = single_bounds(q, x, m)
        for name, (kern, plain, args, kwargs) in runs.items():
            timings[name, (k, m), bits, rho, phase] = timed(
                name, f"{tag} x={str(xdtype)[6:]:8s}", kern, args, kwargs,
                plain, *bounds[name], errs[name])
    return timings, max_err


def single_mix(timings, name):
    """Mean per launch of ``name`` over the single-adapter serve's mix
    (bits 2, rho 0.9; each of the 7 LoRA linears once at prefill and once
    per decode step), as :func:`main_path_mix` does for ``sgmv_fused``."""
    return main_path_mix({((k, m), phase): timings[name, (k, m), 2, 0.9, phase]
                          for (k, m) in SHAPES for phase in SINGLE_PHASES})


def phase_two_pass():
    """The two-pass route of ``lora_apply_quantized`` on the card: launch
    counts per call and outputs against the fused kernel and the plain
    version. Returns the launch counts of the whole phase."""
    import torch
    from repro_torch.kernels.quant_matmul import (
        LAUNCH_COUNTS, fused_lora, fused_lora_ref, lora_apply_quantized,
        reset_launch_counts)
    from repro_torch.launch.bench_kernels import fused_args, single_qlora

    gen = torch.Generator(device="cuda")
    gen.manual_seed(99)
    total = {}

    def run(want_counts, **kw):
        reset_launch_counts()
        y = lora_apply_quantized(x, q, scaling=2.0, **kw)
        torch.cuda.synchronize()
        if dict(LAUNCH_COUNTS) != want_counts:
            raise AssertionError(f"lora_apply_quantized({kw}) launched "
                                 f"{dict(LAUNCH_COUNTS)}, want {want_counts}")
        for n, c in LAUNCH_COUNTS.items():
            total[n] = total.get(n, 0) + c
        return y

    two = {"matmul_rhs": 2, "matmul_out": 2}
    for k, m in SHAPES:
        q = single_qlora(k, m, 2, 0.9, seed=k * 3 + m)
        x = torch.randn(SINGLE_PHASES["decode"], k, generator=gen,
                        device="cuda")
        want = run({"fused_lora": 1})
        for kw in (dict(fused=False), dict(vmem_budget=1)):
            check_close(f"two-pass {kw} K={k} M={m}", run(two, **kw), want)
        sides, fkw = fused_args(q)
        check_close(f"fused K={k} M={m} vs plain", want,
                    2.0 * fused_lora_ref(x, *sides, **fkw))
    m, k, r, rows = GUARD
    q = single_qlora(k, m, 2, 1.0, seed=13, r=r)
    x = torch.randn(rows, k, generator=gen, device="cuda")
    got = run({"matmul_rhs": 1, "matmul_out": 1})
    sides, fkw = fused_args(q)
    check_close("large-M guard vs plain", got,
                2.0 * fused_lora_ref(x, *sides, **fkw))
    check_close("large-M guard vs fused_lora", got,
                2.0 * fused_lora(x, *sides, **fkw))
    total.pop("fused_lora", None)     # the comparisons' fused calls
    log(f"two-pass route: {len(SHAPES)} shapes x (fused=False, vmem_budget=1)"
        f" launched 2 + 2 each; the large-M guard (M={m}, K={k}, r={r}, "
        f"T={rows}) 1 + 1 and no fused_lora; all within {RTOL:g} x max|y| "
        f"of the fused kernel and the plain version")
    return total


def stack_layers(qls):
    """Per-layer ``QuantizedLoRA`` entries of one split h → one
    layer-stacked ``QuantizedLoRA`` (every array with a leading ``(L,)``)."""
    import dataclasses

    import torch

    if len({q.h for q in qls}) != 1:
        raise AssertionError(f"layers split at different h: "
                             f"{sorted({q.h for q in qls})}")

    def stack(ts):
        return dataclasses.replace(ts[0], **{
            f: torch.stack([getattr(t, f) for t in ts])
            for f in ("codes", "scale", "zero")})

    q0 = qls[0]
    low = q0.a_low is not None
    return dataclasses.replace(
        q0, b_high=stack([q.b_high for q in qls]),
        a_high=stack([q.a_high for q in qls]),
        b_low=stack([q.b_low for q in qls]) if low else None,
        a_low=stack([q.a_low for q in qls]) if low else None)


def single_adapter(template, seed):
    """One adapter over every LoRA linear of ``template`` (an fp lora
    tree), quantized ``2@0.9`` by the port's pipeline: per path the list of
    per-layer ``QuantizedLoRA`` entries."""
    from repro_torch.core import LoRAQuantConfig, quantize_lora_stack
    from repro_torch.launch.bench_kernels import decayed_pairs
    from repro_torch.serving.engine import iter_lora_linears

    entries = {}
    for i, (path, leaf) in enumerate(iter_lora_linears(template)):
        n, r, k = leaf["a"].shape
        b, a = decayed_pairs(n, leaf["b"].shape[1], k, r, seed=seed * 100 + i)
        entries[path] = quantize_lora_stack(
            b, a, LoRAQuantConfig(rho=0.9, bits_high=2))
    return entries


def lora_tree(template, entries, form):
    """The adapter's lora tree in one of three forms: ``qlora`` (stacked
    ``QuantizedLoRA`` leaves), ``packed`` (a one-adapter
    ``PackedLoRABatch`` per leaf, prefill tiles of 8 rows) or ``fp``
    (materialized fp32 factors)."""
    import torch
    from repro_torch.kernels.quant_matmul import (pack_adapter_layers,
                                                   stack_packed_adapters)

    def leaf(path):
        qls = entries[path]
        if form == "qlora":
            return stack_layers(qls)
        if form == "packed":
            return stack_packed_adapters([pack_adapter_layers(qls)], tile_t=8)
        bs, as_ = zip(*(q.materialize() for q in qls))
        return {"a": torch.stack(as_), "b": torch.stack(bs)}

    def rebuild(node, path):
        if isinstance(node, dict) and set(node) == {"a", "b"}:
            return leaf(path)
        if isinstance(node, dict):
            return {k: rebuild(v, f"{path}/{k}") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(v, f"{path}/{i}")
                              for i, v in enumerate(node))
        return node

    return rebuild(template, "")


def greedy(model, base, lora_pre, lora_dec, prompts):
    """Prefill the prompts, then decode greedily to MAX_NEW tokens through
    the model's public API. Returns tokens ``(B, MAX_NEW)`` and every
    step's last-position logits ``(B, MAX_NEW, V)`` fp32, on the card."""
    import torch

    b = prompts.shape[0]
    logits, caches = model.prefill({"base": base, "lora": lora_pre},
                                   {"tokens": prompts}, PROMPT + MAX_NEW)
    last = logits[:, -1].argmax(-1)
    outs, kept = [last], [logits[:, -1].float()]
    del logits
    for k in range(MAX_NEW - 1):
        pos = torch.full((b,), PROMPT + k, dtype=torch.int64, device="cuda")
        logits, caches = model.decode_step(
            {"base": base, "lora": lora_dec}, last[:, None], caches, pos)
        last = logits[:, -1].argmax(-1)
        outs.append(last)
        kept.append(logits[:, -1].float())
    return torch.stack(outs, 1), torch.stack(kept, 1)


def phase_single_serve():
    """Phases 7 and 8; returns the bf16 run's launch counts and numbers."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.quant_matmul import (LAUNCH_COUNTS,
                                                   reset_launch_counts,
                                                   retile_packed)
    from repro_torch.models import build_model

    cfg = get_config("llama3.2-3b", "full")
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(N_REQ, PROMPT)), device="cuda")
    res = {}
    for dtype in (torch.bfloat16, torch.float32):
        model = build_model(dataclasses.replace(cfg, dtype=dtype))
        params = model.init(seed=0, device="cuda")
        base, template = params["base"], params["lora"]
        t0 = time.perf_counter()
        entries = single_adapter(template, seed=1)
        torch.cuda.synchronize()
        t_quant = time.perf_counter() - t0
        hs = {p: qls[0].h for p, qls in entries.items()}
        qtree = lora_tree(template, entries, "qlora")
        if dtype == torch.bfloat16:
            # ---- 7. single-adapter serve, bf16 ----------------------------
            with profiled_decode() as prof7:  # the warm-up, profiled
                greedy(model, base, qtree, qtree, prompts)
            log(window_line("single-adapter serve", prof7))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t0 = time.perf_counter()
            toks, _ = greedy(model, base, qtree, qtree, prompts)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = dict(LAUNCH_COUNTS)
            want = {"fused_lora": LAYERS * len(LINEARS) * MAX_NEW}
            if counts != want:
                raise AssertionError(f"single-adapter serve launched "
                                     f"{counts}, want {want}")
            if not ((0 <= toks) & (toks < cfg.vocab)).all():
                raise AssertionError(f"tokens out of range: {toks}")
            res.update(tokens_per_s=N_REQ * MAX_NEW / dt, seconds=dt,
                       peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                       launches=counts["fused_lora"], quantize_s=t_quant)
            log(f"single-adapter serve bf16: adapter quantized 2@0.9 in "
                f"{t_quant:.2f}s (split h per path {hs}); "
                f"{N_REQ * MAX_NEW} tokens in {dt:.3f}s "
                f"({res['tokens_per_s']:.1f} tokens/s), peak device memory "
                f"{res['peak_gib']:.2f} GiB; launches {counts}")
        else:
            # ---- 8. three-way parity in fp32 -------------------------------
            packed = lora_tree(template, entries, "packed")
            seg = torch.zeros(N_REQ, dtype=torch.int32, device="cuda")
            pre = {"groups": packed["groups"],
                   "seg": seg.repeat_interleave(PROMPT)}
            dec = {"groups": retile_packed(packed, 1)["groups"], "seg": seg}
            fp = lora_tree(template, entries, "fp")
            runs = {}
            for name, lp, ld, kern in (("fused_lora", qtree, qtree,
                                        "fused_lora"),
                                       ("sgmv_fused", pre, dec, "sgmv_fused"),
                                       ("materialize", fp, fp, None)):
                reset_launch_counts()
                runs[name] = greedy(model, base, lp, ld, prompts)
                torch.cuda.synchronize()
                want = ({kern: LAYERS * len(LINEARS) * MAX_NEW} if kern
                        else {})
                if dict(LAUNCH_COUNTS) != want:
                    raise AssertionError(f"fp32 {name} run launched "
                                         f"{dict(LAUNCH_COUNTS)}, want {want}")
            del packed, pre, dec, fp
            other = lora_tree(template, single_adapter(template, seed=2),
                              "qlora")
            runs["control"] = greedy(model, base, other, other, prompts)
            ref_toks, ref_logits = runs["fused_lora"]
            scale = ref_logits.abs().max().item()
            tol = LOGIT_RTOL * scale
            gaps = {}
            for name in ("sgmv_fused", "materialize"):
                toks, logits = runs[name]
                if not torch.equal(toks, ref_toks):
                    bad = (toks != ref_toks).any(1).nonzero().flatten()
                    raise AssertionError(f"fp32 greedy tokens of fused_lora "
                                         f"and {name} differ for requests "
                                         f"{bad.tolist()}")
                gaps[name] = (logits - ref_logits).abs().max().item()
                if gaps[name] > tol:
                    raise AssertionError(f"fp32 logits of fused_lora and "
                                         f"{name} differ by {gaps[name]:.3e}"
                                         f" > {LOGIT_RTOL:g} x {scale:.3e}")
            moved = (runs["control"][1] - ref_logits).abs().amax(
                dim=(1, 2))
            if moved.min().item() < CONTROL_MARGIN * tol:
                raise AssertionError(f"another adapter moves the logits by "
                                     f"only {moved.tolist()}, under "
                                     f"{CONTROL_MARGIN} x {tol:.3e}: the "
                                     f"parity check is blind")
            res.update(parity_gaps=gaps, parity_tol=tol, logit_scale=scale,
                       control_min=moved.min().item(),
                       control_max=moved.max().item())
            log(f"three-way fp32 parity: identical greedy tokens for all "
                f"{N_REQ} requests ({N_REQ * MAX_NEW} tokens) across "
                f"fused_lora, sgmv_fused and materialize; logits max |diff| "
                f"vs fused_lora: sgmv_fused {gaps['sgmv_fused']:.3e}, "
                f"materialize {gaps['materialize']:.3e} <= {tol:.3e} "
                f"({LOGIT_RTOL:g} x max|logit| {scale:.3e}); an adapter from "
                f"another seed moves every request by "
                f"{res['control_min']:.3e} to {res['control_max']:.3e}")
        del model, params, base, template, entries, qtree
        torch.cuda.empty_cache()
    return res


# --------------------------------------------------------------------------
# multi-adapter kernels (sgmv_rhs, sgmv_out, single-side sgmv_fused),
# sgmv_apply and mixed-recipe serving
# --------------------------------------------------------------------------

SIDE_FORMATS = ("rtn2", "rtn3", "rtn4", "binary")
# two of each premium recipe, the rest at the default 2@0.9: 3 layout buckets
MIXED_RECIPES = ("user_0=4@0.95", "user_1=4@0.95", "user_2=3@0.9",
                 "user_3=3@0.9")


def used_bytes(side, seg, binary):
    """Packed bytes of the adapters the tiles use (a binary side's
    zero-points are never read)."""
    return len(set(seg.tolist())) * side_bytes([t[0] for t in side], binary)


def phase_sgmv_kernels():
    """sgmv_rhs, sgmv_out and the single-side sgmv_fused against their plain
    versions; returns ``{(kernel, (k, m), fmt, phase): timings}`` (see
    :func:`timed`) and the max error per kernel."""
    import torch
    from repro_torch.kernels.quant_matmul import (
        sgmv_fused, sgmv_fused_ref, sgmv_out, sgmv_out_ref, sgmv_rhs,
        sgmv_rhs_ref)
    from repro_torch.launch.bench_kernels import (kernel_times, seg_for,
                                                  sgmv_sides)

    cases = [((k, m), fmt, phase, torch.bfloat16) for (k, m) in SHAPES
             for fmt in SIDE_FORMATS for phase in PHASES]
    cases += [((256, 200), fmt, phase, torch.float32)
              for fmt in SIDE_FORMATS for phase in PHASES]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2468)
    timings = {}
    max_err = {"sgmv_rhs": 0.0, "sgmv_out": 0.0, "sgmv_fused": 0.0}
    sides = {}
    for (k, m), fmt, phase, xdtype in cases:
        if ((k, m), fmt) not in sides:
            sides[(k, m), fmt] = sgmv_sides(k, m, fmt, seed=k + 7 * m)
        qas, qbs, a, b = sides[(k, m), fmt]
        binary = fmt == "binary"
        bits = qas[0].bits
        ga, gb = qas[0].group_size, qbs[0].group_size
        tile_t, rows = PHASES[phase]
        seg = seg_for(phase)
        x = torch.randn(rows, k, generator=gen, device="cuda").to(xdtype)
        kw = dict(bits=bits, binary=binary, group=ga, tile_t=tile_t)
        okw = dict(kw, group=gb, m=m)
        fkw = dict(bits_a=bits, binary_a=binary, group_a=ga, bits_b=bits,
                   binary_b=binary, group_b=gb, m=m, tile_t=tile_t)
        h = sgmv_rhs(x, *a, seg, **kw)
        y = sgmv_out(h, *b, seg, **okw)
        f = sgmv_fused(x, *a, *b, seg, **fkw)
        torch.cuda.synchronize()
        tag = f"K={k:5d} M={m:5d} {fmt:6s} {phase:7s} T={rows:3d}"
        if not torch.equal(h, sgmv_rhs(x, *a, seg, **kw)):
            raise AssertionError(f"sgmv_rhs {tag}: two launches differ")
        if not torch.equal(y, sgmv_out(h, *b, seg, **okw)):
            raise AssertionError(f"sgmv_out {tag}: two launches differ")
        errs = {
            "sgmv_rhs": check_close(f"sgmv_rhs {tag}", h,
                                    sgmv_rhs_ref(x, *a, seg, **kw)),
            "sgmv_out": check_close(f"sgmv_out {tag}", y,
                                    sgmv_out_ref(h, *b, seg, **okw)),
            "sgmv_fused": check_close(f"sgmv_fused 1-side {tag}", f,
                                      sgmv_fused_ref(x, *a, *b, seg, **fkw)),
        }
        rp = a[0].shape[1]
        a_bytes, b_bytes = used_bytes(a, seg, binary), used_bytes(b, seg,
                                                                 binary)
        h_bytes, y_bytes = rows * rp * 4, rows * m * 4
        bounds = {
            "sgmv_rhs": (x.nbytes + seg.nbytes + a_bytes + h_bytes,
                         2 * rows * rp * k),
            "sgmv_out": (h_bytes + seg.nbytes + b_bytes + y_bytes,
                         2 * rows * rp * m),
            "sgmv_fused": (x.nbytes + seg.nbytes + a_bytes + b_bytes
                           + y_bytes, 2 * rows * rp * (k + m)),
        }
        runs = {
            "sgmv_rhs": (sgmv_rhs, sgmv_rhs_ref, (x, *a, seg), kw),
            "sgmv_out": (sgmv_out, sgmv_out_ref, (h, *b, seg), okw),
            "sgmv_fused": (sgmv_fused, sgmv_fused_ref, (x, *a, *b, seg), fkw),
        }
        for name, (kern, plain, args, kwargs) in runs.items():
            max_err[name] = max(max_err[name], errs[name])
            nbytes, ops = bounds[name]
            timings[name, (k, m), fmt, phase] = timed(
                name, f"{tag} x={str(xdtype)[6:]:8s}", kern, args, kwargs,
                plain, nbytes / HBM_BYTES_PER_S * 1e3,
                ops / FP32_FLOPS_PER_S * 1e3, errs[name])

    # two-sided: an RTN-3 high side of rank 16 and a binary low side of
    # rank 8, at the widest-K shape
    k, m = 8192, 3072
    qa, qb = sgmv_sides(k, m, "rtn3", seed=5)[2:]
    la, lb = sgmv_sides(k, m, "binary", seed=6, r=8)[2:]
    for phase in PHASES:
        tile_t, rows = PHASES[phase]
        seg = seg_for(phase)
        x = torch.randn(rows, k, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        fkw = dict(bits_a=3, binary_a=False, group_a=128, bits_b=3,
                   binary_b=False, group_b=128, a_lo=la, b_lo=lb, bits_lo=1,
                   binary_lo=True, group_al=128, group_bl=128, m=m,
                   tile_t=tile_t)
        got = sgmv_fused(x, *qa, *qb, seg, **fkw)
        torch.cuda.synchronize()
        err = check_close(f"sgmv_fused hi 16 + lo 8 {phase}", got,
                          sgmv_fused_ref(x, *qa, *qb, seg, **fkw))
        max_err["sgmv_fused"] = max(max_err["sgmv_fused"], err)
        t = kernel_times(sgmv_fused, (x, *qa, *qb, seg), fkw)
        log(f"sgmv_fused K={k} M={m} hi rtn3 rank {qa[0].shape[1]} + lo "
            f"binary rank {la[0].shape[1]} {phase:7s} T={rows:3d} max|err|="
            f"{err:.2e}  kernel {t['ms']:.4f} ms (cold-L2 "
            f"{t['cold_ms']:.4f}, host {t['host_ms']:.4f} ms/call)")
    return timings, max_err


def sgmv_mix(timings, name, fmt="rtn2"):
    """Mean per launch of ``name`` over the serve's mix, as
    :func:`main_path_mix` weighs ``sgmv_fused``."""
    return main_path_mix({((k, m), phase): timings[name, (k, m), fmt, phase]
                          for (k, m) in SHAPES for phase in PHASES})


def phase_sgmv_apply():
    """``sgmv_apply`` fused and two-pass at every full-width shape, decode
    and prefill: per-call launch counts and outputs against ``ref_sgmv``.
    Returns the launch counts of the whole phase."""
    import torch
    from repro_torch.kernels.quant_matmul import (LAUNCH_COUNTS, ref,
                                                   reset_launch_counts,
                                                   sgmv_apply)
    from repro_torch.launch.bench_kernels import seg_for, sgmv_sides

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1357)
    total = {}
    for k, m in SHAPES:
        qas, qbs = sgmv_sides(k, m, "rtn2", seed=k + m + 1)[:2]
        for phase, (tile_t, rows) in PHASES.items():
            seg = seg_for(phase)
            seg_rows = seg.repeat_interleave(tile_t).tolist()
            x = torch.randn(rows, k, generator=gen, device="cuda")
            want = 2.0 * ref.ref_sgmv(x, qas, qbs, seg_rows)
            for fused, counts in ((True, {"sgmv_fused": 1}),
                                  (False, {"sgmv_rhs": 1, "sgmv_out": 1})):
                reset_launch_counts()
                y = sgmv_apply(x, qas, qbs, seg, scaling=2.0, tile_t=tile_t,
                               fused=fused)
                torch.cuda.synchronize()
                if dict(LAUNCH_COUNTS) != counts:
                    raise AssertionError(f"sgmv_apply(fused={fused}) K={k} "
                                         f"M={m} {phase} launched "
                                         f"{dict(LAUNCH_COUNTS)}, want "
                                         f"{counts}")
                for n, c in LAUNCH_COUNTS.items():
                    total[n] = total.get(n, 0) + c
                check_close(f"sgmv_apply(fused={fused}) K={k} M={m} {phase}",
                            y, want)
    log(f"sgmv_apply: {len(SHAPES)} shapes x (decode, prefill): fused=True "
        f"launched 1 sgmv_fused, fused=False 1 sgmv_rhs + 1 sgmv_out, each "
        f"call; all within {RTOL:g} x max|y| of ref_sgmv; phase counts "
        f"{total}")
    return total


def phase_mixed_parity(vocab):
    """Phase 12: the mixed-recipe fleet of phase 11 in fp32, served packed
    and materialized by the engine, and a control in which request r meets
    adapter r + 1 instead of r (mod 8)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import LoRAQuantConfig
    from repro_torch.kernels.quant_matmul import (LAUNCH_COUNTS,
                                                   reset_launch_counts)
    from repro_torch.launch.serve import (parse_recipe_override,
                                          random_trained_lora)
    from repro_torch.models import build_model
    from repro_torch.serving import AdapterStore, MultiLoRAEngine, Request

    cfg = dataclasses.replace(get_config("llama3.2-3b", "full"),
                              dtype=torch.float32)
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    store = AdapterStore(LoRAQuantConfig(rho=0.9, bits_high=2))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    store.register_many(
        {f"user_{i}": random_trained_lora(params["lora"], gen)
         for i in range(N_ADAPTERS)},
        recipes=dict(parse_recipe_override(r) for r in MIXED_RECIPES))
    engine = MultiLoRAEngine(model, params, store, cache_capacity=128)
    prompts = np.random.default_rng(0).integers(
        0, vocab, size=(N_REQ, PROMPT)).astype(np.int32)

    def run(mode, shift=0):
        for rid in range(N_REQ):
            engine.submit(Request(
                request_id=rid,
                adapter_id=f"user_{(rid + shift) % N_ADAPTERS}",
                prompt=prompts[rid], max_new_tokens=MAX_NEW,
                keep_logits=True))
        reset_launch_counts()
        done = engine.run(mode)
        torch.cuda.synchronize()
        check_outputs(done, vocab)
        return done, dict(LAUNCH_COUNTS)

    packed, counts = run("packed")
    want = {"sgmv_fused": 3 * LAYERS * len(LINEARS) * MAX_NEW}
    if counts != want:
        raise AssertionError(f"fp32 mixed packed run launched {counts}, "
                             f"want {want}")
    mat, counts = run("materialize")
    if counts:
        raise AssertionError(f"materialize launched kernels: {counts}")
    control, _ = run("packed", shift=1)
    diff = [r.request_id for r, q in zip(packed, mat)
            if r.output.tolist() != q.output.tolist()]
    if diff:
        raise AssertionError(f"fp32 mixed-recipe packed vs materialize "
                             f"tokens differ for requests {diff}")
    scale = max(float(abs(r.logits).max()) for r in packed)
    tol = LOGIT_RTOL * scale
    gap = logit_gap(packed, mat)
    if max(gap.values()) > tol:
        raise AssertionError(f"fp32 mixed-recipe logits differ by {gap} > "
                             f"{LOGIT_RTOL:g} x {scale:.3e}")
    moved = logit_gap(packed, control)
    if min(moved.values()) < CONTROL_MARGIN * tol:
        raise AssertionError(f"another adapter moves the logits by only "
                             f"{moved}, under {CONTROL_MARGIN} x {tol:.3e}: "
                             f"the parity check is blind")
    avg = {aid: round(st["avg_bits"], 4)
           for aid, st in sorted(store.adapter_stats().items())}
    log(f"mixed-recipe fp32 parity: packed == materialize for all {N_REQ} "
        f"requests ({N_REQ * MAX_NEW} tokens, {want['sgmv_fused']} "
        f"sgmv_fused launches in 3 buckets); logits max |diff| "
        f"{max(gap.values()):.3e} <= {tol:.3e} ({LOGIT_RTOL:g} x max|logit| "
        f"{scale:.3e}); every request meeting another adapter moves by "
        f"{min(moved.values()):.3e} to {max(moved.values()):.3e}; avg_bits "
        f"{avg}")
    del engine, store, model, params
    torch.cuda.empty_cache()
    return {"gap": max(gap.values()), "tol": tol,
            "control_min": min(moved.values())}


# --------------------------------------------------------------------------
# continuous serving over paged adapter memory (phases 13-15)
# --------------------------------------------------------------------------

CONT_ROWS = 8                 # decode rows of the continuous scheduler
CONT_SLOTS = 4                # the bounded slot pool: half the fleet
CACHE_CAPACITY = 128          # the serve driver's
# The reference engine's schedule and paging of the Zipf stream at
# CONT_ROWS rows and CONT_SLOTS slots (without EOS they depend on neither
# width nor depth); tests/test_torch_memory.py holds JAX's engine to them.
ZIPF_BOUNDED = {"hits": 9, "misses": 7, "evictions": 3, "swap_ins": 7,
                "decode_steps": 21, "admission_waves": 3}


def zipf_stream(vocab: int, n_adapters: int = N_ADAPTERS,
                n_req: int = N_REQ, prompt: int = PROMPT):
    """``benchmarks/bench_serving.py``'s churn stream: adapter ids drawn
    Zipf(α=1) over the fleet (``default_rng(17)``), prompts from
    ``default_rng(19)``."""
    import numpy as np

    pz = 1.0 / np.arange(1, n_adapters + 1)
    ids = [f"user_{i}" for i in np.random.default_rng(17).choice(
        n_adapters, size=n_req, p=pz / pz.sum())]
    rng = np.random.default_rng(19)
    return ids, [rng.integers(0, vocab, size=prompt).astype(np.int32)
                 for _ in ids]


def fleet(dtype, recipes=(), device="cuda", preset="full"):
    """llama3.2-3b with params from seed 0 and the serve driver's 8
    adapters (generator seed 1, default recipe ``2@0.9``, ``recipes``
    overrides), quantized once."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import LoRAQuantConfig
    from repro_torch.launch.serve import (parse_recipe_override,
                                          random_trained_lora)
    from repro_torch.models import build_model
    from repro_torch.serving import AdapterStore

    model = build_model(dataclasses.replace(
        get_config("llama3.2-3b", preset), dtype=dtype))
    params = model.init(seed=0, device=device)
    store = AdapterStore(LoRAQuantConfig(rho=0.9, bits_high=2))
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    store.register_many(
        {f"user_{i}": random_trained_lora(params["lora"], gen)
         for i in range(N_ADAPTERS)},
        recipes=dict(parse_recipe_override(r) for r in recipes))
    return model, params, store


def launch_counts(device):
    from repro_torch.kernels.quant_matmul import LAUNCH_COUNTS, PLAIN_CALLS

    return dict(LAUNCH_COUNTS if device == "cuda" else PLAIN_CALLS)


def sync(device):
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def count_forwards():
    """While active, every ``Model.prefill`` / ``decode_step`` appends the
    number of ``sgmv_fused`` launches per LoRA linear its params carry
    (one per bucket of a mixed tree, else one) to the yielded list."""
    from repro_torch.models.model import Model

    seen = []
    orig = {n: getattr(Model, n) for n in ("prefill", "decode_step")}

    def wrap(fn):
        def call(self, params, *a, **kw):
            leaf = params["lora"]["groups"][0]["sub_0"]["mixer"]["wq"]
            seen.append(len(getattr(leaf, "buckets", (leaf,))))
            return fn(self, params, *a, **kw)
        return call

    for n, fn in orig.items():
        setattr(Model, n, wrap(fn))
    try:
        yield seen
    finally:
        for n, fn in orig.items():
            setattr(Model, n, fn)


def run_stream(model, params, store, ids, prompts, vocab, *, slots=None,
               mode="continuous", keep_logits=False, shift=0,
               device="cuda", profile=False, telemetry=None):
    """Serve the stream through ``MultiLoRAEngine`` (``CONT_ROWS`` rows,
    ``slots`` device slots, ``telemetry`` if given); request r meets
    adapter ``ids[r] + shift``. Checks the outputs and that the kernel
    launches are exactly one ``sgmv_fused`` per LoRA linear per bucket per
    forward (none for ``materialize``). Returns the requests in id order
    and the run's numbers (continuous mode: each engine step's host time,
    which ends in the step's host synchronization)."""
    from repro_torch.kernels.quant_matmul import reset_launch_counts
    from repro_torch.serving import MultiLoRAEngine, Request

    engine = MultiLoRAEngine(model, params, store,
                             cache_capacity=CACHE_CAPACITY, mode=mode,
                             max_rows=CONT_ROWS, hbm_slots=slots,
                             telemetry=telemetry)
    for rid, (aid, p) in enumerate(zip(ids, prompts)):
        aid = f"user_{(int(aid.split('_')[1]) + shift) % N_ADAPTERS}"
        engine.submit(Request(request_id=rid, adapter_id=aid, prompt=p,
                              max_new_tokens=MAX_NEW,
                              keep_logits=keep_logits))
    prof = (profiled_call(type(engine), "step") if profile
            else contextlib.nullcontext({}))
    sync(device)
    reset_launch_counts()
    step_s = []
    with count_forwards() as forwards, prof as window:
        t0 = time.perf_counter()
        if mode == "continuous":
            done = []
            while engine.pending or engine.active_rows:
                t = time.perf_counter()
                done += engine.step()
                step_s.append(time.perf_counter() - t)
        else:
            done = engine.run()
        sync(device)
        dt = time.perf_counter() - t0
    counts = launch_counts(device)
    check_outputs(done, vocab)
    st = engine.stats()
    want = ({} if mode == "materialize" else
            {"sgmv_fused": LAYERS_OF[device] * len(LINEARS) * sum(forwards)})
    if counts != want:
        raise AssertionError(f"{mode} serve (slots {slots}) launched "
                             f"{counts}, want {want} ({len(forwards)} "
                             f"forwards over {forwards} buckets)")
    if mode != "materialize" and len(forwards) != (
            st["decode_steps"] + st["admission_waves"]):
        raise AssertionError(f"{len(forwards)} forwards, the engine counts "
                             f"{st}")
    return sorted(done, key=lambda r: r.request_id), {
        "s": dt, "tok_s": sum(len(r.output) for r in done) / dt,
        "counts": counts, "forwards": forwards, "engine": engine,
        "stats": st, "window": window, "step_s": step_s}


LAYERS_OF = {"cuda": LAYERS, "cpu": 2}     # full width; the smoke rehearsal


def same_tokens(a, b, what):
    diff = [r.request_id for r, q in zip(a, b)
            if r.output.tolist() != q.output.tolist()]
    if diff:
        raise AssertionError(f"{what}: tokens differ for requests {diff}")


def phase_continuous(vocab, device="cuda", preset="full"):
    """Phases 13 and 14: the uniform ``2@0.9`` fleet served continuously,
    all-resident and bounded, in bf16; then the bounded serve in fp32
    against materialize, with a shifted-adapter control."""
    import torch

    ids, prompts = zipf_stream(vocab)
    t0 = time.perf_counter()
    model, params, store = fleet(torch.bfloat16, device=device,
                                 preset=preset)
    sync(device)
    log(f"continuous phase: bf16 model and 8 adapters in "
        f"{time.perf_counter() - t0:.1f}s; stream {ids}")
    resident, r_res = run_stream(model, params, store, ids, prompts, vocab,
                                 device=device)
    bounded, r_bnd = run_stream(model, params, store, ids, prompts, vocab,
                                slots=CONT_SLOTS, device=device)
    same_tokens(resident, bounded, "bounded vs all-resident continuous")
    eng = r_bnd["engine"]
    mem = eng.memory_stats()
    got = {k: mem[k] for k in ("hits", "misses", "evictions", "swap_ins")}
    got.update({k: r_bnd["stats"][k]
                for k in ("decode_steps", "admission_waves")})
    if got != ZIPF_BOUNDED:
        raise AssertionError(f"bounded paging {got}, the reference's "
                             f"{ZIPF_BOUNDED}")
    page = eng.memory.page_bytes
    if eng.memory.hbm_bytes() != CONT_SLOTS * page or mem["slots"] != 4:
        raise AssertionError(f"bounded pool holds {eng.memory.hbm_bytes()} "
                             f"bytes, want {CONT_SLOTS} x {page}")
    rmem = r_res["engine"].memory_stats()
    for name, r, m in (("all-resident", r_res, rmem),
                       ("bounded", r_bnd, mem)):
        log(f"continuous bf16 {name}: {r['tok_s']:.1f} tokens/s "
            f"({N_REQ * MAX_NEW} tokens in {r['s']:.3f}s, "
            f"{r['stats']['admission_waves']} prefill groups + "
            f"{r['stats']['decode_steps']} decode steps, "
            f"{r['counts']['sgmv_fused']} sgmv_fused launches); "
            f"{m['slots']} slots, pool {m['hbm_slot_mb'] * 1e6:.0f} bytes "
            f"(page {page} bytes), host tier "
            f"{m['host_tier_mb'] * 1e6:.0f} bytes; hits {m['hits']}, "
            f"misses {m['misses']}, evictions {m['evictions']}, swap-ins "
            f"{m['swap_ins']} ({m['swap_in_bytes']} bytes), prefetch "
            f"{m['prefetch']}")
    del r_res, resident
    res = {"launches": r_bnd["counts"]["sgmv_fused"], "page": page}
    if device == "cuda":
        _, r_prof = run_stream(model, params, store, ids, prompts, vocab,
                               slots=CONT_SLOTS, device=device, profile=True)
        log(window_line("continuous bounded serve", r_prof["window"],
                        "engine-step"))
        del r_prof
    del model, params, eng, r_bnd, bounded
    if device == "cuda":
        torch.cuda.empty_cache()

    # ---- 14. fp32: bounded continuous == materialize ---------------------
    # the same quantized store: the adapters come from their own generator
    # over the fp32 LoRA template, whatever the base dtype
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    model = build_model(dataclasses.replace(
        get_config("llama3.2-3b", preset), dtype=torch.float32))
    params = model.init(seed=0, device=device)
    runs = {}
    for name, mode, slots, shift in (("continuous", "continuous",
                                      CONT_SLOTS, 0),
                                     ("materialize", "materialize", None, 0),
                                     ("control", "continuous",
                                      CONT_SLOTS, 1)):
        runs[name] = run_stream(model, params, store, ids, prompts, vocab,
                                slots=slots, mode=mode, keep_logits=True,
                                shift=shift, device=device)[0]
    same_tokens(runs["continuous"], runs["materialize"],
                "fp32 continuous vs materialize")
    scale = max(float(abs(r.logits).max()) for r in runs["continuous"])
    tol = LOGIT_RTOL * scale
    gap = logit_gap(runs["continuous"], runs["materialize"])
    if max(gap.values()) > tol:
        raise AssertionError(f"fp32 continuous vs materialize logits differ "
                             f"by {gap} > {LOGIT_RTOL:g} x {scale:.3e}")
    moved = logit_gap(runs["continuous"], runs["control"])
    if min(moved.values()) < CONTROL_MARGIN * tol:
        raise AssertionError(f"another adapter moves the logits by only "
                             f"{moved}, under {CONTROL_MARGIN} x {tol:.3e}: "
                             f"the parity check is blind")
    log(f"continuous fp32 parity {time.perf_counter() - t0:.1f}s: bounded "
        f"({CONT_SLOTS} slots) continuous == materialize for all {N_REQ} "
        f"requests ({N_REQ * MAX_NEW} tokens); logits max |diff| "
        f"{max(gap.values()):.3e} <= {tol:.3e} ({LOGIT_RTOL:g} x "
        f"max|logit| {scale:.3e}); every request meeting another adapter "
        f"moves by {min(moved.values()):.3e} to {max(moved.values()):.3e}")
    res.update(gap=max(gap.values()), tol=tol)
    del model, params, store, runs
    if device == "cuda":
        torch.cuda.empty_cache()
    return res


def phase_mixed_continuous(vocab, device="cuda", preset="full"):
    """Phase 15: phase 11's three-recipe fleet served continuously under a
    device budget of half the fleet's summed page bytes. In bf16 the
    budgeted serve runs twice (the second profiled) and must repeat its
    tokens and paging; in fp32 it must give the all-resident serve's
    tokens and logits. (A budget changes which requests share a prefill
    group, and bf16 logits then round differently: the bf16 tokens of the
    two serves may part at a near-tie, so bf16 only reports them.)"""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import AdapterMemoryManager
    from repro_torch.serving import memory as memory_mod

    ids, prompts = zipf_stream(vocab)
    t0 = time.perf_counter()
    model, params, store = fleet(torch.bfloat16, MIXED_RECIPES,
                                 device=device, preset=preset)
    probe = AdapterMemoryManager(store, params["lora"], device=device)
    pages = {aid: probe.page_bytes_of(aid) for aid in store.quantized}
    budget = sum(pages.values()) // 2
    del probe
    log(f"mixed continuous phase: model and 8 adapters in "
        f"{time.perf_counter() - t0:.1f}s; page bytes "
        f"{sorted(set(pages.values()))}, budget {budget} bytes")
    reclaims = []
    orig = memory_mod.AdapterMemoryManager._reclaim

    def counted(self, sig):
        reclaims.append(sig)
        return orig(self, sig)

    def serve_budgeted(**kw):
        store.hbm_budget_bytes = budget
        memory_mod.AdapterMemoryManager._reclaim = counted
        try:
            return run_stream(model, params, store, ids, prompts, vocab,
                              device=device, **kw)
        finally:
            memory_mod.AdapterMemoryManager._reclaim = orig
            store.hbm_budget_bytes = None

    def check_budgeted(r, what):
        mem = r["engine"].memory_stats()
        hbm = r["engine"].memory.hbm_bytes()
        if max(r["forwards"]) < 2 or mem["pools"] < 2:
            raise AssertionError(f"{what}: at most {max(r['forwards'])} "
                                 f"live pools")
        if mem["evictions"] == 0 or hbm > budget:
            raise AssertionError(f"{what}: {mem['evictions']} evictions, "
                                 f"{hbm} bytes against budget {budget}")
        return mem

    resident, r_res = run_stream(model, params, store, ids, prompts, vocab,
                                 device=device)
    bounded, r_bnd = serve_budgeted()
    mem = check_budgeted(r_bnd, "bf16 budgeted mixed serve")
    n_reclaims = len(reclaims)
    again, r_again = serve_budgeted(profile=device == "cuda")
    same_tokens(bounded, again, "bf16 budgeted mixed serve, two runs")
    if r_again["engine"].memory_stats() != mem:
        raise AssertionError("bf16 budgeted mixed serve: the second run "
                             "paged differently")
    parted = [r.request_id for r, q in zip(resident, bounded)
              if r.output.tolist() != q.output.tolist()]
    rmem = r_res["engine"].memory_stats()
    for name, r, m in (("all-resident", r_res, rmem),
                       ("budgeted", r_bnd, mem)):
        log(f"mixed continuous bf16 {name}: {r['tok_s']:.1f} tokens/s "
            f"({r['s']:.3f}s, {r['stats']['admission_waves']} prefill "
            f"groups + {r['stats']['decode_steps']} decode steps, "
            f"{r['counts']['sgmv_fused']} sgmv_fused launches over "
            f"{sum(r['forwards'])} bucket-forwards); {m['pools']} pools, "
            f"{m['slots']} slots, {m['hbm_slot_mb'] * 1e6:.0f} bytes; hits "
            f"{m['hits']}, misses {m['misses']}, evictions "
            f"{m['evictions']}, swap-ins {m['swap_ins']}; per pool "
            + ", ".join(f"{k}: {v['capacity']} slots, {v['evictions']} "
                        f"evictions" for k, v in sorted(
                            m["per_pool"].items())))
    log(f"mixed continuous bf16: _reclaim ran {n_reclaims} times; the "
        f"second budgeted run repeats tokens and paging; requests whose "
        f"bf16 tokens part from the all-resident serve's: {parted}")
    if device == "cuda":
        log(window_line("mixed continuous budgeted serve",
                        r_again["window"], "engine-step"))
    res = {"launches": r_bnd["counts"]["sgmv_fused"],
           "reclaims": n_reclaims, "budget": budget}
    del model, params, r_res, r_bnd, r_again, resident, bounded, again
    if device == "cuda":
        torch.cuda.empty_cache()

    # fp32: the budgeted serve gives the all-resident serve's tokens and
    # logits (the same quantized store; the adapters do not depend on the
    # base dtype)
    t0 = time.perf_counter()
    model = build_model(dataclasses.replace(
        get_config("llama3.2-3b", preset), dtype=torch.float32))
    params = model.init(seed=0, device=device)
    resident, _ = run_stream(model, params, store, ids, prompts, vocab,
                             keep_logits=True, device=device)
    bounded, r_bnd = serve_budgeted(keep_logits=True)
    check_budgeted(r_bnd, "fp32 budgeted mixed serve")
    same_tokens(resident, bounded, "fp32 budgeted vs all-resident mixed")
    scale = max(float(abs(r.logits).max()) for r in resident)
    tol = LOGIT_RTOL * scale
    gap = logit_gap(bounded, resident)
    if max(gap.values()) > tol:
        raise AssertionError(f"fp32 budgeted vs all-resident logits differ "
                             f"by {gap} > {LOGIT_RTOL:g} x {scale:.3e}")
    log(f"mixed continuous fp32 {time.perf_counter() - t0:.1f}s: budgeted "
        f"== all-resident tokens for all {N_REQ} requests; logits max "
        f"|diff| {max(gap.values()):.3e} <= {tol:.3e} ({LOGIT_RTOL:g} x "
        f"max|logit| {scale:.3e}); {r_bnd['counts']['sgmv_fused']} "
        f"sgmv_fused launches over {sum(r_bnd['forwards'])} "
        f"bucket-forwards")
    res.update(gap=max(gap.values()), tol=tol, parted_bf16=parted)
    del model, params, store, resident, bounded, r_bnd
    if device == "cuda":
        torch.cuda.empty_cache()
    return res


# --------------------------------------------------------------------------
# faults and telemetry on the continuous path (phases 16-17)
# --------------------------------------------------------------------------

# benchmarks/bench_chaos.py's storm, unchanged: 6 adapters 2@0.9, 12
# requests with a generous total deadline plus one with an impossible TTFT
# budget, 3 rows over 3 device slots, an all-pinned episode at step 3 for
# 2 steps, virtual time (a ManualClock advanced STEP_S per step and by the
# transport's injected sleeps)
CHAOS_ADAPTERS = 6
CHAOS_REQUESTS = 12
CHAOS_PROMPT = 8
CHAOS_NEW = 4
CHAOS_SLOTS = 3
CHAOS_ROWS = 3
CHAOS_BAD = "user_1"          # the storm corrupts this adapter's pages
CHAOS_DEADLINE_MS = 120_000.0
CHAOS_PIN_AT, CHAOS_PIN_STEPS = 3, 2
CHAOS_STEP_CAP = 500          # deadlock tripwire
CHAOS_STEP_S = 0.05           # virtual seconds of compute per step
CHAOS_CAPACITY = 64
GOODPUT_BOUND = 0.5           # storm goodput >= bound x baseline goodput
# The reference engine's run of that stream (statuses, injected faults,
# transport, paging, schedule, virtual time): without EOS it depends on
# neither width nor depth nor the codes; tests/test_torch_faults.py holds
# JAX's bench_chaos run to it.
CHAOS_STORM = {
    "baseline": {
        "statuses": ["done"] * 12 + ["timed_out"],
        "faults": {},
        "transport": {"reads": 6, "retries": 0, "timeouts": 0, "failures": 0},
        "paging": {"hits": 6, "misses": 6, "evictions": 3, "swap_ins": 6,
                   "stale_serves": 0, "poisoned": 0,
                   "prefetch": {"hit": 9, "staged": 0, "failed": 0,
                                "no_slot": 18}},
        "schedule": {"steps": 12, "decode_steps": 12, "admission_waves": 4,
                     "recovery_steps": 1},
        "wall": 0.6},
    "storm": {
        "statuses": ["done", "failed", "done", "done", "done", "done",
                     "done", "failed", "done", "done", "done", "done",
                     "timed_out"],
        "faults": {"read_latency": 3, "read_fail_transient": 2,
                   "page_corruption": 1},
        "transport": {"reads": 6, "retries": 2, "timeouts": 0, "failures": 0},
        "paging": {"hits": 5, "misses": 6, "evictions": 2, "swap_ins": 5,
                   "stale_serves": 0, "poisoned": 0,
                   "prefetch": {"hit": 6, "staged": 0, "failed": 0,
                                "no_slot": 12}},
        "schedule": {"steps": 12, "decode_steps": 12, "admission_waves": 4,
                     "recovery_steps": 1},
        "wall": 0.6110000000000001},
}


def chaos_plan():
    from repro_torch.serving import FaultPlan

    return FaultPlan(seed=29, read_latency_s=0.003, read_latency_prob=0.3,
                     transient_fail_prob=0.3,
                     corrupt_adapters=frozenset({CHAOS_BAD}))


def chaos_requests(vocab: int):
    """bench_chaos's stream: prompts from ``default_rng(23)``."""
    import numpy as np
    from repro_torch.serving import Request

    rng = np.random.default_rng(23)
    reqs = [Request(request_id=rid, adapter_id=f"user_{rid % CHAOS_ADAPTERS}",
                    prompt=rng.integers(0, vocab, size=CHAOS_PROMPT
                                        ).astype(np.int32),
                    max_new_tokens=CHAOS_NEW, deadline_ms=CHAOS_DEADLINE_MS)
            for rid in range(CHAOS_REQUESTS)]
    reqs.append(Request(request_id=CHAOS_REQUESTS, adapter_id="user_0",
                        prompt=rng.integers(0, vocab, size=CHAOS_PROMPT
                                            ).astype(np.int32),
                        max_new_tokens=CHAOS_NEW, ttft_deadline_ms=1e-3))
    return reqs


def chaos_drive(model, params, store, vocab, faults, device="cuda"):
    """One bench_chaos run on the port: submit the stream, step to the end
    with the all-pinned episode, on a ManualClock shared by the engine and
    the transport (``HostTransport(max_retries=6, sleep=clock.sleep)``).
    Returns the requests, the schedule, virtual time and step latencies,
    the paging and transport stats, and the real wall time."""
    import numpy as np
    from repro_torch.serving import (HostTransport, ManualClock,
                                     MultiLoRAEngine, RequestStatus)

    clock = ManualClock()
    transport = (HostTransport(faults=faults, max_retries=6,
                               sleep=clock.sleep)
                 if faults is not None else None)
    eng = MultiLoRAEngine(model, params, store,
                          cache_capacity=CHAOS_CAPACITY, max_rows=CHAOS_ROWS,
                          hbm_slots=CHAOS_SLOTS, faults=faults,
                          transport=transport, clock=clock)
    reqs = chaos_requests(vocab)
    for r in reqs:
        eng.submit(r)
    mgr = eng.memory
    lats, done, steps = [], [], 0
    pinned, episode_end, recovery = [], None, None
    sync(device)
    t_wall = time.perf_counter()
    while eng.pending or eng.active_rows or eng._terminated:
        if steps == CHAOS_PIN_AT:               # pin every slot externally
            pinned = list(mgr._where)
            for aid in pinned:
                mgr.pin(aid)
        if steps == CHAOS_PIN_AT + CHAOS_PIN_STEPS and pinned:
            for aid in pinned:
                mgr.unpin(aid)
            pinned, episode_end = [], steps
        ts = clock()
        fin = eng.step()                        # injected sleeps advance it
        clock.advance(CHAOS_STEP_S)
        lats.append(clock() - ts)
        done += fin
        steps += 1
        if (episode_end is not None and recovery is None
                and any(r.status is RequestStatus.DONE for r in fin)):
            recovery = steps - episode_end
        if steps >= CHAOS_STEP_CAP:
            break
    sync(device)
    return {"reqs": reqs, "done": done, "steps": steps, "wall": clock(),
            "lats": np.asarray(lats), "recovery_steps": recovery,
            "mem": eng.memory_stats(), "stats": eng.stats(), "eng": eng,
            "transport": mgr.transport.stats(),
            "real_s": time.perf_counter() - t_wall}


def chaos_goodput(run) -> float:
    """Tokens of DONE requests per virtual second."""
    from repro_torch.serving import RequestStatus

    return sum(len(r.output) for r in run["reqs"]
               if r.status is RequestStatus.DONE) / run["wall"]


def chaos_checks(base, storm) -> dict:
    """bench_chaos's four checks; raises on any failure. ``RequestStatus``
    is compared by value so a reference run checks the same way."""
    parity, statuses = True, True
    by_id = {r.request_id: r for r in base["reqs"]}
    for r in storm["reqs"]:
        b = by_id[r.request_id]
        if r.adapter_id == CHAOS_BAD:
            statuses &= (r.status.value == "failed"
                         and r.error.kind == "poisoned_adapter"
                         and b.status.value == "done")
        elif r.ttft_deadline_ms is not None:
            statuses &= (r.status.value == "timed_out"
                         and b.status.value == "timed_out")
        else:
            statuses &= r.status.value == "done" and b.status.value == "done"
            parity &= r.output.tolist() == b.output.tolist()
    no_deadlock = (base["steps"] < CHAOS_STEP_CAP
                   and storm["steps"] < CHAOS_STEP_CAP
                   and not storm["eng"].pending
                   and storm["eng"].active_rows == 0)
    goodput = chaos_goodput(storm) >= GOODPUT_BOUND * chaos_goodput(base)
    checks = {"healthy_token_parity": parity, "statuses_correct": statuses,
              "no_deadlock": no_deadlock, "goodput_within_bound": goodput}
    if not all(checks.values()):
        raise AssertionError(f"chaos checks failed: {checks}")
    return checks


def chaos_summary(run, plan) -> dict:
    """What ``CHAOS_STORM`` holds of one run: statuses, the plan's injected
    faults, the transport's stats, paging, schedule and virtual time."""
    mem = run["mem"]
    return {
        "statuses": [r.status.value for r in run["reqs"]],
        "faults": plan.stats() if plan is not None else {},
        "transport": dict(run["transport"]),
        "paging": {k: mem[k] for k in ("hits", "misses", "evictions",
                                       "swap_ins", "stale_serves",
                                       "poisoned", "prefetch")},
        "schedule": {"steps": run["steps"],
                     "decode_steps": run["stats"]["decode_steps"],
                     "admission_waves": run["stats"]["admission_waves"],
                     "recovery_steps": run["recovery_steps"]},
        "wall": run["wall"],
    }


def chaos_fleet(device="cuda", preset="full"):
    """llama3.2-3b in fp32 (params from seed 0) and bench_chaos's 6
    adapters ``2@0.9`` (generator seed 40, scale 0.05), quantized once."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import LoRAQuantConfig
    from repro_torch.launch.serve import random_trained_lora
    from repro_torch.models import build_model
    from repro_torch.serving import AdapterStore

    model = build_model(dataclasses.replace(
        get_config("llama3.2-3b", preset), dtype=torch.float32))
    params = model.init(seed=0, device=device)
    store = AdapterStore(LoRAQuantConfig(rho=0.9, bits_high=2))
    gen = torch.Generator(device=device)
    gen.manual_seed(40)
    store.register_many({
        f"user_{i}": random_trained_lora(params["lora"], gen, scale=0.05)
        for i in range(CHAOS_ADAPTERS)})
    return model, params, store


def phase_chaos(vocab, device="cuda", preset="full"):
    """Phase 16: bench_chaos's storm and its fault-free baseline at full
    width in fp32: healthy tokens identical, exact statuses, no deadlock,
    goodput within ``GOODPUT_BOUND``, the reference's run
    (``CHAOS_STORM``), and exactly one ``sgmv_fused`` per LoRA linear per
    live pool per forward."""
    import numpy as np
    from repro_torch.kernels.quant_matmul import reset_launch_counts

    t0 = time.perf_counter()
    model, params, store = chaos_fleet(device, preset)
    sync(device)
    log(f"chaos phase: fp32 model and {CHAOS_ADAPTERS} adapters in "
        f"{time.perf_counter() - t0:.1f}s")
    runs, plan = {}, None
    for name in ("baseline", "storm"):
        plan = chaos_plan() if name == "storm" else None
        reset_launch_counts()
        with count_forwards() as forwards:
            run = chaos_drive(model, params, store, vocab, plan, device)
        counts = launch_counts(device)
        want = {"sgmv_fused": LAYERS_OF[device] * len(LINEARS)
                * sum(forwards)}
        st = run["stats"]
        if counts != want or len(forwards) != (st["decode_steps"]
                                               + st["admission_waves"]):
            raise AssertionError(f"chaos {name}: launched {counts} over "
                                 f"{len(forwards)} forwards, want {want}; "
                                 f"engine {st}")
        run.update(counts=counts, summary=chaos_summary(run, plan))
        runs[name] = run
    checks = chaos_checks(runs["baseline"], runs["storm"])
    got = {name: runs[name]["summary"] for name in runs}
    if got != CHAOS_STORM:
        raise AssertionError(f"chaos runs {got}, the reference's "
                             f"{CHAOS_STORM}")
    for name, run in runs.items():
        toks = sum(len(r.output) for r in run["reqs"]
                   if r.status.value == "done")
        log(f"chaos {name}: {run['steps']} steps "
            f"({run['stats']['admission_waves']} prefill groups + "
            f"{run['stats']['decode_steps']} decode steps, "
            f"{run['counts']['sgmv_fused']} sgmv_fused launches); virtual "
            f"goodput {chaos_goodput(run):.3f} tokens/s, p99 step "
            f"{float(np.percentile(run['lats'], 99)) * 1e3:.1f} ms "
            f"(virtual); real wall {run['real_s']:.3f}s, "
            f"{toks / run['real_s']:.1f} tokens/s; statuses "
            f"{run['summary']['statuses']}; transport {run['transport']}")
    log(f"chaos storm: injected {plan.stats()}; recovery "
        f"{runs['storm']['recovery_steps']} steps after the all-pinned "
        f"episode; checks {checks}; the run equals CHAOS_STORM")
    res = {"launches": runs["storm"]["counts"]["sgmv_fused"],
           "tok_s": {name: sum(len(r.output) for r in run["reqs"]
                               if r.status.value == "done") / run["real_s"]
                     for name, run in runs.items()}}
    del model, params, store, runs
    if device == "cuda":
        import torch

        torch.cuda.empty_cache()
    return res


def check_exports(tel, tmp: Path) -> dict:
    """Write the three exports of ``tel`` under ``tmp`` and parse them:
    Prometheus text (every sample line ``name value``), Chrome-trace JSON
    with spans of non-negative time, JSONL of one object per event."""
    paths = {"metrics": tmp / "metrics.prom", "trace": tmp / "trace.json",
             "events": tmp / "events.jsonl"}
    tel.write_prometheus(str(paths["metrics"]))
    tel.write_chrome_trace(str(paths["trace"]))
    tel.write_jsonl(str(paths["events"]))
    return parse_exports(paths)


def parse_exports(paths) -> dict:
    samples = 0
    for line in paths["metrics"].read_text().strip().splitlines():
        if not line.startswith("#"):
            _, value = line.rsplit(" ", 1)
            float(value)
            samples += 1
    doc = json.loads(paths["trace"].read_text())
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    if not spans or any(e["dur"] < 0 or e["ts"] < 0 for e in spans):
        raise AssertionError("chrome trace: no spans or a negative span")
    events = [json.loads(line)
              for line in paths["events"].read_text().splitlines()]
    if samples == 0 or not events:
        raise AssertionError(f"exports: {samples} samples, "
                             f"{len(events)} events")
    return {"samples": samples, "spans": len(spans), "events": events}


def check_lifecycles(events, n_req: int):
    """Every request has submit → admit → first_token → retire, in that
    order, and every event has exactly its ``EVENT_SCHEMA`` fields."""
    from repro_torch.serving.telemetry import EVENT_SCHEMA

    seqs = {}
    for ev in events:
        fields = set(ev) - {"ts", "event"}
        if set(EVENT_SCHEMA[ev["event"]]) != fields:
            raise AssertionError(f"event {ev} breaks EVENT_SCHEMA")
        if "request_id" in ev:
            seqs.setdefault(ev["request_id"], []).append(ev["event"])
    want = ["submit", "admit", "first_token", "retire"]
    bad = {rid: seq for rid, seq in seqs.items() if seq != want}
    if bad or len(seqs) != n_req:
        raise AssertionError(f"request lifecycles {bad or seqs}")


def pct_ms(values) -> dict:
    """p50 / p99 in ms of a list of seconds (numpy's linear percentiles:
    exact, where the registry's histograms interpolate in buckets)."""
    import numpy as np

    return {q: float(np.percentile(values, int(q[1:]))) * 1e3
            for q in ("p50", "p99")}


def phase_telemetry(vocab, device="cuda", preset="full"):
    """Phase 17: phase 13's bounded bf16 serve without and with
    ``Telemetry()`` on the real clock, in the order off, on, on, off
    (identical tokens and launches; each registry's launch series equals
    its run's launches; every request's lifecycle logged; the three
    exports parse; latencies and engine steps reported per condition, and
    the launch sink's host cost per call), then the serve driver at full
    width with every fault and telemetry flag."""
    import io
    import tempfile

    import torch
    from repro_torch.launch import serve as serve_mod
    from repro_torch.serving import Telemetry

    ids, prompts = zipf_stream(vocab)
    model, params, store = fleet(torch.bfloat16, device=device,
                                 preset=preset)
    order = ("off", "on", "on", "off")
    runs = {"off": [], "on": []}
    first = None
    for cond in order:
        tel = Telemetry() if cond == "on" else None
        try:
            done, r = run_stream(model, params, store, ids, prompts, vocab,
                                 slots=CONT_SLOTS, device=device,
                                 telemetry=tel)
        finally:
            if tel is not None:
                tel.uninstall_kernel_counter()
        if first is None:
            first = (done, r["counts"])
        same_tokens(first[0], done, f"telemetry {cond} vs off")
        series = (tel.registry.value("pallas_launches_total",
                                     kernel="sgmv_fused")
                  if tel is not None else r["counts"]["sgmv_fused"])
        if r["counts"] != first[1] or series != r["counts"]["sgmv_fused"] \
                or (tel is not None and len(tel.registry.series(
                    "pallas_launches_total")) != 1):
            raise AssertionError(f"launches {r['counts']} ({cond}), first "
                                 f"run {first[1]}, registry {series}")
        runs[cond].append({"tel": tel, "step_s": r["step_s"],
                           "tok_s": r["tok_s"]})
        del done, r
    tel = runs["on"][0]["tel"]
    with tempfile.TemporaryDirectory() as tmp:
        parsed = check_exports(tel, Path(tmp))
    check_lifecycles(parsed["events"], N_REQ)
    traces = [tr for run in runs["on"] for tr in run["tel"].traces.values()]
    lat = {name: pct_ms([getattr(tr, f"{name}_s") for tr in traces])
           for name in ("ttft", "e2e", "queue_wait")}
    for cond, rs in runs.items():
        lat[f"step_{cond}"] = pct_ms([t for run in rs for t in run["step_s"]])
    probe = Telemetry()                 # the sink's own host cost per call
    probe.install_kernel_counter()
    n = 20000
    t0 = time.perf_counter()
    for _ in range(n):
        probe._kernel_sink("sgmv_fused")
    sink_us = (time.perf_counter() - t0) / n * 1e6
    probe.uninstall_kernel_counter()
    log(f"telemetry serve (bf16, {CONT_SLOTS} slots), off, on, on, off: "
        f"tokens and launches identical ({first[1]} per run); "
        f"pallas_launches_total{{kernel=\"sgmv_fused\"}} "
        f"{first[1]['sgmv_fused']} in each on run; exports parse "
        f"({parsed['samples']} samples, {parsed['spans']} spans, "
        f"{len(parsed['events'])} events)")
    log("telemetry latencies (ms; requests of both on runs, the engine "
        "steps of both runs per condition): "
        + "; ".join(f"{k} p50 {v['p50']:.2f} / p99 {v['p99']:.2f}"
                    for k, v in lat.items()))
    seq = [(cond, runs[cond][order[:i].count(cond)])
           for i, cond in enumerate(order)]
    log("telemetry host cost, in run order: tokens/s "
        + ", ".join(f"{cond} {run['tok_s']:.1f}" for cond, run in seq)
        + "; median engine step "
        + ", ".join(f"{cond} {pct_ms(run['step_s'])['p50']:.2f} ms"
                    for cond, run in seq)
        + f"; the launch sink {sink_us:.2f} us per call")
    res = {"launches": first[1]["sgmv_fused"], "lat": lat,
           "sink_us": sink_us}
    del model, params, store, runs, seq, first, tel, traces
    if device == "cuda":
        torch.cuda.empty_cache()

    # the serve driver with every fault and telemetry flag
    with tempfile.TemporaryDirectory() as tmp:
        paths = {"metrics": Path(tmp) / "metrics.prom",
                 "trace": Path(tmp) / "trace.json",
                 "events": Path(tmp) / "events.jsonl"}
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            done = serve_mod.main([
                "--arch", "llama3.2-3b", "--preset", preset,
                "--device", device, "--inject", "storm",
                "--queue-limit", "12", "--queue-policy", "shed_oldest",
                "--deadline-ms", "600000", "--stats-every", "4",
                "--metrics-out", str(paths["metrics"]),
                "--trace-out", str(paths["trace"]),
                "--events-out", str(paths["events"])])
        parsed = parse_exports(paths)
    text = out.getvalue()
    for line in text.splitlines():
        log(f"  {line}")
    if "[serve] quarantined adapters: ['user_1']" not in text:
        raise AssertionError("the serve driver did not quarantine user_1")
    bad = {r.request_id: r.status.value for r in done
           if (r.adapter_id == "user_1") != (r.status.value == "failed")}
    if bad:
        raise AssertionError(f"serve driver statuses {bad}")
    log(f"serve driver with --inject storm: {len(done)} requests, exports "
        f"parse ({parsed['samples']} samples, {parsed['spans']} spans, "
        f"{len(parsed['events'])} events)")
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script drives the "
              "port on an NVIDIA GPU", file=sys.stderr)
        return 2
    t_start = time.perf_counter()

    # ---- 1. environment and build ----------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    log(f"card: {smi}")
    from repro_torch.kernels.quant_matmul import build, kernel

    t0 = time.perf_counter()
    lib_path, built = build.build_library()
    build.load_library()
    if built:
        log(f"built {lib_path.name} with nvcc in "
            f"{time.perf_counter() - t0:.2f}s")
    else:
        log(f"{lib_path.name} cached from an earlier build of this source")
    report = build.ptxas_report(build.BUILD_LOG)
    for line in report:
        log(f"  ptxas: {line}")
    for name in KERNELS:                      # every kernel, in every form
        forms = sum(f"{name}_kernel" in line for line in report)
        if built and forms < len(kernel.TILE_ROWS):
            raise AssertionError(f"ptxas reports {forms} forms of "
                                 f"{name}_kernel, want one per tile-row "
                                 f"count {kernel.TILE_ROWS}")

    # ---- 2. kernel vs plain ----------------------------------------------
    t0 = time.perf_counter()
    timings, max_err = phase_kernel()
    fused_mix = main_path_mix({((k, m), phase): t for ((k, m), bits, phase), t
                               in timings.items() if bits == 2})
    log(f"kernel phase done in {time.perf_counter() - t0:.1f}s; "
        + mix_line("sgmv_fused main-path", fused_mix))

    # ---- 3. serve full width, bf16, packed --------------------------------
    from repro_torch.configs import get_config

    vocab = get_config("llama3.2-3b", "full").vocab
    torch.cuda.reset_peak_memory_stats()
    kernel.reset_launch_counts()
    t0 = time.perf_counter()
    done = serve("bfloat16", "packed")
    launches = kernel.LAUNCH_COUNTS["sgmv_fused"]
    log(f"serve phase (init + register + serve) {time.perf_counter() - t0:.1f}s;"
        f" peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB; sgmv_fused launches {launches}")
    want = LAYERS * len(LINEARS) * MAX_NEW
    if launches != want:
        raise AssertionError(f"sgmv_fused launched {launches} times, want "
                             f"{want} (28 layers x 7 linears x 8 forwards)")
    check_outputs(done, vocab)
    del done
    torch.cuda.empty_cache()
    with profiled_decode() as prof3:          # a second run, profiled
        check_outputs(serve("bfloat16", "packed"), vocab)
    log(window_line("one-layout serve", prof3))
    torch.cuda.empty_cache()

    # ---- 4. parity in fp32: packed == materialize -------------------------
    t0 = time.perf_counter()
    runs = {}
    for name, mode, adapters in (("packed", "packed", N_ADAPTERS),
                                 ("materialize", "materialize", N_ADAPTERS),
                                 ("control", "packed", N_ADAPTERS + 1)):
        runs[name] = serve("float32", mode, adapters, keep_logits=True)
        check_outputs(runs[name], vocab)
        torch.cuda.empty_cache()
    packed = {r.request_id: r.output.tolist() for r in runs["packed"]}
    mat = {r.request_id: r.output.tolist() for r in runs["materialize"]}
    diff = [rid for rid in packed if packed[rid] != mat[rid]]
    if diff:
        raise AssertionError(f"fp32 packed vs materialize tokens differ for "
                             f"requests {diff}: {[packed[r] for r in diff]} vs "
                             f"{[mat[r] for r in diff]}")
    scale = max(float(abs(r.logits).max()) for r in runs["packed"])
    tol = LOGIT_RTOL * scale
    gap = logit_gap(runs["packed"], runs["materialize"])
    if max(gap.values()) > tol:
        raise AssertionError(f"fp32 packed vs materialize logits differ by "
                             f"{gap} > {LOGIT_RTOL:g} x {scale:.3e}")
    moved = {rid: g for rid, g in logit_gap(runs["packed"],
                                            runs["control"]).items()
             if rid % N_ADAPTERS != rid % (N_ADAPTERS + 1)}
    if min(moved.values()) < CONTROL_MARGIN * tol:
        raise AssertionError(f"another adapter moves the logits of requests "
                             f"by only {moved}, under {CONTROL_MARGIN} x the "
                             f"tolerance {tol:.3e}: the parity check is blind")
    log(f"parity phase {time.perf_counter() - t0:.1f}s: packed == materialize "
        f"for all {len(packed)} requests ({N_REQ * MAX_NEW} tokens); logits "
        f"max |diff| {max(gap.values()):.3e} <= {tol:.3e} "
        f"({LOGIT_RTOL:g} x max|logit| {scale:.3e}); another adapter moves "
        f"requests {sorted(moved)} by {min(moved.values()):.3e} to "
        f"{max(moved.values()):.3e}")
    del runs
    torch.cuda.empty_cache()

    # ---- 5. single-adapter kernels vs plain -------------------------------
    t0 = time.perf_counter()
    single_timings, single_err = phase_single_kernels()
    mixes = {name: single_mix(single_timings, name)
             for name in ("fused_lora", "matmul_rhs", "matmul_out")}
    log(f"single-adapter kernel phase {time.perf_counter() - t0:.1f}s; "
        + "; ".join(mix_line(n, x) for n, x in mixes.items()))

    # ---- 6. the two-pass route ----------------------------------------------
    two_pass = phase_two_pass()

    # ---- 7-8. single-adapter serve (bf16) and three-way parity (fp32) -------
    t0 = time.perf_counter()
    single = phase_single_serve()
    log(f"single-adapter phases {time.perf_counter() - t0:.1f}s")

    # ---- 9. multi-adapter kernels vs plain ----------------------------------
    t0 = time.perf_counter()
    sgmv_timings, sgmv_err = phase_sgmv_kernels()
    sgmv_mixes = {name: sgmv_mix(sgmv_timings, name)
                  for name in ("sgmv_rhs", "sgmv_out", "sgmv_fused")}
    log(f"multi-adapter kernel phase {time.perf_counter() - t0:.1f}s; "
        + "; ".join(mix_line(f"{n} (rtn2)", x)
                    for n, x in sgmv_mixes.items()))
    for fmt in SIDE_FORMATS[1:]:
        log(mix_line(f"single-side sgmv_fused ({fmt})",
                     sgmv_mix(sgmv_timings, "sgmv_fused", fmt)))

    # ---- 10. sgmv_apply, fused and two-pass ---------------------------------
    kernel.reset_launch_counts()
    sgmv_apply_counts = phase_sgmv_apply()

    # ---- 11. mixed-recipe serve, full width, bf16 ---------------------------
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    kernel.reset_launch_counts()
    done = serve("bfloat16", "packed", recipes=MIXED_RECIPES)
    mixed_counts = dict(kernel.LAUNCH_COUNTS)
    want = {"sgmv_fused": 3 * LAYERS * len(LINEARS) * MAX_NEW}
    if mixed_counts != want:
        raise AssertionError(f"mixed-recipe serve launched {mixed_counts}, "
                             f"want {want} (3 buckets x 28 layers x 7 "
                             f"linears x 8 forwards)")
    check_outputs(done, vocab)
    log(f"mixed-recipe serve phase (init + register + serve) "
        f"{time.perf_counter() - t0:.1f}s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{mixed_counts}")
    del done
    torch.cuda.empty_cache()
    with profiled_decode() as prof11:         # a second run, profiled
        check_outputs(serve("bfloat16", "packed", recipes=MIXED_RECIPES),
                      vocab)
    log(window_line("mixed-recipe serve", prof11))
    torch.cuda.empty_cache()

    # ---- 12. mixed-recipe parity in fp32 ------------------------------------
    t0 = time.perf_counter()
    phase_mixed_parity(vocab)
    log(f"mixed-recipe parity phase {time.perf_counter() - t0:.1f}s")

    # ---- 13-14. continuous serve over paged memory; fp32 parity ------------
    t0 = time.perf_counter()
    cont = phase_continuous(vocab)
    log(f"continuous phases {time.perf_counter() - t0:.1f}s")

    # ---- 15. mixed-recipe continuous serve under a byte budget --------------
    t0 = time.perf_counter()
    phase_mixed_continuous(vocab)
    log(f"mixed continuous phase {time.perf_counter() - t0:.1f}s")

    # ---- 16. chaos storm at full width, fp32 --------------------------------
    t0 = time.perf_counter()
    phase_chaos(vocab)
    log(f"chaos phase {time.perf_counter() - t0:.1f}s")

    # ---- 17. telemetry on the card; the serve driver's fault flags ----------
    t0 = time.perf_counter()
    phase_telemetry(vocab)
    log(f"telemetry phase {time.perf_counter() - t0:.1f}s")
    log(f"total {time.perf_counter() - t_start:.1f}s")

    # ---- summary -------------------------------------------------------------
    def entry(name, replaces, launches, err, x):
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/quant_matmul/csrc/"
                          f"{name}.cu",
                "replaces": f"src/repro/kernels/quant_matmul/kernel.py:"
                            f"{replaces}",
                "launches": launches, "max_abs_err": err, "ms": x["ms"],
                "plain_ms": x["plain_ms"], "bound_ms": x["bound_ms"],
                "bound_by": x["bound_by"], "library_ms": None}

    print(smi)
    print(json.dumps({"kernels": [
        entry("sgmv_fused", 481, cont["launches"],
              max(max_err, sgmv_err["sgmv_fused"]), fused_mix),
        entry("sgmv_rhs", 250, sgmv_apply_counts["sgmv_rhs"],
              sgmv_err["sgmv_rhs"], sgmv_mixes["sgmv_rhs"]),
        entry("sgmv_out", 293, sgmv_apply_counts["sgmv_out"],
              sgmv_err["sgmv_out"], sgmv_mixes["sgmv_out"]),
        entry("fused_lora", 348, single["launches"], single_err["fused_lora"],
              mixes["fused_lora"]),
        entry("matmul_rhs", 157, two_pass["matmul_rhs"],
              single_err["matmul_rhs"], mixes["matmul_rhs"]),
        entry("matmul_out", 204, two_pass["matmul_out"],
              single_err["matmul_out"], mixes["matmul_out"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
