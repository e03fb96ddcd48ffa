#!/usr/bin/env python3
"""Drive the PyTorch/H100 port of LoRAQuant serving on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (a failure raises and the script exits non-zero):

1. Environment: torch / CUDA versions, the card's name and power limit, and
   the nvcc build of the ``sgmv_fused`` kernel from
   ``src/repro_torch/kernels/quant_matmul/csrc/`` (timed).
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

The last three lines are the card (nvidia-smi), a ``{"kernels": [...]}``
summary and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

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

LAYERS = 28
LINEARS = {"wq": (3072, 3072), "wk": (3072, 1024), "wv": (3072, 1024),
           "wo": (3072, 3072), "wg": (3072, 8192), "wu": (3072, 8192),
           "wd": (8192, 3072)}
SHAPES = [(3072, 3072), (3072, 1024), (3072, 8192), (8192, 3072)]
N_REQ, PROMPT, MAX_NEW, N_ADAPTERS = 16, 32, 8, 8
PHASES = {"decode": (1, N_REQ), "prefill": (8, N_REQ * PROMPT)}  # tile, rows


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


def call(fn, x, pb, seg_tiles, tile_t):
    return fn(x, pb.ah_codes, pb.ah_scale, pb.ah_zero, pb.bh_codes,
              pb.bh_scale, pb.bh_zero, seg_tiles,
              bits_a=pb.bits_hi, binary_a=False, group_a=pb.group_ah,
              bits_b=pb.bits_hi, binary_b=False, group_b=pb.group_bh,
              a_lo=(pb.al_codes, pb.al_scale, pb.al_zero),
              b_lo=(pb.bl_codes, pb.bl_scale, pb.bl_zero),
              group_al=pb.group_al, group_bl=pb.group_bl, m=pb.m,
              tile_t=tile_t)


def phase_kernel():
    import torch
    from repro_torch.kernels.quant_matmul import sgmv_fused, sgmv_fused_ref

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
        n_tiles = rows // tile_t
        # requests r -> adapter r % 8; a prompt spans PROMPT / tile_t tiles
        per_req = max(1, n_tiles // N_REQ)
        seg_tiles = ((torch.arange(n_tiles, device="cuda") // per_req)
                     % N_ADAPTERS).to(torch.int32)
        x = (torch.randn(rows, k, generator=gen, device="cuda")).to(xdtype)
        got = call(sgmv_fused, x, pb, seg_tiles, tile_t)
        torch.cuda.synchronize()
        want = call(sgmv_fused_ref, x, pb, seg_tiles, tile_t)
        if got.shape != (rows, m) or not torch.isfinite(got).all():
            raise AssertionError(f"bad kernel output {tuple(got.shape)}")
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        if err > RTOL * scale:
            raise AssertionError(
                f"sgmv_fused K={k} M={m} bits={bits} {phase}: max |err| "
                f"{err:.3e} > {RTOL:g} x {scale:.3e}")
        max_err = max(max_err, err)
        ms = time_ms(lambda: call(sgmv_fused, x, pb, seg_tiles, tile_t))
        plain = time_ms(lambda: call(sgmv_fused_ref, x, pb, seg_tiles, tile_t),
                        iters=5)
        t_bytes, t_ops = bound(pb, x, seg_tiles, m)
        timings[(k, m), bits, phase] = (ms, plain, t_bytes, t_ops)
        log(f"sgmv_fused K={k:5d} M={m:5d} bits={bits} {phase:7s} "
            f"T={rows:3d} x={str(xdtype)[6:]:8s} max|err|={err:.2e} "
            f"(max|y| {scale:.2e})  kernel {ms:.4f} ms  plain {plain:.4f} ms"
            f"  bound {max(t_bytes, t_ops):.5f} ms (bytes {t_bytes:.5f}, "
            f"ops {t_ops:.5f})")
    return timings, max_err


def main_path_mix(timings):
    """Mean per launch over the main path's launches (bits_hi = 2): every
    layer runs each of its 7 LoRA linears once at prefill and once per
    decode step. The bound of the mix is the larger of its summed byte time
    and its summed operation time."""
    tot = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "ops": 0.0}
    n = 0
    for k, m in LINEARS.values():
        for phase, count in (("prefill", 1), ("decode", MAX_NEW - 1)):
            ms, plain, t_bytes, t_ops = timings[(k, m), 2, phase]
            tot["ms"] += count * ms
            tot["plain_ms"] += count * plain
            tot["bytes"] += count * t_bytes
            tot["ops"] += count * t_ops
            n += count
    return {"ms": tot["ms"] / n, "plain_ms": tot["plain_ms"] / n,
            "bound_ms": max(tot["bytes"], tot["ops"]) / n,
            "bound_by": "bytes" if tot["bytes"] >= tot["ops"] else "operations"}


def serve(dtype: str, mode: str, adapters: int = N_ADAPTERS,
          keep_logits: bool = False):
    from repro_torch.launch import serve as serve_mod

    return serve_mod.main([
        "--arch", "llama3.2-3b", "--preset", "full", "--dtype", dtype,
        "--adapters", str(adapters), "--variant", "2@0.9",
        "--requests", str(N_REQ), "--prompt-len", str(PROMPT),
        "--max-new", str(MAX_NEW), "--mode", mode, "--seed", "0"]
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script drives the "
              "port on an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch next to {__file__}; run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
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
    for line in build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # ---- 2. kernel vs plain ----------------------------------------------
    t0 = time.perf_counter()
    timings, max_err = phase_kernel()
    mix = main_path_mix(timings)
    log(f"kernel phase done in {time.perf_counter() - t0:.1f}s; main-path "
        f"mix per launch: kernel {mix['ms']:.4f} ms, plain "
        f"{mix['plain_ms']:.4f} ms, bound {mix['bound_ms']:.5f} ms "
        f"({mix['bound_by']})")

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
    log(f"total {time.perf_counter() - t_start:.1f}s")

    # ---- 5. summary --------------------------------------------------------
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "sgmv_fused",
        "route": "cuda",
        "source": "src/repro_torch/kernels/quant_matmul/csrc/sgmv_fused.cu",
        "replaces": "src/repro/kernels/quant_matmul/kernel.py:481",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": mix["ms"],
        "plain_ms": mix["plain_ms"],
        "bound_ms": mix["bound_ms"],
        "bound_by": mix["bound_by"],
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
