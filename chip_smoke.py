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
   shape whose M is not a multiple of the group. Each bits-2 case at the
   four shapes (the mix's) prints the kernel's time, the plain version's
   time and the bound; the others their error.
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
   launches. The mix's cases (bits 2, rho 0.9, the four shapes) are timed.
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
8. Three-way parity in fp32 at 8 layers: the codes served as
   ``QuantizedLoRA`` leaves (``fused_lora``), as a one-adapter
   ``PackedLoRABatch`` (``sgmv_fused``) and as materialized fp factors:
   identical greedy tokens
   and every step's logits within ``LOGIT_RTOL``; an adapter from another
   seed must move every request's logits by ``CONTROL_MARGIN`` tolerances.
9. Multi-adapter kernels vs plain (TF32 off): ``sgmv_rhs``, ``sgmv_out``
   and the single-side ``sgmv_fused`` at the four full-width shapes, 8
   adapters of rank 16 quantized per side with ``rtn_quantize`` at 2/3/4
   bits and with ``binary_quantize`` (group 128), decode (tile_t 1, 16
   rows) and prefill (tile_t 8, 512 rows) with x bf16, plus (256, 200) in
   fp32, and one two-sided ``sgmv_fused`` whose low side has another rank
   (8) than the high side (16). ``sgmv_rhs`` and ``sgmv_out`` must give the
   same bits on two launches. The mixes' cases at the four shapes are
   timed: ``sgmv_fused`` in every format, the two-pass pair in RTN-2.
10. ``sgmv_apply`` at every full-width shape, decode and prefill:
    ``fused=True`` launches exactly one ``sgmv_fused``, ``fused=False``
    exactly one ``sgmv_rhs`` and one ``sgmv_out``; both held against the
    dense oracle ``ref_sgmv``.
11. Mixed-recipe serve: llama3.2-3b at full width in bf16, 8 adapters, two
    ``4@0.95``, two ``3@0.9`` and four ``2@0.9`` (3 layout buckets), 16
    requests, prompt 32, 8 new tokens, ``--mode packed``: exactly 3 x 1568
    = 4704 ``sgmv_fused`` launches and no other kernel.
12. fp32 parity of the same mixed-recipe fleet at 8 of its 28 layers:
    packed vs materialize, identical greedy tokens and every step's logits
    within ``LOGIT_RTOL``;
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
14. fp32 parity of the bounded continuous serve against materialize at 8
    layers (the fleet drawn again over their template): identical tokens,
    every step's logits within ``LOGIT_RTOL``, and a control in which
    every request meets another adapter moving them by ``CONTROL_MARGIN``
    tolerances.
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
18. MoE kernel vs plain: ``sgmv_fused`` against ``sgmv_fused_ref`` (TF32
    off) at mixtral-8x22b's five (K, M) -- (6144, 6144), (6144, 1024),
    (6144, 16384), (16384, 6144) and the router's (6144, 8) -- with 8
    adapters x 8 experts folded into 64 entries and folded seg ids
    ``adapter·8 + expert`` at tile_t 1 over the dispatch rows (64 at
    decode, 1280 at prefill), bits 2; bitwise repeats; time, plain time
    and bound per case, and the mix over mixtral's 8 LoRA linears.
19. MoE continuous serve: mixtral at full width cut to 8 layers, bf16, 8
    adapters ``2@0.9`` (per-expert LoRA), ``MultiLoRAEngine`` with 8 rows
    over the Zipf stream of phase 13, all-resident and bounded to 4
    slots: the reference's paging (``ZIPF_BOUNDED``), the pool at 4
    pages, exactly 8 layers x 8 LoRA linears = 64 ``sgmv_fused`` per live
    pool per forward and no other kernel; a second bounded run (one
    engine step profiled) repeats the first's tokens and paging; the
    requests whose all-resident tokens part from the bounded ones are
    reported (capacity drops and bf16 rounding depend on which requests
    share a prefill group).
20. MoE fp32 parity, 2 layers, capacity factor n_experts (drop-free, as
    the reference's own parity tests): bounded continuous == all-resident
    == materialize in routing (every prompt at every MoE layer), greedy
    tokens and logits within ``LOGIT_RTOL``; a shifted-adapter control
    moves them by ``CONTROL_MARGIN`` tolerances.
21. Long prompt, fp32, 2 layers: one request of 8704 tokens (past the
    4096 window and the 8192-token blockwise threshold) and 4 decode
    steps, continuous packed == materialize in routing at every MoE layer
    of every forward, tokens, and logits within ``LOGIT_RTOL``; then one
    full-width attention layer at T = 8704: blockwise == plain within
    ``RTOL``, with window 4096 and without, and the default path is the
    blockwise one.
22. Dense-variant kernel vs plain: ``sgmv_fused`` against
    ``sgmv_fused_ref`` (TF32 off) at every (K, M) of the LoRA linears of
    gemma2-2b, olmo-1b, internlm2-20b, qwen2-vl-72b and musicgen-medium
    (19 shapes, K and M up to qwen2-vl's 29568), 8 adapters, bits 2,
    decode (tile_t 1, 16 rows) and prefill (tile_t 8, 512 rows); bitwise
    repeats; time, plain time and bound per case, and each model's mix.
23. gemma2-2b at full width and depth (26 layers of alternating local /
    global attention, soft-caps, post-norms), bf16, phase 13's Zipf
    stream served continuously all-resident and bounded to 4 slots:
    identical tokens, paging == ``ZIPF_BOUNDED``, exactly 26 x 7 = 182
    ``sgmv_fused`` per live pool per forward and no other kernel; a
    second bounded run (one engine step profiled) repeats the first's
    tokens and paging. This bounded run is the slice's main path.
24. gemma2-2b fp32 at 8 layers: bounded continuous == materialize
    (tokens, logits within ``LOGIT_RTOL``) and the shifted-adapter
    control.
25. gemma2-2b fp32, one local / global period: an 8704-token prompt (past
    the 4096 window: the local layer's ring holds 4096 slots, the global
    layer's the whole prompt) and 4 decode steps, packed == materialize;
    then one gemma2 attention layer (soft-cap 50) at T = 8704: blockwise
    == plain within ``RTOL``, with and without the window.
26. olmo-1b (16 layers), internlm2-20b (16 of 48) and qwen2-vl-72b (8
    of 80), width full, as in phase 23, and in fp32 as in phase 24 at 8,
    8 and 2 layers. In bf16 their bounded tokens may part from the
    all-resident ones (bf16 rounding of other prefill groups): the parted
    requests are reported, and the two runs' logits must stay within
    ``BF16_GAP_RTOL`` of max |logit| on the steps before they part.
27. musicgen-medium at full width, 16 of its 48 layers, fp32, at the
    model level (the engine cannot serve it: ROADMAP C8): 8 adapters as
    one ``PackedLoRABatch``, ``(16, 4, 32)`` prompts, prefill and 7 decode
    steps: 16 x 7 launches per forward, frames and logits ``(16, 4, 32,
    V)`` == materialize within ``LOGIT_RTOL``, a control; the serve driver
    refuses the arch.

28. LoRA training: llama3.2-3b at full width and depth, bf16 frozen base,
    fp32 LoRA of rank 16 on the 7 linears of every layer,
    ``make_train_step`` with ``remat`` (as the reference's
    ``launch/train.py`` sets it at ``--preset full``), batch 8 x 128 in 2
    microbatches, lr 2e-4, ``TRAIN_STEPS`` steps on
    ``benchmarks/common.py``'s task B (data seed 101): every loss and grad norm finite, the CE of the trained batches
    lower after training (the held-out CE is reported), one step
    profiled; in fp32 at ``FP32_LAYERS`` layers one step's loss and
    gradients with 2 microbatches equal to one batch's within
    ``MICRO_RTOL`` of their max |value|.
29. Table 1: the trained adapter quantized by every row of
    ``make_method_table`` (fp16, bin, rtn1, rtn2, gptq2, pbllm, billm,
    LoRAQuant 2@0.8 / 2@0.9 / 3@0.8 / 3@0.9 and the two ALS rows): AvgBits,
    held-out CE (``eval_loss``'s 8 batches from step 10000) and quantize
    time per row; the fp16 row's CE equal to the unquantized adapter's,
    every AvgBits equal to the reference's accounting (``expected_bits``),
    LoRAQuant 2@0.9 under 2 bits. The quality order is reported, not held
    (the base is random).
30. Eval from packed codes: the LoRAQuant 2@0.9 adapter as one-layer
    stacked ``QuantizedLoRA`` leaves (each layer its own group, so each
    leaf has one split h) through ``fused_lora`` (or the two-pass pair
    where the reference's guard says so), against the same codes
    materialized: in fp32 at ``FP32_LAYERS`` layers the logits within
    ``LOGIT_RTOL`` of max |logit|, a 3@0.9 control moving them by
    ``CONTROL_MARGIN`` tolerances, launches == the reference's rule; in
    bf16 at full depth both held-out CEs reported, and these launches
    are the ``eval_launches`` of the kernels line.
31. deepseek kernel vs plain: ``sgmv_fused`` against ``sgmv_fused_ref``
    (TF32 off) at the nine (K, M) of deepseek-v3-671b's LoRA linears (MLA's
    ``wq_down`` / ``wq_up`` / ``wkv_down`` / ``wo``, the dense FFN, the
    router's M = 256, the shared expert), 8 adapters of rank 16, group
    128, bits 2 (timed) and 3 / 4 (checked), decode (tile_t 1, 16 rows)
    and prefill (tile_t 8, 512 rows); bitwise repeats; the mix per launch
    over a dense and over an MoE layer.
32. MLA at full width, one layer, fp32: a prefill of 64 tokens and 8
    absorbed decode steps (one row left-padded) equal the sequence forward
    of all 72 tokens within ``RTOL``, and the cache holds its latents;
    4096 tokens through the blockwise path equal the plain one.
33. deepseek continuous serve, the slice's main path: full width cut to
    3 dense + 2 MoE layers (int8 experts), bf16, phase 13's Zipf stream
    all-resident and bounded to 4 slots: paging == ``ZIPF_BOUNDED``,
    exactly 3 x 7 + 2 x 8 = 37 ``sgmv_fused`` per live pool per forward
    and no other kernel, a second bounded run (one engine step profiled)
    repeating tokens and paging; parted requests, tokens/s and peak
    memory reported.
34. deepseek fp32 parity, 1 dense + 1 MoE layer, capacity factor 32
    (drop-free): bounded == all-resident == materialize in routing,
    tokens, and logits within ``LOGIT_RTOL``; a shifted-adapter control.
35. deepseek ``train_loss`` with the MTP head and its backward at full
    width, 1 + 1 layers, bf16 base, fp32 LoRA, batch 2 x 128: finite
    loss, CE, aux and MTP CE, finite LoRA gradients, no base gradient.
36. recurrent kernel vs plain: ``sgmv_fused`` against ``sgmv_fused_ref``
    (TF32 off) at the seven distinct (K, M) of rwkv6-1.6b's and
    recurrentgemma-2b's LoRA linears, 8 adapters of rank 16, group 128,
    bits 2 (timed) and 3 / 4 (checked), decode (tile_t 1, 16 rows) and
    prefill (tile_t 8, 512 rows); bitwise repeats; each model's mix per
    launch.
37. The recurrent mixers at full width, one layer each, fp32, TF32 off:
    RWKV-6's time mix prefilled with 56 tokens and decoded 8 steps equals
    its sequence forward of 64 tokens within ``RTOL``, chunk 16 equals
    chunk 64 at T = 128; the same for ``rglru_block`` with its conv
    window carried; one recurrentgemma period (rglru, rglru, local_attn)
    over 8704 tokens (past its 2048-token window) equals a prefill of
    8640 tokens and 64 decode steps.
38. rwkv6-1.6b continuous serve, the slice's main path: full width and
    full depth (24 layers), bf16, phase 13's Zipf stream all-resident and
    bounded to 4 slots: paging == ``ZIPF_BOUNDED``, exactly 24 x 8 = 192
    ``sgmv_fused`` per live pool per forward and no other kernel, a
    second bounded run (one engine step profiled) repeating tokens and
    paging, every request prefilled in the same group in both runs giving
    the same bits; parted requests, the others' logit gap (reported: the
    random-weight recurrence amplifies rounding ~100x over 24 layers),
    the growth of a prefill's rounding by layer, tokens/s, peak memory,
    step time and idle share reported.
39. recurrentgemma-2b the same at full depth (26 layers, two groups):
    8 x 19 + 12 = 164 ``sgmv_fused`` per live pool per forward, the
    others' logits within ``BF16_GAP_RTOL`` before they part.
40. fp32 parity of both at full width and cut depth (rwkv6 4 layers,
    recurrentgemma one period and its tail group): bounded continuous ==
    materialize in tokens, logits within ``LOGIT_RTOL``, a
    shifted-adapter control.
41. The mesh and EF-int8 compression on the card: ``make_host_mesh()``
    (NCCL, world size 1); llama3.2-3b's full-size parameter tree (meta)
    under ``shard_tree`` on it, every leaf whole; the sharded leaves and
    bytes per device on the two production meshes, (16, 16) and (2, 16,
    16); ``compressed_psum_mean`` over the NCCL group on the LoRA
    gradients of one full-width step (a 1e-6 residual carried in): equal
    bit for bit to the single-process arithmetic, the new residual at most
    scale / 2 per element; its time per call.
42. The training driver at full width: ``repro_torch.launch.train.main``
    for llama3.2-3b, ``--preset full`` (bf16 base, remat), batch 8 x 128,
    a checkpoint every 4 steps. Run A goes 12 steps; run B is sent SIGTERM
    after 6 and resumed to 12: its steps 6-11 (every metric) and its final
    LoRA params and optimizer state equal A's bit for bit, and both keep
    exactly 3 step directories. A driver subprocess sent SIGTERM after its
    step-3 line exits 0 with the checkpoint of its last finished step;
    resumed, it ends where A ends, bit for bit. Step time, tokens/s, peak
    memory, a checkpoint's bytes and seconds, the steps that overlap an
    async write against the median, and one profiled step's idle share.

43. The dry run (``repro_torch.launch.dryrun``) at (16, 16) on the card,
    rank 0's local program under a fake process group of 256 ranks, for
    llama3.2-3b x train_4k (cut to 2 microbatches, remat), llama3.2-3b x
    decode_32k and deepseek-v3-671b x decode_32k, each cell a subprocess
    beside its ``--device meta`` count: parameter bytes and counted FLOPs
    equal the meta count exactly, the peak memory is below the card's;
    per cell the collective bytes by kind, the three roofline terms of the
    H100 hardware model and the local step's wall time.

44. Adapters of any rank: (a) the six kernels at
    llama3.2-3b's four (K, M) at LoRA ranks 16, 64, 128 and 256 -- the
    fused kernels' ``2·rp`` = 32 to 512 rank rows (RTN 2/3/4/8 high
    side, binary low side), the one-sided kernels' ``rp`` and ``2·rp`` rows
    (RTN 2/3/4/8 and binary) -- decode and prefill, each within ``RTOL``
    of its plain version and bitwise equal on a second launch, with each
    kernel's main-path mix per launch (bits 2) at every rank beside rank
    16's; (b) llama3.2-3b at full width and depth in bf16 with the
    ``2@0.9`` fleet at LoRA rank 64, phase 13's Zipf stream all-resident
    and bounded to 4 slots: paging == ``ZIPF_BOUNDED``, 196 ``sgmv_fused``
    per live pool per forward and no other kernel, a second bounded run
    repeating tokens and paging, tokens/s, peak memory and the idle share;
    (c) rank 64 in fp32 at 4 layers: bounded continuous == materialize with
    the shifted-adapter control, and one rank-64 adapter as layer-stacked
    ``QuantizedLoRA`` leaves (``fused_lora``, or the two-pass pair where
    the reference's guard says so) == its materialized factors, with a
    control.

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


def timed(name, tag, fn, args, kwargs, plain, err):
    """Time one kernel case and log it: device time (CUDA-graph replay) with
    the inputs in L2 and rotating over 28 layer copies (cold L2), the
    wrapper's host time per call, the plain version's time (CUDA events
    around eager calls) and the bound (``bench_kernels.call_bound``: bytes
    over the HBM peak or fp32 operations over the fp32 peak, the larger).
    Returns the numbers as a dict."""
    from repro_torch.launch.bench_kernels import call_bound, kernel_times

    t_bytes, t_ops = call_bound(name, args, kwargs)
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
        tag = (f"K={k:5d} M={m:5d} bits={bits} {phase:7s} T={rows:3d} "
               f"x={str(xdtype)[6:]:8s}")
        if bits != 2 or (k, m) not in SHAPES:     # the mix's cases are timed
            log(f"sgmv_fused {tag} max|err|={err:.2e} (checked, not timed)")
            continue
        timings[(k, m), bits, phase] = timed(
            "sgmv_fused", tag, sgmv_fused, args, kw, sgmv_fused_ref, err)
    return timings, max_err


MIX_KEYS = ("ms", "cold_ms", "host_ms", "plain_ms")


def main_path_mix(per_case, linears=None):
    """Each timing of ``per_case`` (``{((k, m), phase): timings}`` at
    bits_hi 2) per launch over a model's main path (:func:`mix`: every
    layer runs each of its LoRA linears -- llama3.2-3b's unless
    ``linears`` names others -- once at prefill and once per decode step),
    and the mix's bound: the larger of its byte time and its operation
    time."""
    out = {key: mix(per_case, key, linears) for key in MIX_KEYS}
    t_bytes, t_ops = (mix(per_case, "bytes", linears),
                      mix(per_case, "ops", linears))
    out.update(bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    return out


def mix_line(name, x) -> str:
    return (f"{name} mix per launch: kernel {x['ms']:.4f} ms (cold-L2 "
            f"{x['cold_ms']:.4f}, host {x['host_ms']:.4f} ms/call), plain "
            f"{x['plain_ms']:.4f} ms, bound {x['bound_ms']:.5f} ms "
            f"({x['bound_by']})")


LORA_KERNELS = ("sgmv_fused_kernel", "fused_lora_kernel")
TOP_KERNELS = 6               # device kernels by time a profile keeps
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
    spans, lora, n_lora, by_name = [], 0.0, 0, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.end - e.time_range.start, n + 1)
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP_KERNELS]
    res.update(device_ms=busy / 1e3, lora_ms=lora / 1e3,
               other_ms=(total - lora) / 1e3, idle=1 - busy / 1e3 / window,
               lora_launches=n_lora, kernels=len(spans),
               top=[(name[:60], t / 1e3, n) for name, (t, n) in top])
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
        if (bits, rho) != (2, 0.9) or (k, m) not in SHAPES:
            log(f"single-adapter {tag} max|err| " + ", ".join(
                f"{n} {e:.2e}" for n, e in errs.items())
                + " (checked, not timed)")
            continue                            # the mix's cases are timed
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
        for name, (kern, plain, args, kwargs) in runs.items():
            timings[name, (k, m), bits, rho, phase] = timed(
                name, f"{tag} x={str(xdtype)[6:]:8s}", kern, args, kwargs,
                plain, errs[name])
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
        b, a = decayed_pairs(n, leaf["b"].shape[1], k, r, seed=seed * 100 + i,
                             device=leaf["a"].device)
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


def greedy(model, base, lora_pre, lora_dec, prompts, device="cuda"):
    """Prefill the prompts, then decode greedily to MAX_NEW tokens through
    the model's public API. Returns tokens ``(B, MAX_NEW)`` and every
    step's last-position logits ``(B, MAX_NEW, V)`` fp32, on ``device``."""
    import torch

    b = prompts.shape[0]
    logits, caches = model.prefill({"base": base, "lora": lora_pre},
                                   {"tokens": prompts}, PROMPT + MAX_NEW)
    last = logits[:, -1].argmax(-1)
    outs, kept = [last], [logits[:, -1].float()]
    del logits
    for k in range(MAX_NEW - 1):
        pos = torch.full((b,), PROMPT + k, dtype=torch.int64, device=device)
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
        # bf16 at full depth (phase 7), fp32 at PARITY_LAYERS (phase 8)
        model = build_model(dataclasses.replace(cfg, dtype=dtype) if
                            dtype == torch.bfloat16 else dense_config(
                                "llama3.2-3b", dtype, PARITY_LAYERS))
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
                want = ({kern: PARITY_LAYERS * len(LINEARS) * MAX_NEW}
                        if kern else {})
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
            log(f"three-way fp32 parity ({PARITY_LAYERS} layers): identical "
                f"greedy tokens for all "
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
        runs = {
            "sgmv_rhs": (sgmv_rhs, sgmv_rhs_ref, (x, *a, seg), kw),
            "sgmv_out": (sgmv_out, sgmv_out_ref, (h, *b, seg), okw),
            "sgmv_fused": (sgmv_fused, sgmv_fused_ref, (x, *a, *b, seg), fkw),
        }
        for name, (kern, plain, args, kwargs) in runs.items():
            max_err[name] = max(max_err[name], errs[name])
            # the mixes' cases are timed: every format of sgmv_fused, RTN-2
            # of the two-pass pair, at llama's shapes
            if (k, m) not in SHAPES or (fmt != "rtn2"
                                        and name != "sgmv_fused"):
                log(f"{name} {tag} max|err|={errs[name]:.2e} (checked, "
                    f"not timed)")
                continue
            timings[name, (k, m), fmt, phase] = timed(
                name, f"{tag} x={str(xdtype)[6:]:8s}", kern, args, kwargs,
                plain, errs[name])

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


# llama's depth in the fp32 parity phases 8, 12 and 14 (of its 28 layers;
# the bf16 serves and phase 4 run all 28), for the script's time
PARITY_LAYERS = 8


def packed_parity(vocab, recipes=(), device="cuda", preset="full"):
    """Phase 12: the fleet of phase 11 (``recipes``: three layouts; empty:
    phase 3's one) in fp32 at ``PARITY_LAYERS`` layers, served
    static packed and materialized by the engine, and a control in which
    request r meets adapter r + 1 instead of r (mod 8): identical tokens,
    logits within ``LOGIT_RTOL``, the control ``CONTROL_MARGIN`` times
    that, and one ``sgmv_fused`` per LoRA linear per layout per forward."""
    import numpy as np
    import torch
    from repro_torch.core import LoRAQuantConfig
    from repro_torch.kernels.quant_matmul import reset_launch_counts
    from repro_torch.launch.serve import (parse_recipe_override,
                                          random_trained_lora)
    from repro_torch.models import build_model
    from repro_torch.serving import AdapterStore, MultiLoRAEngine, Request

    cfg = dense_config("llama3.2-3b", torch.float32, PARITY_LAYERS, preset)
    layers = cfg.total_layers()
    model = build_model(cfg)
    params = model.init(seed=0, device=device)
    store = AdapterStore(LoRAQuantConfig(rho=0.9, bits_high=2))
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    store.register_many(
        {f"user_{i}": random_trained_lora(params["lora"], gen)
         for i in range(N_ADAPTERS)},
        recipes=dict(parse_recipe_override(r) for r in recipes))
    layouts = len({qa.signature for qa in store.quantized.values()})
    label = f"{layouts}-layout"
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
        sync(device)
        check_outputs(done, vocab)
        return done, launch_counts(device)

    packed, counts = run("packed")
    want = {"sgmv_fused": layouts * layers * len(LINEARS) * MAX_NEW}
    if counts != want:
        raise AssertionError(f"fp32 {label} packed run launched {counts}, "
                             f"want {want}")
    mat, counts = run("materialize")
    if counts:
        raise AssertionError(f"materialize launched kernels: {counts}")
    control, _ = run("packed", shift=1)
    diff = [r.request_id for r, q in zip(packed, mat)
            if r.output.tolist() != q.output.tolist()]
    if diff:
        raise AssertionError(f"fp32 {label} packed vs materialize "
                             f"tokens differ for requests {diff}")
    scale = max(float(abs(r.logits).max()) for r in packed)
    tol = LOGIT_RTOL * scale
    gap = logit_gap(packed, mat)
    if max(gap.values()) > tol:
        raise AssertionError(f"fp32 {label} logits differ by {gap} > "
                             f"{LOGIT_RTOL:g} x {scale:.3e}")
    moved = logit_gap(packed, control)
    if min(moved.values()) < CONTROL_MARGIN * tol:
        raise AssertionError(f"another adapter moves the logits by only "
                             f"{moved}, under {CONTROL_MARGIN} x {tol:.3e}: "
                             f"the parity check is blind")
    avg = {aid: round(st["avg_bits"], 4)
           for aid, st in sorted(store.adapter_stats().items())}
    log(f"{label} fp32 parity ({layers} layers): packed == "
        f"materialize for all {N_REQ} requests ({N_REQ * MAX_NEW} tokens, "
        f"{want['sgmv_fused']} sgmv_fused launches in {layouts} buckets); "
        f"logits max |diff| "
        f"{max(gap.values()):.3e} <= {tol:.3e} ({LOGIT_RTOL:g} x max|logit| "
        f"{scale:.3e}); every request meeting another adapter moves by "
        f"{min(moved.values()):.3e} to {max(moved.values()):.3e}; avg_bits "
        f"{avg}")
    del engine, store, model, params
    if device == "cuda":
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
            mixer = params["lora"]["groups"][0]["sub_0"]["mixer"]
            leaf = next(iter(mixer.values()))
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


@contextlib.contextmanager
def record_groups():
    """While active, every continuous admission appends the sorted request
    ids of its prefill group to the yielded list."""
    from repro_torch.serving.engine import MultiLoRAEngine

    groups = []
    orig = MultiLoRAEngine._admit_group

    def admit(self, reqs, rows, slots):
        groups.append(tuple(sorted(r.request_id for r in reqs)))
        return orig(self, reqs, rows, slots)

    MultiLoRAEngine._admit_group = admit
    try:
        yield groups
    finally:
        MultiLoRAEngine._admit_group = orig


def run_stream(model, params, store, ids, prompts, vocab, *, slots=None,
               mode="continuous", keep_logits=False, shift=0,
               device="cuda", profile=False, telemetry=None,
               per_forward=None):
    """Serve the stream through ``MultiLoRAEngine`` (``CONT_ROWS`` rows,
    ``slots`` device slots, ``telemetry`` if given); request r meets
    adapter ``ids[r] + shift``. Checks the outputs and that the kernel
    launches are exactly one ``sgmv_fused`` per LoRA linear per bucket per
    forward (``per_forward`` per bucket, llama3.2-3b's layers x linears by
    default; none for ``materialize``). Returns the requests in id order
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
    with count_forwards() as forwards, prof as window, \
            record_groups() as groups:
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
    if per_forward is None:
        per_forward = LAYERS_OF[device] * len(LINEARS)
    want = ({} if mode == "materialize" else
            {"sgmv_fused": per_forward * sum(forwards)})
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
        "stats": st, "window": window, "step_s": step_s, "groups": groups}


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

    # ---- 14. fp32: bounded continuous == materialize, PARITY_LAYERS ------
    del store
    t0 = time.perf_counter()
    cfg = dense_config("llama3.2-3b", torch.float32, PARITY_LAYERS, preset)
    model, params, store = fleet_of(cfg, device)
    res.update(fp32_parity(f"continuous ({cfg.total_layers()} layers)",
                           model, params, store, ids, prompts, vocab, device,
                           t0, per_forward=cfg.total_layers() * len(LINEARS)))
    del model, params, store
    if device == "cuda":
        torch.cuda.empty_cache()
    return res


def fp32_parity(label, model, params, store, ids, prompts, vocab, device,
                t0, per_forward=None):
    """The stream served in fp32, continuous bounded to ``CONT_SLOTS`` slots
    against materialize: identical tokens, every step's logits within
    ``LOGIT_RTOL`` of max |logit|, and a control in which every request
    meets another adapter moving them by ``CONTROL_MARGIN`` tolerances.
    Returns the gap and the tolerance."""
    runs = {}
    for name, mode, slots, shift in (("continuous", "continuous",
                                      CONT_SLOTS, 0),
                                     ("materialize", "materialize", None, 0),
                                     ("control", "continuous",
                                      CONT_SLOTS, 1)):
        runs[name] = run_stream(model, params, store, ids, prompts, vocab,
                                slots=slots, mode=mode, keep_logits=True,
                                shift=shift, device=device,
                                per_forward=per_forward)[0]
    same_tokens(runs["continuous"], runs["materialize"],
                f"{label}: fp32 continuous vs materialize")
    scale = max(float(abs(r.logits).max()) for r in runs["continuous"])
    tol = LOGIT_RTOL * scale
    gap = logit_gap(runs["continuous"], runs["materialize"])
    if max(gap.values()) > tol:
        raise AssertionError(f"{label}: fp32 continuous vs materialize "
                             f"logits differ by {gap} > {LOGIT_RTOL:g} x "
                             f"{scale:.3e}")
    moved = logit_gap(runs["continuous"], runs["control"])
    if min(moved.values()) < CONTROL_MARGIN * tol:
        raise AssertionError(f"{label}: another adapter moves the logits by "
                             f"only {moved}, under {CONTROL_MARGIN} x "
                             f"{tol:.3e}: the parity check is blind")
    log(f"{label} fp32 parity {time.perf_counter() - t0:.1f}s: bounded "
        f"({CONT_SLOTS} slots) continuous == materialize for all {N_REQ} "
        f"requests ({N_REQ * MAX_NEW} tokens); logits max |diff| "
        f"{max(gap.values()):.3e} <= {tol:.3e} ({LOGIT_RTOL:g} x "
        f"max|logit| {scale:.3e}); every request meeting another adapter "
        f"moves by {min(moved.values()):.3e} to {max(moved.values()):.3e}")
    return {"gap": max(gap.values()), "tol": tol}


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


# --------------------------------------------------------------------------
# mixtral-8x22b: sparse MoE with per-expert LoRA, sliding-window and
# blockwise attention (phases 18-21)
# --------------------------------------------------------------------------

MOE_ARCH = "mixtral-8x22b"
# depth cut, full width: 8 layers of ~2.50 B parameters (5.0 GB in bf16)
# for the serve, 2 layers (10.0 GB each in fp32) for the fp32 phases
MOE_LAYERS = {"cuda": 8, "cpu": 2}
MOE_PARITY_LAYERS = 2
LONG_PROMPT = 8704     # past the window (4096) and BLOCKWISE_THRESHOLD (8192)
LONG_NEW = 5           # the prefill's token and 4 decode steps


def kernel_case(label, pb, x, seg_tiles, tile_t, timing=True):
    """``sgmv_fused`` against its plain version on one packed layer: the
    output's shape and finiteness, max |err| within ``RTOL`` x max |y|,
    two launches bitwise equal; then (with ``timing``) its times and bound
    (:func:`timed`). Returns ``(timings or None, err)``."""
    import torch
    from repro_torch.kernels.quant_matmul import sgmv_fused, sgmv_fused_ref
    from repro_torch.launch.bench_kernels import packed_args

    m = pb.m
    args, kw = packed_args(pb, x, seg_tiles, tile_t)
    got = sgmv_fused(*args, **kw)
    again = sgmv_fused(*args, **kw)
    torch.cuda.synchronize()
    want = sgmv_fused_ref(*args, **kw)
    if got.shape != (x.shape[0], m) or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: bad kernel output "
                             f"{tuple(got.shape)}")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    if err > RTOL * scale:
        raise AssertionError(f"sgmv_fused {label}: max |err| {err:.3e} > "
                             f"{RTOL:g} x {scale:.3e}")
    if not torch.equal(got, again):
        raise AssertionError(f"sgmv_fused {label}: two launches differ")
    del got, again, want
    if not timing:
        log(f"sgmv_fused {label} max|err|={err:.2e} (checked, not timed)")
        return None, err
    return timed("sgmv_fused", label, sgmv_fused, args, kw, sgmv_fused_ref,
                 err), err


def phase_moe_kernel():
    """Phase 18: ``sgmv_fused`` against its plain version (TF32 off) at
    mixtral's five (K, M), 8 adapters x 8 experts folded into 64 entries,
    folded seg ids at tile_t 1 over the dispatch rows (64 at decode, 1280
    at prefill), bits 2; two launches must give the same bits."""
    import torch
    from repro_torch.launch.bench_kernels import (MOE_EXPERTS, MOE_PHASES,
                                                  MOE_SHAPES, moe_seg_for,
                                                  packed_layer)

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    timings, max_err = {}, 0.0
    for k, m in MOE_SHAPES:
        pb = packed_layer(k, m, 2, 128, N_ADAPTERS * MOE_EXPERTS,
                          seed=k + m + 2)
        for phase, (tile_t, rows) in MOE_PHASES.items():
            x = torch.randn(rows, k, generator=gen,
                            device="cuda").to(torch.bfloat16)
            timings[(k, m), phase], err = kernel_case(
                f"MoE K={k:5d} M={m:5d} {phase:7s} T={rows:4d} folded seg "
                f"(64 entries), tile_t 1", pb, x, moe_seg_for(phase), tile_t)
            max_err = max(max_err, err)
    return timings, max_err


def moe_config(dtype, layers, preset="full", cf=None):
    """mixtral-8x22b at full width (or the smoke preset), cut to ``layers``
    layers (one layer is a whole period of its pattern); ``cf`` replaces
    the capacity factor."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(MOE_ARCH, preset)
    moe = cfg.moe if cf is None else dataclasses.replace(
        cfg.moe, capacity_factor=cf)
    return dataclasses.replace(
        cfg, n_layers=layers, dtype=dtype, moe=moe,
        blocks=(dataclasses.replace(cfg.blocks[0], count=layers),))


def moe_fleet(dtype, layers, device="cuda", preset="full", cf=None):
    """mixtral cut to ``layers``, with :func:`fleet_of`'s params and
    adapters."""
    return fleet_of(moe_config(dtype, layers, preset, cf), device)


def fleet_of(cfg, device="cuda"):
    """A model of ``cfg`` with params from seed 0, and 8 adapters
    ``2@0.9`` drawn over its LoRA template (generator seed 1), quantized
    once."""
    import torch
    from repro_torch.core import LoRAQuantConfig
    from repro_torch.launch.serve import random_trained_lora
    from repro_torch.models import build_model
    from repro_torch.serving import AdapterStore

    model = build_model(cfg)
    params = model.init(seed=0, device=device)
    store = AdapterStore(LoRAQuantConfig(rho=0.9, bits_high=2))
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    store.register_many({f"user_{i}": random_trained_lora(params["lora"],
                                                          gen)
                         for i in range(N_ADAPTERS)})
    return model, params, store


def iter_tensors(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from iter_tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from iter_tensors(v)


@contextlib.contextmanager
def record_routing():
    """While active, every MoE layer's top-k choice is recorded in call
    order: ``(prefill tokens or None, router probabilities (n_tok, E),
    chosen experts (n_tok, k))`` on the host. Each call synchronizes, so
    only the parity phases record."""
    from repro_torch.models import ffn as ffn_mod
    from repro_torch.models.model import Model

    calls, state = [], {"tokens": None}
    orig_top_k, orig_prefill = ffn_mod._top_k, Model.prefill

    def top_k(probs, k):
        vals, idx = orig_top_k(probs, k)
        calls.append((state["tokens"], probs.float().cpu(), idx.cpu()))
        return vals, idx

    def prefill(self, params, batch, capacity):
        state["tokens"] = batch["tokens"].cpu()
        try:
            return orig_prefill(self, params, batch, capacity)
        finally:
            state["tokens"] = None

    ffn_mod._top_k, Model.prefill = top_k, prefill
    try:
        yield calls
    finally:
        ffn_mod._top_k, Model.prefill = orig_top_k, orig_prefill


def prefill_routing(calls):
    """Per prompt (its token bytes), the router probabilities and chosen
    experts of its rows at every MoE layer of its prefill."""
    out = {}
    for tokens, probs, idx in calls:
        if tokens is None:
            continue
        b, t = tokens.shape
        for row in range(b):
            sl = slice(row * t, (row + 1) * t)
            out.setdefault(tokens[row].numpy().tobytes(), []).append(
                (probs[sl], idx[sl]))
    return out


def routing_flips(a, b):
    """Tokens routed differently by two recordings of the same layers:
    ``[(layer, token, experts a, experts b, margin)]``, the margin being
    the gap between the k-th and the (k+1)-th router probability in ``a``
    (how near the choice was to a tie)."""
    flips = []
    if len(a) != len(b):
        raise AssertionError(f"{len(a)} routing calls vs {len(b)}")
    for layer, ((pa, ia), (_, ib)) in enumerate(zip(a, b)):
        if ia.shape != ib.shape:
            raise AssertionError(f"layer {layer}: routed {tuple(ia.shape)} "
                                 f"vs {tuple(ib.shape)}")
        k = ia.shape[1]
        for tok in (ia != ib).any(dim=1).nonzero().flatten().tolist():
            srt = pa[tok].sort(descending=True).values
            flips.append((layer, tok, ia[tok].tolist(), ib[tok].tolist(),
                          float(srt[k - 1] - srt[k])))
    return flips


def bounded_serve(label, model, params, store, vocab, device, per_forward,
                  keep_logits=False):
    """Phase 13's Zipf stream (8 rows) through ``model``, all-resident and
    bounded to ``CONT_SLOTS`` slots, then bounded again with one engine
    step profiled: the reference's paging (``ZIPF_BOUNDED``: the schedule
    depends on neither width nor depth), the pool at ``CONT_SLOTS`` pages,
    exactly ``per_forward`` ``sgmv_fused`` per live pool per forward and
    no other kernel (:func:`run_stream`), and the second bounded run
    repeating the first's tokens and paging. Logs each run; returns the
    requests of both first runs and the bounded run's numbers (its
    launches are the path's)."""
    ids, prompts = zipf_stream(vocab)
    kw = dict(device=device, per_forward=per_forward,
              keep_logits=keep_logits)
    resident, r_res = run_stream(model, params, store, ids, prompts, vocab,
                                 **kw)
    bounded, r_bnd = run_stream(model, params, store, ids, prompts, vocab,
                                slots=CONT_SLOTS, **kw)
    eng = r_bnd["engine"]
    mem = eng.memory_stats()
    got = {k: mem[k] for k in ("hits", "misses", "evictions", "swap_ins")}
    got.update({k: r_bnd["stats"][k]
                for k in ("decode_steps", "admission_waves")})
    if got != ZIPF_BOUNDED:
        raise AssertionError(f"{label} bounded paging {got}, the "
                             f"reference's {ZIPF_BOUNDED}")
    page = eng.memory.page_bytes
    if eng.memory.hbm_bytes() != CONT_SLOTS * page or mem["slots"] != 4:
        raise AssertionError(f"{label} bounded pool holds "
                             f"{eng.memory.hbm_bytes()} bytes, want "
                             f"{CONT_SLOTS} x {page}")
    again, r_again = run_stream(model, params, store, ids, prompts, vocab,
                                slots=CONT_SLOTS, profile=device == "cuda",
                                **kw)
    same_tokens(bounded, again, f"{label} bounded serve, two runs")
    if r_again["engine"].memory_stats() != mem:
        raise AssertionError(f"{label} bounded serve: the second run paged "
                             f"differently")
    for name, r in (("all-resident", r_res), ("bounded", r_bnd)):
        steps = sorted(r["step_s"])
        m = r["engine"].memory_stats()
        log(f"{label} continuous {name}: {r['tok_s']:.1f} tokens/s "
            f"({N_REQ * MAX_NEW} tokens in {r['s']:.3f}s, "
            f"{r['stats']['admission_waves']} prefill groups + "
            f"{r['stats']['decode_steps']} decode steps, "
            f"{r['counts']['sgmv_fused']} sgmv_fused launches = "
            f"{per_forward} x {sum(r['forwards'])} forwards; engine step "
            f"median {steps[len(steps) // 2] * 1e3:.1f} ms); "
            f"{m['slots']} slots, page {page} bytes; hits {m['hits']}, "
            f"misses {m['misses']}, evictions {m['evictions']}, swap-ins "
            f"{m['swap_ins']} ({m['swap_in_bytes']} bytes)")
    res = {"resident": resident, "bounded": bounded,
           "groups": (r_res["groups"], r_bnd["groups"]),
           "launches": r_bnd["counts"]["sgmv_fused"], "page": page,
           "tok_s": r_bnd["tok_s"], "tok_s_resident": r_res["tok_s"],
           "parted": [r.request_id for r, q in zip(resident, bounded)
                      if r.output.tolist() != q.output.tolist()]}
    if device == "cuda":
        res["window"] = r_again["window"]
        log(window_line(f"{label} continuous bounded serve", res["window"],
                        "engine-step"))
    return res


def phase_moe_continuous(device="cuda", preset="full"):
    """Phase 19: mixtral at full width, 8 layers, bf16, the ``2@0.9`` fleet
    through :func:`bounded_serve` (8 layers x 8 LoRA linears per live
    pool per forward). The bounded run is the MoE main path whose
    launches the summary reports. (Capacity drops and bf16 rounding depend
    on which requests share a prefill group, which the bound changes, as
    in the reference; so the all-resident tokens are reported against the
    bounded ones, and held to them in fp32 without drops in phase 20.)"""
    import torch
    from repro_torch.launch.bench_kernels import MOE_LINEARS
    from repro_torch.models import build_model

    vocab = moe_config(torch.bfloat16, 1, preset).vocab
    ids, prompts = zipf_stream(vocab)
    layers = MOE_LAYERS[device]
    per_forward = layers * len(MOE_LINEARS)
    t0 = time.perf_counter()
    model, params, store = moe_fleet(torch.bfloat16, layers, device, preset)
    sync(device)
    weights = sum(t.nbytes for t in iter_tensors(params["base"]))
    log(f"MoE continuous phase: bf16 mixtral ({layers} layers, "
        f"{weights / 1e9:.2f} GB of base weights) and 8 adapters in "
        f"{time.perf_counter() - t0:.1f}s; stream {ids}")
    res = bounded_serve("MoE bf16", model, params, store, vocab, device,
                        per_forward)
    # the same pair without capacity drops (capacity factor n_experts):
    # what still parts is bf16 rounding of differently shaped prefill
    # groups, the rest was drops
    free = build_model(moe_config(torch.bfloat16, layers, preset,
                                  cf=float(model.cfg.moe.n_experts)))
    kw = dict(device=device, per_forward=per_forward)
    free_res = run_stream(free, params, store, ids, prompts, vocab, **kw)[0]
    free_bnd = run_stream(free, params, store, ids, prompts, vocab,
                          slots=CONT_SLOTS, **kw)[0]
    res["parted_free"] = [r.request_id for r, q in zip(free_res, free_bnd)
                          if r.output.tolist() != q.output.tolist()]
    log(f"MoE continuous bf16: requests whose tokens part from the "
        f"all-resident serve's: {res['parted']} (capacity factor "
        f"{model.cfg.moe.capacity_factor:g}), {res['parted_free']} without "
        f"drops (capacity factor {model.cfg.moe.n_experts})")
    del model, params, store, free, free_res, free_bnd
    if device == "cuda":
        torch.cuda.empty_cache()
    return res


def drop_free_parity(label, cfg, device, per_forward):
    """A model of ``cfg`` (fp32, drop-free: the reference defines
    cross-mode parity only without capacity drops, since a drop depends
    on the batch) and phase 13's stream: the bounded continuous serve
    against the all-resident one and against materialize, identical
    routing of every prompt at every MoE layer, identical greedy tokens,
    logits within ``LOGIT_RTOL``, and a control in which every request
    meets another adapter moving them by ``CONTROL_MARGIN`` tolerances.
    Returns the largest gap, the tolerance and the peak memory."""
    import torch

    t0 = time.perf_counter()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    model, params, store = fleet_of(cfg, device)
    ids, prompts = zipf_stream(cfg.vocab)
    kw = dict(keep_logits=True, device=device, per_forward=per_forward)
    runs, routes = {}, {}
    for name, mode, slots, shift in (
            ("bounded", "continuous", CONT_SLOTS, 0),
            ("resident", "continuous", None, 0),
            ("materialize", "materialize", None, 0),
            ("control", "continuous", CONT_SLOTS, 1)):
        with record_routing() as calls:
            runs[name] = run_stream(model, params, store, ids, prompts,
                                    cfg.vocab, slots=slots, mode=mode,
                                    shift=shift, **kw)[0]
        routes[name] = prefill_routing(calls)
    for other in ("resident", "materialize"):
        same_tokens(runs["bounded"], runs[other],
                    f"{label} fp32 bounded vs {other}")
        if routes[other].keys() != routes["bounded"].keys():
            raise AssertionError(f"{label} fp32 {other}: other prompts "
                                 f"routed")
        flips = [f for key in routes["bounded"]
                 for f in routing_flips(routes["bounded"][key],
                                        routes[other][key])]
        if flips:
            raise AssertionError(f"{label} fp32 bounded vs {other}: "
                                 f"routing flips (layer, token, experts, "
                                 f"experts, margin) {flips[:8]}")
    n_layers = sorted({len(v) for v in routes["bounded"].values()})
    scale = max(float(abs(r.logits).max()) for r in runs["bounded"])
    tol = LOGIT_RTOL * scale
    gaps = {o: logit_gap(runs["bounded"], runs[o])
            for o in ("resident", "materialize")}
    for o, gap in gaps.items():
        if max(gap.values()) > tol:
            raise AssertionError(f"{label} fp32 bounded vs {o} logits "
                                 f"differ by {gap} > {LOGIT_RTOL:g} x "
                                 f"{scale:.3e}")
    moved = logit_gap(runs["bounded"], runs["control"])
    if min(moved.values()) < CONTROL_MARGIN * tol:
        raise AssertionError(f"{label}: another adapter moves the logits "
                             f"by only {moved}, under {CONTROL_MARGIN} x "
                             f"{tol:.3e}: the parity check is blind")
    peak = (torch.cuda.max_memory_allocated() / 2**30 if device == "cuda"
            else None)
    log(f"{label} fp32 parity (capacity factor "
        f"{cfg.moe.capacity_factor:g}) {time.perf_counter() - t0:.1f}s: "
        f"bounded ({CONT_SLOTS} slots) == all-resident == materialize for "
        f"all {N_REQ} requests; every prompt routed identically at its "
        f"{n_layers} MoE layers ({len(routes['bounded'])} prompts); logits "
        f"max |diff| {max(gaps['resident'].values()):.3e} (resident), "
        f"{max(gaps['materialize'].values()):.3e} (materialize) <= "
        f"{tol:.3e} ({LOGIT_RTOL:g} x max|logit| {scale:.3e}); every "
        f"request meeting another adapter moves by "
        f"{min(moved.values()):.3e} to {max(moved.values()):.3e}"
        + (f"; peak device memory {peak:.2f} GiB" if peak else ""))
    res = {"gap": max(max(g.values()) for g in gaps.values()), "tol": tol,
           "peak_gib": peak}
    del model, params, store, runs, routes
    if device == "cuda":
        torch.cuda.empty_cache()
    return res


def phase_moe_parity(device="cuda", preset="full"):
    """Phase 20: mixtral at full width, 2 layers, fp32, capacity factor
    n_experts: :func:`drop_free_parity`."""
    import torch
    from repro_torch.launch.bench_kernels import MOE_LINEARS

    n_experts = moe_config(torch.float32, 1, preset).moe.n_experts
    cfg = moe_config(torch.float32, MOE_PARITY_LAYERS, preset,
                     cf=float(n_experts))
    return drop_free_parity("MoE", cfg, device,
                            MOE_PARITY_LAYERS * len(MOE_LINEARS))


def long_serve(model, params, store, prompt, mode, device):
    """One request of ``len(prompt)`` tokens, ``LONG_NEW`` greedy tokens,
    logits kept, through a one-row engine in ``mode``; returns the request,
    the routing recorded call by call, and the wall time."""
    from repro_torch.serving import MultiLoRAEngine, Request

    engine = MultiLoRAEngine(model, params, store,
                             cache_capacity=len(prompt) + LONG_NEW + 3,
                             mode=mode, max_rows=1)
    engine.submit(Request(request_id=0, adapter_id="user_0", prompt=prompt,
                          max_new_tokens=LONG_NEW, keep_logits=True))
    sync(device)
    t0 = time.perf_counter()
    with record_routing() as calls:
        done = engine.run()
    sync(device)
    dt = time.perf_counter() - t0
    (req,) = done
    if req.status.value != "done" or req.output.shape != (LONG_NEW,):
        raise AssertionError(f"long prompt ({mode}): {req.status} "
                             f"{req.output}")
    return req, [(p, i) for _, p, i in calls], dt


def phase_moe_long(device="cuda", preset="full"):
    """Phase 21: one request of ``LONG_PROMPT`` tokens (past the window and
    the blockwise threshold) and 4 decode steps, mixtral at full width,
    2 layers, fp32, the config's capacity factor: continuous packed ==
    materialize (one row each, so the same batches): identical routing at
    every MoE layer of every forward, tokens, logits within
    ``LOGIT_RTOL``. Then one full-width attention layer at T = LONG_PROMPT:
    the blockwise path (what ``gqa_attention`` takes above the threshold)
    against the plain one, with the window and without."""
    import torch

    t0 = time.perf_counter()
    model, params, store = moe_fleet(torch.float32, MOE_PARITY_LAYERS,
                                     device, preset)
    cfg = model.cfg
    n = LONG_PROMPT if preset == "full" else 3 * cfg.window + 5
    res = long_parity("MoE", model, params, store, n, device, t0)
    del model, params, store
    if device == "cuda":
        torch.cuda.empty_cache()
    res.update(attention_check(cfg, n, device))
    return res


def long_parity(label, model, params, store, n, device, t0):
    """One request of ``n`` tokens and ``LONG_NEW`` greedy tokens served
    continuously from packed codes and by materialize (one row each, so
    the same batches): identical routing at every MoE layer of every
    forward (if any), tokens, and logits within ``LOGIT_RTOL``."""
    import numpy as np

    prompt = np.random.default_rng(23).integers(
        0, model.cfg.vocab, size=n).astype(np.int32)
    got, got_route, t_packed = long_serve(model, params, store, prompt,
                                          "continuous", device)
    want, want_route, t_mat = long_serve(model, params, store, prompt,
                                         "materialize", device)
    flips = routing_flips(got_route, want_route)
    if flips:
        raise AssertionError(f"{label} long prompt: routing flips (layer, "
                             f"token, experts, experts, margin) {flips[:8]}")
    if got.output.tolist() != want.output.tolist():
        raise AssertionError(f"{label} long prompt: tokens {got.output} vs "
                             f"materialize {want.output}")
    scale = float(abs(want.logits).max())
    gap = float(abs(got.logits - want.logits).max())
    if gap > LOGIT_RTOL * scale:
        raise AssertionError(f"{label} long prompt: logits differ by "
                             f"{gap:.3e} > {LOGIT_RTOL:g} x {scale:.3e}")
    log(f"{label} long prompt {time.perf_counter() - t0:.1f}s: {n} tokens + "
        f"{LONG_NEW - 1} decode steps, continuous packed {t_packed:.2f}s, "
        f"materialize {t_mat:.2f}s; "
        + (f"{len(got_route)} routing calls identical; " if got_route
           else "")
        + f"tokens {got.output.tolist()} equal; logits max |diff| "
        f"{gap:.3e} <= {LOGIT_RTOL * scale:.3e}")
    return {"gap": gap, "tol": LOGIT_RTOL * scale}


def attention_check(cfg, n, device):
    """One attention layer of ``cfg`` at full width (its soft-cap
    included), random weights, T = ``n``: the blockwise path (what
    ``gqa_attention`` takes above the threshold) against the plain one
    within ``RTOL`` of max |out|, with the config's window and without,
    and the default path the one the threshold picks. Returns the errors
    by window."""
    import torch
    from repro_torch.models import attention as attn_mod

    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    base, _ = attn_mod.init_gqa(gen, cfg, None, 1)
    base = {k: {"w": v["w"][0]} for k, v in base.items()}
    x = torch.randn((1, n, cfg.d_model), generator=gen, device=device)
    pos = torch.arange(n, device=device)[None]
    res = {}
    for window in (cfg.window, None):
        outs, times = {}, {}
        for name, force in (("plain", False), ("blockwise", True),
                            ("default", None)):
            sync(device)
            t1 = time.perf_counter()
            outs[name] = attn_mod.gqa_attention(
                x, base, None, cfg, positions=pos, window=window,
                force_blockwise=force)
            sync(device)
            times[name] = time.perf_counter() - t1
        path = ("blockwise" if n > attn_mod.BLOCKWISE_THRESHOLD
                else "plain")
        if not torch.equal(outs["default"], outs[path]):
            raise AssertionError(f"T={n}: the default path is not the "
                                 f"{path} one")
        err = (outs["blockwise"] - outs["plain"]).abs().max().item()
        mag = outs["plain"].abs().max().item()
        if not torch.isfinite(outs["blockwise"]).all() or err > RTOL * mag:
            raise AssertionError(f"{cfg.name}: blockwise vs plain attention "
                                 f"(window {window}) at T={n}: max |err| "
                                 f"{err:.3e} > {RTOL:g} x {mag:.3e}")
        log(f"{cfg.name} attention T={n} window {window} soft-cap "
            f"{cfg.attn_softcap}: blockwise == plain within {err:.3e} (<= "
            f"{RTOL:g} x {mag:.3e}); plain {times['plain'] * 1e3:.1f} ms, "
            f"blockwise {times['blockwise'] * 1e3:.1f} ms (host wall, first "
            f"calls)")
        res[f"attn_err_{window}"] = err
        del outs
        if device == "cuda":
            torch.cuda.empty_cache()
    return res


def moe_phases() -> dict:
    """Phases 18-21 in order; returns the MoE kernel's error, its mix per
    launch over mixtral's linears, and the MoE main path's launches."""
    from repro_torch.launch.bench_kernels import MOE_LINEARS

    t0 = time.perf_counter()
    timings, max_err = phase_moe_kernel()
    moe_mix = main_path_mix(timings, MOE_LINEARS)
    log(f"MoE kernel phase {time.perf_counter() - t0:.1f}s; "
        + mix_line("sgmv_fused mixtral main-path", moe_mix))
    t0 = time.perf_counter()
    cont = phase_moe_continuous()
    log(f"MoE continuous phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    parity = phase_moe_parity()
    log(f"MoE parity phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    long = phase_moe_long()
    log(f"MoE long-prompt phase {time.perf_counter() - t0:.1f}s")
    return {"max_err": max_err, "mix": moe_mix, "launches": cont["launches"],
            "parted": cont["parted"], "parted_free": cont["parted_free"],
            "parity_gap": parity["gap"],
            "long_gap": long["gap"]}


# --------------------------------------------------------------------------
# the dense variants (phases 22-27)
# --------------------------------------------------------------------------

DENSE_ARCHS = ("gemma2-2b", "olmo-1b", "internlm2-20b", "qwen2-vl-72b")
MUSICGEN = "musicgen-medium"
# depth on the card, full width: (bf16 serve, fp32 parity). These paths
# are host-bound (~110 launches per layer per forward), so their depth
# sets their time, and the whole script has to stay inside its limit:
# gemma2-2b's bf16 serve keeps its 26 layers (its tokens are held
# bounded == all-resident), the rest are cut. qwen2-vl's 80 layers are
# 1.76 GB each in bf16 beside 5.0 GB of tables (24 would fit the card);
# internlm2's 48 are 37.5 GB in bf16; qwen2-vl's 2 in fp32 are 7.0 GB
# beside 10.0 GB of tables. The CPU rehearsal keeps each smoke config's
# own depth.
DENSE_LAYERS = {"gemma2-2b": (26, 8), "olmo-1b": (16, 8),
                "internlm2-20b": (16, 8), "qwen2-vl-72b": (8, 2)}
MUSIC_LAYERS = 16              # of musicgen's 48, fp32, for time
GEMMA_LONG_LAYERS = 2          # one local/global period
# bf16 logits of the same requests served all-resident and bounded (other
# prefill groups, so other matmul shapes and rounding) differ by ~1 % of
# max |logit| at full width; another adapter moves the fp32 logits by 27 %
# or more (phases 24 and 26). A gap past this bound is no rounding.
BF16_GAP_RTOL = 0.05
MUSIC_ROWS = 16                # musicgen prompts (16, 4, PROMPT)


def linears_of(cfg) -> dict:
    """(K, M) of each LoRA linear of a dense decoder layer."""
    d, dh = cfg.d_model, cfg.resolved_head_dim
    q, kv = cfg.n_heads * dh, cfg.n_kv_heads * dh
    return {"wq": (d, q), "wk": (d, kv), "wv": (d, kv), "wo": (q, d),
            "wg": (d, cfg.d_ff), "wu": (d, cfg.d_ff), "wd": (cfg.d_ff, d)}


def dense_config(arch, dtype, layers=None, preset="full"):
    """``arch`` at full width (or its smoke preset) in ``dtype``, cut to
    ``layers`` (whole periods of its block pattern; None keeps the
    config's depth)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch, preset)
    if layers is None or preset != "full":
        return dataclasses.replace(cfg, dtype=dtype)
    block = cfg.blocks[0]
    if len(cfg.blocks) != 1 or layers % len(block.pattern):
        raise ValueError(f"{arch}: cannot cut {cfg.blocks} to {layers}")
    return dataclasses.replace(
        cfg, n_layers=layers, dtype=dtype,
        blocks=(dataclasses.replace(block,
                                    count=layers // len(block.pattern)),))


def phase_dense_kernel():
    """Phase 22: ``sgmv_fused`` against its plain version (TF32 off) at
    every (K, M) of the five dense variants' LoRA linears, 8 adapters
    ``2@0.9``-like (mixed split h), decode (tile_t 1, 16 rows) and
    prefill (tile_t 8, 512 rows), x bf16; bitwise repeats. Returns the
    timings per case and the largest error."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.bench_kernels import packed_layer, seg_for

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2468)
    shapes = sorted({km for arch in DENSE_ARCHS + (MUSICGEN,)
                     for km in linears_of(get_config(arch)).values()})
    timings, max_err = {}, 0.0
    for k, m in shapes:
        pb = packed_layer(k, m, 2, 128, N_ADAPTERS, seed=k + m + 2)
        for phase, (tile_t, rows) in PHASES.items():
            x = torch.randn(rows, k, generator=gen,
                            device="cuda").to(torch.bfloat16)
            timings[(k, m), phase], err = kernel_case(
                f"dense K={k:5d} M={m:5d} {phase:7s} T={rows:3d} tile_t "
                f"{tile_t}", pb, x, seg_for(phase), tile_t)
            max_err = max(max_err, err)
        del pb
    return timings, max_err


def dense_layers(arch, device):
    return DENSE_LAYERS[arch] if device == "cuda" else (None, None)


def comparable_gap(a, b) -> float:
    """Max |logit| difference of two runs of the same requests over the
    steps whose inputs are still the same: each request's steps up to and
    including the first where its tokens part."""
    import numpy as np

    gap = 0.0
    for r, q in zip(a, b):
        part = np.nonzero(r.output != q.output)[0]
        n = int(part[0]) + 1 if part.size else len(r.output)
        gap = max(gap, float(np.abs(r.logits[:n] - q.logits[:n]).max()))
    return gap


def phase_dense_serve(arch, device="cuda", preset="full"):
    """Phases 23 and 26 (bf16): ``arch`` at full width through
    :func:`bounded_serve` (one ``sgmv_fused`` per LoRA linear per layer
    per live pool per forward). gemma2-2b's bounded tokens must equal the
    all-resident ones; for the others, whose bf16 logits round
    differently in differently shaped prefill groups, the requests that
    part are reported, and the two runs' logits on the steps before they
    part must stay within ``BF16_GAP_RTOL`` of max |logit|. The bounded
    run is the slice's main path."""
    import torch

    cfg = dense_config(arch, torch.bfloat16, dense_layers(arch, device)[0],
                       preset)
    layers = cfg.total_layers()
    t0 = time.perf_counter()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    model, params, store = fleet_of(cfg, device)
    sync(device)
    weights = sum(t.nbytes for t in iter_tensors(params["base"]))
    peak = (f", peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
            if device == "cuda" else "")
    log(f"{arch}: bf16 model ({layers} layers, {weights / 1e9:.2f} GB of "
        f"base weights) and 8 adapters in {time.perf_counter() - t0:.1f}s"
        f"{peak}")
    res = bounded_serve(f"{arch} bf16", model, params, store, cfg.vocab,
                        device, layers * len(LINEARS), keep_logits=True)
    resident, bounded = res.pop("resident"), res.pop("bounded")
    if arch == "gemma2-2b":
        same_tokens(resident, bounded,
                    f"{arch} bf16 bounded vs all-resident continuous")
    scale = max(float(abs(r.logits).max()) for r in resident)
    gap = comparable_gap(resident, bounded)
    if gap > BF16_GAP_RTOL * scale:
        raise AssertionError(f"{arch} bf16 all-resident vs bounded logits "
                             f"differ by {gap:.3e} > {BF16_GAP_RTOL:g} x "
                             f"{scale:.3e} before their tokens part")
    log(f"{arch} continuous bf16: requests whose tokens part from the "
        f"all-resident serve's: {res['parted']}; bf16 logit gap of the two "
        f"runs on the steps before they part {gap:.3e} ({gap / scale:.2e} "
        f"of max|logit| {scale:.3e})")
    res.update(layers=layers, bf16_gap=gap / scale)
    del model, params, store, resident, bounded
    if device == "cuda":
        torch.cuda.empty_cache()
    return res


def phase_dense_parity(arch, device="cuda", preset="full"):
    """Phases 24 and 26 (fp32): ``arch`` at full width, cut to its parity
    depth: :func:`fp32_parity` (bounded continuous == materialize, the
    shifted-adapter control)."""
    import torch

    t0 = time.perf_counter()
    cfg = dense_config(arch, torch.float32, dense_layers(arch, device)[1],
                       preset)
    model, params, store = fleet_of(cfg, device)
    ids, prompts = zipf_stream(cfg.vocab)
    res = fp32_parity(f"{arch} ({cfg.total_layers()} layers)", model,
                      params, store, ids, prompts, cfg.vocab, device, t0,
                      per_forward=cfg.total_layers() * len(LINEARS))
    res["layers"] = cfg.total_layers()
    del model, params, store
    if device == "cuda":
        torch.cuda.empty_cache()
    return res


def phase_gemma_long(device="cuda", preset="full"):
    """Phase 25: gemma2-2b at full width, one local/global period, fp32:
    one request of ``LONG_PROMPT`` tokens (past the 4096-token window and
    the blockwise threshold; the local layer's cache a ring of 4096 slots,
    the global layer's the whole prompt) and 4 decode steps, continuous
    packed == materialize; then one gemma2 attention layer (soft-cap 50)
    at T = ``LONG_PROMPT``: blockwise == plain, with the window and
    without."""
    import torch

    t0 = time.perf_counter()
    cfg = dense_config("gemma2-2b", torch.float32,
                       GEMMA_LONG_LAYERS if device == "cuda" else None,
                       preset)
    model, params, store = fleet_of(cfg, device)
    n = LONG_PROMPT if preset == "full" else 3 * cfg.window + 5
    res = long_parity("gemma2", model, params, store, n, device, t0)
    del model, params, store
    if device == "cuda":
        torch.cuda.empty_cache()
    res.update(attention_check(cfg, n, device))
    return res


def music_greedy(model, base, lora_pre, lora_dec, prompts, device):
    """musicgen through ``Model.prefill`` / ``decode_step``: ``(B, K, T)``
    prompts, greedy per codebook to ``MAX_NEW`` frames. Returns the frames
    ``(B, K, MAX_NEW)``, the prefill logits ``(B, K, T, V)`` and each
    decode step's ``(B, K, V)``, fp32."""
    import torch

    b, _, t = prompts.shape
    logits, caches = model.prefill({"base": base, "lora": lora_pre},
                                   {"tokens": prompts}, t + MAX_NEW)
    pre = logits.float()
    last = logits[..., -1, :].argmax(-1)                  # (B, K)
    outs, steps = [last], []
    for k in range(MAX_NEW - 1):
        pos = torch.full((b,), t + k, dtype=torch.int64, device=device)
        logits, caches = model.decode_step(
            {"base": base, "lora": lora_dec}, last[..., None], caches, pos)
        steps.append(logits[..., -1, :].float())
        last = logits[..., -1, :].argmax(-1)
        outs.append(last)
    return torch.stack(outs, -1), pre, torch.stack(steps, 1)


def phase_musicgen(device="cuda", preset="full"):
    """Phase 27: musicgen-medium at full width, ``MUSIC_LAYERS`` layers,
    fp32, at the model level: 8 adapters ``2@0.9`` as one ``PackedLoRABatch``
    (row r meets adapter r mod 8), ``(16, 4, 32)`` prompts, prefill and 7
    greedy decode steps of ``(16, 4, 1)`` frames: exactly L x 7
    ``sgmv_fused`` per forward; frames identical to materialize (each
    adapter's rows through its dequantized fp factors), the prefill logits
    ``(16, 4, 32, V)`` and every step's within ``LOGIT_RTOL``; a control
    in which every row meets another adapter moves them by
    ``CONTROL_MARGIN`` tolerances. The serve driver refuses the arch
    (ROADMAP C8)."""
    import numpy as np
    import torch
    from repro_torch.kernels.quant_matmul import (reset_launch_counts,
                                                   retile_packed)
    from repro_torch.launch import serve as serve_mod
    from repro_torch.serving.engine import SEG_TILE

    t0 = time.perf_counter()
    cfg = dense_config(MUSICGEN, torch.float32,
                       MUSIC_LAYERS if device == "cuda" else None, preset)
    model, params, store = fleet_of(cfg, device)
    base = params["base"]
    ids = [f"user_{i}" for i in range(N_ADAPTERS)]
    prompts = torch.as_tensor(np.random.default_rng(29).integers(
        0, cfg.vocab, (MUSIC_ROWS, cfg.n_codebooks, PROMPT)), device=device)
    packed = store.pack_batch(ids, params["lora"], tile_t=SEG_TILE)
    dec_groups = retile_packed(packed, 1)["groups"]
    per_forward = cfg.total_layers() * len(LINEARS)

    def packed_run(shift):
        aidx = ((torch.arange(MUSIC_ROWS, device=device) + shift)
                % N_ADAPTERS).to(torch.int32)
        pre = {"groups": packed["groups"],
               "seg": aidx.repeat_interleave(PROMPT)}
        dec = {"groups": dec_groups, "seg": aidx}
        sync(device)
        reset_launch_counts()
        t1 = time.perf_counter()
        out = music_greedy(model, base, pre, dec, prompts, device)
        sync(device)
        dt = time.perf_counter() - t1
        counts = launch_counts(device)
        want = {"sgmv_fused": per_forward * MAX_NEW}
        if counts != want:
            raise AssertionError(f"musicgen packed launched {counts}, want "
                                 f"{want} ({cfg.total_layers()} layers x "
                                 f"{len(LINEARS)} linears x {MAX_NEW} "
                                 f"forwards)")
        return out, dt

    (frames, pre, steps), dt = packed_run(0)
    if (frames.shape != (MUSIC_ROWS, cfg.n_codebooks, MAX_NEW)
            or not torch.isfinite(pre).all()
            or not ((frames >= 0) & (frames < cfg.vocab)).all()):
        raise AssertionError(f"musicgen frames {tuple(frames.shape)}")
    # materialize: each adapter's rows through its dequantized fp factors
    m_frames, m_pre, m_steps = (torch.empty_like(frames),
                                torch.empty_like(pre),
                                torch.empty_like(steps))
    sync(device)
    reset_launch_counts()
    for a, aid in enumerate(ids):
        rows = torch.arange(a, MUSIC_ROWS, N_ADAPTERS, device=device)
        lora = store.materialize(aid, params["lora"])
        f, p, st = music_greedy(model, base, lora, lora, prompts[rows],
                                device)
        m_frames[rows], m_pre[rows], m_steps[rows] = f, p, st
    if launch_counts(device):
        raise AssertionError(f"materialize launched "
                             f"{launch_counts(device)}")
    if not torch.equal(frames, m_frames):
        diff = (frames != m_frames).any(-1).any(-1).nonzero().flatten()
        raise AssertionError(f"musicgen packed vs materialize frames differ "
                             f"for rows {diff.tolist()}")
    scale = max(pre.abs().max().item(), steps.abs().max().item())
    tol = LOGIT_RTOL * scale
    gap = max((pre - m_pre).abs().max().item(),
              (steps - m_steps).abs().max().item())
    if gap > tol:
        raise AssertionError(f"musicgen packed vs materialize logits differ "
                             f"by {gap:.3e} > {LOGIT_RTOL:g} x {scale:.3e}")
    (_, c_pre, _), _ = packed_run(1)
    moved = (c_pre - pre).abs().amax(dim=(1, 2, 3))          # per row
    if moved.min().item() < CONTROL_MARGIN * tol:
        raise AssertionError(f"musicgen: another adapter moves the prefill "
                             f"logits by only {moved.tolist()}, under "
                             f"{CONTROL_MARGIN} x {tol:.3e}")
    try:
        serve_mod.main(["--arch", MUSICGEN, "--preset", preset])
    except ValueError as e:
        if "C8" not in str(e):
            raise
    else:
        raise AssertionError("serve.py --arch musicgen-medium served")
    log(f"musicgen ({cfg.total_layers()} layers, model level) "
        f"{time.perf_counter() - t0:.1f}s: packed prefill + {MAX_NEW - 1} "
        f"decode steps of {MUSIC_ROWS} x {cfg.n_codebooks} frames in "
        f"{dt:.3f}s ({MUSIC_ROWS * MAX_NEW / dt:.1f} frames/s), "
        f"{per_forward * MAX_NEW} sgmv_fused launches; frames == "
        f"materialize; logits (prefill {tuple(pre.shape)} and every step) "
        f"max |diff| {gap:.3e} <= {tol:.3e}; another adapter moves every "
        f"row by {moved.min().item():.3e} to {moved.max().item():.3e}; the "
        f"serve driver refuses the arch (C8)")
    res = {"launches": per_forward * MAX_NEW, "gap": gap, "tol": tol,
           "frames_s": MUSIC_ROWS * MAX_NEW / dt}
    del model, params, store, packed, dec_groups
    if device == "cuda":
        torch.cuda.empty_cache()
    return res


def dense_phases() -> dict:
    """Phases 22-27 in order; returns the kernel's error at the dense
    shapes, its mix per launch over each model's linears, and each model's
    numbers (gemma2's bounded serve is the slice's main path)."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    timings, max_err = phase_dense_kernel()
    mixes = {a: main_path_mix(timings, linears_of(get_config(a)))
             for a in DENSE_ARCHS + (MUSICGEN,)}
    log(f"dense kernel phase {time.perf_counter() - t0:.1f}s; "
        + "; ".join(mix_line(f"sgmv_fused {a} main-path", x)
                    for a, x in mixes.items()))
    out = {"max_err": max_err, "mix": mixes, "serve": {}, "parity": {}}
    for arch in DENSE_ARCHS:
        t0 = time.perf_counter()
        out["serve"][arch] = phase_dense_serve(arch)
        log(f"{arch} serve phase {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        out["parity"][arch] = phase_dense_parity(arch)
        log(f"{arch} parity phase {time.perf_counter() - t0:.1f}s")
        if arch == "gemma2-2b":
            t0 = time.perf_counter()
            out["long"] = phase_gemma_long()
            log(f"gemma2 long-prompt phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    out["musicgen"] = phase_musicgen()
    log(f"musicgen phase {time.perf_counter() - t0:.1f}s")
    return out


# --------------------------------------------------------------------------
# training and the paper's Table 1 (phases 28-30)
# --------------------------------------------------------------------------

# launch/train.py's defaults at --preset full (remat on), with 2
# microbatches; the LoRA task of benchmarks/common.py's trained_setup
TRAIN_STEPS = 20
TRAIN_BATCH = 8
TRAIN_SEQ = 128
TRAIN_MICRO = 2
TRAIN_LR = 2e-4
TASK_B_SEED = 101
EVAL_STEP0 = 10_000            # eval_loss's held-out steps
EVAL_BATCHES = 8
# fp32 depth of the microbatch check (phase 28) and of the eval from packed
# codes (phase 30), full width: 4 layers are 1.6 GB beside 3.2 GB of tables
FP32_LAYERS = 4
# one step with 2 microbatches against one with 1: loss and gradients
# within this fraction of their max |value| (fp32 sums in other orders)
MICRO_RTOL = 1e-5
PROFILED_STEP = 5


def table1_methods() -> dict:
    """``benchmarks/common.py``'s ``make_method_table`` on the port, one
    layer stack per call: name → ``fn(b (L, m, r), a (L, r, n)) -> (b', a',
    total_bits, n_params)``, the factors dequantized to their shapes. The
    per-matrix baselines run per layer (their bits are per matrix); GPTQ,
    PB-LLM and BiLLM take the whole stack; LoRAQuant runs its layer-stack
    pipeline (per layer the math of ``quantize_lora``, ``ste_steps=60``)."""
    import torch
    from repro_torch.core import LoRAQuantConfig, quantize_lora_stack
    from repro_torch.core.baselines import (billm_lora, bin_lora, gptq_lora,
                                            pbllm_lora, rtn_lora)

    def fp16(b, a):
        return b, a, float((b.numel() + a.numel()) * 16), b.numel() + a.numel()

    def per_layer(callable_, *args):
        def fn(b, a):
            qps = [callable_(b[i], a[i], *args) for i in range(b.shape[0])]
            return (torch.stack([q.b_deq for q in qps]),
                    torch.stack([q.a_deq for q in qps]),
                    sum(q.total_bits for q in qps),
                    sum(q.num_params for q in qps))
        return fn

    def stacked(callable_, *args):
        def fn(b, a):
            qp = callable_(b, a, *args)
            return qp.b_deq, qp.a_deq, qp.total_bits, qp.num_params
        return fn

    def lq(bits_high, rho, refine="ste"):
        cfg = LoRAQuantConfig(rho=rho, bits_high=bits_high, refine=refine,
                              ste_steps=60)

        def fn(b, a):
            qls = quantize_lora_stack(b, a, cfg)
            mats = [q.materialize() for q in qls]
            return (torch.stack([m[0] for m in mats]),
                    torch.stack([m[1] for m in mats]),
                    sum(q.total_bits() for q in qls),
                    sum(q.num_params() for q in qls))
        fn.config = cfg
        return fn

    return {
        "fp16": fp16,
        "bin": per_layer(bin_lora),
        "rtn1": per_layer(rtn_lora, 1),
        "rtn2": per_layer(rtn_lora, 2),
        "gptq2": stacked(gptq_lora, 2),
        "pbllm": stacked(pbllm_lora),
        "billm": stacked(billm_lora),
        "loraquant_2@0.8": lq(2, 0.8),
        "loraquant_2@0.9": lq(2, 0.9),
        "loraquant_3@0.8": lq(3, 0.8),
        "loraquant_3@0.9": lq(3, 0.9),
        "loraquant_2@0.9_als": lq(2, 0.9, refine="als"),
        "loraquant_3@0.9_als": lq(3, 0.9, refine="als"),
    }


def expected_bits(name, m, n, r, hs=None, sal=None) -> int:
    """The reference's bit accounting for one ``(m, r) x (r, n)`` adapter
    (LoRAQuant: per layer split ``hs``; PB-LLM: the salient counts ``sal``
    of Bᵀ and A, which pass 10 % where magnitudes tie at the threshold),
    written out from
    ``core/baselines.py`` and ``core/quant.storage_bits``: codes, a 16-bit
    scale per group, a ``bits``-wide zero per RTN group, PB-LLM's
    indicator bits and 8-bit salient grid, BiLLM's residual columns, two
    row scales per part and column indices. Groups run along m for B and
    along n for A (128 wide)."""
    import math

    def cdiv(x, y):
        return -(-x // y)

    groups = r * (cdiv(m, min(128, m)) + cdiv(n, min(128, n)))
    if name == "fp16":
        return 16 * r * (m + n)
    if name == "bin":
        return r * (m + n) + groups * 16
    if name.startswith("rtn"):
        b = int(name[3:])
        return r * (m + n) * b + groups * (16 + b)
    if name == "gptq2":          # B (m, r): m rows of one group each
        return r * (m + n) * 2 + (m * cdiv(r, min(128, r)) + r * cdiv(
            n, min(128, n))) * 18
    if name == "pbllm":          # B as Bᵀ (r, m) and A (r, n)
        total = 0
        for cols, n_sal in zip((m, n), sal):
            size, g = r * cols, r * cdiv(cols, min(128, cols))
            total += n_sal * 8 + (size - n_sal) + size + g * 24 + g * 16
        return total
    if name == "billm":
        total = 0
        for cols in (m, n):
            k = max(1, int(round(0.1 * cols)))
            total += (r * k * 2 + r * 32 + r * (cols - k) * 2 + r * 32
                      + k * math.ceil(math.log2(max(cols, 2))))
        return total
    bits = int(name.split("_")[1].split("@")[0])
    per = cdiv(m, min(128, m)) + cdiv(n, min(128, n))
    hi = (m + n) * bits + per * (16 + bits)
    lo = (m + n) + per * 16
    return sum(h * hi + (r - h) * lo for h in hs)


def salient_count(w, frac: float = 0.1) -> int:
    """PB-LLM's salient entries of one matrix: those whose |w| reaches the
    ``frac``-th largest magnitude."""
    import torch

    aw = w.abs().flatten()
    k = max(1, int(round(frac * aw.numel())))
    return int((aw >= torch.sort(aw, descending=True).values[k - 1]).sum())


def leaf_paths(tree, is_leaf):
    """``(path, leaf)`` for every node of a tree of dicts / lists that
    ``is_leaf`` accepts."""
    if is_leaf(tree):
        return [((), tree)]
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, list) else ())
    return [((k,) + p, leaf) for k, v in items
            for p, leaf in leaf_paths(v, is_leaf)]


def lora_paths(lora):
    """``(path, leaf)`` for every ``{'a', 'b'}`` leaf of a LoRA tree."""
    return leaf_paths(lora, lambda n: isinstance(n, dict)
                      and set(n) == {"a", "b"})


def replace_leaves(tree, new: dict):
    """``tree`` with the leaves at the paths of ``new`` replaced."""
    if not new:
        return tree
    heads = {}
    for path, v in new.items():
        if not path:
            return v
        heads.setdefault(path[0], {})[path[1:]] = v
    if isinstance(tree, list):
        return [replace_leaves(v, heads.get(i, {}))
                for i, v in enumerate(tree)]
    return {k: replace_leaves(v, heads.get(k, {})) for k, v in tree.items()}


def per_layer_groups(cfg, params):
    """The same model with every layer its own group of one: config blocks
    of ``count=1`` and params re-grouped (views). LoRAQuant picks the split
    h per layer, and a layer-stacked ``QuantizedLoRA`` leaf (applied
    straight from its codes by ``fused_lora``) needs one h over its stack,
    as the reference's layer scan does; a group of one holds any h."""
    import dataclasses

    from repro_torch.optim.adamw import tree_map

    blocks = tuple(dataclasses.replace(b, count=1) for b in cfg.blocks
                   for _ in range(b.count))

    def regroup(groups):
        return [tree_map(lambda t: t[i:i + 1], g)
                for g, blk in zip(groups, cfg.blocks)
                for i in range(blk.count)]

    out = {"base": dict(params["base"],
                        groups=regroup(params["base"]["groups"])),
           "lora": {"groups": regroup(params["lora"]["groups"])}}
    return dataclasses.replace(cfg, blocks=blocks), out


def quantized_groups(cfg, lora, grouped, config):
    """LoRAQuant ``config`` over every leaf of ``lora`` (layer stacks under
    ``cfg``'s groups; one ``quantize_lora_stack`` per stack, so per layer
    the math of ``quantize_lora``), laid out as ``grouped`` (the
    :func:`per_layer_groups` tree): each layer's leaf a one-layer stacked
    ``QuantizedLoRA``."""
    from repro_torch.core import quantize_lora_stack

    first = [sum(b.count for b in cfg.blocks[:gi])
             for gi in range(len(cfg.blocks))]
    new = {}
    for path, leaf in lora_paths(lora):
        qls = quantize_lora_stack(leaf["b"], leaf["a"], config)
        for li, q in enumerate(qls):
            new[("groups", first[path[1]] + li) + path[2:]] = stack_layers(
                [q])
    return replace_leaves(grouped, new)


def materialized_tree(lora):
    """Every ``QuantizedLoRA`` leaf of a tree as its dequantized fp
    ``{'a', 'b'}`` factors (the benchmark's route)."""
    from repro_torch.core import QuantizedLoRA

    if isinstance(lora, QuantizedLoRA):
        b, a = lora.materialize()
        return {"a": a, "b": b}
    if isinstance(lora, dict):
        return {k: materialized_tree(v) for k, v in lora.items()}
    if isinstance(lora, list):
        return [materialized_tree(v) for v in lora]
    return lora


def train_batch(dc, step, device):
    import torch
    from repro_torch.data import make_batch

    return {k: torch.from_numpy(v).to(device)
            for k, v in make_batch(dc, step).items()}


def mean_ce(model, params, dc, steps, device):
    """Mean CE of ``model`` over the batches of ``steps`` (no autograd)."""
    from repro_torch.launch.step import make_eval_step

    ev = make_eval_step(model)
    return sum(float(ev(params, train_batch(dc, s, device))["ce"])
               for s in steps) / len(steps)


def fp32_cut(cfg, params, layers):
    """The first ``layers`` layers of ``params`` and the tables in fp32 (a
    bf16 value is exact in fp32), with the config cut to match."""
    import dataclasses

    import torch
    from repro_torch.optim.adamw import tree_map

    f32 = lambda t: t[:layers].to(torch.float32)
    base = {k: (v if k == "groups" else tree_map(
        lambda t: t.to(torch.float32), v)) for k, v in params["base"].items()}
    base["groups"] = [tree_map(f32, params["base"]["groups"][0])]
    lora = {"groups": [tree_map(f32, params["lora"]["groups"][0])]}
    block = dataclasses.replace(cfg.blocks[0], count=layers)
    return (dataclasses.replace(cfg, dtype=torch.float32, n_layers=layers,
                                blocks=(block,)),
            {"base": base, "lora": lora})


def phase_train(device="cuda", preset="full"):
    """Phase 28: the LoRA train step of llama3.2-3b at full width and depth
    (bf16 frozen base, fp32 LoRA of rank 16 on the 7 linears of every
    layer), ``make_train_step`` with ``remat``, batch 8 x 128, 2
    microbatches, lr 2e-4, ``TRAIN_STEPS`` steps on task B. Holds finite
    losses and grad norms, a lower CE on the trained batches after
    training, and, in fp32 at ``FP32_LAYERS`` layers, 2 microbatches == 1.
    Returns the trained model, params and numbers."""
    import math

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.launch.step import _lora_grads, make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import OptimizerConfig, init_opt_state
    from repro_torch.optim.adamw import tree_leaves

    t0 = time.perf_counter()
    cfg = get_config("llama3.2-3b", preset)
    model = build_model(cfg, remat=True)
    params = model.init(seed=0, device=device)
    sync(device)
    log(f"train phase: {cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}, "
        f"vocab {cfg.vocab}) bf16 base, fp32 LoRA rank {cfg.lora_rank}, in "
        f"{time.perf_counter() - t0:.1f}s")
    dc = DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                    vocab=cfg.vocab, seed=TASK_B_SEED)
    trained = range(TRAIN_STEPS)
    held = range(EVAL_STEP0, EVAL_STEP0 + EVAL_BATCHES)
    ce0 = mean_ce(model, params, dc, trained, device)
    held0 = mean_ce(model, params, dc, held, device)

    opt_cfg = OptimizerConfig(lr=TRAIN_LR, total_steps=TRAIN_STEPS)
    step_fn = make_train_step(model, opt_cfg, TRAIN_MICRO)
    opt = init_opt_state(params["lora"])
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    curve, times, window = [], [], None
    for step in trained:
        batch = train_batch(dc, step, device)
        sync(device)
        t1 = time.perf_counter()
        if step == PROFILED_STEP and device == "cuda":
            (params, opt, m), window = profile_step(
                lambda: step_fn(params, opt, batch))
        else:
            params, opt, m = step_fn(params, opt, batch)
            sync(device)
            times.append(time.perf_counter() - t1)
        row = {k: float(v) for k, v in m.items()}
        if not all(math.isfinite(v) for v in row.values()):
            raise AssertionError(f"train step {step}: {row}")
        curve.append(row)
    peak = (torch.cuda.max_memory_allocated() / 2**30 if device == "cuda"
            else None)
    ce1 = mean_ce(model, params, dc, trained, device)
    held1 = mean_ce(model, params, dc, held, device)
    if not ce1 < ce0:
        raise AssertionError(f"training did not lower the CE of its own "
                             f"batches: {ce0:.4f} -> {ce1:.4f}")
    step_s = sorted(times)[len(times) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log("train loss curve (step: loss / grad norm / lr): " + ", ".join(
        f"{i}: {r['loss']:.4f}/{r['grad_norm']:.3f}/{r['lr']:.2e}"
        for i, r in enumerate(curve)))
    log(f"train: {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens "
        f"in {TRAIN_MICRO} microbatches, remat; median step "
        f"{step_s * 1e3:.1f} ms ({tokens / step_s:.0f} tokens/s), min "
        f"{min(times) * 1e3:.1f} ms; peak device memory "
        + (f"{peak:.2f} GiB" if peak is not None else "not measured")
        + f"; CE of the trained batches {ce0:.4f} -> {ce1:.4f}; held-out CE "
        f"(steps {EVAL_STEP0}+) {held0:.4f} -> {held1:.4f}")
    if window is not None:
        log(window_line("train", {"window": window,
                                  "unprofiled_ms": step_s * 1e3},
                        what="train-step"))

    # 2 microbatches == 1, fp32, the trained adapter at FP32_LAYERS layers
    t1 = time.perf_counter()
    cut = FP32_LAYERS if device == "cuda" else cfg.n_layers
    cfg32, p32 = fp32_cut(cfg, params, cut)
    model32 = build_model(cfg32, remat=True)
    batch = train_batch(dc, 0, device)
    l1, _, g1 = _lora_grads(model32, p32, batch, 1)
    l2, _, g2 = _lora_grads(model32, p32, batch, TRAIN_MICRO)
    loss_gap = abs(float(l1) - float(l2))
    if loss_gap > MICRO_RTOL * abs(float(l1)):
        raise AssertionError(f"fp32 loss with {TRAIN_MICRO} microbatches "
                             f"{float(l2)} != one batch {float(l1)}")
    grad_gap = 0.0
    for x, y in zip(tree_leaves(g1), tree_leaves(g2)):
        gap = float((x - y).abs().max()) / max(float(x.abs().max()), 1e-30)
        if not gap <= MICRO_RTOL:
            raise AssertionError(f"fp32 gradients with {TRAIN_MICRO} "
                                 f"microbatches differ by {gap:.3e} of "
                                 f"max |grad| > {MICRO_RTOL:g}")
        grad_gap = max(grad_gap, gap)
    log(f"train fp32 at {cut} layers ({time.perf_counter() - t1:.1f}s): "
        f"{TRAIN_MICRO} microbatches == 1 batch: loss {float(l1):.6f} (gap "
        f"{loss_gap:.3e}), gradients within {grad_gap:.3e} of max |grad| "
        f"(tolerance {MICRO_RTOL:g})")
    del p32, g1, g2, model32
    return model, params, {
        "step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
        "peak_gib": peak, "ce": (ce0, ce1), "held": (held0, held1),
        "window": window, "curve": curve, "dc": dc}


def phase_table1(model, params, dc, device="cuda"):
    """Phase 29: the trained adapter quantized by every row of Table 1
    (``table1_methods``): AvgBits, held-out CE (``eval_loss``'s batches)
    and quantize time per row. Holds the fp16 row's CE equal to the
    unquantized adapter's, every row's bits equal to ``expected_bits`` and
    LoRAQuant 2@0.9 under 2 bits."""
    import torch
    from repro_torch.core import select_h, svd_reparam_stack

    held = range(EVAL_STEP0, EVAL_STEP0 + EVAL_BATCHES)
    base_ce = mean_ce(model, params, dc, held, device)
    leaves = lora_paths(params["lora"])
    rows = {}
    for name, fn in table1_methods().items():
        sync(device)
        t0 = time.perf_counter()
        new, bits, n, want = {}, 0.0, 0, 0
        for path, leaf in leaves:
            b, a = leaf["b"], leaf["a"]
            bq, aq, tb, tn = fn(b, a)
            new[path] = {"a": aq.to(a.dtype), "b": bq.to(b.dtype)}
            bits += tb
            n += tn
            L, m, r = b.shape
            n_in = a.shape[-1]
            if name.startswith("loraquant"):
                s = svd_reparam_stack(b, a).s
                want += expected_bits(name, m, n_in, r, hs=[
                    select_h(s[i], fn.config.rho) for i in range(L)])
            elif name == "pbllm":
                want += sum(expected_bits(name, m, n_in, r, sal=(
                    salient_count(b[i].mT), salient_count(a[i])))
                    for i in range(L))
            else:
                want += L * expected_bits(name, m, n_in, r)
        sync(device)
        q_s = time.perf_counter() - t0
        if bits != want:
            raise AssertionError(f"{name}: {bits} bits, the reference's "
                                 f"accounting gives {want}")
        qp = {"base": params["base"],
              "lora": replace_leaves(params["lora"], new)}
        ce = mean_ce(model, qp, dc, held, device)
        rows[name] = {"avg_bits": bits / n, "ce": ce, "quantize_s": q_s}
        log(f"table1 {name:20s} AvgBits {bits / n:.4f}  held-out CE "
            f"{ce:.4f}  quantize {q_s:.2f}s")
        del qp, new
    if rows["fp16"]["ce"] != base_ce:
        raise AssertionError(f"fp16 row CE {rows['fp16']['ce']} != the "
                             f"unquantized adapter's {base_ce}")
    if not rows["loraquant_2@0.9"]["avg_bits"] < 2.0:
        raise AssertionError(f"LoRAQuant 2@0.9 at "
                             f"{rows['loraquant_2@0.9']['avg_bits']} bits")
    order = sorted(rows, key=lambda k: rows[k]["ce"])
    log(f"table1: fp16 CE == unquantized {base_ce:.4f}; LoRAQuant 2@0.9 "
        f"{rows['loraquant_2@0.9']['avg_bits']:.4f} < 2 bits; every AvgBits "
        f"== the reference's accounting; CE order (random base, reported, "
        f"not held): {' < '.join(order)}")
    return rows


def expected_launches(qlora_tree, rows: int) -> dict:
    """The reference's launch rule for a forward of ``rows`` token rows
    over per-layer ``QuantizedLoRA`` leaves (``lora_apply_quantized``):
    one ``fused_lora`` per leaf, or, where ``_fused_vmem_estimate`` at its
    token tile crosses the budget, one ``matmul_rhs`` + ``matmul_out`` per
    sub-LoRA."""
    from repro_torch.core import QuantizedLoRA
    from repro_torch.kernels.quant_matmul import ops
    from repro_torch.models.model import _layer_slice

    want = {}

    def add(k, n):
        want[k] = want.get(k, 0) + n

    for _, leaf in leaf_paths(qlora_tree,
                              lambda n: isinstance(n, QuantizedLoRA)):
        q = _layer_slice(leaf, 0)
        tt = min(128, rows)
        tk = ops._pick_tile(q.a_high.orig_shape[1], q.a_high.group_size)
        if ops._fused_vmem_estimate(q, tt, tk) > ops.FUSED_VMEM_BUDGET:
            sides = 1 if q.a_low is None else 2
            add("matmul_rhs", sides)
            add("matmul_out", sides)
        else:
            add("fused_lora", 1)
    return want


def packed_eval(model, params, lora, batch, device):
    """``(logits, ce, launches)`` of one forward with ``lora`` in place of
    the params' LoRA tree, launches counted from 0."""
    import torch
    from repro_torch.kernels.quant_matmul import reset_launch_counts

    reset_launch_counts()
    with torch.no_grad():
        p = {"base": params["base"], "lora": lora}
        logits, _ = model.forward(p, batch)
        _, m = model.train_loss(p, batch)
    sync(device)
    return logits, float(m["ce"]), launch_counts(device)


def phase_eval_packed(model, params, dc, device="cuda"):
    """Phase 30: the trained adapter, LoRAQuant ``2@0.9``, evaluated
    straight from its packed codes (every leaf a one-layer stacked
    ``QuantizedLoRA``, each layer its own group: ``fused_lora``, or the
    two-pass pair where the reference's guard says so) against the same
    codes materialized. fp32 at ``FP32_LAYERS`` layers: logits within
    ``LOGIT_RTOL`` of max |logit|, a ``3@0.9`` control moving them by
    ``CONTROL_MARGIN`` tolerances, launches == the reference's rule for both
    the forward and the loss. bf16 at full depth: both held-out CEs
    reported; returns that run's launches (the kernels line's)."""
    import torch
    from repro_torch.core import LoRAQuantConfig
    from repro_torch.kernels.quant_matmul import reset_launch_counts
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    cfg = model.cfg
    cut = FP32_LAYERS if device == "cuda" else cfg.n_layers
    cfg32, p32 = fp32_cut(cfg, params, cut)
    gcfg, gp = per_layer_groups(cfg32, p32)
    m32 = build_model(gcfg)
    batch = train_batch(dc, EVAL_STEP0, device)
    rows = batch["tokens"].numel()
    lq = quantized_groups(cfg32, p32["lora"], gp["lora"], LoRAQuantConfig(
        rho=0.9, bits_high=2, ste_steps=60))
    ctrl = quantized_groups(cfg32, p32["lora"], gp["lora"], LoRAQuantConfig(
        rho=0.9, bits_high=3, ste_steps=60))
    want = {k: 2 * v for k, v in expected_launches(lq, rows).items()}
    got_l, got_ce, counts = packed_eval(m32, gp, lq, batch, device)
    if counts != want:
        raise AssertionError(f"fp32 eval from codes launched {counts}, the "
                             f"reference's rule gives {want}")
    mat_l, mat_ce, mat_counts = packed_eval(m32, gp, materialized_tree(lq),
                                            batch, device)
    if mat_counts:
        raise AssertionError(f"materialized eval launched {mat_counts}")
    ctl_l, _, _ = packed_eval(m32, gp, ctrl, batch, device)
    scale = float(mat_l.abs().max())
    tol = LOGIT_RTOL * scale
    gap = float((got_l - mat_l).abs().max())
    moved = float((ctl_l - mat_l).abs().max())
    if not torch.isfinite(got_l).all() or gap > tol:
        raise AssertionError(f"eval from codes vs materialize: logits "
                             f"differ by {gap:.3e} > {tol:.3e}")
    if moved < CONTROL_MARGIN * tol:
        raise AssertionError(f"the 3@0.9 control moves the logits by only "
                             f"{moved:.3e} < {CONTROL_MARGIN} x {tol:.3e}")
    log(f"eval from packed codes, fp32 at {cut} layers "
        f"({time.perf_counter() - t0:.1f}s): {rows} rows, launches {counts} "
        f"(forward + loss) == the reference's rule; logits max |diff| "
        f"{gap:.3e} <= {tol:.3e} ({LOGIT_RTOL:g} x max|logit| {scale:.3e}); "
        f"CE {got_ce:.6f} vs materialized {mat_ce:.6f}; the 3@0.9 control "
        f"moves them by {moved:.3e}")
    del p32, gp, lq, ctrl, got_l, mat_l, ctl_l, m32

    # bf16, full depth: held-out CE from codes and materialized
    t0 = time.perf_counter()
    gcfg, gp = per_layer_groups(cfg, params)
    mb = build_model(gcfg)
    lq = quantized_groups(cfg, params["lora"], gp["lora"], LoRAQuantConfig(
        rho=0.9, bits_high=2, ste_steps=60))
    held = range(EVAL_STEP0, EVAL_STEP0 + EVAL_BATCHES)
    per_batch = expected_launches(lq, rows)
    reset_launch_counts()
    ce_codes = mean_ce(mb, {"base": gp["base"], "lora": lq}, dc, held,
                       device)
    sync(device)
    launches = launch_counts(device)
    want = {k: v * EVAL_BATCHES for k, v in per_batch.items()}
    if launches != want:
        raise AssertionError(f"bf16 eval from codes launched {launches}, "
                             f"want {want}")
    ce_mat = mean_ce(mb, {"base": gp["base"],
                          "lora": materialized_tree(lq)}, dc, held, device)
    log(f"eval from packed codes, bf16 at {cfg.n_layers} layers "
        f"({time.perf_counter() - t0:.1f}s): held-out CE from codes "
        f"{ce_codes:.4f}, materialized {ce_mat:.4f}; launches {launches} "
        f"({EVAL_BATCHES} forwards)")
    return {"launches": launches, "ce_codes": ce_codes, "ce_mat": ce_mat,
            "gap": gap}


def train_phases(device="cuda", preset="full") -> dict:
    """Phases 28-30 in order."""
    import torch

    t0 = time.perf_counter()
    model, params, train = phase_train(device, preset)
    log(f"train phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    table = phase_table1(model, params, train["dc"], device)
    log(f"table1 phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    ev = phase_eval_packed(model, params, train["dc"], device)
    log(f"eval-from-codes phase {time.perf_counter() - t0:.1f}s")
    del model, params
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"train": train, "table1": table, "eval": ev}


# --------------------------------------------------------------------------
# deepseek-v3-671b (phases 31-35)
# --------------------------------------------------------------------------

DS_ARCH = "deepseek-v3-671b"
# Depth cut, full width, forced by memory: a dense layer is 1.17 GB in
# bf16 (MLA 0.37 + FFN 0.79), an MoE layer 11.75 GB (256 x 3 int8 experts
# of 7168 x 2048 = 11.27 GB, MLA, the shared expert, the router), the
# embedding, head and MTP head 3.9 GB: the 61 layers' 58 x 11.27 = 654 GB
# of int8 experts need ~9 cards. 3 dense + 2 MoE layers are ~31 GB
# resident, with one 7.5 GB bf16 transient per expert matrix while it is
# dequantized; the fp32 phases keep 1 + 1 (each dequantized fp32 matrix
# is 15 GB). The CPU rehearsal keeps the smoke config's 1 + 2 for the
# serve and cuts 1 + 1 as on the card.
DS_LAYERS = {"cuda": (3, 2), "cpu": (1, 2)}
DS_SMALL = (1, 1)
DS_ATTN_T = 4096      # plain fp32 scores at full width: 8.6 GB (8704: 39 GB)
DS_PREFILL, DS_DECODE = 64, 8       # phase 32's prefill and decode steps
DS_TRAIN_BATCH, DS_TRAIN_SEQ = 2, 128


def ds_linears(cfg):
    """(K, M) of each LoRA linear of deepseek's dense and MoE layers."""
    m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
    mla = {"wq_down": (d, m.q_lora_rank),
           "wq_up": (m.q_lora_rank, h * (m.nope_head_dim + m.rope_head_dim)),
           "wkv_down": (d, m.kv_lora_rank), "wo": (h * m.v_head_dim, d)}
    f = cfg.moe.d_ff_expert * cfg.moe.n_shared
    dense = dict(mla, wg=(d, cfg.d_ff), wu=(d, cfg.d_ff), wd=(cfg.d_ff, d))
    moe = dict(mla, router=(d, cfg.moe.n_experts), shared_wg=(d, f),
               shared_wu=(d, f), shared_wd=(f, d))
    return dense, moe


def ds_config(dtype, layers=None, preset="full", cf=None):
    """deepseek-v3-671b at full width (or the smoke preset) in ``dtype``,
    cut to ``layers`` = (dense, MoE) layers (None keeps the config's);
    ``cf`` replaces the capacity factor."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(DS_ARCH, preset)
    moe = cfg.moe if cf is None else dataclasses.replace(
        cfg.moe, capacity_factor=cf)
    cfg = dataclasses.replace(cfg, dtype=dtype, moe=moe)
    if layers is None:
        return cfg
    blocks = tuple(dataclasses.replace(b, count=n)
                   for b, n in zip(cfg.blocks, layers))
    return dataclasses.replace(cfg, n_layers=sum(layers), blocks=blocks)


def ds_per_forward(cfg) -> int:
    """``sgmv_fused`` launches per forward: one per LoRA linear per layer
    (7 in a dense layer, 8 in an MoE layer)."""
    dense, moe = ds_linears(cfg)
    n_dense, n_moe = (b.count for b in cfg.blocks)
    return n_dense * len(dense) + n_moe * len(moe)


def phase_ds_kernel():
    """Phase 31: ``sgmv_fused`` against its plain version (TF32 off) at
    deepseek's nine (K, M), 8 adapters of rank 16 (mixed split h), group
    128, bits 2 (timed) and 3 / 4 (checked), decode (tile_t 1, 16 rows)
    and prefill (tile_t 8, 512 rows), x bf16; bitwise repeats. Returns
    the bits-2 timings per case and the largest error."""
    import torch
    from repro_torch.launch.bench_kernels import packed_layer, seg_for

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1357)
    dense, moe = ds_linears(ds_config(torch.bfloat16))
    shapes = sorted(set(dense.values()) | set(moe.values()))
    timings, max_err = {}, 0.0
    for k, m in shapes:
        for bits in (2, 3, 4):
            pb = packed_layer(k, m, bits, 128, N_ADAPTERS, seed=k + m + bits)
            for phase, (tile_t, rows) in PHASES.items():
                x = torch.randn(rows, k, generator=gen,
                                device="cuda").to(torch.bfloat16)
                t, err = kernel_case(
                    f"deepseek K={k:5d} M={m:5d} bits={bits} {phase:7s} "
                    f"T={rows:3d} tile_t {tile_t}", pb, x, seg_for(phase),
                    tile_t, timing=bits == 2)
                if bits == 2:
                    timings[(k, m), phase] = t
                max_err = max(max_err, err)
            del pb
    return timings, max_err


def phase_mla(device="cuda", preset="full"):
    """Phase 32: one MLA layer at full width in fp32, random weights.
    Two rows (the second left-padded by 3) prefilled with ``DS_PREFILL``
    tokens and decoded ``DS_DECODE`` steps through the absorbed decode
    equal the sequence-mode forward of all the tokens at their real
    positions, within ``RTOL`` of max |out|, and the cache holds the
    sequence's latents (the reference's ``test_decode_matches_forward`` at
    full width). Then ``DS_ATTN_T`` tokens through the blockwise path
    equal the plain one within ``RTOL``."""
    import torch
    from repro_torch.models import attention as attn_mod

    cfg = ds_config(torch.float32, preset=preset)
    gen = torch.Generator(device=device)
    gen.manual_seed(11)
    base, _ = attn_mod.init_mla(gen, cfg, None, 1)
    base = {k: {"w": v["w"][0]} for k, v in base.items()}
    tp, total = DS_PREFILL, DS_PREFILL + DS_DECODE
    x = torch.randn((2, total, cfg.d_model), generator=gen, device=device)
    start = torch.tensor([0, 3], device=device)
    ar = torch.arange(total, device=device)
    pad = ar[None, :] >= start[:, None]
    pos = torch.clamp(ar[None, :] - start[:, None], min=0)
    t0 = time.perf_counter()
    seq = attn_mod.mla_attention(x, base, None, cfg, positions=pos,
                                 pad_mask=pad)
    cache = {k: v[0] for k, v in attn_mod.init_mla_cache(
        cfg, 2, total, torch.float32, device, count=1).items()}
    pre = attn_mod.mla_attention(x[:, :tp], base, None, cfg,
                                 positions=pos[:, :tp], cache=cache,
                                 cache_pos=0, pad_mask=pad[:, :tp])
    dec = torch.cat([attn_mod.mla_attention(
        x[:, i:i + 1], base, None, cfg, positions=pos[:, i:i + 1],
        cache=cache, cache_pos=torch.full((2,), i, device=device),
        valid_start=start) for i in range(tp, total)], dim=1)
    sync(device)
    dt = time.perf_counter() - t0
    mag = seq.abs().max().item()
    err_pre = max((pre[b, int(start[b]):] - seq[b, int(start[b]):tp])
                  .abs().max().item() for b in range(2))
    err_dec = (dec - seq[:, tp:]).abs().max().item()
    latent = attn_mod.rmsnorm(x @ base["wkv_down"]["w"],
                              base["kv_norm"]["w"])
    err_c = (cache["c"] - latent).abs().max().item()
    if (not torch.isfinite(dec).all()
            or max(err_pre, err_dec) > RTOL * mag
            or err_c > RTOL * latent.abs().max().item()):
        raise AssertionError(f"MLA full width: prefill {err_pre:.3e}, "
                             f"absorbed decode {err_dec:.3e}, cache "
                             f"{err_c:.3e} vs {RTOL:g} x {mag:.3e}")
    log(f"MLA ({cfg.n_heads} heads, ranks {cfg.mla.q_lora_rank} / "
        f"{cfg.mla.kv_lora_rank}) fp32: prefill {tp} + {DS_DECODE} "
        f"absorbed decode steps == the sequence forward of {total} tokens "
        f"(row 1 left-padded by 3): max |err| prefill {err_pre:.3e}, decode "
        f"{err_dec:.3e} <= {RTOL:g} x {mag:.3e}; latent cache {err_c:.3e}; "
        f"{dt:.2f}s host wall")
    del x, seq, pre, dec, cache
    full = preset == "full"
    n = DS_ATTN_T if full else 40
    chunk = attn_mod.KV_CHUNK if full else 16
    xl = torch.randn((1, n, cfg.d_model), generator=gen, device=device)
    posl = torch.arange(n, device=device)[None]
    outs, times = {}, {}
    for name, force in (("plain", False), ("blockwise", True)):
        sync(device)
        t1 = time.perf_counter()
        outs[name] = attn_mod.mla_attention(
            xl, base, None, cfg, positions=posl, force_blockwise=force,
            kv_chunk=chunk)
        sync(device)
        times[name] = time.perf_counter() - t1
        if device == "cuda":
            torch.cuda.empty_cache()
    err = (outs["blockwise"] - outs["plain"]).abs().max().item()
    mag_l = outs["plain"].abs().max().item()
    if not torch.isfinite(outs["blockwise"]).all() or err > RTOL * mag_l:
        raise AssertionError(f"MLA blockwise vs plain at T={n}: max |err| "
                             f"{err:.3e} > {RTOL:g} x {mag_l:.3e}")
    log(f"MLA T={n} fp32: blockwise == plain within {err:.3e} (<= "
        f"{RTOL:g} x {mag_l:.3e}); plain {times['plain'] * 1e3:.1f} ms, "
        f"blockwise {times['blockwise'] * 1e3:.1f} ms (host wall, first "
        f"calls)")
    del xl, outs
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"decode_err": err_dec, "prefill_err": err_pre, "tol": RTOL * mag,
            "attn_err": err, "attn_tol": RTOL * mag_l}


def phase_ds_serve(device="cuda", preset="full"):
    """Phase 33, the slice's main path: deepseek at full width, 3 dense +
    2 MoE layers, bf16, the ``2@0.9`` fleet through :func:`bounded_serve`
    (3 x 7 + 2 x 8 = 37 ``sgmv_fused`` per live pool per forward). The
    requests whose all-resident tokens part from the bounded ones are
    reported, with the two runs' logit gap on the steps before they part
    (capacity drops and bf16 rounding depend on the prefill groups), and
    the profiled step's device time by kernel."""
    import torch

    cfg = ds_config(torch.bfloat16, DS_LAYERS[device], preset)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, params, store = fleet_of(cfg, device)
    sync(device)
    weights = sum(t.nbytes for t in iter_tensors(params["base"]))
    log(f"deepseek serve phase: bf16 model ({cfg.blocks[0].count} dense + "
        f"{cfg.blocks[1].count} MoE layers, {weights / 1e9:.2f} GB of base "
        f"weights) and 8 adapters in {time.perf_counter() - t0:.1f}s")
    res = bounded_serve("deepseek bf16", model, params, store, cfg.vocab,
                        device, ds_per_forward(cfg), keep_logits=True)
    resident, bounded = res.pop("resident"), res.pop("bounded")
    scale = max(float(abs(r.logits).max()) for r in resident)
    gap = comparable_gap(resident, bounded)
    res.update(bf16_gap=gap / scale, peak_gib=(
        torch.cuda.max_memory_allocated() / 2**30 if device == "cuda"
        else None))
    log(f"deepseek continuous bf16: requests whose tokens part from the "
        f"all-resident serve's: {res['parted']}; logit gap on the steps "
        f"before they part {gap:.3e} ({gap / scale:.2e} of max|logit| "
        f"{scale:.3e})" + (f"; peak device memory {res['peak_gib']:.2f} "
                           f"GiB" if device == "cuda" else ""))
    if device == "cuda":
        log("deepseek engine step, device time by kernel: " + "; ".join(
            f"{name} {ms:.3f} ms x {n}"
            for name, ms, n in res["window"]["window"].get("top", [])))
    del model, params, store, resident, bounded
    if device == "cuda":
        torch.cuda.empty_cache()
    return res


def phase_ds_parity(device="cuda", preset="full"):
    """Phase 34: deepseek at full width, 1 dense + 1 MoE layer, fp32,
    capacity factor E / top_k = 32 (every expert can take every token):
    :func:`drop_free_parity`."""
    import torch

    mc = ds_config(torch.float32, preset=preset).moe
    cfg = ds_config(torch.float32, DS_SMALL, preset,
                    cf=float(mc.n_experts // mc.top_k))
    return drop_free_parity("deepseek (1 + 1 layers)", cfg, device,
                            ds_per_forward(cfg))


def phase_ds_train(device="cuda", preset="full"):
    """Phase 35: deepseek's ``train_loss`` with the MTP head and its
    backward at full width, 1 dense + 1 MoE layer, bf16 frozen base (int8
    experts), fp32 LoRA (a random trained-looking adapter), a batch of
    ``DS_TRAIN_BATCH`` x ``DS_TRAIN_SEQ`` tokens: the loss and its CE,
    aux and MTP parts finite, every LoRA gradient finite and not all
    zero, no gradient on any base leaf."""
    import math

    import torch
    from repro_torch.launch.serve import random_trained_lora
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    cfg = ds_config(torch.bfloat16, DS_SMALL, preset)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    params = model.init(seed=0, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    lora = random_trained_lora(params["lora"], gen)
    leaves = list(iter_tensors(lora))
    for t in leaves:
        t.requires_grad_(True)
    toks = torch.randint(0, cfg.vocab, (DS_TRAIN_BATCH, DS_TRAIN_SEQ + 1),
                         generator=gen, device=device)
    sync(device)
    t1 = time.perf_counter()
    loss, parts = model.train_loss(
        {"base": params["base"], "lora": lora},
        {"tokens": toks[:, :-1], "targets": toks[:, 1:]})
    loss.backward()
    sync(device)
    dt = time.perf_counter() - t1
    vals = {"loss": loss.item(), "ce": parts["ce"].item(),
            "aux": parts["aux"].item()}
    vals["mtp_ce"] = (vals["loss"] - vals["ce"] - vals["aux"]) / 0.3
    grads = [t.grad for t in leaves]
    if (not all(math.isfinite(v) for v in vals.values())
            or any(g is None or not torch.isfinite(g).all() for g in grads)
            or not any(g.abs().max().item() > 0 for g in grads)):
        raise AssertionError(f"deepseek train_loss {vals}: a LoRA gradient "
                             f"is missing, not finite, or all are 0")
    based = [t for t in iter_tensors(params["base"])
             if t.requires_grad or t.grad is not None]
    if based:
        raise AssertionError(f"{len(based)} base leaves carry gradients")
    gnorm = math.sqrt(sum(float((g.float() ** 2).sum()) for g in grads))
    peak = (torch.cuda.max_memory_allocated() / 2**30 if device == "cuda"
            else None)
    log(f"deepseek train_loss + backward ({cfg.blocks[0].count} + "
        f"{cfg.blocks[1].count} layers, bf16 base, batch {DS_TRAIN_BATCH} x "
        f"{DS_TRAIN_SEQ}) in {dt:.2f}s: loss {vals['loss']:.4f} = CE "
        f"{vals['ce']:.4f} + aux {vals['aux']:.5f} + 0.3 x MTP CE "
        f"{vals['mtp_ce']:.4f}; {len(leaves)} LoRA leaves, grad norm "
        f"{gnorm:.4e}, no base gradient"
        + (f"; peak device memory {peak:.2f} GiB" if peak else "")
        + f"; phase {time.perf_counter() - t0:.1f}s")
    vals.update(grad_norm=gnorm, peak_gib=peak, s=dt)
    del model, params, lora, leaves, grads, loss, parts
    if device == "cuda":
        torch.cuda.empty_cache()
    return vals


def deepseek_phases() -> dict:
    """Phases 31-35 in order; returns the kernel's error at deepseek's
    shapes, its mix per launch over a dense and an MoE layer, and each
    phase's numbers (phase 33's bounded serve is the slice's main
    path)."""
    import torch

    t0 = time.perf_counter()
    timings, max_err = phase_ds_kernel()
    dense, moe = ds_linears(ds_config(torch.bfloat16))
    mixes = {"dense": main_path_mix(timings, dense),
             "moe": main_path_mix(timings, moe)}
    log(f"deepseek kernel phase {time.perf_counter() - t0:.1f}s; "
        + "; ".join(mix_line(f"sgmv_fused deepseek {n}-layer main-path", x)
                    for n, x in mixes.items()))
    out = {"max_err": max_err, "mix": mixes}
    for name, fn in (("mla", phase_mla), ("serve", phase_ds_serve),
                     ("parity", phase_ds_parity), ("train", phase_ds_train)):
        t0 = time.perf_counter()
        out[name] = fn()
        log(f"deepseek {name} phase {time.perf_counter() - t0:.1f}s")
    return out


# --------------------------------------------------------------------------
# the recurrent families: rwkv6-1.6b and recurrentgemma-2b (phases 36-40)
# --------------------------------------------------------------------------

REC_ARCHS = ("rwkv6-1.6b", "recurrentgemma-2b")
# fp32 parity depth (phase 40), full width, as layer counts per group:
# rwkv6 at 4 of its 24 layers; recurrentgemma at one (rglru, rglru,
# local_attn) period and its (rglru, rglru) tail group, so that both
# groups and both cache kinds go through paging. The bf16 serves (phases
# 38, 39) keep the configs' full depth: rwkv6 is 3.2 GB in bf16,
# recurrentgemma 6.3 GB.
REC_PARITY = {"rwkv6-1.6b": (4,), "recurrentgemma-2b": (1, 1)}
REC_PREFILL, REC_DECODE = 56, 8     # phase 37's mixer prefill and decode
REC_LONG_DECODE = 64                # decode steps after phase 37's long prefill


def rec_config(arch, dtype, counts=None, preset="full"):
    """``arch`` at full width (or its smoke preset) in ``dtype``; with
    ``counts`` its groups are the full config's layer patterns, each
    repeated that many times (a count of 0 drops the group)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(arch, preset), dtype=dtype)
    if counts is None:
        return cfg
    blocks = tuple(dataclasses.replace(b, count=n)
                   for b, n in zip(get_config(arch).blocks, counts) if n)
    return dataclasses.replace(cfg, blocks=blocks, n_layers=sum(
        b.count * len(b.pattern) for b in blocks))


def rec_linears(cfg) -> dict:
    """(K, M) of every LoRA linear of one forward of a recurrent config
    (one ``sgmv_fused`` launch each per live pool), keyed
    ``group/layer/sub/part/name``: an ``rwkv`` time mix's five, an
    ``rwkv_cm`` channel mix's three, an ``rglru`` block's three, a local
    attention's four and a dense FFN's three."""
    d, f = cfg.d_model, cfg.d_ff
    w = cfg.rglru_width or d
    attn = {k: v for k, v in linears_of(cfg).items()
            if k in ("wq", "wk", "wv", "wo")}
    mixers = {"rwkv": {n: (d, d) for n in ("wr", "wk", "wv", "wg", "wo")},
              "rglru": {"w_in": (d, w), "w_gate": (d, w), "w_out": (w, d)},
              "local_attn": attn, "attn": attn}
    ffns = {"rwkv_cm": {"wk": (d, f), "wv": (f, d), "wr": (d, d)},
            "dense": {"wg": (d, f), "wu": (d, f), "wd": (f, d)}}
    out = {}
    for gi, block in enumerate(cfg.blocks):
        for li in range(block.count):
            for j, (mk, fk) in enumerate(zip(block.pattern, block.ffn)):
                for part, names in (("mixer", mixers[mk]),
                                    ("ffn", ffns[fk])):
                    for n, km in names.items():
                        out[f"{gi}/{li}/sub_{j}/{part}/{n}"] = km
    return out


def phase_rec_kernel():
    """Phase 36: ``sgmv_fused`` against its plain version (TF32 off) at the
    seven distinct (K, M) of rwkv6-1.6b's and recurrentgemma-2b's LoRA
    linears, 8 adapters of rank 16 (mixed split h), group 128, bits 2
    (timed) and 3 / 4 (checked), decode (tile_t 1, 16 rows) and prefill
    (tile_t 8, 512 rows), x bf16; bitwise repeats. Returns the bits-2
    timings per case and the largest error."""
    import torch
    from repro_torch.launch.bench_kernels import packed_layer, seg_for

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2357)
    shapes = sorted({km for arch in REC_ARCHS
                     for km in rec_linears(rec_config(
                         arch, torch.bfloat16)).values()})
    timings, max_err = {}, 0.0
    for k, m in shapes:
        for bits in (2, 3, 4):
            pb = packed_layer(k, m, bits, 128, N_ADAPTERS, seed=k + m + bits)
            for phase, (tile_t, rows) in PHASES.items():
                x = torch.randn(rows, k, generator=gen,
                                device="cuda").to(torch.bfloat16)
                t, err = kernel_case(
                    f"recurrent K={k:5d} M={m:5d} bits={bits} {phase:7s} "
                    f"T={rows:3d} tile_t {tile_t}", pb, x, seg_for(phase),
                    tile_t, timing=bits == 2)
                if bits == 2:
                    timings[(k, m), phase] = t
                max_err = max(max_err, err)
            del pb
    return timings, max_err


def _rel_err(got, want) -> tuple:
    return ((got - want).abs().max().item(), want.abs().max().item())


def phase_rec_mixers(device="cuda", preset="full"):
    """Phase 37: the recurrent mixers at full width, one layer each, fp32,
    TF32 off, random weights (RWKV's bonus drawn, not zero). RWKV-6's time
    mix: a prefill of ``REC_PREFILL`` tokens with a state and
    ``REC_DECODE`` one-step decodes equal the sequence forward of all the
    tokens, and chunk 16 equals chunk 64 at T = 128; the same
    prefill-then-decode check for ``rglru_block`` with its conv window and
    ``h`` carried; then one recurrentgemma period (rglru, rglru,
    local_attn, with dense FFNs): the sequence forward of ``LONG_PROMPT``
    tokens (past the 2048-token window; blockwise attention) equals a
    prefill of all but ``REC_LONG_DECODE`` of them and that many decode
    steps, logits within ``RTOL`` of max |logit|."""
    import torch
    from repro_torch.models import recurrent as rec
    from repro_torch.models import build_model

    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    res = {}
    gen = torch.Generator(device=device)
    gen.manual_seed(37)
    t_total = REC_PREFILL + REC_DECODE
    with torch.no_grad():
        for arch, init, fn, state_of in (
                ("rwkv6-1.6b", rec.init_rwkv_tmix, rec.rwkv_tmix,
                 lambda c: rec.init_rwkv_state(c, 2, device)["tmix"]),
                ("recurrentgemma-2b", rec.init_rglru, rec.rglru_block,
                 lambda c: rec.init_rglru_state(c, 2, device))):
            cfg = rec_config(arch, torch.float32, preset=preset)
            base, _ = init(gen, cfg, None, 1)
            base = {k: ({"w": v["w"][0]} if isinstance(v, dict) else v[0])
                    for k, v in base.items()}
            if "bonus" in base:
                base["bonus"] = 0.5 * torch.randn(
                    base["bonus"].shape, generator=gen, device=device)
            x = torch.randn((2, t_total, cfg.d_model), generator=gen,
                            device=device)
            t0 = time.perf_counter()
            whole, _ = fn(x, base, None, cfg)
            st = {k: v[0] for k, v in state_of(cfg).items()}
            out, st = fn(x[:, :REC_PREFILL], base, None, cfg, state=st)
            outs = [out]
            for i in range(REC_PREFILL, t_total):
                out, st = fn(x[:, i:i + 1], base, None, cfg, state=st)
                outs.append(out)
            sync(device)
            err, mag = _rel_err(torch.cat(outs, 1), whole)
            if not torch.isfinite(whole).all() or err > RTOL * mag:
                raise AssertionError(f"{arch} mixer: prefill {REC_PREFILL} "
                                     f"+ {REC_DECODE} decode steps vs the "
                                     f"sequence forward: max |err| "
                                     f"{err:.3e} > {RTOL:g} x {mag:.3e}")
            res[f"{arch}_decode_err"], res[f"{arch}_tol"] = err, RTOL * mag
            line = (f"{arch} mixer (d {cfg.d_model}) fp32: prefill "
                    f"{REC_PREFILL} + {REC_DECODE} decode steps == the "
                    f"sequence forward of {t_total} tokens within {err:.3e} "
                    f"(<= {RTOL:g} x {mag:.3e})")
            if arch == "rwkv6-1.6b":
                xl = torch.randn((2, 128, cfg.d_model), generator=gen,
                                 device=device)
                c16 = fn(xl, base, None, cfg, chunk=16)[0]
                c64 = fn(xl, base, None, cfg, chunk=64)[0]
                err_c, mag_c = _rel_err(c16, c64)
                if err_c > RTOL * mag_c:
                    raise AssertionError(f"rwkv chunk 16 vs 64 at T=128: "
                                         f"{err_c:.3e} > {RTOL:g} x "
                                         f"{mag_c:.3e}")
                res["chunk_err"] = err_c
                line += (f"; chunk 16 == chunk 64 at T=128 within "
                         f"{err_c:.3e} (<= {RTOL:g} x {mag_c:.3e})")
            sync(device)
            log(f"{line}; {time.perf_counter() - t0:.2f}s host wall")
        # one recurrentgemma period: sequence vs prefill + decode
        cfg = rec_config("recurrentgemma-2b", torch.float32, (1, 0), preset)
        model = build_model(cfg)
        params = model.init(seed=5, device=device)
        n = LONG_PROMPT if preset == "full" else 6 * cfg.window
        dec = REC_LONG_DECODE if preset == "full" else cfg.window
        toks = torch.randint(0, cfg.vocab, (1, n), generator=gen,
                             device=device)
        t0 = time.perf_counter()
        x = model._embed(params["base"], {"tokens": toks})
        pos = torch.arange(n, device=device)[None]
        h, _ = model._backbone(params, x, pos, None, None)
        want = model._logits(params["base"], h[:, n - dec:])
        del h
        caches = model.init_cache(1, n, device=device)
        model._backbone(params, x[:, :n - dec], pos[:, :n - dec], caches, 0)
        got = []
        for i in range(n - dec, n):
            logits, caches = model.decode_step(
                params, toks[:, i:i + 1], caches,
                torch.full((1,), i, device=device))
            got.append(logits)
        sync(device)
        err, mag = _rel_err(torch.cat(got, 1), want)
        if err > RTOL * mag:
            raise AssertionError(f"recurrentgemma period: sequence forward "
                                 f"of {n} tokens vs prefill + {dec} decode "
                                 f"steps: logits max |err| {err:.3e} > "
                                 f"{RTOL:g} x {mag:.3e}")
        log(f"recurrentgemma period (rglru, rglru, local_attn; window "
            f"{cfg.window}) fp32: prefill {n - dec} + {dec} decode steps == "
            f"the sequence forward of {n} tokens, logits within {err:.3e} "
            f"(<= {RTOL:g} x {mag:.3e}); {time.perf_counter() - t0:.2f}s "
            f"host wall")
        res.update(long_err=err, long_tol=RTOL * mag)
        del model, params, caches, x, want, got
    if device == "cuda":
        torch.cuda.empty_cache()
    return res


# rwkv6's random-weight recurrence amplifies a rounding perturbation
# ~100x over its 24 layers, in fp32 as in bf16 (the growth lines of
# phases 38 and 40; recurrentgemma's 26 layers ~5x): a request prefilled
# in another group's batch shape then moves by a tenth or more of max
# |logit| in bf16 without parting. Its gap is reported, not held to
# BF16_GAP_RTOL; every request prefilled in the same group in both runs
# is held to the same bits.
BF16_GAP_REPORTED = ("rwkv6-1.6b",)


def rounding_growth(model, params, prompts, device) -> list:
    """Per layer, the largest difference of the hidden state of prompt 0
    prefilled in a batch of 8 and alone (no LoRA: other matmul shapes,
    other rounding), relative to its max |h|."""
    import numpy as np
    import torch
    from repro_torch.models.model import Model

    seen, orig = [], Model._layer

    def layer(self, *a, **kw):
        x, aux = orig(self, *a, **kw)
        seen.append(x[0].float().clone())
        return x, aux

    toks = torch.as_tensor(np.stack(prompts[:8]), device=device).long()
    p = {"base": params["base"], "lora": params["lora"]}
    Model._layer = layer
    try:
        model.prefill(p, {"tokens": toks}, CACHE_CAPACITY)
        batch = list(seen)
        seen.clear()
        model.prefill(p, {"tokens": toks[:1]}, CACHE_CAPACITY)
    finally:
        Model._layer = orig
    return [float((a - b).abs().max() / a.abs().max())
            for a, b in zip(batch, seen)]


def growth_line(label, growth) -> str:
    return (f"{label}: prompt 0 prefilled in a batch of 8 vs alone, hidden "
            f"max |diff| / max |h| after each layer (a recurrentgemma "
            f"layer: one period) " + " ".join(f"{g:.1e}" for g in growth)
            + f"; x{growth[-1] / max(growth[0], 1e-30):.0f} over the depth")


def phase_rec_serve(arch, device="cuda", preset="full"):
    """Phases 38 (rwkv6-1.6b, the slice's main path) and 39
    (recurrentgemma-2b): the model at full width and full depth in bf16,
    the ``2@0.9`` fleet through :func:`bounded_serve` (one
    ``sgmv_fused`` per LoRA linear per live pool per forward: 24 x 8 = 192
    and 8 x 19 + 12 = 164). The requests whose bounded tokens part from
    the all-resident ones are reported; a request prefilled in the same
    group in both runs must give the same tokens and logits to the bit,
    and the others' logits must stay within ``BF16_GAP_RTOL`` of max
    |logit| on the steps before they part (rwkv6: reported, see
    ``BF16_GAP_REPORTED``); the growth of a prefill's rounding over the
    layers, the profiled step's device time by kernel, peak memory."""
    import torch

    cfg = rec_config(arch, torch.bfloat16, preset=preset)
    per_forward = len(rec_linears(cfg))
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, params, store = fleet_of(cfg, device)
    sync(device)
    weights = sum(t.nbytes for t in iter_tensors(params["base"]))
    log(f"{arch}: bf16 model ({cfg.total_layers()} layers, "
        f"{weights / 1e9:.2f} GB of base weights) and 8 adapters in "
        f"{time.perf_counter() - t0:.1f}s")
    res = bounded_serve(f"{arch} bf16", model, params, store, cfg.vocab,
                        device, per_forward, keep_logits=True)
    resident, bounded = res.pop("resident"), res.pop("bounded")
    g_res, g_bnd = res.pop("groups")
    group_of = [{rid: g for g in gs for rid in g} for gs in (g_res, g_bnd)]
    same = [r.request_id for r in resident
            if group_of[0][r.request_id] == group_of[1][r.request_id]]
    for r, q in zip(resident, bounded):
        if r.request_id in same and (r.output.tolist() != q.output.tolist()
                                     or not (r.logits == q.logits).all()):
            raise AssertionError(f"{arch} bf16: request {r.request_id}, "
                                 f"prefilled in the same group in both "
                                 f"runs, gives other bits")
    moved = [r.request_id for r in resident if r.request_id not in same]
    scale = max(float(abs(r.logits).max()) for r in resident)
    gap = comparable_gap(resident, bounded)
    held = arch not in BF16_GAP_REPORTED
    if held and gap > BF16_GAP_RTOL * scale:
        raise AssertionError(f"{arch} bf16 all-resident vs bounded logits "
                             f"differ by {gap:.3e} > {BF16_GAP_RTOL:g} x "
                             f"{scale:.3e} before their tokens part")
    growth = rounding_growth(model, params, zipf_stream(cfg.vocab)[1],
                             device)
    res.update(layers=cfg.total_layers(), per_forward=per_forward,
               weights_gb=weights / 1e9, bf16_gap=gap / scale,
               moved=moved, growth=growth,
               peak_gib=(torch.cuda.max_memory_allocated() / 2**30
                         if device == "cuda" else None))
    log(f"{arch} continuous bf16: requests whose tokens part from the "
        f"all-resident serve's: {res['parted']}; prefilled in another group "
        f"when bounded: {moved}, the rest ({len(same)}) bit-identical; "
        f"logit gap on the steps before they part {gap:.3e} "
        f"({gap / scale:.2e} of max|logit| {scale:.3e}; "
        + (f"<= {BF16_GAP_RTOL:g})" if held else "reported, not held)")
        + (f"; peak device memory {res['peak_gib']:.2f} GiB"
           if device == "cuda" else ""))
    log(growth_line(f"{arch} bf16 ({cfg.total_layers()} layers)", growth))
    if device == "cuda":
        log(f"{arch} engine step, device time by kernel: " + "; ".join(
            f"{name} {ms:.3f} ms x {n}"
            for name, ms, n in res["window"]["window"].get("top", [])))
    del model, params, store, resident, bounded
    if device == "cuda":
        torch.cuda.empty_cache()
    return res


def phase_rec_parity(arch, device="cuda", preset="full"):
    """Phase 40: ``arch`` at full width in fp32, cut to ``REC_PARITY``:
    :func:`fp32_parity` (bounded continuous == materialize in tokens,
    logits within ``LOGIT_RTOL``, the shifted-adapter control). Phase
    13's prompts are all 32 tokens, so no row is padded (pads would flow
    through the recurrent states, in the reference too)."""
    import torch

    t0 = time.perf_counter()
    cfg = rec_config(arch, torch.float32, REC_PARITY[arch], preset)
    model, params, store = fleet_of(cfg, device)
    ids, prompts = zipf_stream(cfg.vocab)
    res = fp32_parity(f"{arch} ({cfg.total_layers()} layers, "
                      f"{len(cfg.blocks)} groups)", model, params, store, ids,
                      prompts, cfg.vocab, device, t0,
                      per_forward=len(rec_linears(cfg)))
    res.update(layers=cfg.total_layers(),
               growth=rounding_growth(model, params, prompts, device))
    log(growth_line(f"{arch} fp32 ({cfg.total_layers()} layers)",
                    res["growth"]))
    del model, params, store
    if device == "cuda":
        torch.cuda.empty_cache()
    return res


def recurrent_phases() -> dict:
    """Phases 36-40 in order; returns the kernel's error at the recurrent
    shapes, its mix per launch over each model's forward, and each phase's
    numbers (phase 38's bounded serve is the slice's main path)."""
    import torch

    t0 = time.perf_counter()
    timings, max_err = phase_rec_kernel()
    mixes = {arch: main_path_mix(timings, rec_linears(
        rec_config(arch, torch.bfloat16))) for arch in REC_ARCHS}
    log(f"recurrent kernel phase {time.perf_counter() - t0:.1f}s; "
        + "; ".join(mix_line(f"sgmv_fused {a} main-path", x)
                    for a, x in mixes.items()))
    out = {"max_err": max_err, "mix": mixes, "serve": {}, "parity": {}}
    t0 = time.perf_counter()
    out["mixers"] = phase_rec_mixers()
    log(f"recurrent mixer phase {time.perf_counter() - t0:.1f}s")
    for arch in REC_ARCHS:
        t0 = time.perf_counter()
        out["serve"][arch] = phase_rec_serve(arch)
        log(f"{arch} serve phase {time.perf_counter() - t0:.1f}s")
    for arch in REC_ARCHS:
        t0 = time.perf_counter()
        out["parity"][arch] = phase_rec_parity(arch)
        log(f"{arch} parity phase {time.perf_counter() - t0:.1f}s")
    return out


# --------------------------------------------------------------------------
# the mesh, compression and the training driver (phases 41-42)
# --------------------------------------------------------------------------

DRIVER_ARCH = "llama3.2-3b"
DRIVER_STEPS = 12
DRIVER_CUT = 6                 # run B stops after this many steps, resumes
DRIVER_BATCH = 8
DRIVER_SEQ = 128
DRIVER_CKPT_EVERY = 4
DRIVER_KEEP = 3                # the driver's keep-K
DRIVER_PROFILED = 9            # run A's step under torch.profiler
SIGTERM_AFTER = 3              # the subprocess is sent SIGTERM after this line
COMPRESS_CALLS = 10


def tree_bytes(tree, specs=None, mesh=None) -> int:
    """Bytes of a tree's leaves; with specs and a mesh, per device."""
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.parallel.sharding import block_index

    sizes = []
    if specs is None:
        tree_map(lambda t: sizes.append(t.numel() * t.element_size()), tree)
        return sum(sizes)

    def one(t, spec):
        parts = 1
        for e in spec:
            parts *= block_index(e, mesh, {a: 0 for a in mesh.axis_names})[1]
        sizes.append(t.numel() * t.element_size() // parts)

    tree_map(one, tree, specs)
    return sum(sizes)


def spec_list(tree, specs) -> list:
    """The specs of a spec tree, one per leaf of ``tree``."""
    from repro_torch.optim.adamw import tree_map

    out = []
    tree_map(lambda t, s: out.append(s), tree, specs)
    return out


def phase_mesh(device="cuda", preset="full"):
    """Phase 41: ``make_host_mesh()`` (NCCL on the card, world size 1);
    llama3.2-3b's full-size parameter tree (meta) under ``shard_tree`` on
    it, every leaf whole on the one device; the sharded leaves and bytes
    per device on the two production meshes; ``compressed_psum_mean`` over
    the mesh's group on the LoRA gradients of one full-width step, equal
    bit for bit to the single-process arithmetic, with the EF residual at
    most scale / 2 per element; its time per call."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.launch.step import _lora_grads
    from repro_torch.models import build_model
    from repro_torch.optim import (compress_with_feedback,
                                   compressed_psum_mean, dequantize_int8,
                                   init_error_feedback)
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.parallel.sharding import local_block, shard_tree

    t0 = time.perf_counter()
    cfg = get_config(DRIVER_ARCH, preset)
    tree = build_model(cfg).init(0, device="meta")
    mesh = make_host_mesh(device)
    out = {}
    try:
        import torch.distributed as dist

        group = mesh.fsdp_group()
        specs = shard_tree(tree, mesh)
        whole = []
        tree_map(lambda t, s: whole.append(tuple(local_block(
            t, s, mesh, mesh.coords).shape) == tuple(t.shape)), tree, specs)
        if not all(whole):
            raise AssertionError("a leaf is cut on the one-device mesh")
        log(f"mesh phase: make_host_mesh({device!r}) -> {mesh.shape} over "
            f"{dist.get_backend(group)}, world size {dist.get_world_size()}; "
            f"{cfg.name}'s {len(whole)} leaves "
            f"({tree_bytes(tree) / 2**30:.2f} GiB) all whole on it")
        out["production"] = {}
        for multi in (False, True):
            pm = make_production_mesh(multi_pod=multi)
            ps = shard_tree(tree, pm)
            cut = sum(any(e is not None for e in s)
                      for s in spec_list(tree, ps))
            per_dev = tree_bytes(tree, ps, pm)
            out["production"][pm.sizes] = {"sharded": cut, "bytes": per_dev}
            log(f"  {pm.sizes} {pm.axis_names}: {cut} of {len(whole)} leaves "
                f"sharded; {per_dev / 2**20:.1f} MiB of params per device "
                f"({tree_bytes(tree) / per_dev:.1f}x less than one copy)")
        del tree

        # the LoRA gradients of one full-width step, in the port's dtype
        model = build_model(cfg, remat=True)
        params = model.init(0, device=device)
        dc = DataConfig(seq_len=DRIVER_SEQ, global_batch=DRIVER_BATCH,
                        vocab=cfg.vocab, seed=0)
        batch = train_batch(dc, 0, device)
        _, _, grads = _lora_grads(model, params, batch)
        del params, model
        error = tree_map(lambda g: torch.randn_like(g) * 1e-6, grads)
        red, new_e = compressed_psum_mean(grads, error, group)
        q, s, want_e = compress_with_feedback(grads, error)
        want = tree_map(lambda qi, si: dequantize_int8(qi, si) / 1, q, s)
        for a, b in zip(tree_leaves(red) + tree_leaves(new_e),
                        tree_leaves(want) + tree_leaves(want_e)):
            if not torch.equal(a, b):
                raise AssertionError("compressed_psum_mean over the group "
                                     "differs from the local arithmetic")
        # |residual| <= scale / 2, up to the rounding of |g + e| <= 127
        # scales in fp32 (127 x 2^-23 of a scale)
        worst = max(float((e.abs() / si).max())
                    for e, si in zip(tree_leaves(new_e), tree_leaves(s)))
        if worst > 0.5 + 127 * 2.0 ** -23:
            raise AssertionError(f"EF residual {worst} x scale > 1/2")
        sync(device)
        t1 = time.perf_counter()
        for _ in range(COMPRESS_CALLS):
            compressed_psum_mean(grads, error, group)
        sync(device)
        ms = (time.perf_counter() - t1) / COMPRESS_CALLS * 1e3
        n_leaves = len(tree_leaves(grads))
        n_bytes = tree_bytes(grads)
        log(f"  compressed_psum_mean over {dist.get_backend(group)} on "
            f"{n_leaves} LoRA gradient leaves ({n_bytes / 2**20:.1f} MiB "
            f"fp32, {n_bytes / 4 / 2**20:.1f} MiB of int8 codes): == the "
            f"local arithmetic bit for bit, |residual| <= {worst:.4f} x "
            f"scale; {ms:.3f} ms per call ({COMPRESS_CALLS} calls, host "
            f"clock, synchronized); phase {time.perf_counter() - t0:.1f}s")
        out.update(compress_ms=ms, residual=worst, leaves=n_leaves)
        del grads, error, red, new_e, q, s, want, want_e
    finally:
        mesh.close()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def recorded_driver(device, profiled=None):
    """While active, every run of ``repro_torch.launch.train.main`` appends
    each step's metrics (copied) and time (synchronized) to the yielded
    dict's lists, and each checkpoint write's seconds and bytes; the step
    index ``profiled`` of the next run is profiled; with ``stop_after``
    set, the run is sent SIGTERM after that many steps."""
    import os
    import signal

    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.launch import train as train_mod

    rec = {"metrics": [], "times": [], "writes": [], "stop_after": None,
           "window": None, "async_steps": []}
    make, write = train_mod.make_train_step, ckpt.CheckpointManager._write
    save_async = ckpt.CheckpointManager.save_async

    def wrapped(*a, **kw):
        fn = make(*a, **kw)
        done = [0]

        def step(*sa):
            sync(device)
            t1 = time.perf_counter()
            if (profiled is not None and device == "cuda"
                    and len(rec["metrics"]) == profiled):
                out, rec["window"] = profile_step(lambda: fn(*sa))
            else:
                out = fn(*sa)
            sync(device)
            rec["times"].append(time.perf_counter() - t1)
            rec["metrics"].append({k: v.clone() for k, v in out[2].items()})
            done[0] += 1
            if done[0] == rec["stop_after"]:
                signal.raise_signal(signal.SIGTERM)
            return out
        return step

    def timed_write(self, step, payload, meta):
        t1 = time.perf_counter()
        write(self, step, payload, meta)
        d = os.path.join(self.directory, f"step_{step:08d}")
        size = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
        rec["writes"].append((time.perf_counter() - t1, size))

    def marked_async(self, step, *a, **kw):
        rec["async_steps"].append(len(rec["metrics"]))
        return save_async(self, step, *a, **kw)

    train_mod.make_train_step = wrapped
    ckpt.CheckpointManager._write = timed_write
    ckpt.CheckpointManager.save_async = marked_async
    try:
        yield rec
    finally:
        train_mod.make_train_step = make
        ckpt.CheckpointManager._write = write
        ckpt.CheckpointManager.save_async = save_async


def ckpt_arrays(directory, step) -> dict:
    import numpy as np

    d = Path(directory) / f"step_{step:08d}"
    out = {}
    for name in ("params.npz", "opt_state.npz"):
        with np.load(d / name) as z:
            out.update({f"{name}:{k}": z[k] for k in z.files})
    return out


def same_ckpt(a, b, what):
    import numpy as np

    diff = [k for k in a if k not in b or a[k].dtype != b[k].dtype
            or not np.array_equal(a[k], b[k])]
    if diff or sorted(a) != sorted(b):
        raise AssertionError(f"{what}: checkpoints differ in {diff[:5]} "
                             f"({len(diff)} arrays)")


def driver_args(ckpt, preset, steps=DRIVER_STEPS, device="cuda"):
    return ["--arch", DRIVER_ARCH, "--preset", preset, "--steps", str(steps),
            "--batch", str(DRIVER_BATCH), "--seq", str(DRIVER_SEQ),
            "--ckpt-every", str(DRIVER_CKPT_EVERY), "--ckpt-dir", str(ckpt),
            "--log-every", "1", "--device", device]


def phase_driver(device="cuda", preset="full"):
    """Phase 42: ``repro_torch.launch.train.main`` for llama3.2-3b at full
    width and depth (``--preset full``: bf16 base, remat), batch 8 x 128,
    a checkpoint every 4 steps. Run A goes 12 steps; run B is sent SIGTERM
    after 6 steps and resumed to 12: its steps 6-11 (every metric) and its
    final LoRA params and optimizer state equal A's bit for bit, and each
    directory keeps exactly 3 steps. A driver subprocess sent SIGTERM after
    its step-3 line exits 0, leaves the checkpoint of its last finished
    step, and resumed (in process) ends where A ends, bit for bit. Reports
    step time, tokens/s, peak memory, a checkpoint's bytes and seconds,
    the step that overlaps an async write against the median, and one
    profiled step's idle share."""
    import math
    import os
    import shutil
    import signal
    import statistics
    import tempfile

    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train as train_mod

    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    res = {}
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    # run A: uninterrupted
    with recorded_driver(device, profiled=DRIVER_PROFILED) as a:
        train_mod.main(driver_args(tmp / "a", preset, device=device))
    peak = (torch.cuda.max_memory_allocated() / 2**30 if device == "cuda"
            else None)
    if len(a["metrics"]) != DRIVER_STEPS:
        raise AssertionError(f"run A took {len(a['metrics'])} steps")
    # run B: SIGTERM after DRIVER_CUT steps, then resumed
    with recorded_driver(device) as b:
        b["stop_after"] = DRIVER_CUT
        train_mod.main(driver_args(tmp / "b", preset, device=device))
        cut_steps = CheckpointManager(str(tmp / "b")).list_steps()
        if len(b["metrics"]) != DRIVER_CUT or cut_steps[-1] != DRIVER_CUT - 1:
            raise AssertionError(f"run B stopped after {len(b['metrics'])} "
                                 f"steps with checkpoints {cut_steps}")
        b["stop_after"] = None
        train_mod.main(driver_args(tmp / "b", preset, device=device))
    if len(b["metrics"]) != DRIVER_STEPS:
        raise AssertionError(f"run B took {len(b['metrics'])} steps in all")
    for i in range(DRIVER_CUT, DRIVER_STEPS):
        for k, v in a["metrics"][i].items():
            if not torch.equal(v, b["metrics"][i][k]):
                raise AssertionError(
                    f"resumed step {i} {k}: {float(b['metrics'][i][k])!r} "
                    f"!= uninterrupted {float(v)!r}")
    last = DRIVER_STEPS - 1
    final = ckpt_arrays(tmp / "a", last)
    same_ckpt(ckpt_arrays(tmp / "b", last), final, "resumed run B vs A")
    for run in ("a", "b"):
        kept = CheckpointManager(str(tmp / run)).list_steps()
        if len(kept) != DRIVER_KEEP:
            raise AssertionError(f"run {run} keeps {kept}")
    losses = [float(m["loss"]) for m in a["metrics"]]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"losses {losses}")
    log(f"driver runs A (12 steps) and B (6, SIGTERM, resumed to 12): steps "
        f"{DRIVER_CUT}-{last} equal bit for bit in every metric, final LoRA "
        f"params and optimizer state equal ({len(final)} arrays); kept "
        f"{CheckpointManager(str(tmp / 'a')).list_steps()} / "
        f"{CheckpointManager(str(tmp / 'b')).list_steps()}; losses "
        + ", ".join(f"{v:.4f}" for v in losses))

    # a subprocess sent SIGTERM after its step-3 line
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train",
         *driver_args(tmp / "c", preset, device=device)],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if line.startswith(f"[train] step {SIGTERM_AFTER} "):
                proc.send_signal(signal.SIGTERM)
                break
        lines += proc.communicate(timeout=600)[0].splitlines(keepends=True)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    done = [int(l.split()[2]) for l in lines if l.startswith("[train] step ")]
    kept = CheckpointManager(str(tmp / "c")).list_steps()
    if (proc.returncode != 0 or not done or not kept or kept[-1] != done[-1]
            or not any("caught signal" in l for l in lines)):
        raise AssertionError(f"SIGTERM'd driver: exit {proc.returncode}, "
                             f"steps {done}, checkpoints {kept}: "
                             + "".join(lines)[-2000:])
    with recorded_driver(device) as c:
        train_mod.main(driver_args(tmp / "c", preset, device=device))
    same_ckpt(ckpt_arrays(tmp / "c", last), final,
              "SIGTERM'd and resumed vs A")
    log(f"driver subprocess: SIGTERM after the step-{SIGTERM_AFTER} line, "
        f"exit 0 after step {done[-1]} with its checkpoint; resumed in "
        f"process for {len(c['metrics'])} steps; final LoRA params and "
        f"optimizer state == run A's")

    times = a["times"]
    plain = [t for i, t in enumerate(times)
             if i not in a["async_steps"] and i != DRIVER_PROFILED and i > 0]
    med = statistics.median(plain)
    tokens = DRIVER_BATCH * DRIVER_SEQ
    overlap = [times[i] for i in a["async_steps"] if i < len(times)]
    w_s = [s for s, _ in a["writes"]]
    w_b = a["writes"][0][1] if a["writes"] else 0
    log(f"driver at full width ({preset}): median step {med * 1e3:.1f} ms "
        f"({tokens / med:.0f} tokens/s), first step {times[0] * 1e3:.1f} ms;"
        f" peak device memory "
        + (f"{peak:.2f} GiB" if peak is not None else "not measured")
        + f"; a checkpoint {w_b / 2**20:.1f} MiB written in "
        + ", ".join(f"{s:.3f}" for s in w_s) + " s; steps overlapping an "
        f"async write " + ", ".join(f"{t * 1e3:.1f}" for t in overlap)
        + f" ms vs median {med * 1e3:.1f} ms")
    if a["window"] is not None:
        log(window_line("driver", {"window": a["window"],
                                   "unprofiled_ms": med * 1e3},
                        what="train-step"))
    res.update(step_ms=med * 1e3, tokens_per_s=tokens / med, peak_gib=peak,
               ckpt_bytes=w_b, ckpt_s=w_s, overlap_ms=[t * 1e3
                                                       for t in overlap],
               window=a["window"], losses=losses)
    shutil.rmtree(tmp, ignore_errors=True)
    if device == "cuda":
        torch.cuda.empty_cache()
    log(f"driver phase {time.perf_counter() - t0:.1f}s")
    return res


def driver_phases(device="cuda", preset="full") -> dict:
    """Phases 41-42 in order."""
    t0 = time.perf_counter()
    mesh = phase_mesh(device, preset)
    log(f"mesh phase {time.perf_counter() - t0:.1f}s")
    return {"mesh": mesh, "driver": phase_driver(device, preset)}


# (arch, shape, microbatches): train_4k's step is cut from the dry run's
# 16 microbatches (4 at rank 0's 4 rows) to 2, for the script's time
DRYRUN_CELLS = (("llama3.2-3b", "train_4k", 2),
                ("llama3.2-3b", "decode_32k", 16),
                ("deepseek-v3-671b", "decode_32k", 16))
DRYRUN_TIMEOUT = 600          # seconds per dry-run subprocess


def phase_dryrun(device="cuda", cells=DRYRUN_CELLS) -> dict:
    """Phase 43: ``repro_torch.launch.dryrun`` at (16, 16) on the card, each
    cell in its own subprocess (a fresh fake process group and memory
    counters), beside the same cell's ``--device meta`` count (run in
    parallel on the host): per-device parameter bytes and counted FLOPs
    equal the meta count exactly, and the peak memory is below the card's.
    Prints per cell the parameter bytes, peak memory against 80 GiB,
    counted FLOPs, collective bytes by kind, the three roofline terms and
    the local step's wall time beside its compute term."""
    import os
    import shutil
    import tempfile

    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    tmp = Path(tempfile.mkdtemp(prefix="dryrun"))

    def start(arch, shape, micro, dev):
        report = tmp / f"{arch}.{shape}.{dev}.json"
        return report, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--device",
             dev, "--arch", arch, "--shape", shape, "--microbatches",
             str(micro), "--report", str(report)],
            cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)

    def finish(report, proc, what):
        out = proc.communicate(timeout=DRYRUN_TIMEOUT)[0]
        if proc.returncode != 0:
            raise AssertionError(f"dry run {what}: exit {proc.returncode}: "
                                 + out[-3000:])
        (r,) = json.loads(report.read_text())
        if "error" in r or "skipped" in r:
            raise AssertionError(f"dry run {what}: {r}")
        return r

    metas = [start(*cell, "meta") for cell in cells]
    out = {}
    try:
        for (arch, shape, micro), meta in zip(cells, metas):
            r = finish(*start(arch, shape, micro, device), f"{arch} {shape}")
            m = finish(*meta, f"{arch} {shape} meta")
            for key in ("params_bytes_per_chip", "counted_flops_per_chip"):
                if r[key] != m[key]:
                    raise AssertionError(f"{arch} {shape}: {key} "
                                         f"{r[key]} on the card, {m[key]} "
                                         f"on meta")
            mem = r["memory"]
            if device == "cuda" and not mem["peak_bytes"] < mem["card_bytes"]:
                raise AssertionError(f"{arch} {shape}: peak {mem}")
            peak = (f"{mem['peak_bytes'] / 2**30:.3f} GiB of the card's "
                    f"{mem['card_bytes'] / 2**30:.2f} GiB (model: 80 GiB)"
                    if "peak_bytes" in mem else "not measured")
            step = (f"{r['step_s']:.3f} s" if r["step_s"] is not None
                    else "not measured")
            colls = ", ".join(f"{k} {v / 2**20:.1f} MiB" for k, v in
                              sorted(r["collective_bytes_per_chip"].items()))
            log(f"dry run {arch} x {shape} at (16, 16), rank 0 of 256 "
                f"({r['microbatches']} microbatches): params "
                f"{r['params_bytes_per_chip'] / 2**20:.1f} MiB/device "
                f"(== meta); peak {peak}; counted {r['counted_flops_per_chip']:.6g} "
                f"FLOPs (== meta), {r['counted_bytes_per_chip']:.6g} bytes; "
                f"collectives {colls}; roofline terms compute "
                f"{r['compute_term_s']:.6g} s, memory "
                f"{r['memory_term_s']:.6g} s, collective "
                f"{r['collective_term_s']:.6g} s ({r['dominant_term']}, "
                f"roofline fraction {r['roofline_fraction']:.4g}); local "
                f"step {step} on the card vs its compute term "
                f"{r['compute_term_s']:.6g} s; counted run {r['run_s']:.1f} s")
            out[(arch, shape)] = r
    finally:
        for _, proc in metas:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"dry-run phase {time.perf_counter() - t0:.1f}s")
    return out


# --------------------------------------------------------------------------
# 44. adapters of any rank: the six kernels at rank rows 128-512, a rank-64
# fleet served at full width and depth, fp32 parity at rank 64
# --------------------------------------------------------------------------

RANKS = (16, 64, 128, 256)    # LoRA ranks; 16 is the configs' default
RANK_BITS = (2, 3, 4, 8)      # RTN widths of the high side (the low binary)
ONE_SIDED = ("rtn2", "rtn3", "rtn4", "rtn8", "binary")
SERVE_RANK = 64
RANK_PARITY_LAYERS = 4


def rank_kernel_cases(rank, k, m, gen):
    """The calls of the six kernels at LoRA rank ``rank`` and (K, M), decode
    and prefill: ``[(name, fmt, rows, phase, kernel, plain, args, kw)]``.
    ``sgmv_fused`` takes 8 packed adapters (mixed split h, a binary low
    side), ``fused_lora`` one rho-0.9 adapter: ``2·rp`` rank rows, bits
    ``RANK_BITS`` on the high side. The one-sided kernels take 8 adapters'
    sides quantized per format at ``rp`` rows and, past rank 16, at ``2·rp``
    too (up to 512 rows); ``matmul_*`` adapter 0 of those stacks."""
    import torch
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.launch.bench_kernels import (fused_args, packed_args,
                                                  packed_layer, seg_for,
                                                  sgmv_sides, single_qlora)

    rp = -(-rank // 8) * 8
    xs = {phase: torch.randn(rows, k, generator=gen, device="cuda",
                             dtype=torch.bfloat16)
          for phase, (_, rows) in PHASES.items()}
    out = []
    for bits in RANK_BITS:
        pb = packed_layer(k, m, bits, 128, N_ADAPTERS, seed=k + m + bits,
                          r=rank)
        q = single_qlora(k, m, bits, 0.9, seed=k + m + bits, r=rank)
        sides, fkw = fused_args(q)
        for phase, (tile_t, _) in PHASES.items():
            x = xs[phase]
            out.append(("sgmv_fused", f"rtn{bits}", 2 * rp, phase,
                        qm.sgmv_fused, qm.sgmv_fused_ref,
                        *packed_args(pb, x, seg_for(phase), tile_t)))
            out.append(("fused_lora", f"rtn{bits}", 2 * rp, phase,
                        qm.fused_lora, qm.fused_lora_ref, (x, *sides), fkw))
    for fmt in ONE_SIDED:
        binary = fmt == "binary"
        for rows in (rp,) + ((2 * rp,) if rank > 16 else ()):
            qas, _, sa, sb = sgmv_sides(k, m, fmt, seed=k + 7 * m + rows,
                                        r=rows)
            a, b = (tuple(t[0] for t in s) for s in (sa, sb))
            kw = dict(bits=qas[0].bits, binary=binary, group=128)
            for phase, (tile_t, _) in PHASES.items():
                x, seg = xs[phase], seg_for(phase)
                skw = dict(kw, tile_t=tile_t)
                h = torch.randn(x.shape[0], rows, generator=gen,
                                device="cuda")
                out += [
                    ("sgmv_rhs", fmt, rows, phase, qm.sgmv_rhs,
                     qm.sgmv_rhs_ref, (x, *sa, seg), skw),
                    ("sgmv_out", fmt, rows, phase, qm.sgmv_out,
                     qm.sgmv_out_ref, (h, *sb, seg), dict(skw, m=m)),
                    ("matmul_rhs", fmt, rows, phase, qm.matmul_rhs,
                     qm.matmul_rhs_ref, (x, *a), kw),
                    ("matmul_out", fmt, rows, phase, qm.matmul_out,
                     qm.matmul_out_ref, (h, *b), kw)]
    return out


def phase_rank_kernels():
    """Phase 44a: the six kernels at llama3.2-3b's four (K, M) at LoRA ranks
    16, 64, 128 and 256 (the fused kernels' ``2·rp`` = 32-512 rank rows, the
    one-sided kernels' ``rp`` and ``2·rp``), every width, decode and
    prefill: each call within ``RTOL`` of its plain version (TF32 off) and
    bitwise equal on a second launch. Then per kernel and rank the
    main-path mix per launch (device time, CUDA-graph replay) and its
    bound, from ``bench_kernels.bench``: the cases and timing of
    ``bench_kernels.py --rank``. Returns the mixes and the max error per
    kernel."""
    import torch
    from repro_torch.launch.bench_kernels import bench, device_times

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4444)
    max_err, rows_seen = {n: 0.0 for n in KERNELS}, {}
    checked = 0
    for rank in RANKS:
        for k, m in SHAPES:
            for (name, fmt, rows, phase, fn, plain, args,
                 kw) in rank_kernel_cases(rank, k, m, gen):
                tag = (f"{name} rank {rank} ({rows} rank rows) K={k} M={m} "
                       f"{fmt} {phase}")
                got = fn(*args, **kw)
                torch.cuda.synchronize()
                err = check_close(tag, got, plain(*args, **kw))
                if not torch.equal(got, fn(*args, **kw)):
                    raise AssertionError(f"{tag}: two launches differ")
                max_err[name] = max(max_err[name], err)
                rows_seen.setdefault(name, set()).add(rows)
                checked += 1
            torch.cuda.empty_cache()
    want = {32, 128, 256, 512}
    for name in ("sgmv_fused", "fused_lora"):
        if rows_seen[name] != want:
            raise AssertionError(f"{name} ran {rows_seen[name]} rank rows")
    log(f"rank kernel phase: {checked} calls of the six kernels within "
        f"{RTOL:g} x max|y| of their plain versions, each repeated bit for "
        f"bit")
    mixes = {name: {} for name in KERNELS}
    for rank in RANKS:
        for name, r in bench(rank, f"rank {rank}", device_times,
                             moe=False).items():
            mixes[name][rank] = {"ms": r["mix_ms"],
                                 "bound_ms": r["mix_bound_ms"],
                                 "bound_by": r["bound_by"]}
        torch.cuda.empty_cache()
    for name in KERNELS:
        log(f"rank {name}: rank rows {sorted(rows_seen[name])}, max |err| "
            f"{max_err[name]:.2e}; main-path mix per launch (bits 2, "
            f"device time) "
            + ", ".join(f"rank {r} {x['ms']:.4f} ms (bound "
                        f"{x['bound_ms']:.5f} ms, {x['bound_by']}; "
                        f"{x['ms'] / mixes[name][16]['ms']:.2f}x rank 16)"
                        for r, x in mixes[name].items()))
    return {"mix": mixes, "max_err": max_err, "checked": checked}


def rank_config(dtype, layers=None, preset="full"):
    """llama3.2-3b at full width (or the smoke preset) in ``dtype`` with
    adapters of rank ``SERVE_RANK``, cut to ``layers``."""
    import dataclasses

    return dataclasses.replace(dense_config("llama3.2-3b", dtype, layers,
                                            preset), lora_rank=SERVE_RANK)


def store_ranks(store) -> set:
    return {q.rank for qa in store.quantized.values()
            for qs in qa.entries.values() for q in qs}


def phase_rank_serve(device="cuda", preset="full"):
    """Phase 44b, the slice's main path: llama3.2-3b at full width and depth
    in bf16, the ``2@0.9`` fleet at LoRA rank 64 (``2·rp`` = 128 rank rows
    per ``sgmv_fused`` call), phase 13's Zipf stream through
    :func:`bounded_serve`: paging == ``ZIPF_BOUNDED``, 28 x 7 = 196
    ``sgmv_fused`` per live pool per forward and no other kernel, a second
    bounded run repeating tokens and paging; tokens/s, peak memory and
    the idle share reported."""
    import torch

    cfg = rank_config(torch.bfloat16, preset=preset)
    layers = cfg.total_layers()
    t0 = time.perf_counter()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    model, params, store = fleet_of(cfg, device)
    if store_ranks(store) != {SERVE_RANK}:
        raise AssertionError(f"adapters of rank {store_ranks(store)}")
    sync(device)
    peak = ""
    if device == "cuda":
        peak = (f", peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        torch.cuda.reset_peak_memory_stats()
    log(f"rank-{SERVE_RANK} serve: bf16 model ({layers} layers) and 8 "
        f"adapters of rank {SERVE_RANK} (fp32 factors drawn and quantized) "
        f"in {time.perf_counter() - t0:.1f}s{peak}")
    res = bounded_serve(f"llama3.2-3b rank {SERVE_RANK} bf16", model, params,
                        store, cfg.vocab, device, layers * len(LINEARS))
    res.pop("resident"), res.pop("bounded")
    if device == "cuda":
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        log(f"rank-{SERVE_RANK} serve: bounded {res['tok_s']:.1f} tokens/s "
            f"(all-resident {res['tok_s_resident']:.1f}), page "
            f"{res['page']} bytes, peak device memory of the three serves "
            f"{res['peak_gib']:.2f} GiB, requests whose tokens part from "
            f"the all-resident serve's: {res['parted']}")
    del model, params, store
    if device == "cuda":
        torch.cuda.empty_cache()
    return res


def phase_rank_parity(device="cuda", preset="full"):
    """Phase 44c: rank 64 in fp32 at ``RANK_PARITY_LAYERS`` layers. The
    fleet's bounded continuous serve == materialize (:func:`fp32_parity`,
    with its shifted-adapter control); then one rank-64 adapter as
    layer-stacked ``QuantizedLoRA`` leaves through ``fused_lora`` (or the
    two-pass pair where the reference's guard says so,
    :func:`expected_launches`) against its materialized factors: identical greedy tokens, logits within
    ``LOGIT_RTOL``, an adapter from another seed moving every request by
    ``CONTROL_MARGIN`` tolerances."""
    import numpy as np
    import torch
    from repro_torch.kernels.quant_matmul import reset_launch_counts

    t0 = time.perf_counter()
    cfg = rank_config(torch.float32, RANK_PARITY_LAYERS, preset)
    layers = cfg.total_layers()
    model, params, store = fleet_of(cfg, device)
    ids, prompts = zipf_stream(cfg.vocab)
    res = fp32_parity(f"rank-{SERVE_RANK} ({layers} layers)", model, params,
                      store, ids, prompts, cfg.vocab, device, t0,
                      per_forward=layers * len(LINEARS))
    del store
    t0 = time.perf_counter()
    base, template = params["base"], params["lora"]
    entries = single_adapter(template, seed=1)
    qtree = lora_tree(template, entries, "qlora")
    fp = lora_tree(template, entries, "fp")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(N_REQ, PROMPT)), device=device)
    want = {}
    for rows, n in ((N_REQ * PROMPT, 1), (N_REQ, MAX_NEW - 1)):
        for kern, c in expected_launches(qtree, rows).items():
            want[kern] = want.get(kern, 0) + c * n * layers
    reset_launch_counts()
    got_t, got_l = greedy(model, base, qtree, qtree, toks, device)
    sync(device)
    counts = launch_counts(device)
    if counts != want:
        raise AssertionError(f"rank-{SERVE_RANK} QuantizedLoRA serve "
                             f"launched {counts}, the reference's rule "
                             f"{want}")
    ref_t, ref_l = greedy(model, base, fp, fp, toks, device)
    other = lora_tree(template, single_adapter(template, seed=2), "qlora")
    _, ctl_l = greedy(model, base, other, other, toks, device)
    if not torch.equal(got_t, ref_t):
        bad = (got_t != ref_t).any(1).nonzero().flatten().tolist()
        raise AssertionError(f"rank-{SERVE_RANK} fused_lora vs materialize "
                             f"tokens differ for requests {bad}")
    scale = ref_l.abs().max().item()
    tol = LOGIT_RTOL * scale
    gap = (got_l - ref_l).abs().max().item()
    moved = (ctl_l - got_l).abs().amax(dim=(1, 2))
    if gap > tol:
        raise AssertionError(f"rank-{SERVE_RANK} fused_lora vs materialize "
                             f"logits differ by {gap:.3e} > {tol:.3e}")
    if moved.min().item() < CONTROL_MARGIN * tol:
        raise AssertionError(f"another adapter moves the logits by only "
                             f"{moved.tolist()}: the parity check is blind")
    log(f"rank-{SERVE_RANK} QuantizedLoRA fp32 ({layers} layers) "
        f"{time.perf_counter() - t0:.1f}s: launches {counts} (the "
        f"reference's guard rule), tokens == materialize for all {N_REQ} "
        f"requests, logits max |diff| {gap:.3e} <= {tol:.3e}; an adapter "
        f"from another seed moves every request by {moved.min().item():.3e}"
        f" to {moved.max().item():.3e}")
    res.update(fused=counts, fused_gap=gap, fused_tol=tol)
    del model, params, base, template, entries, qtree, fp, other
    if device == "cuda":
        torch.cuda.empty_cache()
    return res


def rank_phases() -> dict:
    """Phase 44 on the card: 44a, 44b, 44c."""
    out = {}
    for key, fn in (("kernels", phase_rank_kernels),
                    ("serve", phase_rank_serve),
                    ("parity", phase_rank_parity)):
        t0 = time.perf_counter()
        out[key] = fn()
        log(f"rank {key} phase {time.perf_counter() - t0:.1f}s")
    return out


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
    packed_parity(vocab, MIXED_RECIPES)
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

    # ---- 18-21. mixtral-8x22b: MoE kernel, serve, parity, long prompt -----
    moe = moe_phases()

    # ---- 22-27. the dense variants ------------------------------------------
    dense = dense_phases()

    # ---- 28-30. the LoRA train step, Table 1, eval from packed codes -------
    train = train_phases()

    # ---- 31-35. deepseek-v3-671b: kernel, MLA, serve, parity, MTP loss ----
    ds = deepseek_phases()

    # ---- 36-40. rwkv6-1.6b and recurrentgemma-2b ---------------------------
    rec = recurrent_phases()

    # ---- 41-42. the mesh, compression and the training driver --------------
    driver_phases()

    # ---- 43. the dry run at (16, 16) under a fake process group ------------
    phase_dryrun()

    # ---- 44. adapters of any rank: kernels, rank-64 serve, fp32 parity -----
    rank_phases()
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

    fused = entry("sgmv_fused", 481, cont["launches"],
                  max(max_err, sgmv_err["sgmv_fused"], moe["max_err"],
                      dense["max_err"], ds["max_err"], rec["max_err"]),
                  fused_mix)
    # the MoE main path (phase 19's bounded serve) and the kernel's mix
    # per launch over mixtral's linears (phase 18)
    fused.update(moe_launches=moe["launches"], moe_ms=moe["mix"]["ms"],
                 moe_plain_ms=moe["mix"]["plain_ms"],
                 moe_bound_ms=moe["mix"]["bound_ms"])
    # the dense variants: each model's main path (its bounded serve;
    # musicgen's model-level run) and the kernel's mix over its linears
    fused["dense"] = {
        arch: {"launches": (dense["serve"][arch]["launches"]
                            if arch in dense["serve"]
                            else dense["musicgen"]["launches"]),
               "ms": x["ms"], "plain_ms": x["plain_ms"],
               "bound_ms": x["bound_ms"]}
        for arch, x in dense["mix"].items()}
    # deepseek: the slice's main path (phase 33's bounded serve) and the
    # kernel's mix per launch over a dense and an MoE layer (phase 31)
    fused["deepseek"] = {
        "launches": ds["serve"]["launches"],
        **{f"{kind}_{key}": x[key] for kind, x in ds["mix"].items()
           for key in ("ms", "plain_ms", "bound_ms")}}
    # rwkv6-1.6b (phase 38's bounded serve, the slice's main path) and
    # recurrentgemma-2b (phase 39's), and the kernel's mix per launch over
    # each model's forward (phase 36)
    fused["recurrent"] = {
        arch: {"launches": rec["serve"][arch]["launches"],
               "per_forward": rec["serve"][arch]["per_forward"],
               "ms": x["ms"], "plain_ms": x["plain_ms"],
               "bound_ms": x["bound_ms"]}
        for arch, x in rec["mix"].items()}
    # phase 30: the trained adapter evaluated from its codes (bf16, full
    # depth), the launches of the slice's main path
    evl = train["eval"]["launches"]
    fused_lora_entry = entry("fused_lora", 348, single["launches"],
                             single_err["fused_lora"], mixes["fused_lora"])
    fused_lora_entry["eval_launches"] = evl.get("fused_lora", 0)
    pair = {n: entry(n, line, two_pass[n], single_err[n], mixes[n])
            for n, line in (("matmul_rhs", 157), ("matmul_out", 204))}
    for n, e in pair.items():
        e["eval_launches"] = evl.get(n, 0)
    print(smi)
    print(json.dumps({"kernels": [
        fused,
        entry("sgmv_rhs", 250, sgmv_apply_counts["sgmv_rhs"],
              sgmv_err["sgmv_rhs"], sgmv_mixes["sgmv_rhs"]),
        entry("sgmv_out", 293, sgmv_apply_counts["sgmv_out"],
              sgmv_err["sgmv_out"], sgmv_mixes["sgmv_out"]),
        fused_lora_entry,
        pair["matmul_rhs"],
        pair["matmul_out"],
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
