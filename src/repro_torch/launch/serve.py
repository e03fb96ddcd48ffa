"""Multi-LoRA serving driver on PyTorch (port of ``repro/launch/serve.py``):
register N LoRAQuant-quantized adapters, serve requests through the
continuous-batching engine over paged adapter memory (or one of the static
modes), report throughput and memory.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \\
        --preset full --adapters 8 --requests 16 --variant 2@0.9 \\
        --recipe user_0=4@0.95 --recipe user_1=3@0.9 --slots 4

``--slots`` bounds the device slot pools of the paged adapter memory to
that many adapters, ``--hbm-budget`` to that many MB at each recipe's real
page size; the rest page in from the host tier on demand.

``--recipe id=bits@rho`` (repeatable) quantizes one upload under its own
recipe, so a batch may mix packed layouts; ``--target-bits`` fits the
default recipe to an average-bits budget on the first upload.

The failure contract: ``--deadline-ms`` (a total budget per request),
``--queue-limit`` / ``--queue-policy`` (backpressure) and ``--inject``
(a named fault plan: ``latency``, ``transient``, ``poison``, ``storm``).
Every run records telemetry: per-status TTFT / E2E percentiles are
printed, ``--metrics-out`` / ``--trace-out`` / ``--events-out`` write the
Prometheus exposition, a Chrome trace and the JSONL event log, and
``--stats-every N`` prints a snapshot every N continuous steps.

Runs on the card (``--device cuda``, the default) unless asked for the CPU.
``main(argv)`` returns the finished requests.
"""

from __future__ import annotations

import argparse
import dataclasses
import re
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import LoRAQuantConfig
from repro_torch.models import build_model
from repro_torch.serving.engine import AdapterStore, MultiLoRAEngine, Request
from repro_torch.serving.faults import RequestStatus, named_plan
from repro_torch.serving.telemetry import Telemetry

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _fmt_ms(v) -> str:
    return "-" if v is None else f"{v * 1e3:.1f}ms"


def print_latency_summary(telemetry: Telemetry, prefix: str = "[serve]"):
    """Per-terminal-status p50/p95/p99 TTFT and E2E lines from the
    telemetry histograms (one line per status seen)."""
    reg = telemetry.registry
    statuses = sorted({dict(m.labels).get("status", "")
                       for m in reg.series("serving_e2e_seconds")})
    for status in statuses:
        parts = []
        for title, name in (("ttft", "serving_ttft_seconds"),
                            ("e2e", "serving_e2e_seconds")):
            hs = [m for m in reg.series(name)
                  if dict(m.labels).get("status") == status]
            if not hs or not any(h.count for h in hs):
                continue
            h = hs[0]
            parts.append(f"{title} p50={_fmt_ms(h.percentile(50))} "
                         f"p95={_fmt_ms(h.percentile(95))} "
                         f"p99={_fmt_ms(h.percentile(99))} (n={h.count})")
        if parts:
            print(f"{prefix} latency[{status}]: {' | '.join(parts)}")


def parse_variant(s: str) -> LoRAQuantConfig:
    m = re.match(r"^(\d)@(0?\.\d+)$", s)
    if not m:
        raise ValueError(f"variant must look like 2@0.9, got {s!r}")
    return LoRAQuantConfig(bits_high=int(m.group(1)), rho=float(m.group(2)))


def parse_recipe_override(s: str):
    """``id=2@0.9`` → (id, recipe): a per-upload recipe override."""
    if "=" not in s:
        raise ValueError(f"--recipe must look like user_0=4@0.95, got {s!r}")
    adapter_id, variant = s.split("=", 1)
    return adapter_id, parse_variant(variant)


def random_trained_lora(template, gen: torch.Generator, scale: float = 0.02,
                        spectrum_decay: float = 0.3):
    """Synthesize a 'trained' adapter shaped like ``template``: Gaussian
    factors whose rank components decay like ``exp(-decay·i)`` (what SGD
    produces on real tasks), the regime where LoRAQuant's variance split
    has signal. Drawn from ``gen`` on its device."""
    def one(node, name):
        if isinstance(node, dict):
            return {k: one(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(one(v, name) for v in node)
        shape = tuple(node.shape)
        arr = torch.randn(shape, generator=gen, device=gen.device) * scale
        if len(shape) >= 2 and name in ("a", "b"):
            r = shape[-2] if name == "a" else shape[-1]
            decay = torch.exp(-spectrum_decay * torch.arange(
                r, dtype=torch.float32, device=gen.device))
            arr = arr * (decay[:, None] if name == "a" else decay[None, :])
        return arr.to(node.dtype)

    return one(template, "")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", default="llama3.2-3b")
    p.add_argument("--preset", default="smoke", choices=("smoke", "full"))
    p.add_argument("--adapters", type=int, default=4)
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--max-new", type=int, default=8)
    p.add_argument("--variant", default="2@0.9",
                   help="default recipe (bits_high@rho) uploads quantize "
                        "under")
    p.add_argument("--recipe", action="append", default=[],
                   metavar="ID=BITS@RHO",
                   help="per-upload recipe override, e.g. user_0=4@0.95 "
                        "(repeatable)")
    p.add_argument("--target-bits", type=float, default=None,
                   help="fit the default recipe to this average-bits budget "
                        "on the first upload (overrides --variant)")
    p.add_argument("--mode", default="continuous",
                   choices=("continuous", "packed", "materialize"),
                   help="continuous: step-based scheduler (mid-decode "
                        "admission, per-row positions) over paged adapter "
                        "memory, straight from packed codes; packed: one "
                        "static heterogeneous batch; materialize: "
                        "per-adapter segment loop over dequantized fp trees")
    p.add_argument("--max-rows", type=int, default=8,
                   help="decode batch rows owned by the continuous scheduler")
    p.add_argument("--slots", type=int, default=None,
                   help="slot-pool size of the paged adapter memory "
                        "(continuous mode): at most this many adapters' "
                        "packed pages are device-resident, the rest page in "
                        "from the host tier. Default: unbounded")
    p.add_argument("--hbm-budget", type=float, default=None, metavar="MB",
                   help="alternative to --slots: device budget of the slot "
                        "pools in MB, each slot priced at its recipe's page "
                        "bytes (--slots wins if both are given)")
    p.add_argument("--no-quant", action="store_true",
                   help="serve unquantized adapters: not supported (the "
                        "reference's flag crashes in its quantizer, ROADMAP "
                        "C7); raises")
    p.add_argument("--deadline-ms", type=float, default=None,
                   help="total deadline per request: requests still running "
                        "past it retire TIMED_OUT with their partial output")
    p.add_argument("--queue-limit", type=int, default=None,
                   help="bounded pending queue: submits past this depth hit "
                        "backpressure (--queue-policy)")
    p.add_argument("--queue-policy", default="reject",
                   choices=("reject", "shed_oldest"),
                   help="what a full queue does: reject the new request, or "
                        "shed the oldest pending one to make room")
    p.add_argument("--inject", default=None, metavar="PLAN",
                   help="named fault plan (none|latency|transient|poison|"
                        "storm) injected into host reads and uploads")
    p.add_argument("--metrics-out", default=None, metavar="PATH",
                   help="write the final Prometheus metrics exposition here")
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="write a Chrome-trace JSON of request and scheduler "
                        "spans here (Perfetto / chrome://tracing)")
    p.add_argument("--events-out", default=None, metavar="PATH",
                   help="write the JSONL lifecycle event log here")
    p.add_argument("--stats-every", type=int, default=0, metavar="N",
                   help="continuous mode: print a one-line stats snapshot "
                        "every N scheduler steps (0 = off)")
    p.add_argument("--keep-logits", action="store_true",
                   help="keep each request's per-step logits on the returned "
                        "requests (parity checks between modes)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", default=None, choices=sorted(DTYPES),
                   help="base-model dtype (default: float32 for the smoke "
                        "preset, the config's dtype otherwise)")
    args = p.parse_args(argv)
    if args.no_quant:
        # the reference sets bits_high=16, which its quantizer cannot pack
        raise ValueError("--no-quant is not supported: the reference's "
                         "serve driver crashes on it with 'unsupported "
                         "bitwidth 16' (ROADMAP C7), so the port serves "
                         "quantized adapters only")
    plan = named_plan(args.inject) if args.inject else None

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, args.preset)
    dtype = DTYPES[args.dtype] if args.dtype else (
        torch.float32 if args.preset == "smoke" else cfg.dtype)
    cfg = dataclasses.replace(cfg, dtype=dtype)
    model = build_model(cfg)
    params = model.init(seed=args.seed, device=dev)

    qcfg = parse_variant(args.variant)
    budget = (int(args.hbm_budget * 1e6)
              if args.hbm_budget is not None else None)
    store = AdapterStore(qcfg, hbm_budget_bytes=budget, faults=plan)
    recipes = dict(parse_recipe_override(r) for r in args.recipe)
    unknown = sorted(set(recipes) - {f"user_{i}"
                                     for i in range(args.adapters)})
    if unknown:
        raise ValueError(f"--recipe overrides for unknown uploads: {unknown} "
                         f"(uploads are user_0..user_{args.adapters - 1})")
    print(f"[serve] registering {args.adapters} adapters "
          f"(default LoRAQuant {qcfg.bits_high}@{qcfg.rho:g}, "
          f"{len(recipes)} per-upload overrides) on {dev}...")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 1)
    uploads = {f"user_{i}": random_trained_lora(params["lora"], gen)
               for i in range(args.adapters)}
    _sync(dev)
    t0 = time.perf_counter()
    if args.target_bits is not None:
        qcfg = LoRAQuantConfig.for_budget(
            next(iter(uploads.values())), args.target_bits,
            ste_steps=qcfg.ste_steps, refine=qcfg.refine)
        store.default_recipe = qcfg
        print(f"[serve] fitted default recipe for {args.target_bits} avg "
              f"bits: {qcfg.variant_name}")
    store.register_many(uploads, recipes=recipes,
                        on_error="skip" if plan else "raise")
    if store.onboard_errors:
        print(f"[serve] rejected uploads: {store.onboard_errors}")
    _sync(dev)
    t_reg = time.perf_counter() - t0
    print(f"[serve] quantized in {t_reg:.2f}s; store stats: {store.stats()}")

    telemetry = Telemetry()
    engine = MultiLoRAEngine(model, params, store, cache_capacity=128,
                             mode=args.mode, max_rows=args.max_rows,
                             hbm_slots=args.slots,
                             queue_limit=args.queue_limit,
                             queue_policy=args.queue_policy,
                             default_deadline_ms=args.deadline_ms,
                             faults=plan, telemetry=telemetry)
    drng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        engine.submit(Request(
            request_id=rid, adapter_id=f"user_{rid % args.adapters}",
            prompt=drng.integers(0, cfg.vocab,
                                 size=args.prompt_len).astype(np.int32),
            max_new_tokens=args.max_new, keep_logits=args.keep_logits))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    try:
        done = _drive(engine, args)
    finally:
        telemetry.uninstall_kernel_counter()
    _sync(dev)
    dt = time.perf_counter() - t0
    ok = [r for r in done if r.status is RequestStatus.DONE]
    total_tokens = sum(len(r.output) for r in ok)
    by_status = {}
    for r in done:
        by_status[r.status.value] = by_status.get(r.status.value, 0) + 1
    print(f"[serve] mode={args.mode}: {len(done)} requests "
          f"({', '.join(f'{k}={v}' for k, v in sorted(by_status.items()))}), "
          f"{total_tokens} tokens in {dt:.3f}s ({total_tokens / dt:.1f} "
          f"tok/s); fp-resident LoRA bytes: {store.fp_resident_bytes()}")
    for r in [r for r in done if r.status is not RequestStatus.DONE][:8]:
        print(f"[serve]   request {r.request_id} ({r.adapter_id}): "
              f"{r.status.value} — {r.error}")
    if engine.quarantined:
        print(f"[serve] quarantined adapters: {sorted(engine.quarantined)}")
    print_latency_summary(telemetry)
    if dev.type == "cuda":
        print(f"[serve] peak device memory while serving: "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    mem = engine.memory_stats()
    if mem:
        # hit_rate is None until the first acquire: an idle pool must not
        # print as a perfect one
        rate = ("n/a (0 lookups)" if mem["hit_rate"] is None
                else f"{mem['hit_rate']:.2f} ({mem['lookups']} lookups)")
        print(f"[serve] adapter memory: {mem['slots']} slots in "
              f"{mem['pools']:.0f} pool(s) "
              f"({mem['hbm_slot_mb']:.3f} MB on {dev.type}) over "
              f"{store.stats()['adapters']:.0f} adapters "
              f"({mem['host_tier_mb']:.3f} MB host tier); "
              f"hit rate {rate}, "
              f"swap-ins {mem['swap_ins']:.0f}, "
              f"evictions {mem['evictions']:.0f}")
        for label, pool in sorted(mem["per_pool"].items()):
            prate = ("n/a" if pool["hit_rate"] is None
                     else f"{pool['hit_rate']:.2f}")
            print(f"[serve]   pool {label}: {pool['resident']}/"
                  f"{pool['capacity']} resident, hit rate {prate}, "
                  f"swap-ins {pool['swap_ins']} "
                  f"({pool['swap_in_bytes'] / 1e6:.3f} MB), "
                  f"evictions {pool['evictions']}")
    col = " ".join(f"{aid}={st['avg_bits']:.2f}"
                   for aid, st in sorted(store.adapter_stats().items()))
    print(f"[serve] per-adapter avg_bits: {col}")
    if ok:
        print(f"[serve] sample output (req {ok[0].request_id}): "
              f"{ok[0].output.tolist()}")
    if args.metrics_out:
        telemetry.write_prometheus(args.metrics_out)
        print(f"[serve] wrote metrics exposition to {args.metrics_out}")
    if args.trace_out:
        telemetry.write_chrome_trace(args.trace_out)
        print(f"[serve] wrote Chrome trace to {args.trace_out}")
    if args.events_out:
        telemetry.write_jsonl(args.events_out)
        print(f"[serve] wrote {len(telemetry.events)} lifecycle events "
              f"to {args.events_out}")
    return done


def _drive(engine: MultiLoRAEngine, args):
    """Run the engine to completion; in continuous mode with
    ``--stats-every N``, step by step with a snapshot every N steps."""
    if args.mode != "continuous" or args.stats_every <= 0:
        return engine.run()
    done = []
    while engine.pending or engine.active_rows or engine._terminated:
        done.extend(engine.step())
        if engine._step_count % args.stats_every == 0:
            st = engine.stats()
            mem = engine.memory_stats()
            print(f"[serve] step {st['decode_steps']}: "
                  f"active={st['active_rows']}/{args.max_rows} "
                  f"pending={st['pending']} "
                  f"finished={sum(st.get('finished', {}).values())} "
                  f"tokens={st.get('tokens', 0)} "
                  f"mem hits/misses={mem.get('hits', 0)}/"
                  f"{mem.get('misses', 0)}")
    return done


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


if __name__ == "__main__":
    main()
