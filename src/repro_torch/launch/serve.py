"""Multi-LoRA serving driver on PyTorch (port of ``repro/launch/serve.py``):
register N LoRAQuant-quantized adapters, serve a heterogeneous batch of
requests through the static engine, report throughput and memory.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \\
        --preset full --adapters 8 --requests 16 --variant 2@0.9

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
from repro_torch.serving.faults import RequestStatus

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def parse_variant(s: str) -> LoRAQuantConfig:
    m = re.match(r"^(\d)@(0?\.\d+)$", s)
    if not m:
        raise ValueError(f"variant must look like 2@0.9, got {s!r}")
    return LoRAQuantConfig(bits_high=int(m.group(1)), rho=float(m.group(2)))


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
                   help="recipe (bits_high@rho) every upload quantizes under")
    p.add_argument("--mode", default="packed",
                   choices=("packed", "materialize"),
                   help="packed: one heterogeneous batch straight from "
                        "packed codes; materialize: per-adapter segment "
                        "loop over dequantized fp trees")
    p.add_argument("--keep-logits", action="store_true",
                   help="keep each request's per-step logits on the returned "
                        "requests (parity checks between modes)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", default=None, choices=sorted(DTYPES),
                   help="base-model dtype (default: float32 for the smoke "
                        "preset, the config's dtype otherwise)")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, args.preset)
    dtype = DTYPES[args.dtype] if args.dtype else (
        torch.float32 if args.preset == "smoke" else cfg.dtype)
    cfg = dataclasses.replace(cfg, dtype=dtype)
    model = build_model(cfg)
    params = model.init(seed=args.seed, device=dev)

    qcfg = parse_variant(args.variant)
    store = AdapterStore(qcfg)
    print(f"[serve] registering {args.adapters} adapters "
          f"(LoRAQuant {qcfg.bits_high}@{qcfg.rho:g}) on {dev}...")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 1)
    uploads = {f"user_{i}": random_trained_lora(params["lora"], gen)
               for i in range(args.adapters)}
    _sync(dev)
    t0 = time.perf_counter()
    store.register_many(uploads)
    _sync(dev)
    t_reg = time.perf_counter() - t0
    print(f"[serve] quantized in {t_reg:.2f}s; store stats: {store.stats()}")

    engine = MultiLoRAEngine(model, params, store, cache_capacity=128,
                             mode=args.mode)
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
    done = engine.run()
    _sync(dev)
    dt = time.perf_counter() - t0
    ok = [r for r in done if r.status is RequestStatus.DONE]
    total_tokens = sum(len(r.output) for r in ok)
    print(f"[serve] mode={args.mode}: {len(done)} requests ({len(ok)} done), "
          f"{total_tokens} tokens in {dt:.3f}s ({total_tokens / dt:.1f} "
          f"tok/s); fp-resident LoRA bytes: {store.fp_resident_bytes()}")
    if dev.type == "cuda":
        print(f"[serve] peak device memory while serving: "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    col = " ".join(f"{aid}={st['avg_bits']:.2f}"
                   for aid, st in sorted(store.adapter_stats().items()))
    print(f"[serve] per-adapter avg_bits: {col}")
    if ok:
        print(f"[serve] sample output (req {ok[0].request_id}): "
              f"{ok[0].output.tolist()}")
    return done


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


if __name__ == "__main__":
    main()
