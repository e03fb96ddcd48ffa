"""End-to-end LoRA fine-tuning driver (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
        --preset smoke --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

Runs on the card unless ``--device cpu`` is given; with no GPU the default
raises instead of falling back to the CPU. Production features, as in the
reference:
* resume-latest checkpointing (atomic, keep-K, async write), in the
  reference's on-disk format;
* deterministic data (restart-safe: the stream is f(seed, step));
* straggler watchdog — flags steps slower than ``factor×`` the running p50;
* preemption-style graceful save on SIGTERM/SIGINT: the step in flight
  finishes, its checkpoint is written, and the process exits cleanly.

The mesh is the host's, ``(1, world)`` over ``("data", "model")``, as the
reference builds it. At world size 1 the parameters stay plain tensors on
the device; above 1 the ``model`` axis exceeds 1, which is ROADMAP A9b, and
the model refuses it. ``--preset smoke`` or ``--fp32`` trains in fp32;
``--preset full`` recomputes each layer on the backward pass.
"""

from __future__ import annotations

import argparse
import dataclasses
import signal
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.step import local_batch, make_train_step
from repro_torch.models import build_model
from repro_torch.optim import OptimizerConfig, init_opt_state

__all__ = ["StragglerWatchdog", "main"]


class StragglerWatchdog:
    """Flags steps slower than ``factor`` × running median. On a real pod this
    signal triggers hot-spare swap; here it logs + counts."""

    def __init__(self, factor: float = 2.0, warmup: int = 5):
        self.factor = factor
        self.warmup = warmup
        self.times = []
        self.flagged = 0

    def record(self, dt: float) -> bool:
        self.times.append(dt)
        if len(self.times) <= self.warmup:
            return False
        p50 = float(np.median(self.times[self.warmup:]))
        if dt > self.factor * p50:
            self.flagged += 1
            return True
        return False


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="llama3.2-3b")
    p.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--eval-every", type=int, default=25)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--fp32", action="store_true", help="CPU smoke precision")
    p.add_argument("--device", default="cuda",
                   help="cuda (default: the card) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch, args.preset)
    if args.fp32 or args.preset == "smoke":
        cfg = dataclasses.replace(cfg, dtype=torch.float32)

    mesh = make_host_mesh(device)
    try:
        return _train(args, cfg, mesh, device)
    finally:
        mesh.close()


def _train(args, cfg, mesh, device):
    model = build_model(cfg, remat=args.preset == "full", mesh=mesh)
    opt_cfg = OptimizerConfig(lr=args.lr, total_steps=args.steps)

    params = model.local_params(model.init(args.seed, device=device))
    opt_state = init_opt_state(params["lora"])

    dcfg = DataConfig(
        seq_len=args.seq, global_batch=args.batch, vocab=cfg.vocab,
        seed=args.seed, n_codebooks=cfg.n_codebooks,
        vision_tokens=8 if cfg.vision_stub else 0, d_model=cfg.d_model)

    start_step = 0
    manager = None
    if args.ckpt_dir:
        manager = CheckpointManager(args.ckpt_dir, keep=3)
        restored = manager.restore_latest(params["lora"], opt_state)
        if restored is not None:
            lora_p, opt_state, meta = restored
            params = {"base": params["base"], "lora": lora_p}
            start_step = int(meta["step"]) + 1
            print(f"[train] resumed from step {meta['step']}")

    step_fn = make_train_step(model, opt_cfg, args.microbatches)
    stop = {"flag": False}

    def _graceful(signum, frame):
        stop["flag"] = True

    old_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        old_handlers[sig] = signal.signal(sig, _graceful)

    watchdog = StragglerWatchdog()
    losses = []
    try:
        for step in range(start_step, args.steps):
            batch = local_batch(
                {k: torch.from_numpy(v).to(device)
                 for k, v in make_batch(dcfg, step).items()}, mesh)
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            _sync(device)
            dt = time.perf_counter() - t0
            slow = watchdog.record(dt)
            losses.append(float(metrics["loss"]))
            if step % args.log_every == 0 or slow:
                msg = (f"[train] step {step} loss {float(metrics['loss']):.4f} "
                       f"lr {float(metrics['lr']):.2e} gnorm "
                       f"{float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms")
                if slow:
                    msg += "  [STRAGGLER FLAGGED]"
                print(msg, flush=True)
            if manager and (step + 1) % args.ckpt_every == 0:
                manager.save_async(step, params["lora"], opt_state)
            if stop["flag"]:
                print("[train] caught signal — saving and exiting",
                      flush=True)
                break
    finally:
        for sig, h in old_handlers.items():
            signal.signal(sig, h)
        if manager:
            last = start_step if not losses else start_step + len(losses) - 1
            manager.save(last, params["lora"], opt_state)
            manager.wait()

    if losses:
        k = max(len(losses) // 5, 1)
        print(f"[train] loss first-{k}-mean {np.mean(losses[:k]):.4f} "
              f"last-{k}-mean {np.mean(losses[-k:]):.4f} "
              f"stragglers={watchdog.flagged}", flush=True)
    return params


if __name__ == "__main__":
    main()
