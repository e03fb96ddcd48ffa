"""One run of a cell from set-up to the result line (``run.py`` is its
command line, which insists on a card)."""

from __future__ import annotations

import json
import subprocess
import sys
import time
from typing import Any, Dict, Optional

import torch

from . import check, spec
from .serve import CellRun, lateness_line, log

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden() -> list:
    """Modules of JAX or the JAX package in this process, compared by whole
    top-level name (``repro_torch`` is not ``repro``)."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def power_limit() -> Optional[str]:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else None


def execute(cell: spec.Cell, seed: int, seconds: float, trace: bool,
            device, t_process: float, run: Optional[CellRun] = None,
            control: bool = False) -> Dict[str, Any]:
    """Set up, measure, check; returns the result line's object (with
    ``checks`` last). ``run``: one already set up (``calibrate.py``
    shares a build between runs); ``control``: the reference at the next
    lower precision takes the program's place in the check."""
    if run is None:
        run = CellRun(cell.cfg, cell.mix, seed, seconds, trace, device,
                      t_process)
        run.setup()
    run.loop()
    log(lateness_line(run.lateness))
    out = run.outcome()
    metrics = spec.read_metrics(cell.bench, cell.per_layer if trace
                                else cell.end_to_end, out)
    dev = torch.device(device)
    device_info: Dict[str, Any] = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": 1, "memory_peak_bytes": out.memory_peak_bytes}
    result: Dict[str, Any] = {"correct": False, "attempted": out.attempted,
                              "failed": out.failed, "metrics": metrics,
                              "device": device_info}
    if trace and out.trace is not None:
        device_info["busy_s"] = out.trace["busy_s"]
        device_info["window_s"] = out.trace["window_s"]
        result["breakdown"] = {"device_ops": out.trace["device_ops"],
                               "idle_gaps": out.trace["idle_gaps"]}
    numbers = judge(run, out, cell, seed, device, control)
    limits = cell.limits
    checks = {k: {"value": v, "limit": limits[k]}
              for k, v in numbers.items()}
    result["correct"] = bool(numbers) and all(
        v <= limits[k] for k, v in numbers.items()) and out.failed == 0
    result["checks"] = checks
    return result


def judge(run: CellRun, out, cell: spec.Cell, seed: int, device,
          control: bool = False) -> Dict[str, float]:
    """The check's numbers (empty when nothing could be compared)."""
    got = collect(run, out, cell)
    if got is None:
        return {}
    t = time.perf_counter()
    nums = check.compare(cell.cfg, seed, device, cell.mix["fleet"]["recipe"],
                         *got, control=control)
    log(f"reference took {time.perf_counter() - t:.1f} s")
    return nums


def collect(run: CellRun, out, cell: spec.Cell):
    """The sample under check and what the program served it, copied to
    the host; then the program's state is freed. ``(sampled, codes,
    moe_rule)``, or None when nothing finished."""
    picked = check.sample(run, out)
    if not picked:
        log("no finished request to check")
        run.release()
        return None
    cfg = cell.cfg
    k = cfg.get("num_experts_per_tok", 0)
    if k:
        run.rec.routing_to_host()
    sampled = []
    for r in picked:
        s = {"prompt": r.prompt.tolist(), "output": r.output.tolist(),
             "adapter": int(r.adapter_id[1:])}
        if k:
            s["experts"], s["kept"] = check.routes(
                run.rec.forwards, r, k, cfg["num_hidden_layers"])
        sampled.append(s)
    moe_rule = None
    if k:
        moe_rule = {"mismatches": check.drop_mismatches(
            run.rec.forwards, {r.request_id for r in picked},
            cfg["num_local_experts"], k,
            float(cfg["assumed"]["capacity_factor"]))}
    codes = check.stored_codes(run.store,
                               sorted({r.adapter_id for r in picked}))
    log(f"checking {len(picked)} requests "
        f"({sum(len(s['output']) for s in sampled)} served tokens) of "
        f"adapters {sorted({s['adapter'] for s in sampled})}")
    run.release()
    return sampled, codes, moe_rule


def emit(result: Dict[str, Any]) -> int:
    """Refuse to report if JAX got in; else the check lines on standard
    error and the result line on standard output."""
    bad = loaded_forbidden()
    if bad:
        print(f"[perfbench] refused: modules of JAX or the JAX package "
              f"were loaded: {bad}", file=sys.stderr, flush=True)
        return 4
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
