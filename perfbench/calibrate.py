"""Readings that set a cell's rate and limits (not run by the benchmark).

    python3 perfbench/calibrate.py sweep faults --workload mixtral-chat \\
        --seed 5 --seconds 18 --rates 4 4.4 4.8 5.2

The fleet is onboarded once and shared. ``sweep`` draws the weights once
and runs the cell's traffic at each offered rate on a fresh engine, one
JSON line per rate: the requests waiting for a row at the window's start,
at its most and at its close, and the rows live per decode step. The knee
is the highest rate whose queue does not grow through the window.
``faults`` runs the cell through ``harness.main.execute`` once with the
control in the program's place (the reference at the next lower
precision: bf16 in the quantizer, fp8 in the forward) and once with each
fault of ``harness/faults.py`` planted, each on weights drawn anew, one
JSON line each with ``correct`` and the numbers beside their limits: each
has to read ``correct`` false. Both write to standard output and need a
card unless ``--device cpu`` is given.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import copy  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import torch  # noqa: E402

# as run.py serves the port
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for _p in (str(ROOT / "src"), str(BENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def _shared(cell, seed, seconds, device, first):
    """A run on a fresh engine that takes ``first``'s fleet (and its
    weights, where it still holds them)."""
    from harness.serve import CellRun

    run = CellRun(cell.cfg, cell.mix, seed, seconds, False, device,
                  time.perf_counter())
    if first.model is not None:
        run.model, run.params = first.model, first.params
    else:
        run.build()
    run.store, run.adapters = first.store, first.adapters
    run.onboard_s = first.onboard_s
    return run


def _queue(events, t0, t1):
    """Requests submitted and not yet admitted: at ``t0``, at most in
    ``[t0, t1]``, and at ``t1``."""
    marks = sorted((e["ts"], 1 if e["event"] == "submit" else -1)
                   for e in events if e["event"] in ("submit", "admit"))
    n, start, most = 0, None, 0
    for ts, d in marks:
        if ts > t1:
            break
        if start is None and ts >= t0:
            start = n
        n += d
        if ts >= t0:
            most = max(most, n)
    return (n if start is None else start), most, n


def fleet(cell, seed, seconds, device):
    """A run that holds the onboarded fleet the others share."""
    from harness.serve import CellRun

    first = CellRun(cell.cfg, cell.mix, seed, seconds, False, device,
                    time.perf_counter())
    first.onboard()
    first.model = None
    return first


def sweep(cell, seed, seconds, rates, device, first):
    from harness import spec

    first.build()
    for j, rate in enumerate(rates):
        run = _shared(cell, seed, seconds, device, first)
        run.mix = copy.deepcopy(cell.mix)
        run.mix["arrival"]["rate_per_s"] = float(rate)
        run.gen = type(run.gen)(run.mix, cell.cfg["vocab_size"], seed)
        run.start_engine(warm=j == 0)
        run.loop()
        out = run.outcome()
        m = spec.read_metrics(cell.bench, cell.end_to_end + cell.per_layer,
                              out)
        at0, most, at1 = _queue(run.telemetry.events, run.t_w0,
                                run.t_close)
        rows = [len(f.rows) for _, f in out.window.decodes_in()]
        tok = out.window.tokens()
        print(json.dumps({
            "rate": rate, "queue_at_start": at0, "queue_max": most,
            "queue_at_close": at1,
            "rows_mean": sum(rows) / max(1, len(rows)),
            "rows_max": max(rows, default=0),
            "tokens_per_s": (tok["prompt"] + tok["generated"])
            / out.window.seconds,
            **{k: v["value"] for k, v in m.items()}}), flush=True)
        run.rec.uninstall()
        run.telemetry.uninstall_kernel_counter()
        run.engine = run.telemetry = None
    first.model = first.params = run = None
    gc.collect()
    torch.cuda.empty_cache()


def faults(cell, seed, seconds, device, first):
    from harness import faults as planted
    from harness import main as hm

    variants = [("control", None)] + [(f, f) for f in sorted(planted.FAULTS)]
    for name, fault in variants:
        # the reference needs the device the program's weights held: each
        # variant draws them again, and the check frees them
        # planted before the engine is made: it binds the model's steps
        with (planted.planted(fault) if fault else contextlib.nullcontext()):
            run = _shared(cell, seed, seconds, device, first)
            run.start_engine(warm=False)
            res = hm.execute(cell, seed, seconds, False, device,
                             time.perf_counter(), run=run,
                             control=fault is None)
        print(json.dumps({"variant": name, "seed": seed,
                          "correct": res["correct"],
                          "attempted": res["attempted"],
                          "checks": res["checks"]}), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("modes", nargs="+", choices=("sweep", "faults"))
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--rates", type=float, nargs="*", default=[])
    p.add_argument("--device", default="cuda")
    p.add_argument("--root", default=str(ROOT))
    args = p.parse_args(argv)

    from harness.spec import Cell

    cell = Cell(Path(args.root), args.workload)
    first = fleet(cell, args.seed, args.seconds, args.device)
    if "sweep" in args.modes:
        sweep(cell, args.seed, args.seconds, args.rates, args.device, first)
    if "faults" in args.modes:
        faults(cell, args.seed, args.seconds, args.device, first)
    return 0


if __name__ == "__main__":
    sys.exit(main())
