"""Run one benchmark cell once on the card and print its result line.

    python3 perfbench/run.py --workload mixtral-chat --seed 7 --seconds 40 \\
        --trace 0

from the root of a checkout. ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics from a run with a profiled
stretch. Both check the served tokens against the plain reference. Without
a CUDA card it exits non-zero and prints no result.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the port is served with PyTorch's expandable segments, so that a freed
# prefill's transients do not fragment the device into pieces that the
# next long prefill cannot use
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for _p in (str(ROOT / "src"), str(BENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from harness import main as hm
    from harness.spec import Cell

    cell = Cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("[perfbench] no CUDA device: this benchmark measures the card "
              "and does not fall back to the CPU", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"[perfbench] {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    hm.log(f"{cell.name}: {hm.power_limit()}, torch {torch.__version__}, "
           f"CUDA {torch.version.cuda}")
    result = hm.execute(cell, args.seed, args.seconds, bool(args.trace),
                        "cuda", T_PROCESS)
    return hm.emit(result)


if __name__ == "__main__":
    sys.exit(main())
