"""Finding a cell's pieces by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
configuration's file is the entry's ``file``, the mix is
``traffic/<traffic>.json``, each metric is read by ``metrics/<name>.py``
(a module with ``read(outcome) -> float | None``) and a cell's limits are
``limits/<cell>.json``. Adding any of them is adding files and entries.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Any, Dict, List


class Cell:
    def __init__(self, root: Path, name: str):
        root = Path(root)
        spec = json.loads((root / "BENCHMARK.json").read_text())
        self.bench = bench = root / spec["paths"][0]
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"known: {sorted(cells)}")
        self.name = name
        self.entry = cells[name]
        configs = {c["name"]: c for c in spec["configs"]}
        self.cfg = json.loads((root / configs[self.entry["config"]]["file"])
                              .read_text())
        self.mix = json.loads(
            (bench / "traffic" / f"{self.entry['traffic']}.json").read_text())
        self.limits = json.loads(
            (bench / "limits" / f"{name}.json").read_text())["limits"]
        self.end_to_end = [m for m in spec["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in spec["per_layer"]
                          if name in m.get("workloads", [name])]
        self.chips = int(self.entry["chips"])


def reader(bench: Path, name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = Path(bench) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(bench: Path, entries: List[Dict[str, Any]],
                 outcome) -> Dict[str, dict]:
    """Each metric's value by its reader; a reader that finds nothing to
    read returns None and the metric is left out."""
    out = {}
    for m in entries:
        value = reader(bench, m["name"])(outcome)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
