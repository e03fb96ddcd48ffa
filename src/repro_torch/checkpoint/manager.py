"""Fault-tolerant checkpointing (port of ``repro/checkpoint/manager.py``),
in the reference's on-disk format, so a checkpoint written by either
package restores in the other:

* ``step_%08d/`` holds ``params.npz`` and ``opt_state.npz``, each keyed by
  the leaves' paths as ``jax.tree_util.keystr`` spells them (``.mu[...]``
  for the optimizer's moments), bf16 stored as fp32 (npz has no bf16), and
  ``meta.json`` (``{"step": ...}`` and any extra fields).
* **Atomic**: written to ``step_XXXXXXXX.tmp/`` then ``rename``d — a
  preempted writer never corrupts the latest valid checkpoint, and
  ``list_steps`` ignores the ``.tmp`` directories.
* **Restartable**: ``restore_latest`` picks the highest complete step; the
  data pipeline is a pure function of step, so a restart is exactly-once.
* **Elastic**: arrays are saved whole; ``restore`` casts each leaf to its
  template leaf's dtype and device and, given specs and a mesh, keeps the
  calling rank's block (:func:`~repro_torch.parallel.sharding.local_block`).
* **Async**: ``save_async`` snapshots to host memory synchronously and
  writes on a background thread — training never blocks on disk.
* **keep-K GC** bounds disk usage.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.optim.adamw import tree_map, tree_map_with_path, tree_paths
from repro_torch.parallel.sharding import local_block

__all__ = ["CheckpointManager"]

_STEP_RE = re.compile(r"^step_(\d{8})$")


def _flatten(tree) -> Dict[str, np.ndarray]:
    """Host copies of every leaf, keyed by path (bf16 → fp32, exactly)."""
    flat = {}
    for path, leaf in tree_paths(tree):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        flat[path] = np.array(t.cpu().numpy())       # a copy, never a view
    return flat


def _unflatten(template, flat: Dict[str, np.ndarray]):
    """The template's structure with each leaf read from ``flat`` by path,
    cast to the template leaf's dtype and moved to its device."""
    def one(path, leaf):
        arr = flat[path]
        if not isinstance(leaf, torch.Tensor):
            return arr
        return torch.from_numpy(arr).to(leaf.dtype).to(leaf.device)

    return tree_map_with_path(one, template)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ----- save -----

    def _write(self, step: int, payload: Dict[str, Dict[str, np.ndarray]],
               meta: Dict[str, Any]):
        name = f"step_{step:08d}"
        tmp = os.path.join(self.directory, name + ".tmp")
        final = os.path.join(self.directory, name)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for group, flat in payload.items():
            np.savez(os.path.join(tmp, f"{group}.npz"), **flat)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _payload(self, step, params, opt_state, extra_meta):
        payload = {"params": _flatten(params)}
        if opt_state is not None:
            payload["opt_state"] = _flatten(opt_state)
        return payload, {"step": step, **(extra_meta or {})}

    def save(self, step: int, params, opt_state=None,
             extra_meta: Optional[Dict[str, Any]] = None):
        self.wait()  # never race an in-flight async write for the same step
        self._write(step, *self._payload(step, params, opt_state,
                                         extra_meta))

    def save_async(self, step: int, params, opt_state=None,
                   extra_meta: Optional[Dict[str, Any]] = None):
        """Snapshot to host synchronously, write on a background thread."""
        payload, meta = self._payload(step, params, opt_state, extra_meta)
        self.wait()
        self._thread = threading.Thread(
            target=self._write, args=(step, payload, meta), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self.list_steps())
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # ----- restore -----

    def list_steps(self):
        out = []
        for d in os.listdir(self.directory):
            m = _STEP_RE.match(d)
            if m and os.path.exists(os.path.join(self.directory, d,
                                                 "meta.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def restore(self, step: int, params_template, opt_template=None,
                specs=None, mesh=None) -> Tuple[Any, Any, Dict[str, Any]]:
        """``(params, opt_state, meta)`` of ``step``; with ``specs`` (a spec
        tree shaped like the params) and ``mesh`` (one with ``coords``),
        each param leaf is this rank's block of the saved array."""
        name = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(name, "meta.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(name, "params.npz")) as z:
            pflat = dict(z)
        params = _unflatten(params_template, pflat)
        if specs is not None:
            params = tree_map(
                lambda t, s: local_block(t, s, mesh, mesh.coords).clone(),
                params, specs)
        opt_state = None
        opt_path = os.path.join(name, "opt_state.npz")
        if opt_template is not None and os.path.exists(opt_path):
            with np.load(opt_path) as z:
                opt_state = _unflatten(opt_template, dict(z))
        return params, opt_state, meta

    def restore_latest(self, params_template, opt_template=None, specs=None,
                       mesh=None):
        steps = self.list_steps()
        if not steps:
            return None
        return self.restore(steps[-1], params_template, opt_template, specs,
                            mesh)
