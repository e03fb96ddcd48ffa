"""Multi-pod dry run (port of ``repro/launch/dryrun.py``): prove the
distribution config is coherent and count what one device does.

For every (architecture × input-shape) cell, run rank 0's local program of
the production step (the train step for train shapes, ``prefill`` or one
``decode_step`` for inference shapes) on the single-pod ``(16, 16)`` mesh
and the 2-pod ``(2, 16, 16)`` mesh, each a ``DeviceMesh`` over the
``fake`` process-group backend (world 256 / 512, this process rank 0), and
report per device:

* parameter bytes (the rule table's blocks) and memory: on the card the
  peak ``torch.cuda.max_memory_allocated`` around the step, on ``meta``
  the argument bytes only;
* counted FLOPs (``FlopCounterMode``: matmuls, attention) and counted
  bytes (:class:`_ByteCount`: every op's tensor inputs and outputs,
  unfused, views excluded);
* collective bytes by kind, from the record of every collective the step
  issues (``parallel.collectives``): result bytes, all-reduce twice;
* the roofline terms against an NVIDIA H100 80GB HBM3 (SXM5, 700 W)
  hardware model.

The fake backend's collectives leave their outputs as they were: values
are meaningless, so only shapes, bytes, FLOPs and memory are read. Every
index the program computes from such values stays in range (routing picks
top-k of E, capacity is static), so the local program runs as it would.

The port has no HLO: the reference's HLO parser (``collective_bytes``) and
its scan-undercount fit (``extrapolate_cost``) have no counterpart here.
Eager execution runs, and so counts, every layer and microbatch; the
report says so (``"counted": "eager"``). Its keys are the reference's
where the meaning holds; ``counted_flops_per_chip`` /
``counted_bytes_per_chip`` stand for ``hlo_*`` and ``run_s`` for
``lower_s`` / ``compile_s``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --device meta \\
        --arch llama3.2-3b --shape decode_32k [--multi-pod] [--report r.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --device meta --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
        --shape train_4k          # on the card (the default device)
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, SHAPE_CELLS, get_config
from repro_torch.data.pipeline import DataConfig, make_batch_specs
from repro_torch.launch.mesh import mesh_over
from repro_torch.launch.step import make_train_step
from repro_torch.models import build_model
from repro_torch.optim import OptimizerConfig, init_opt_state
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.parallel.collectives import recording
from repro_torch.parallel.sharding import batch_specs, shard_tree

__all__ = ["active_param_count", "lower_cell", "main", "model_flops",
           "params_bytes_per_chip"]

# ---------------------------------------------------------------------------
# hardware model: NVIDIA H100 80GB HBM3 (SXM5, 700 W), spec values
# ---------------------------------------------------------------------------
CARD = "NVIDIA H100 80GB HBM3 (SXM5, 700 W)"
PEAK_FLOPS = 989e12          # bf16 per card, dense tensor cores (spec)
HBM_BW = 3.35e12             # bytes/s per card, HBM3 (spec)
HBM_BYTES = 80 * 2 ** 30     # per card (spec: 80 GiB)
NVLINK_BW = 450e9            # bytes/s per direction per card, NVLink 4,
                             # inside an 8-card node (spec)
IB_BW = 50e9                 # bytes/s per card across nodes, NDR InfiniBand
                             # (400 Gb/s per card, spec)
NODE_CARDS = 8               # cards per node behind one NVLink switch
# A collective over a group of more than NODE_CARDS ranks crosses nodes and
# runs at the InfiniBand rate: every axis of the (16, 16) and (2, 16, 16)
# meshes does (the model axis spans two nodes, the data axis sixteen).


def link_rate(group_size: int) -> float:
    """Bytes/s per card of a collective over ``group_size`` ranks."""
    return NVLINK_BW if group_size <= NODE_CARDS else IB_BW


# ---------------------------------------------------------------------------
# analytic counts (the reference's, unchanged)
# ---------------------------------------------------------------------------

def model_flops(cfg, shape_kind: str, seq: int, batch: int) -> float:
    """6·N_active·tokens (train) or 2·N_active·tokens (inference)."""
    n = active_param_count(cfg)
    toks = batch * (1 if shape_kind == "decode" else seq)
    return (6.0 if shape_kind == "train" else 2.0) * n * toks


def active_param_count(cfg) -> float:
    """Analytic active-parameter count (MoE counts top-k + shared experts)."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab
    h, kv = cfg.n_heads, cfg.n_kv_heads
    dh = cfg.resolved_head_dim
    total = v * d * (1 if cfg.tie_embeddings else 2)
    if cfg.n_codebooks:
        total *= cfg.n_codebooks
    for block in cfg.blocks:
        for mk, fk in zip(block.pattern, block.ffn):
            if mk in ("attn", "local_attn"):
                mix = d * h * dh + 2 * d * kv * dh + h * dh * d
            elif mk == "mla":
                m = cfg.mla
                qd = m.nope_head_dim + m.rope_head_dim
                mix = (d * m.q_lora_rank + m.q_lora_rank * h * qd
                       + d * m.kv_lora_rank + d * m.rope_head_dim
                       + m.kv_lora_rank * h * (m.nope_head_dim + m.v_head_dim)
                       + h * m.v_head_dim * d)
            elif mk == "rwkv":
                mix = 5 * d * d
            elif mk == "rglru":
                w = cfg.rglru_width or d
                mix = 2 * d * w + 2 * w * w + w * d
            else:
                mix = 0
            if fk == "dense":
                ff = 3 * d * f
            elif fk == "moe":
                mc = cfg.moe
                ff = (3 * d * mc.d_ff_expert * (mc.top_k + mc.n_shared)
                      + d * mc.n_experts)
            elif fk == "rwkv_cm":
                ff = 2 * d * f + d * d
            else:
                ff = 0
            total += (mix + ff) * block.count
    return float(total)


def _axis_size(mesh, entry) -> int:
    axes = () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))
    return int(np.prod([mesh.shape[a] for a in axes])) if axes else 1


def _tree_bytes_sharded(tree, specs, mesh) -> int:
    """Per-device bytes of a tree of (meta) tensors under the given specs."""
    total = 0
    by_leaf = {}
    tree_map(lambda t, s: by_leaf.setdefault(id(t), s), tree, specs)
    for leaf in tree_leaves(tree):
        size = leaf.numel() * leaf.element_size()
        shard = 1
        for entry in by_leaf[id(leaf)]:
            shard *= _axis_size(mesh, entry)
        total += size // shard
    return total


def params_bytes_per_chip(cfg, mesh) -> int:
    """Per-device bytes of the whole parameter tree under the rule table."""
    params = build_model(cfg).init(device="meta")
    return _tree_bytes_sharded(params, shard_tree(params, mesh), mesh)


def _all_local(cfg) -> bool:
    return all(mk != "attn" for b in cfg.blocks for mk in b.pattern)


def _cache_cap(cfg, seq: int) -> int:
    """Global-attention archs need capacity = seq; windowed archs bound it."""
    has_global = any(mk in ("attn", "mla")
                     for b in cfg.blocks for mk in b.pattern)
    return seq if has_global else min(seq, cfg.window)


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------

class _ByteCount(TorchDispatchMode):
    """Sums the bytes of every op's tensor inputs and outputs (each op
    unfused: what it would read and write alone); views and collectives
    (counted apart) excluded."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func.namespace != "c10d":
            self.bytes += _nbytes(args) + _nbytes(out)
            if kwargs:
                self.bytes += _nbytes(tuple(kwargs.values()))
        return out


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


# ---------------------------------------------------------------------------
# the cell's local program
# ---------------------------------------------------------------------------

def _local(t, spec, mesh, dev, gen):
    """A tensor of the block shape ``spec`` gives ``t`` on ``mesh``: on
    ``meta`` shapes only, on the card filled from ``gen``."""
    shape = [n // _axis_size(mesh, e) for n, e in zip(t.shape, spec)]
    out = torch.empty(shape, dtype=t.dtype, device=dev)
    if dev.type != "meta":
        if t.dtype.is_floating_point:
            out.normal_(0.0, 0.02, generator=gen)
        else:
            out.random_(-127, 128, generator=gen)
    return out


def _local_batch(cfg, seq, batch, mesh, dev, gen, kind):
    specs = make_batch_specs(DataConfig(
        seq_len=seq, global_batch=batch, vocab=cfg.vocab,
        n_codebooks=cfg.n_codebooks, vision_tokens=0, d_model=cfg.d_model))
    if kind != "train":
        specs.pop("targets")
    out = {}
    for k, t in specs.items():
        spec = batch_specs({k: t}, mesh)[k]
        shape = [n // _axis_size(mesh, e) for n, e in zip(t.shape, spec)]
        if t.dtype.is_floating_point:
            out[k] = _local(torch.empty(shape, dtype=t.dtype,
                                        device="meta"),
                            (None,) * len(shape), mesh, dev, gen)
        elif dev.type == "meta":
            out[k] = torch.empty(shape, dtype=torch.int64, device=dev)
        else:
            out[k] = torch.randint(0, cfg.vocab, shape, generator=gen,
                                   device=dev)
    return out


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def lower_cell(arch: str, shape: str, mesh, n_microbatches: int = 16,
               device="cuda", seed: int = 0):
    """Run rank 0's local program of one (arch × shape × mesh) cell under
    the counters; return the report dict. ``mesh`` is a host mesh over the
    fake process group."""
    seq, batch, kind = SHAPE_CELLS[shape]
    cfg = get_config(arch)
    if shape == "long_500k" and not cfg.subquadratic:
        return {"arch": arch, "shape": shape, "skipped":
                "full attention at 500k context (DESIGN.md §3)"}
    dev = resolve_device(device)
    gen = (torch.Generator(device=dev).manual_seed(seed)
           if dev.type != "meta" else None)
    model = build_model(
        cfg, remat=(kind == "train"), mesh=mesh,
        force_blockwise=(seq > 8192 and kind != "decode") or None)
    params_t = build_model(cfg).init(device="meta")
    specs = model.param_specs(params_t)
    params = tree_map(lambda t, s: _local(t, s, mesh, dev, gen), params_t,
                      specs)
    b = _local_batch(cfg, seq, batch, mesh, dev, gen, kind)
    rows = b["tokens"].shape[0]
    if kind == "train":
        # each microbatch takes whole rows of this rank's batch
        n_micro = max(m for m in range(1, min(n_microbatches, rows) + 1)
                      if rows % m == 0)
        opt = init_opt_state(params["lora"])
        step = make_train_step(model, OptimizerConfig(), n_micro)
        args = (params, opt, b)
        arg_bytes = _tensor_bytes(args)

        def run():
            return step(*args)
    elif kind == "prefill":
        n_micro = 1
        capacity = min(seq, cfg.window) if _all_local(cfg) else seq
        arg_bytes = _tensor_bytes((params, b))

        def run():
            return model.prefill(params, b, capacity)
    else:
        n_micro = 1
        caches = model.init_cache(rows, _cache_cap(cfg, seq), device=dev)
        tokens = b["tokens"][..., -1:]
        pos = torch.full((rows,), _cache_cap(cfg, seq) - 1, device=dev)
        arg_bytes = _tensor_bytes((params, tokens, caches))

        def run():
            return model.decode_step(params, tokens, caches, pos)

    sync = (torch.cuda.synchronize if dev.type == "cuda" else (lambda: None))
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc, _ByteCount() as bc, \
            recording() as rec:
        run()
        sync()
    run_s = time.perf_counter() - t0
    report_mem = {"argument_bytes": int(arg_bytes)}
    step_s = None
    if dev.type == "cuda":
        # the same step again, uncounted: its time and peak memory
        torch.cuda.reset_peak_memory_stats()
        sync()
        t0 = time.perf_counter()
        run()
        sync()
        step_s = time.perf_counter() - t0
        report_mem["peak_bytes"] = int(torch.cuda.max_memory_allocated())
        report_mem["card_bytes"] = int(
            torch.cuda.get_device_properties(dev).total_memory)

    n_chips = int(np.prod(list(mesh.shape.values())))
    flops = float(fc.get_total_flops())
    nbytes = float(bc.bytes)
    colls, coll_term = {}, 0.0
    for r in rec:
        colls[r["kind"]] = colls.get(r["kind"], 0.0) + r["bytes"]
        coll_term += r["bytes"] / link_rate(r["group"])
    compute_term = flops / PEAK_FLOPS if flops > 0 else None
    memory_term = nbytes / HBM_BW if nbytes > 0 else None
    mflops = model_flops(cfg, kind, seq, batch)
    report = {
        "arch": arch, "shape": shape, "kind": kind,
        "mesh": dict(mesh.shape), "chips": n_chips,
        "microbatches": n_micro, "device": str(dev), "counted": "eager",
        "hardware": CARD, "run_s": run_s, "step_s": step_s,
        "counted_flops_per_chip": flops,
        "counted_bytes_per_chip": nbytes,
        "collective_bytes_per_chip": colls,
        "collectives_issued": len(rec),
        "params_bytes_per_chip": _tree_bytes_sharded(params_t, specs, mesh),
        "model_flops_total": mflops,
        "model_flops_per_chip": mflops / n_chips,
        "compute_term_s": compute_term,
        "memory_term_s": memory_term,
        "collective_term_s": coll_term,
        "memory": report_mem,
    }
    terms = {k: v for k, v in (("compute", compute_term),
                               ("memory", memory_term),
                               ("collective", coll_term)) if v}
    if terms:
        report["dominant_term"] = max(terms, key=terms.get)
        report["roofline_fraction"] = (
            (mflops / n_chips / PEAK_FLOPS) / max(terms.values()))
        report["useful_flops_ratio"] = (
            mflops / n_chips / flops if flops > 0 else None)
    return report


# ---------------------------------------------------------------------------
# the fake process group
# ---------------------------------------------------------------------------

def fake_mesh(multi_pod: bool, device="cuda", rank: int = 0):
    """Start the ``fake`` process group at ``rank`` of the production
    layout's world and return the host mesh over it (the caller destroys
    the group: ``dist.destroy_process_group()``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return fake_mesh_of(shape, names, device, rank)


def fake_mesh_of(shape, names, device="cuda", rank: int = 0):
    """The ``fake`` process group at ``rank`` of a world of ``shape`` and
    the host mesh over it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already up")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=int(np.prod(shape)))
    return mesh_over(shape, names, device=device)


def _check_card(dev):
    """The hardware model holds for the card it names: refuse another."""
    if dev.type != "cuda":
        return
    total = torch.cuda.get_device_properties(dev).total_memory
    if not 0.9 * HBM_BYTES <= total <= HBM_BYTES:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(dev)} has {total} bytes; the "
            f"hardware model is the {CARD} ({HBM_BYTES} bytes)")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None)
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--both-meshes", action="store_true")
    p.add_argument("--all", action="store_true")
    p.add_argument("--microbatches", type=int, default=16)
    p.add_argument("--report", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default: the card) or meta (counts only)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    _check_card(dev)

    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = (list(SHAPE_CELLS) if (args.all or args.shape is None)
              else [args.shape])
    meshes = ([False, True] if (args.both_meshes or args.all)
              else [args.multi_pod])

    reports = []
    for multi in meshes:
        mesh = fake_mesh(multi, dev)
        try:
            for arch in archs:
                for shape in shapes:
                    tag = f"{arch} × {shape} × {'2pod' if multi else '1pod'}"
                    try:
                        r = lower_cell(arch, shape, mesh, args.microbatches,
                                       dev)
                        r["multi_pod"] = multi
                        if "skipped" in r:
                            print(f"[dryrun] SKIP {tag}: {r['skipped']}")
                        else:
                            _print(tag, r)
                    except Exception as e:           # noqa: BLE001
                        r = {"arch": arch, "shape": shape,
                             "multi_pod": multi,
                             "error": f"{type(e).__name__}: {e}"}
                        print(f"[dryrun] FAIL {tag}: {r['error'][:300]}")
                    reports.append(r)
                    if dev.type == "cuda":
                        torch.cuda.empty_cache()
                    sys.stdout.flush()
        finally:
            dist.destroy_process_group()

    if args.report:
        with open(args.report, "w") as f:
            json.dump(reports, f, indent=1)
        print(f"[dryrun] wrote {args.report}")
    n_ok = sum(1 for r in reports if "error" not in r and "skipped" not in r)
    n_skip = sum(1 for r in reports if "skipped" in r)
    n_fail = sum(1 for r in reports if "error" in r)
    print(f"[dryrun] {n_ok} ok, {n_skip} skipped, {n_fail} FAILED")
    return 1 if n_fail else 0


def _print(tag, r):
    mem = r["memory"]
    peak = (f" peak {mem['peak_bytes'] / 2 ** 30:.2f} GiB"
            if "peak_bytes" in mem else "")
    print(f"[dryrun] OK   {tag}: run {r['run_s']:.1f}s "
          f"flops/chip {r['counted_flops_per_chip']:.4g} "
          f"bytes/chip {r['counted_bytes_per_chip']:.4g} "
          f"dominant {r.get('dominant_term')} roofline "
          f"{r.get('roofline_fraction') and round(r['roofline_fraction'], 4)}")
    print(f"         params {r['params_bytes_per_chip'] / 2 ** 30:.3f} GiB "
          f"args {mem['argument_bytes'] / 2 ** 30:.3f} GiB{peak}")
    print(f"         collectives: "
          f"{ {k: f'{v / 1e6:.1f}MB' for k, v in r['collective_bytes_per_chip'].items()} }")


if __name__ == "__main__":
    sys.exit(main())
