"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU, on
``meta``.

* For all 10 archs at (16, 16) and (2, 16, 16): ``active_param_count``,
  every cell's ``model_flops`` and ``params_bytes_per_chip`` equal the
  reference's (its ``_tree_bytes_sharded`` over ``named_shardings`` of its
  ``eval_shape`` params), computed in a subprocess that imports
  ``repro.launch.dryrun`` (512 host devices) and compiles nothing.
* On a fake (2, 2) mesh at a smoke config: the collective bytes by kind
  of one dense FFN's forward and backward equal a count derived by hand
  from the port's collectives, and the FLOPs of its sharded matmuls,
  summed over the four fake ranks, equal the single-device count.
* One full-width ``llama3.2-3b × decode_32k`` cell at (16, 16) runs on
  ``meta`` in under 60 s; its report keeps the reference's keys.
* The hardware model is the H100's, each constant a spec value.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from repro_torch.configs import ARCH_IDS, SHAPE_CELLS, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh

SRC = Path(__file__).resolve().parents[1] / "src"
ENV = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
           OMP_NUM_THREADS="1")

_REFERENCE = r"""
import json, sys
import jax
from repro.launch import dryrun
from repro.configs import ARCH_IDS, SHAPE_CELLS, get_config
from repro.launch.mesh import make_production_mesh
from repro.models import build_model
from repro.parallel.sharding import named_shardings

out = {}
meshes = {m: make_production_mesh(multi_pod=m) for m in (False, True)}
for arch in ARCH_IDS:
    cfg = get_config(arch)
    params = jax.eval_shape(build_model(cfg).init, jax.random.PRNGKey(0))
    out[arch] = {
        "active": dryrun.active_param_count(cfg),
        "model_flops": {s: dryrun.model_flops(cfg, k, seq, b)
                        for s, (seq, b, k) in SHAPE_CELLS.items()},
        "params_bytes": {str(m): dryrun._tree_bytes_sharded(
            params, named_shardings(params, mesh), mesh)
            for m, mesh in meshes.items()}}
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "reference.json"
    p = subprocess.run([sys.executable, "-c", _REFERENCE, str(out)],
                       env=ENV, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_counts_match_reference(reference, arch):
    cfg = get_config(arch)
    want = reference[arch]
    assert dryrun.active_param_count(cfg) == want["active"]
    for shape, (seq, batch, kind) in SHAPE_CELLS.items():
        assert dryrun.model_flops(cfg, kind, seq, batch) \
            == want["model_flops"][shape], shape


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_bytes_per_chip_match_reference(reference, arch, multi):
    mesh = make_production_mesh(multi_pod=multi)
    got = dryrun.params_bytes_per_chip(get_config(arch), mesh)
    assert got == reference[arch]["params_bytes"][str(multi)]


# --------------------------------------------------------------------------
# a fake (2, 2) mesh
# --------------------------------------------------------------------------

_FAKE = r"""
import dataclasses, json, sys
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import get_config
from repro_torch.launch.dryrun import fake_mesh_of
from repro_torch.models import build_model
from repro_torch.models.ffn import _dense_ffn_tp, dense_ffn
from repro_torch.models.model import _layer_slice
from repro_torch.parallel.collectives import recording
from repro_torch.parallel.tensor import annotate

T = int(sys.argv[2])
cfg = dataclasses.replace(get_config("llama3.2-3b", "smoke"),
                          dtype=torch.float32)
params = build_model(cfg).init(0, device="cpu")
x = torch.randn(T, cfg.d_model)
with FlopCounterMode(display=False) as fc:
    dense_ffn(x, _layer_slice(params["base"]["groups"][0], 0)["sub_0"]["ffn"],
              None)
out = {"single_flops": fc.get_total_flops(), "rank_flops": []}
for rank in range(4):
    mesh = fake_mesh_of((2, 2), ("data", "model"), "cpu", rank)
    model = build_model(cfg, mesh=mesh)
    local = model.local_params(params)
    bspec, lspec = model._annotated(local)
    base = annotate(_layer_slice(local["base"]["groups"][0], 0),
                    bspec[0])["sub_0"]["ffn"]
    lora = annotate(_layer_slice(local["lora"]["groups"][0], 0),
                    lspec[0])["sub_0"]["ffn"]
    xl = x[rank // 2 * T // 2:(rank // 2 + 1) * T // 2]
    with FlopCounterMode(display=False) as fc:
        _dense_ffn_tp(xl, base, None, "silu", 2.0, model.tp)
    out["rank_flops"].append(fc.get_total_flops())
    if rank == 0:
        xg = xl.clone().requires_grad_(True)
        lora = {k: {f: t.detach().requires_grad_(True) for f, t in v.items()}
                for k, v in lora.items()}
        annotate(lora, lspec[0]["sub_0"]["ffn"])
        with recording() as rec:
            y = _dense_ffn_tp(xg, base, lora, "silu", 2.0, model.tp)
            y.sum().backward()
        out["record"] = rec
    dist.destroy_process_group()
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module")
def fake(tmp_path_factory):
    out = tmp_path_factory.mktemp("fake") / "fake.json"
    p = subprocess.run([sys.executable, "-c", _FAKE, str(out), "8"],
                       env=ENV, capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(out.read_text())


def test_fake_2x2_collective_bytes_by_hand(fake):
    """One dense FFN (``wg`` / ``wu`` column-, ``wd`` row-parallel, each
    base weight's in or out dim sliced over the 2 data ranks) forward and
    backward on rank 0's 4 token rows (fp32, LoRA rank r):

    * all-gather: each base weight's data slices (no backward): ``wg``
      and ``wu`` ``(d, f/2)``, ``wd`` ``(f/2, d)``; in the backward, the
      gradient of ``wd``'s replicated ``a`` ``(r, f)``;
    * all-reduce (charged twice): forward ``wd``'s rank-r ``h`` and its
      output ``(T, d)``; backward ``h``'s gradient in each of the three
      linears and ``x``'s gradient once for ``wg`` and ``wu`` together."""
    cfg = get_config("llama3.2-3b", "smoke")
    d, f, r, t = cfg.d_model, cfg.d_ff, cfg.lora_rank, 4
    gathers = 3 * d * (f // 2) * 4 + r * f * 4
    reduces = 2 * (t * r * 4 + t * d * 4) + 2 * (3 * t * r * 4 + t * d * 4)
    got = {}
    for e in fake["record"]:
        got[e["kind"]] = got.get(e["kind"], 0) + e["bytes"]
        assert e["group"] == 2
    assert got == {"all-gather": gathers, "all-reduce": reduces}


def test_fake_2x2_flops_sum_to_single_device(fake):
    assert len(fake["rank_flops"]) == 4
    assert len(set(fake["rank_flops"])) == 1
    assert sum(fake["rank_flops"]) == fake["single_flops"] > 0


# --------------------------------------------------------------------------
# a full-width cell on meta
# --------------------------------------------------------------------------

def test_llama_decode_cell_on_meta_under_60s(tmp_path):
    report = tmp_path / "r.json"
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--device",
         "meta", "--arch", "llama3.2-3b", "--shape", "decode_32k",
         "--report", str(report)],
        env=ENV, capture_output=True, text=True, timeout=120)
    took = time.perf_counter() - t0
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    assert took < 60, took
    (r,) = json.loads(report.read_text())
    cfg = get_config("llama3.2-3b")
    mesh = make_production_mesh()
    assert r["mesh"] == {"data": 16, "model": 16} and r["chips"] == 256
    assert r["device"] == "meta" and r["counted"] == "eager"
    assert r["params_bytes_per_chip"] == dryrun.params_bytes_per_chip(cfg,
                                                                      mesh)
    seq, batch, kind = SHAPE_CELLS["decode_32k"]
    assert r["model_flops_total"] == dryrun.model_flops(cfg, kind, seq,
                                                        batch)
    assert r["counted_flops_per_chip"] > r["model_flops_per_chip"] > 0
    assert set(r["collective_bytes_per_chip"]) == {"all-gather",
                                                   "all-reduce"}
    assert r["memory"]["argument_bytes"] > r["params_bytes_per_chip"]
    assert "peak_bytes" not in r["memory"]
    for k in ("compute_term_s", "memory_term_s", "collective_term_s",
              "roofline_fraction", "useful_flops_ratio"):
        assert r[k] > 0, k
    assert r["dominant_term"] in ("compute", "memory", "collective")


def test_multi_pod_cell_on_meta(tmp_path):
    """(2, 16, 16): the FSDP axes are ("pod", "data") flattened into one
    group of 32, which the frozen base's gathers use."""
    report = tmp_path / "r.json"
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--device",
         "meta", "--arch", "olmo-1b", "--shape", "decode_32k",
         "--multi-pod", "--report", str(report)],
        env=ENV, capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    (r,) = json.loads(report.read_text())
    assert r["mesh"] == {"pod": 2, "data": 16, "model": 16}
    assert r["chips"] == 512 and r["multi_pod"] is True
    assert r["params_bytes_per_chip"] == dryrun.params_bytes_per_chip(
        get_config("olmo-1b"), make_production_mesh(multi_pod=True))
    assert r["collective_bytes_per_chip"]["all-gather"] > 0


def test_hardware_model_is_the_h100():
    assert dryrun.CARD == "NVIDIA H100 80GB HBM3 (SXM5, 700 W)"
    assert (dryrun.PEAK_FLOPS, dryrun.HBM_BW, dryrun.HBM_BYTES) == \
        (989e12, 3.35e12, 80 * 2 ** 30)
    assert (dryrun.NVLINK_BW, dryrun.IB_BW, dryrun.NODE_CARDS) == \
        (450e9, 50e9, 8)
    # a 16-rank axis spans two 8-card nodes: InfiniBand
    assert dryrun.link_rate(16) == dryrun.IB_BW
    assert dryrun.link_rate(8) == dryrun.NVLINK_BW


def test_dryrun_needs_the_card_by_default(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.main(["--arch", "llama3.2-3b", "--shape", "decode_32k"])
