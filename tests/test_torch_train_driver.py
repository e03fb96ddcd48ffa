"""The port's training driver (``launch/train.py``) on the CPU.

With the reference test's arguments (olmo-1b smoke, 8 steps, batch 2, seq
32, a checkpoint every 4 steps) the driver's per-step losses match a loop
of the reference's ``make_train_step`` over the same batches within 1e-5:
the reference's own driver fails before its first step (ROADMAP C1), so
the loop stands in for it. The parameters are the reference's, bridged in
by a test-only patch of ``Model.init``. A run stopped by SIGTERM after 4
steps and resumed equals an uninterrupted run bit for bit, in process and
as a subprocess; the straggler watchdog is the reference's; world size
above 1 and a missing GPU are refused.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke_cfg
from repro.data import pipeline as jdata
from repro.launch import step as jstep
from repro.models import build_model as j_build_model
from repro.optim import OptimizerConfig as JOptimizerConfig
from repro.optim import init_opt_state as j_init_opt_state
from repro_torch.bridge import to_torch
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch import train
from repro_torch.models.model import Model

SRC = Path(__file__).resolve().parents[1] / "src"
ARGS = ["--arch", "olmo-1b", "--steps", "8", "--batch", "2", "--seq", "32",
        "--ckpt-every", "4", "--log-every", "100", "--device", "cpu"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: small tensors, and the same summation on every
    run, in process or not."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def recorded(monkeypatch):
    """Every step's metrics of every driver run, in order; with
    ``stop_after`` set, the driver is sent SIGTERM after that many steps
    of the run."""
    rec = {"metrics": [], "stop_after": None}
    make = train.make_train_step

    def wrapped(*a, **kw):
        fn = make(*a, **kw)
        done = [0]

        def step(*sa):
            out = fn(*sa)
            rec["metrics"].append({k: v.clone() for k, v in out[2].items()})
            done[0] += 1
            if done[0] == rec["stop_after"]:
                signal.raise_signal(signal.SIGTERM)
            return out
        return step

    monkeypatch.setattr(train, "make_train_step", wrapped)
    return rec


def ckpt_bytes(directory, step):
    d = Path(directory) / f"step_{step:08d}"
    out = {}
    for name in ("params.npz", "opt_state.npz"):
        with np.load(d / name) as z:
            out.update({f"{name}:{k}": z[k] for k in z.files})
    return out


def assert_same_ckpt(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_driver_matches_reference_step_loop(tmp_path, recorded, monkeypatch):
    cfg = smoke_cfg("olmo-1b")
    jparams = j_build_model(cfg).init(jax.random.PRNGKey(0))
    monkeypatch.setattr(Model, "init", lambda self, seed=0, device="cuda":
                        to_torch(jparams, device))
    params = train.main(ARGS + ["--ckpt-dir", str(tmp_path)])
    got = [float(m["loss"]) for m in recorded["metrics"]]
    assert len(got) == 8

    jfn = jax.jit(jstep.make_train_step(
        j_build_model(cfg), JOptimizerConfig(lr=2e-4, total_steps=8)))
    jp, jst = jparams, j_init_opt_state(jparams["lora"])
    dc = jdata.DataConfig(seq_len=32, global_batch=2, vocab=cfg.vocab,
                          seed=0)
    want = []
    for step in range(8):
        b = {k: jnp.asarray(v) for k, v in jdata.make_batch(dc, step).items()}
        jp, jst, jm = jfn(jp, jst, b)
        want.append(jm)
    for i, (g, w) in enumerate(zip(recorded["metrics"], want)):
        for k in ("loss", "ce", "lr", "grad_norm"):
            np.testing.assert_allclose(float(g[k]), float(w[k]), rtol=1e-5,
                                       err_msg=f"step {i} {k}")
    assert CheckpointManager(str(tmp_path)).list_steps() == [3, 7]
    assert set(params) == {"base", "lora"}


def test_resume_equals_uninterrupted_bit_for_bit(tmp_path, recorded):
    a, b = tmp_path / "a", tmp_path / "b"
    train.main(ARGS + ["--ckpt-dir", str(a)])
    full = recorded["metrics"][:]
    recorded["metrics"].clear()
    recorded["stop_after"] = 4                   # SIGTERM during step 3
    train.main(ARGS + ["--ckpt-dir", str(b)])
    assert len(recorded["metrics"]) == 4
    assert CheckpointManager(str(b)).list_steps() == [3]
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL
    recorded["stop_after"] = None
    train.main(ARGS + ["--ckpt-dir", str(b)])
    assert len(recorded["metrics"]) == 8
    for i, (g, w) in enumerate(zip(recorded["metrics"], full)):
        for k in w:
            assert torch.equal(g[k], w[k]), (i, k)
    assert_same_ckpt(ckpt_bytes(b, 7), ckpt_bytes(a, 7))
    assert CheckpointManager(str(b)).list_steps() == [3, 7]


def _driver(ckpt, steps):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "olmo-1b", "--steps", str(steps), "--batch", "2", "--seq", "32",
         "--ckpt-every", "4", "--log-every", "1", "--device", "cpu",
         "--ckpt-dir", str(ckpt)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def test_sigterm_saves_exits_and_resumes(tmp_path):
    """A driver subprocess sent SIGTERM after its step-3 line finishes the
    step in flight, saves it, exits 0; resumed, it ends where an
    uninterrupted run ends, bit for bit."""
    steps = 30
    whole = _driver(tmp_path / "whole", steps)
    cut = _driver(tmp_path / "cut", steps)
    lines = []
    try:
        for line in cut.stdout:
            lines.append(line)
            if line.startswith("[train] step 3 "):
                cut.send_signal(signal.SIGTERM)
                break
        rest, _ = cut.communicate(timeout=120)
        whole_out, _ = whole.communicate(timeout=240)
    finally:
        for p in (cut, whole):
            if p.poll() is None:
                p.kill()
                p.wait()
    lines += rest.splitlines(keepends=True)
    assert cut.returncode == 0, "".join(lines)[-3000:]
    assert whole.returncode == 0, whole_out[-3000:]
    assert any("caught signal" in l for l in lines)
    done = [int(l.split()[2]) for l in lines if l.startswith("[train] step ")]
    last = done[-1]
    assert 3 <= last < steps - 1, lines
    mgr = CheckpointManager(str(tmp_path / "cut"))
    assert mgr.list_steps()[-1] == last
    resumed = _driver(tmp_path / "cut", steps)
    out, _ = resumed.communicate(timeout=240)
    assert resumed.returncode == 0, out[-3000:]
    assert f"[train] resumed from step {last}" in out
    assert_same_ckpt(ckpt_bytes(tmp_path / "cut", steps - 1),
                     ckpt_bytes(tmp_path / "whole", steps - 1))


def test_straggler_watchdog_flags_outliers():
    w = train.StragglerWatchdog(factor=2.0, warmup=3)
    flagged = [w.record(0.1) for _ in range(10)]
    assert not any(flagged)
    assert w.record(0.5) is True
    assert w.flagged == 1


_RANK = r"""
import sys
import torch.distributed as dist
from repro_torch.launch.train import main
rank, store = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=2)
try:
    main(["--arch", "olmo-1b", "--steps", "2", "--batch", "2", "--seq",
          "8", "--device", "cpu"])
    print("RAN")
except NotImplementedError as e:
    print("REFUSED", e)
finally:
    if dist.is_initialized():
        dist.destroy_process_group()
"""


def test_world_size_above_one_names_a9b(tmp_path):
    """Two gloo ranks: the host mesh is (1, 2), a 'model' axis of 2, which
    the driver refuses, naming ROADMAP A9b."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(tmp_path / "store")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
        assert "REFUSED" in out and "A9b" in out, out[-3000:]


def test_missing_gpu_refused(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--arch", "olmo-1b", "--steps", "1"])
