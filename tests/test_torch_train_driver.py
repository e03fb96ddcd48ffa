"""The port's training driver (``launch/train.py``) on the CPU.

With the reference test's arguments (olmo-1b smoke, 8 steps, batch 2, seq
32, a checkpoint every 4 steps) the driver's per-step losses match a loop
of the reference's ``make_train_step`` over the same batches within 1e-5:
the reference's own driver fails before its first step (ROADMAP C1), so
the loop stands in for it. The parameters are the reference's, bridged in
by a test-only patch of ``Model.init``. A run stopped by SIGTERM after 4
steps and resumed equals an uninterrupted run bit for bit, in process and
as a subprocess; the straggler watchdog is the reference's; two gloo ranks
(mesh (1, 2)) match the reference's loop under a (1, 2) mesh and write a
checkpoint that one rank and the reference restore; a missing GPU is
refused.
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
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.checkpoint.manager import _unflatten
from repro_torch.launch import train
from repro_torch.models.model import Model

torch.set_num_threads(1)
rank, store, params, out, ckpt = (int(sys.argv[1]), sys.argv[2],
                                  sys.argv[3], sys.argv[4], sys.argv[5])
init = Model.init
with np.load(params) as z:
    flat = dict(z)
Model.init = lambda self, seed=0, device="cuda": _unflatten(
    init(self, seed, "cpu"), flat)
losses = []
make = train.make_train_step

def wrapped(*a, **kw):
    fn = make(*a, **kw)
    def step(*sa):
        res = fn(*sa)
        losses.append({k: float(v) for k, v in res[2].items()})
        return res
    return step

train.make_train_step = wrapped
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=2)
try:
    train.main(["--arch", "olmo-1b", "--steps", "6", "--batch", "2",
                "--seq", "32", "--ckpt-every", "3", "--log-every", "1",
                "--device", "cpu", "--ckpt-dir", ckpt])
finally:
    if dist.is_initialized():
        dist.destroy_process_group()
with open(out, "w") as f:
    json.dump(losses, f)
"""

# the reference's train-step loop on an Auto-axes (1, 2) mesh of 2 host
# devices (its driver fails before its first step: ROADMAP C1)
_REFERENCE = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from conftest import smoke_cfg
from repro.data import pipeline as jdata
from repro.launch import step as jstep
from repro.models import build_model
from repro.optim import OptimizerConfig, init_opt_state
from repro.parallel.sharding import named_shardings

params_path, out = sys.argv[1], sys.argv[2]
cfg = smoke_cfg("olmo-1b")
model = build_model(cfg, mesh=Mesh(np.array(jax.devices()[:2]).reshape(
    1, 2), ("data", "model")))
tmpl = build_model(cfg).init(jax.random.PRNGKey(0))
with np.load(params_path) as z:
    flat = dict(z)
leaves, tdef = jax.tree_util.tree_flatten_with_path(tmpl)
params = jax.tree_util.tree_unflatten(tdef, [
    jnp.asarray(flat[jax.tree_util.keystr(p)]) for p, _ in leaves])
params = jax.device_put(params, named_shardings(params, model.mesh))
fn = jax.jit(jstep.make_train_step(model, OptimizerConfig(lr=2e-4,
                                                          total_steps=6)))
st = init_opt_state(params["lora"])
dc = jdata.DataConfig(seq_len=32, global_batch=2, vocab=cfg.vocab, seed=0)
rec = []
for step in range(6):
    b = {k: jnp.asarray(v) for k, v in jdata.make_batch(dc, step).items()}
    params, st, m = fn(params, st, b)
    rec.append({k: float(v) for k, v in m.items()})
with open(out, "w") as f:
    json.dump(rec, f)
"""


def test_world_size_above_one_names_a9b(tmp_path, monkeypatch, recorded):
    """Two gloo ranks: the host mesh is (1, 2), pure tensor parallelism
    over a 'model' axis of 2 (ROADMAP A9b). The driver's per-step metrics
    match the reference's train-step loop under an Auto-axes (1, 2) mesh
    within 1e-5; its checkpoints hold the global arrays, which a 1-rank
    run restores (and saves again bit for bit) and the reference's
    CheckpointManager restores."""
    from repro.checkpoint.manager import CheckpointManager as JManager

    cfg = smoke_cfg("olmo-1b")
    jparams = j_build_model(cfg).init(jax.random.PRNGKey(0))
    ppath = tmp_path / "params.npz"
    np.savez(ppath, **{jax.tree_util.keystr(p): np.asarray(l) for p, l in
                       jax.tree_util.tree_flatten_with_path(jparams)[0]})
    ckpt = tmp_path / "ckpt"
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(tmp_path / "store"),
         str(ppath), str(tmp_path / f"rank{r}.json"), str(ckpt)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    procs.append(subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(ppath),
         str(tmp_path / "ref.json")],
        env=dict(env, PYTHONPATH=f"{SRC}{os.pathsep}{Path(__file__).parent}"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    want = json.loads((tmp_path / "ref.json").read_text())
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text())
             for r in range(2)]
    assert ranks[0] == ranks[1] and len(ranks[0]) == 6
    for i, (g, w) in enumerate(zip(ranks[0], want)):
        for k in ("loss", "ce", "lr", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5,
                                       err_msg=f"step {i} {k}")
    assert CheckpointManager(str(ckpt)).list_steps() == [2, 5]

    # a 1-rank run restores the 2-rank checkpoint (global arrays) and,
    # with no step left, saves it again as step 6
    monkeypatch.setattr(Model, "init", lambda self, seed=0, device="cuda":
                        to_torch(jparams, device))
    train.main(["--arch", "olmo-1b", "--steps", "6", "--batch", "2",
                "--seq", "32", "--device", "cpu", "--ckpt-dir", str(ckpt)])
    assert_same_ckpt(ckpt_bytes(ckpt, 6), ckpt_bytes(ckpt, 5))

    # the reference's manager restores it into its own trees
    lora = jparams["lora"]
    jp, jo, meta = JManager(str(ckpt)).restore(5, lora,
                                               j_init_opt_state(lora))
    assert meta["step"] == 5
    saved = ckpt_bytes(ckpt, 5)
    for p, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        np.testing.assert_array_equal(
            np.asarray(leaf), saved["params.npz:" + jax.tree_util.keystr(p)])
    for p, leaf in jax.tree_util.tree_flatten_with_path(jo)[0]:
        np.testing.assert_array_equal(
            np.asarray(leaf),
            saved["opt_state.npz:" + jax.tree_util.keystr(p)])


def test_missing_gpu_refused(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--arch", "olmo-1b", "--steps", "1"])
