"""Port vs reference under a ``model`` axis: tensor parallelism at meshes
(1, 2) and (2, 2), on the CPU (mixtral's weight-FSDP expert layout and
gemma2's blockwise attention among them).

The reference runs in two subprocesses whose JAX sees 4 forced host
devices, under an Auto-axes ``Mesh(devices[:n].reshape(shape), ("data",
"model"))`` with its parameters placed by ``named_shardings`` of its rule
table; ``pjit`` propagates from there. It initializes each case's
parameters (every LoRA ``B`` drawn nonzero, so A's gradients do not
vanish) and writes them keyed by path; the port's ranks (2 or 4 gloo
processes meeting through a ``file://`` store) read them, take their
blocks and rows, and run the same programs.

Each case holds: the loss, CE and aux within 1e-5 relative; every LoRA
gradient (gathered by its spec; replicated leaves identical on every
rank) within 1e-5 of its max |grad|; one AdamW step (the global-norm clip
across shards) within 5 % of lr; ``prefill`` and 4 ``decode_step`` logits
within 1e-4 of max |logit|; and each rank's leaves equal to
``local_block`` of the rule table's spec, bit for bit. mixtral at (2, 2)
is held against the reference's (2, 1), where the reference itself raises
(ROADMAP C11).
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.optim.adamw import tree_map, tree_paths
from repro_torch.parallel.sharding import AbstractMesh

SRC = Path(__file__).resolve().parents[1] / "src"
RTOL = 1e-5
LOGIT_RTOL = 1e-4
LR = 2e-4
STEPS = 10                     # the schedule's length: step 1 is in warmup
BATCH, SEQ, DECODE = 4, 16, 4
TIMEOUT = 600

ARCHS = {"llama": "llama3.2-3b", "gemma2": "gemma2-2b",
         "qwen2vl": "qwen2-vl-72b", "deepseek": "deepseek-v3-671b",
         "rwkv6": "rwkv6-1.6b", "recgemma": "recurrentgemma-2b",
         "mixtral": "mixtral-8x22b"}
# name: (arch, the port's mesh, the reference's mesh, config overrides
# (``moe`` ones nested), model overrides)
CASES = {f"{k}_{d}x2": (a, (d, 2), (d, 2), {}, {})
         for k, a in ARCHS.items() for d in (1, 2) if k != "mixtral"}
CASES["mixtral_1x2"] = ("mixtral-8x22b", (1, 2), (1, 2), {}, {})
CASES["mixtral_2x2"] = ("mixtral-8x22b", (2, 2), (2, 1), {}, {})  # C11
# E = 3 does not divide the 2 data ranks: the weight-FSDP expert layout,
# f split over 'model'
CASES["mixtral_fsdp_2x2"] = ("mixtral-8x22b", (2, 2), (2, 2),
                             {"moe": {"n_experts": 3}}, {})
# gemma2's window and soft-caps through the blockwise attention
CASES["gemma2_blockwise_1x2"] = ("gemma2-2b", (1, 2), (1, 2), {},
                                 {"force_blockwise": True})


def cfg_of(arch, over=None):
    cfg = dataclasses.replace(get_config(arch, "smoke"), dtype=torch.float32)
    over = dict(over or {})
    if "moe" in over:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, **over.pop("moe")))
    return dataclasses.replace(cfg, **over)


# --------------------------------------------------------------------------
# the reference, in a subprocess with 4 host devices
# --------------------------------------------------------------------------

_REFERENCE = r"""
import dataclasses, json, os, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_config
from repro.data.pipeline import DataConfig, make_batch
from repro.launch.step import make_train_step
from repro.models import build_model
from repro.optim import OptimizerConfig, init_opt_state
from repro.parallel.sharding import named_shardings

out_dir, cases, lr, steps, bsz, seq, ndec = sys.argv[1], \
    json.loads(sys.argv[2]), float(sys.argv[3]), int(sys.argv[4]), \
    int(sys.argv[5]), int(sys.argv[6]), int(sys.argv[7])
flat = lambda tree: {jax.tree_util.keystr(p): np.asarray(l) for p, l in
                     jax.tree_util.tree_flatten_with_path(tree)[0]}

def nonzero_b(lora, key):
    leaves, tdef = jax.tree_util.tree_flatten_with_path(lora)
    keys = jax.random.split(key, len(leaves))
    return jax.tree_util.tree_unflatten(tdef, [
        0.05 * jax.random.normal(k, l.shape, l.dtype)
        if p[-1].key == "b" else l for (p, l), k in zip(leaves, keys)])

def mesh_of(shape):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"))

def config(arch, over):
    cfg = dataclasses.replace(get_config(arch, "smoke"), dtype=jnp.float32)
    over = dict(over)
    if "moe" in over:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, **over.pop("moe")))
    return dataclasses.replace(cfg, **over)

inits = {}
for name, (arch, _, _, over, _) in cases.items():
    cfg = config(arch, over)
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    params = {"base": params["base"],
              "lora": nonzero_b(params["lora"], jax.random.PRNGKey(1))}
    inits[name] = (cfg, params)
    path = os.path.join(out_dir, f"{name}.params")
    np.savez(path + ".tmp.npz", **flat(params))
    os.rename(path + ".tmp.npz", path + ".npz")     # whole, or not there

for name, (arch, _, ref_shape, _, model_over) in cases.items():
    cfg, params = inits[name]
    mesh = mesh_of(tuple(ref_shape))
    model = build_model(cfg, mesh=mesh, **model_over)
    params = jax.device_put(params, named_shardings(params, mesh))
    batch = {k: jnp.asarray(v) for k, v in make_batch(
        DataConfig(seq_len=seq, global_batch=bsz, vocab=cfg.vocab, seed=0),
        0).items()}
    step = make_train_step(model, OptimizerConfig(lr=lr, total_steps=steps))

    def both(params, opt, batch):
        def loss_fn(lora_p):
            return model.train_loss({"base": params["base"],
                                     "lora": lora_p}, batch)
        (loss, m), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params["lora"])
        new, _, sm = step(params, opt, batch)
        return loss, m, grads, new, sm

    loss, m, grads, new, sm = jax.jit(both)(
        params, init_opt_state(params["lora"]), batch)
    logits, caches = jax.jit(lambda p, b: model.prefill(p, b, seq + ndec))(
        params, {"tokens": batch["tokens"]})
    out = {"prefill": np.asarray(logits)}
    dec = jax.jit(model.decode_step)
    for i in range(ndec):
        logits, caches = dec(params, batch["tokens"][:, i:i + 1], caches,
                             jnp.full((bsz,), seq + i, jnp.int32))
        out[f"decode{i}"] = np.asarray(logits)
    np.savez(os.path.join(out_dir, f"{name}.ref.npz"),
             **{"loss": np.asarray(loss), "ce": np.asarray(m["ce"]),
                "aux": np.asarray(m["aux"]),
                "step_loss": np.asarray(sm["loss"]),
                "grad_norm": np.asarray(sm["grad_norm"])}, **out,
             **{"grad" + k: v for k, v in flat(grads).items()},
             **{"new" + k: v for k, v in flat(new["lora"]).items()})
"""


# --------------------------------------------------------------------------
# the port, one gloo process per rank
# --------------------------------------------------------------------------

_RANK = r"""
import json, os, sys, time
import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(sys.argv[1])))
import test_torch_tensor_parallel as T
from repro_torch.checkpoint.manager import _unflatten
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.launch.mesh import mesh_over
from repro_torch.launch.step import (_lora_grads, _mesh_mean, local_batch,
                                     make_train_step)
from repro_torch.models import build_model
from repro_torch.optim import OptimizerConfig, init_opt_state
from repro_torch.optim.adamw import tree_paths
from repro_torch.parallel.sharding import (AbstractMesh, local_block,
                                           spec_for)

torch.set_num_threads(1)
rank, world, out_dir = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
names = json.loads(sys.argv[5])
dist.init_process_group("gloo", init_method="file://" + sys.argv[6],
                        rank=rank, world_size=world)
deadline = time.time() + float(sys.argv[7])
flat = lambda tree: {p: l.detach().numpy() for p, l in tree_paths(tree)}
meshes = {}
for name in names:
    arch, shape, _, over, model_over = T.CASES[name]
    shape = tuple(shape)
    if shape not in meshes:
        meshes[shape] = mesh_over(shape, device="cpu")
    mesh = meshes[shape]
    cfg = T.cfg_of(arch, over)
    model = build_model(cfg, mesh=mesh, **model_over)
    path = os.path.join(out_dir, f"{name}.params.npz")
    while not os.path.exists(path):
        if time.time() > deadline:
            raise TimeoutError(f"the reference wrote no {path}")
        time.sleep(0.1)
    with np.load(path) as z:
        params = _unflatten(build_model(cfg).init(0, device="cpu"), dict(z))
    local = model.local_params(params)
    # each leaf is the rule table's block, bit for bit
    rules = AbstractMesh(("data", "model"), shape)
    misplaced = [
        p for (p, g), (_, l) in zip(tree_paths(params), tree_paths(local))
        if not torch.equal(l, local_block(g, spec_for(p, tuple(g.shape),
                                                      rules),
                                          mesh, mesh.coords))]
    batch = {k: torch.from_numpy(v) for k, v in make_batch(
        DataConfig(seq_len=T.SEQ, global_batch=T.BATCH, vocab=cfg.vocab,
                   seed=0), 0).items()}
    lb = local_batch(batch, mesh)
    loss, m, grads = _lora_grads(model, local, lb)
    loss, m, grads, _ = _mesh_mean(model, loss, m, grads)
    new, _, sm = make_train_step(model, OptimizerConfig(
        lr=T.LR, total_steps=T.STEPS))(
        local, init_opt_state(local["lora"]), lb)
    logits, caches = model.prefill(local, {"tokens": lb["tokens"]},
                                   T.SEQ + T.DECODE)
    out = {"prefill": logits.numpy()}
    for i in range(T.DECODE):
        logits, caches = model.decode_step(
            local, lb["tokens"][:, i:i + 1], caches,
            torch.full((lb["tokens"].shape[0],), T.SEQ + i))
        out[f"decode{i}"] = logits.numpy()
    np.savez(os.path.join(out_dir, f"{name}.rank{rank}.npz"),
             loss=loss.numpy(), ce=m["ce"].numpy(), aux=m["aux"].numpy(),
             step_loss=sm["loss"].numpy(), grad_norm=sm["grad_norm"].numpy(),
             misplaced=np.array(json.dumps(misplaced)), **out,
             **{"grad" + k: v for k, v in flat(grads).items()},
             **{"new" + k: v for k, v in flat(new["lora"]).items()})
dist.destroy_process_group()
"""


def _wait_all(procs, deadline):
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(deadline - time.time(),
                                                  1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run the reference (one process per rank group) and both rank groups
    (2 and 4 gloo ranks) at once; returns the output directory."""
    out = tmp_path_factory.mktemp("tp")
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               OMP_NUM_THREADS="1")
    procs = []
    for world in (2, 4):
        names = [n for n, c in CASES.items()
                 if int(np.prod(c[1])) == world]
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _REFERENCE, str(out),
             json.dumps({n: CASES[n] for n in names}), str(LR), str(STEPS),
             str(BATCH), str(SEQ), str(DECODE)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
        init = out / f"store{world}"
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _RANK, __file__, str(rank),
                 str(world), str(out), json.dumps(names), str(init),
                 str(TIMEOUT)], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    _wait_all(procs, time.time() + TIMEOUT)
    return out


def load(out, name):
    with np.load(out / name) as z:
        return dict(z)


def lora_specs(arch, shape, over=None):
    """Path (within the LoRA tree) → spec of every LoRA leaf as the port
    places it on a ``shape`` mesh."""
    cfg = cfg_of(arch, over)
    model = build_model(cfg, mesh=AbstractMesh(("data", "model"), shape))
    lora = build_model(cfg).init(0, device="meta")["lora"]
    by_leaf = {}
    tree_map(lambda leaf, spec: by_leaf.setdefault(id(leaf), spec), lora,
             model.param_specs(lora))
    return {p: by_leaf[id(leaf)] for p, leaf in tree_paths(lora)}


def _axes(e):
    return () if e is None else (e if isinstance(e, tuple) else (e,))


def _merge(parts, dim, key):
    """Blocks concatenated along ``dim``, or (None) one value held whole
    by every part, checked equal on each."""
    if dim is not None:
        return np.concatenate(parts, axis=dim)
    for i, part in enumerate(parts[1:], 1):
        np.testing.assert_array_equal(part, parts[0], err_msg=f"{key} {i}")
    return parts[0]


def gathered(out, name, shape, specs):
    """Each value of the ranks' npz files as a global array: a gradient or
    param reassembled from the ranks' blocks by its spec, the logits
    concatenated over the data ranks, a value whole on several ranks
    checked equal on each (ranks are row-major over (data, model))."""
    d, m = shape
    ranks = [load(out, f"{name}.rank{r}.npz") for r in range(d * m)]
    got = {}
    for key in ranks[0]:
        field = next((f for f in ("grad", "new") if key.startswith(f + "[")),
                     None)
        if field is not None:
            spec = specs[key[len(field):]]
        elif key.startswith(("prefill", "decode")):
            spec = ("data",)
        else:
            spec = ()
        split = {a: dim for dim, e in enumerate(spec) for a in _axes(e)}
        rows = [_merge([ranks[i * m + j][key] for j in range(m)],
                       split.get("model"), key) for i in range(d)]
        got[key] = _merge(rows, split.get("data"), key)
    return got


@pytest.mark.parametrize("name", sorted(CASES))
def test_tp_matches_reference(runs, name):
    arch, shape, _, over, _ = CASES[name]
    want = load(runs, f"{name}.ref.npz")
    got = gathered(runs, name, shape, lora_specs(arch, shape, over))
    assert json.loads(str(got["misplaced"])) == []
    for k in ("loss", "ce", "aux", "step_loss", "grad_norm"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=0,
                                   err_msg=k)
    grads = sorted(k for k in want if k.startswith("grad["))
    assert grads == sorted(k for k in got if k.startswith("grad[")) \
        and grads
    for k in grads:
        w = want[k]
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=RTOL * max(np.abs(w).max(), 1e-30),
                                   err_msg=k)
    news = sorted(k for k in want if k.startswith("new["))
    assert news == sorted(k for k in got if k.startswith("new[")) and news
    for k in news:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=0.05 * LR,
                                   err_msg=k)
    for k in ["prefill"] + [f"decode{i}" for i in range(DECODE)]:
        w = want[k]
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=LOGIT_RTOL * np.abs(w).max(),
                                   err_msg=k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_tp_splits_the_model_axis(runs, name):
    """Every case runs a real ``model`` split: some LoRA ``b`` and the head
    (or tied table) are split over it, and the ranks' logits are whole."""
    arch, shape, _, over, _ = CASES[name]
    specs = lora_specs(arch, shape, over)
    assert any("model" in _axes(e) for s in specs.values() for e in s)
    cfg = cfg_of(arch, over)
    model = build_model(cfg, mesh=AbstractMesh(("data", "model"), shape))
    params = build_model(cfg).init(0, device="meta")
    head = "embed_tied" if cfg.tie_embeddings else "head"
    assert model.param_specs(params)["base"][head]["e"] == ("model", None)
    rank0 = load(runs, f"{name}.rank0.npz")
    assert rank0["prefill"].shape == (BATCH // shape[0], SEQ, cfg.vocab)
