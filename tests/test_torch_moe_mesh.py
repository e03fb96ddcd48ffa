"""Port vs reference across ranks: the expert path under a data-axis mesh,
the data-parallel train step and the EF-int8 all-reduce, on the CPU.

The reference runs in a subprocess whose JAX sees 4 forced host devices,
under an Auto-axes ``Mesh(devices[:S].reshape(S, 1), ("data", "model"))``
(``jax.make_mesh`` makes Explicit axes, on which the reference's
``_constrain_act`` raises: ROADMAP C1). It initializes each case's
parameters (every LoRA ``B`` drawn nonzero, so A's gradients do not
vanish) and writes them keyed by path; the port's ranks read them, take
their blocks and rows, and run the same step. The port's ranks are gloo
processes (2 or 4) that meet through a ``file://`` store in the test's
temporary directory.

Each case holds the global loss, CE and aux within 1e-5 relative, every
LoRA gradient (gathered by its spec; replicated leaves identical on every
rank) within 1e-5 of its max |grad|, and one AdamW step's LoRA params
within 5 % of lr (Adam normalizes each update to about lr, so an entry
whose gradient is near eps moves by an amount rounding decides). Under a
mesh the losses differ from the single-device ones, because capacity is
per shard: the port's own single-device loss is the control.
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

from repro_torch.checkpoint.manager import _unflatten
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.models import build_model
from repro_torch.optim.adamw import tree_map, tree_paths
from repro_torch.parallel.sharding import AbstractMesh

SRC = Path(__file__).resolve().parents[1] / "src"
RTOL = 1e-5
LR = 2e-4
STEPS = 10                     # the schedule's length: step 1 is in warmup
TIMEOUT = 240

# name: (arch, S, global batch, seq, moe overrides)
CASES = {
    "mixtral_ep_s2": ("mixtral-8x22b", 2, 4, 16, {}),
    "mixtral_ep_s4": ("mixtral-8x22b", 4, 4, 16, {}),
    "deepseek_ep_s2": ("deepseek-v3-671b", 2, 4, 16, {}),
    # E = 6 does not divide S = 4: the weight-FSDP layout
    "mixtral_fsdp_s4": ("mixtral-8x22b", 4, 4, 16, {"n_experts": 6}),
    "olmo_s2": ("olmo-1b", 2, 4, 16, {}),
    # 2 x 6 tokens over 2 ranks: 6 per rank < 8, one dispatch over all
    "mixtral_fallback_s2": ("mixtral-8x22b", 2, 2, 6, {}),
}
LAYOUT = {"mixtral_ep_s2": "ep", "mixtral_ep_s4": "ep",
          "deepseek_ep_s2": "ep", "mixtral_fsdp_s4": "fsdp",
          "olmo_s2": None, "mixtral_fallback_s2": "ep"}
# the per-rank trees of the compressed all-reduce: name -> (shape, scale)
COMPRESS_LEAVES = {"w": ((7, 5), 1.0), "b": ((33,), 1e-3),
                   "z": ((4, 4), 0.0)}


def cfg_of(arch, moe):
    cfg = dataclasses.replace(get_config(arch, "smoke"), dtype=torch.float32)
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    return cfg


def compress_inputs(rank):
    rng = np.random.default_rng(100 + rank)
    g = {k: (rng.normal(size=s) * sc).astype(np.float32)
         for k, (s, sc) in COMPRESS_LEAVES.items()}
    e = {k: (rng.normal(size=s) * 1e-3).astype(np.float32)
         for k, (s, _) in COMPRESS_LEAVES.items()}
    return g, e


# --------------------------------------------------------------------------
# the reference, in a subprocess with 4 host devices
# --------------------------------------------------------------------------

_REFERENCE = r"""
import dataclasses, json, os, sys, traceback
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs import get_config
from repro.data.pipeline import DataConfig, make_batch
from repro.launch.step import make_train_step
from repro.models import build_model
from repro.optim import OptimizerConfig, init_opt_state
from repro.optim.compress import compressed_psum_mean

out_dir, cases, lr, steps = sys.argv[1], json.loads(sys.argv[2]), \
    float(sys.argv[3]), int(sys.argv[4])
world = max(c[1] for c in cases.values())
flat = lambda tree: {jax.tree_util.keystr(p): np.asarray(l) for p, l in
                     jax.tree_util.tree_flatten_with_path(tree)[0]}

def config(arch, moe):
    cfg = dataclasses.replace(get_config(arch, "smoke"), dtype=jnp.float32)
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
    return cfg

def nonzero_b(lora, key):
    leaves, tdef = jax.tree_util.tree_flatten_with_path(lora)
    keys = jax.random.split(key, len(leaves))
    return jax.tree_util.tree_unflatten(tdef, [
        0.05 * jax.random.normal(k, l.shape, l.dtype)
        if p[-1].key == "b" else l for (p, l), k in zip(leaves, keys)])

def mesh_of(shape):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"))

# 1. every case's parameters, for the port's ranks
inits = {}
for name, (arch, s, b, t, moe) in cases.items():
    cfg = config(arch, moe)
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    params = {"base": params["base"],
              "lora": nonzero_b(params["lora"], jax.random.PRNGKey(1))}
    inits[name] = (cfg, params)
    path = os.path.join(out_dir, f"{name}.params")
    np.savez(path + ".tmp.npz", **flat(params))
    os.rename(path + ".tmp.npz", path + ".npz")     # whole, or not there

# 2. one step of each case under its mesh
for name, (arch, s, b, t, moe) in cases.items():
    cfg, params = inits[name]
    model = build_model(cfg, mesh=mesh_of((s, 1)))
    batch = {k: jnp.asarray(v) for k, v in make_batch(
        DataConfig(seq_len=t, global_batch=b, vocab=cfg.vocab, seed=0),
        0).items()}
    step = make_train_step(model, OptimizerConfig(lr=lr, total_steps=steps))

    def both(params, opt, batch):
        # the loss and its gradients, and one step, in one compile
        def loss_fn(lora_p):
            return model.train_loss({"base": params["base"],
                                     "lora": lora_p}, batch)
        (loss, m), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params["lora"])
        new, _, sm = step(params, opt, batch)
        return loss, m, grads, new, sm

    loss, m, grads, new, sm = jax.jit(both)(
        params, init_opt_state(params["lora"]), batch)
    np.savez(os.path.join(out_dir, f"{name}.ref.npz"),
             **{"loss": np.asarray(loss), "ce": np.asarray(m["ce"]),
                "aux": np.asarray(m["aux"]),
                "step_loss": np.asarray(sm["loss"]),
                "grad_norm": np.asarray(sm["grad_norm"])},
             **{"grad" + k: v for k, v in flat(grads).items()},
             **{"new" + k: v for k, v in flat(new["lora"]).items()})

if world != 4:
    sys.exit(0)

# 3. C11: mixtral with expert LoRA at mesh (2, 2)
arch, s, b, t, moe = cases["mixtral_ep_s4"]
cfg, params = inits["mixtral_ep_s4"]
batch = {k: jnp.asarray(v) for k, v in make_batch(
    DataConfig(seq_len=t, global_batch=b, vocab=cfg.vocab, seed=0), 0).items()}
try:
    jax.jit(build_model(cfg, mesh=mesh_of((2, 2))).train_loss)(params, batch)
    c11 = "no error"
except Exception as e:
    c11 = f"{type(e).__name__}: {e}"

# 4. the EF-int8 mean over 4 devices, each with its own grads and residual
from jax.experimental.shard_map import shard_map
ins = json.loads(sys.argv[5])
g = {k: jnp.asarray(np.stack([np.asarray(r["g"][k], np.float32)
                              for r in ins])) for k in ins[0]["g"]}
e = {k: jnp.asarray(np.stack([np.asarray(r["e"][k], np.float32)
                              for r in ins])) for k in ins[0]["e"]}
mesh4 = Mesh(np.array(jax.devices()[:4]), ("pod",))
def per_device(gg, ee):
    red, err = compressed_psum_mean(jax.tree_util.tree_map(lambda x: x[0], gg),
                                    jax.tree_util.tree_map(lambda x: x[0], ee),
                                    "pod")
    return red, jax.tree_util.tree_map(lambda x: x[None], err)

fn = shard_map(per_device, mesh=mesh4, in_specs=(P("pod"), P("pod")), out_specs=(P(), P("pod")),
    check_rep=False)
red, err = fn(g, e)
np.savez(os.path.join(out_dir, "compress.ref.npz"),
         **{"red" + k: np.asarray(v) for k, v in red.items()},
         **{"err" + k: np.asarray(v) for k, v in err.items()})
with open(os.path.join(out_dir, "reference.json"), "w") as f:
    json.dump({"c11": c11}, f)
"""


# --------------------------------------------------------------------------
# the port, one gloo process per rank
# --------------------------------------------------------------------------

_RANK = r"""
import dataclasses, json, os, sys, time
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

sys.path.insert(0, os.path.dirname(os.path.abspath(sys.argv[1])))
import test_torch_moe_mesh as T
from repro_torch.checkpoint.manager import _unflatten
from repro_torch.launch.mesh import HostMesh
from repro_torch.launch.step import _lora_grads, _mesh_mean, local_batch, \
    make_train_step
from repro_torch.models import build_model
from repro_torch.optim import OptimizerConfig, compressed_psum_mean, \
    init_opt_state
from repro_torch.optim.adamw import tree_paths

torch.set_num_threads(1)
rank, world, out_dir = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
names = json.loads(sys.argv[5])
dist.init_process_group("gloo", init_method="file://" + sys.argv[6],
                        rank=rank, world_size=world)
mesh = HostMesh(init_device_mesh("cpu", (world, 1),
                                 mesh_dim_names=("data", "model")))
deadline = time.time() + float(sys.argv[7])
flat = lambda tree: {p: l.detach().numpy() for p, l in tree_paths(tree)}
res = {}
for name in names:
    arch, s, b, t, moe = T.CASES[name]
    cfg = T.cfg_of(arch, moe)
    model = build_model(cfg, mesh=mesh)
    path = os.path.join(out_dir, f"{name}.params.npz")
    while not os.path.exists(path):
        if time.time() > deadline:
            raise TimeoutError(f"the reference wrote no {path}")
        time.sleep(0.1)
    with np.load(path) as z:
        params = _unflatten(build_model(cfg).init(0, device="cpu"), dict(z))
    params = model.local_params(params)
    batch = local_batch({k: torch.from_numpy(v) for k, v in T.make_batch(
        T.DataConfig(seq_len=t, global_batch=b, vocab=cfg.vocab, seed=0),
        0).items()}, mesh)
    loss, m, grads = _lora_grads(model, params, batch)
    loss, m, grads, _ = _mesh_mean(model, loss, m, grads)
    new, _, sm = make_train_step(model, OptimizerConfig(
        lr=T.LR, total_steps=T.STEPS))(
        params, init_opt_state(params["lora"]), batch)
    np.savez(os.path.join(out_dir, f"{name}.rank{rank}.npz"),
             loss=loss.numpy(), ce=m["ce"].numpy(), aux=m["aux"].numpy(),
             step_loss=sm["loss"].numpy(), grad_norm=sm["grad_norm"].numpy(),
             **{"grad" + k: v for k, v in flat(grads).items()},
             **{"new" + k: v for k, v in flat(new["lora"]).items()})
if world == 4:
    g, e = T.compress_inputs(rank)
    red, err = compressed_psum_mean(
        {k: torch.from_numpy(v) for k, v in g.items()},
        {k: torch.from_numpy(v) for k, v in e.items()})
    np.savez(os.path.join(out_dir, f"compress.rank{rank}.npz"),
             **{"red" + k: v.numpy() for k, v in red.items()},
             **{"err" + k: v.numpy() for k, v in err.items()})
    # C11's mesh: a 'model' axis of 2 is refused (ROADMAP A9b)
    mesh22 = HostMesh(init_device_mesh("cpu", (2, 2),
                                       mesh_dim_names=("data", "model")))
    try:
        build_model(T.cfg_of("mixtral-8x22b", {}), mesh=mesh22)
        msg = "no error"
    except NotImplementedError as ex:
        msg = str(ex)
    with open(os.path.join(out_dir, f"c11.rank{rank}.txt"), "w") as f:
        f.write(msg)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run the reference (one process for the 2-rank cases, one for the
    4-rank cases, C11 and the compressed all-reduce) and both rank groups
    (2 and 4 gloo ranks) at once; returns the output directory."""
    out = tmp_path_factory.mktemp("mesh")
    inputs = [dict(zip("ge", [{k: v.tolist() for k, v in t.items()}
                              for t in compress_inputs(r)]))
              for r in range(4)]
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               OMP_NUM_THREADS="1")
    procs = []
    for world in (2, 4):
        names = [n for n, c in CASES.items() if c[1] == world]
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _REFERENCE, str(out),
             json.dumps({n: CASES[n] for n in names}), str(LR), str(STEPS),
             json.dumps(inputs)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
        init = out / f"store{world}"
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _RANK, __file__, str(rank),
                 str(world), str(out), json.dumps(names), str(init),
                 str(TIMEOUT)], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    deadline = time.time() + TIMEOUT
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
    return out


def load(out, name):
    with np.load(out / name) as z:
        return dict(z)


def gathered(out, name, world, specs):
    """Each value of the ranks' npz files: a replicated one checked equal
    on every rank, a sharded gradient or param concatenated along its
    sharded dim in rank order."""
    ranks = [load(out, f"{name}.rank{r}.npz") for r in range(world)]
    got = {}
    for key in ranks[0]:
        parts = [r[key] for r in ranks]
        field = next((f for f in ("grad", "new") if key.startswith(f + "[")),
                     None)
        spec = specs[key[len(field):]] if field else None
        dims = [d for d, e in enumerate(spec or ()) if e is not None]
        if dims:
            got[key] = np.concatenate(parts, axis=dims[0])
        else:
            for r, part in enumerate(parts[1:], 1):
                np.testing.assert_array_equal(part, parts[0],
                                              err_msg=f"{key} rank {r}")
            got[key] = parts[0]
    return got


def lora_specs(arch, world, moe):
    """Path (within the LoRA tree) → spec of every LoRA leaf, as the port
    places them on a ``(world, 1)`` mesh."""
    cfg = cfg_of(arch, moe)
    model = build_model(cfg, mesh=AbstractMesh(("data", "model"),
                                               (world, 1)))
    lora = build_model(cfg).init(0, device="meta")["lora"]
    by_leaf = {}
    tree_map(lambda leaf, spec: by_leaf.setdefault(id(leaf), spec), lora,
             model.param_specs(lora))
    return {p: by_leaf[id(leaf)] for p, leaf in tree_paths(lora)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_mesh_step_matches_reference(runs, name):
    arch, world, b, t, moe = CASES[name]
    specs = lora_specs(arch, world, moe)
    sharded = {p for p, s in specs.items() if any(e is not None for e in s)}
    assert bool(sharded) == (LAYOUT[name] == "ep"
                             and cfg_of(arch, moe).moe.lora_on_experts), \
        sharded
    want = load(runs, f"{name}.ref.npz")
    got = gathered(runs, name, world, specs)
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


@pytest.mark.parametrize("name", sorted(CASES))
def test_mesh_loss_is_the_meshs(runs, name):
    """The port's single-device loss on the whole batch: it differs from
    the mesh loss exactly where capacity per shard changes the drops (the
    EP and weight-FSDP cases), and equals it where there is no shard path
    (olmo) or the fallback dispatches over all tokens."""
    arch, world, b, t, moe = CASES[name]
    cfg = cfg_of(arch, moe)
    with np.load(runs / f"{name}.params.npz") as z:
        params = _unflatten(build_model(cfg).init(0, device="cpu"), dict(z))
    batch = {k: torch.from_numpy(v) for k, v in make_batch(
        DataConfig(seq_len=t, global_batch=b, vocab=cfg.vocab, seed=0),
        0).items()}
    with torch.no_grad():
        single = float(build_model(cfg).train_loss(params, batch)[0])
    mesh = float(load(runs, f"{name}.ref.npz")["loss"])
    if name in ("olmo_s2", "mixtral_fallback_s2"):
        assert abs(single - mesh) <= RTOL * abs(mesh), (single, mesh)
    else:
        assert abs(single - mesh) > 10 * RTOL * abs(mesh), (single, mesh)


def test_compressed_psum_mean_bit_exact_at_four_ranks(runs):
    want = load(runs, "compress.ref.npz")
    for r in range(4):
        got = load(runs, f"compress.rank{r}.npz")
        for k in COMPRESS_LEAVES:
            np.testing.assert_array_equal(got["red" + k], want["red" + k])
            np.testing.assert_array_equal(got["err" + k],
                                          want["err" + k][r])


def test_model_axis_refused_where_the_reference_fails(runs):
    """C11: at mesh (2, 2) the reference's EP in_specs give the expert
    LoRA's b no 'model' split while w has one, and its expert FFN cannot
    add the two; the port refuses any 'model' axis above 1 (A9b)."""
    ref = json.loads((runs / "reference.json").read_text())["c11"]
    assert ref.startswith("TypeError") and "incompatible shapes" in ref, ref
    for r in range(4):
        msg = (runs / f"c11.rank{r}.txt").read_text()
        assert "A9b" in msg and "'model'" in msg, msg
