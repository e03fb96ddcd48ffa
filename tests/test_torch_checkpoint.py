"""Port vs reference: fault-tolerant checkpointing
(``checkpoint/manager.py``). The reference's four checkpoint tests
(``tests/test_substrate.py``) are ported; a checkpoint written by either
package restores in the other with params and optimizer state bit for bit
(bf16 through its fp32 storage); ``restore`` with specs keeps each rank's
block; ``save_async`` writes the snapshot taken when it was called."""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.optim import init_opt_state as j_init_opt_state
from repro_torch.bridge import to_torch
from repro_torch.checkpoint import CheckpointManager
from repro_torch.optim import init_opt_state
from repro_torch.optim.adamw import tree_leaves, tree_paths


def same(got, want):
    """Same leaves bit for bit, same dtypes, in JAX's order."""
    want = jax.tree_util.tree_leaves(want)
    got = tree_leaves(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        gn = g.view(torch.uint16).numpy() if g.dtype == torch.bfloat16 \
            else g.numpy()
        wn = w.view(np.uint16) if w.dtype.name == "bfloat16" else w
        assert gn.dtype == wn.dtype
        np.testing.assert_array_equal(gn, wn)


def j_tree(seed=0):
    """A LoRA-like tree: nested dicts, a list, fp32 and bf16 leaves."""
    rng = np.random.default_rng(seed)
    r = lambda *s: jnp.asarray(rng.normal(size=s).astype(np.float32))
    return {"groups": [{"sub_0": {"mixer": {"wq": {"a": r(2, 4, 8),
                                                   "b": r(2, 8, 4)}}}},
                       {"sub_0": {"ffn": {"wg": {"a": r(1, 4, 8)}}}}],
            "head": {"e": r(5, 3).astype(jnp.bfloat16)}}


def j_opt(params, seed=1):
    """An optimizer state past step 0, with nonzero moments."""
    rng = np.random.default_rng(seed)
    st = j_init_opt_state(params)
    fill = lambda t: jnp.asarray(rng.random(t.shape).astype(np.float32))
    return st._replace(step=jnp.asarray(7, jnp.int32),
                       mu=jax.tree_util.tree_map(fill, st.mu),
                       nu=jax.tree_util.tree_map(fill, st.nu))


# ----- the reference's checkpoint tests -----

def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    params = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
              "nested": {"b": torch.ones(4, dtype=torch.bfloat16)}}
    opt = init_opt_state(params)
    mgr.save(3, params, opt)
    restored, opt2, meta = mgr.restore_latest(params, opt)
    assert meta["step"] == 3
    for x, y in zip(tree_leaves(params), tree_leaves(restored)):
        assert torch.equal(x, y)
        assert x.dtype == y.dtype
    for x, y in zip(tree_leaves(opt), tree_leaves(opt2)):
        assert torch.equal(x, y) and x.dtype == y.dtype


def test_checkpoint_keep_k_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    p = {"w": torch.zeros(2)}
    for s in range(5):
        mgr.save(s, p)
    assert mgr.list_steps() == [3, 4]


def test_checkpoint_async_then_sync_no_race(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    p = {"w": torch.arange(4.0)}
    mgr.save_async(7, p)
    mgr.save(7, p)      # must wait for the async write, not collide
    assert mgr.list_steps() == [7]


def test_checkpoint_atomicity_tmp_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert mgr.list_steps() == []
    assert mgr.restore_latest({"w": torch.zeros(1)}) is None


# ----- across the two packages -----

def test_reference_writes_port_restores(tmp_path):
    params = j_tree()
    opt = j_opt(params)
    JManager(str(tmp_path)).save(12, params, opt, extra_meta={"tag": "j"})
    tparams = to_torch(jax.tree_util.tree_map(jnp.zeros_like, params), "cpu")
    p, o, meta = CheckpointManager(str(tmp_path)).restore_latest(
        tparams, init_opt_state(tparams))
    assert meta == {"step": 12, "tag": "j"}
    assert p["head"]["e"].dtype == torch.bfloat16
    same(p, params)
    same(o, opt)
    assert o.step.dtype == torch.int32


def test_port_writes_reference_restores(tmp_path):
    want = j_tree(3)
    wopt = j_opt(want, 4)
    params = to_torch(want, "cpu")
    opt = init_opt_state(params)
    opt = opt._replace(step=torch.tensor(7, dtype=torch.int32),
                       mu=to_torch(wopt.mu, "cpu"),
                       nu=to_torch(wopt.nu, "cpu"))
    CheckpointManager(str(tmp_path)).save(5, params, opt)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, want)
    p, o, meta = JManager(str(tmp_path)).restore_latest(
        zeros, j_init_opt_state(zeros))
    assert meta == {"step": 5}
    for got, ref in ((p, want), (o, wopt)):
        for g, w in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(ref)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    # the file keys are the reference's: keystr paths of each tree
    with np.load(tmp_path / "step_00000005" / "opt_state.npz") as z:
        keys = sorted(z.files)
    assert keys == sorted(jax.tree_util.keystr(k) for k, _ in
                          jax.tree_util.tree_flatten_with_path(wopt)[0])
    assert [p for p, _ in tree_paths(opt)] == [
        jax.tree_util.keystr(k) for k, _ in
        jax.tree_util.tree_flatten_with_path(wopt)[0]]


def test_restore_places_each_ranks_block(tmp_path):
    params = {"a": torch.arange(24, dtype=torch.float32).reshape(4, 6),
              "r": torch.arange(3, dtype=torch.float32)}
    CheckpointManager(str(tmp_path)).save(0, params)
    specs = {"a": ("data", None), "r": (None,)}
    blocks = []
    for rank in range(2):
        mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                     shape={"data": 2, "model": 1},
                                     coords={"data": rank, "model": 0})
        template = {"a": torch.zeros(2, 6), "r": torch.zeros(3)}
        p, _, _ = CheckpointManager(str(tmp_path)).restore(
            0, template, specs=specs, mesh=mesh)
        assert torch.equal(p["r"], params["r"])
        blocks.append(p["a"])
    assert torch.equal(torch.cat(blocks), params["a"])


def test_save_async_writes_the_snapshot(tmp_path):
    """The snapshot is taken when save_async is called: a later in-place
    change of the params does not reach the file."""
    mgr = CheckpointManager(str(tmp_path))
    p = {"w": torch.arange(4.0)}
    mgr.save_async(1, p)
    p["w"].add_(100.0)
    mgr.wait()
    got, _, _ = mgr.restore(1, {"w": torch.zeros(4)})
    assert torch.equal(got["w"], torch.arange(4.0))
