"""Port vs reference: the partition rules (``parallel/sharding.py``), the
production meshes, ``SHAPE_CELLS`` and ``make_batch_specs``.

For every architecture the port's full-size parameter tree is built on the
meta device and held leaf for leaf against ``jax.eval_shape`` of the
reference's init: the same paths (``jax.tree_util.keystr``'s spelling),
shapes and dtypes, and under ``shard_tree`` the same spec at (16, 16) and
(2, 16, 16). Decode caches (``cache_specs``) and batches (``batch_specs``)
are held the same way for every ``SHAPE_CELLS`` cell. The reference's seven
rule tests and its batch-spec test (``tests/test_substrate.py``) are
ported as cases.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh

from repro.configs import ARCH_IDS, SHAPE_CELLS as J_CELLS
from repro.configs import get_config as j_get_config
from repro.data import pipeline as jdata
from repro.models import build_model as j_build_model
from repro.parallel import sharding as jshard
from repro_torch.configs import SHAPE_CELLS, get_config
from repro_torch.data import pipeline as tdata
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.optim.adamw import tree_map, tree_paths
from repro_torch.parallel import sharding as tshard

MESHES = {"pod": (("data", "model"), (16, 16)),
          "multipod": (("pod", "data", "model"), (2, 16, 16))}
DTYPES = {torch.bfloat16: "bfloat16", torch.float32: "float32",
          torch.int8: "int8", torch.int32: "int32"}


def j_mesh(kind):
    names, shape = MESHES[kind]
    try:
        return JAbstractMesh(tuple(zip(names, shape)))
    except TypeError:                        # older JAX: (shape, names)
        return JAbstractMesh(shape, names)


def t_mesh(kind):
    return make_production_mesh(multi_pod=kind == "multipod")


def j_items(tree, is_leaf=None):
    """``(keystr, leaf)`` pairs of a JAX tree, in its order."""
    return [(jax.tree_util.keystr(p), l) for p, l in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]]


def t_specs(tree, specs):
    """``(path, spec)`` pairs of a port spec tree over ``tree``'s leaves."""
    by_leaf = {}
    tree_map(lambda leaf, spec: by_leaf.setdefault(id(leaf), spec), tree,
             specs)
    return [(p, by_leaf[id(leaf)]) for p, leaf in tree_paths(tree)]


def j_specs(specs):
    is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)
    return [(p, tuple(s)) for p, s in j_items(specs, is_leaf=is_p)]


def pad_spec(spec, ndim):
    """A ``PartitionSpec`` may drop trailing Nones: compare padded."""
    return tuple(spec) + (None,) * (ndim - len(spec))


_TREES = {}


def trees(arch):
    """The full-size parameter trees: JAX's ``eval_shape`` and the port's
    meta-device init."""
    if arch not in _TREES:
        jmodel = j_build_model(j_get_config(arch, "full"))
        want = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
        got = build_model(get_config(arch, "full")).init(0, device="meta")
        _TREES[arch] = (want, got)
    return _TREES[arch]


def test_shape_cells_copied():
    assert SHAPE_CELLS == J_CELLS


def test_production_meshes():
    for kind, (names, shape) in MESHES.items():
        m = t_mesh(kind)
        assert m.axis_names == names and tuple(m.shape.values()) == shape
        assert m.shape == dict(j_mesh(kind).shape)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_tree_paths_shapes_dtypes(arch):
    want, got = trees(arch)
    w, g = j_items(want), tree_paths(got)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (p, gl), (_, wl) in zip(g, w):
        assert gl.device.type == "meta", p
        assert tuple(gl.shape) == tuple(wl.shape), p
        assert DTYPES[gl.dtype] == np.dtype(wl.dtype).name, p


@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, kind):
    want, got = trees(arch)
    ws = j_specs(jshard.shard_tree(want, j_mesh(kind)))
    gs = t_specs(got, tshard.shard_tree(got, t_mesh(kind)))
    assert [p for p, _ in gs] == [p for p, _ in ws]
    shapes = dict(tree_paths(got))
    for (p, g), (_, w) in zip(gs, ws):
        nd = shapes[p].dim()
        assert len(g) == nd, p
        assert g == pad_spec(w, nd), (p, g, w)
    # the production layouts shard the big leaves
    assert any(any(e is not None for e in s) for _, s in gs)


CACHE_CELLS = [c for c, (_, _, kind) in SHAPE_CELLS.items()
               if kind == "decode"]


@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_reference(arch, kind):
    jmodel = j_build_model(j_get_config(arch, "full"))
    tmodel = build_model(get_config(arch, "full"))
    for cell in CACHE_CELLS:
        seq, batch, _ = SHAPE_CELLS[cell]
        want = jax.eval_shape(lambda: jmodel.init_cache(batch, seq))
        got = tmodel.init_cache(batch, seq, device="meta")
        w, g = j_items(want), tree_paths(got)
        assert [p for p, _ in g] == [p for p, _ in w], cell
        for (p, gl), (_, wl) in zip(g, w):
            assert tuple(gl.shape) == tuple(wl.shape), (cell, p)
        ws = j_specs(jshard.cache_specs(want, j_mesh(kind)))
        gs = t_specs(got, tshard.cache_specs(got, t_mesh(kind)))
        for (p, gsp), (_, wsp) in zip(gs, ws):
            assert gsp == pad_spec(wsp, len(gsp)), (cell, p, gsp, wsp)


def data_cfgs(arch, cell, lib):
    seq, batch, _ = SHAPE_CELLS[cell]
    cfg = get_config(arch, "full")
    return lib.DataConfig(seq_len=seq, global_batch=batch, vocab=cfg.vocab,
                          n_codebooks=cfg.n_codebooks,
                          vision_tokens=8 if cfg.vision_stub else 0,
                          d_model=cfg.d_model)


@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_specs_match_reference(arch, kind):
    for cell in SHAPE_CELLS:
        want = jdata.make_batch_specs(data_cfgs(arch, cell, jdata))
        got = tdata.make_batch_specs(data_cfgs(arch, cell, tdata))
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == want[k].shape, (cell, k)
            assert DTYPES[got[k].dtype] == np.dtype(want[k].dtype).name
        ws = jshard.batch_specs(want, j_mesh(kind))
        gs = tshard.batch_specs(got, t_mesh(kind))
        for k in want:
            assert gs[k] == pad_spec(ws[k], got[k].dim()), (cell, k)


def test_mrope_positions_batch_dim():
    """(3, B, T) positions shard their batch dim, dim 1."""
    b = {"positions": torch.empty((3, 32, 128), dtype=torch.int32,
                                  device="meta"),
         "tokens": torch.empty((32, 128), dtype=torch.int32, device="meta")}
    jb = {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.int32)
          for k, v in b.items()}
    for kind in MESHES:
        gs = tshard.batch_specs(b, t_mesh(kind))
        ws = jshard.batch_specs(jb, j_mesh(kind))
        assert gs["positions"][0] is None and gs["positions"][1] is not None
        assert gs["tokens"][0] is not None
        for k in b:
            assert gs[k] == pad_spec(ws[k], b[k].dim())


# --------------------------------------------------------------------------
# the reference's rule tests (tests/test_substrate.py), as cases
# --------------------------------------------------------------------------

MESH = make_production_mesh()
MESH3 = make_production_mesh(multi_pod=True)


def _column_row_parallel():
    s = tshard.spec_for("['groups'][0]['sub_0']['mixer']['wq']['w']",
                        (28, 3072, 3072), MESH)
    assert s == (None, "data", "model")
    s = tshard.spec_for("['groups'][0]['sub_0']['mixer']['wo']['w']",
                        (28, 3072, 3072), MESH)
    assert s == (None, "model", "data")


def _divisibility_guard():
    # out dim 8 not divisible by 16 → drop to unsharded candidates
    s = tshard.spec_for("['groups'][0]['sub_0']['mixer']['wk']['w']",
                        (2, 128, 8), MESH)
    assert "model" not in s, s


def _expert_parallel_vs_intra_expert_tp():
    # 256 experts divide the FSDP axis (16) → EP over FSDP × f-TP
    s = tshard.spec_for("['groups'][1]['sub_0']['ffn']['experts']['wg']['w']",
                        (58, 256, 7168, 2048), MESH)
    assert s[1] == "data" and s[3] == "model"
    # 8 experts don't divide 16 → ZeRO-3 d-shard over FSDP × f-TP
    s = tshard.spec_for("['groups'][0]['sub_0']['ffn']['experts']['wg']['w']",
                        (56, 8, 6144, 16384), MESH)
    assert s[1] is None and s[2] == "data" and s[3] == "model"


def _multipod_fsdp_axis_tuple():
    s = tshard.spec_for("['groups'][0]['sub_0']['mixer']['wq']['w']",
                        (28, 4096, 4096), MESH3)
    assert s == (None, ("pod", "data"), "model")


def _lora_b_sharded_a_replicated():
    sb = tshard.spec_for("['groups'][0]['sub_0']['mixer']['wq']['b']",
                         (28, 4096, 16), MESH)
    sa = tshard.spec_for("['groups'][0]['sub_0']['mixer']['wq']['a']",
                         (28, 16, 4096), MESH)
    assert sb == (None, "model", None)
    assert sa == (None, None, None)


def _cache_specs_shard_kv_heads_or_dh():
    meta = lambda *s: torch.empty(s, dtype=torch.bfloat16, device="meta")
    s = tshard.cache_specs({"k": meta(28, 128, 32768, 8, 128)}, MESH)["k"]
    assert s[1] == "data"
    assert s[4] == "model"  # kv=8 < 16 → dh sharded
    s = tshard.cache_specs({"k": meta(16, 128, 32768, 16, 128)}, MESH)["k"]
    assert s[3] == "model"  # kv=16 divides


def _batch_specs_mrope_positions():
    b = {"positions": torch.empty((3, 32, 128), device="meta"),
         "tokens": torch.empty((32, 128), device="meta")}
    specs = tshard.batch_specs(b, MESH)
    assert specs["positions"][0] is None and specs["positions"][1] is not None
    assert specs["tokens"][0] is not None


def _batch_specs_match_shapes():
    cfg = tdata.DataConfig(seq_len=8, global_batch=4, vocab=32, n_codebooks=2)
    specs = tdata.make_batch_specs(cfg)
    batch = tdata.make_batch(cfg, 0)
    for k in batch:
        assert tuple(specs[k].shape) == batch[k].shape, k


SUBSTRATE = {f.__name__[1:]: f for f in (
    _column_row_parallel, _divisibility_guard,
    _expert_parallel_vs_intra_expert_tp, _multipod_fsdp_axis_tuple,
    _lora_b_sharded_a_replicated, _cache_specs_shard_kv_heads_or_dh,
    _batch_specs_mrope_positions, _batch_specs_match_shapes)}


@pytest.mark.parametrize("case", sorted(SUBSTRATE))
def test_reference_rule_cases(case):
    SUBSTRATE[case]()


# --------------------------------------------------------------------------
# placing tensors
# --------------------------------------------------------------------------

def test_local_block_cuts_as_shard_map():
    """Each rank's block, concatenated in mesh order, rebuilds the global
    tensor, for a one-axis and a two-axis entry."""
    mesh = tshard.AbstractMesh(("pod", "data", "model"), (2, 2, 3))
    t = torch.arange(8 * 6 * 5).reshape(8, 6, 5)
    spec = (("pod", "data"), "model", None)
    blocks = {}
    for p in range(2):
        for d in range(2):
            for m in range(3):
                blocks[p, d, m] = tshard.local_block(
                    t, spec, mesh, {"pod": p, "data": d, "model": m})
                assert tuple(blocks[p, d, m].shape) == (2, 2, 5)
    rows = [torch.cat([blocks[p, d, m] for m in range(3)], dim=1)
            for p in range(2) for d in range(2)]
    assert torch.equal(torch.cat(rows, dim=0), t)
    with pytest.raises(ValueError):
        tshard.local_block(torch.zeros(5, 3), ("data", None), mesh,
                           {"pod": 0, "data": 0, "model": 0})


def test_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = tshard.AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    assert tshard.placements((None, ("pod", "data"), "model"), mesh) == [
        Shard(1), Shard(1), Shard(2)]
    assert tshard.placements(("model", None), mesh) == [
        Replicate(), Replicate(), Shard(0)]
