"""Partition rules (port of ``repro/parallel/sharding.py``): map every
parameter, batch and cache leaf to a partition spec over a named mesh.

Strategy, as in the reference:

* mesh axes — single pod ``("data", "model")`` = (16, 16); multi-pod
  ``("pod", "data", "model")`` = (2, 16, 16). ``FSDP`` below denotes the
  combined batch axes ``("pod", "data")`` (or just ``("data",)``).
* **base weights** — Megatron-style TP over ``model`` on the feature axis
  (column-parallel in-proj, row-parallel out-proj) + FSDP over the other
  big axis. Embedding/unembedding shard over ``model``.
* **experts** — expert-parallel over the FSDP axes when n_experts divides
  them (deepseek 256/16), else weight-FSDP inside each expert (mixtral 8).
* **LoRA params** — B (out×r) shards its out dim over ``model``; A stays
  replicated. Expert-stacked LoRA follows EP.
* **activations/batch** — sharded over FSDP axes; decode caches shard
  batch (replicated for batch-1 long-context cells) and a feature dim over
  ``model``.

Every rule is divisibility-guarded: the first candidate spec whose sharded
dims divide the mesh axis sizes wins.

A **mesh** here is anything with ``axis_names`` and a ``shape`` mapping
from name to size: an :class:`AbstractMesh` (names and sizes, no
processes: the production layouts) or the host mesh of
``repro_torch.launch.mesh`` (a torch ``DeviceMesh`` behind the same two
attributes). A **spec** is a tuple with one entry per tensor dimension:
``None``, an axis name, or a tuple of two or more names — the entries of
the reference's ``PartitionSpec``. Trees are the port's dicts, lists and
``OptState``; each leaf's path is spelled as ``jax.tree_util.keystr``
spells it (:func:`~repro_torch.optim.adamw.tree_paths`), so the same
regexes apply.

:func:`placements` turns a spec into DTensor placements, and
:func:`local_block` cuts a global tensor to one rank's block, as
``shard_map`` hands it to its body.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.optim.adamw import tree_map, tree_map_with_path

__all__ = ["AbstractMesh", "FSDP", "batch_specs", "cache_specs",
           "data_ranks", "fsdp_axes", "local_block", "placements",
           "shard_tree", "spec_for"]

Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh by axis names and sizes only: the rules need nothing else."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


# --------------------------------------------------------------------------
# rule table
# --------------------------------------------------------------------------

# Each entry: (path regex, [candidate specs]); the specs are written for
# the *trailing* dims and left-padded with None for the leading scan-stack
# axes.


def _entry(e):
    """``PartitionSpec``'s normal form: a one-name tuple is the name."""
    if isinstance(e, tuple) and len(e) == 1:
        return e[0]
    return e


def _pad(spec: Sequence, ndim: int) -> Spec:
    spec = list(spec)
    if len(spec) > ndim:
        # drop leading Nones if the leaf is unstacked
        spec = spec[len(spec) - ndim:]
    return tuple(_entry(e) for e in [None] * (ndim - len(spec)) + spec)


FSDP = "__fsdp__"   # placeholder resolved to ("pod","data") or ("data",)


_RULES: Tuple[Tuple[str, Tuple[Tuple[Any, ...], ...]], ...] = (
    # unembedding (and tied tables): vocab over model — logits stay sharded
    (r"\['(head|embed_tied)'\]\['e'\]$", (("model", None), (None, None))),
    # input-only embedding: d over model
    (r"\['embed'\]\['e'\]$", (("model", None), (None, None))),
    # routers stay replicated (tiny, fp32)
    (r"router", ((None, None),)),
    # expert stacks (E, in, out) — must match the shard_map MoE in_specs:
    # EP × f-TP when E divides the FSDP axes (deepseek 256), else
    # weight-FSDP × f-TP (mixtral 8 experts, ZeRO-3-gathered per layer)
    (r"experts.*\['wg'\]\['w'\]|experts.*\['wu'\]\['w'\]",
     ((FSDP, None, "model"), (None, FSDP, "model"), (None, None, "model"),
      (None, None, None))),
    (r"experts.*\['(wg|wu)'\]\['scale'\]",
     ((FSDP, None, "model"), (None, None, "model"), (None, None, None))),
    (r"experts.*\['wd'\]\['scale'\]",
     ((FSDP, None, None), (None, None, None))),
    (r"experts.*\['wd'\]\['w'\]",
     ((FSDP, "model", None), (None, "model", FSDP), (None, "model", None),
      (None, None, None))),
    # expert LoRA: EP-sharded over E when divisible, else f-dim sharded
    (r"experts.*\['wd'\]\['a'\]$",
     ((FSDP, None, None), (None, None, "model"), (None, None, None))),
    (r"experts.*\['(wg|wu)'\]\['b'\]$",
     ((FSDP, None, None), (None, "model", None), (None, None, None))),
    (r"experts.*\['a'\]$", ((FSDP, None, None), (None, None, None))),
    (r"experts.*\['b'\]$", ((FSDP, None, None), (None, None, None))),
    # attention / dense in-projections (d, out): column parallel
    (r"\['(wq|wk|wv|wg|wu|wq_up|wk_up|wv_up|w_in|w_gate|wr)'\]\['w'\]",
     ((FSDP, "model"), (None, "model"), (FSDP, None), (None, None))),
    # out-projections (in, d): row parallel
    (r"\['(wo|wd|w_out)'\]\['w'\]",
     (("model", FSDP), ("model", None), (None, FSDP), (None, None))),
    # MLA down-projections (d, rank): rank is small — shard d over fsdp
    (r"\['(wq_down|wkv_down|wk_rope)'\]\['w'\]", ((FSDP, None), (None, None))),
    # RWKV channel-mix value proj (f, d) is an out-projection
    (r"\['wv'\]\['w'\]", (("model", FSDP), ("model", None), (None, None))),
    # RG-LRU gate mats (width, width)
    (r"\['(w_ix|w_ax)'\]\['w'\]", ((None, "model"), (None, None))),
    # LoRA factors on big linears: b (out, r) over model; a replicated
    (r"\['b'\]$", (("model", None), (None, None))),
    (r"\['a'\]$", ((None, None),)),
    # everything else (norms, mus, convs, decay, bonus, scalar state)
    (r"", ((None,),)),
)


def fsdp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def data_ranks(mesh) -> int:
    """The ranks along the mesh's FSDP axes (1 without a mesh)."""
    if mesh is None:
        return 1
    return int(np.prod([mesh.shape[a] for a in fsdp_axes(mesh)]))


def _resolve(entry, mesh):
    fa = fsdp_axes(mesh)
    if entry == FSDP:
        return fa if len(fa) > 1 else (fa[0] if fa else None)
    return entry


def _axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, tuple):
        return int(np.prod([mesh.shape[a] for a in entry]))
    return mesh.shape[entry]


def _fits(spec: Spec, shape, mesh) -> bool:
    for dim, entry in zip(shape, spec):
        if entry is None:
            continue
        if dim % _axis_size(mesh, entry) != 0:
            return False
    return True


def spec_for(path: str, shape, mesh) -> Spec:
    """First divisibility-compatible candidate for this param path."""
    ndim = len(shape)
    for pattern, candidates in _RULES:
        if re.search(pattern, path):
            for cand in candidates:
                resolved = tuple(_resolve(c, mesh) for c in cand)
                spec = _pad(resolved, ndim)
                if _fits(spec, shape, mesh):
                    return spec
            return (None,) * ndim
    return (None,) * ndim


def shard_tree(tree, mesh):
    """Spec tree for an arbitrary param tree (path-based)."""
    return tree_map_with_path(
        lambda path, leaf: spec_for(path, tuple(leaf.shape), mesh), tree)


# --------------------------------------------------------------------------
# batch / cache shardings
# --------------------------------------------------------------------------

def _fsdp_entry(mesh):
    fa = fsdp_axes(mesh)
    return fa if len(fa) > 1 else (fa[0] if fa else None)


def batch_specs(batch_tree, mesh):
    """Shard the leading batch dim over the FSDP axes (guarded)."""
    axis = _fsdp_entry(mesh)

    def one(leaf):
        shape = tuple(leaf.shape)
        ndim = len(shape)
        # musicgen tokens are (B, K, T); vlm positions are (3, B, T)
        bdim = 1 if ndim == 3 and shape[0] == 3 else 0
        spec = [None] * ndim
        if axis is not None and shape[bdim] % _axis_size(mesh, axis) == 0:
            spec[bdim] = axis
        return tuple(spec)

    return tree_map(one, batch_tree)


def cache_specs(cache_tree, mesh):
    """Decode caches: leaves are (L, B, ...) stacked.

    * B (axis 1) shards over FSDP when divisible (batch-1 long-context cells
      fall back to replication).
    * A feature dim shards over ``model``: for 5-dim GQA caches
      (L, B, S, KV, dh) prefer the KV-head dim, falling back to dh; for
      MLA/recurrent caches the last (latent/width) dim.
    """
    axis = _fsdp_entry(mesh)
    msize = mesh.shape.get("model", 1) if "model" in mesh.axis_names else 1

    def one(leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        spec = [None] * nd
        if (axis is not None and nd >= 2 and shape[1] > 1
                and shape[1] % _axis_size(mesh, axis) == 0):
            spec[1] = axis
        if msize > 1:
            if nd == 5:                       # (L, B, S, KV, dh)
                if shape[3] % msize == 0 and shape[3] > 1:
                    spec[3] = "model"
                elif shape[4] % msize == 0:
                    spec[4] = "model"
            elif nd >= 3:                     # (L, B, ..., feat)
                if shape[-1] % msize == 0 and shape[-1] >= msize:
                    spec[-1] = "model"
        return tuple(spec)

    return tree_map(one, cache_tree)


# --------------------------------------------------------------------------
# placing tensors
# --------------------------------------------------------------------------

def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec``: per mesh dim (in ``axis_names``
    order) ``Shard(d)`` for the tensor dim ``d`` whose entry names that
    axis, else ``Replicate()``. A dim sharded over several axes takes them
    in mesh order, which is the row-major order ``PartitionSpec`` uses."""
    from torch.distributed.tensor import Replicate, Shard

    by_axis = {a: d for d, e in enumerate(spec) for a in _axes_of(e)}
    return [Shard(by_axis[a]) if a in by_axis else Replicate()
            for a in mesh.axis_names]


def block_index(entry, mesh, coords: Mapping[str, int]) -> Tuple[int, int]:
    """``(index, count)`` of a rank's block along a dim with this entry:
    the rank's coordinates over the entry's axes, row-major."""
    idx, count = 0, 1
    for a in _axes_of(entry):
        idx = idx * mesh.shape[a] + int(coords[a])
        count *= mesh.shape[a]
    return idx, count


def local_block(t: torch.Tensor, spec: Spec, mesh,
                coords: Mapping[str, int]) -> torch.Tensor:
    """The block of the global ``t`` that the rank at ``coords`` (axis name
    → coordinate) holds under ``spec``: each sharded dim cut into equal
    parts, the rank's part kept (a view)."""
    if len(spec) != t.dim():
        raise ValueError(f"spec {spec} has {len(spec)} entries for a "
                         f"{t.dim()}-dim tensor")
    for d, entry in enumerate(spec):
        idx, count = block_index(entry, mesh, coords)
        if count == 1:
            continue
        if t.shape[d] % count:
            raise ValueError(f"dim {d} of size {t.shape[d]} does not divide "
                             f"into {count} blocks ({entry})")
        n = t.shape[d] // count
        t = t.narrow(d, idx * n, n)
    return t
