"""Tensor parallelism over a mesh's ``model`` axis, with weight-FSDP of the
frozen base over its data axes: the explicit program equivalent to the
reference's ``pjit`` over its rule table (``parallel/sharding.py``).

Each rank holds every leaf as ``local_block`` of the rule table's spec; the
model sets that spec on each tensor it hands the layers as the attribute
``tp_spec`` (:func:`annotate`). :class:`TensorParallel` runs the local
math Megatron's way, with the region collectives of
``parallel.collectives`` carrying gradients:

* a **frozen** base weight sliced over the data axes is all-gathered with
  no backward before use (:meth:`TensorParallel.weight`), then freed;
* a weight split over ``model`` on its **out** dim is column-parallel (the
  output is the rank's block of columns), on its **in** dim row-parallel
  (the input is the rank's block, the partial products are all-reduced);
* a LoRA pair follows its own specs: ``a`` is replicated, ``b`` split over
  ``out`` where the rule says so. In a row-parallel linear the rank-r
  bottleneck ``h`` is what is all-reduced (not the ``(T, d)`` update), and
  a ``model``-split ``b``'s update joins the base's partial sums in the
  rank's columns, so one all-reduce carries both.

An activation is either **replicated** (the same on every model rank; its
gradient whole on each) or **sharded** (the rank's contiguous block of the
last dim). :meth:`TensorParallel.linear` takes and returns that flag, and
:meth:`cols` / :meth:`rep` / :meth:`shard` move between the two.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .collectives import (all_gather, copy_to_region, gather_frozen,
                          gather_from_region, reduce_from_region,
                          scatter_to_region)
from .sharding import data_ranks, fsdp_axes

__all__ = ["TensorParallel", "annotate", "axes_of", "model_dim", "spec_of"]


def axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_of(t: torch.Tensor):
    """The spec the model set on ``t`` (None: replicated, unannotated)."""
    return getattr(t, "tp_spec", None)


def annotate(tree, specs):
    """Set each tensor's ``tp_spec`` from the parallel spec tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            annotate(v, specs[k])
    elif isinstance(tree, (list, tuple)) and not isinstance(specs, tuple):
        for v, s in zip(tree, specs):
            annotate(v, s)
    elif isinstance(tree, torch.Tensor):
        tree.tp_spec = specs
    return tree


def model_dim(spec) -> Optional[int]:
    """The dim that ``spec`` splits over ``model`` (None: none)."""
    if spec is None:
        return None
    for d, e in enumerate(spec):
        if "model" in axes_of(e):
            return d
    return None


class TensorParallel:
    """This rank's view of a mesh: ``m`` model ranks (this one ``j``, its
    group ``group``) and ``s`` data ranks (their group ``dgroup``)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.m = int(mesh.shape.get("model", 1))
        self.s = data_ranks(mesh)
        self.j = int(mesh.coords.get("model", 0)) if self.m > 1 else 0
        self.group = mesh.model_group() if self.m > 1 else None
        self.dgroup = mesh.fsdp_group() if self.s > 1 else None
        self.fsdp = fsdp_axes(mesh)

    # ----- blocks -----

    def block(self, n: int) -> Tuple[int, int]:
        """This rank's ``[lo, hi)`` of a dim of size ``n`` split over
        ``model``."""
        if n % self.m:
            raise ValueError(f"{n} does not split over {self.m} ranks")
        k = n // self.m
        return self.j * k, (self.j + 1) * k

    def rep(self, t, sharded: bool):
        """The whole last dim, replicated (its gradient the rank's slice)."""
        return gather_from_region(t, -1, self.group) if sharded else t

    def shard(self, t, sharded: bool):
        """The rank's block of the last dim."""
        if sharded or self.m == 1:
            return t
        return scatter_to_region(t, -1, self.group)

    def cols(self, t, sharded: bool, lo: int, hi: int, distinct: bool):
        """Columns ``[lo, hi)`` of the whole last dim of ``t``, for math
        that differs per rank (``distinct``) or is the same on every rank."""
        n = t.shape[-1] * (self.m if sharded else 1)
        if sharded:
            if (lo, hi) == self.block(n):
                return t
            whole = (all_gather(t, -1, self.group) if distinct
                     else gather_from_region(t, -1, self.group))
        else:
            whole = copy_to_region(t, self.group) if distinct and self.m > 1 \
                else t
        return whole[..., lo:hi]

    def frozen_cols(self, w, dim: int, sharded: bool, lo: int, hi: int):
        """Entries ``[lo, hi)`` of dim ``dim`` of a frozen weight whose dim is
        split over ``model`` (``sharded``) or whole."""
        n = w.shape[dim] * (self.m if sharded else 1)
        if sharded:
            if (lo, hi) == self.block(n):
                return w
            w = gather_frozen(w, dim, self.group)
        return w.narrow(dim, lo, hi - lo)

    def splits_in(self, leaf) -> bool:
        """Whether a base linear's weight is split over ``model`` on its
        in dim (row-parallel: its input is taken as the rank's block)."""
        spec = spec_of(leaf["w"])
        return spec is not None and model_dim(spec) == len(spec) - 2

    def heads(self, leaf, n_heads: int, width: int):
        """``(distinct, c0, c1, h0, h1)`` for an output projection ``leaf``
        over ``n_heads`` heads of ``width`` columns: its input columns
        ``[c0, c1)`` this rank supplies (all of them, and the same on every
        rank, unless ``distinct``) and the heads ``[h0, h1)`` they need."""
        distinct = self.splits_in(leaf)
        c0, c1 = (self.block(n_heads * width) if distinct
                  else (0, n_heads * width))
        return distinct, c0, c1, c0 // width, -(-c1 // width)

    # ----- weights -----

    def _data_gathered(self, t, spec, grad: bool):
        """``t`` with each dim sliced over the data axes gathered."""
        for d, e in enumerate(spec or ()):
            ax = axes_of(e)
            if not ax or "model" in ax:
                continue
            if ax != self.fsdp:
                raise ValueError(f"spec entry {e} is not the FSDP axes "
                                 f"{self.fsdp}")
            t = (all_gather(t, d, self.dgroup) if grad
                 else gather_frozen(t, d, self.dgroup))
        return t

    def weight(self, leaf, dtype=None):
        """A base linear's weight with its data slices gathered (no
        backward), an int8 ``{"w", "scale"}`` leaf dequantized in
        ``dtype`` as the reference does it; returns ``(w, model_dim)``."""
        w = leaf["w"]
        spec = spec_of(w)
        mdim = model_dim(spec)
        w = self._data_gathered(w, spec, grad=False)
        if w.dtype == torch.int8:
            sc = self._data_gathered(leaf["scale"], spec_of(leaf["scale"]),
                                     grad=False)
            w = w.to(dtype) * sc.to(dtype)
        return w, (None if mdim is None else mdim - len(spec))

    def data_gathered(self, t, grad: bool):
        """``t`` (a LoRA leaf when ``grad``) with its data slices gathered;
        the result carries the spec without them."""
        spec = spec_of(t)
        out = self._data_gathered(t, spec, grad)
        if spec is not None:
            out.tp_spec = tuple(e if "model" in axes_of(e) else None
                                for e in spec)
        return out

    # ----- the linear -----

    def linears(self, x, pairs, scaling: float, x_sharded: bool = False):
        """:meth:`linear` of one input through several ``(base, lora)``
        pairs (q / k / v, gate / up), the input's region crossing shared:
        one all-reduce of its gradient for all the column-parallel ones,
        not one each."""
        shared = {}
        return [self.linear(x, base, lora, scaling, x_sharded, shared)
                for base, lora in pairs]

    def linear(self, x, base, lora, scaling: float,
               x_sharded: bool = False, shared=None):
        """``x @ W (+ LoRA)`` over this rank's blocks; returns ``(y,
        y_sharded)``. A 3-dim ``(E, in, out)`` weight is applied per
        expert to ``x: (E, C, in)``. ``shared`` (a dict) keeps the input's
        region crossings for other linears of the same input."""
        shared = {} if shared is None else shared
        w, wdim = self.weight(base, x.dtype)
        if lora is not None and not (isinstance(lora, dict)
                                     and set(lora) == {"a", "b"}):
            if self.m > 1:
                raise NotImplementedError(
                    f"a {type(lora).__name__} LoRA leaf under a 'model' axis "
                    f"of {self.m}: tensor parallelism runs float LoRA only, "
                    f"as the reference's dry run lowers it")
            # packed or quantized leaves take the single-device branches
            from repro_torch.models.common import linear

            return linear(x, {"w": w}, lora, scaling), False
        w_in, w_out = wdim == -2, wdim == -1
        if x.dtype != w.dtype:
            dt = torch.promote_types(x.dtype, w.dtype)
            x, w = x.to(dt), w.to(dt)
        def once(key, fn):
            if key not in shared:
                shared[key] = fn()
            return shared[key]

        if w_in:
            xj = x if x_sharded else once(
                "scatter", lambda: scatter_to_region(x, -1, self.group))
            part = xj @ w
        else:
            xf = once("gather", lambda: gather_from_region(
                x, -1, self.group)) if x_sharded else x
            y = (once("copy", lambda: copy_to_region(xf, self.group))
                 if w_out else xf) @ w
        if lora is None:
            if w_in:
                return reduce_from_region(part, self.group), False
            return y, w_out
        a, b = lora["a"], lora["b"]
        a_in = model_dim(spec_of(a)) is not None
        b_out = model_dim(spec_of(b)) is not None
        if w_in:
            aj = a if a_in else scatter_to_region(a, -1, self.group)
            h = reduce_from_region(xj.to(a.dtype) @ aj.transpose(-1, -2),
                                   self.group)
        else:
            if a_in:
                raise ValueError("a LoRA 'a' split over 'model' on a "
                                 "linear whose input is whole")
            h = xf.to(a.dtype) @ a.transpose(-1, -2)
        if b_out:
            upd = copy_to_region(h, self.group) @ b.transpose(-1, -2)
        else:
            upd = h @ b.transpose(-1, -2)
        if w_in:
            if b_out:
                lo, hi = self.block(w.shape[-1])
                upd = F.pad((scaling * upd).to(part.dtype),
                            (lo, w.shape[-1] - hi))
                return reduce_from_region(part + upd, self.group), False
            y = reduce_from_region(part, self.group)
            return y + (scaling * upd).to(y.dtype), False
        if w_out:
            if not b_out:
                upd = scatter_to_region(upd, -1, self.group)
            return y + (scaling * upd).to(y.dtype), True
        if b_out:
            upd = gather_from_region(upd, -1, self.group)
        return y + (scaling * upd).to(y.dtype), False
