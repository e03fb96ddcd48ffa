"""Collectives with gradients, over one process group.

Over the mesh's data axis, as the expert path under a mesh needs them:

* :func:`all_reduce_sum` — the backward is the same all-reduce of the
  incoming gradients (every rank's output depends on every rank's input);
* :func:`all_to_all` — equal chunks of dim 0, chunk ``j`` to group rank
  ``j``; the backward is the inverse exchange, which for equal chunks is
  the same one;
* :func:`all_gather` — the ranks' tensors concatenated along ``dim`` in
  group-rank order; the backward is a reduce-scatter (an all-reduce of the
  gradient, each rank keeping its own slice: gloo has no reduce-scatter).

Over the ``model`` axis, Megatron's region functions (the ranks of a model
group compute one loss, so a replicated activation's gradient is whole on
every rank and a sharded one's is the rank's block of it):

* :func:`copy_to_region` — identity forward, all-reduce backward: a
  replicated tensor entering rank-distinct math;
* :func:`reduce_from_region` — all-reduce forward, identity backward:
  partial sums leaving it;
* :func:`gather_from_region` — all-gather forward, the rank's own slice
  backward: a sharded tensor leaving it (``all_gather`` is this followed by
  :func:`copy_to_region`);
* :func:`scatter_to_region` — the rank's own slice forward, all-gather
  backward;
* :func:`gather_frozen` — an all-gather with no backward, for a frozen base
  weight sliced over the data axes (ZeRO-3 on a frozen base).

Every collective goes through :func:`_issue`, which adds its kind, result
bytes and group size to :data:`RECORD` when a recorder is on
(:func:`recording`); all-reduce is charged twice its result, as a ring
moves it (reduce-scatter then all-gather). Each works on NCCL (tensors on
the card), gloo (CPU tensors) and the ``fake`` backend (any device,
``meta`` too). A collective that fails raises; nothing here catches it.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import torch
import torch.distributed as dist

__all__ = ["RECORD", "all_gather", "all_reduce_max", "all_reduce_sum",
           "all_to_all",
           "copy_to_region", "gather_frozen", "gather_from_region",
           "recording", "reduce_from_region", "scatter_to_region"]

# one all-gather into one tensor (newer torch names it all_gather_single)
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor

# the collectives issued while a recorder is on: dicts of ``kind``
# ("all-reduce", "all-gather", "all-to-all"), ``bytes`` (result bytes,
# all-reduce twice) and ``group`` (its size); None when off
RECORD: Optional[List[dict]] = None


@contextlib.contextmanager
def recording():
    """Record every collective issued inside the block; yields the list."""
    global RECORD
    prev, RECORD = RECORD, []
    try:
        yield RECORD
    finally:
        RECORD = prev


def _issue(kind: str, out: torch.Tensor, group, fn):
    """Run the collective ``fn`` (whose result is ``out``) and record it."""
    fn()
    if RECORD is not None:
        nbytes = out.numel() * out.element_size()
        RECORD.append({"kind": kind,
                       "bytes": nbytes * (2 if kind == "all-reduce" else 1),
                       "group": dist.get_world_size(group)})
    return out


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    return _issue("all-reduce", out, group, lambda: dist.all_reduce(
        out, op=dist.ReduceOp.SUM, group=group))


def _gathered(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in rank order."""
    n = dist.get_world_size(group)
    x = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _issue("all-gather", out, group, lambda: _ALL_GATHER(out, x, group=group))
    return out.movedim(0, dim)


def _own(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = x.shape[dim] // dist.get_world_size(group)
    return x.narrow(dim, dist.get_rank(group) * n, n)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        return _issue("all-to-all", out, group,
                      lambda: dist.all_to_all_single(out, x, group=group))

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.apply(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gathered(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _own(_summed(g, ctx.group), ctx.dim, ctx.group), None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gathered(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _own(g, ctx.dim, ctx.group).contiguous(), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _own(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gathered(g, ctx.dim, ctx.group), None, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over the group, with no gradient."""
    out = x.detach().clone(memory_format=torch.contiguous_format)
    return _issue("all-reduce", out, group, lambda: dist.all_reduce(
        out, op=dist.ReduceOp.MAX, group=group))


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    return _AllToAll.apply(x, group)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _AllGather.apply(x, dim, group)


def copy_to_region(x: torch.Tensor, group) -> torch.Tensor:
    return _Copy.apply(x, group)


def reduce_from_region(x: torch.Tensor, group) -> torch.Tensor:
    return _Reduce.apply(x, group)


def gather_from_region(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _Gather.apply(x, dim, group)


def scatter_to_region(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _Scatter.apply(x, dim, group)


def gather_frozen(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``x``'s blocks concatenated along ``dim`` in group-rank order, with
    no gradient (a frozen weight's FSDP slices)."""
    with torch.no_grad():
        return _gathered(x.detach(), dim, group)
