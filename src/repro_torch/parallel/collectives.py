"""Collectives with gradients, over one process group (the mesh's data
axis), as the expert path under a mesh needs them:

* :func:`all_reduce_sum` — the backward is the same all-reduce of the
  incoming gradients (every rank's output depends on every rank's input);
* :func:`all_to_all` — equal chunks of dim 0, chunk ``j`` to group rank
  ``j``; the backward is the inverse exchange, which for equal chunks is
  the same one;
* :func:`all_gather` — the ranks' tensors concatenated along ``dim`` in
  group-rank order; the backward is a reduce-scatter (an all-reduce of the
  gradient, each rank keeping its own slice: gloo has no reduce-scatter).

Each works on NCCL (tensors on the card) and on gloo (CPU tensors). A
collective that fails raises; nothing here catches it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_gather", "all_reduce_sum", "all_to_all"]


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


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
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.apply(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        ctx.rank, ctx.size = dist.get_rank(group), x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = _summed(g, ctx.group)
        return g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    return _AllToAll.apply(x, group)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _AllGather.apply(x, dim, group)
