"""The collectives of the port's parallel paths, over one mesh axis.

Every collective is built from all_reduce, which every backend takes on
CPU and CUDA tensors alike (gloo takes no other collective on CUDA:
parallel/dist's transport rule), so one path runs everywhere. A gather
places each rank's part in a zero tensor and sums: adding exact zeros, it
is exact.

Under autograd the Megatron conjugate pairs carry the gradients:
    copy_to      identity forward, all_reduce(sum) backward (the input of
                 a column-parallel linear: each rank's partial gradient
                 of a replicated activation sums to the whole);
    reduce_from  all_reduce(sum) forward, identity backward (the output of
                 a row-parallel linear);
    gather_last  concatenation over the ranks along the last dim forward,
                 this rank's slice of the gradient backward.
Outside autograd each is its plain collective (copy_to is free).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist


def all_reduce_(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all_reduce of x over `group`; returns x."""
    dist.all_reduce(x, op=op, group=group)
    return x


def gather_dim(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """Concatenate the ranks' equal-shaped x along `dim`, in rank order."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    dim = dim % x.dim()
    r = dist.get_group_rank(group, dist.get_rank())
    shape = list(x.shape)
    w = shape[dim]
    shape[dim] = n * w
    out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    out.narrow(dim, r * w, w).copy_(x)
    return all_reduce_(out, group)


def gather_rows(x: torch.Tensor, counts: Sequence[int], group) -> torch.Tensor:
    """Concatenate the ranks' x [counts[r], ...] along dim 0 (counts may
    differ: the data-parallel chunks of a batch). Every rank passes the
    same counts and a tensor of its own count."""
    if dist.get_world_size(group) == 1:
        return x
    r = dist.get_group_rank(group, dist.get_rank())
    out = torch.zeros((sum(counts),) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    off = sum(counts[:r])
    out[off : off + counts[r]] = x
    return all_reduce_(out, group)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.w = group, x.shape[-1]
        return gather_dim(x, group, -1)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_group_rank(ctx.group, dist.get_rank())
        return g.narrow(-1, r * ctx.w, ctx.w).contiguous(), None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    if group is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFrom.apply(x, group)
    return all_reduce_(x.contiguous(), group)


def gather_last(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherLast.apply(x, group)
    return gather_dim(x, group, -1)
