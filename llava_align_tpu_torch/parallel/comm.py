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

A dim that the ranks do not split evenly (a vocabulary against the
'model' axis) is split as GSPMD pads it: ceil(size / n) rows a rank, the
last ranks short (`shard_range`); its gathers take the whole size.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def all_reduce_(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all_reduce of x over `group`; returns x."""
    dist.all_reduce(x, op=op, group=group)
    return x


def group_rank(group) -> int:
    return dist.get_group_rank(group, dist.get_rank())


def shard_range(size: int, n: int, r: int) -> Tuple[int, int]:
    """(start, length) of rank r's part of a dim `size` long split n ways:
    size / n each where n divides it, else ceil(size / n) with the last
    ranks short (one may hold none)."""
    w = -(-size // n)
    start = min(r * w, size)
    return start, min(w, size - start)


def _place(x: torch.Tensor, group, dim: int, size: Optional[int]):
    """(the whole dim's size, this rank's start in it): equal parts of x's
    width, or shard_range's parts of `size`."""
    n, r, w = dist.get_world_size(group), group_rank(group), x.shape[dim]
    if size is None:
        return n * w, r * w
    start, length = shard_range(size, n, r)
    if length != w:
        raise ValueError(f"rank {r} holds {w} of dim {dim}, shard_range({size}, {n}) gives it {length}")
    return size, start


def gather_dim(x: torch.Tensor, group, dim: int = -1, size: Optional[int] = None) -> torch.Tensor:
    """Concatenate the ranks' parts of x along `dim`, in rank order: equal
    parts, or the shard_range parts of a dim `size` long."""
    if dist.get_world_size(group) == 1:
        return x
    dim = dim % x.dim()
    total, start = _place(x, group, dim, size)
    shape = list(x.shape)
    shape[dim] = total
    out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    out.narrow(dim, start, x.shape[dim]).copy_(x)
    return all_reduce_(out, group)


def gather_rows(x: torch.Tensor, counts: Sequence[int], group) -> torch.Tensor:
    """Concatenate the ranks' x [counts[r], ...] along dim 0 (counts may
    differ: the data-parallel chunks of a batch). Every rank passes the
    same counts and a tensor of its own count."""
    if dist.get_world_size(group) == 1:
        return x
    r = group_rank(group)
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
    def forward(ctx, x, group, size):
        ctx.w, ctx.start = x.shape[-1], _place(x, group, x.dim() - 1, size)[1]
        return gather_dim(x, group, -1, size)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.start, ctx.w).contiguous(), None, None


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


def gather_last(x: torch.Tensor, group, size: Optional[int] = None) -> torch.Tensor:
    """gather_dim along the last dim (`size`: its whole length, where the
    ranks' parts follow shard_range)."""
    if group is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherLast.apply(x, group, size)
    return gather_dim(x, group, -1, size)


def vocab_parallel_embed(table: torch.Tensor, ids: torch.Tensor, vocab: int, group) -> torch.Tensor:
    """Rows of an embedding table split on its vocab over `group` (this
    rank holds rows shard_range(vocab) of it): ids are clamped into the
    vocab, as JAX clamps its gathers; each rank looks up the ids it holds,
    zeros elsewhere, and the sum over the group (exact: one nonzero term)
    gives every rank the whole [..., D]. group None: the whole table."""
    ids = ids.long().clamp(0, vocab - 1)
    if group is None:
        return table[ids]
    start, rows = shard_range(vocab, dist.get_world_size(group), group_rank(group))
    local = ids - start
    held = (local >= 0) & (local < rows)
    if rows == 0:
        emb = table.new_zeros(tuple(ids.shape) + (table.shape[-1],))
    else:
        emb = torch.where(held[..., None], table[local.clamp(0, rows - 1)], table.new_zeros(()))
    return reduce_from(emb, group)
