"""Differentiable collectives over a mesh axis's process group.

The reference writes its distributed code inside ``shard_map``, where JAX's
collectives are differentiable and each transposes to another collective.
``torch.distributed``'s calls are not, so each one used under autograd is a
``torch.autograd.Function`` here whose backward is JAX's transpose of the
same collective (plain ``torch.distributed`` calls inside: its ``nn``
wrappers are deprecated).

Cotangents follow ``shard_map``'s replication rule: a value that every rank
of a group holds (replicated) carries the same cotangent on each, and a
value that each rank holds its own part of carries its own. One exception,
``pmean(..., partial=True)``, serves the data axes of a data-parallel step,
where each rank's loss is its own and the step's gradient mean over the data
axes completes the sum (see ``pmean``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _gather(x, group, dim: int):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _slice(x, group, dim: int):
    return x.chunk(dist.get_world_size(group), dim=dim)[dist.get_rank(group)].contiguous()


def _all_reduce_sum(x, group):
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def _all_to_all(x, group):
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def all_to_all(x, group):
    """``lax.all_to_all(x, axis, 0, 0, tiled=False)``: x's leading dim has one
    block per rank of ``group``; block j goes to rank j, and the result's
    block j is the one rank j sent here. Its transpose is itself. Integer
    tensors pass without autograd."""
    if not x.dtype.is_floating_point:
        return _all_to_all(x, group)
    return _AllToAll.apply(x, group)


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, partial):
        ctx.group, ctx.partial = group, partial
        ctx.n = dist.get_world_size(group)
        return _all_reduce_sum(x, group) / ctx.n

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            g = _all_reduce_sum(g, ctx.group)
        return g / ctx.n, None, None


def pmean(x, group, partial: bool = False):
    """``lax.pmean`` over ``group``: the mean of every rank's ``x``, held by
    all. Its cotangent is replicated, so each rank's share of it is 1/n
    (JAX's transpose, no communication). With ``partial`` each rank's
    cotangent is only its own part of the whole, which is their sum: the
    backward adds them before taking the share. That is the data axes' case
    in a data-parallel step, where rank d's loss holds the value once and
    the step averages the ranks' gradients."""
    return _PMean.apply(x, group, partial)


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _slice(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


def shard(x, group, dim: int):
    """This rank's block of a replicated ``x`` along ``dim`` (the blocks in
    rank order, as a ``shard_map`` in-spec splits it). Backward: the blocks'
    cotangents all-gathered, replicated again."""
    return _Shard.apply(x, group, dim)


class _Unshard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.group, ctx.dim), None, None


def unshard(x, group, dim: int):
    """The ranks' blocks all-gathered along ``dim`` into one replicated
    tensor (a ``shard_map`` out-spec that splits ``dim``, seen from outside).
    Backward: this rank's block of the replicated cotangent."""
    return _Unshard.apply(x, group, dim)


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_sum(g, ctx.group), None


def replicated(x, group):
    """A replicated ``x`` used by each rank on its own part of the work (a
    ``shard_map`` in-spec that splits nothing). Forward: ``x``. Backward:
    the ranks' cotangents summed, replicated."""
    return _Replicated.apply(x, group)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum(x, group):
    """``lax.psum`` over ``group`` of each rank's own part: the sum, held by
    all (the all-reduce after a row-parallel product, Megatron's "g"). Its
    cotangent is replicated, and each rank's part takes it whole (JAX's
    transpose, no communication)."""
    return _PSum.apply(x, group)


def pmax(x, group):
    """The elementwise max over ``group``, held by all, outside autograd (the
    shift of a vocab-parallel log-sum-exp, whose value cancels)."""
    x = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def sum_before(x, group):
    """The sum of ``x`` over the ranks of ``group`` before this one (zeros on
    its first rank), outside autograd: one all-gather. An exclusive prefix
    sum over the ranks, such as the counts that come before this rank's
    rows in the global order of a batch split over ``group``."""
    parts = _gather(x.detach()[None], group, 0)
    return parts[:dist.get_rank(group)].sum(0)


def mean_over(tensors, group):
    """Each of ``tensors``' mean over ``group``, outside autograd, in one
    all-reduce: flattened into one float32 buffer, summed, divided by the
    group's size, and each returned in its own dtype and shape (on one rank
    every value comes back bit for bit)."""
    sizes = [t.numel() for t in tensors]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=tensors[0].device)
    for t, part in zip(tensors, flat.split(sizes)):  # no f32 copy of each beside the buffer
        part.copy_(t.detach().reshape(-1))
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat.div_(torch.full((), dist.get_world_size(group), dtype=flat.dtype, device=flat.device))
    return [part.reshape(t.shape).to(t.dtype) for t, part in zip(tensors, flat.split(sizes))]
