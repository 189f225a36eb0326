"""The collectives of the port, over one mesh axis.

Every collective is an ``all_reduce`` (gloo takes CUDA tensors for
``all_reduce`` and ``broadcast`` only, so one code path runs over NCCL,
over gloo on the CPU and over gloo on the card).  A gather is the
``all_reduce`` of a zero-filled buffer into which each rank has written
its slice: x + 0 is x exactly, so it is a copy.  An axis whose ``group``
is None (outside a process group) makes every collective a no-op.

The autograd-aware forms sit where gradients cross ranks:
  - :func:`copy_to` and :func:`reduce_from`, Megatron's f and g around a
    tensor-parallel region (identity forward / sum backward, sum forward /
    identity backward);
  - :func:`average_over`, the mean over an axis both ways (BatchNorm's
    statistics over the data axis);
  - :func:`gather_shard`, a weight shard gathered whole forward and the
    whole gradient narrowed to the shard backward (the kernel routes under
    tensor parallelism: every model rank runs the same whole block, so the
    whole gradient is already the same on each).
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def active(axis) -> bool:
    return axis is not None and axis.group is not None


def all_reduce_(t: torch.Tensor, axis) -> torch.Tensor:
    """Sum ``t`` over ``axis`` in place."""
    if active(axis):
        dist.all_reduce(t, group=axis.group)
    return t


def _blocks(shape, dim: int, parts: int):
    """The shape with ``dim`` split into (parts, shape[dim] // parts)."""
    return (*shape[:dim], parts, shape[dim] // parts, *shape[dim + 1:])


def shard_of(t: torch.Tensor, dim: int, parts: int, index: int, size: int) -> torch.Tensor:
    """Shard ``index`` of ``size`` of ``t`` along ``dim``: ``dim`` is
    ``parts`` equal blocks (q | k | v of a qkv weight: 3), each split in
    ``size`` contiguous pieces, and the shard is piece ``index`` of every
    block, in block order."""
    n = t.shape[dim] // parts // size
    inner = t.reshape(_blocks(t.shape, dim, parts)).narrow(dim + 1, index * n, n)
    shape = list(t.shape)
    shape[dim] //= size
    return inner.reshape(shape)


def gather_shards(local: torch.Tensor, axis, dim: int, parts: int) -> torch.Tensor:
    """The whole tensor from every rank's :func:`shard_of` along ``axis``
    (zero-filled buffer, ``all_reduce``); ``local`` itself when the axis
    has one rank."""
    if axis is None or axis.size == 1:
        return local
    shape = list(local.shape)
    shape[dim] *= axis.size
    full = torch.zeros(shape, dtype=local.dtype, device=local.device)
    n = local.shape[dim] // parts
    full.reshape(_blocks(shape, dim, parts)).narrow(dim + 1, axis.index * n, n).copy_(
        local.reshape(_blocks(local.shape, dim, parts)))
    return all_reduce_(full, axis)


def gather_rows(local: torch.Tensor, axis) -> torch.Tensor:
    """Concatenate every rank's ``local`` (the same shape on each) along
    dim 0 in axis order."""
    return gather_shards(local, axis, 0, 1)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce_(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AverageOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_reduce_(x.clone(), axis) / axis.size

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.axis) / ctx.axis.size, None


class _GatherShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, axis, dim, parts):
        ctx.axis, ctx.dim, ctx.parts = axis, dim, parts
        return gather_shards(local.detach(), axis, dim, parts)

    @staticmethod
    def backward(ctx, g):
        a = ctx.axis
        return shard_of(g, ctx.dim, ctx.parts, a.index, a.size).contiguous(), None, None, None


def copy_to(x: torch.Tensor, axis) -> torch.Tensor:
    """Megatron's f: ``x`` forward, its gradient summed over ``axis``."""
    return _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis) -> torch.Tensor:
    """Megatron's g: ``x`` summed over ``axis`` forward, the gradient as is."""
    return _ReduceFrom.apply(x, axis)


def average_over(x: torch.Tensor, axis) -> torch.Tensor:
    """The mean of ``x`` over ``axis``, and of its gradient; ``x`` itself
    outside a process group."""
    return _AverageOver.apply(x, axis) if active(axis) else x


def gather_shard(local: torch.Tensor, axis, dim: int, parts: int = 1) -> torch.Tensor:
    """:func:`gather_shards` with the gradient narrowed back to the shard."""
    if axis is None or axis.size == 1:
        return local
    return _GatherShard.apply(local, axis, dim, parts)
