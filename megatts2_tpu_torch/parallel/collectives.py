"""The collectives of the mesh, written out where GSPMD inserts them in JAX.

Only ``all_reduce`` (sum) and ``broadcast`` are used: the backend table of
``torch.distributed`` gives gloo only those two on CUDA tensors, so the
same code runs over NCCL (one card a rank) and over gloo (ranks sharing a
card, or the CPU).  A gather is an all-reduce of a zero-filled buffer in
which each rank has written its own slice: adding zeros is exact, so the
gathered values are the ranks' values bit for bit.  Below fp32 a tensor is
reduced in fp32 and rounded once.  Every function is the identity on a
group of None (an axis of size 1).

The autograd Functions are Megatron's: :func:`copy_to` (identity forward,
all-reduce backward) in front of a column-parallel layer,
:func:`reduce_from` (all-reduce forward, identity backward) after a
row-parallel one, :func:`gather_from` (gather forward, this rank's slice
backward) for an output that must be whole, and :func:`sum_over`
(all-reduce both ways) for a statistic of the global batch whose
gradient reaches every rank's rows.
"""
from __future__ import annotations

from typing import Iterable, Optional

import torch
import torch.distributed as dist

_LOW = (torch.bfloat16, torch.float16)


def _reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, a new tensor of t's dtype and device."""
    buf = (t.float() if t.dtype in _LOW else t).clone(memory_format=torch.contiguous_format)
    if dist.get_backend(group) == "nccl" and buf.device.type != "cuda":
        buf = buf.cuda()
    dist.all_reduce(buf, group=group)
    return buf.to(t.device, t.dtype)


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group`` (not recorded by autograd)."""
    if group is None:
        return t
    with torch.no_grad():
        return _reduce(t.detach(), group)


def gather(t: torch.Tensor, group, index: int, count: int, dim: int = 0) -> torch.Tensor:
    """The ``count`` equal slices of ``group`` joined along ``dim``, this
    rank's (``index``) being ``t`` (not recorded by autograd)."""
    if group is None:
        return t
    n = t.shape[dim]
    shape = list(t.shape)
    shape[dim] = n * count
    buf = t.new_zeros(shape)
    buf.narrow(dim, index * n, n).copy_(t)
    return all_reduce(buf, group)


def gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """The global batch's rows of ``t``: every data rank's rows, in rank order."""
    return gather(t, mesh.data_group, mesh.data_rank, mesh.n_data, 0)


def broadcast_(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` overwritten in place by the value of the group's first rank."""
    if group is None:
        return t
    src = dist.get_global_rank(group, 0)
    if dist.get_backend(group) == "nccl" and t.device.type != "cuda":
        buf = t.cuda()
        dist.broadcast(buf, src, group=group)
        t.copy_(buf)
    else:
        dist.broadcast(t, src, group=group)
    return t


def barrier(mesh) -> None:
    """Every rank of ``mesh`` waits here for all (an all-reduce of one element)."""
    if mesh is not None and mesh.size > 1:
        all_reduce(torch.zeros(1), dist.group.WORLD)


def reduce_grads(params: Iterable[torch.nn.Parameter], group, average: bool) -> None:
    """Sum (or average) the gradients of ``params`` over ``group`` in place,
    in one all-reduce of their concatenation per dtype."""
    if group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    by_dtype: dict = {}
    for g in grads:
        by_dtype.setdefault((g.dtype, g.device), []).append(g)
    n = dist.get_world_size(group)
    with torch.no_grad():
        for gs in by_dtype.values():
            flat = _reduce(torch.cat([g.reshape(-1) for g in gs]), group)
            if average:
                flat /= n
            for g, new in zip(gs, flat.split([g.numel() for g in gs])):
                g.copy_(new.view_as(g))


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.group), None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, count):
        ctx.index, ctx.n = index, x.shape[-1]
        return gather(x, group, index, count, -1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.index * ctx.n, ctx.n).contiguous(), None, None, None


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``; its gradient is summed over the group too."""
    return x if group is None else _SumOver.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """``x``; its gradient is summed over ``group`` (input of a column-parallel layer)."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (output of a row-parallel layer)."""
    return x if group is None else _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, group, index: int, count: int) -> torch.Tensor:
    """The last axis gathered over ``group``; the gradient keeps this rank's slice."""
    return x if group is None else _GatherFrom.apply(x, group, index, count)


def data_sum(t: torch.Tensor, mesh: Optional[object]) -> torch.Tensor:
    """``t`` summed over the data axis (a metric's numerator or denominator)."""
    return t if mesh is None else all_reduce(t, mesh.data_group)


def data_mean(t: torch.Tensor, mesh: Optional[object]) -> torch.Tensor:
    """The mean of ``t`` over the data axis (a mean over equal shards)."""
    if mesh is None or mesh.data_group is None:
        return t
    return all_reduce(t, mesh.data_group) / mesh.n_data
