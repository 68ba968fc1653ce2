"""The collectives of the port's mesh axes, on NCCL and gloo through one
code path.

gloo runs ``all_reduce`` and ``broadcast`` on CUDA tensors but neither
``all_gather`` nor ``reduce_scatter``, so every gather here is an
``all_reduce`` of a zero-padded buffer: each rank writes its part into its
own slot of a buffer of zeros, and the sum over the axis is every part in
its place (a sum of one value and zeros is that value, bit for bit).  The
transpose of a gather (a reduce-scatter) is an ``all_reduce`` of the
gradient and a slice.  The cost is the axis's width times the bytes of an
``all_gather``, on either backend.

:class:`Axis` is one mesh axis as this rank sees it: its process group, its
width and this rank's index on it.  An axis of width 1 has no group and
every function here is then the identity.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: the process group of this rank's
    line of the mesh, its width and this rank's place on it."""

    group: Optional[object] = None
    size: int = 1
    index: int = 0


LONE = Axis()


def row_bounds(n: int, parts: int) -> list:
    """Offsets of ``n`` rows cut into ``parts`` consecutive parts, the first
    ``n % parts`` one row longer (``np.array_split``): parts + 1 ints."""
    sizes = [n // parts + (i < n % parts) for i in range(parts)]
    return [0] + np.cumsum(sizes).tolist()


def sum_tensors_(tensors: Sequence[torch.Tensor], axis: Axis) -> None:
    """Sum each of ``tensors`` over ``axis`` in place, in one ``all_reduce``
    a dtype."""
    if axis.size == 1 or not tensors:
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat, group=axis.group)
        off = 0
        for t in group:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def gather_dim(x: torch.Tensor, axis: Axis, dim: int, sizes: Optional[Sequence[int]] = None
               ) -> torch.Tensor:
    """Every rank's part of ``x`` along ``dim``, concatenated in axis order
    (``sizes[i]`` rows from rank i; equal parts unless given): an
    ``all_reduce`` of a zero-padded buffer, no autograd."""
    if axis.size == 1:
        return x
    n = axis.size
    sizes = list(sizes) if sizes is not None else [x.shape[dim]] * n
    xm = x.movedim(dim, 0)
    buf = xm.new_zeros((n, max(sizes)) + tuple(xm.shape[1:]))
    buf[axis.index, :xm.shape[0]] = xm
    dist.all_reduce(buf, group=axis.group)
    return torch.cat([buf[i, :sizes[i]] for i in range(n)]).movedim(0, dim).contiguous()


class _GatherRows(torch.autograd.Function):
    """(lead*b, ...) rows of this rank, trial-major, to (lead*B, ...): within
    each of the ``lead`` blocks every rank's rows in axis order.  The
    backward sums the gradient over the axis and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, axis: Axis, sizes: tuple, lead: int):
        ctx.axis, ctx.sizes, ctx.lead = axis, sizes, lead
        rest = x.shape[1:]
        y = gather_dim(x.reshape(lead, -1, *rest), axis, 1, sizes)
        return y.reshape(-1, *rest)

    @staticmethod
    def backward(ctx, g):
        axis, sizes, lead = ctx.axis, ctx.sizes, ctx.lead
        rest = g.shape[1:]
        g = g.contiguous().view(lead, sum(sizes), *rest).clone()
        dist.all_reduce(g, group=axis.group)
        lo = sum(sizes[:axis.index])
        return g[:, lo:lo + sizes[axis.index]].reshape(-1, *rest), None, None, None


def gather_rows(x: torch.Tensor, axis: Axis, sizes: Sequence[int], lead: int = 1
                ) -> torch.Tensor:
    """Every rank's rows of ``x`` (differentiable; :class:`_GatherRows`)."""
    if axis.size == 1:
        return x
    return _GatherRows.apply(x, axis, tuple(sizes), lead)


def local_rows(y: torch.Tensor, axis: Axis, sizes: Sequence[int], lead: int = 1
               ) -> torch.Tensor:
    """This rank's rows of a gathered (lead*B, ...) tensor."""
    if axis.size == 1:
        return y
    lo = sum(sizes[:axis.index])
    rest = y.shape[1:]
    return y.reshape(lead, -1, *rest)[:, lo:lo + sizes[axis.index]].reshape(-1, *rest)


class _SumOver(torch.autograd.Function):
    """A sum over the axis whose every rank's loss reads the sum: the
    backward sums the gradients too (the head's BN statistics)."""

    @staticmethod
    def forward(ctx, x, axis: Axis):
        ctx.axis = axis
        y = x.clone()
        dist.all_reduce(y, group=axis.group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.axis.group)
        return g, None


def sum_over(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``x`` summed over ``axis``, differentiable (:class:`_SumOver`)."""
    return x if axis.size == 1 else _SumOver.apply(x, axis)


class _CopyTo(torch.autograd.Function):
    """Megatron's f: the identity forward into a model-parallel region whose
    ranks each read a share of the input; the backward sums the shares."""

    @staticmethod
    def forward(ctx, x, axis: Axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.axis.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    """Megatron's g: the partial sums of a row-parallel product summed over
    the axis; every rank then holds the whole, so the backward is the
    identity."""

    @staticmethod
    def forward(ctx, x, axis: Axis):
        y = x.clone()
        dist.all_reduce(y, group=axis.group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return x if axis.size == 1 else _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return x if axis.size == 1 else _ReduceFrom.apply(x, axis)


def traced_gather_rows(x: torch.Tensor, n: int, shard: torch.Tensor, group) -> torch.Tensor:
    """:func:`gather_rows` of ``n`` equal parts as an exportable graph: the
    zero-padded buffer written at the index the int64 tensor ``shard``
    holds and summed by ``_c10d_functional.all_reduce``, so that one
    program serves every rank of the axis."""
    import torch.distributed._functional_collectives as fc

    buf = x.new_zeros((n,) + tuple(x.shape))
    buf = buf.index_copy(0, shard.view(1), x.unsqueeze(0))
    buf = fc.wait_tensor(fc.all_reduce(buf, "sum", group))
    return buf.reshape(-1, *x.shape[1:])


def traced_local_rows(y: torch.Tensor, n: int, shard: torch.Tensor) -> torch.Tensor:
    """This rank's part of a (n*b, ...) tensor, at the index ``shard`` holds."""
    return y.reshape(n, -1, *y.shape[1:]).index_select(0, shard.view(1))[0]
