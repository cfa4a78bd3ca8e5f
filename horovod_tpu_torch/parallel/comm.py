"""Differentiable collectives over one :class:`~..plan.AxisGroup`.

Under GSPMD the reference never writes these: ``lax.ppermute`` and
``lax.all_to_all`` transpose themselves, and the partitioner inserts the
tensor-parallel psums.  Here each is a ``torch.autograd.Function`` whose
backward runs the adjoint collective, so every rank of the group must
run the same forward, in the same order, and autograd then runs the
backward collectives in the same order too.

Transport is byte-exact: rotations and all-to-alls move the tensor's
bytes (any dtype); sums run in float32 and round once to the input's
dtype.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _as_bytes(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().reshape(-1).view(torch.uint8)


def _shift(x: torch.Tensor, axis, step: int) -> torch.Tensor:
    """Send ``x`` to the group member ``step`` places ahead and receive
    the one from ``step`` places behind (cyclically): one
    ``all_to_all_single`` whose splits are all zero but one each way,
    which gloo and NCCL both run."""
    n = axis.size
    if n == 1:
        return x
    flat = _as_bytes(x)
    m = flat.numel()
    dst, src = (axis.index + step) % n, (axis.index - step) % n
    out = torch.empty_like(flat)
    dist.all_to_all_single(out, flat,
                           output_split_sizes=[m if j == src else 0
                                               for j in range(n)],
                           input_split_sizes=[m if j == dst else 0
                                              for j in range(n)],
                           group=axis.group)
    return out.view(x.dtype).reshape(x.shape)


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _shift(x, axis, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.axis, -1), None


def shift(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` moved one place forward along ``axis`` (the one from one
    place behind arrives); the gradient moves one place back."""
    return x if axis.size == 1 else _Shift.apply(x, axis)


class _RingStream(torch.autograd.Function):
    """The blocks a ring passes around: ``x`` and then ``n - 1``
    rotations of it, so that block ``s`` is the one that started ``s``
    places behind.  One node for the whole stream: its backward runs on
    every rank even where the later blocks fed nothing (a causal ring
    skips them), rotating the gradients back ``n - 1`` times and adding
    each block's own."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        blocks = [x.view_as(x)]
        for _ in range(axis.size - 1):
            blocks.append(_shift(blocks[-1], axis, 1))
        return tuple(blocks)

    @staticmethod
    def backward(ctx, *grads):
        acc = grads[-1]
        for g in reversed(grads[:-1]):
            acc = g + _shift(acc, ctx.axis, -1)
        return acc, None


def ring_stream(x: torch.Tensor, axis):
    """``(x, x from 1 behind, ..., x from n - 1 behind)`` along ``axis``
    (differentiable)."""
    if axis.size == 1:
        return (x,)
    return _RingStream.apply(x, axis)


def _exchange(x: torch.Tensor, axis) -> torch.Tensor:
    out = torch.empty_like(_as_bytes(x))
    dist.all_to_all_single(out, _as_bytes(x), group=axis.group)
    return out.view(x.dtype).reshape(x.shape)


class _AllToAll(torch.autograd.Function):
    """Dim 0 (the group's width) exchanged: member ``j`` receives slot
    ``i`` of member ``i`` into its slot ``i``.  The exchange is its own
    adjoint."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _exchange(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.axis), None


def all_to_all(x: torch.Tensor, axis) -> torch.Tensor:
    """Exchange ``x``'s dim 0 (of size ``axis.size``) over ``axis``."""
    if x.shape[0] != axis.size:
        raise ValueError(f"all_to_all needs dim 0 == {axis.size}, got "
                         f"{tuple(x.shape)}")
    if axis.size == 1:
        return x
    return _AllToAll.apply(x, axis)


def _sum(x: torch.Tensor, axis) -> torch.Tensor:
    y = x.to(torch.float32, copy=True)
    dist.all_reduce(y, group=axis.group)
    return y.to(x.dtype)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _sum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x: torch.Tensor, axis) -> torch.Tensor:
    """The input of a column-parallel layer: the identity forward, the
    gradient summed over ``axis`` backward (each member computed its
    columns' share of it)."""
    return x if axis.size == 1 else _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis) -> torch.Tensor:
    """The output of a row-parallel layer (or a loss's contribution):
    summed over ``axis`` forward, the identity backward."""
    return x if axis.size == 1 else _ReduceFrom.apply(x, axis)
