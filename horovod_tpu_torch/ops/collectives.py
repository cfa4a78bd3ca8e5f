"""Synchronous collectives over ``torch.distributed``.

Counterpart of ``horovod_tpu/ops/collectives.py`` and ``ops/spmd.py``:
``allreduce`` (Sum/Average with prescale and postscale, on any
compression tier), ``allgather``, ``alltoall`` and ``broadcast``, each
returning a new tensor.  Every rank must call them in the same order,
as in the reference.  Async handles, process sets, hierarchical
reduction and Adasum are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .. import basics

Average = "average"
Sum = "sum"
Min = "min"
Max = "max"
Product = "product"

_REDUCE_OPS = {Sum: dist.ReduceOp.SUM, Min: dist.ReduceOp.MIN,
               Max: dist.ReduceOp.MAX, Product: dist.ReduceOp.PRODUCT}


def reduce_raw(x: torch.Tensor, op: str, group=None) -> torch.Tensor:
    """The uncompressed wire: a new tensor holding the reduction of
    ``x`` over the group (average = sum, then divide by ``n`` in
    ``x``'s dtype, as the reference's ``psum / n``)."""
    if op != Average and op not in _REDUCE_OPS:
        raise ValueError(f"Unknown reduction op: {op!r}")
    out = x.clone()
    dist.all_reduce(out, op=_REDUCE_OPS.get(op, dist.ReduceOp.SUM),
                    group=group)
    if op == Average:
        out = out / dist.get_world_size(group)
    return out


def reducescatter_raw(x: torch.Tensor, op: str, group=None) -> torch.Tensor:
    """The uncompressed reduce-scatter over dim 0 (reference:
    ``spmd.reducescatter``): rank ``i`` gets the ``i``-th of ``n`` equal
    dim-0 pieces of the sum, divided by ``n`` for average."""
    if op not in (Sum, Average):
        raise ValueError(f"reducescatter supports sum/average, got {op!r}")
    n = dist.get_world_size(group)
    if x.shape[0] % n:
        raise ValueError(f"dim 0 ({x.shape[0]}) is not divisible by the "
                         f"world ({n})")
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x.contiguous(), op=dist.ReduceOp.SUM,
                               group=group)
    if op == Average:
        out = out / n
    return out


def allreduce(tensor: torch.Tensor, *, op: str = Average, compression=None,
              prescale_factor: float = 1.0,
              postscale_factor: float = 1.0) -> torch.Tensor:
    """Reference: ``hvd.allreduce``.  ``compression`` picks the wire
    (``Compression.none`` by default); ``prescale_factor`` multiplies
    before the wire and ``postscale_factor`` after it."""
    from .compression import Compression

    basics._require()
    comp = compression or Compression.none
    x = tensor
    if prescale_factor != 1.0:
        x = x * prescale_factor
    x = comp.spmd_allreduce(x, op=op)
    if postscale_factor != 1.0:
        x = x * postscale_factor
    return x


def allgather(tensor: torch.Tensor) -> torch.Tensor:
    """Reference: ``hvd.allgather`` — concatenate every rank's tensor
    along dim 0.  Every rank must pass the same shape."""
    basics._require()
    x = tensor.contiguous()
    n = dist.get_world_size()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x)
    return out


def alltoall(tensor: torch.Tensor,
             splits: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Reference: ``hvd.alltoall`` — send ``splits[j]`` rows of dim 0 to
    rank ``j`` (equal splits by default) and return the rows received,
    concatenated in rank order."""
    basics._require()
    x = tensor.contiguous()
    n = dist.get_world_size()
    if splits is None:
        if x.shape[0] % n:
            raise ValueError(
                f"dim 0 ({x.shape[0]}) is not divisible by the world ({n}); "
                "pass splits")
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        return out
    splits = [int(s) for s in splits]
    if len(splits) != n or sum(splits) != x.shape[0] or min(splits) < 0:
        raise ValueError(f"splits {splits} do not cover dim 0 "
                         f"({x.shape[0]}) over {n} ranks")
    send = torch.tensor(splits, dtype=torch.int64, device=x.device)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send)
    recv_splits = recv.tolist()
    out = x.new_empty((sum(recv_splits),) + tuple(x.shape[1:]))
    dist.all_to_all_single(out, x, output_split_sizes=recv_splits,
                           input_split_sizes=splits)
    return out


def broadcast(tensor: torch.Tensor, root_rank: int = 0) -> torch.Tensor:
    """Reference: ``hvd.broadcast`` — every rank gets ``root_rank``'s
    tensor (a new tensor; the argument is left as it is)."""
    basics._require()
    out = tensor.detach().clone().contiguous()
    dist.broadcast(out, src=root_rank)
    return out
