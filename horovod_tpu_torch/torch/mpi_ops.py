"""Torch-tensor collective API: ``horovod.torch``'s names over the core.

Counterpart of ``horovod_tpu/torch/mpi_ops.py``.  The reference bridges
each CPU tensor through numpy into its JAX host core; here a tensor goes
straight to the port's collectives (:mod:`horovod_tpu_torch.ops.
collectives`) on its own device (``cuda:<local_rank>`` after ``init()``),
with no numpy step and no bf16 view.  The functions keep the
reference's signatures and its order of work: ``compression`` compresses
here, the exact collective reduces the wire tensor (prescale, sum,
Average's divide and postscale all in the wire's dtype), and the result
is decompressed and cast back to the input's dtype.

The reference's ``Handle`` resolves through ``synchronize``/``poll``; so
does the core's :class:`~horovod_tpu_torch.ops.collectives.Handle`,
re-exported here.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..ops import collectives as C
from ..ops.collectives import (  # noqa: F401
    Adasum, Average, Handle, Max, Min, Product, Sum, poll,
    sparse_allreduce_async, synchronize,
)


def _finish(tensor, out, compression, ctx):
    """The result step of an allreduce: decompress, cast to the input's
    dtype, write into ``out`` for the in-place forms."""
    def finish(r: torch.Tensor) -> torch.Tensor:
        if compression is not None:
            r = compression.decompress(r, ctx)
        r = r.to(tensor.dtype)
        return C._write(out, r) if out is not None else r
    return finish


# --- allreduce ---------------------------------------------------------------

def allreduce(tensor: "torch.Tensor", *, op: str = Average,
              process_set=None, prescale_factor: float = 1.0,
              postscale_factor: float = 1.0, compression=None,
              name: str = "allreduce") -> "torch.Tensor":
    """Reference: ``hvd.allreduce(tensor)``: out of place, Average by
    default."""
    return synchronize(allreduce_async(
        tensor, op=op, process_set=process_set,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        compression=compression, name=name))


def allreduce_(tensor: "torch.Tensor", **kwargs) -> "torch.Tensor":
    """Reference: ``hvd.allreduce_``: in place."""
    return synchronize(allreduce_async_(tensor, **kwargs))


def allreduce_async(tensor: "torch.Tensor", *, op: str = Average,
                    process_set=None, prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0, compression=None,
                    name: str = "allreduce") -> Handle:
    """Reference: ``hvd.allreduce_async``."""
    return _allreduce_async_impl(tensor, None, op, process_set,
                                 prescale_factor, postscale_factor,
                                 compression, name)


def allreduce_async_(tensor: "torch.Tensor", *, op: str = Average,
                     process_set=None, prescale_factor: float = 1.0,
                     postscale_factor: float = 1.0, compression=None,
                     name: str = "allreduce") -> Handle:
    """Reference: ``hvd.allreduce_async_``: the gradient hooks' call."""
    return _allreduce_async_impl(tensor, tensor, op, process_set,
                                 prescale_factor, postscale_factor,
                                 compression, name)


def _allreduce_async_impl(tensor, out, op, process_set, prescale_factor,
                          postscale_factor, compression, name) -> Handle:
    wire, ctx = (compression.compress(tensor) if compression is not None
                 else (tensor, None))
    h = C.allreduce_async(wire, op=op, process_set=process_set,
                          prescale_factor=prescale_factor,
                          postscale_factor=postscale_factor, name=name)
    return h.then(_finish(tensor, out, compression, ctx))


def grouped_allreduce(tensors: Sequence["torch.Tensor"], *,
                      op: str = Average, process_set=None,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0, compression=None,
                      name: str = "grouped_allreduce"
                      ) -> List["torch.Tensor"]:
    """Reference: ``hvd.grouped_allreduce``: one fused logical op."""
    return synchronize(grouped_allreduce_async(
        tensors, op=op, process_set=process_set,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        compression=compression, name=name))


def grouped_allreduce_(tensors: Sequence["torch.Tensor"], **kwargs):
    return synchronize(grouped_allreduce_async_(tensors, **kwargs))


def grouped_allreduce_async(tensors, **kwargs) -> Handle:
    return _grouped_allreduce_async_impl(tensors, False, **kwargs)


def grouped_allreduce_async_(tensors, **kwargs) -> Handle:
    return _grouped_allreduce_async_impl(tensors, True, **kwargs)


def _grouped_allreduce_async_impl(tensors, in_place, *, op: str = Average,
                                  process_set=None,
                                  prescale_factor: float = 1.0,
                                  postscale_factor: float = 1.0,
                                  compression=None,
                                  name: str = "grouped_allreduce") -> Handle:
    tensors = list(tensors)
    pairs = [compression.compress(t) if compression is not None
             else (t, None) for t in tensors]
    h = C.grouped_allreduce_async(
        [w for w, _ in pairs], op=op, process_set=process_set,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        name=name)

    def finish(results: List[torch.Tensor]) -> List[torch.Tensor]:
        return [_finish(t, t if in_place else None, compression, ctx)(r)
                for r, t, (_, ctx) in zip(results, tensors, pairs)]

    return h.then(finish)


# --- allgather ---------------------------------------------------------------

def allgather(tensor: "torch.Tensor", *, process_set=None,
              name: str = "allgather") -> "torch.Tensor":
    """Reference: ``hvd.allgather``: concatenation along dim 0; the
    members' lengths of dim 0 may differ."""
    return synchronize(allgather_async(tensor, process_set=process_set,
                                       name=name))


def allgather_async(tensor: "torch.Tensor", *, process_set=None,
                    name: str = "allgather") -> Handle:
    return C.allgather_async(tensor, process_set=process_set, name=name)


def grouped_allgather(tensors: Sequence["torch.Tensor"], *, process_set=None,
                      name: str = "grouped_allgather") -> List["torch.Tensor"]:
    return C.grouped_allgather(tensors, process_set=process_set, name=name)


# --- broadcast ---------------------------------------------------------------

def broadcast(tensor: "torch.Tensor", root_rank: int = 0, *,
              process_set=None, name: str = "broadcast") -> "torch.Tensor":
    """Reference: ``hvd.broadcast``: every member gets the root's."""
    return synchronize(broadcast_async(tensor, root_rank,
                                       process_set=process_set, name=name))


def broadcast_(tensor: "torch.Tensor", root_rank: int = 0, **kwargs):
    """Reference: ``hvd.broadcast_``: in place."""
    return synchronize(broadcast_async_(tensor, root_rank, **kwargs))


def broadcast_async(tensor: "torch.Tensor", root_rank: int = 0, *,
                    process_set=None, name: str = "broadcast") -> Handle:
    return C.broadcast_async(tensor, root_rank, process_set=process_set,
                             name=name)


def broadcast_async_(tensor: "torch.Tensor", root_rank: int = 0, *,
                     process_set=None, name: str = "broadcast") -> Handle:
    return C.broadcast_async_(tensor, root_rank, process_set=process_set,
                              name=name)


# --- alltoall ----------------------------------------------------------------

def alltoall(tensor: "torch.Tensor", splits: Optional["torch.Tensor"] = None,
             *, process_set=None, name: str = "alltoall"):
    """Reference: ``hvd.alltoall(tensor, splits=None)``; with ``splits``
    the result is ``(gathered, received_splits)``."""
    return C.alltoall(tensor, splits, process_set=process_set, name=name)


# --- reducescatter -----------------------------------------------------------

def reducescatter(tensor: "torch.Tensor", *, op: str = Sum,
                  process_set=None, name: str = "reducescatter"):
    """Reference: ``hvd.reducescatter``: reduce, then this member keeps
    its dim-0 piece."""
    return C.reducescatter(tensor, op=op, process_set=process_set,
                           name=name)


def grouped_reducescatter(tensors: Sequence["torch.Tensor"], *,
                          op: str = Sum, process_set=None,
                          name: str = "grouped_reducescatter"
                          ) -> List["torch.Tensor"]:
    """Reference: ``hvd.grouped_reducescatter``: one reduce-scatter a
    fusion bucket."""
    return C.grouped_reducescatter(tensors, op=op, process_set=process_set,
                                   name=name)


# --- barrier / join ----------------------------------------------------------

def barrier(process_set=None, name: str = "barrier") -> None:
    """Reference: ``hvd.barrier``."""
    C.barrier(process_set=process_set, name=name)


def join() -> int:
    """Reference: ``hvd.join()``."""
    return C.join()
