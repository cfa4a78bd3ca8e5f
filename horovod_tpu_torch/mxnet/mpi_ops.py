"""MXNet-NDArray collective API: ``horovod.mxnet``'s names over the
port's core.

Counterpart of ``horovod_tpu/mxnet/mpi_ops.py``.  An NDArray's value
crosses to the host (``asnumpy()``), becomes a torch tensor on the
session's device (``cuda:<local_rank>``; the CPU when the session was
started there), goes through the port's collective
(:mod:`horovod_tpu_torch.ops.collectives`) and comes back as an NDArray
in the input's context (``mx.nd.array``).  The in-place forms write the
result back by slice assignment (``t[:] = a``).  The async forms return
the core's :class:`~horovod_tpu_torch.ops.collectives.Handle`, whose
``wait()`` writes back and returns the NDArrays.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

import mxnet as mx  # gated by horovod_tpu_torch/mxnet/__init__.py

from .. import basics
from ..ops import collectives as C

Average = C.Average
Sum = C.Sum
Adasum = C.Adasum
Min = C.Min
Max = C.Max
Product = C.Product

Handle = C.Handle
synchronize = C.synchronize
poll = C.poll


# --- the bridge ----------------------------------------------------------------

def _to_torch(t) -> torch.Tensor:
    """An NDArray's value as a torch tensor on the session's device."""
    return torch.from_numpy(np.ascontiguousarray(t.asnumpy())).to(
        basics.device())


def _to_numpy(r: torch.Tensor) -> np.ndarray:
    return r.detach().to("cpu").numpy()


def _like(t, r: torch.Tensor):
    """A new NDArray in ``t``'s context holding ``r``."""
    a = _to_numpy(r)
    kwargs = {}
    ctx = getattr(t, "context", None)
    if ctx is not None:
        kwargs["ctx"] = ctx
    return mx.nd.array(a, dtype=a.dtype, **kwargs)


def _write_back(t, r: torch.Tensor):
    t[:] = _to_numpy(r)
    return t


# --- allreduce ---------------------------------------------------------------

def _allreduce_start(tensor, op, process_set, prescale_factor,
                     postscale_factor, name) -> Handle:
    return C.allreduce_async(
        _to_torch(tensor), op=op, process_set=process_set,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        name=name)


def allreduce(tensor, *, op: str = Average, process_set=None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              name: str = "allreduce"):
    """Reference: ``hvd.allreduce(tensor)``, a new NDArray."""
    return _allreduce_start(tensor, op, process_set, prescale_factor,
                            postscale_factor, name).then(
        lambda r: _like(tensor, r)).wait()


def allreduce_(tensor, *, op: str = Average, process_set=None,
               prescale_factor: float = 1.0, postscale_factor: float = 1.0,
               name: str = "allreduce"):
    """Reference: ``hvd.allreduce_``, in place."""
    return allreduce_async_(tensor, op=op, process_set=process_set,
                            prescale_factor=prescale_factor,
                            postscale_factor=postscale_factor,
                            name=name).wait()


def allreduce_async_(tensor, *, op: str = Average, process_set=None,
                     prescale_factor: float = 1.0,
                     postscale_factor: float = 1.0,
                     name: str = "allreduce") -> Handle:
    """In place and asynchronous: ``DistributedTrainer``'s route."""
    return _allreduce_start(tensor, op, process_set, prescale_factor,
                            postscale_factor, name).then(
        lambda r: _write_back(tensor, r))


def _grouped_start(tensors, in_place, op, process_set, prescale_factor,
                   postscale_factor, name) -> Handle:
    h = C.grouped_allreduce_async(
        [_to_torch(t) for t in tensors], op=op, process_set=process_set,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        name=name)
    finish = _write_back if in_place else _like
    return h.then(lambda results: [finish(t, r)
                                   for t, r in zip(tensors, results)])


def grouped_allreduce(tensors: Sequence, *, op: str = Average,
                      process_set=None, prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0,
                      name: str = "grouped_allreduce") -> List:
    return _grouped_start(tensors, False, op, process_set, prescale_factor,
                          postscale_factor, name).wait()


def grouped_allreduce_(tensors: Sequence, *, op: str = Average,
                       process_set=None, prescale_factor: float = 1.0,
                       postscale_factor: float = 1.0,
                       name: str = "grouped_allreduce") -> List:
    return _grouped_start(tensors, True, op, process_set, prescale_factor,
                          postscale_factor, name).wait()


def grouped_allreduce_async_(tensors: Sequence, *, op: str = Average,
                             process_set=None, prescale_factor: float = 1.0,
                             postscale_factor: float = 1.0,
                             name: str = "grouped_allreduce") -> Handle:
    return _grouped_start(tensors, True, op, process_set, prescale_factor,
                          postscale_factor, name)


# --- allgather / broadcast / alltoall / reducescatter ------------------------

def allgather(tensor, *, process_set=None, name: str = "allgather"):
    """Reference: ``hvd.allgather``: concatenation along dim 0; the
    members' lengths of dim 0 may differ."""
    return _like(tensor, C.allgather(_to_torch(tensor),
                                     process_set=process_set, name=name))


def broadcast(tensor, root_rank: int = 0, *, process_set=None,
              name: str = "broadcast"):
    return _like(tensor, C.broadcast(_to_torch(tensor), root_rank,
                                     process_set=process_set, name=name))


def broadcast_(tensor, root_rank: int = 0, *, process_set=None,
               name: str = "broadcast"):
    return _write_back(tensor, C.broadcast(_to_torch(tensor), root_rank,
                                           process_set=process_set,
                                           name=name))


def alltoall(tensor, splits=None, *, process_set=None,
             name: str = "alltoall"):
    """Reference: ``hvd.alltoall(tensor, splits=None)``; with ``splits``
    the result is ``(gathered, received_splits)``, the second int64."""
    x = _to_torch(tensor)
    if splits is None:
        return _like(tensor, C.alltoall(x, process_set=process_set,
                                        name=name))
    send = torch.from_numpy(splits.asnumpy().astype(np.int64))
    gathered, received = C.alltoall(x, send, process_set=process_set,
                                    name=name)
    return _like(tensor, gathered), _like(tensor, received)


def reducescatter(tensor, *, op: str = Sum, process_set=None,
                  name: str = "reducescatter"):
    return _like(tensor, C.reducescatter(_to_torch(tensor), op=op,
                                         process_set=process_set, name=name))


def barrier(process_set=None, name: str = "barrier") -> None:
    C.barrier(process_set=process_set, name=name)


def join() -> int:
    return C.join()
