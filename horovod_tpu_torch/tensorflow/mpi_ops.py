"""TensorFlow-tensor collective API: ``horovod.tensorflow``'s names over
the port's core.

Counterpart of ``horovod_tpu/tensorflow/mpi_ops.py``.  The bridge: a tf
tensor's value becomes a torch tensor on the session's device (``cuda:
<local_rank>``, whose wire is NCCL; on a CPU session the step is a
no-op), goes through the port's collective
(:mod:`horovod_tpu_torch.ops.collectives`) and comes back as a tf
tensor.  numpy has no bfloat16, so a bf16 value crosses as ml_dtypes'
bfloat16 array viewed as int16 and reinterpreted in torch.

Eagerly the bridge runs at once.  Inside a ``tf.function`` graph each
collective is a ``tf.py_function`` node chained to the graph's previous
collective by a control dependency, so execution order equals trace
order and every rank dispatches in the same order (TF's executor would
otherwise run data-independent nodes in any order).  TF runs those
nodes on its own threads; the core's collectives accept any thread.

``tf.function(jit_compile=True)`` needs the TF-XLA adapter (the
reference's ``tensorflow/xla_ops.py`` with ``native/src/tf_xla_ops.cc``),
which is not ported: a collective traced there raises
``NotImplementedError`` naming it.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

try:
    import tensorflow as tf
except ImportError as _e:
    raise ImportError(
        "horovod_tpu_torch.tensorflow requires tensorflow; use "
        "horovod_tpu_torch.torch (or horovod_tpu_torch) on a host "
        "without it") from _e

import ml_dtypes
import torch

from .. import basics
from ..ops import collectives as C

# Reduction-op constants, the core's.
Average = C.Average
Sum = C.Sum
Adasum = C.Adasum
Min = C.Min
Max = C.Max
Product = C.Product

_BF16 = np.dtype(ml_dtypes.bfloat16)
XLA_ADAPTER_ERROR = (
    "{name}: a Horovod collective inside tf.function(jit_compile=True) "
    "needs the TF-XLA adapter (tensorflow/xla_ops.py with "
    "native/src/tf_xla_ops.cc), which horovod_tpu_torch.tensorflow does "
    "not have yet; trace the step with tf.function without jit_compile "
    "(Keras: model.compile(..., jit_compile=False))")


# --- the bridge ---------------------------------------------------------------

def host_tensor(a) -> torch.Tensor:
    """A host array (ml_dtypes' bfloat16 too) as a CPU torch tensor of its
    own memory."""
    a = np.array(a)
    if a.dtype == _BF16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def host_array(t: torch.Tensor) -> np.ndarray:
    """A torch tensor as a host array of its own memory (bfloat16 as
    ml_dtypes')."""
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16).copy()
    return t.numpy().copy()


def _to_torch(value) -> torch.Tensor:
    """A tf tensor's value as a torch tensor on the session's device."""
    return host_tensor(value.numpy()).to(basics.device())


def _to_tf(t: torch.Tensor):
    return tf.convert_to_tensor(host_array(t))


def _in_xla_context() -> bool:
    from tensorflow.python.ops import control_flow_util

    return control_flow_util.GraphOrParentsInXlaContext(
        tf.compat.v1.get_default_graph())


# The attribute holding a graph's last collective, on the FuncGraph itself
# so that the tensor kept dies with its graph.
_CHAIN_ATTR = "_hvd_tpu_torch_collective_chain_tail"


def _bridge(fn, inputs: Sequence, out_dtypes: Sequence, name: str) -> List:
    """``fn(*torch_tensors) -> [torch tensors]`` on tf inputs: at once when
    eager, else as a ``tf.py_function`` chained after the graph's previous
    collective."""
    def run(*values):
        return [_to_tf(o) for o in fn(*[_to_torch(v) for v in values])]

    if tf.executing_eagerly():
        return run(*inputs)
    if _in_xla_context():
        raise NotImplementedError(XLA_ADAPTER_ERROR.format(name=name))
    graph = tf.compat.v1.get_default_graph()
    prev = getattr(graph, _CHAIN_ATTR, None)
    with tf.control_dependencies([prev] if prev is not None else []):
        outs = tf.py_function(run, list(inputs), list(out_dtypes),
                              name=name.replace(":", "_"))
    setattr(graph, _CHAIN_ATTR,
            outs[0] if isinstance(outs, (list, tuple)) else outs)
    return outs


def _set_size(process_set) -> int:
    return process_set.size() if process_set is not None else basics.size()


# --- allreduce ---------------------------------------------------------------

def _allreduce_dense(tensor, op, process_set, prescale_factor,
                     postscale_factor, name):
    def run(t):
        return [C.allreduce(t, op=op, process_set=process_set,
                            prescale_factor=prescale_factor,
                            postscale_factor=postscale_factor, name=name)]

    out = _bridge(run, [tensor], [tensor.dtype], name)[0]
    out.set_shape(tensor.shape)
    return out


def allreduce(tensor, *, op: str = Average, process_set=None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              compression=None, name: str = "allreduce"):
    """Reference: ``hvd.allreduce``: Average by default.  A
    ``tf.IndexedSlices`` takes the allgather route (values and indices
    gathered; Average divides the values), and Adasum on it raises."""
    if isinstance(tensor, tf.IndexedSlices):
        if op == Adasum:
            raise NotImplementedError(
                f"{name}: Adasum reduction does not support "
                "tf.IndexedSlices; densify first (sparse_as_dense=True)")
        values = allgather(tensor.values, process_set=process_set,
                           name=f"{name}.values")
        indices = allgather(tensor.indices, process_set=process_set,
                            name=f"{name}.indices")
        # The gather is linear and row-wise, so the two scales commute
        # into one factor on the gathered values.
        scale = float(prescale_factor) * float(postscale_factor)
        if scale != 1.0:
            values = values * tf.cast(scale, values.dtype)
        if op == Average:
            values = values / tf.cast(_set_size(process_set), values.dtype)
        return tf.IndexedSlices(values, indices,
                                dense_shape=tensor.dense_shape)
    tensor = tf.convert_to_tensor(tensor)
    wire, ctx = (compression.compress(tensor) if compression is not None
                 else (tensor, None))
    out = _allreduce_dense(wire, op, process_set, float(prescale_factor),
                           float(postscale_factor), name)
    if compression is not None:
        out = compression.decompress(out, ctx)
    return tf.cast(out, tensor.dtype)


def grouped_allreduce(tensors: Sequence, *, op: str = Average,
                      process_set=None, prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0, compression=None,
                      name: str = "grouped_allreduce") -> List:
    """Reference: ``hvd.grouped_allreduce``: one fused, ordered op for a
    whole set of tensors (in graphs, one node)."""
    tensors = [tf.convert_to_tensor(t) for t in tensors]
    pairs = [compression.compress(t) if compression is not None
             else (t, None) for t in tensors]
    wires = [w for w, _ in pairs]

    def run(*values):
        return C.grouped_allreduce(
            list(values), op=op, process_set=process_set,
            prescale_factor=float(prescale_factor),
            postscale_factor=float(postscale_factor), name=name)

    outs = _bridge(run, wires, [w.dtype for w in wires], name)
    results = []
    for o, w, t, (_, c) in zip(outs, wires, tensors, pairs):
        o.set_shape(w.shape)
        if compression is not None:
            o = compression.decompress(o, c)
        results.append(tf.cast(o, t.dtype))
    return results


# --- allgather ---------------------------------------------------------------

def _dim0_unknown(out, like) -> None:
    out.set_shape(tf.TensorShape([None]).concatenate(like.shape[1:]))


def allgather(tensor, *, process_set=None, name: str = "allgather"):
    """Reference: ``hvd.allgather``: concatenation along dim 0; the
    members' lengths of dim 0 may differ."""
    tensor = tf.convert_to_tensor(tensor)
    out = _bridge(lambda t: [C.allgather(t, process_set=process_set,
                                         name=name)],
                  [tensor], [tensor.dtype], name)[0]
    _dim0_unknown(out, tensor)
    return out


def grouped_allgather(tensors: Sequence, *, process_set=None,
                      name: str = "grouped_allgather") -> List:
    return [allgather(t, process_set=process_set, name=f"{name}[{i}]")
            for i, t in enumerate(tensors)]


# --- broadcast ---------------------------------------------------------------

def broadcast(tensor, root_rank: int = 0, *, process_set=None,
              name: str = "broadcast"):
    """Reference: ``hvd.broadcast``: every member gets the root's."""
    tensor = tf.convert_to_tensor(tensor)
    out = _bridge(lambda t: [C.broadcast(t, root_rank,
                                         process_set=process_set,
                                         name=name)],
                  [tensor], [tensor.dtype], name)[0]
    out.set_shape(tensor.shape)
    return out


# --- alltoall ----------------------------------------------------------------

def alltoall(tensor, splits=None, *, process_set=None,
             name: str = "alltoall"):
    """Reference: ``hvd.alltoall(tensor, splits=None)``; with ``splits``
    the result is ``(gathered, received_splits)``.  ``splits`` crosses
    the bridge too: inside a graph it has no value until the op runs."""
    tensor = tf.convert_to_tensor(tensor)
    if splits is None:
        out = _bridge(lambda t: [C.alltoall(t, process_set=process_set,
                                            name=name)],
                      [tensor], [tensor.dtype], name)[0]
        _dim0_unknown(out, tensor)
        return out

    def run(t, s):
        return list(C.alltoall(t, s.cpu(), process_set=process_set,
                               name=name))

    gathered, received = _bridge(
        run, [tensor, tf.cast(tf.convert_to_tensor(splits), tf.int64)],
        [tensor.dtype, tf.int64], name)
    _dim0_unknown(gathered, tensor)
    return gathered, received


# --- reducescatter -----------------------------------------------------------

def reducescatter(tensor, *, op: str = Sum, process_set=None,
                  name: str = "reducescatter"):
    """Reference: ``hvd.reducescatter``: reduce, then this member keeps
    its dim-0 piece."""
    tensor = tf.convert_to_tensor(tensor)
    out = _bridge(lambda t: [C.reducescatter(t, op=op,
                                             process_set=process_set,
                                             name=name)],
                  [tensor], [tensor.dtype], name)[0]
    _dim0_unknown(out, tensor)
    return out


def grouped_reducescatter(tensors: Sequence, *, op: str = Sum,
                          process_set=None,
                          name: str = "grouped_reducescatter") -> List:
    """Reference: ``hvd.grouped_reducescatter``: one bridge call (one
    graph node) for the group."""
    tensors = [tf.convert_to_tensor(t) for t in tensors]
    outs = _bridge(lambda *ts: C.grouped_reducescatter(
                       list(ts), op=op, process_set=process_set, name=name),
                   tensors, [t.dtype for t in tensors], name)
    for o, t in zip(outs, tensors):
        _dim0_unknown(o, t)
    return list(outs)


# --- barrier / join ----------------------------------------------------------

def barrier(process_set=None, name: str = "barrier") -> None:
    """Reference: ``hvd.barrier``."""
    C.barrier(process_set=process_set, name=name)


def join() -> int:
    """Reference: ``hvd.join()``."""
    return C.join()


# --- the world's facts as graph constants (fixed for a session) ---------------

def size_op(process_set=None, name=None):
    """Reference: ``hvd.size_op()``."""
    return tf.constant(_set_size(process_set), tf.int32, name=name)


def rank_op(name=None):
    """Reference: ``hvd.rank_op()``."""
    return tf.constant(basics.rank(), tf.int32, name=name)


def local_rank_op(name=None):
    return tf.constant(basics.local_rank(), tf.int32, name=name)


def local_size_op(name=None):
    return tf.constant(basics.local_size(), tf.int32, name=name)


def process_set_included_op(process_set=None, name=None):
    """Reference: ``hvd.process_set_included_op()``: 1 on a member."""
    included = process_set is None or process_set.included()
    return tf.constant(int(included), tf.int32, name=name)
