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

Inside a graph, dense allreduce (alone, grouped, and the tape's and
the optimizers') goes through the TF-XLA adapter (:mod:`.xla_ops`)
where it loaded: one ``HvdTpuTorchAllreduce`` op a call (a grouped call
concatenates each dtype's tensors in the graph first), chained the same
way, which also compiles under ``tf.function(jit_compile=True)``; where
it did not load, a plain graph takes the ``tf.py_function`` route and
``jit_compile=True`` raises with the adapter's load error.  Eager calls
need no op and always take the bridge.  The adapter covers dense
allreduce only, as the reference's: allgather, broadcast, alltoall,
reducescatter and ``tf.IndexedSlices`` traced under ``jit_compile=True``
raise ``NotImplementedError``.
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
    "{name}: inside tf.function(jit_compile=True) the TF-XLA adapter "
    "(tensorflow/xla_ops.py) covers dense allreduce only; densify sparse "
    "gradients (sparse_as_dense=True) or trace this collective with a "
    "plain tf.function (Keras: model.compile(..., jit_compile=False))")
XLA_UNAVAILABLE_ERROR = (
    "{name}: inside tf.function(jit_compile=True) a dense allreduce needs "
    "the TF-XLA adapter (tensorflow/xla_ops.py), {why}; trace this "
    "collective with a plain tf.function (Keras: model.compile(..., "
    "jit_compile=False))")


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

def _native_bridge(fn, tensor, name):
    """The adapter's op running ``fn(np_in) -> np_out`` on ``tensor``'s
    host value inside a graph (plain or ``jit_compile=True``), chained
    after the graph's previous collective as :func:`_bridge` chains."""
    from . import xla_ops

    graph = tf.compat.v1.get_default_graph()
    prev = getattr(graph, _CHAIN_ATTR, None)
    with tf.control_dependencies([prev] if prev is not None else []):
        out = xla_ops.allreduce(tensor, fn, name)
    setattr(graph, _CHAIN_ATTR, out)
    return out


def _use_native(dtype, name: str) -> bool:
    """Whether a dense allreduce of ``dtype`` emits the adapter's op:
    inside a graph, where the adapter loaded and takes the dtype.  An
    eager call needs no op (the op's closure table is trace-time state).
    Under ``jit_compile=True`` the op is the only route, so its absence
    raises, naming why."""
    from . import xla_ops

    if tf.executing_eagerly():
        return False
    if xla_ops.available() and xla_ops.supported_dtype(dtype):
        return True
    if _in_xla_context():
        why = (f"which does not take {tf.as_dtype(dtype).name}"
               if xla_ops.available()
               else f"which did not load: {xla_ops.load_error()}")
        raise NotImplementedError(XLA_UNAVAILABLE_ERROR.format(name=name,
                                                               why=why))
    return False


def _allreduce_host(op, process_set, prescale_factor, postscale_factor,
                    name):
    """``fn(np_in) -> np_out`` for the adapter's op: the value onto the
    session's device, the core's allreduce, back to the host."""
    def run_np(value):
        return host_array(C.allreduce(
            host_tensor(value).to(basics.device()), op=op,
            process_set=process_set, prescale_factor=prescale_factor,
            postscale_factor=postscale_factor, name=name))

    return run_np


def _allreduce_dense(tensor, op, process_set, prescale_factor,
                     postscale_factor, name):
    if _use_native(tensor.dtype, name):
        out = _native_bridge(_allreduce_host(
            op, process_set, prescale_factor, postscale_factor, name),
            tensor, name)
    else:
        def run(t):
            return [C.allreduce(t, op=op, process_set=process_set,
                                prescale_factor=prescale_factor,
                                postscale_factor=postscale_factor,
                                name=name)]

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

    if (all(_use_native(w.dtype, name) for w in wires)
            and all(w.shape.is_fully_defined() for w in wires)):
        outs = _grouped_native(wires, op, process_set,
                               float(prescale_factor),
                               float(postscale_factor), name)
    else:
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


def _grouped_native(wires, op, process_set, prescale, postscale,
                    name) -> List:
    """A grouped allreduce through the adapter: one op a dtype, on the
    dtype's tensors concatenated in the graph (the fusion buffer, which
    XLA compiles), for the elementwise ops; one op a tensor for Adasum,
    whose projections are per tensor and do not commute with the
    concatenation."""
    if op == Adasum:
        return [_allreduce_dense(w, op, process_set, prescale, postscale,
                                 f"{name}[{i}]")
                for i, w in enumerate(wires)]
    buckets: dict = {}
    for i, w in enumerate(wires):
        buckets.setdefault(w.dtype, []).append(i)
    outs: List = [None] * len(wires)
    for dtype, idxs in buckets.items():
        fused = tf.concat([tf.reshape(wires[i], [-1]) for i in idxs], axis=0)
        sizes = [int(wires[i].shape.num_elements()) for i in idxs]
        bucket = f"{name}.{dtype.name}"
        reduced = _native_bridge(
            _allreduce_host(op, process_set, prescale, postscale, bucket),
            fused, bucket)
        for i, part in zip(idxs, tf.split(reduced, sizes)):
            outs[i] = tf.reshape(part, tf.shape(wires[i]))
    return outs


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
