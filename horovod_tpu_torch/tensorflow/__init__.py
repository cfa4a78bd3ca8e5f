"""``import horovod_tpu_torch.tensorflow as hvd``: the TF binding.

Counterpart of ``horovod_tpu/tensorflow/__init__.py`` (reference:
``horovod/tensorflow/__init__.py``), over the port's core: collectives on
tf tensors (:mod:`.mpi_ops`, through torch tensors on the session's
device), ``DistributedOptimizer`` over a Keras optimizer,
``DistributedGradientTape``, ``broadcast_variables``, ``Compression``
and ``backward_passes_per_step`` aggregation::

    import horovod_tpu_torch.tensorflow as hvd

    hvd.init()                    # cuda:<local_rank>; init(device="cpu")
    opt = hvd.DistributedOptimizer(tf.keras.optimizers.Adam(1e-3))
    model.compile(optimizer=opt, loss=...)     # jit_compile=True too
    hvd.broadcast_variables(model.variables, root_rank=0)

Import this package before the process's first ``jit_compile=True``
trace: the import loads the TF-XLA adapter (:mod:`.xla_ops`), which
puts the dense allreduce inside XLA-compiled steps.  Only this
subpackage and ``horovod_tpu_torch.keras`` import tensorflow, keras or
ml_dtypes; ``import horovod_tpu_torch`` does not import them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

try:
    import tensorflow as tf
except ImportError as _e:
    raise ImportError(
        "horovod_tpu_torch.tensorflow requires tensorflow; use "
        "horovod_tpu_torch.torch (or horovod_tpu_torch) on a host "
        "without it") from _e

from ..basics import (  # noqa: F401
    init, shutdown, is_initialized,
    local_rank, local_size, cross_rank, cross_size,
    is_homogeneous,
    mpi_built, nccl_built, gloo_built, ccl_built, cuda_built, rocm_built,
    xla_built, mpi_threads_supported,
    start_timeline, stop_timeline,
)
from .. import basics as _basics
from ..process_sets import (  # noqa: F401
    ProcessSet, add_process_set, remove_process_set, global_process_set,
)
from . import elastic  # noqa: F401  (TensorFlowKerasState)
from .compression import Compression  # noqa: F401
from .functions import (  # noqa: F401
    allgather_object, broadcast_model, broadcast_object, broadcast_variables,
)
from .mpi_ops import (  # noqa: F401
    Adasum, Average, Max, Min, Product, Sum,
    allgather, allreduce, alltoall, barrier, broadcast, grouped_allgather,
    grouped_allreduce, grouped_reducescatter, join, reducescatter,
    size_op, rank_op, local_rank_op, local_size_op, process_set_included_op,
)
from . import xla_ops as _xla_ops

# TF freezes its XLA kernel registry at the first jit_compile trace; the
# adapter's op must be registered before then (see xla_ops.preload).
_xla_ops.preload()


def rank() -> int:
    """This process's rank (reference: ``hvd.rank()``)."""
    return _basics.rank()


def size() -> int:
    """The number of ranks (reference: ``hvd.size()``)."""
    return _basics.size()


def _to_dense(grad):
    if isinstance(grad, tf.IndexedSlices):
        return tf.convert_to_tensor(grad)
    return grad


def _allreduce_grads(grads: Sequence, *, op: str, compression,
                     process_set, sparse_as_dense: bool,
                     name: str, num_groups: int = 0) -> List:
    """Reduce a gradient set as one ordered op: the dense gradients in
    one grouped allreduce (``num_groups`` > 0: that many, ``dense[g::n]``),
    a ``tf.IndexedSlices`` on the allgather route, ``None`` passed
    through."""
    if num_groups < 0:
        raise ValueError("num_groups must be >= 0")
    if sparse_as_dense:
        grads = [_to_dense(g) for g in grads]
    dense_idx = [i for i, g in enumerate(grads)
                 if g is not None and not isinstance(g, tf.IndexedSlices)]
    out = list(grads)
    if dense_idx:
        n = min(num_groups, len(dense_idx)) if num_groups > 0 else 1
        for g in range(n):
            chunk = dense_idx[g::n]
            reduced = grouped_allreduce(
                [grads[i] for i in chunk], op=op, compression=compression,
                process_set=process_set,
                name=name if n == 1 else f"{name}.g{g}")
            for i, r in zip(chunk, reduced):
                out[i] = r
    for i, g in enumerate(grads):
        if isinstance(g, tf.IndexedSlices):
            out[i] = allreduce(g, op=op, process_set=process_set,
                               name=f"{name}.sparse[{i}]")
    return out


class LocalGradientAggregationHelper:
    """``backward_passes_per_step`` local accumulation (reference:
    ``horovod/tensorflow/gradient_aggregation*.py``): gradients are added
    into local variables for N passes; on every Nth the mean is
    allreduced and applied, and the other passes skip the optimizer (so
    its slots and step count advance once an effective step).  A
    ``None`` gradient gets no accumulator and stays ``None``."""

    def __init__(self, backward_passes_per_step: int, allreduce_fn):
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        self.n = int(backward_passes_per_step)
        self._allreduce = allreduce_fn
        self._counter: Optional[tf.Variable] = None
        self._accum: Optional[List[tf.Variable]] = None

    def _build(self, grads):
        self._counter = tf.Variable(0, dtype=tf.int64, trainable=False,
                                    name="hvd_tpu_agg_counter")
        self._accum = [
            None if g is None else
            tf.Variable(tf.zeros_like(g), trainable=False,
                        name=f"hvd_tpu_agg_{i}")
            for i, g in enumerate(grads)
        ]

    def apply(self, grads: Sequence, apply_fn) -> None:
        """Accumulate ``grads``; on pass N allreduce the mean, call
        ``apply_fn(reduced_grads)`` and reset the accumulators."""
        grads = [_to_dense(g) for g in grads]
        if self._counter is None:
            self._build(grads)
        for acc, g in zip(self._accum, grads):
            if acc is not None and g is not None:
                acc.assign_add(tf.cast(g, acc.dtype))
        self._counter.assign_add(1)

        def boundary():
            mean = [None if a is None else tf.cast(a / self.n, a.dtype)
                    for a in self._accum]
            apply_fn(self._allreduce(mean))
            for a in self._accum:
                if a is not None:
                    a.assign(tf.zeros_like(a))
            return tf.constant(True)

        tf.cond(tf.equal(self._counter % self.n, 0),
                boundary, lambda: tf.constant(False))


class _DistributedOptimizerMixin:
    """Mixed in ahead of the wrapped Keras optimizer's class: ``apply``
    (which ``apply_gradients`` goes through in Keras 3) allreduces the
    gradients first."""

    _hvd_tpu_distributed = True

    def _hvd_setup(self, *, op, compression, process_set, sparse_as_dense,
                   backward_passes_per_step, reduce_name, num_groups=0):
        self._hvd_op = op
        self._hvd_compression = compression
        self._hvd_process_set = process_set
        self._hvd_sparse_as_dense = sparse_as_dense
        self._hvd_reduce_name = reduce_name
        self._hvd_num_groups = num_groups
        self._hvd_agg = (
            LocalGradientAggregationHelper(
                backward_passes_per_step, self._hvd_allreduce)
            if backward_passes_per_step > 1 else None)

    def _hvd_allreduce(self, grads):
        return _allreduce_grads(
            grads, op=self._hvd_op, compression=self._hvd_compression,
            process_set=self._hvd_process_set,
            sparse_as_dense=self._hvd_sparse_as_dense,
            name=self._hvd_reduce_name,
            num_groups=self._hvd_num_groups)

    def apply(self, grads, trainable_variables=None, **kwargs):
        sup = super()
        if trainable_variables is None:
            apply_fn = lambda gs: sup.apply(gs, **kwargs)  # noqa: E731
        else:
            apply_fn = lambda gs: sup.apply(  # noqa: E731
                gs, trainable_variables, **kwargs)
        if self._hvd_agg is not None:
            return self._hvd_agg.apply(list(grads), apply_fn)
        return apply_fn(self._hvd_allreduce(list(grads)))


def DistributedOptimizer(optimizer, *, op: str = Average,
                         compression=Compression.none,
                         backward_passes_per_step: int = 1,
                         process_set=None, sparse_as_dense: bool = False,
                         num_groups: int = 0,
                         name: Optional[str] = None):
    """Reference: ``hvd.DistributedOptimizer(opt)``: an optimizer of a
    subclass of ``type(opt)``, rebuilt from ``opt.get_config()`` (fresh
    and unbuilt), whose ``apply`` allreduces the gradients before the
    update.  Wrapping twice raises."""
    if getattr(optimizer, "_hvd_tpu_distributed", False):
        raise ValueError(
            "optimizer is already distributed (double-wrapping detected)")
    base = type(optimizer)
    cls = type("Distributed" + base.__name__,
               (_DistributedOptimizerMixin, base), {})
    dist = cls.from_config(optimizer.get_config())
    dist._hvd_setup(
        op=op, compression=compression, process_set=process_set,
        sparse_as_dense=sparse_as_dense,
        backward_passes_per_step=backward_passes_per_step,
        reduce_name=name or "DistributedOptimizer.grads",
        num_groups=num_groups)
    return dist


class _DistributedGradientTape:
    """A ``tf.GradientTape`` whose ``gradient()`` returns the allreduced
    gradients."""

    def __init__(self, tape: "tf.GradientTape", *, op, compression,
                 process_set, sparse_as_dense, num_groups=0):
        self._tape = tape
        self._op = op
        self._compression = compression
        self._process_set = process_set
        self._sparse_as_dense = sparse_as_dense
        self._num_groups = num_groups

    def __enter__(self):
        self._tape.__enter__()
        return self

    def __exit__(self, *exc):
        return self._tape.__exit__(*exc)

    def __getattr__(self, item):
        return getattr(self._tape, item)

    def gradient(self, target, sources, output_gradients=None):
        grads = self._tape.gradient(target, sources, output_gradients)
        reduced = _allreduce_grads(
            tf.nest.flatten(grads), op=self._op,
            compression=self._compression, process_set=self._process_set,
            sparse_as_dense=self._sparse_as_dense,
            name="DistributedGradientTape.grads",
            num_groups=self._num_groups)
        return tf.nest.pack_sequence_as(grads, reduced)


def DistributedGradientTape(gradtape: "tf.GradientTape", *,
                            op: str = Average,
                            compression=Compression.none,
                            process_set=None,
                            sparse_as_dense: bool = False,
                            num_groups: int = 0):
    """Reference: ``hvd.DistributedGradientTape(tape)``."""
    return _DistributedGradientTape(
        gradtape, op=op, compression=compression, process_set=process_set,
        sparse_as_dense=sparse_as_dense, num_groups=num_groups)


from . import keras  # noqa: E402,F401  (horovod.tensorflow.keras)
