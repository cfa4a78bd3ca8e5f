"""``DistributedTrainer``: gluon training with the gradients reduced
over the ranks.

Counterpart of ``horovod_tpu/mxnet/trainer.py`` (reference:
``DistributedTrainer`` in ``horovod/mxnet/__init__.py``): a
``gluon.Trainer`` with ``kvstore=None`` whose ``_allreduce_grads``
sum-allreduces every gradient in place, pre- and post-scaled so that,
with the optimizer's ``rescale_grad``, the applied gradient is the mean
over the ranks.
"""

from __future__ import annotations

import mxnet as mx  # gated by horovod_tpu_torch/mxnet/__init__.py

from .. import basics
from ..ops.compression import NoneCompressor
from . import mpi_ops


class DistributedTrainer(mx.gluon.Trainer):
    """Reference API: ``hvd.DistributedTrainer(params, opt,
    optimizer_params, gradient_predivide_factor=1.0, process_set=...)``.

    The gradient applied is ``sum_r(grad_r) / N`` over the ``N`` ranks
    (of ``process_set``), as single-rank training on an N-times larger
    batch.  ``gradient_predivide_factor`` moves that 1/N between the
    pre- and the post-scale of the summed allreduce.  An
    ``mx.optimizer.Optimizer`` object takes no ``optimizer_params``.
    ``compression`` is kept for the reference's signature and accepts
    only None or ``Compression.none``: the binding reduces the gradients
    uncompressed, so any other compressor raises
    ``NotImplementedError`` rather than go unapplied."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 gradient_predivide_factor: float = 1.0,
                 prescale_factor: float = 1.0,
                 postscale_factor: float = 1.0,
                 process_set=None,
                 num_groups: int = 0,
                 compression=None):
        if isinstance(optimizer, mx.optimizer.Optimizer) \
                and optimizer_params is not None:
            raise ValueError(
                "optimizer_params is only usable with a string optimizer "
                "name (reference contract)")
        if compression not in (None, NoneCompressor):
            raise NotImplementedError(
                "DistributedTrainer: the MXNet binding reduces gradients "
                f"uncompressed; compression={compression!r} is not "
                "supported (pass None)")
        super().__init__(params, optimizer, optimizer_params, kvstore=None)

        self._hvd_process_set = process_set
        self._hvd_num_groups = int(num_groups)
        # The reference's world is its controller processes; the port's
        # ranks are processes too.
        n = (process_set.size() if process_set is not None
             else basics.size())
        self._hvd_prescale = prescale_factor / gradient_predivide_factor
        self._hvd_postscale = postscale_factor * gradient_predivide_factor / n
        self._hvd_world = n

    def _hvd_grads(self):
        grads = []
        for p in self._params:
            if getattr(p, "grad_req", "write") != "null":
                if hasattr(p, "list_grad"):
                    grads.extend(p.list_grad())
                elif hasattr(p, "grad") and callable(getattr(p, "grad")):
                    grads.append(p.grad())
        return grads

    def _allreduce_grads(self):
        grads = self._hvd_grads()
        if not grads:
            return
        if self._hvd_num_groups > 0:
            k = max(1, (len(grads) + self._hvd_num_groups - 1)
                    // self._hvd_num_groups)
            handles = [mpi_ops.grouped_allreduce_async_(
                grads[i:i + k], op=mpi_ops.Sum,
                process_set=self._hvd_process_set,
                prescale_factor=self._hvd_prescale,
                postscale_factor=self._hvd_postscale,
                name=f"grads[{i}]") for i in range(0, len(grads), k)]
        else:
            handles = [mpi_ops.allreduce_async_(
                g, op=mpi_ops.Sum, process_set=self._hvd_process_set,
                prescale_factor=self._hvd_prescale,
                postscale_factor=self._hvd_postscale,
                name=f"grad[{i}]") for i, g in enumerate(grads)]
        for h in handles:
            h.wait()
