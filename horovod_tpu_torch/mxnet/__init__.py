"""``import horovod_tpu_torch.mxnet as hvd``: the MXNet binding.

Counterpart of ``horovod_tpu/mxnet/__init__.py`` (reference:
``horovod/mxnet/``): NDArray collectives (:mod:`.mpi_ops`), bridged
through numpy onto a torch tensor on the session's device and the
port's core (``ops/collectives.py``); ``broadcast_parameters``; and
``DistributedTrainer`` (:mod:`.trainer`), a ``gluon.Trainer`` whose
gradients are sum-allreduced in place before the update.

MXNet is retired upstream; this package needs it installed (or an API
stand-in registered as ``mxnet``) and raises an ``ImportError`` naming
it otherwise.  ``import horovod_tpu_torch`` never imports it.
"""

from __future__ import annotations

try:
    import mxnet  # noqa: F401
except ImportError as _e:
    raise ImportError(
        "horovod_tpu_torch.mxnet requires mxnet (retired upstream and not "
        "installed here); use horovod_tpu_torch.torch, "
        "horovod_tpu_torch.tensorflow or horovod_tpu_torch") from _e

from ..basics import (  # noqa: F401
    init, shutdown, is_initialized,
    rank, size, local_rank, local_size, cross_rank, cross_size,
    mpi_built, nccl_built, gloo_built, ccl_built, cuda_built, rocm_built,
)
from ..process_sets import (  # noqa: F401
    ProcessSet, add_process_set, remove_process_set, global_process_set,
)
from .mpi_ops import (  # noqa: F401
    Average, Sum, Adasum, Min, Max, Product,
    allreduce, allreduce_, allreduce_async_,
    grouped_allreduce, grouped_allreduce_, grouped_allreduce_async_,
    allgather, broadcast, broadcast_, alltoall, reducescatter,
    barrier, synchronize, poll, join, Handle,
)
from .functions import broadcast_parameters, broadcast_object  # noqa: F401
from .trainer import DistributedTrainer  # noqa: F401
