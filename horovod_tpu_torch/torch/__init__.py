"""``import horovod_tpu_torch.torch as hvd``: the torch binding.

Counterpart of ``horovod_tpu/torch/__init__.py`` (reference:
``horovod/torch/__init__.py``), over the port's core.  A rank is a
process; ``hvd.init()`` puts it on ``cuda:<local_rank>`` (NCCL), and
``hvd.init(device="cpu")`` on the CPU (gloo).  Usage, as the
reference's::

    import horovod_tpu_torch.torch as hvd

    hvd.init()
    optimizer = hvd.DistributedOptimizer(
        optimizer, named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(optimizer, root_rank=0)

The optimizer starts each gradient's allreduce from a hook while
backward runs (:mod:`.optimizer`); the core's
``horovod_tpu_torch.DistributedOptimizer`` reduces fused buckets after
backward instead.
"""

from __future__ import annotations

from ..basics import (  # noqa: F401
    init, shutdown, is_initialized, is_homogeneous,
    local_rank, local_size,
    mpi_built, nccl_built, gloo_built, ccl_built, cuda_built, rocm_built,
    xla_built, mpi_threads_supported,
    NotInitializedError,
)
from .. import basics as _basics
from ..process_sets import (  # noqa: F401
    ProcessSet, add_process_set, remove_process_set, global_process_set,
)
from .mpi_ops import (  # noqa: F401
    Average, Sum, Adasum, Min, Max, Product,
    allreduce, allreduce_, allreduce_async, allreduce_async_,
    grouped_allreduce, grouped_allreduce_, grouped_allreduce_async,
    grouped_allreduce_async_,
    allgather, allgather_async, grouped_allgather,
    broadcast, broadcast_, broadcast_async, broadcast_async_,
    alltoall, reducescatter, grouped_reducescatter,
    sparse_allreduce_async,
    barrier, join, synchronize, poll, Handle,
)
from .compression import Compression  # noqa: F401
from .functions import (  # noqa: F401
    broadcast_object, allgather_object, broadcast_parameters,
    broadcast_optimizer_state,
)
from .optimizer import DistributedOptimizer  # noqa: F401
from .sync_batch_norm import SyncBatchNorm  # noqa: F401
from ..elastic.sampler import ElasticSampler  # noqa: F401
from . import elastic  # noqa: F401  (hvd.elastic.TorchState / run)


def rank() -> int:
    """This process's rank (reference: ``hvd.rank()``)."""
    return _basics.rank()


def size() -> int:
    """The number of ranks (reference: ``hvd.size()``)."""
    return _basics.size()


def cross_rank() -> int:
    """Reference: ``hvd.cross_rank()`` (the node's index)."""
    return _basics.cross_rank()


def cross_size() -> int:
    """Reference: ``hvd.cross_size()``."""
    return _basics.cross_size()
