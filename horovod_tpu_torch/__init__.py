"""horovod_tpu_torch — the PyTorch/CUDA port of horovod_tpu.

A package of its own beside the JAX reference (``horovod_tpu``): it
imports ``torch`` and never ``jax`` or any module of ``horovod_tpu``.
Its kernels are written by hand in CUDA C++ for Hopper (``csrc/``) and
built with nvcc at first use.  Usage::

    import horovod_tpu_torch as hvd
    hvd.init()                       # cuda:<local_rank> and NCCL
    model = hvd.models.GPT(cfg).to(hvd.device())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4),
        compression=hvd.Compression.int8, error_feedback=True)
    step = hvd.make_train_step(hvd.models.lm_loss_fn(model), opt)
    loss = step(model, (inputs, targets))   # this rank's shard

The ZeRO-1 step (optimizer state sharded over the ranks) is
``hvd.make_zero_train_step(loss_fn, lambda shards: torch.optim.AdamW(
shards, lr=3e-4), compression=hvd.Compression.int8)``; the fused
collectives (int8 wire, all-gather + SGD/Adam apply, the FSDP unshard
matmul ``hvd.optim.unshard_matmul``) are in ``hvd.ops``.

``init(device="cpu")`` runs the same code on the CPU over gloo, where
each kernel wrapper takes its plain PyTorch version.
"""

from .basics import (  # noqa: F401
    init, shutdown, is_initialized, rank, size, local_rank, local_size,
    device, config, NotInitializedError,
)
from .config import Config  # noqa: F401
from .ops import (  # noqa: F401
    Average, Sum, Min, Max, Product,
    allreduce, allgather, alltoall, broadcast, Compression,
)
from .functions import (  # noqa: F401
    broadcast_parameters, broadcast_optimizer_state,
)
from .optim import (  # noqa: F401
    DistributedOptimizer, make_train_step, make_zero_train_step,
)
from . import models  # noqa: F401
from . import ops  # noqa: F401
from . import optim  # noqa: F401
