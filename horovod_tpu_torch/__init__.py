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

The Horovod collective API runs over process sets: ``ps =
hvd.add_process_set([0, 2])`` (collective: every rank calls it), then
``hvd.allreduce(x, process_set=ps)``, ``hvd.allreduce_async`` +
``hvd.synchronize``, ``hvd.grouped_allreduce``, ``op=hvd.Adasum`` and
the rest; ``DistributedOptimizer`` takes ``process_set=``,
``op=hvd.Adasum`` and ``backward_passes_per_step=``.

Long-context and tensor-parallel training run on a mesh::

    from horovod_tpu_torch.parallel import (make_mesh, shard_params,
        shard_batch, make_spmd_train_step, init_opt_state)
    from horovod_tpu_torch.plan import P
    mesh = make_mesh({"dp": 1, "sp": 2, "tp": 2})
    model = hvd.models.GPT(GPTConfig(attention="ring",
                                     attention_engine="flash"), mesh=mesh)
    shard_params(model, mesh)                 # this rank's tp slices
    opt = init_opt_state(lambda ps: torch.optim.AdamW(ps, lr=3e-4), model)
    step = make_spmd_train_step(hvd.models.lm_loss_fn(model), opt)
    batch = shard_batch((inputs, targets), mesh, P("dp", "sp"))
    loss = step(model, batch)                 # the global mean

GPipe runs a GPT's trunk over a ``pp`` axis
(``hvd.models.PipelinedGPT(cfg, mesh=make_mesh({"dp": 2, "pp": 4}),
n_micro=4)``), and ``GPTConfig(moe_experts=8)`` makes every
``moe_every``-th FFN a mixture of experts cut over an ``ep`` axis; both
train through ``make_spmd_train_step``.  ``hvd.make_fsdp_train_step``
shards parameters, gradients and optimizer state (FSDP, or HSDP with a
``data`` axis beside ``fsdp``).

The session's plan (``HVD_TPU_MESH_PLAN``, ``hvd.mesh_plan()``,
``hvd.apply_mesh_plan``) names the reduce group of ``make_train_step``
and ``make_zero_train_step``.  ``HOROVOD_AUTOTUNE=1`` tunes
``make_train_step``'s knobs online (``hvd.parameter_manager()``).

Durable state and recovery: ``hvd.ckpt.AsyncCheckpointer(dir)`` (async
sharded saves, the step journal, ``resume()``), the whole-tree
``hvd.checkpoint.Checkpointer`` on ``torch.save``, ``hvd.elastic``
(``TorchState(model=, optimizer=)``, ``@hvd.elastic.run``, the sampler
and the discovery driver), ``hvd.faults`` (``HVD_TPU_FAULT_SPEC``) and
``hvd.data`` (padding, masks, joined ragged shards).

The host runtime: ``HOROVOD_TIMELINE`` (or ``hvd.start_timeline``)
writes a Chrome trace of the eager collectives and the step spans; the
stall inspectors warn when a rank stops dispatching
(``HOROVOD_STALL_CHECK_TIME_SECONDS``); ``python -m
horovod_tpu_torch.runner -np N cmd ...`` launches a job (torchrun's
variables, per-rank output, the HMAC-signed control plane of
``runner/common/network.py``), on other hosts too (``-H a:4,b:4``:
ssh-started task agents; ``jsrun`` inside an LSF allocation), and
``hvd.run(func, np=N)`` runs a function on every rank of a fresh world,
returning the results in rank order.

Serving (``hvd.serve``, imported on first use): ``InferenceEngine(GPT)``
(prefill/decode over a dense or paged KV cache, speculative decoding),
``ContinuousBatcher``, ``InferenceServer`` and ``Router``; the fleet
(prefill and decode replicas with live KV migration, ``FleetController``),
the weight hot swap from a checkpoint store (``WeightSubscriber``,
``swap_store=``) and the fleet telemetry plane (``hvd.obs.collector.
TelemetryPlane``).  ``hvd.init(config)`` takes an explicit ``Config`` in
the place of the environment's.

The framework bindings, the reference's ``horovod.torch``,
``horovod.tensorflow`` and ``horovod.keras`` surfaces, are subpackages
imported on demand: ``import horovod_tpu_torch.torch as hvd`` (the
hook-driven ``DistributedOptimizer``, ``SyncBatchNorm``),
``horovod_tpu_torch.tensorflow`` and ``horovod_tpu_torch.keras`` (these
two need tensorflow; nothing else here imports it).

``init(device="cpu")`` runs the same code on the CPU over gloo, where
each kernel wrapper takes its plain PyTorch version.
"""

from .basics import (  # noqa: F401
    init, shutdown, is_initialized, rank, size, local_rank, local_size,
    cross_rank, cross_size, is_homogeneous, device, config, global_mesh,
    mesh_plan, apply_mesh_plan, start_timeline, stop_timeline, timeline,
    stall_inspector, peek,
    NotInitializedError, nccl_built, gloo_built, mpi_built, cuda_built,
    rocm_built, ccl_built, ddl_built, xla_built, gloo_enabled, mpi_enabled,
    xla_enabled, mpi_threads_supported,
)
from .config import Config  # noqa: F401
from .plan import MeshPlan  # noqa: F401
from .version import __version__  # noqa: F401
from .process_sets import (  # noqa: F401
    ProcessSet, add_process_set, remove_process_set, global_process_set,
)
from .ops import (  # noqa: F401
    Average, Sum, Adasum, Min, Max, Product, Compression, Handle,
    synchronize, poll,
    allreduce, allreduce_async, allreduce_, allreduce_async_,
    grouped_allreduce, grouped_allreduce_async, grouped_allreduce_,
    grouped_allreduce_async_, sparse_allreduce_async,
    allgather, allgather_async, grouped_allgather, grouped_allgather_async,
    broadcast, broadcast_async, broadcast_, broadcast_async_,
    alltoall, alltoall_async, reducescatter, reducescatter_async,
    grouped_reducescatter, grouped_reducescatter_async, barrier, join,
)
from .functions import (  # noqa: F401
    broadcast_parameters, broadcast_optimizer_state, broadcast_object,
    allgather_object,
)
from .basics import parameter_manager  # noqa: F401
from .optim import (  # noqa: F401
    DistributedOptimizer, make_fsdp_train_step, make_train_step,
    make_zero_train_step,
)
from . import checkpoint  # noqa: F401
from . import ckpt  # noqa: F401
from . import data  # noqa: F401
from . import elastic  # noqa: F401
from . import faults  # noqa: F401
from . import models  # noqa: F401
from . import obs  # noqa: F401
from . import ops  # noqa: F401
from . import optim  # noqa: F401
from . import parallel  # noqa: F401
from . import plan  # noqa: F401


def __getattr__(name):
    # hvd.run, imported on first use: ``python -m
    # horovod_tpu_torch.runner.run_func`` (its workers) then runs that
    # module once, as __main__ only.
    if name == "run":
        from .runner.run_func import launch

        return launch
    if name == "serve":
        # The serving stack, imported on first touch as the
        # reference's ``hvd.serve``.
        import importlib

        return importlib.import_module(".serve", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
