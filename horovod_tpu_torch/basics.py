"""Process model: init / shutdown / rank / size / local_rank / device,
the node layout (``cross_rank``, ``cross_size``) and the feature matrix.

Counterpart of ``horovod_tpu/basics.py`` over ``torch.distributed``: one
process per card, as in the reference Horovod.  :func:`init` with no
argument takes ``cuda:<local_rank>`` and NCCL and raises when there is
no CUDA device; it never drops to the CPU on its own.
``init(device="cpu")`` runs the same code on the CPU over gloo, which
is how the tests run it.

The world comes from torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``GROUP_RANK``/``GROUP_WORLD_SIZE``
for the node, ``MASTER_ADDR``/``MASTER_PORT``) when it is set, from a
process group the caller already initialised, or else is a world of one
on a free local TCP port.  A world without the node variables is one
node.  The session owns the process-set table
(:mod:`horovod_tpu_torch.process_sets`); :func:`shutdown` clears it.

The session also holds the 1-D world (:func:`global_mesh`) and the
parallelism plan (:func:`mesh_plan`): ``HVD_TPU_MESH_PLAN`` unset is the
1-D plan over the world, a declared layout (``data=2,fsdp=2``) registers
one process set per axis group at ``init``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import socket
from datetime import timedelta
from typing import Optional, Union

import torch
import torch.distributed as dist

from .config import Config, warn_noop_knobs
from .mesh import GlobalMesh
from .process_sets import ProcessSetTable, destroy_group

logger = logging.getLogger(__name__)


class NotInitializedError(RuntimeError):
    def __init__(self) -> None:
        super().__init__("horovod_tpu_torch has not been initialized; "
                         "call horovod_tpu_torch.init() first.")


@dataclasses.dataclass(frozen=True)
class _Session:
    rank: int
    size: int
    local_rank: int
    local_size: int
    cross_rank: int
    cross_size: int
    device: torch.device
    config: Config
    owns_group: bool           # False when the caller initialised it
    process_sets: ProcessSetTable
    # The topology tiers' groups, by (pods, chips_per_pod): every rank's
    # intra-pod groups, then its cross-pod groups (topo/topology.py).
    tier_groups: dict = dataclasses.field(default_factory=dict)
    mesh: Optional[GlobalMesh] = None
    # The parallelism plan (plan/mesh_plan.py), and its axis groups' torch
    # groups by (axis names, sizes, axes), each list in the order of
    # Mesh.groups.
    mesh_plan: object = None
    mesh_groups: dict = dataclasses.field(default_factory=dict)


_session: Optional[_Session] = None


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init(device: Union[str, torch.device, None] = None) -> None:
    """Join (or start) the process group and pick this rank's device.

    ``device=None`` means ``cuda:<local_rank>`` with NCCL, and raises
    ``RuntimeError`` without a CUDA device.  An explicit device is used
    as given: ``"cpu"`` runs over gloo.  Idempotent."""
    global _session
    if _session is not None:
        return
    env = os.environ
    # An adopted group without torchrun's env runs on one host.
    local_rank = int(env.get(
        "LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "horovod_tpu_torch.init(): no CUDA device; pass "
                "device='cpu' to run on the CPU")
        dev = torch.device("cuda", local_rank)
    else:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"

    owns = not dist.is_initialized()
    if owns:
        kwargs = dict(backend=backend, timeout=timedelta(minutes=10))
        if dev.type == "cuda":
            kwargs["device_id"] = dev
        if "RANK" in env and "WORLD_SIZE" in env:
            dist.init_process_group(init_method="env://", **kwargs)
        else:
            dist.init_process_group(
                init_method=f"tcp://127.0.0.1:{_free_port()}",
                rank=0, world_size=1, **kwargs)
    size, me = dist.get_world_size(), dist.get_rank()
    local_size = int(env.get("LOCAL_WORLD_SIZE", size))
    cfg = Config.from_env()
    _session = _Session(
        rank=me, size=size, local_rank=local_rank,
        local_size=local_size, cross_rank=int(env.get("GROUP_RANK", 0)),
        cross_size=int(env.get("GROUP_WORLD_SIZE", -(-size // local_size))),
        device=dev, config=cfg, owns_group=owns,
        process_sets=ProcessSetTable(size),
        mesh=GlobalMesh.build(size, me, local_rank, local_size))
    warn_noop_knobs(logger)
    # The session plan: the 1-D default over the global mesh, or the
    # declared HVD_TPU_MESH_PLAN with one process set per axis group.
    try:
        _install_plan(cfg.mesh_plan)
    except BaseException:
        shutdown()
        raise


def shutdown() -> None:
    """Drop the process sets and the topology tiers' groups and leave the
    process group (if :func:`init` created it)."""
    global _session
    if _session is None:
        return
    _session.process_sets.clear()
    for intra, cross in _session.tier_groups.values():
        for group in intra + cross:
            destroy_group(group)
    _session.tier_groups.clear()
    for groups in _session.mesh_groups.values():
        for group in groups:
            destroy_group(group)
    _session.mesh_groups.clear()
    if _session.owns_group and dist.is_initialized():
        dist.destroy_process_group()
    _session = None


def is_initialized() -> bool:
    return _session is not None


def _require() -> _Session:
    if _session is None:
        raise NotInitializedError()
    return _session


def rank() -> int:
    return _require().rank


def size() -> int:
    return _require().size


def local_rank() -> int:
    return _require().local_rank


def local_size() -> int:
    return _require().local_size


def cross_rank() -> int:
    """This rank's node (torchrun's ``GROUP_RANK``; 0 on one node)."""
    return _require().cross_rank


def cross_size() -> int:
    """The number of nodes (``GROUP_WORLD_SIZE``, else ``size /
    local_size``)."""
    return _require().cross_size


def is_homogeneous() -> bool:
    """True when every node runs ``local_size`` ranks."""
    s = _require()
    return s.size == s.local_size * s.cross_size


def device() -> torch.device:
    """This rank's device: ``cuda:<local_rank>`` unless :func:`init` was
    given another."""
    return _require().device


def config() -> Config:
    return _require().config


def global_mesh() -> GlobalMesh:
    """The 1-D world: every rank on the axis ``hvd``."""
    return _require().mesh


def mesh_plan():
    """The session's :class:`~horovod_tpu_torch.plan.MeshPlan`, the one
    source every parallelism entry point derives its axes, groups and
    tiers from.  ``HVD_TPU_MESH_PLAN`` unset: the 1-D plan over
    :func:`global_mesh`."""
    plan = _require().mesh_plan
    if plan is None:
        raise NotInitializedError()
    return plan


def _install_plan(spec):
    """Compile ``spec``'s plan, register its process sets (collective)
    and put both spec and plan in the session."""
    global _session
    from . import plan as _plan

    plan = _plan.compile_plan(spec)
    plan.register_process_sets(_session.process_sets)
    _session = dataclasses.replace(
        _session, mesh_plan=plan,
        config=dataclasses.replace(_session.config, mesh_plan=spec))
    return plan


def apply_mesh_plan(spec):
    """Rebuild the session's plan from an axis spec (``"data=4,fsdp=2"``;
    None restores the 1-D default); returns it.  Collective: every rank
    calls it with the same spec.  Steps read the plan at each call, so
    the next step runs on the new layout."""
    _require()
    return _install_plan(spec)


# --- feature matrix (reference: hvd.nccl_built() and friends): what this
#     torch build and session really have ---------------------------------

def nccl_built() -> int:
    """NCCL's version code (``NCCL_VERSION_CODE``: 22105 for 2.21.5) when
    torch has NCCL, else 0."""
    if not (dist.is_nccl_available() and torch.cuda.is_available()):
        return 0
    major, minor, patch = torch.cuda.nccl.version()[:3]
    if (major, minor) >= (2, 9):
        return major * 10000 + minor * 100 + patch
    return major * 1000 + minor * 100 + patch


def gloo_built() -> bool:
    return dist.is_gloo_available()


def mpi_built() -> bool:
    return dist.is_mpi_available()


def cuda_built() -> bool:
    return torch.version.cuda is not None


def rocm_built() -> bool:
    return getattr(torch.version, "hip", None) is not None


def ccl_built() -> bool:
    """False: the port runs no oneCCL backend."""
    return False


def ddl_built() -> bool:
    return False


def xla_built() -> bool:
    """False: collectives run over ``torch.distributed``, not XLA."""
    return False


def _backend() -> str:
    _require()
    return str(dist.get_backend()).lower()


def gloo_enabled() -> bool:
    return _backend() == "gloo"


def mpi_enabled() -> bool:
    return _backend() == "mpi"


def xla_enabled() -> bool:
    return False


def mpi_threads_supported() -> bool:
    """False: the port drives no MPI library of its own."""
    return False
