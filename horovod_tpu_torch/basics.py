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
for the node, ``MASTER_ADDR``/``MASTER_PORT``; without ``RANK``, a
scheduler's ``PMIX_RANK``, ``OMPI_COMM_WORLD_RANK`` or
``SLURM_PROCID``) when it is set, from a
process group the caller already initialised, or else is a world of one
on a free local TCP port.  A world without the node variables is one
node.  The session owns the process-set table
(:mod:`horovod_tpu_torch.process_sets`); :func:`shutdown` clears it.

The session also holds the 1-D world (:func:`global_mesh`) and the
parallelism plan (:func:`mesh_plan`): ``HVD_TPU_MESH_PLAN`` unset is the
1-D plan over the world, a declared layout (``data=2,fsdp=2``) registers
one process set per axis group at ``init``.

And the host runtime: the timeline (``HOROVOD_TIMELINE``;
:func:`timeline`, :func:`start_timeline`, :func:`stop_timeline`), the
stall inspector (:func:`stall_inspector`) and, in a world of two or
more, the cross-process monitor over the native coordinator.
:func:`peek` reads any of them, None before ``init``.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import socket
import threading
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
    backend: str               # the group's backend ("nccl", "gloo")
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
    # The online autotuner (HOROVOD_AUTOTUNE) and, with a declared plan,
    # the layouts its ``layout`` knob indexes (1 = the live one).
    parameter_manager: object = None
    layout_lattice: Optional[list] = None
    # The bound local scrape port (HVD_TPU_METRICS_PORT + rank), if any.
    metrics_port: Optional[int] = None
    # The host runtime: the Chrome-trace timeline (utils/timeline.py),
    # the heartbeat watchdog (utils/stall.py) and, at two ranks or more,
    # the cross-process monitor (utils/cross_stall.py).
    timeline: object = None
    stall_inspector: object = None
    cross_monitor: object = None


_session: Optional[_Session] = None
# Serialises init and shutdown.  The session itself is a frozen snapshot
# published by one assignment, so a reader sees the old session or the
# new one whole; the lock keeps two threads from both starting a world
# (or both tearing one down) between the check and the publish.
_lifecycle_lock = threading.RLock()
# The rendezvous store of the first group this module created from
# torchrun's environment, kept across re-inits: each later generation
# rendezvouses under a prefix of its own on it (``hvd_tpu_torch/gen<g>/``),
# so an elastic re-init never reuses the dead generation's keys and never
# binds ``MASTER_PORT`` twice.
_rendezvous = {"store": None, "key": None, "generation": 0}


def rendezvous_generation() -> int:
    """How many process groups this module has created from the
    environment's rendezvous (0 before the first): an elastic re-init
    moves it on by one."""
    return _rendezvous["generation"]


# A scheduler's own per-task rank (jsrun, mpirun, srun: runner/lsf.py),
# read when the launcher stamped no RANK.
SCHEDULER_RANK_VARS = ("PMIX_RANK", "OMPI_COMM_WORLD_RANK", "SLURM_PROCID")


def _env_rank() -> Optional[int]:
    """This task's rank: ``RANK``, else the first scheduler variable set.
    ``WORLD_SIZE`` > 1 with no rank raises: N tasks all taking rank 0
    would hang in the rendezvous."""
    env = os.environ
    for var in ("RANK",) + SCHEDULER_RANK_VARS:
        if var in env:
            return int(env[var])
    if int(env.get("WORLD_SIZE", "1")) > 1:
        raise RuntimeError(
            f"WORLD_SIZE={env['WORLD_SIZE']} but no per-task rank was "
            f"found: set RANK, or launch through a job-step manager that "
            f"exports {' / '.join(SCHEDULER_RANK_VARS)}")
    return None


def _init_group_from_env(rank: int, kwargs: dict) -> None:
    """``init_process_group`` over torchrun's rendezvous, generation by
    generation: the first creates the store as ``env://`` does, later
    ones reuse it under a fresh prefix."""
    env = os.environ
    key = (env.get("MASTER_ADDR"), env.get("MASTER_PORT"), rank,
           int(env["WORLD_SIZE"]))
    if _rendezvous["store"] is None or _rendezvous["key"] != key:
        dist.init_process_group(init_method="env://", rank=key[2],
                                world_size=key[3], **kwargs)
        _rendezvous.update(store=dist.distributed_c10d._get_default_store(),
                           key=key, generation=1)
        return
    gen = _rendezvous["generation"]
    _rendezvous["generation"] = gen + 1
    dist.init_process_group(
        store=dist.PrefixStore(f"hvd_tpu_torch/gen{gen}/",
                               _rendezvous["store"]),
        rank=key[2], world_size=key[3], **kwargs)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init(config: Optional[Config] = None,
         device: Union[str, torch.device, None] = None,
         backend: Optional[str] = None) -> None:
    """Join (or start) the process group and pick this rank's device.

    ``config`` is an explicit :class:`Config` used in the place of the
    environment's (``Config.from_env()`` when None), as the reference's
    ``init(config)``: every knob read here, the fault plan included,
    comes from it.  ``device=None`` means ``cuda:<local_rank>`` with NCCL, and raises
    ``RuntimeError`` without a CUDA device.  An explicit device is used
    as given: ``"cpu"`` runs over gloo.  ``backend`` overrides the
    device's backend for a group this call creates (``"gloo"`` on CUDA
    tensors: several ranks sharing one card, which NCCL refuses).
    ``HVD_TPU_FAULT_SPEC`` is armed here when it differs from the armed
    plan (a malformed spec raises before any group is joined).
    Idempotent, and safe to call from several threads at once."""
    with _lifecycle_lock:
        _init(config, device, backend)


def _init(config: Optional[Config], device, backend: Optional[str]) -> None:
    global _session
    if _session is not None:
        return
    cfg = config if config is not None else Config.from_env()
    _arm_faults(cfg)
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
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"

    owns = not dist.is_initialized()
    if owns:
        kwargs = dict(backend=backend, timeout=timedelta(minutes=10))
        if backend == "nccl":
            kwargs["device_id"] = dev
        rank = _env_rank()
        if rank is not None and "WORLD_SIZE" in env:
            _init_group_from_env(rank, kwargs)
        else:
            dist.init_process_group(
                init_method=f"tcp://127.0.0.1:{_free_port()}",
                rank=0, world_size=1, **kwargs)
    size, me = dist.get_world_size(), dist.get_rank()
    local_size = int(env.get("LOCAL_WORLD_SIZE", size))
    _session = _Session(
        rank=me, size=size, local_rank=local_rank,
        local_size=local_size, cross_rank=int(env.get("GROUP_RANK", 0)),
        cross_size=int(env.get("GROUP_WORLD_SIZE", -(-size // local_size))),
        device=dev, config=cfg, owns_group=owns,
        backend=str(dist.get_backend()).lower(),
        process_sets=ProcessSetTable(size),
        mesh=GlobalMesh.build(size, me, local_rank, local_size,
                              axis_name=cfg.mesh_axis_name))
    warn_noop_knobs(logger)
    _configure_obs(cfg, me)
    # The session plan: the 1-D default over the global mesh, or the
    # declared HVD_TPU_MESH_PLAN with one process set per axis group.
    try:
        _start_host_runtime(cfg, me)
        _install_plan(cfg.mesh_plan)
        _maybe_build_parameter_manager(_session.config)
        _session = dataclasses.replace(
            _session, cross_monitor=_maybe_start_cross_monitor(cfg))
    except BaseException:
        shutdown()
        raise


def _arm_faults(cfg: Config) -> None:
    """Arm the fault plan once per spec: an elastic re-init (shutdown,
    then init, mid-recovery) must not restart the armed plan's counters
    and history, or a step fault would fire again on every reset."""
    if cfg.fault_spec:
        from . import faults

        if faults.active_spec() != cfg.fault_spec:
            faults.configure(cfg.fault_spec)


def _configure_obs(cfg: Config, rank: int) -> None:
    """Pin the telemetry gates to the resolved config and start the scrape
    port on ``metrics_port + rank``.  The registry and the span and event
    rings are NOT reset: counters span re-inits, so rates stay
    meaningful."""
    global _session
    from .obs import flight, metrics, trace

    metrics.configure(enabled=cfg.metrics, window=cfg.metrics_window)
    trace.configure(enabled=cfg.trace, ring=cfg.trace_ring)
    flight.configure(enabled=cfg.flight, directory=cfg.flight_dir,
                     ring=cfg.flight_ring)
    if cfg.metrics and cfg.metrics_port > 0:
        from .obs import export

        _session = dataclasses.replace(
            _session,
            metrics_port=export.start_http_exporter(cfg.metrics_port + rank))


def _start_host_runtime(cfg: Config, rank: int) -> None:
    """The log level, this rank's timeline and the stall inspector."""
    global _session
    from .utils.logging import set_level
    from .utils.stall import StallInspector
    from .utils.timeline import Timeline, per_process_path

    set_level(cfg.log_level)
    _session = dataclasses.replace(
        _session,
        timeline=Timeline(per_process_path(cfg.timeline, rank),
                          mark_cycles=cfg.timeline_mark_cycles),
        stall_inspector=StallInspector(
            enabled=not cfg.stall_check_disable,
            warn_after_s=cfg.stall_check_time_seconds,
            shutdown_after_s=cfg.stall_shutdown_time_seconds))


def _maybe_start_cross_monitor(cfg: Config):
    """The cross-process stall monitor over the native coordinator, in a
    world of two or more (reference: ``basics._maybe_start_cross_monitor``).

    Fail-soft, with one hard rule: the exchange of rank 0's coordinator
    port is a collective, so every rank reaches it exactly once whatever
    fails locally (a rank that skipped it would leave its peers blocked
    in ``init``).  A local failure ships port -1 (rank 0) or ignores the
    port it got (the others).  The exchange is a plain
    ``torch.distributed`` broadcast: it ticks no fault site and counts
    no dispatch."""
    s = _session
    if s.size <= 1 or cfg.stall_check_disable or not cfg.native_coordinator:
        return None
    from .native import runtime as native

    host = os.environ.get("MASTER_ADDR") or "127.0.0.1"
    try:
        host = socket.gethostbyname(host)
    except OSError:
        host = "127.0.0.1"
    coord, port = None, -1
    if s.rank == 0:
        try:
            if native.available():
                coord = native.Coordinator(
                    0, s.size, host=host, port=0,
                    fusion_threshold=cfg.fusion_threshold, timeout_s=30.0)
                port = coord.bound_port
        except Exception as e:
            logger.warning("cross-process stall monitor unavailable: %s", e)
            coord, port = None, -1
    box = torch.tensor([port], dtype=torch.int64, device=s.device)
    try:
        dist.broadcast(box, src=0)
        port = int(box.item())
    except Exception as e:
        logger.warning("cross-process monitor port exchange failed: %s", e)
        port = -1
    if port < 0:
        if coord is not None:   # the exchange failed after a good bind
            coord.close()
        return None
    if s.rank != 0:
        try:
            if native.available():
                coord = native.Coordinator(
                    s.rank, s.size, host=host, port=port,
                    fusion_threshold=cfg.fusion_threshold, timeout_s=30.0)
        except Exception as e:
            logger.warning("cross-process stall monitor unavailable: %s", e)
            coord = None
    if coord is None:
        return None
    from .utils.cross_stall import CrossProcessMonitor

    return CrossProcessMonitor(coord,
                               warn_after_s=cfg.stall_check_time_seconds)


def metrics_port() -> Optional[int]:
    """The port this rank's ``/metrics`` answers on
    (``HVD_TPU_METRICS_PORT`` + rank), or None."""
    return _require().metrics_port


def shutdown() -> None:
    """Close the timeline, stop the stall inspectors, drop the process
    sets and the topology tiers' groups, stop the scrape port and leave
    the process group (if :func:`init` created it)."""
    with _lifecycle_lock:
        _shutdown()


def _shutdown() -> None:
    global _session
    if _session is None:
        return
    if _session.timeline is not None:
        _session.timeline.close()
    if _session.stall_inspector is not None:
        _session.stall_inspector.stop()
    if _session.cross_monitor is not None:
        _session.cross_monitor.stop()
    if _session.metrics_port is not None:
        from .obs import export

        export.stop_http_exporter()
    if _session.parameter_manager is not None:
        _session.parameter_manager.close()
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


def peek(attr: str):
    """One field of the session (``"timeline"``, ``"stall_inspector"``,
    ``"cross_monitor"``, ...), or None before :func:`init`: the
    fail-soft read of the observability paths, which run before and
    after a session."""
    return getattr(_session, attr, None)


def timeline():
    """This rank's :class:`~.utils.timeline.Timeline` (disabled unless
    ``HOROVOD_TIMELINE`` or :func:`start_timeline` gave it a path)."""
    return _require().timeline


def stall_inspector():
    """This rank's :class:`~.utils.stall.StallInspector`."""
    return _require().stall_inspector


def start_timeline(path: str, mark_cycles: bool = False) -> None:
    """Reference: ``hvd.start_timeline()``: close the live timeline and
    write a new one to ``path`` (rank r: ``<path>.rank<r>``)."""
    global _session
    from .utils.timeline import Timeline, per_process_path

    s = _require()
    if s.timeline is not None:
        s.timeline.close()
    _session = dataclasses.replace(
        s, timeline=Timeline(per_process_path(path, s.rank),
                             mark_cycles=mark_cycles))


def stop_timeline() -> None:
    """Reference: ``hvd.stop_timeline()``: close the live timeline."""
    global _session
    from .utils.timeline import Timeline

    s = _require()
    if s.timeline is not None:
        s.timeline.close()
    _session = dataclasses.replace(s, timeline=Timeline(None))


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


def backend() -> str:
    """The session group's backend (``"nccl"``, ``"gloo"``)."""
    return _require().backend


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
    from .obs import instrument

    _require()
    plan = _install_plan(spec)
    instrument.on_plan_relayout()
    return plan


# --- the online autotuner (reference: basics.py's parameter manager) -------

# Pipeline-depth search ceiling: past ~8 buckets in flight the transient
# shard buffers outweigh any remaining overlap.
_MAX_PIPELINE_DEPTH = 8
# Microbatch search ceiling.
_MAX_MICROBATCHES = 32
# Search lattices (index 1..n on the GP's log2 machinery); the names are
# the knobs' own values, so an applied point round-trips through them.
_COMPRESSOR_LATTICE = ("none", "fp16", "bf16", "int8")
_TOPO_LATTICE = ("flat", "two_phase", "hierarchical")
_KERNEL_LATTICE = ("spmd", "pallas")


def _nearest_pow2(value: int) -> int:
    """Nearest power of two in log space."""
    v = max(1, int(value))
    lo = 1 << (v.bit_length() - 1)
    hi = lo * 2
    return lo if abs(math.log2(v) - math.log2(lo)) <= \
        abs(math.log2(hi) - math.log2(v)) else hi


def _nearest_divisor(value: int, size: int) -> int:
    """The divisor of ``size`` nearest ``value`` in log space (the
    hierarchical inner width must tile the ranks exactly)."""
    divisors = [d for d in range(1, size + 1) if size % d == 0]
    return min(divisors,
               key=lambda d: abs(math.log2(d) - math.log2(max(1, value))))


def _maybe_build_parameter_manager(cfg: Config) -> None:
    """``HOROVOD_AUTOTUNE=1``: build the online knob tuner into the
    session, and make the live config the manager's start point (scores
    are attributed to it).  The knobs, as the reference picks them: the
    fusion threshold always; with ``HOROVOD_HIERARCHICAL_ALLREDUCE`` on
    four or more ranks the hierarchical inner width; with
    ``HVD_TPU_TWO_PHASE_ALLREDUCE`` the two-phase on/off and pipeline
    depth; with ``HVD_TPU_MICROBATCHES > 1`` the microbatch count and
    the overlap on/off; with ``HVD_TPU_ERROR_FEEDBACK`` the compressor;
    with ``HVD_TPU_TOPO_SCHEDULE`` on, the schedule (on a two-tier
    topology) and the lowering backend; with a declared
    ``HVD_TPU_MESH_PLAN``, the layout among ``plan.layout_lattice``.
    Each is applied at the step's rebuild (``optim/autotune.py``)."""
    global _session
    if not cfg.autotune:
        return
    from .optim.parameter_manager import ParameterManager

    lo, hi = 1 << 20, 1 << 28
    knobs = {"fusion_threshold": (lo, hi)}
    initial = {}
    size = _session.size
    joint = cfg.hierarchical_allreduce and size >= 4
    joint_two_phase = cfg.two_phase_allreduce and size > 1
    if joint_two_phase:
        knobs["two_phase"] = (1, 2)
        initial["two_phase"] = 2
        knobs["pipeline_depth"] = (1, _MAX_PIPELINE_DEPTH)
        initial["pipeline_depth"] = min(max(1, cfg.pipeline_depth),
                                        _MAX_PIPELINE_DEPTH)
    joint_microbatch = cfg.microbatches > 1 and size > 1
    if joint_microbatch:
        knobs["microbatches"] = (1, _MAX_MICROBATCHES)
        initial["microbatches"] = _nearest_pow2(
            min(max(1, cfg.microbatches), _MAX_MICROBATCHES))
        knobs["overlap"] = (1, 2)
        initial["overlap"] = 2 if cfg.overlap_reduce else 1
    if cfg.error_feedback and size > 1:
        knobs["compressor"] = (1, len(_COMPRESSOR_LATTICE))
        initial["compressor"] = _COMPRESSOR_LATTICE.index(
            cfg.compression or "none") + 1
    if cfg.topo_schedule != "off" and size > 1:
        from .topo.topology import MeshTopology, resolve_topology

        try:
            topo = resolve_topology(size, cfg.topo_spec)
        except ValueError:
            topo = MeshTopology(pods=1, chips_per_pod=size)
        if topo.two_tier:
            knobs["topo_schedule"] = (1, len(_TOPO_LATTICE))
            initial["topo_schedule"] = (
                _TOPO_LATTICE.index(cfg.topo_schedule) + 1
                if cfg.topo_schedule in _TOPO_LATTICE
                else len(_TOPO_LATTICE))   # auto seeds at hierarchical
        knobs["topo_kernel"] = (1, len(_KERNEL_LATTICE))
        initial["topo_kernel"] = (
            _KERNEL_LATTICE.index(cfg.topo_kernel) + 1
            if cfg.topo_kernel in _KERNEL_LATTICE else 1)
    layouts = None
    if cfg.mesh_plan is not None and size > 1:
        from . import plan as _plan

        layouts = _plan.layout_lattice(size)
        if cfg.mesh_plan in layouts:
            layouts.remove(cfg.mesh_plan)
        layouts = [cfg.mesh_plan] + layouts
        if len(layouts) > 1:
            knobs["layout"] = (1, len(layouts))
            initial["layout"] = 1
        else:
            layouts = None
    if joint:
        knobs["hierarchical_inner_size"] = (1, size)
        live_inner = cfg.hierarchical_inner_size
        if not 1 <= live_inner <= size:
            live_inner = max(1, size // 2)
        initial["hierarchical_inner_size"] = _nearest_divisor(live_inner,
                                                              size)
    # A live threshold outside the search space (0, fusion off) cannot
    # seed it: the tuner's start point becomes the live value instead.
    seedable = lo <= cfg.fusion_threshold <= hi
    if seedable:
        initial["fusion_threshold"] = cfg.fusion_threshold
    pm = ParameterManager(
        knobs=knobs,
        warmup_samples=cfg.autotune_warmup_samples,
        steps_per_sample=cfg.autotune_steps_per_sample,
        max_samples=cfg.autotune_max_samples,
        # Only the deciding rank writes the log (a second writer opening
        # it with mode "w" would truncate it).
        log_path=cfg.autotune_log if _session.rank == 0 else None,
        initial=initial or None,
    )
    start = pm.current_values()
    updates = {}
    if not seedable:
        updates["fusion_threshold"] = int(start["fusion_threshold"])
        logger.warning(
            "HOROVOD_AUTOTUNE=1 overrides fusion_threshold=%d (outside the "
            "tunable range [%d, %d]): starting from %d",
            cfg.fusion_threshold, lo, hi, updates["fusion_threshold"])
    if joint:
        updates["hierarchical_inner_size"] = _nearest_divisor(
            int(round(start["hierarchical_inner_size"])), size)
    if joint_two_phase:
        updates["pipeline_depth"] = int(round(start["pipeline_depth"]))
    if joint_microbatch:
        updates["microbatches"] = _nearest_pow2(int(round(
            start["microbatches"])))
        updates["overlap_reduce"] = start["overlap"] >= 1.5
    if "compressor" in knobs:
        idx = min(max(1, int(round(start["compressor"]))),
                  len(_COMPRESSOR_LATTICE))
        updates["compression"] = _COMPRESSOR_LATTICE[idx - 1]
    _session = dataclasses.replace(
        _session, parameter_manager=pm, layout_lattice=layouts,
        config=dataclasses.replace(_session.config, **updates))
    logger.info("autotune enabled: tuning %s, %d warmup + %d scored windows "
                "of %d steps%s", " x ".join(pm.knob_names),
                cfg.autotune_warmup_samples, cfg.autotune_max_samples,
                cfg.autotune_steps_per_sample,
                f", log={cfg.autotune_log}" if cfg.autotune_log else "")


def parameter_manager():
    """The session's autotuner, or None unless ``HOROVOD_AUTOTUNE=1``."""
    return _require().parameter_manager


def _apply_autotuned_knobs(values) -> dict:
    """Apply an autotune proposal: swap the session's config for one with
    the knobs' new values (a layout rebuilds the plan: collective, every
    rank applies the same proposal).  Returns the values as applied,
    snapped onto each knob's lattice and keyed by knob name, for the
    manager to attribute the next scores to."""
    global _session
    s = _require()
    updates, applied = {}, {}
    if "fusion_threshold" in values:
        v = int(values["fusion_threshold"])
        updates["fusion_threshold"] = applied["fusion_threshold"] = v
    if "hierarchical_inner_size" in values:
        v = _nearest_divisor(int(round(values["hierarchical_inner_size"])),
                             s.size)
        updates["hierarchical_inner_size"] = v
        applied["hierarchical_inner_size"] = v
    if "two_phase" in values:
        snapped = 2 if values["two_phase"] >= 1.5 else 1
        updates["two_phase_allreduce"] = snapped == 2
        applied["two_phase"] = snapped
    if "pipeline_depth" in values:
        v = min(max(1, int(round(values["pipeline_depth"]))),
                _MAX_PIPELINE_DEPTH)
        updates["pipeline_depth"] = applied["pipeline_depth"] = v
    if "microbatches" in values:
        v = min(_nearest_pow2(int(round(values["microbatches"]))),
                _MAX_MICROBATCHES)
        updates["microbatches"] = applied["microbatches"] = v
    if "overlap" in values:
        snapped = 2 if values["overlap"] >= 1.5 else 1
        updates["overlap_reduce"] = snapped == 2
        applied["overlap"] = snapped
    for knob, field, lattice in (
            ("compressor", "compression", _COMPRESSOR_LATTICE),
            ("topo_schedule", "topo_schedule", _TOPO_LATTICE),
            ("topo_kernel", "topo_kernel", _KERNEL_LATTICE)):
        if knob in values:
            idx = min(max(1, int(round(values[knob]))), len(lattice))
            updates[field] = lattice[idx - 1]
            applied[knob] = idx
    if "layout" in values and s.layout_lattice:
        idx = min(max(1, int(round(values["layout"]))),
                  len(s.layout_lattice))
        updates["mesh_plan"] = s.layout_lattice[idx - 1]
        applied["layout"] = idx
    relayout = ("mesh_plan" in updates
                and updates["mesh_plan"] != s.config.mesh_plan)
    _session = dataclasses.replace(
        s, config=dataclasses.replace(s.config, **updates))
    if relayout:
        # The next step reads the new plan (its groups, its reduce axes).
        from .obs import instrument

        _install_plan(updates["mesh_plan"])
        instrument.on_plan_relayout()
    return applied


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
