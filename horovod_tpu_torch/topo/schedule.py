"""The schedule compiler: each bucket lowered to a deterministic,
rank-invariant :class:`CollectiveSchedule`, and its executor on
``torch.distributed`` groups.

Counterpart of ``horovod_tpu/topo/schedule.py``.  Given a bucket's
payload bytes, a :class:`~.topology.MeshTopology` and per-tier α/β
(:mod:`.costmodel`), :func:`compile_bucket_schedule` emits one of

* ``flat``: one allreduce over the whole world;
* ``two_phase``: reduce-scatter → all-gather over the whole world (the
  pipelined wire of ``ops/fusion.py``, for buckets bound by bandwidth
  on meshes where hierarchy does not pay);
* ``hierarchical``: reduce-scatter inside the pod (``ici``, NVLink in
  the port) → allreduce of the ``b/C`` fragment between pods (``dcn``,
  the network) → all-gather inside the pod,

as a tuple of ``(op, tier, groups, payload)`` :class:`ScheduleStep`\\ s.
The IR is bookkeeping over sizes: every rank compiles the same schedule,
and it compares equal, field by field, to the reference's.  Its choice
asks the native twin (``hvd_tpu_plan_hierarchical``) first, as the
reference does, and :func:`choose_algo` without it.

:func:`execute_schedule` runs a schedule on a compressor's wire over the
tiers' torch groups (:func:`~.topology.tier_groups`):
:func:`hierarchical_reduce_scatter` / :func:`hierarchical_all_gather` are
the halves the overlap wire composes (shards come back in (chip,
pod)-major order and the all-gather inverts the permutation).  On
``Compression.int8`` every stage is the port's int8 wire (B2 quantize,
B3 dequantize-accumulate, B4 dequantize), over the tier's group, with
blocks of the tier's width.

The IR keeps the reference's ``kernel`` field (``spmd`` or ``pallas``,
from ``HVD_TPU_TOPO_KERNEL``).  The reference lowers the int8 intra-pod
steps under ``pallas`` to its fused Pallas kernels; the port has one
int8 wire, already on its Hopper kernels, so both values lower to the
same B2–B4 calls and give the same bits, as the reference's two
backends do.

Telemetry: :func:`record_plans` publishes the ``hvd_tpu_topo_*``
metrics, and each stage of a hierarchical schedule runs under its span
(``hvd_tpu_topo_rs_intra``, ``_xpod``, ``_ag_intra``, with the
reference's args), every step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from .. import faults as _faults
from ..obs import instrument as _obs
from ..obs import trace as _trace
from ..ops.collectives import Handle
from .costmodel import (TopoCostParams, default_params, estimator,
                        flat_cost_us, hierarchical_cost_us,
                        hierarchical_phase_costs_us)
from .topology import MeshTopology, config_topology, tier_groups

Groups = Optional[Tuple[Tuple[int, ...], ...]]

ALGO_FLAT, ALGO_TWO_PHASE, ALGO_HIERARCHICAL = "flat", "two_phase", \
    "hierarchical"
ALGOS = (ALGO_FLAT, ALGO_TWO_PHASE, ALGO_HIERARCHICAL)

KERNEL_SPMD, KERNEL_PALLAS = "spmd", "pallas"
KERNELS = (KERNEL_SPMD, KERNEL_PALLAS)


@dataclasses.dataclass(frozen=True)
class ScheduleStep:
    """One step of the IR: ``op`` ∈ {rs, ar, ag}, the tier whose wire it
    rides, the partition of the ranks it reduces over (None: the whole
    world), and the payload bytes it moves."""

    op: str
    tier: str
    groups: Groups
    payload_bytes: int


@dataclasses.dataclass(frozen=True)
class CollectiveSchedule:
    """A compiled bucket schedule: the algorithm, its steps, the modeled
    cost and the topology it was compiled for, all from static values,
    so it is the same on every rank."""

    algo: str
    steps: Tuple[ScheduleStep, ...]
    nbytes: int
    est_cost_us: float
    topo: MeshTopology
    kernel: str = KERNEL_SPMD

    def tier_bytes(self) -> Dict[str, int]:
        """Wire bytes a tier (exact dtype bytes; :func:`record_plans`
        scales them by the compressor's wire ratio)."""
        out: Dict[str, int] = {}
        for s in self.steps:
            out[s.tier] = out.get(s.tier, 0) + s.payload_bytes
        return out

    def hbm_materializations(self, compression) -> int:
        """The reference's structural count of the buffers its int8 wire
        writes to memory around this schedule's collectives: 2 a
        reduce-scatter or all-gather step, 4 an allreduce, none for the
        intra-pod steps its fused Pallas backend lowers (``kernel ==
        "pallas"``), none on an exact or cast wire.  Kept so the port's
        plan records compare with the reference's; the port runs both
        backends on one wire."""
        if not _is_int8(compression):
            return 0
        total = 0
        for s in self.steps:
            if self.kernel == KERNEL_PALLAS and s.tier == "ici":
                continue
            total += 4 if s.op == "ar" else 2
        return total


def _is_int8(compression) -> bool:
    """Whether ``compression`` is the int8 transport (a compressor class,
    as ``Compression.int8``, or an instance)."""
    from ..ops.compression import Int8Compressor

    if compression is None:
        return False
    if isinstance(compression, type):
        return issubclass(compression, Int8Compressor)
    return isinstance(compression, Int8Compressor)


def choose_algo(nbytes: int, topo: MeshTopology,
                params: TopoCostParams) -> str:
    """The modeled-cost decision: hierarchical when its makespan beats
    flat's on a two-tier mesh; otherwise the flat family, decomposed
    into reduce-scatter + all-gather when the bucket clears the
    two-phase crossover at the flat wire's parameters (α_ici with the
    bottleneck β: the slow tier's on a mesh of several pods)."""
    n = topo.size
    if n <= 1:
        return ALGO_FLAT
    if topo.two_tier and hierarchical_cost_us(nbytes, topo, params) \
            < flat_cost_us(nbytes, topo, params):
        return ALGO_HIERARCHICAL
    beta_eff = (params.dcn.beta_gbps if topo.pods > 1
                else params.ici.beta_gbps)
    crossover_d = params.ici.alpha_us * beta_eff * 1e3 * n
    if crossover_d < 9.2e18 and nbytes >= int(crossover_d):
        return ALGO_TWO_PHASE
    return ALGO_FLAT


def _dispatch_algo(nbytes: int, topo: MeshTopology,
                   params: TopoCostParams) -> str:
    """The planner's dispatch: the native twin of :func:`choose_algo`
    (``hvd_tpu_plan_hierarchical``) when built and
    ``HVD_TPU_USE_NATIVE_PLANNER`` is on, else :func:`choose_algo`; the
    same choice either way."""
    from ..ops.fusion import _use_native_planner

    if _use_native_planner():
        from ..native import planner as _native

        return _native.plan_hierarchical(
            [int(nbytes)], topo.pods, topo.chips_per_pod,
            params.ici.alpha_us, params.ici.beta_gbps,
            params.dcn.alpha_us, params.dcn.beta_gbps)[0]
    return choose_algo(nbytes, topo, params)


def compile_bucket_schedule(nbytes: int, topo: MeshTopology,
                            params: Optional[TopoCostParams] = None, *,
                            force: Optional[str] = None,
                            kernel: str = KERNEL_SPMD,
                            ) -> CollectiveSchedule:
    """Compile one bucket's schedule.  ``force`` pins the algorithm; None
    lets the cost model choose (``auto``).  ``kernel`` is recorded in
    the IR (spmd | pallas)."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    params = params or default_params()
    algo = force if force in ALGOS else _dispatch_algo(nbytes, topo, params)
    if algo == ALGO_HIERARCHICAL and not topo.two_tier:
        algo = ALGO_FLAT   # nothing to make hierarchical on one tier
    flat_tier = "dcn" if topo.pods > 1 else "ici"
    nbytes = int(nbytes)
    if algo == ALGO_HIERARCHICAL:
        intra = tuple(tuple(g) for g in topo.intra_pod_groups())
        cross = tuple(tuple(g) for g in topo.cross_pod_groups())
        frag = nbytes // topo.chips_per_pod
        steps = (
            ScheduleStep("rs", "ici", intra, nbytes),
            ScheduleStep("ar", "dcn", cross, frag),
            ScheduleStep("ag", "ici", intra, nbytes),
        )
        cost = hierarchical_cost_us(nbytes, topo, params)
    elif algo == ALGO_TWO_PHASE:
        steps = (ScheduleStep("rs", flat_tier, None, nbytes),
                 ScheduleStep("ag", flat_tier, None, nbytes))
        cost = flat_cost_us(nbytes, topo, params)
    else:
        steps = (ScheduleStep("ar", flat_tier, None, nbytes),)
        cost = flat_cost_us(nbytes, topo, params)
    return CollectiveSchedule(algo=algo, steps=steps, nbytes=nbytes,
                              est_cost_us=cost, topo=topo, kernel=kernel)


class ScheduleCompiler:
    """A compile cache bound to one (topology, params, force, kernel)
    point: what ``fused_two_phase_apply(schedule=)`` and the overlap
    wire's ``topo=`` take."""

    def __init__(self, topo: MeshTopology,
                 params: Optional[TopoCostParams] = None,
                 force: Optional[str] = None,
                 kernel: str = KERNEL_SPMD) -> None:
        self.topo = topo
        self.params = params or default_params()
        self.force = force
        self.kernel = kernel
        self._cache: Dict[int, CollectiveSchedule] = {}

    def compile(self, nbytes: int) -> CollectiveSchedule:
        nbytes = int(nbytes)
        sched = self._cache.get(nbytes)
        if sched is None:
            sched = self._cache[nbytes] = compile_bucket_schedule(
                nbytes, self.topo, self.params, force=self.force,
                kernel=self.kernel)
        return sched


def maybe_compiler(world_size: int, groups=None,
                   mode: Optional[str] = None,
                   kernel: Optional[str] = None,
                   ) -> Optional[ScheduleCompiler]:
    """The topology gate: a compiler when ``HVD_TPU_TOPO_SCHEDULE`` (or
    an explicit ``mode``) turns it on and the reduction runs over the
    whole world (``groups`` None: a process set keeps the flat wire,
    since the tiers are partitions of the world); None otherwise, and
    the caller runs the flat planner.  ``kernel`` None reads
    ``HVD_TPU_TOPO_KERNEL``.  Pure: it creates no group."""
    if mode is None or kernel is None:
        from .. import basics

        cfg = basics.config() if basics.is_initialized() else None
        if mode is None:
            mode = cfg.topo_schedule if cfg is not None else "off"
        if kernel is None:
            kernel = cfg.topo_kernel if cfg is not None else KERNEL_SPMD
    if mode == "off" or groups is not None or world_size <= 1:
        return None
    topo = config_topology(world_size)
    if topo.size != world_size:
        return None
    force = None if mode == "auto" else mode
    return ScheduleCompiler(topo, estimator().effective_params(),
                            force=force, kernel=kernel)


def record_plans(scheds: Sequence[CollectiveSchedule], compression,
                 itemsize: int,
                 params: Optional[TopoCostParams] = None) -> dict:
    """The plan record of a set of compiled bucket schedules: schedules
    by algorithm and by kernel, wire bytes a tier (scaled by the
    compressor's wire ratio), modeled µs a tier, the structural
    materialization count.  It is published as the ``hvd_tpu_topo_*``
    metrics (:func:`..obs.instrument.on_topo_plan`, once per build of a
    step) and the per-tier bytes go to the estimator
    (:meth:`~.costmodel.OnlineEstimator.note_plan`).  ``params`` must be
    the point the schedules were compiled with.  Returns the record; an
    empty dict for no schedules."""
    from ..ops.fusion import wire_ratio

    scheds = list(scheds)
    if not scheds:
        return {}
    ratio = wire_ratio(compression, max(itemsize, 1))
    params = params or default_params()
    tier_bytes: Dict[str, int] = {}
    tier_cost: Dict[str, float] = {}
    by_algo: Dict[str, int] = {}
    by_kernel: Dict[str, int] = {}
    hbm_mats = 0
    for sched in scheds:
        by_algo[sched.algo] = by_algo.get(sched.algo, 0) + 1
        by_kernel[sched.kernel] = by_kernel.get(sched.kernel, 0) + 1
        hbm_mats += sched.hbm_materializations(compression)
        for t, b in sched.tier_bytes().items():
            tier_bytes[t] = tier_bytes.get(t, 0) + int(b * ratio)
        if sched.algo == ALGO_HIERARCHICAL:
            phase = hierarchical_phase_costs_us(sched.nbytes, sched.topo,
                                                params)
            tier_cost["ici"] = tier_cost.get("ici", 0.0) \
                + phase["rs_intra"] + phase["ag_intra"]
            tier_cost["dcn"] = tier_cost.get("dcn", 0.0) + phase["xpod"]
        else:
            t = "dcn" if sched.topo.pods > 1 else "ici"
            tier_cost[t] = tier_cost.get(t, 0.0) + sched.est_cost_us
    _obs.on_topo_plan(by_algo, tier_bytes=tier_bytes, est_cost_us=tier_cost,
                      kernels=by_kernel, hbm_materializations=hbm_mats)
    estimator().note_plan(tier_bytes)
    return {"algos": by_algo, "kernels": by_kernel,
            "tier_bytes": tier_bytes, "est_cost_us": tier_cost,
            "hbm_materializations": hbm_mats}


# --- execution ---------------------------------------------------------------
# Every stage below is a collective on a torch group: every rank runs the
# same schedule at the same point of its program.

def _stage_span(sched: CollectiveSchedule, i: int, compression):
    """The span of stage ``i`` of a hierarchical schedule (rs_intra,
    xpod, ag_intra) with the reference's args: the stage's bytes and, on
    the intra-pod tier, the lowering backend the reference's rule picks
    (``pallas`` for the int8 wire under ``kernel=pallas``)."""
    step = sched.steps[i]
    args = {"bytes": step.payload_bytes}
    if step.tier == "ici":
        args["kernel"] = (KERNEL_PALLAS if sched.kernel == KERNEL_PALLAS
                          and _is_int8(compression) else KERNEL_SPMD)
    return _trace.span(_STAGE_SPANS[i], args=args)


_STAGE_SPANS = ("hvd_tpu_topo_rs_intra", "hvd_tpu_topo_xpod",
                "hvd_tpu_topo_ag_intra")


def _padded(x: torch.Tensor, n: int) -> torch.Tensor:
    pad = (-x.numel()) % n
    return torch.cat([x, x.new_zeros(pad)]) if pad else x


def _on_dcn_step(stage: str) -> None:
    """The ``dcn`` fault site at the cross-pod exchange (never at the
    intra-pod stages), at the build boundary: on the first call of a
    built step and on every eager call, as the reference fires it while
    the exchange is traced."""
    if _faults._active is not None and _obs.plans_open():
        _faults.on_dcn(stage)


def execute_schedule(x: torch.Tensor, sched: CollectiveSchedule, *,
                     op: str, compression) -> torch.Tensor:
    """Run one compiled schedule over this rank's flat 1-D bucket ``x``:
    allreduce semantics (every rank returns the reduction over the whole
    world), on the compressor's wire.  ``op`` is sum or average.  The
    hierarchical stages reduce with ``op="sum"`` and divide once by the
    world's width at the end, so the result equals the flat wire's
    average bit for bit on exact data.  ``sched.kernel`` lowers to the
    same wire either way (module docstring), so the reference's
    ``kernel=`` override has no port."""
    if op not in ("sum", "average"):
        raise ValueError(
            f"topo schedules support op=sum/average, got {op!r}")
    n = sched.topo.size
    if n <= 1 or sched.algo == ALGO_FLAT:
        return compression.spmd_allreduce(x, op=op, group=None)
    if sched.algo == ALGO_TWO_PHASE:
        shard = compression.spmd_reducescatter(_padded(x, n), op=op,
                                               group=None)
        return compression.spmd_allgather(shard, group=None)[:x.numel()]
    intra, cross = tier_groups(sched.topo)
    with _stage_span(sched, 0, compression):
        frag = compression.spmd_reducescatter(_padded(x, n), op="sum",
                                              group=intra)
    with _stage_span(sched, 1, compression):
        _on_dcn_step("xpod")
        frag = compression.spmd_allreduce(frag, op="sum", group=cross)
    with _stage_span(sched, 2, compression):
        out = compression.spmd_allgather(frag, group=intra)[:x.numel()]
    return out / n if op == "average" else out


def hierarchical_reduce_scatter_start(x: torch.Tensor,
                                      sched: CollectiveSchedule, *,
                                      op: str, compression) -> Handle:
    """Start the reduce-scatter half of the overlap wire: the intra-pod
    reduce-scatter starts now, as async works; the handle's finish step
    runs the cross-pod reduce-scatter of the fragment (and the divide
    for Average).  ``x`` is padded to the world's width already; the
    result is this rank's ``x.numel() / n`` shard, in (chip, pod)-major
    order, a fixed permutation of the flat reduce-scatter's that
    :func:`hierarchical_all_gather` inverts."""
    n = sched.topo.size
    intra, cross = tier_groups(sched.topo)
    with _stage_span(sched, 0, compression):
        rs_intra = compression.spmd_reducescatter_async(x, op="sum",
                                                        group=intra)

    def finish():
        with _stage_span(sched, 1, compression):
            _on_dcn_step("xpod_rs")
            shard = compression.spmd_reducescatter(rs_intra.wait(),
                                                   op="sum", group=cross)
        return shard / n if op == "average" else shard

    return Handle(rs_intra.works, finish)


def hierarchical_reduce_scatter(x: torch.Tensor, sched: CollectiveSchedule,
                                *, op: str, compression) -> torch.Tensor:
    """:func:`hierarchical_reduce_scatter_start`, waited."""
    return hierarchical_reduce_scatter_start(
        x, sched, op=op, compression=compression).wait()


def hierarchical_all_gather_start(shard: torch.Tensor,
                                  sched: CollectiveSchedule, *,
                                  compression) -> Handle:
    """Start the all-gather half: the cross-pod gather that rebuilds the
    fragment starts now; the handle's finish step runs the intra-pod
    all-gather that rebuilds the whole padded buffer, the exact inverse
    of :func:`hierarchical_reduce_scatter`'s permutation."""
    intra, cross = tier_groups(sched.topo)
    with _stage_span(sched, 1, compression):
        _on_dcn_step("xpod_ag")
        ag_cross = compression.spmd_allgather_async(shard, group=cross)

    def finish():
        frag = ag_cross.wait()
        with _stage_span(sched, 2, compression):
            return compression.spmd_allgather(frag, group=intra)

    return Handle(ag_cross.works, finish)


def hierarchical_all_gather(shard: torch.Tensor, sched: CollectiveSchedule,
                            *, compression) -> torch.Tensor:
    """:func:`hierarchical_all_gather_start`, waited."""
    return hierarchical_all_gather_start(
        shard, sched, compression=compression).wait()
