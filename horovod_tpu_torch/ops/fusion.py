"""Tensor fusion: bucket many small tensors into few large collectives.

Counterpart of ``horovod_tpu/ops/fusion.py``.  The flat path: leaves
are grouped by dtype, bucketed greedily in order up to ``threshold``
bytes (:func:`plan_buckets`), each bucket is concatenated into one flat
tensor, reduced with one collective, and split back.

A pytree here is a flat mapping from dotted parameter names to tensors
(``block_0.attn.qkv.kernel``).  :func:`tree_flatten` orders it as
``jax.tree.flatten`` orders the reference's nested dicts, sorting the
keys at every level.  The order matters: the int8 wire quantizes blocks
that span leaf boundaries inside a bucket, so another order would
quantize other elements together.

Two-phase buckets (:func:`fused_two_phase_apply`): an α–β cost model
(per-collective launch latency α, per-hop bandwidth β) decides which
buckets are bandwidth-bound; those decompose into reduce-scatter →
all-gather, and up to ``pipeline_depth`` reduce-scatters are in flight
as async works before the oldest bucket's all-gather starts
(:func:`plan_pipeline_order`).  The overlap wire of the microbatch step
(:func:`plan_overlap_buckets`, :func:`overlap_reduce_scatter`,
:func:`overlap_all_gather`) reduce-scatters each microbatch's gradients
while the next one's backward runs and all-gathers once at the update.
Every plan is pure bookkeeping on sizes, so every rank computes the same
one and issues the same collectives in the same order.

The two-tier topology compiler (:mod:`..topo.schedule`) plugs in as
``fused_two_phase_apply(schedule=)``, ``fused_allreduce_pytree(
topo_schedule=)`` (resolved from ``HVD_TPU_TOPO_SCHEDULE`` when None)
and the overlap wire's ``topo=``: per bucket, flat, two-phase, or
hierarchical (reduce-scatter inside the node, exchange between nodes,
all-gather inside the node).  The bucket and two-phase planners ask the
native C++ planner first (``native/planner.py``), under
``HVD_TPU_USE_NATIVE_PLANNER`` (on by default); their Python twins give
the same plans bit for bit and run when the knob is off or the library
is not built.

Each plan is recorded (:func:`..obs.instrument.on_fusion_plan`, tiers
``spmd``, ``two_phase``, ``overlap`` and ``schedule``, the reference's
labels): once per build inside a step, every call outside one.
"""

from __future__ import annotations

import dataclasses
from typing import (Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import torch
import torch.distributed as dist

from .. import faults as _faults
from ..config import DEFAULT_COST_ALPHA_US, DEFAULT_COST_BETA_GBPS
from ..obs import instrument as _obs
from .collectives import Handle
from .compression import Compression

DEFAULT_THRESHOLD = 64 * 1024 * 1024


def wire_ratio(compression, data_itemsize: int) -> float:
    """Wire bytes / exact bytes for a compression tier, from the
    compressor's own declaration (``wire_dtype`` on the cast tiers,
    ``wire_itemsize`` on the int8 tier, whose per-block scales are
    ignored here)."""
    if compression is None:
        return 1.0
    wd = getattr(compression, "wire_dtype", None)
    if wd is not None:
        return wd.itemsize / max(1, data_itemsize)
    wi = getattr(compression, "wire_itemsize", None)
    if wi is not None:
        return float(wi) / max(1, data_itemsize)
    return 1.0


def plan_buckets_py(sizes_bytes: Sequence[int],
                    threshold: int) -> List[List[int]]:
    """Greedy in-order bin packing of byte sizes into buckets of at most
    ``threshold`` bytes (an oversized tensor gets a bucket of its own)."""
    buckets: List[List[int]] = []
    current: List[int] = []
    current_bytes = 0
    for i, sz in enumerate(sizes_bytes):
        if current and current_bytes + sz > threshold:
            buckets.append(current)
            current, current_bytes = [], 0
        current.append(i)
        current_bytes += sz
    if current:
        buckets.append(current)
    return buckets


def _use_native_planner() -> bool:
    """``HVD_TPU_USE_NATIVE_PLANNER`` (on before ``init``) and the native
    library built."""
    from .. import basics

    if basics.is_initialized() and not basics.config().use_native_planner:
        return False
    from ..native import planner as _native

    return _native.available()


def plan_buckets(sizes_bytes: Sequence[int],
                 threshold: int) -> List[List[int]]:
    """The bucket plan (reference: ``plan_buckets``): the native planner
    when built and not disabled, else :func:`plan_buckets_py`, the same
    contract."""
    if _use_native_planner():
        from ..native import planner as _native

        return _native.plan_buckets(list(sizes_bytes), threshold)
    return plan_buckets_py(sizes_bytes, threshold)


# --- α–β cost model + schedule planning --------------------------------------

def phase_cost_us(nbytes: int, n: int, alpha_us: float,
                  beta_gbps: float) -> float:
    """Modeled wall time of ONE phase (reduce-scatter or all-gather) of a
    ring collective over ``n`` participants: ``(n-1)`` hops of launch
    latency α plus shard transfer at bandwidth β."""
    if n <= 1:
        return 0.0
    beta_bytes_per_us = beta_gbps * 1e3  # GB/s == 10^9 B/s == 10^3 B/µs
    return (n - 1) * (alpha_us + (nbytes / n) / beta_bytes_per_us)


def allreduce_cost_us(nbytes: int, n: int, alpha_us: float,
                      beta_gbps: float) -> float:
    """Modeled wall time of a monolithic ring allreduce: ``2(n-1)``
    hops."""
    return 2.0 * phase_cost_us(nbytes, n, alpha_us, beta_gbps)


def two_phase_crossover_bytes(n: int, alpha_us: float,
                              beta_gbps: float) -> int:
    """Bucket payload above which phase decomposition pays: the per-hop
    shard transfer ``bytes/(n·β)`` is at least the extra launch α."""
    if n <= 1:
        return 1 << 62  # nothing to decompose in a world of one
    return int(alpha_us * beta_gbps * 1e3 * n)


def plan_two_phase_flags(bucket_bytes: Sequence[int], n: int,
                         alpha_us: float, beta_gbps: float) -> List[bool]:
    """Per-bucket phase decision from the α–β model (True = decompose
    into reduce-scatter + all-gather)."""
    crossover = two_phase_crossover_bytes(n, alpha_us, beta_gbps)
    return [b >= crossover for b in bucket_bytes]


def _dispatch_two_phase_flags(payloads: Sequence[int], world_size: int,
                              alpha_us: float,
                              beta_gbps: float) -> List[bool]:
    """Same contract as :func:`plan_two_phase_flags`; asks the native
    planner first (mirroring :func:`plan_buckets`' dispatch)."""
    if _use_native_planner():
        from ..native import planner as _native

        return _native.plan_two_phase_flags(list(payloads), world_size,
                                            alpha_us, beta_gbps)
    return plan_two_phase_flags(payloads, world_size, alpha_us, beta_gbps)


def plan_overlap_priority(bucket_bytes: Sequence[int], world_size: int,
                          alpha_us: float, beta_gbps: float) -> List[int]:
    """Bucket emission order that maximizes hidden communication:
    descending modeled wire cost (stable on ties), so the most expensive
    collective starts first."""
    costs = [phase_cost_us(b, world_size, alpha_us, beta_gbps)
             for b in bucket_bytes]
    return sorted(range(len(bucket_bytes)), key=lambda i: (-costs[i], i))


def plan_pipeline_order(two_phase_flags: Sequence[bool],
                        pipeline_depth: int,
                        priority: Optional[Sequence[float]] = None,
                        ) -> List[Tuple[str, int]]:
    """Software-pipelined emission order over buckets: ``("rs", i)`` /
    ``("ag", i)`` for decomposed buckets, ``("ar", i)`` for single-phase
    ones.  At most ``pipeline_depth`` reduce-scatters are in flight
    before the oldest bucket's all-gather is emitted; depth 1 is strictly
    sequential rs/ag pairs.  ``priority`` reorders emission by
    descending priority, keeping the rs-before-ag and in-flight bounds.
    Deterministic in its inputs: every rank issues the same order."""
    depth = max(1, int(pipeline_depth))
    idxs: Sequence[int] = range(len(two_phase_flags))
    if priority is not None:
        if len(priority) != len(two_phase_flags):
            raise ValueError(
                f"priority has {len(priority)} entries for "
                f"{len(two_phase_flags)} buckets")
        idxs = sorted(idxs, key=lambda i: (-priority[i], i))
    order: List[Tuple[str, int]] = []
    inflight: List[int] = []
    for i in idxs:
        if two_phase_flags[i]:
            order.append(("rs", i))
            inflight.append(i)
            if len(inflight) >= depth:
                order.append(("ag", inflight.pop(0)))
        else:
            order.append(("ar", i))
    while inflight:
        order.append(("ag", inflight.pop(0)))
    return order


@dataclasses.dataclass(frozen=True)
class BucketSchedule:
    """A complete fusion plan: bucket membership, per-bucket phase
    decision, interleaved emission order, and the modeled makespan.
    ``est_hidden_us`` is the wire time the overlap term expects to hide
    under concurrent compute (0.0 when no compute estimate was given)."""

    buckets: Tuple[Tuple[int, ...], ...]
    two_phase: Tuple[bool, ...]
    order: Tuple[Tuple[str, int], ...]
    est_cost_us: float
    est_hidden_us: float = 0.0


def estimate_schedule_cost_us(bucket_bytes: Sequence[int],
                              two_phase_flags: Sequence[bool], n: int,
                              alpha_us: float, beta_gbps: float) -> float:
    """Modeled makespan of a pipelined schedule: single-phase buckets
    serialize; decomposed buckets overlap bucket *i*'s all-gather with
    bucket *i+1*'s reduce-scatter."""
    total = 0.0
    prev_ag = 0.0
    for nbytes, tp in zip(bucket_bytes, two_phase_flags):
        if not tp:
            total += prev_ag + allreduce_cost_us(nbytes, n, alpha_us,
                                                 beta_gbps)
            prev_ag = 0.0
            continue
        rs = phase_cost_us(nbytes, n, alpha_us, beta_gbps)
        total += max(rs, prev_ag)   # this RS hides behind the prior AG
        prev_ag = rs                # AG cost == RS cost in the α–β model
    return total + prev_ag


def plan_bucket_schedule(sizes_bytes: Sequence[int], threshold: int, *,
                         world_size: int,
                         alpha_us: float = DEFAULT_COST_ALPHA_US,
                         beta_gbps: float = DEFAULT_COST_BETA_GBPS,
                         two_phase: bool = True,
                         pipeline_depth: int = 2,
                         compute_us: Optional[float] = None,
                         ) -> BucketSchedule:
    """The whole plan for one dtype class: greedy byte-bounded buckets,
    α–β phase decisions and the pipelined emission order.  With
    ``compute_us`` (the modeled concurrent compute) buckets are emitted
    in descending wire cost (:func:`plan_overlap_priority`) and
    ``est_hidden_us`` reports how much of the makespan that hides."""
    buckets = plan_buckets(sizes_bytes, threshold)
    payloads = [sum(sizes_bytes[i] for i in b) for b in buckets]
    if two_phase and world_size > 1:
        flags = _dispatch_two_phase_flags(payloads, world_size, alpha_us,
                                          beta_gbps)
    else:
        flags = [False] * len(buckets)
    priority = None
    hidden = 0.0
    cost = estimate_schedule_cost_us(payloads, flags, world_size, alpha_us,
                                     beta_gbps)
    if compute_us is not None and world_size > 1:
        # plan_overlap_priority's index order, rank-encoded as priorities.
        order_idx = plan_overlap_priority(payloads, world_size, alpha_us,
                                          beta_gbps)
        priority = [0.0] * len(payloads)
        for rank, bi in enumerate(order_idx):
            priority[bi] = float(len(payloads) - rank)
        hidden = min(float(compute_us), cost)
    order = plan_pipeline_order(flags, pipeline_depth, priority)
    if compute_us is not None and _obs.recording_plans():
        # The overlap-aware plan is where the hidden-communication
        # estimate operators scrape (hvd_tpu_est_hidden_us) comes from.
        _obs.on_fusion_plan(
            "schedule", bytes_on_wire=sum(payloads), buckets=len(buckets),
            est_cost_us=cost, est_hidden_us=hidden)
    return BucketSchedule(
        buckets=tuple(tuple(b) for b in buckets),
        two_phase=tuple(flags),
        order=tuple(order),
        est_cost_us=cost,
        est_hidden_us=hidden,
    )


def estimate_overlap_hidden_fraction(
        sizes_bytes: Sequence[int], threshold: int, *, world_size: int,
        microbatches: int, compute_us_per_microbatch: float,
        alpha_us: float = DEFAULT_COST_ALPHA_US,
        beta_gbps: float = DEFAULT_COST_BETA_GBPS) -> dict:
    """Modeled hidden-communication fraction of the overlap wire: each
    of ``microbatches`` microbatches pays one bucketed reduce-scatter
    pass, ``microbatches − 1`` of them under the next microbatch's
    backward (up to ``compute_us_per_microbatch`` each); the last pass
    and the one deferred all-gather stay exposed.  Returns
    ``{"wire_us", "hidden_us", "hidden_frac"}`` (all 0 in a world of
    one)."""
    mb = max(1, int(microbatches))
    buckets = plan_buckets(sizes_bytes, threshold)
    payloads = [sum(sizes_bytes[i] for i in b) for b in buckets]
    rs_us = sum(phase_cost_us(p, world_size, alpha_us, beta_gbps)
                for p in payloads)
    ag_us = rs_us  # AG cost == RS cost in the α–β model
    wire_us = mb * rs_us + ag_us
    hidden_us = (mb - 1) * min(max(0.0, float(compute_us_per_microbatch)),
                               rs_us)
    return {
        "wire_us": wire_us,
        "hidden_us": hidden_us,
        "hidden_frac": (hidden_us / wire_us) if wire_us > 0 else 0.0,
    }


def tree_flatten(tree: Mapping[str, torch.Tensor],
                 ) -> Tuple[List[str], List[torch.Tensor]]:
    """(names, leaves) in the reference's flatten order: keys sorted at
    every level of the dotted path."""
    names = sorted(tree, key=lambda name: name.split("."))
    return names, [tree[n] for n in names]


def plan_fused_buckets(leaves: Sequence[torch.Tensor],
                       threshold: int) -> List[List[int]]:
    """The fusion plan of ``leaves``: per dtype (in order of first
    appearance), their indices bucketed greedily in order by bytes."""
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault(leaf.dtype, []).append(i)
    plan = []
    for dtype, idxs in by_dtype.items():
        sizes = [leaves[i].numel() * dtype.itemsize for i in idxs]
        plan += [[idxs[j] for j in bucket]
                 for bucket in plan_buckets(sizes, threshold)]
    return plan


def fused_apply(leaves: Sequence[torch.Tensor],
                collective_1d: Callable[[torch.Tensor], torch.Tensor],
                threshold: int) -> List[torch.Tensor]:
    """Apply ``collective_1d`` to ``leaves`` with fusion
    (:func:`plan_fused_buckets`): concatenate each bucket, reduce it
    once, split it back to each leaf's shape."""
    out: List[torch.Tensor] = [None] * len(leaves)  # type: ignore[list-item]
    for members in plan_fused_buckets(leaves, threshold):
        flats = [leaves[i].reshape(-1) for i in members]
        fused = torch.cat(flats) if len(flats) > 1 else flats[0]
        _split_back(collective_1d(fused), members, leaves, out)
    return out


def _nbytes(leaves: Sequence[torch.Tensor], members: Sequence[int]) -> int:
    return sum(leaves[i].numel() * leaves[i].dtype.itemsize for i in members)


def _uniform_group_width(group) -> int:
    """Participant count of the reduction over ``group`` (the reference
    returns None for ragged replica groups; a torch group is one set, so
    its width is always uniform)."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _split_back(flat: torch.Tensor, members: Sequence[int],
                leaves: Sequence[torch.Tensor], out: List) -> None:
    """Cut a bucket's flat result back into its members' shapes."""
    pieces = torch.split(flat, [leaves[i].numel() for i in members])
    for i, piece in zip(members, pieces):
        out[i] = piece.reshape(leaves[i].shape)


def fused_two_phase_apply(
        leaves: Sequence[torch.Tensor], *, op: str, group=None,
        compression=None, threshold: int = DEFAULT_THRESHOLD,
        pipeline_depth: int = 2, alpha_us: float = DEFAULT_COST_ALPHA_US,
        beta_gbps: float = DEFAULT_COST_BETA_GBPS,
        prescale_factor: float = 1.0, postscale_factor: float = 1.0,
        schedule=None) -> List[torch.Tensor]:
    """Schedule-aware fused allreduce over ``group``: buckets whose
    payload clears the α–β crossover (:func:`plan_two_phase_flags`)
    decompose into reduce-scatter → all-gather on the compressor's wire,
    emitted in :func:`plan_pipeline_order`'s order: each reduce-scatter
    starts as an async work, and an all-gather first waits its own
    bucket's reduce-scatter, so up to ``pipeline_depth`` of them are in
    flight.  The other buckets stay single allreduces.  The same
    reduction as the single-phase path, on the same wire.

    ``schedule`` (a :class:`..topo.schedule.ScheduleCompiler`) compiles
    every bucket instead: only its ``two_phase`` buckets join the
    pipelined order, and its ``flat`` and ``hierarchical`` buckets are
    single ``"ar"`` entries run by
    :func:`..topo.schedule.execute_schedule`.  A process set
    (``group``), or a compiler for another width than the group's, keeps
    the flat planner: the tiers are partitions of the whole world."""
    # The fusion fault site, at the build boundary (the reference fires
    # it while the fused program is traced).
    if _faults._active is not None and _obs.plans_open():
        _faults.on_fusion("two_phase_apply")
    compression = compression or Compression.none
    n = _uniform_group_width(group)
    # One bucket list across dtype classes: the pipeline is about wire
    # occupancy, which does not care about element type.
    packed: List[dict] = []
    for members in plan_fused_buckets(leaves, threshold):
        flats = [leaves[i].reshape(-1) for i in members]
        fused = torch.cat(flats) if len(flats) > 1 else flats[0]
        if prescale_factor != 1.0:
            fused = fused * prescale_factor
        packed.append({"members": members, "fused": fused,
                       "bytes": _nbytes(leaves, members)})
    scheds: Dict[int, object] = {}
    if (schedule is not None and group is None and n > 1
            and schedule.topo.size == n):
        from ..topo import schedule as topo_schedule

        scheds = {bi: schedule.compile(b["bytes"])
                  for bi, b in enumerate(packed)}
        flags = [scheds[bi].algo == topo_schedule.ALGO_TWO_PHASE
                 for bi in range(len(packed))]
        if leaves:
            topo_schedule.record_plans(scheds.values(), compression,
                                       leaves[0].dtype.itemsize,
                                       params=schedule.params)
        if any(s.algo == topo_schedule.ALGO_HIERARCHICAL
               for s in scheds.values()):
            from ..topo.topology import tier_groups

            tier_groups(schedule.topo)  # collective on first use: now
    elif n <= 1:
        flags = [False] * len(packed)
    else:
        flags = _dispatch_two_phase_flags([b["bytes"] for b in packed], n,
                                          alpha_us, beta_gbps)
    if packed and _obs.recording_plans():
        # The plan record: every step replays exactly these collectives.
        exact = sum(b["bytes"] for b in packed)
        ratio = wire_ratio(compression, max(leaves[0].dtype.itemsize, 1))
        _obs.on_fusion_plan(
            "two_phase", bytes_on_wire=int(exact * ratio),
            buckets=len(packed), compression_ratio=ratio,
            est_cost_us=estimate_schedule_cost_us(
                [b["bytes"] for b in packed], flags, n, alpha_us,
                beta_gbps))
    scattering: Dict[int, Handle] = {}
    gathering: Dict[int, Handle] = {}
    reduced: Dict[int, torch.Tensor] = {}
    for kind, bi in plan_pipeline_order(flags, pipeline_depth):
        x = packed[bi]["fused"]
        if kind == "ar" and bi in scheds:
            from ..topo.schedule import execute_schedule

            reduced[bi] = execute_schedule(x, scheds[bi], op=op,
                                           compression=compression)
        elif kind == "ar":
            reduced[bi] = compression.spmd_allreduce(x, op=op, group=group)
        elif kind == "rs":
            pad = (-x.numel()) % n
            if pad:
                x = torch.cat([x, x.new_zeros(pad)])
            scattering[bi] = compression.spmd_reducescatter_async(
                x, op=op, group=group)
        else:  # "ag"
            gathering[bi] = compression.spmd_allgather_async(
                scattering.pop(bi).wait(), group=group)
    for bi, h in gathering.items():
        reduced[bi] = h.wait()[:packed[bi]["fused"].numel()]
    out: List[torch.Tensor] = [None] * len(leaves)  # type: ignore[list-item]
    for bi, b in enumerate(packed):
        r = reduced[bi]
        if postscale_factor != 1.0:
            r = r * postscale_factor
        _split_back(r, b["members"], leaves, out)
    return out


# --- overlap-scheduled microbatch wire ---------------------------------------
# The gradient wire of make_train_step(microbatches > 1): each
# microbatch's gradients ride one bucketed reduce-scatter pass, started
# before the NEXT microbatch's backward runs; the shards accumulate
# across microbatches, and ONE all-gather at the update rebuilds the
# full averaged gradient.

@dataclasses.dataclass(frozen=True)
class OverlapBucketPlan:
    """Plan of the overlap wire, made once from the first microbatch's
    gradient shapes, so every reduce-scatter and the all-gather agree on
    the layout.  ``order`` is the reduce-scatter emission order
    (descending modeled wire cost, :func:`plan_overlap_priority`)."""

    members: Tuple[Tuple[int, ...], ...]    # leaf indices per bucket
    cols: Tuple[Tuple[int, ...], ...]       # flat elems per member
    payload: Tuple[int, ...]                # bucket elems before padding
    pad: Tuple[int, ...]                    # zero elems appended per bucket
    shard_elems: Tuple[int, ...]            # (payload+pad)/n per bucket
    dtypes: Tuple[torch.dtype, ...]         # bucket dtype
    order: Tuple[int, ...]                  # RS emission order
    n: int                                  # reduction-group width


def plan_overlap_buckets(leaves: Sequence[torch.Tensor], threshold: int, *,
                         world_size: int,
                         alpha_us: float = DEFAULT_COST_ALPHA_US,
                         beta_gbps: float = DEFAULT_COST_BETA_GBPS,
                         ) -> OverlapBucketPlan:
    """Bucket gradient leaves for the overlap wire: greedy byte-bounded
    buckets per dtype class, padded to the group width, emitted in
    descending wire cost."""
    n = max(1, int(world_size))
    members = [tuple(m) for m in plan_fused_buckets(leaves, threshold)]
    cols = [tuple(leaves[i].numel() for i in m) for m in members]
    payload = [sum(c) for c in cols]
    pad = [(-p) % n for p in payload]
    dtypes = [leaves[m[0]].dtype for m in members]
    order = plan_overlap_priority([_nbytes(leaves, m) for m in members], n,
                                  alpha_us, beta_gbps)
    return OverlapBucketPlan(
        members=tuple(members), cols=tuple(cols), payload=tuple(payload),
        pad=tuple(pad),
        shard_elems=tuple((p + q) // n for p, q in zip(payload, pad)),
        dtypes=tuple(dtypes), order=tuple(order), n=n)


def zero_overlap_shards(plan: OverlapBucketPlan,
                        device=None) -> Tuple[torch.Tensor, ...]:
    """Zero per-bucket shard accumulators on ``device`` (the carry of the
    microbatch loop)."""
    return tuple(torch.zeros(e, dtype=dt, device=device)
                 for e, dt in zip(plan.shard_elems, plan.dtypes))


def _overlap_bucket_schedule(plan: OverlapBucketPlan, bi: int, topo):
    """The compiled schedule of overlap bucket ``bi``, or None for the
    flat wire: only ``hierarchical`` buckets leave it.  The compile is
    keyed on the bucket's exact payload bytes, the coordinate the fused
    paths use, so a bucket's choice is the same everywhere."""
    if topo is None or topo.topo.size != plan.n:
        return None
    nbytes = plan.payload[bi] * plan.dtypes[bi].itemsize
    sched = topo.compile(int(nbytes))
    return sched if sched.algo == "hierarchical" else None


def _hierarchical_buckets(plan: OverlapBucketPlan, topo) -> Dict[int, object]:
    """``{bucket: schedule}`` of the overlap buckets ``topo`` lowers
    hierarchically; the tiers' groups exist once this returns."""
    scheds = {bi: s for bi in range(len(plan.members))
              if (s := _overlap_bucket_schedule(plan, bi, topo)) is not None}
    if scheds:
        from ..topo.topology import tier_groups

        tier_groups(topo.topo)   # collective on first use, before any work
    return scheds


def overlap_reduce_scatter(leaves: Sequence[torch.Tensor],
                           plan: OverlapBucketPlan, *, op: str, group=None,
                           compression=None, topo=None) -> Handle:
    """Start one bucketed reduce-scatter pass over ``leaves`` (one
    microbatch's gradients): each bucket is flattened, padded to the
    group width and reduce-scattered on the compressor's wire as an async
    work, in ``plan.order``.  The handle's result is the tuple of
    per-bucket shards in bucket-index order.

    ``topo`` (a :class:`..topo.schedule.ScheduleCompiler`) lowers the
    buckets it marks hierarchical through the intra-node reduce-scatter
    (started now) and the cross-node one (at the wait): their shards
    come back permuted, the same size, and :func:`overlap_all_gather`
    with the same compiler inverts the permutation."""
    from ..topo.schedule import hierarchical_reduce_scatter_start

    compression = compression or Compression.none
    hier = _hierarchical_buckets(plan, topo)
    started: Dict[int, Handle] = {}
    for bi in plan.order:
        flats = [leaves[i].reshape(-1) for i in plan.members[bi]]
        fused = torch.cat(flats) if len(flats) > 1 else flats[0]
        if plan.pad[bi]:
            fused = torch.cat([fused, fused.new_zeros(plan.pad[bi])])
        if bi in hier:
            started[bi] = hierarchical_reduce_scatter_start(
                fused, hier[bi], op=op, compression=compression)
        else:
            started[bi] = compression.spmd_reducescatter_async(
                fused, op=op, group=group)
    handles = [started[bi] for bi in range(len(plan.members))]
    return Handle([w for h in handles for w in h.works],
                  lambda: tuple(h.wait() for h in handles))


def overlap_all_gather(shards: Sequence[torch.Tensor],
                       plan: OverlapBucketPlan,
                       leaves_like: Sequence[torch.Tensor], *, group=None,
                       compression=None, topo=None) -> List[torch.Tensor]:
    """The deferred all-gather at the update: gather every bucket's
    accumulated shard on the compressor's wire (all started, then
    waited), drop the padding and unpack to ``leaves_like``'s shapes and
    dtypes.  ``topo`` must be the compiler the shards' reduce-scatters
    ran with: its hierarchical buckets gather across nodes, then inside
    the node."""
    from ..topo.schedule import hierarchical_all_gather_start

    compression = compression or Compression.none
    hier = _hierarchical_buckets(plan, topo)
    handles = [hierarchical_all_gather_start(shard, hier[bi],
                                             compression=compression)
               if bi in hier else
               compression.spmd_allgather_async(shard, group=group)
               for bi, shard in enumerate(shards)]
    out: List[torch.Tensor] = [None] * len(leaves_like)  # type: ignore
    for bi, h in enumerate(handles):
        full = h.wait()[:plan.payload[bi]]
        _split_back(full, plan.members[bi], leaves_like, out)
    return [o.to(like.dtype) for o, like in zip(out, leaves_like)]


def fused_allreduce_pytree(tree: Mapping[str, torch.Tensor], *,
                           op: str = "average",
                           threshold: int = DEFAULT_THRESHOLD,
                           group=None, compression=None,
                           prescale_factor: float = 1.0,
                           postscale_factor: float = 1.0,
                           two_phase: Optional[bool] = None,
                           pipeline_depth: Optional[int] = None,
                           topo_schedule=None,
                           ) -> Dict[str, torch.Tensor]:
    """Fused allreduce of every leaf of ``tree`` (the gradient hot
    path), in :func:`tree_flatten` order: returns a new mapping with the
    same names.  ``two_phase`` and ``pipeline_depth`` default to the live
    config (``HVD_TPU_TWO_PHASE_ALLREDUCE``, ``HVD_TPU_PIPELINE_DEPTH``,
    with the cost knobs ``HVD_TPU_COST_ALPHA_US`` and
    ``HVD_TPU_COST_BETA_GBPS``); when on, the buckets ride
    :func:`fused_two_phase_apply`.

    ``topo_schedule`` (a :class:`..topo.schedule.ScheduleCompiler`, or
    None to resolve ``HVD_TPU_TOPO_SCHEDULE`` through
    :func:`..topo.schedule.maybe_compiler`) lowers each bucket through
    the two-tier compiler: flat, two-phase or hierarchical, by the
    per-tier cost model.  Whenever there is a compiler the buckets ride
    :func:`fused_two_phase_apply` with it."""
    from .. import basics

    compression = compression or Compression.none
    names, leaves = tree_flatten(tree)
    alpha_us, beta_gbps = DEFAULT_COST_ALPHA_US, DEFAULT_COST_BETA_GBPS
    if basics.is_initialized():
        cfg = basics.config()
        if two_phase is None:
            two_phase = cfg.two_phase_allreduce
        if pipeline_depth is None:
            pipeline_depth = cfg.pipeline_depth
        alpha_us, beta_gbps = cfg.cost_alpha_us, cfg.cost_beta_gbps
    compiler = topo_schedule
    if compiler is None and op in ("sum", "average") and leaves:
        from ..topo.schedule import maybe_compiler

        compiler = maybe_compiler(_uniform_group_width(group), groups=group)
    if two_phase or compiler is not None:
        reduced = fused_two_phase_apply(
            leaves, op=op, group=group, compression=compression,
            threshold=threshold, pipeline_depth=int(pipeline_depth or 2),
            alpha_us=alpha_us, beta_gbps=beta_gbps,
            prescale_factor=prescale_factor,
            postscale_factor=postscale_factor, schedule=compiler)
        return dict(zip(names, reduced))

    if leaves and _obs.recording_plans():
        ratio = wire_ratio(compression, max(leaves[0].dtype.itemsize, 1))
        _obs.on_fusion_plan(
            "spmd", bytes_on_wire=int(_nbytes(leaves, range(len(leaves)))
                                      * ratio),
            buckets=len(plan_fused_buckets(leaves, threshold)),
            compression_ratio=ratio)

    def collective(flat: torch.Tensor) -> torch.Tensor:
        x = flat
        if prescale_factor != 1.0:
            x = x * prescale_factor
        x = compression.spmd_allreduce(x, op=op, group=group)
        if postscale_factor != 1.0:
            x = x * postscale_factor
        return x

    return dict(zip(names, fused_apply(leaves, collective, threshold)))
