"""Declarative two-tier mesh description (pods × chips-per-pod).

Counterpart of ``horovod_tpu/topo/topology.py``.  The reference stack
finds its topology implicitly (NCCL rings within a node, MPI across
nodes, glued by ``HOROVOD_HIERARCHICAL_ALLREDUCE``); here the topology
is a value, a :class:`MeshTopology`, declared by
``HVD_TPU_TOPO_SPEC=PODSxCHIPS`` or inferred from the node layout, and
read by the cost model and the schedule compiler.  In the port a pod is
a node (NVLink inside it, the network between nodes) and a chip is a
rank of it.  Pods are contiguous ranges of ranks: rank ``r`` lives in
pod ``r // chips_per_pod`` at chip ``r % chips_per_pod``, the layout
torchrun gives.

The tiers are partitions of the ranks: the intra-pod tier has ``pods``
groups of ``chips_per_pod`` ranks, the cross-pod tier ``chips_per_pod``
groups of ``pods`` ranks, one per chip index, so each cross-pod
collective moves only the fragment that chip owns between nodes.  Each
group becomes a ``torch.distributed`` group (:func:`tier_groups`), which
every rank must create, in one order: creating them is collective.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional, Sequence, Tuple

import torch.distributed as dist

from ..config import parse_topo_spec

logger = logging.getLogger(__name__)
_warned_specs: set = set()   # (spec, world size) already warned about


@dataclasses.dataclass(frozen=True)
class MeshTopology:
    """A two-tier mesh: ``pods`` × ``chips_per_pod`` ranks, pods laid out
    contiguously in rank order.  ``pods == 1`` is the flat (one-tier)
    degenerate that every one-node job resolves to."""

    pods: int
    chips_per_pod: int

    def __post_init__(self) -> None:
        if self.pods < 1 or self.chips_per_pod < 1:
            raise ValueError(
                f"MeshTopology factors must be >= 1, got "
                f"{self.pods}x{self.chips_per_pod}")

    @property
    def size(self) -> int:
        return self.pods * self.chips_per_pod

    @property
    def two_tier(self) -> bool:
        """Does a hierarchical schedule exist on this mesh?  Both tiers
        must be non-trivial."""
        return self.pods > 1 and self.chips_per_pod > 1

    def pod_of(self, rank: int) -> int:
        return rank // self.chips_per_pod

    def chip_of(self, rank: int) -> int:
        return rank % self.chips_per_pod

    def intra_pod_groups(self) -> List[List[int]]:
        """The intra-node tier: one group per pod, a partition of the
        ranks."""
        c = self.chips_per_pod
        return [list(range(p * c, (p + 1) * c)) for p in range(self.pods)]

    def cross_pod_groups(self) -> List[List[int]]:
        """The inter-node tier: one group per chip index.  Rank ``p·C +
        c`` talks to its peers at chip ``c`` in every other pod, so each
        group's collective carries only that chip's fragment."""
        c = self.chips_per_pod
        return [[p * c + i for p in range(self.pods)] for i in range(c)]

    def describe(self) -> str:
        return f"{self.pods}x{self.chips_per_pod}"


def _node_of_each_rank() -> Optional[List[int]]:
    """Each rank's node, in rank order, from the session's node layout
    (``basics.local_size()`` ranks a node, ``basics.cross_size()``
    nodes, torchrun's node-major ranks), or None when the nodes do not
    all run ``local_size()`` ranks: the layout is then unknown."""
    from .. import basics

    n, local = basics.size(), basics.local_size()
    if local < 1 or local * basics.cross_size() != n:
        return None
    return [r // local for r in range(n)]


def infer_topology(nodes: Optional[Sequence[int]] = None) -> MeshTopology:
    """Infer the two tiers from ``nodes``, each rank's node in rank order
    (default: the session's node layout, one pod a node).  Runs of equal
    node ids must be contiguous and of one length above 1 to be a
    topology; anything else falls back to the flat 1×N degenerate."""
    if nodes is None:
        from .. import basics

        nodes = _node_of_each_rank()
        if nodes is None:
            return MeshTopology(pods=1, chips_per_pod=basics.size())
    nodes = [int(s) for s in nodes]
    n = len(nodes)
    if n <= 1:
        return MeshTopology(pods=1, chips_per_pod=max(1, n))
    runs: List[Tuple[int, int]] = []   # (node id, run length)
    for s in nodes:
        if runs and runs[-1][0] == s:
            runs[-1] = (s, runs[-1][1] + 1)
        else:
            runs.append((s, 1))
    lengths = {length for _, length in runs}
    ids = [s for s, _ in runs]
    if (len(runs) > 1 and len(lengths) == 1 and len(set(ids)) == len(ids)
            and next(iter(lengths)) > 1):
        return MeshTopology(pods=len(runs), chips_per_pod=runs[0][1])
    return MeshTopology(pods=1, chips_per_pod=n)


def resolve_topology(world_size: int,
                     spec: Optional[str] = None) -> MeshTopology:
    """The topology of a ``world_size``-rank reduction: a declared spec
    wins (it must factor the world: a spec that does not is a deployment
    error, not something to guess around), then inference, then flat."""
    if spec:
        pods, chips = parse_topo_spec(spec)
        if pods * chips != world_size:
            raise ValueError(
                f"topo spec {spec!r} declares {pods * chips} slots but "
                f"the mesh has {world_size}")
        return MeshTopology(pods=pods, chips_per_pod=chips)
    topo = infer_topology()
    if topo.size != world_size:
        # The inferred world is not this reduction's group: stay flat.
        return MeshTopology(pods=1, chips_per_pod=world_size)
    return topo


def config_topology(world_size: int) -> MeshTopology:
    """Resolution from the live config (``HVD_TPU_TOPO_SPEC``), falling
    back to flat with a warning on a spec that does not factor the
    world: a bad spec must not crash a step that can run flat.  It warns
    once a (spec, width), since every step resolves it.

    Between the declared spec and inference sits the session's
    :class:`~horovod_tpu_torch.plan.MeshPlan`: a 2-D reduce layout
    (``data=P,fsdp=C``) is a tier declaration, its outer axis the pod
    tier and its inner the chip tier."""
    from .. import basics

    spec = basics.config().topo_spec if basics.is_initialized() else None
    if not spec and basics.is_initialized():
        plan = basics._require().mesh_plan
        tiers = plan.topo_tiers() if plan is not None else None
        if tiers is not None and tiers.size == world_size:
            return tiers
    try:
        return resolve_topology(world_size, spec)
    except ValueError as e:
        if (spec, world_size) not in _warned_specs:
            _warned_specs.add((spec, world_size))
            logger.warning("ignoring HVD_TPU_TOPO_SPEC (%s); running flat",
                           e)
        return MeshTopology(pods=1, chips_per_pod=world_size)


def register_tier_process_sets(topo: MeshTopology):
    """Register (or find: idempotent) one process set per intra-pod group
    and per cross-pod group.  Returns ``(intra_sets, cross_sets)``.
    Collective, as ``add_process_set``: every rank calls it with the same
    topology.  The schedule executor does not need them
    (:func:`tier_groups`); they give the reference's API surface
    (``ps.rank()``, ``ps.size()``, collectives over one tier)."""
    from ..process_sets import ProcessSet, _table, add_process_set

    def _ensure(ranks) -> ProcessSet:
        existing = _table().find(ranks)
        return existing if existing is not None \
            else add_process_set(ProcessSet(ranks))

    intra = [_ensure(g) for g in topo.intra_pod_groups()]
    cross = [_ensure(g) for g in topo.cross_pod_groups()]
    return intra, cross


def tier_groups(topo: MeshTopology):
    """This rank's ``torch.distributed`` groups for the two tiers of
    ``topo``: ``(intra, cross)``, the pod's group and the chip index's.

    Collective on first use: every rank creates every group, all the
    intra-pod groups by pod and then all the cross-pod groups by chip,
    so call it on every rank at the same point of the program, before
    any work of the step is in flight (with NCCL each group is a
    communicator of its own).  The groups are kept for the session
    (``basics.shutdown`` destroys them)."""
    from .. import basics

    cache = basics._require().tier_groups
    key = (topo.pods, topo.chips_per_pod)
    if key not in cache:
        if topo.size != basics.size():
            raise ValueError(
                f"topology {topo.describe()} does not cover the "
                f"{basics.size()}-rank world")
        intra = [dist.new_group(g) for g in topo.intra_pod_groups()]
        cross = [dist.new_group(g) for g in topo.cross_pod_groups()]
        cache[key] = (intra, cross)
    intra, cross = cache[key]
    me = basics.rank()
    return intra[topo.pod_of(me)], cross[topo.chip_of(me)]
