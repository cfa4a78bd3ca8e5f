"""Topology-aware collective scheduling.

Counterpart of ``horovod_tpu/topo/``.  The flat α–β planner of
:mod:`..ops.fusion` models the wire as one link; a job that spans nodes
has two: NVLink inside a node and the network between nodes, an order of
magnitude apart in latency and bandwidth.  The reference names the tiers
``ici`` (inside a pod) and ``dcn`` (between pods); the port keeps the
names, a pod being a node.

* :mod:`.topology`: the two-tier mesh (pods × chips a pod, from
  ``HVD_TPU_TOPO_SPEC`` or the node layout) and the tiers' groups.
* :mod:`.costmodel`: per-tier α/β and the online estimator (pinned by
  ``HVD_TPU_TOPO_COST_FREEZE``).
* :mod:`.schedule`: the compiler (flat, two-phase RS+AG, or
  hierarchical RS-intra → cross-pod exchange → AG-intra, by modeled
  cost) into a rank-invariant :class:`CollectiveSchedule`, and its
  executor on ``torch.distributed`` groups.
* :mod:`.simulate`: pods declared over the live world, for the
  equivalence and cost oracles.

``HVD_TPU_TOPO_SCHEDULE=auto|flat|two_phase|hierarchical`` routes the
fused gradient wire (``DistributedOptimizer``, ``make_train_step``, the
overlap wire) through the compiler; ``docs/topology.md`` is the
reference's account of the grammar and the IR.
"""

from .topology import (MeshTopology, infer_topology, resolve_topology,
                       register_tier_process_sets)
from .costmodel import (TierParams, TopoCostParams, OnlineEstimator,
                        flat_cost_us, hierarchical_cost_us,
                        hierarchical_crossover_bytes, estimator)
from .schedule import (CollectiveSchedule, ScheduleStep, ScheduleCompiler,
                       choose_algo, compile_bucket_schedule,
                       execute_schedule, maybe_compiler)

__all__ = [
    "MeshTopology", "infer_topology", "resolve_topology",
    "register_tier_process_sets",
    "TierParams", "TopoCostParams", "OnlineEstimator", "flat_cost_us",
    "hierarchical_cost_us", "hierarchical_crossover_bytes", "estimator",
    "CollectiveSchedule", "ScheduleStep", "ScheduleCompiler",
    "choose_algo", "compile_bucket_schedule", "execute_schedule",
    "maybe_compiler",
]
