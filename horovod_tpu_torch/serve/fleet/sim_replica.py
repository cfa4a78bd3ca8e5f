"""Simulated serving replicas and the in-process wire they answer on.

Counterpart of ``horovod_tpu/serve/fleet/sim_replica.py``.  A
:class:`SimReplica` stands where a real replica process would: it owns
a REAL :class:`~..qos.sched.QosQueue` (so weighted-fair ordering — and
the ``qos:invert`` fault that fires inside its ``pop`` — is the
production code path), per-class TTFT windows for the stats snapshots
the fleet controller polls, and seeded service-time samplers from a
:class:`~.traces.ReplicaProfile`.  Only the DATA plane is simulated
(token generation becomes a sampled latency instead of a forward);
every control-plane decision about the replica — routing, health
strikes, probation, drain, directory consistency, brownout — runs
through the real ``Router`` / ``FleetController`` / ``QosGate`` objects
the simulator drives (:mod:`.sim`).

:class:`LocalClient` is the transport the router's ``client_factory``
seam installs: it answers the frames ``BasicClient`` carries (stats,
drain, swap/rollback, cancel) as deterministic in-process calls — a
dead replica raises ``ConnectionError`` exactly where a closed socket
would, so the router's strike/bench machinery fires for real.
"""

from __future__ import annotations

import random
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

from ...runner.common.network import DrainRequest
from ..qos.policy import QosPolicy
from ..qos.sched import QosQueue
from ..router import ReplicaSpec
from ..server import (CancelRequest, RollbackRequest, StatsRequest,
                      SwapRequest)
from .traces import ReplicaProfile, SimRequest

# Bytes a simulated swap "pulls" (the JAX package's recorded
# SERVING_r14 roll moved 32 KiB a replica — the value only feeds a
# counter).
SWAP_PULL_BYTES = 32768

_TTFT_WINDOW = 256   # per-class samples kept for the p99 the stats report


def _p99(samples: List[float]) -> Optional[float]:
    if not samples:
        return None
    ordered = sorted(samples)
    return ordered[min(len(ordered) - 1,
                       int(0.99 * (len(ordered) - 1) + 0.999))]


class SimReplica:
    """One simulated replica: real admission queue, sampled service."""

    def __init__(self, name: str, role: str, profile: ReplicaProfile,
                 seed: int, *, max_slots: int = 8,
                 weights_version: int = 1) -> None:
        self.name = name
        self.role = role
        self.spec = ReplicaSpec(name, [("sim", 0)], role=role)
        self.profile = profile
        self.rng = random.Random(seed)
        self.max_slots = int(max_slots)
        # The REAL weighted-fair queue (default class weights, no
        # budgets — budgets are the router gate's job in this wiring).
        self.queue = QosQueue(QosPolicy())
        self.active: Dict[str, SimRequest] = {}
        self.alive = True
        self.draining = False
        self.weights_version = int(weights_version)
        # Epoch fences stale events: a kill bumps it, and any
        # first-token/finish event scheduled against the old epoch is
        # dropped by the simulator when it fires.
        self.epoch = 0
        self.completed = 0
        self.failed = 0
        # Ground truth for the directory-staleness invariant: prefix
        # keys whose KV blocks this replica actually holds.
        self.resident: set = set()
        # Virtual time of the last event that invalidated this
        # replica's directory entries (kill, weight flip) — the
        # staleness invariant's clock anchor; None = never.
        self.invalidated_at: Optional[float] = None
        # request_id -> decode-replica name for requests admitted on
        # the prefill tier (None = serve locally, unified path).
        self.pipeline_to: Dict[str, Optional[str]] = {}
        self._ttft_all: List[float] = []
        self._ttft_by_class: Dict[str, List[float]] = {}

    # --- service sampling ----------------------------------------------------

    def sample_ttft_ms(self) -> float:
        return self.profile.ttft_ms.sample(self.rng)

    def sample_decode_ms(self, n_tokens: int) -> float:
        return sum(self.profile.tpot_ms.sample(self.rng)
                   for _ in range(max(0, int(n_tokens))))

    def sample_migrate_ms(self) -> float:
        return self.profile.migrate_ms.sample(self.rng)

    def sample_swap_ms(self) -> float:
        return self.profile.swap_ms.sample(self.rng)

    # --- lifecycle -----------------------------------------------------------

    def kill(self) -> List[SimRequest]:
        """Replica death: bump the epoch (in-flight events become
        stale), flush state, and hand back everything that was queued
        or active so the simulator can fail it over."""
        self.alive = False
        self.epoch += 1
        orphans = list(self.queue.drain()) + list(self.active.values())
        self.active.clear()
        self.resident.clear()
        self.pipeline_to.clear()
        return orphans

    def flush_kv(self) -> None:
        """A weight flip drops the KV pool (serve/swap.py semantics):
        resident prefixes are gone whatever the directory still says."""
        self.resident.clear()

    def record_ttft(self, qos_class: str, ttft_ms: float) -> None:
        for bucket in (self._ttft_all,
                       self._ttft_by_class.setdefault(qos_class, [])):
            bucket.append(ttft_ms)
            del bucket[:-_TTFT_WINDOW]

    # --- the stats snapshot the controller polls -----------------------------

    def stats(self) -> dict:
        qos = {cls: {"ttft_ms_p99": _p99(samples)}
               for cls, samples in self._ttft_by_class.items() if samples}
        return {
            "queue_depth": len(self.queue),
            "active_slots": len(self.active),
            "max_slots": self.max_slots,
            "ttft_ms_p99": _p99(self._ttft_all),
            "weights_version": self.weights_version,
            "qos": qos,
        }


class LocalClient:
    """In-process replica transport for the router's ``client_factory``
    seam: same frames, no sockets, deterministic answers."""

    def __init__(self, sim, name: str) -> None:
        self._sim = sim
        self._name = name

    def request(self, frame, idempotent: bool = False,
                timeout: Optional[float] = None):
        rep = self._sim.live_replica(self._name)
        if rep is None:
            raise ConnectionError(f"sim replica {self._name} is dead")
        if isinstance(frame, StatsRequest):
            return SimpleNamespace(stats=rep.stats())
        if isinstance(frame, DrainRequest):
            rep.draining = not frame.cancel
            return SimpleNamespace(error=None)
        if isinstance(frame, (SwapRequest, RollbackRequest)):
            return self._sim.swap_replica_sim(
                rep, frame.step,
                rollback=isinstance(frame, RollbackRequest))
        if isinstance(frame, CancelRequest):
            rep.queue.remove(frame.request_id)
            rep.active.pop(frame.request_id, None)
            return SimpleNamespace(error=None)
        raise ConnectionError(
            f"sim transport: unsupported frame "
            f"{type(frame).__name__} (the simulator drives the data "
            f"plane through events, not GenerateRequest)")
