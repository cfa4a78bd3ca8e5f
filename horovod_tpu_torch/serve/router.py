"""Replicated request router: spread, health, failover.

Counterpart of ``horovod_tpu/serve/router.py``, the role-aware
pipeline and the hot-swap requests included.

Horovod's lineage is data-parallel replicas coordinated over
collectives (SURVEY §0); serving maps the same shape onto request
traffic: each replica is a model copy spanning a *process set* of mesh
slots (:func:`replica_slot_groups` partitions the global mesh exactly
the way ``hvd.add_process_set`` expects), and the router spreads
requests across replicas round-robin — the control plane is
collective-aware, the per-token hot path never crosses replicas.

Failure handling mirrors the task-agent liveness design
(``runner/task_agent.py``): consecutive failures accumulate *strikes*;
at the configured limit the replica is benched for a probation window,
after which one half-open attempt may rehabilitate it.  A request that
was in flight on a dying replica is **drained back into the queue**:
the router re-submits it under the shared
:class:`~..utils.retry.RetryPolicy` (jittered exponential
backoff — synchronized retries from a fleet of routers would re-create
the overload that killed the replica), and a response cache keyed by
``request_id`` guarantees at-most-once delivery to the caller even if
a retry races a late success.

**Global prefix directory** (serve/fleet/directory.py): requests whose
leading prompt block is resident on some replica's paged KV pool route
there — admission is a cache hit instead of a full prefill.  The
directory subsumes the single-replica affinity map: it tracks every
replica a prefix is resident on (migration leaves it on both ends),
drops a replica's entries when it is benched, and consumes eviction
notifications piggybacked on response frames.  Residency is a
preference, not a pin: a benched or saturated resident falls back to
the least-loaded spread, so the failure handling above is unchanged.

**Role-aware dispatch** (serve/fleet/): when the fleet carries both
``prefill`` and ``decode`` replicas, a directory-miss request runs the
admit→prefill→migrate→decode pipeline — the router sends the request
to a prefill replica with its decode target attached, the prefill
replica streams the KV over the wire after the first token, and the
router collects the finished generation from the decode replica.  Any
pipeline failure (prefill death mid-migration, digest rejection, lost
continuation) re-routes to a unified full-generation recompute path on
whatever healthy replica remains — requests are never lost and tokens
are never wrong, the disaggregation only ever costs economics.
"""

from __future__ import annotations

import itertools
import threading
import time
import uuid
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

from ..obs import instrument as _obs
from ..obs import trace as trace_mod
from ..runner.common.network import (BasicClient, CollectRequest,
                                     DrainRequest)
from ..utils.logging import get_logger
from ..utils.retry import RetryPolicy, retry_call
from .engine import resolved_config
from .fleet.directory import PrefixDirectory
from .qos import QosGate, validate_class
from .server import (CancelRequest, GenerateRequest, GenerateResponse,
                     RollbackRequest, StatsRequest, SwapRequest)

logger = get_logger(__name__)

# Wire errors after which the SAME request may safely run elsewhere:
# the replica never produced (or will never deliver) a response.
_RETRYABLE_ERRORS = ("busy", "replica_killed", "replica_dead")


class NoHealthyReplicasError(ConnectionError):
    """Every replica is dead or benched (may clear after probation)."""


class ReplicaUnavailableError(ConnectionError):
    """The chosen replica refused or lost the request; try another."""


def replica_slot_groups(n_replicas: int,
                        world_size: Optional[int] = None) -> List[List[int]]:
    """Partition the mesh's slots into ``n_replicas`` contiguous
    data-parallel groups — the rank lists a deployer feeds to
    ``hvd.add_process_set`` (one set per replica; contiguous keeps each
    replica on an ICI-adjacent block)."""
    from .. import basics

    world = world_size if world_size is not None else basics.size()
    if n_replicas < 1 or world % n_replicas:
        raise ValueError(
            f"cannot split {world} slot(s) into {n_replicas} equal "
            f"replica group(s)")
    per = world // n_replicas
    return [list(range(i * per, (i + 1) * per)) for i in range(n_replicas)]


def register_replica_process_sets(n_replicas: int):
    """Register (or look up) one process set per replica group;
    returns them in replica order.  Idempotent: an already-registered
    identical set is reused, so serving restarts don't collide."""
    from .. import process_sets as ps

    out = []
    for ranks in replica_slot_groups(n_replicas):
        existing = ps._table().find(ranks)
        out.append(existing if existing is not None
                   else ps.add_process_set(ranks))
    return out


class ReplicaSpec:
    """Where one replica answers: candidate addresses, its mesh ranks,
    and its fleet role (``prefill`` / ``decode`` / ``unified`` — the
    replica class the disaggregated dispatch schedules by)."""

    def __init__(self, name: str, addresses: List[Tuple[str, int]],
                 ranks: Optional[Sequence[int]] = None,
                 role: str = "unified"):
        self.name = name
        self.addresses = list(addresses)
        self.ranks = list(ranks) if ranks is not None else None
        if role not in ("prefill", "decode", "unified"):
            raise ValueError(f"unknown replica role {role!r}; expected "
                             f"prefill|decode|unified")
        self.role = role


class _ReplicaState:
    def __init__(self, spec: ReplicaSpec):
        self.spec = spec
        # Health/load state is owned by the Router that holds this
        # replica entry — all mutation happens under ITS lock.
        self.client: Optional[BasicClient] = None  # guarded-by: Router._lock
        self.strikes = 0                           # guarded-by: Router._lock
        self.dead_until: Optional[float] = None    # guarded-by: Router._lock
        self.draining = False                      # guarded-by: Router._lock
        self.inflight = 0                          # guarded-by: Router._lock
        self.completed = 0                         # guarded-by: Router._lock
        self.failed = 0                            # guarded-by: Router._lock
        # Last weights version observed on a response from this replica
        # (serve/swap.py) — None until one reported.
        self.weights_version: Optional[int] = None  # guarded-by: Router._lock


class Router:
    """Client-side request spreader over serving replicas."""

    def __init__(self, replicas: Sequence[ReplicaSpec], key: bytes, *,
                 retry_policy: Optional[RetryPolicy] = None,
                 strikes: Optional[int] = None,
                 probation_s: Optional[float] = None,
                 probe_timeout: float = 5.0,
                 dedupe_window: int = 1024,
                 clock=None,
                 client_factory=None):
        if not replicas:
            raise ValueError("router needs at least one replica")
        cfg = resolved_config()
        self._replicas = [_ReplicaState(r) for r in replicas]
        self._key = key
        self._probe_timeout = probe_timeout
        # Injectable monotonic clock: probation windows and stats
        # deadlines read THIS, so the fleet simulator (serve/fleet/sim
        # .py) can run health policy under a virtual clock.  Default is
        # the real clock — production behavior unchanged.
        self._clock = clock if clock is not None else time.monotonic
        # Transport seam: builds the per-replica client instead of
        # BasicClient.  A deterministic in-process transport (the sim's
        # replicas, a unit test's fake) answers the same wire frames
        # without sockets; with a factory installed, stats snapshots
        # poll serially — there is no network I/O to overlap, and
        # thread scheduling would perturb a simulation's determinism.
        self._client_factory = client_factory
        self._strike_limit = int(strikes if strikes is not None
                                 else cfg.serve_replica_strikes)
        self._probation_s = float(probation_s if probation_s is not None
                                  else cfg.serve_probation_seconds)
        self._default_deadline_s = cfg.serve_deadline_seconds
        # One failover pass visits every replica once; the policy adds
        # backoff'd sweeps on top (half-open probation needs the time).
        self._retry_policy = retry_policy or RetryPolicy(
            attempts=2 * len(self._replicas) + 1,
            base_delay_s=0.05, max_delay_s=2.0)
        self._lock = threading.Lock()
        self._rr = itertools.count()
        self._done: "OrderedDict[str, GenerateResponse]" = OrderedDict()  # guarded-by: _lock
        self._dedupe_window = dedupe_window
        # Global prefix directory: leading-block token key -> replicas
        # with resident blocks (serve/fleet/directory.py — the
        # router-tier promotion of the per-replica radix index).  The
        # slack is how many MORE in-flight requests than the idlest
        # peer a resident replica may carry before residency yields to
        # the least-loaded spread — without it, one hot system prompt
        # would pin the whole fleet's traffic to a single replica and
        # serially bench healthy peers through busy-strikes.
        self._affinity_block = int(cfg.serve_kv_block)
        self._affinity_slack = max(1, int(cfg.serve_max_batch))
        self._directory = PrefixDirectory(self._affinity_block,
                                          max_entries=1024)
        # Multi-tenant QoS gate (serve/qos/brownout.py): per-tenant
        # rate limits + the brownout shed ladder, consulted BEFORE any
        # replica is touched.  None = no router-tier policy (the
        # batcher tier may still enforce budgets).
        self._qos_gate: Optional[QosGate] = None

    def attach_qos(self, gate: QosGate) -> None:
        """Install the router-tier QoS gate (docs/qos.md): every
        ``generate`` runs its shed/budget checks first, and the fleet
        controller feeds it the overload signals each control round."""
        self._qos_gate = gate

    @property
    def qos_gate(self) -> Optional[QosGate]:
        return self._qos_gate

    # --- health -------------------------------------------------------------

    def _healthy(self, rep: _ReplicaState, now: float) -> bool:
        if rep.dead_until is None:
            return True
        return now >= rep.dead_until    # probation over: half-open try

    def _strike(self, rep: _ReplicaState, fatal: bool = False) -> None:
        benched = False
        with self._lock:
            rep.strikes += 1
            rep.failed += 1
            rep.client = None    # re-probe on next use
            if fatal or rep.strikes >= self._strike_limit:
                rep.dead_until = self._clock() + self._probation_s
                benched = True
                logger.warning(
                    "replica %s benched for %.1fs (%d strike(s))",
                    rep.spec.name, self._probation_s, rep.strikes)
        if benched:
            # Directory consistency on replica death: a benched replica
            # may have lost its pool (crash/restart), so its residency
            # entries are dropped — a stale route would only cost a
            # cache miss, but a prompt drop here keeps the directory
            # honest through failover storms.
            self._directory.invalidate_replica(rep)

    def _mark_ok(self, rep: _ReplicaState) -> None:
        with self._lock:
            rep.strikes = 0
            rep.dead_until = None
            rep.completed += 1

    def _prefix_key(self, prompt: Sequence[int]) -> Optional[tuple]:
        """Directory key: the prompt's leading KV block's token IDs —
        the same granularity the replicas' prefix indexes share at, so
        a key match is (at least) a one-block cache hit there."""
        return self._directory.key_for(prompt)

    def _note_affinity(self, key: Optional[tuple], rep: _ReplicaState,
                       version: Optional[int] = None) -> None:
        """Record residency: ``rep`` now holds this prompt's leading
        blocks (it served the request, or adopted its migration).
        ``version`` is the weights version the response reported — the
        KV those blocks were computed under."""
        if key is not None:
            self._directory.record(key, rep, version=version)

    def _ingest_evictions(self, rep: _ReplicaState, resp) -> None:
        """Apply eviction notifications piggybacked on a response frame
        to the directory (the replica no longer holds these keys)."""
        for key in (getattr(resp, "evicted_prefixes", None) or ()):
            self._directory.discard(tuple(key), rep)

    def _note_version(self, rep: _ReplicaState,
                      version: Optional[int]) -> None:
        """Track ``rep``'s weights version from a response/stats frame.
        A CHANGE drops the replica's prefix-directory entries: its KV
        pool was flushed at the flip, so every recorded residency is
        stale — and even a missed notification is caught by the
        version tag ``_resident_locked`` checks (mixed-version routing
        rule, docs/hot_swap.md)."""
        if version is None:
            return
        with self._lock:
            changed = (rep.weights_version is not None
                       and rep.weights_version != version)
            rep.weights_version = int(version)
        if changed:
            self._directory.invalidate_replica(rep)

    def _pick(self, prefix_key: Optional[tuple] = None) -> _ReplicaState:
        """Round-robin over healthy replicas, preferring (1) the
        replica whose KV pool holds this prompt's prefix, then (2) the
        least loaded among the next candidates (spread, not pile-on).

        Expired probation is **half-open**: exactly one request per
        window probes the benched replica (its bench is re-armed under
        the lock before release, so a concurrent wave cannot pile onto
        a possibly-still-dead peer); success rejoins it via
        ``_mark_ok``, failure re-strikes."""
        now = self._clock()
        with self._lock:
            half_open = [r for r in self._replicas
                         if r.dead_until is not None
                         and now >= r.dead_until and not r.draining]
            if half_open:
                probe = min(half_open, key=lambda r: r.dead_until)
                probe.dead_until = now + self._probation_s
                return probe
            fully = [r for r in self._replicas
                     if r.dead_until is None and not r.draining]
            if not fully:
                soonest = min(
                    (r.dead_until for r in self._replicas
                     if r.dead_until is not None), default=None)
                raise NoHealthyReplicasError(
                    f"all {len(self._replicas)} replica(s) benched or "
                    f"draining"
                    + (f"; next probation in "
                       f"{max(0.0, soonest - now):.1f}s"
                       if soonest else ""))
            resident = self._resident_locked(prefix_key, fully)
            if resident is not None:
                return resident
            start = next(self._rr) % len(fully)
            ordered = fully[start:] + fully[:start]
            return min(ordered, key=lambda r: r.inflight)

    def _resident_locked(self, prefix_key: Optional[tuple],
                         fully: List[_ReplicaState]
                         ) -> Optional[_ReplicaState]:
        """Caller holds the lock; ``fully`` is its healthy,
        non-draining pool.  Returns the most recently confirmed
        resident replica within the load slack, or None.  ONE
        definition of the residency rule: prefer the cache-warm replica
        while it is not drastically more loaded than the idlest peer;
        beyond the slack the request spills to the spread (the prefix
        gets cached there too)."""
        if prefix_key is None or not fully:
            return None
        floor = min(r.inflight for r in fully)
        for resident, version in self._directory.lookup_versioned(
                prefix_key):
            if resident not in fully:
                continue
            if version is not None and resident.weights_version is not None \
                    and version != resident.weights_version:
                # Mixed-version rule (docs/hot_swap.md): the recorded
                # residency predates a weight flip — the KV it points
                # at was computed under OLD weights, so the hit must
                # fall back to a recompute, never serve stale blocks.
                continue
            if resident.inflight - floor <= self._affinity_slack:
                return resident
        return None

    def _directory_pick(self,
                        prefix_key: Optional[tuple]
                        ) -> Optional[_ReplicaState]:
        """The global-prefix-directory route: a healthy, non-draining
        replica with this prompt's leading block resident (and within
        the load slack), or None — the fleet dispatch's first choice
        before the prefill/decode pipeline."""
        with self._lock:
            fully = [r for r in self._replicas
                     if r.dead_until is None and not r.draining]
            return self._resident_locked(prefix_key, fully)

    def _pick_role(self, role: str) -> Optional[_ReplicaState]:
        """Least-loaded healthy, non-draining replica of ``role``
        (None when the role has no healthy member — the caller falls
        back to the unified path)."""
        with self._lock:
            pool = [r for r in self._replicas
                    if r.spec.role == role and r.dead_until is None
                    and not r.draining]
            if not pool:
                return None
            return min(pool, key=lambda r: r.inflight)

    def _client(self, rep: _ReplicaState) -> BasicClient:
        with self._lock:
            client = rep.client
        if client is None:
            # Probe outside the lock (network I/O); publish under it so
            # concurrent callers converge on one client instead of
            # racing duplicate probes.
            if self._client_factory is not None:
                client = self._client_factory(rep.spec)
            else:
                client = BasicClient(
                    rep.spec.name, rep.spec.addresses, self._key,
                    probe_timeout=self._probe_timeout,
                    # The router owns cross-replica retries; a
                    # transparent same-replica retry here would stack
                    # policies.
                    retry_policy=RetryPolicy(attempts=1))
            with self._lock:
                if rep.client is None:
                    rep.client = client
                else:
                    client = rep.client
        return client

    def _cancel_on(self, rep: _ReplicaState, request_id: str) -> None:
        """Best-effort abandon of a request the router is about to
        re-run elsewhere — without this, a wire error after admission
        leaves the original replica decoding an answer nobody will
        read, and every failover burns two replicas' worth of slots."""
        try:
            self._client(rep).request(CancelRequest(request_id),
                                      idempotent=False, timeout=5.0)
        except OSError:
            pass   # replica truly gone: nothing left to cancel

    # --- fleet membership (serve/fleet/controller.py drives these) ----------

    def _find(self, name: str) -> Optional[_ReplicaState]:
        with self._lock:
            return next((r for r in self._replicas
                         if r.spec.name == name), None)

    def add_replica(self, spec: ReplicaSpec) -> None:
        """Register a freshly-launched replica (elastic scale-out)."""
        with self._lock:
            self._replicas.append(_ReplicaState(spec))
        logger.info("router: +replica %s (%s)", spec.name, spec.role)

    def remove_replica(self, name: str) -> None:
        """Deregister ``name`` (drain completed / replica retired) and
        release its prefix-directory entries.  The router refuses to
        remove its last replica — an empty fleet serves nothing."""
        with self._lock:
            rep = next((r for r in self._replicas
                        if r.spec.name == name), None)
            if rep is None:
                return
            if len(self._replicas) <= 1:
                raise ValueError(
                    "cannot remove the last replica from the router")
            self._replicas.remove(rep)
        self._directory.invalidate_replica(rep)
        logger.info("router: -replica %s", name)

    def drain_replica(self, name: str, timeout: float = 5.0) -> None:
        """Start drain-and-retire for ``name``: mark it locally (picks
        skip it immediately) and tell the replica to stop admitting."""
        rep = self._find(name)
        if rep is None:
            return
        self._mark_draining(rep)
        try:
            self._client(rep).request(DrainRequest(), idempotent=False,
                                      timeout=timeout)
        except OSError as e:
            logger.warning("drain request to %s failed (%s); the local "
                           "draining mark still shields it from new "
                           "traffic", name, e)

    def undrain_replica(self, name: str, timeout: float = 5.0) -> None:
        """Reverse a drain (the controller's abandon path): clear the
        local mark so picks see the replica again and tell it to admit
        — a replica left draining with no retire coming would starve
        the fleet."""
        rep = self._find(name)
        if rep is None:
            return
        with self._lock:
            rep.draining = False
        try:
            self._client(rep).request(DrainRequest(cancel=True),
                                      idempotent=False, timeout=timeout)
        except OSError as e:
            logger.warning("undrain request to %s failed (%s); the "
                           "replica keeps refusing until reachable",
                           name, e)

    def _mark_draining(self, rep: _ReplicaState) -> None:
        with self._lock:
            rep.draining = True

    # --- weight hot-swap (serve/swap.py; docs/hot_swap.md) ------------------

    def replica_names(self) -> List[str]:
        with self._lock:
            return [r.spec.name for r in self._replicas]

    def swap_replica(self, name: str, step: int, *,
                     rollback: bool = False, timeout: float = 120.0):
        """Tell one replica to hot-swap (or roll back) to ``step``;
        returns its ``SwapResponse``.  A refused/failed swap is NOT a
        health event — the replica answered, and it is still serving
        its old weights — so nothing here strikes it; only a wire
        death does (via the normal strike path)."""
        rep = self._find(name)
        if rep is None:
            raise ValueError(f"unknown replica {name!r}")
        frame = (RollbackRequest(step) if rollback
                 else SwapRequest(step))
        try:
            resp = self._client(rep).request(frame, idempotent=False,
                                             timeout=timeout)
        except OSError as e:
            self._strike(rep)
            raise ReplicaUnavailableError(
                f"replica {name}: {e}") from e
        self._note_version(rep, getattr(resp, "weights_version", None))
        return resp

    def rollback_replica(self, name: str, step: int, *,
                         timeout: float = 120.0):
        return self.swap_replica(name, step, rollback=True,
                                 timeout=timeout)

    # --- request path -------------------------------------------------------

    def generate(self, prompt: Sequence[int], *,
                 max_new_tokens: int = 16, temperature: float = 0.0,
                 top_k: int = 0, stop_token: Optional[int] = None,
                 deadline_s: Optional[float] = None,
                 request_id: Optional[str] = None,
                 spec: bool = False,
                 tenant: Optional[str] = None,
                 qos_class: Optional[str] = None) -> GenerateResponse:
        """Route one generation; at-most-once per ``request_id``.

        Retryable failures (dead/busy/killed replica, wire errors)
        re-enter the queue under the retry policy and land on another
        replica; terminal errors (deadline, oversized prompt) return
        as-is.  ``spec=True`` opts into speculative decoding on
        replicas that run a drafter.  ``tenant``/``qos_class`` place
        the request in the QoS scheduler (docs/qos.md); with a gate
        attached, a brownout shed or an exhausted tenant budget raises
        the typed retriable rejection BEFORE any replica is touched."""
        rid = request_id or uuid.uuid4().hex
        qos_class = validate_class(qos_class)
        tenant = tenant or "default"
        with self._lock:
            if rid in self._done:
                return self._done[rid]
        gate_charge = 0.0
        if self._qos_gate is not None:
            # Raises RequestShedError / BudgetExhaustedError — typed,
            # retriable by the CLIENT after retry_after_s, and costing
            # the fleet nothing (no replica ever sees the request).
            gate_charge = self._qos_gate.admit(
                tenant, qos_class, len(prompt) + max_new_tokens)
        prefix_key = self._prefix_key(prompt)
        # Response-read timeout: a generation legitimately runs for the
        # request's whole deadline — reading it under the snappy probe
        # timeout would misclassify every slow answer as a dead replica
        # (and bench the healthy fleet two requests at a time).
        effective_deadline = (deadline_s if deadline_s is not None
                              else self._default_deadline_s)
        wire_timeout = (effective_deadline * 2 + 30.0
                        if effective_deadline and effective_deadline > 0
                        else 600.0)

        def mk_req(migrate_to=None) -> GenerateRequest:
            return GenerateRequest(rid, list(prompt),
                                   max_new_tokens=max_new_tokens,
                                   temperature=temperature, top_k=top_k,
                                   stop_token=stop_token,
                                   deadline_s=deadline_s, spec=spec,
                                   migrate_to=migrate_to,
                                   tenant=tenant, qos_class=qos_class)

        # A collect failure means the decode replica lost the migrated
        # continuation — later attempts recompute on the unified path
        # instead of re-entering the pipeline (never wrong tokens, at
        # worst one redundant prefill).
        state = {"force_unified": False}

        def run_on(rep: _ReplicaState, wire_req) -> GenerateResponse:
            with self._lock:
                rep.inflight += 1
            try:
                client = self._client(rep)
                resp = client.request(wire_req, idempotent=False,
                                      timeout=wire_timeout)
            except OSError as e:
                self._strike(rep)
                self._cancel_on(rep, rid)
                raise ReplicaUnavailableError(
                    f"replica {rep.spec.name}: {e}") from e
            finally:
                with self._lock:
                    rep.inflight -= 1
            if resp.error == "draining":
                # Voluntary refusal (drain-and-retire), not a failure:
                # shield the replica from picks without striking it.
                self._mark_draining(rep)
                raise ReplicaUnavailableError(
                    f"replica {rep.spec.name}: draining")
            if resp.error in _RETRYABLE_ERRORS:
                self._strike(rep, fatal=resp.error != "busy")
                raise ReplicaUnavailableError(
                    f"replica {rep.spec.name}: {resp.error}")
            self._mark_ok(rep)
            self._ingest_evictions(rep, resp)
            self._note_version(rep, getattr(resp, "weights_version",
                                            None))
            return resp

        def attempt() -> GenerateResponse:
            # 1. Global prefix directory: a resident prefix anywhere in
            # the fleet (prefill source, decode target after an earlier
            # migration, or a unified peer) beats a cold pipeline — the
            # hit replica runs the whole request against warm KV.
            rep = self._directory_pick(prefix_key)
            if rep is not None:
                resp = run_on(rep, mk_req())
                # Counted only on success: a failed route is a failover,
                # not a cache hit, and retries must not recount.
                _obs.on_fleet_directory_hit()
                self._note_affinity(prefix_key, rep,
                                    getattr(resp, "weights_version",
                                            None))
                return resp
            # 2. Disaggregated pipeline: admit→prefill→migrate→decode
            # when both role classes have healthy members.
            if not state["force_unified"]:
                pre = self._pick_role("prefill")
                dec = self._pick_role("decode")
                if pre is not None and dec is not None:
                    # Reserve the decode target for the whole
                    # prefill+migrate window.  ``inflight`` on the
                    # decode otherwise only rises when the collect
                    # starts — so N concurrent submits all see the same
                    # least-loaded decode and the fleet convoys its
                    # migrations into one receiver (found at simulated
                    # scale by serve/fleet/sim.py's no_migration_convoy
                    # invariant).  Inbound migration is load from the
                    # moment the target is chosen.
                    with self._lock:
                        dec.inflight += 1
                    reserved = True
                    try:
                        resp = run_on(pre, mk_req(
                            migrate_to=(dec.spec.name,
                                        dec.spec.addresses)))
                        pre_v = getattr(resp, "weights_version", None)
                        if getattr(resp, "migrated_to", None) is None:
                            # Migration fell back (digest rejection,
                            # wire drop, busy receiver): the prefill
                            # replica finished the generation itself.
                            self._note_affinity(prefix_key, pre, pre_v)
                            return resp
                        self._note_affinity(prefix_key, pre, pre_v)
                        # Hand the reservation off to the collect: from
                        # here ``run_on(dec, …)`` carries the count.
                        with self._lock:
                            dec.inflight -= 1
                        reserved = False
                        try:
                            final = run_on(dec, CollectRequest(rid))
                        except ReplicaUnavailableError:
                            state["force_unified"] = True
                            raise
                    finally:
                        if reserved:
                            with self._lock:
                                dec.inflight -= 1
                    if final.error == "unknown_request" or (
                            final.error or "").startswith("import_failed"):
                        # The decode replica lost the continuation
                        # (restart / cancel race) or could not bind the
                        # adopted KV (pool exhausted at deferred import
                        # time — adopt() only checks the queue): both
                        # are recoverable by recomputing elsewhere, and
                        # returning them to the caller would lose a
                        # request every replica could still serve.
                        state["force_unified"] = True
                        raise ReplicaUnavailableError(
                            f"replica {dec.spec.name}: {final.error} "
                            f"for migrated request {rid}")
                    # The caller-visible response is the collect frame;
                    # carry the prefill half's migration metadata onto
                    # it (which replica carried the decode, what the
                    # transfer cost — the bench's overhead signal) AND
                    # the prefill-side TTFT: the collect frame's own
                    # ttft_ms covers only adoption→first-replayed-token
                    # (~0), while the first token was really produced on
                    # the prefill replica after its queueing + prefill —
                    # the same submit→first-token definition the unified
                    # path reports, so fleet and unified TTFT compare
                    # like for like.
                    final.migrated_to = resp.migrated_to
                    final.migrate_ms = resp.migrate_ms
                    final.ttft_ms = resp.ttft_ms
                    self._note_affinity(prefix_key, dec,
                                        getattr(final, "weights_version",
                                                None))
                    return final
            # 3. Unified spread (also the recompute fallback when the
            # pipeline cannot run or lost a continuation).
            # NoHealthyReplicasError is retryable: probation may clear
            # under the policy's backoff.
            rep = self._pick(prefix_key)
            resp = run_on(rep, mk_req())
            # The replica now holds this prompt's prefix blocks: later
            # requests sharing the leading block prefer it (cache hit).
            self._note_affinity(prefix_key, rep,
                                getattr(resp, "weights_version", None))
            return resp

        # One trace per request, rooted at admission (docs/tracing.md):
        # the failover attempts' RPC client spans, the replica's server
        # span, and the batcher's queued/prefill/decode phases all
        # parent under it, so the merged trace answers "where did this
        # request's latency go" across processes.
        try:
            with trace_mod.span("hvd_tpu_serve_request", root=True,
                                args={"request_id": rid,
                                      "max_new_tokens": max_new_tokens}):
                resp = retry_call(
                    attempt, policy=self._retry_policy,
                    retry_on=(ReplicaUnavailableError,
                              NoHealthyReplicasError),
                    describe=f"serve generate {rid}")
        except Exception:
            if self._qos_gate is not None and gate_charge > 0:
                # A lost request served nothing: hand the whole
                # reservation back, or a few fleet outages would drain
                # the tenant's bucket and convert replica failures
                # into budget_exhausted rejections.
                self._qos_gate.refund(tenant, gate_charge)
            raise
        if self._qos_gate is not None and gate_charge > 0:
            # Refund the unused reservation: the charge covered prompt
            # + the generation cap, the tenant pays prompt + delivered.
            used = len(prompt) + len(resp.tokens or ())
            self._qos_gate.refund(tenant, gate_charge - used)
        with self._lock:
            self._done[rid] = resp
            while len(self._done) > self._dedupe_window:
                self._done.popitem(last=False)
        return resp

    # --- observability ------------------------------------------------------

    def replica_stats(self, timeout: float = 5.0) -> Dict[str, dict]:
        """Live ``StatsRequest`` snapshot per reachable replica, plus
        the router's own health view.

        Replicas are polled CONCURRENTLY under one overall deadline:
        an unreachable replica costs the snapshot one ``timeout``, not
        one timeout EACH — the fleet controller reads this every
        control round, and with serial polling an N-replica snapshot
        over dead peers stalled N×timeout."""
        now = self._clock()
        entries: List[Dict[str, object]] = []
        with self._lock:
            # Snapshot the health fields UNDER the lock: swap/strike
            # threads mutate them concurrently.
            reps = list(self._replicas)
            for rep in reps:
                entries.append({
                    "name": rep.spec.name,
                    "role": rep.spec.role,
                    "healthy": self._healthy(rep, now),
                    "draining": rep.draining,
                    "strikes": rep.strikes,
                    "inflight": rep.inflight,
                    "completed": rep.completed,
                    "failed": rep.failed,
                    "weights_version": rep.weights_version,
                })

        # Fetch threads write into their own holders, NOT the returned
        # entries: a thread that outlives the deadline must not mutate
        # a snapshot the caller is already iterating (the controller
        # reads these mid-control-round).
        holders: List[Dict[str, object]] = [{} for _ in reps]

        def fetch(rep: _ReplicaState, holder: Dict[str, object]) -> None:
            try:
                resp = self._client(rep).request(StatsRequest(),
                                                 idempotent=False,
                                                 timeout=timeout)
                holder["stats"] = resp.stats
                # Stats are a second version source beside responses —
                # an idle replica's flip becomes router-visible on the
                # next controller poll, not only on its next request.
                self._note_version(rep,
                                   resp.stats.get("weights_version"))
            except OSError as e:
                holder["stats_error"] = str(e)

        if self._client_factory is not None:
            # In-process transport (simulation/tests): the "wire" is a
            # deterministic method call, so there is nothing to overlap
            # and thread interleaving would only cost reproducibility —
            # at 1000 simulated replicas per control round, it would
            # also dominate the simulator's CPU budget.
            for rep, holder in zip(reps, holders):
                fetch(rep, holder)
            for entry, holder in zip(entries, holders):
                entry.update(holder)
        else:
            threads = [threading.Thread(target=fetch, args=(rep, holder),
                                        daemon=True,
                                        name=f"stats-{rep.spec.name}")
                       for rep, holder in zip(reps, holders)]
            for t in threads:
                t.start()
            # One overall deadline (timeout + connect grace), not per
            # replica: the snapshot returns when the fleet answered or
            # the clock ran out, whichever is first.
            deadline = self._clock() + timeout + 1.0
            for t in threads:
                t.join(max(0.0, deadline - self._clock()))
            for entry, holder, t in zip(entries, holders, threads):
                if t.is_alive():
                    entry["stats_error"] = f"timeout after {timeout}s"
                else:
                    entry.update(holder)
        out: Dict[str, dict] = {}
        for idx, entry in enumerate(entries):
            key = str(entry["name"])
            if key in out:   # duplicate display names stay visible
                key = f"{key}[{idx}]"
            out[key] = entry
        return out
