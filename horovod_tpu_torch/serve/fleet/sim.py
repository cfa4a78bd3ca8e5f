"""Fleet-scale discrete-event chaos simulator for the serving control
plane.

Counterpart of ``horovod_tpu/serve/fleet/sim.py``, event for event:
the same seed, trace, profile and fault spec give the same event log
in both packages.  Every control-plane policy of the serving stack —
QoS brownout, per-role autoscaling, prefix-directory routing, health
probation, rolling swaps — is tested at 2–4 real replicas, but its
fleet failure modes (shed/scale oscillation, staleness storms,
migration convoys, swap-vs-autoscaler races) only emerge at fleet
sizes no test can run for real.  This module models that regime,
drives the REAL policy objects through it, and checks the SLO
properties as first-class invariants.

**What is real:** the :class:`~..router.Router` (picks, strikes,
probation, the prefix :class:`~.directory.PrefixDirectory`,
version-matched routing), the :class:`~.controller.FleetController`
(scale out/in, drain lifecycle, rolling swaps), the
:class:`~..qos.brownout.QosGate` / ``BrownoutController`` ladder, and
each replica's :class:`~..qos.sched.QosQueue` — the simulator calls
their methods, it does not reimplement them.  The fault hooks inside
those code paths (``qos:invert`` in the weighted-fair pop,
``qos:flood`` in the gate's charge, ``swap:partial-fleet`` at the
roll's batch boundary) fire through the REAL ``faults.py`` plan.

**What is simulated:** wall time (a virtual clock the injected
``clock`` seams read), the wire (:class:`~.sim_replica.LocalClient`
through the router's ``client_factory`` seam), and the data plane —
token generation becomes a seeded lognormal latency draw
(:mod:`~.traces`).  Fault sites whose hooks live in code the simulator
does not drive (``serve:kill`` / ``migrate-*``, ``dcn:*``,
``swap:stall``) are interpreted by the simulator against the same
parsed fault plan — one grammar, two interpreters.

No threads, no wall-clock reads in the event loop: the same seed and
trace give a byte-identical event log (:meth:`FleetSim.event_log_text`).
"""

from __future__ import annotations

import heapq
import json
import random
from typing import Dict, List, Optional, Sequence, Tuple

from ... import faults as faults_mod
from ...obs import instrument as _obs
from ...utils.logging import get_logger
from ...utils.retry import RetryPolicy
from ..qos.brownout import MAX_LEVEL, BrownoutController, QosGate
from ..qos.policy import RequestShedError
from ..router import NoHealthyReplicasError, Router
from .controller import FleetController, ReplicaLauncher
from .sim_replica import SWAP_PULL_BYTES, LocalClient, SimReplica
from .traces import ReplicaProfile, SimRequest, load_profile

logger = get_logger(__name__)

# A request that cannot land after this many routing attempts is LOST —
# the invariant, not a quiet drop.  Generous: a full fleet bench clears
# within a few probation windows of retries.
MAX_ROUTE_ATTEMPTS = 60

_PCTS = (0.50, 0.99)


def _pct(samples: List[float], q: float) -> Optional[float]:
    if not samples:
        return None
    ordered = sorted(samples)
    return ordered[min(len(ordered) - 1,
                       int(q * (len(ordered) - 1) + 0.999))]


class InvariantBook:
    """The SLO invariant catalog as checkable properties: every check
    is counted, every violation recorded with the event context that
    produced it (the postmortem the replay contract re-derives)."""

    NAMES = ("never_shed_interactive", "no_ladder_oscillation",
             "bounded_directory_staleness", "no_migration_convoy",
             "swap_autoscaler_non_interference", "at_most_once",
             "no_lost_requests")

    def __init__(self) -> None:
        self.checks: Dict[str, int] = {n: 0 for n in self.NAMES}
        self.violations: List[dict] = []

    def check(self, name: str, ok: bool, t: float, **detail) -> bool:
        self.checks[name] += 1
        if not ok:
            self.violations.append(
                {"invariant": name, "t": round(t, 6), **detail})
        return ok

    def summary(self) -> dict:
        return {"checks": dict(self.checks),
                "checks_total": sum(self.checks.values()),
                "violations_total": len(self.violations),
                "violations": list(self.violations)}


class _SimLauncher(ReplicaLauncher):
    """The controller's deployment interface, backed by the sim."""

    def __init__(self, sim: "FleetSim") -> None:
        self._sim = sim

    def launch(self, role: str, host: Optional[str] = None):
        return self._sim._launch(role).spec

    def retire(self, name: str) -> None:
        self._sim._retire(name)


class FleetSim:
    """Seeded discrete-event simulation of one serving fleet."""

    def __init__(self, *, replicas: int = 4, seed: int = 0,
                 roles: Optional[Dict[str, int]] = None,
                 profile: Optional[ReplicaProfile] = None,
                 max_slots: int = 8,
                 queue_capacity: int = 64,
                 brownout_high: float = 0.75,
                 brownout_low: float = 0.25,
                 brownout_hold_s: float = 5.0,
                 slo_ttft_ms: float = 0.0,
                 strikes: int = 2,
                 probation_s: float = 10.0,
                 min_per_role: int = 1,
                 max_replicas: Optional[int] = None,
                 scale_out_queue: float = 4.0,
                 scale_out_ttft_ms: float = 0.0,
                 scale_in_idle_s: float = 30.0,
                 drain_deadline_s: float = 60.0,
                 control_period_s: float = 1.0,
                 oscillation_window_s: Optional[float] = None,
                 oscillation_bound: int = 2 * MAX_LEVEL + 2,
                 staleness_bound_s: Optional[float] = None,
                 convoy_bound: Optional[int] = None,
                 record_events: bool = True) -> None:
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self.profile = profile if profile is not None else load_profile()
        self.max_slots = int(max_slots)
        self.control_period_s = float(control_period_s)
        self.record_events = bool(record_events)
        # Invariant bounds: oscillation is judged over ten hold windows
        # (hysteresis permits at most one down-step per hold), a stale
        # directory route must die within two control rounds of the
        # invalidating event, and a decode target may absorb at most
        # two slots' worth of concurrent migrations.
        self.oscillation_window_s = float(
            oscillation_window_s if oscillation_window_s is not None
            else 10.0 * brownout_hold_s)
        self.oscillation_bound = int(oscillation_bound)
        self.staleness_bound_s = float(
            staleness_bound_s if staleness_bound_s is not None
            else 2.0 * control_period_s + 1.0)
        self.convoy_bound = int(convoy_bound if convoy_bound is not None
                                else 2 * max_slots)

        self._now = 0.0
        self._seq = 0
        self._heap: List[tuple] = []
        self.events: List[dict] = []
        self.invariants = InvariantBook()

        # --- the fleet -------------------------------------------------------
        self._weights_step = 1   # what a fresh launch deploys
        self._replicas: Dict[str, SimReplica] = {}
        self._retired: Dict[str, SimReplica] = {}
        self._role_seq: Dict[str, int] = {}
        role_counts = dict(roles) if roles else {"unified": int(replicas)}
        specs = []
        for role in sorted(role_counts):
            for _ in range(role_counts[role]):
                specs.append(self._launch(role, register=False).spec)
        self.has_roles = ("prefill" in role_counts
                         and "decode" in role_counts)

        # --- the REAL control-plane objects, under the virtual clock --------
        self.router = Router(
            specs, key=b"sim",
            retry_policy=RetryPolicy(attempts=1, base_delay_s=0.0,
                                     max_delay_s=0.0, jitter=0.0),
            strikes=strikes, probation_s=probation_s,
            clock=self.now,
            client_factory=lambda spec: LocalClient(self, spec.name))
        self.gate = QosGate(brownout=BrownoutController(
            queue_capacity=queue_capacity, high=brownout_high,
            low=brownout_low, hold_s=brownout_hold_s,
            slo_ttft_ms=slo_ttft_ms, clock=self.now))
        self.router.attach_qos(self.gate)
        self.controller = FleetController(
            self.router, _SimLauncher(self),
            min_per_role=min_per_role,
            max_replicas=(max_replicas if max_replicas is not None
                          else len(specs) + 8),
            scale_out_queue=scale_out_queue,
            scale_out_ttft_ms=scale_out_ttft_ms,
            scale_in_idle_s=scale_in_idle_s,
            drain_deadline_s=drain_deadline_s,
            stats_timeout_s=1.0, clock=self.now)

        # --- per-request bookkeeping ----------------------------------------
        self._key_of: Dict[str, tuple] = {}
        self._req_of: Dict[str, SimRequest] = {}
        self._attempts: Dict[str, int] = {}
        self._force_unified: set = set()
        self._outcome: Dict[str, str] = {}   # rid -> delivered|shed|expired
        self._delivered_at: Dict[str, float] = {}
        self._ttft_by_class: Dict[str, List[float]] = {}
        self._migrating_to: Dict[str, int] = {}
        self._level_transitions: List[Tuple[float, int, int]] = []
        self._last_level = 0
        self._pending_roll: Optional[dict] = None
        self._flood_seq = 0
        self._state_cache: Dict[str, object] = {}
        # Telemetry plane (attach_telemetry): the REAL obs/collector
        # objects, advanced by "collect" events on the virtual clock.
        self._telemetry = None
        self.alerts: List[dict] = []
        self._shed_interactive = 0
        self._drains_started = 0
        self._spiral_onset_t: Optional[float] = None
        self._convoy_skip: set = set()   # rids the control:convoy fault
        #   admitted WITHOUT a decode reservation (the pre-fix bug)
        self.counters: Dict[str, int] = {
            "arrivals": 0, "delivered": 0, "shed": 0, "expired": 0,
            "retries": 0, "kills": 0, "migrations_ok": 0,
            "migrations_failed": 0, "stale_directory_hits": 0,
            "duplicates_suppressed": 0, "faults_fired": 0,
            "scale_out": 0, "scale_in": 0,
        }

    # --- virtual clock (the seam the real objects read) ----------------------

    def now(self) -> float:
        return self._now

    # --- replica registry ----------------------------------------------------

    def _launch(self, role: str, register: bool = True) -> SimReplica:
        idx = self._role_seq.get(role, 0)
        self._role_seq[role] = idx + 1
        # A fresh launch deploys the fleet's CURRENT target step (the
        # launcher pulls from the checkpoint store) — scale-out during
        # a roll's convergence window must not look like divergence.
        rep = SimReplica(f"sim-{role}-{idx:04d}", role, self.profile,
                         self._rng.randrange(1 << 31),
                         max_slots=self.max_slots,
                         weights_version=self._weights_step)
        self._replicas[rep.name] = rep
        if register:
            self._log("launch", replica=rep.name, role=role)
        return rep

    def _retire(self, name: str) -> None:
        rep = self._replicas.pop(name, None)
        self._state_cache.pop(name, None)
        if rep is not None:
            rep.alive = False
            self._retired[name] = rep
            self._log("retire", replica=name)

    def live_replica(self, name: str) -> Optional[SimReplica]:
        """The transport's liveness lookup (None ⇒ ConnectionError up
        the stack — the closed socket of the simulation)."""
        rep = self._replicas.get(name)
        return rep if rep is not None and rep.alive else None

    def _router_state(self, name: str):
        """The router's ``_ReplicaState`` for ``name``, cached —
        ``Router._find`` is a linear scan, and the event loop touches
        replica state several times per request at 1000 replicas."""
        state = self._state_cache.get(name)
        if state is None or state.spec.name != name:
            state = self.router._find(name)
            if state is not None:
                self._state_cache[name] = state
        return state

    def _mirror_inflight(self, name: str, delta: int) -> None:
        """Keep the router's load view current: real traffic would move
        ``inflight`` inside ``Router.generate``; the sim's event-driven
        data plane mirrors it under the SAME lock."""
        state = self._router_state(name)
        if state is None:
            return
        with self.router._lock:
            state.inflight = max(0, state.inflight + delta)

    # --- event plumbing ------------------------------------------------------

    def _schedule(self, t: float, kind: str, **data) -> None:
        self._seq += 1
        heapq.heappush(self._heap, (max(t, self._now), self._seq, kind,
                                    data))

    def _log(self, kind: str, **fields) -> None:
        if self.record_events:
            self.events.append({"t": round(self._now, 6), "kind": kind,
                                **fields})

    def event_log_text(self) -> str:
        """The canonical serialization the determinism tests compare
        byte-for-byte."""
        return "\n".join(json.dumps(e, sort_keys=True)
                         for e in self.events)

    # --- fault interpretation (sim-side sites) -------------------------------

    def _consult_fault(self, site: str, modes: Tuple[str, ...]):
        """Consult the armed fault plan for a site whose real hook
        lives in code the sim does not drive — same clause grammar,
        counters, seeded RNG and firing history as the real hooks
        (``faults.py``); returns the clause when it fires."""
        plan = faults_mod._active
        if plan is None:
            return None
        st = plan.site(site)
        if st is None or (st.clause.mode or modes[0]) not in modes:
            return None
        at = st.counter
        if st.should_fire():
            mode = st.clause.mode or modes[0]
            plan.fire(site, mode, at)
            self.counters["faults_fired"] += 1
            self._log("fault", site=site, mode=mode, at=at)
            return st.clause
        return None

    # --- the run -------------------------------------------------------------

    def run(self, trace: Sequence[SimRequest], *,
            fault_spec: Optional[str] = None,
            swap_rolls: Sequence[Tuple[float, int]] = (),
            horizon_s: Optional[float] = None) -> dict:
        """Replay ``trace`` to completion (or ``horizon_s``); returns
        the report dict (metrics + invariant summary).  ``swap_rolls``
        schedules ``(virtual_time, step)`` rolling weight swaps;
        ``fault_spec`` arms the standard fault grammar for the run."""
        for req in trace:
            self._schedule(req.arrival_s, "arrive", req=req)
        horizon = float(horizon_s) if horizon_s is not None else (
            trace[-1].arrival_s + 120.0 if trace else 0.0)
        t_ctl = 0.0
        while t_ctl <= horizon:
            self._schedule(t_ctl, "control")
            t_ctl += self.control_period_s
        if self._telemetry is not None:
            # One collection round per plane period; scheduled AFTER
            # the control events at the same timestamp, so the
            # controller reads the PREVIOUS round (the production
            # ordering: the plane scrapes on its own cadence).
            t_col = self._telemetry.period_s
            while t_col <= horizon:
                self._schedule(t_col, "collect")
                t_col += self._telemetry.period_s
        for t_roll, step in swap_rolls:
            self._schedule(t_roll, "swap_roll", step=int(step))

        if fault_spec:
            with faults_mod.inject(fault_spec):
                self._drain_heap(horizon)
        else:
            self._drain_heap(horizon)
        report = self._report(horizon)
        _obs.on_sim_run(events=report["events"],
                        checks=report["invariants"]["checks_total"],
                        violations=report["invariants"]
                        ["violations_total"])
        return report

    def _drain_heap(self, horizon: float) -> None:
        handlers = {
            "arrive": self._on_arrive, "retry": self._on_retry,
            "dispatch": self._on_dispatch,
            "first_token": self._on_first_token,
            "finish": self._on_finish,
            "migrate_done": self._on_migrate_done,
            "control": self._on_control,
            "collect": self._on_collect,
            "swap_roll": self._on_swap_roll,
        }
        while self._heap:
            t, _, kind, data = heapq.heappop(self._heap)
            if t > horizon:
                break
            self._now = t
            handlers[kind](**data)

    # --- request lifecycle ---------------------------------------------------

    def _on_arrive(self, req: SimRequest) -> None:
        self.counters["arrivals"] += 1
        self._req_of[req.request_id] = req
        self._key_of[req.request_id] = self.router._prefix_key(req.prompt)
        # qos:flood — a synthetic burst of batch traffic from a flood
        # tenant (the gate's budget-waiver hook needs wall-clock token
        # buckets, which a deterministic sim cannot run; the sim's
        # interpretation of the same clause is the flood itself).
        if req.tenant != "flood" \
                and self._consult_fault("qos", ("flood",)) is not None:
            for _ in range(100):
                self._flood_seq += 1
                flood = SimRequest(
                    request_id=f"flood-{self._flood_seq:05d}",
                    arrival_s=self._now, tenant="flood",
                    qos_class="batch", prompt=req.prompt,
                    max_new_tokens=req.max_new_tokens, deadline=None)
                self._schedule(self._now, "arrive", req=flood)
        try:
            # The REAL gate: brownout shed (and the qos:flood fault's
            # budget waiver) fire inside this call.
            self.gate.admit(req.tenant, req.qos_class, 0.0)
        except RequestShedError:
            self.counters["shed"] += 1
            if req.qos_class == "interactive":
                self._shed_interactive += 1
            self._outcome[req.request_id] = "shed"
            self.invariants.check(
                "never_shed_interactive",
                req.qos_class != "interactive", self._now,
                request=req.request_id, qos_class=req.qos_class,
                level=self.gate.brownout.level)
            self._log("shed", request=req.request_id,
                      qos_class=req.qos_class)
            return
        self._route(req)

    def _on_retry(self, req: SimRequest) -> None:
        self.counters["retries"] += 1
        self._route(req)

    def _fail_over(self, req: SimRequest) -> None:
        attempt = self._attempts.get(req.request_id, 0) + 1
        self._attempts[req.request_id] = attempt
        if not self.invariants.check(
                "no_lost_requests", attempt <= MAX_ROUTE_ATTEMPTS,
                self._now, request=req.request_id, attempts=attempt):
            self._outcome[req.request_id] = "lost"
            self._log("lost", request=req.request_id)
            return
        # Deterministic capped backoff standing in for the router's
        # jittered RetryPolicy (jitter would break replay): quick first
        # sweeps, then probation-scale waits.
        delay = min(2.0, 0.02 * (1 << min(attempt, 7)))
        self._schedule(self._now + delay, "retry", req=req)

    def _route(self, req: SimRequest) -> None:
        rid = req.request_id
        key = self._key_of.get(rid)
        # 1. The real directory route (warm KV anywhere in the fleet).
        state = self.router._directory_pick(key)
        via = "directory"
        if state is not None:
            rep = self._replicas.get(state.spec.name)
            # Ground truth vs the directory's belief: a route to a
            # replica that no longer holds the blocks (flushed, killed,
            # retired) is STALE — tolerated briefly (it only costs a
            # cache miss or one failover), a violation once the
            # invalidation machinery has had two control rounds to
            # catch up.
            if rep is None or not rep.alive or key not in rep.resident:
                self.counters["stale_directory_hits"] += 1
                invalidated = rep.invalidated_at if rep is not None \
                    else None
                since = (self._now - invalidated
                         if invalidated is not None else 0.0)
                self.invariants.check(
                    "bounded_directory_staleness",
                    since <= self.staleness_bound_s, self._now,
                    request=rid, replica=state.spec.name,
                    stale_for_s=round(since, 3))
        # 2. The disaggregated pipeline when both role tiers are live.
        if state is None and self.has_roles \
                and rid not in self._force_unified:
            pre = self.router._pick_role("prefill")
            dec = self.router._pick_role("decode")
            if pre is not None and dec is not None:
                self._admit(req, pre.spec.name, via="pipeline",
                            decode_to=dec.spec.name)
                return
        # 3. The unified spread (and the recompute fallback).
        if state is None:
            try:
                state = self.router._pick(key)
                via = "spread"
            except NoHealthyReplicasError:
                self._log("no_healthy", request=rid)
                self._fail_over(req)
                return
        rep = self._replicas.get(state.spec.name)
        if rep is None or not rep.alive:
            # The pick landed on a dead replica (a half-open probe, or
            # a kill the router has not yet observed): strike it for
            # real — this is exactly the failover path — and re-route.
            self.router._strike(state, fatal=True)
            self._log("probe_dead", request=rid, replica=state.spec.name)
            self._fail_over(req)
            return
        self._admit(req, rep.name, via=via)

    def _admit(self, req: SimRequest, name: str, via: str,
               decode_to: Optional[str] = None) -> None:
        rep = self._replicas[name]
        rep.queue.push(req)          # the REAL WFQ admission
        self._mirror_inflight(name, +1)
        if decode_to is not None:
            # Mirror the router's migration reservation: the decode
            # target carries the inbound load from pick time, so
            # concurrent pipeline picks spread instead of convoying
            # into one receiver.  Released on migration failure /
            # expiry / kill; a successful adoption converts it into
            # the active count.  control:mode=convoy re-introduces the
            # pre-fix bug: the reservation is deferred to adoption
            # time, so concurrent picks all see the target as idle —
            # the exact convoy the telemetry plane's detector pages on.
            if self._consult_fault("control", ("convoy",)) is not None:
                self._convoy_skip.add(req.request_id)
            else:
                self._mirror_inflight(decode_to, +1)
        self._outcome.pop(req.request_id, None)
        rep.pipeline_to[req.request_id] = decode_to
        if via == "directory":
            _obs.on_fleet_directory_hit()
        self._log("admit", request=req.request_id, replica=name,
                  via=via)
        self._schedule(self._now, "dispatch", replica=name)

    def _on_dispatch(self, replica: str) -> None:
        rep = self._replicas.get(replica)
        if rep is None or not rep.alive:
            return
        # The real deadline machinery: expired queued work dies here.
        for dead in rep.queue.pop_expired(self._now):
            self.counters["expired"] += 1
            self._outcome[dead.request_id] = "expired"
            self._mirror_inflight(replica, -1)
            reserved = rep.pipeline_to.pop(dead.request_id, None)
            if reserved is not None \
                    and dead.request_id not in self._convoy_skip:
                self._mirror_inflight(reserved, -1)
            self._convoy_skip.discard(dead.request_id)
            self._log("expired", request=dead.request_id,
                      replica=replica)
        while rep.alive and len(rep.active) < rep.max_slots:
            req = rep.queue.pop()    # the REAL WFQ pop (qos:invert
            if req is None:          # fires inside, when armed)
                break
            # serve:kill — replica death at the dispatch boundary, the
            # batcher-step analog of the real site.
            if self._consult_fault("serve", ("kill",)) is not None:
                rep.active[req.request_id] = req
                self._kill(rep)
                return
            rep.active[req.request_id] = req
            ttft_ms = rep.sample_ttft_ms()
            self._schedule(self._now + ttft_ms / 1e3, "first_token",
                           replica=rep.name, epoch=rep.epoch,
                           rid=req.request_id, ttft_ms=ttft_ms)

    def _on_first_token(self, replica: str, epoch: int, rid: str,
                        ttft_ms: float) -> None:
        rep = self._replicas.get(replica)
        if rep is None or rep.epoch != epoch or rid not in rep.active:
            return   # stale: the replica died after scheduling this
        req = rep.active[rid]
        ttft = (self._now - req.arrival_s) * 1e3
        rep.record_ttft(req.qos_class, ttft)
        self._ttft_by_class.setdefault(req.qos_class, []).append(ttft)
        decode_to = rep.pipeline_to.get(rid)
        if decode_to is not None:
            self._start_migration(rep, req, decode_to)
            return
        self._schedule(
            self._now + rep.sample_decode_ms(req.max_new_tokens) / 1e3,
            "finish", replica=rep.name, epoch=epoch, rid=rid)

    def _on_finish(self, replica: str, epoch: int, rid: str) -> None:
        rep = self._replicas.get(replica)
        if rep is None or rep.epoch != epoch or rid not in rep.active:
            return
        req = rep.active.pop(rid)
        rep.pipeline_to.pop(rid, None)
        rep.completed += 1
        self._mirror_inflight(replica, -1)
        state = self._router_state(replica)
        key = self._key_of.get(rid)
        if state is not None:
            self.router._mark_ok(state)
            # The real directory learns the residency; the sim's ground
            # truth learns it too (the staleness oracle).
            self.router._note_affinity(key, state, rep.weights_version)
        if key is not None:
            rep.resident.add(key)
        self._deliver(req)
        self._schedule(self._now, "dispatch", replica=replica)

    def _deliver(self, req: SimRequest) -> None:
        rid = req.request_id
        dup = rid in self._delivered_at
        self.invariants.check("at_most_once", not dup, self._now,
                              request=rid)
        if dup:
            self.counters["duplicates_suppressed"] += 1
            return
        self._delivered_at[rid] = self._now
        self._outcome[rid] = "delivered"
        self.counters["delivered"] += 1
        self._log("deliver", request=rid)

    # --- disaggregated pipeline ----------------------------------------------

    def _start_migration(self, pre: SimReplica, req: SimRequest,
                         decode_to: str) -> None:
        rid = req.request_id
        ms = pre.sample_migrate_ms()
        ok = True
        clause = self._consult_fault(
            "serve", ("migrate-drop", "migrate-delay"))
        if clause is not None:
            if (clause.mode or "") == "migrate-drop":
                ok = False
            else:
                ms += max(0.0, clause.delay_ms)
        dcn = self._consult_fault("dcn", ("drop", "delay", "partition"))
        if dcn is not None:
            if (dcn.mode or "drop") in ("drop", "partition"):
                ok = False
            else:
                ms += max(0.0, dcn.delay_ms)
        conc = self._migrating_to.get(decode_to, 0) + 1
        self._migrating_to[decode_to] = conc
        self.invariants.check("no_migration_convoy",
                              conc <= self.convoy_bound, self._now,
                              decode=decode_to, concurrent=conc)
        self._log("migrate", request=rid, source=pre.name,
                  target=decode_to, ok=ok)
        self._schedule(self._now + ms / 1e3, "migrate_done",
                       pre=pre.name, epoch=pre.epoch, rid=rid,
                       decode_to=decode_to, ok=ok, ms=ms)

    def _on_migrate_done(self, pre: str, epoch: int, rid: str,
                         decode_to: str, ok: bool, ms: float) -> None:
        self._migrating_to[decode_to] = max(
            0, self._migrating_to.get(decode_to, 0) - 1)
        rep = self._replicas.get(pre)
        if rep is None or rep.epoch != epoch or rid not in rep.active:
            return   # prefill died mid-transfer: the kill path retried
        req = rep.active.pop(rid)
        rep.pipeline_to.pop(rid, None)
        self._mirror_inflight(pre, -1)
        _obs.on_fleet_migration(len(req.prompt) * 8, ok, ms)
        state = self._router_state(pre)
        dec = self._replicas.get(decode_to)
        key = self._key_of.get(rid)
        if not ok or dec is None or not dec.alive:
            self.counters["migrations_failed"] += 1
            rep.failed += 1
            if rid in self._convoy_skip:
                self._convoy_skip.discard(rid)   # never reserved
            else:
                self._mirror_inflight(decode_to, -1)   # drop the reservation
            # The router's semantics: a lost transfer recomputes on the
            # unified path — never wrong tokens, at worst one redundant
            # prefill.
            self._force_unified.add(rid)
            self._log("migrate_failed", request=rid, source=pre,
                      target=decode_to)
            self._fail_over(req)
            return
        self.counters["migrations_ok"] += 1
        rep.completed += 1
        if state is not None:
            self.router._mark_ok(state)
            self.router._note_affinity(key, state, rep.weights_version)
        if key is not None:
            rep.resident.add(key)
        # Decode adopts directly (the real adopt path bypasses the
        # admission queue); the reservation taken at pick time now
        # counts the adopted generation, so no further increment —
        # _on_finish releases it.  Under control:convoy the count only
        # appears NOW (too late for pick spread — the bug).
        if rid in self._convoy_skip:
            self._convoy_skip.discard(rid)
            self._mirror_inflight(decode_to, +1)
        dec.active[rid] = req
        dec.pipeline_to[rid] = None
        self._schedule(
            self._now + dec.sample_decode_ms(req.max_new_tokens) / 1e3,
            "finish", replica=decode_to, epoch=dec.epoch, rid=rid)

    # --- faults --------------------------------------------------------------

    def _kill(self, rep: SimReplica) -> None:
        self.counters["kills"] += 1
        rep.invalidated_at = self._now
        pipes = dict(rep.pipeline_to)   # kill() clears it
        orphans = rep.kill()
        self._log("kill", replica=rep.name, orphans=len(orphans))
        for req in orphans:
            self._mirror_inflight(rep.name, -1)
            reserved = pipes.get(req.request_id)
            if reserved is not None \
                    and req.request_id not in self._convoy_skip:
                self._mirror_inflight(reserved, -1)
            self._convoy_skip.discard(req.request_id)
            self._fail_over(req)

    # --- telemetry plane -----------------------------------------------------

    def attach_telemetry(self, *, slo_spec: Optional[str] = None,
                         period_s: Optional[float] = None,
                         stale_after_s: Optional[float] = None,
                         journal_path: Optional[str] = None,
                         detect_overrides: Optional[dict] = None):
        """Wire the live telemetry plane into the simulated fleet: the
        SAME :class:`~...obs.collector.FleetCollector` /
        ``SloBook`` / ``DetectorBook`` objects production runs, scraping
        through the ``LocalClient`` transport under the virtual clock
        (detectors proven against the REAL control plane at 1000
        replicas).  ``run``
        schedules one "collect" event per plane period; fired alerts
        land in the event log and ``self.alerts``.  The controller is
        re-pointed at the collector's rounds — one fleet fan-out per
        period, shared by scaling and alerting."""
        from ...obs.collector import (FleetCollector, Target,
                                      TelemetryPlane)

        period = float(period_s if period_s is not None
                       else self.control_period_s)
        collector = FleetCollector(
            lambda: [Target(name=name, role=rep.role)
                     for name, rep in sorted(self._replicas.items())],
            clock=self.now,
            client_factory=lambda tg: LocalClient(self, tg.name),
            timeout_s=1.0)
        overrides = {
            "convoy_bound": float(self.convoy_bound),
            "oscillation_bound": self.oscillation_bound,
            "oscillation_window_s": self.oscillation_window_s,
        }
        overrides.update(detect_overrides or {})
        self._telemetry = TelemetryPlane(
            collector, slo_spec=slo_spec,
            control_probe=self._control_probe, period_s=period,
            stale_after_s=(stale_after_s if stale_after_s is not None
                           else max(10.0, self.staleness_bound_s)),
            journal_path=journal_path, detect_overrides=overrides)
        self.controller._collector = collector
        return self._telemetry

    def _control_probe(self) -> dict:
        """The detector book's control-plane signals from the sim's
        own state (a production wiring reads the same fields off the
        router/controller/QoS gate — obs/detect.py module docstring).
        ``scale_in_total`` counts DRAIN starts: the drain is when
        capacity leaves the load balancer, which is the round the
        death-spiral signature must be caught in."""
        return {
            "brownout_level": self.gate.brownout.level,
            "scale_in_total": self._drains_started,
            "shed_interactive_total": self._shed_interactive,
            "swap_target_version": self._weights_step,
            "directory_replicas": self.router._directory.replicas(),
        }

    def _on_collect(self) -> None:
        # One plane round on the virtual clock: scrape (serial through
        # LocalClient — deterministic), SLO burn rates, detectors,
        # alert edges.
        if self._telemetry is None:
            return
        for alert in self._telemetry.run_round(now=self._now):
            self.alerts.append(alert)
            self._log("alert", alert=alert["alert"],
                      severity=alert["severity"])

    # --- control plane -------------------------------------------------------

    def _on_control(self) -> None:
        # The REAL policy loop: serial stats through the LocalClient
        # transport, brownout observe, scale out/in, drain completion.
        actions = self.controller.poll_once(now=self._now)
        level = self.gate.brownout.level
        if level != self._last_level:
            self._level_transitions.append(
                (self._now, self._last_level, level))
            self._last_level = level
            window = [tr for tr in self._level_transitions
                      if tr[0] > self._now - self.oscillation_window_s]
            self.invariants.check(
                "no_ladder_oscillation",
                len(window) <= self.oscillation_bound, self._now,
                transitions_in_window=len(window),
                window_s=self.oscillation_window_s)
            self._log("brownout", level=level)
        for action in actions:
            self._log("scale", **action)
            if action["action"] == "scale_out":
                self.counters["scale_out"] += 1
            elif action["action"] == "drain":
                self._drains_started += 1
                # Ground truth for the death-spiral drill: the first
                # drain issued while the ladder sheds is the onset the
                # ladder_oscillation detector races against.
                if level > 0 and self._spiral_onset_t is None:
                    self._spiral_onset_t = self._now
            elif action["action"] == "retire":
                self.counters["scale_in"] += 1
            if self._pending_roll is not None \
                    and action["action"] in ("drain", "retire"):
                # Interference: the autoscaler shrank the fleet while a
                # swap roll was still converging.
                self._pending_roll["scale_in_during_roll"] += 1
        self._check_roll_convergence()

    def _on_swap_roll(self, step: int) -> None:
        self._weights_step = int(step)
        # max_concurrent=1 serializes the roll's worker threads — the
        # only thread use in a sim run, one at a time and joined before
        # the next, so the event log stays deterministic.  The
        # swap:partial-fleet fault fires inside the REAL roll_swap.
        outcomes = self.controller.roll_swap(step, max_concurrent=1,
                                             timeout=5.0)
        ok = sum(1 for o in outcomes if o.get("ok"))
        aborted = any(o.get("skipped") for o in outcomes)
        self._log("swap_roll", step=step, ok=ok, total=len(outcomes),
                  aborted=aborted)
        self._pending_roll = {
            "step": step, "t": self._now, "aborted": aborted,
            # Only replicas whose swap SUCCEEDED owe convergence: a
            # stalled/failed pull keeps old weights by design, and the
            # version-matched routing rule keeps the mixed fleet
            # correct.
            "flipped": [o["replica"] for o in outcomes if o.get("ok")],
            "scale_in_during_roll": 0,
            "deadline": self._now + 3.0 * self.control_period_s}

    def swap_replica_sim(self, rep: SimReplica, step: int, *,
                         rollback: bool = False):
        """The transport's swap handler: sampled pull+flip latency,
        ``swap:stall`` interpreted as virtual delay (the real hook
        sleeps — a sim must not), KV flushed on flip so the directory's
        version rule is exercised for real."""
        from types import SimpleNamespace
        ms = rep.sample_swap_ms()
        clause = self._consult_fault("swap", ("stall",))
        if clause is not None:
            # The real hook wall-sleeps ``delay_ms`` inside the pull;
            # the sim interprets the same clause as virtual delay past
            # the pull deadline — abandoned, old weights keep serving
            # (serve/swap.py semantics).
            self._log("swap_stalled", replica=rep.name, step=step)
            return SimpleNamespace(
                error="pull_stalled_past_deadline",
                weights_version=rep.weights_version,
                swap_ms=None, pulled_bytes=0)
        rep.weights_version = int(step)
        rep.flush_kv()
        rep.invalidated_at = self._now
        self._log("swap", replica=rep.name, step=step,
                  rollback=rollback)
        return SimpleNamespace(error=None, weights_version=int(step),
                               swap_ms=ms,
                               pulled_bytes=SWAP_PULL_BYTES)

    def _check_roll_convergence(self) -> None:
        roll = self._pending_roll
        if roll is None or self._now < roll["deadline"]:
            return
        self._pending_roll = None
        if roll["aborted"]:
            return   # a fault-aborted roll converges by design later
        converged = all(
            rep.weights_version == roll["step"]
            for rep in (self._replicas.get(name)
                        for name in roll["flipped"])
            if rep is not None and rep.alive and not rep.draining)
        self.invariants.check(
            "swap_autoscaler_non_interference",
            converged and roll["scale_in_during_roll"] == 0, self._now,
            step=roll["step"], converged=converged,
            scale_in_during_roll=roll["scale_in_during_roll"])

    # --- reporting -----------------------------------------------------------

    def _report(self, horizon: float) -> dict:
        # Requests with no terminal outcome at the horizon are still in
        # flight (queued/active/retrying) — legitimate for an open-loop
        # trace cut off mid-stream, and reported so the bench can bound
        # it; a VANISHED request would have tripped no_lost_requests.
        unresolved = sum(1 for rid in self._req_of
                         if rid not in self._outcome)
        ttft = {}
        for cls, samples in sorted(self._ttft_by_class.items()):
            ttft[f"{cls}_ttft_ms_p50"] = _pct(samples, 0.50)
            ttft[f"{cls}_ttft_ms_p99"] = _pct(samples, 0.99)
        all_samples = [s for v in self._ttft_by_class.values()
                       for s in v]
        report = {
            "horizon_s": horizon,
            "replicas_final": len(self._replicas),
            "events": len(self.events) if self.record_events
            else self._seq,
            "requests": self.counters["arrivals"],
            "in_flight_at_horizon": unresolved,
            "ttft_ms_p50": _pct(all_samples, 0.50),
            "ttft_ms_p99": _pct(all_samples, 0.99),
            **ttft,
            **{k: v for k, v in self.counters.items()
               if k != "arrivals"},
            "brownout_level_max": max(
                [tr[2] for tr in self._level_transitions], default=0),
            "level_transitions": len(self._level_transitions),
            "invariants": self.invariants.summary(),
        }
        if self._spiral_onset_t is not None:
            report["spiral_onset_t"] = round(self._spiral_onset_t, 6)
        if self._telemetry is not None:
            report["alerts_fired"] = len(self.alerts)
            report["alerts"] = [
                {"alert": a["alert"], "t": round(a["t"], 6),
                 "severity": a["severity"]} for a in self.alerts]
        return report
