"""Elastic fleet autoscaling: per-role replica counts from live load.

Counterpart of ``horovod_tpu/serve/fleet/controller.py``.

The control loop above the router: each :meth:`FleetController.
poll_once` snapshots every replica's serving stats (queue depth, slot
occupancy, TTFT p99 — the ``obs``-derived signals ``ServingStats``
aggregates) and drives per-role replica counts:

* **scale out** — a role whose replicas' mean queue depth exceeds
  ``HVD_TPU_FLEET_SCALE_OUT_QUEUE`` (or whose p99 TTFT exceeds
  ``HVD_TPU_FLEET_SCALE_OUT_TTFT_MS``, when set) is saturated: the
  controller asks its :class:`ReplicaLauncher` for a new replica of
  that role (placement rides the ``elastic/`` ``HostDiscovery``
  machinery: an :class:`~...elastic.driver.ElasticDriver`
  supplies discovered, non-blacklisted hosts and the controller
  reserves a slot there) and registers it with the router.
* **drain-and-retire** — a role idle (no queued or in-flight work on
  any replica) for ``HVD_TPU_FLEET_SCALE_IN_IDLE_S`` shrinks by one:
  the victim stops admitting (``DrainRequest`` → ``draining`` on the
  wire, so the router shifts load), finishes its in-flight requests,
  releases its directory entries, and only then retires —
  ``HVD_TPU_FLEET_DRAIN_DEADLINE_S`` bounds a wedged drain.

Prefill and decode replicas scale independently — prefill is
compute-bound, decode is memory-bound, so a bursty prompt-heavy load
grows the prefill tier while a long-generation load grows decode
(the role-heterogeneous economics the disaggregation exists for).

``scale_out`` / ``drain_and_retire`` are public: chaos drills and
operators force cycles directly; ``poll_once`` is the policy loop that
calls them.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from ... import faults as faults_mod
from ...obs import flight as flight_mod
from ...obs import instrument as _obs
from ...utils.logging import get_logger
from ..engine import resolved_config

logger = get_logger(__name__)

ROLES = ("prefill", "decode", "unified")


def _interactive_p99(entry: dict) -> Optional[float]:
    """Interactive-class p99 TTFT from one replica's stats snapshot
    (None before that class completed anything there)."""
    return (entry["stats"].get("qos", {}).get("interactive", {})
            .get("ttft_ms_p99"))


class ReplicaLauncher:
    """Deployment interface the controller scales through: ``launch``
    brings up one replica of ``role`` (on ``host`` when placement is
    driven by discovery) and returns its router
    :class:`~..router.ReplicaSpec`; ``retire`` tears
    one down AFTER its drain completed."""

    def launch(self, role: str, host: Optional[str] = None):
        raise NotImplementedError

    def retire(self, name: str) -> None:
        raise NotImplementedError


class FleetController:
    """Per-role elastic scaling over one router + launcher."""

    def __init__(self, router, launcher: ReplicaLauncher, *,
                 driver=None, min_per_role: int = 1,
                 max_replicas: int = 16,
                 scale_out_queue: Optional[float] = None,
                 scale_out_ttft_ms: Optional[float] = None,
                 scale_in_idle_s: Optional[float] = None,
                 drain_deadline_s: Optional[float] = None,
                 stats_timeout_s: float = 2.0,
                 qos_gate=None, clock=None, collector=None) -> None:
        cfg = resolved_config()
        self._router = router
        self._launcher = launcher
        # Optional obs/collector.FleetCollector: when wired, poll_once
        # reads the telemetry plane's last scrape round instead of
        # issuing its own StatsRequest fan-out — one scrape path serves
        # both alerting and scaling, and a wedged fleet costs ONE
        # timeout per collection round rather than one per consumer.
        self._collector = collector
        # Injectable monotonic clock: drain timers, idle clocks and
        # swap-roll deadlines read THIS so the fleet simulator
        # (serve/fleet/sim.py) can run the policy loop under virtual
        # time; default is the real clock — behavior unchanged.
        self._clock = clock if clock is not None else time.monotonic
        self._driver = driver   # elastic ElasticDriver (placement), optional
        self.min_per_role = int(min_per_role)
        self.max_replicas = int(max_replicas)
        self.scale_out_queue = float(
            scale_out_queue if scale_out_queue is not None
            else cfg.fleet_scale_out_queue)
        self.scale_out_ttft_ms = float(
            scale_out_ttft_ms if scale_out_ttft_ms is not None
            else cfg.fleet_scale_out_ttft_ms)
        self.scale_in_idle_s = float(
            scale_in_idle_s if scale_in_idle_s is not None
            else cfg.fleet_scale_in_idle_s)
        self.drain_deadline_s = float(
            drain_deadline_s if drain_deadline_s is not None
            else cfg.fleet_drain_deadline_s)
        self.stats_timeout_s = float(stats_timeout_s)
        # QoS brownout (serve/qos/brownout.py): the controller feeds
        # the router's shed ladder the SAME signals it scales on —
        # fleet-mean queue depth and interactive p99 TTFT.  None when
        # the router runs ungated (falls back to the router's own gate
        # so one wiring suffices).
        self._qos_gate = (qos_gate if qos_gate is not None
                          else getattr(router, "qos_gate", None))
        self._lock = threading.Lock()
        self._draining: Dict[str, float] = {}   # name -> drain start  guarded-by: _lock
        self._placement: Dict[str, str] = {}    # name -> reserved host  guarded-by: _lock
        self._idle_since: Dict[str, float] = {}  # role -> first idle ts  guarded-by: _lock
        self._seq = 0                           # guarded-by: _lock
        self.events: List[dict] = []            # guarded-by: _lock (bounded action log)

    # --- forced actions (the policy loop calls these; drills may too) -------

    def scale_out(self, role: str) -> Optional[object]:
        """Launch + register one ``role`` replica; returns its spec, or
        None when no placement capacity exists."""
        if role not in ROLES:
            raise ValueError(f"unknown role {role!r}; expected one of "
                             f"{ROLES}")
        host = None
        if self._driver is not None:
            host = self._driver.reserve_slot()
            if host is None:
                logger.warning("scale-out of %s declined: no discovered "
                               "host has free capacity", role)
                return None
        try:
            spec = self._launcher.launch(role, host)
        except Exception:
            if self._driver is not None and host is not None:
                self._driver.release_slot(host)
            raise
        self._router.add_replica(spec)
        with self._lock:
            if host is not None:
                self._placement[spec.name] = host
            self._log_locked("scale_out", role=role, replica=spec.name,
                             host=host)
        _obs.on_fleet_scale_event("out")
        logger.info("fleet scale-out: +%s (%s%s)", spec.name, role,
                    f" on {host}" if host else "")
        return spec

    def drain_and_retire(self, name: str) -> None:
        """Begin the drain-and-retire lifecycle for replica ``name``:
        stop admitting now; the retire completes on a later
        :meth:`poll_once` once in-flight work finished (or the drain
        deadline passed)."""
        self._router.drain_replica(name)
        with self._lock:
            self._draining.setdefault(name, self._clock())
            self._log_locked("drain", replica=name)
        logger.info("fleet drain started: %s", name)

    # --- zero-downtime weight hot-swap (serve/swap.py; docs/hot_swap.md) ----

    def roll_swap(self, step: int, *, rollback: bool = False,
                  max_concurrent: Optional[int] = None,
                  timeout: float = 120.0) -> List[dict]:
        """Rolling fleet swap: tell every replica to hot-swap (or roll
        back) to ``step``, at most ``HVD_TPU_SWAP_MAX_CONCURRENT``
        flipping at once — the rest keep serving the OLD weights, so
        fleet capacity never drops below ``N - max_concurrent`` replicas
        mid-deployment.  Returns one outcome row per replica:
        ``{replica, ok, error, weights_version, swap_ms,
        pulled_bytes}``.

        A per-replica failure (rejected pull, abandoned stall, wire
        death) is recorded and the roll CONTINUES — the fleet converges
        as far as it can, and the version-matched routing rule keeps a
        mixed fleet correct.  The ``swap:mode=partial-fleet`` fault
        fires at each replica boundary and aborts the remainder of the
        roll — the deliberately-mixed-fleet drill."""
        cfg = resolved_config()
        bound = max(1, int(max_concurrent if max_concurrent is not None
                           else cfg.swap_max_concurrent))
        names = self._router.replica_names()
        outcomes: List[dict] = []
        aborted = False
        for i in range(0, len(names), bound):
            batch = names[i:i + bound]
            if faults_mod._active is not None and faults_mod.on_swap_roll():
                aborted = True
                flight_mod.record("swap_roll_aborted", step=int(step),
                                  done=len(outcomes),
                                  remaining=len(names) - len(outcomes))
                logger.warning(
                    "rolling swap to step %d aborted before %s "
                    "(partial fleet: %d/%d replicas flipped)", step,
                    batch, len(outcomes), len(names))
                break
            holders = [dict() for _ in batch]

            def swap_one(name: str, holder: dict) -> None:
                try:
                    resp = self._router.swap_replica(
                        name, step, rollback=rollback, timeout=timeout)
                    holder.update(
                        ok=resp.error is None, error=resp.error,
                        weights_version=resp.weights_version,
                        swap_ms=resp.swap_ms,
                        pulled_bytes=resp.pulled_bytes)
                except Exception as e:   # wire death / unknown replica
                    holder.update(ok=False, error=str(e),
                                  weights_version=None, swap_ms=None,
                                  pulled_bytes=0)

            threads = [threading.Thread(target=swap_one,
                                        args=(name, holder), daemon=True,
                                        name=f"swap-{name}")
                       for name, holder in zip(batch, holders)]
            for t in threads:
                t.start()
            # ONE deadline for the whole batch: hung replicas must not
            # serially stack a full timeout each.
            batch_deadline = self._clock() + timeout + 10.0
            for t in threads:
                t.join(timeout=max(0.0,
                                   batch_deadline - self._clock()))
            for name, holder in zip(batch, holders):
                if not holder:
                    holder.update(ok=False,
                                  error="swap_hung_past_timeout",
                                  weights_version=None, swap_ms=None,
                                  pulled_bytes=0)
                outcomes.append(dict(holder, replica=name))
        for name in names[len(outcomes):]:
            outcomes.append({"replica": name, "ok": False,
                             "error": "roll_aborted", "skipped": True,
                             "weights_version": None, "swap_ms": None,
                             "pulled_bytes": 0})
        with self._lock:
            self._log_locked("rollback" if rollback else "swap",
                             step=int(step),
                             ok=sum(1 for o in outcomes if o["ok"]),
                             total=len(outcomes), aborted=aborted)
        return outcomes

    def rollback(self, step: int, *,
                 max_concurrent: Optional[int] = None,
                 timeout: float = 120.0) -> List[dict]:
        """Fleet-wide instant rollback: re-point every replica at a
        journaled ``step`` through the same staged-flip path (the
        ``RollbackRequest`` wire frame)."""
        return self.roll_swap(step, rollback=True,
                              max_concurrent=max_concurrent,
                              timeout=timeout)

    # --- policy loop --------------------------------------------------------

    def poll_once(self, now: Optional[float] = None,
                  stats: Optional[Dict[str, dict]] = None) -> List[dict]:
        """One control round; returns the actions taken (for logs and
        drills).  Cheap by construction: the stats snapshot polls
        replicas concurrently under one deadline — or, when a
        telemetry-plane collector is wired, reuses ITS last round so
        the fleet is scraped once per period, not once per consumer.
        A stale collector round (older than the stats timeout plus one
        collect period) falls back to a direct poll: scaling on old
        numbers re-creates the exact oscillations the detectors page
        on."""
        now = self._clock() if now is None else now
        if stats is None and self._collector is not None:
            max_age = self.stats_timeout_s + float(
                getattr(self._collector, "timeout_s", 0.0))
            stats = self._collector.latest_stats(max_age_s=max_age,
                                                 now=now)
        if stats is None:
            stats = self._router.replica_stats(
                timeout=self.stats_timeout_s)
        actions: List[dict] = []
        self._feed_brownout(stats, now)
        # Brownout counts as fleet-wide busyness (a simulator-found
        # death spiral, pinned by tests/test_fleet_sim.py): at level >
        # 0 the ladder is actively hiding demand — queues look calm
        # precisely BECAUSE traffic is being shed, so an "idle" role is
        # an artifact of the shed, not spare capacity.  Scaling in here
        # shrinks the fleet the un-shed backlog is about to re-flood,
        # re-tripping the ladder: shed → scale-in → overload → shed,
        # forever.  While the ladder is up no role's idle clock runs.
        shed_active = bool(getattr(
            getattr(self._qos_gate, "brownout", None), "level", 0))
        if faults_mod._active is not None \
                and faults_mod.on_control("spiral"):
            # Fault site "control:mode=spiral": run this round with the
            # pre-fix policy (idle clocks tick during a shed) so the
            # telemetry plane's ladder-oscillation detector can be
            # proven against the REAL controller re-entering the death
            # spiral — not against a synthetic trace.
            shed_active = False
        actions += self._finish_drains(stats, now)
        by_role: Dict[str, List[dict]] = {}
        with self._lock:
            draining = set(self._draining)
        for name, entry in stats.items():
            if name in draining or entry.get("draining"):
                continue
            by_role.setdefault(entry.get("role", "unified"),
                               []).append(entry)
        total = sum(len(v) for v in by_role.values()) + len(draining)
        for role in sorted(by_role):
            entries = by_role[role]
            live = [e for e in entries if "stats" in e]
            occ = [e["stats"]["active_slots"] / max(1, e["stats"]
                                                    ["max_slots"])
                   for e in live]
            _obs.on_fleet_role_occupancy(
                role, sum(occ) / len(occ) if occ else 0.0, len(entries))
            if not live:
                continue
            queues = [e["stats"]["queue_depth"] for e in live]
            ttfts = [e["stats"].get("ttft_ms_p99") for e in live]
            ttfts = [t for t in ttfts if t is not None]
            # Per-class scale signal (serve/qos/): the INTERACTIVE tail
            # triggers scale-out on its own — a batch-dominated
            # aggregate can look calm while the SLO class is drowning,
            # and capacity (not shedding) is the right first answer.
            ittfts = [_interactive_p99(e) for e in live]
            ittfts = [t for t in ittfts if t is not None]
            saturated = (sum(queues) / len(queues) > self.scale_out_queue
                         or (self.scale_out_ttft_ms > 0 and ttfts
                             and max(ttfts) > self.scale_out_ttft_ms)
                         or (self.scale_out_ttft_ms > 0 and ittfts
                             and max(ittfts) > self.scale_out_ttft_ms))
            busy = (shed_active
                    or any(q > 0 or e["stats"]["active_slots"] > 0
                           for q, e in zip(queues, live)))
            with self._lock:
                if busy:
                    self._idle_since.pop(role, None)
                else:
                    self._idle_since.setdefault(role, now)
                idle_for = (now - self._idle_since[role]
                            if role in self._idle_since else 0.0)
            if saturated and total < self.max_replicas:
                spec = self.scale_out(role)
                if spec is not None:
                    total += 1
                    actions.append({"action": "scale_out", "role": role,
                                    "replica": spec.name})
            elif (not busy and idle_for >= self.scale_in_idle_s
                  and len(entries) > self.min_per_role):
                victim = entries[-1]["name"]
                self.drain_and_retire(victim)
                actions.append({"action": "drain", "role": role,
                                "replica": victim})
        return actions

    def _feed_brownout(self, stats: Dict[str, dict],
                       now: float) -> None:
        """Feed the QoS gate's brownout ladder one control round's
        signals: fleet-mean queue depth and the worst interactive p99
        TTFT — the same obs-derived numbers the scale policy reads."""
        if self._qos_gate is None:
            return
        live = [e for e in stats.values() if "stats" in e]
        if not live:
            return
        queues = [e["stats"]["queue_depth"] for e in live]
        ittfts = [_interactive_p99(e) for e in live]
        ittfts = [t for t in ittfts if t is not None]
        self._qos_gate.observe(sum(queues) / len(queues),
                               max(ittfts) if ittfts else None, now=now)

    def _finish_drains(self, stats: Dict[str, dict],
                       now: float) -> List[dict]:
        """Retire every draining replica whose in-flight work finished
        (or whose drain deadline passed — a wedged replica must not
        block the scale-in forever)."""
        actions = []
        with self._lock:
            draining = dict(self._draining)
        for name, started in draining.items():
            entry = stats.get(name)
            if entry is None:
                idle = True    # already deregistered: nothing to wait on
            elif "stats" in entry:
                idle = (entry["stats"]["queue_depth"] == 0
                        and entry["stats"]["active_slots"] == 0)
            else:
                # Unreachable THIS poll (stats_error/timeout) is not
                # evidence the drain ran dry — a transient blip must
                # not retire a replica with work in flight; only the
                # drain deadline may force that.
                idle = False
            expired = now - started > self.drain_deadline_s
            if not (idle or expired):
                continue
            if expired and not idle:
                logger.warning("drain deadline passed for %s; forcing "
                               "retire with work in flight", name)
            try:
                self._router.remove_replica(name)
            except ValueError as e:
                # The router refuses to drop its last replica; a wedged
                # draining entry must not poison every later control
                # round — clear it, UN-drain the replica (left draining
                # it would refuse work forever with no peers to carry
                # it), and keep it registered.
                logger.error("cannot retire %s (%s); abandoning the "
                             "drain and re-admitting", name, e)
                self._router.undrain_replica(name)
                with self._lock:
                    self._draining.pop(name, None)
                continue
            try:
                self._launcher.retire(name)
            except Exception:
                logger.exception("launcher failed to retire %s", name)
            with self._lock:
                self._draining.pop(name, None)
                host = self._placement.pop(name, None)
                self._log_locked("retire", replica=name, forced=expired)
            if self._driver is not None and host is not None:
                self._driver.release_slot(host)
            _obs.on_fleet_scale_event("in")
            logger.info("fleet scale-in: -%s%s", name,
                        " (forced)" if expired else "")
            actions.append({"action": "retire", "replica": name,
                            "forced": expired})
        return actions

    def draining(self) -> List[str]:
        with self._lock:
            return sorted(self._draining)

    def _log_locked(self, action: str, **kw) -> None:
        self._seq += 1  # hvdlint: disable=unguarded-mutation -- _locked suffix contract: every caller holds _lock
        self.events.append({"seq": self._seq, "action": action, **kw})  # hvdlint: disable=unguarded-mutation -- _locked suffix contract: every caller holds _lock
        del self.events[:-256]  # hvdlint: disable=unguarded-mutation -- _locked suffix contract: every caller holds _lock
