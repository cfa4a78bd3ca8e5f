"""Fleet telemetry collector: one scrape loop over every replica.

Counterpart of ``horovod_tpu/obs/collector.py`` (host Python, no device
work), under the reference's names.

The serving stack already exposes everything a fleet health view
needs — ``StatsRequest`` (queue depth, slot occupancy, per-class TTFT,
weights version) and ``MetricsRequest`` (the whole registry) answered
by every replica over the runner's HMAC control plane.  What was
missing is the loop that reads them ON A CADENCE and keeps history:
this module's :class:`FleetCollector` scrapes the roster every round
into a bounded :class:`~.timeseries.RingTSDB`, and
:class:`TelemetryPlane` composes it with the SLO burn-rate evaluator
(:mod:`~.slo`) and the online invariant detectors
(:mod:`~.detect`) into the one-call-per-round plane the
fleet controller reads (the chaos sim and ``scripts/fleet_top.py``
share it in the reference; neither is ported yet).

Scrape discipline (the ``Router.replica_stats`` contract, restated):

* replicas are scraped CONCURRENTLY under **one shared deadline** — a
  wedged replica costs the round one timeout, not one each (at 1000
  replicas, serial timeouts would stall the plane for minutes);
* scrape threads write into private holders, never the returned
  snapshot — a thread that outlives the deadline must not mutate what
  the caller is already reading;
* with a ``client_factory`` (the sim's in-process transport) the
  scrape runs serially: the "wire" is a deterministic method call, and
  thread interleaving would only cost reproducibility;
* ``clock=`` is injected everywhere — the SAME collector runs against
  ``serve/fleet/sim.py``'s virtual clock at 1000 replicas and against
  wall time in production;
* the collector DEGRADES, never stalls: a dead replica becomes a
  ``stats_error`` entry and a staleness gauge
  (``hvd_tpu_collect_staleness_seconds``), and the ``collect`` fault
  site (drop/delay/garbage — ``faults.on_collect``) drills exactly
  that path.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .timeseries import RingTSDB
from ..utils.logging import get_logger

logger = get_logger(__name__)

__all__ = ["Target", "FleetCollector", "TelemetryPlane", "scrape_fleet",
           "parse_targets"]


@dataclasses.dataclass(frozen=True)
class Target:
    """One scrape target: a replica's name and control-plane address
    (``addresses`` unused under a ``client_factory`` transport)."""

    name: str
    addresses: Tuple[Tuple[str, int], ...] = ()
    role: str = "unified"


def parse_targets(spec: str) -> List[Target]:
    """``HOST:PORT,HOST:PORT,...`` → targets named by address (the
    ``metrics_dump --fleet`` / ``fleet_top`` CLI form)."""
    out: List[Target] = []
    for raw in spec.split(","):
        raw = raw.strip()
        if not raw:
            continue
        host, sep, port = raw.rpartition(":")
        if not sep or not port.isdigit():
            raise ValueError(
                f"fleet target {raw!r}: expected HOST:PORT")
        out.append(Target(name=raw,
                          addresses=(((host or "127.0.0.1"), int(port)),)))
    return out


def _stats_error(stats: Any) -> Optional[str]:
    """Reject a payload the TSDB/detectors must never ingest: the
    ``collect:mode=garbage`` drill and any wire-corrupted answer.  The
    required numeric fields are the ones every replica's stats endpoint
    serves (``serve/metrics.py`` / ``sim_replica.stats``)."""
    if not isinstance(stats, dict):
        return f"garbage stats payload ({type(stats).__name__})"
    for field in ("queue_depth", "active_slots"):
        v = stats.get(field)
        if v is not None and not isinstance(v, (int, float)):
            return f"garbage stats field {field}={v!r}"
    return None


class FleetCollector:
    """Scrape the fleet roster on demand into a ring TSDB.

    ``targets`` is a callable returning the CURRENT roster (an elastic
    fleet's roster changes under the collector; a static list is
    wrapped) of objects with ``.name`` (+ optional ``.role`` /
    ``.addresses``).  ``client_factory`` swaps the transport (the sim's
    ``LocalClient``); without one, each scrape opens a probe-less
    :class:`~..runner.common.network.BasicClient` against the
    target's addresses with ``key`` (the launcher-minted HMAC secret).
    """

    def __init__(self, targets, *, key: Optional[bytes] = None,
                 clock: Callable[[], float] = time.monotonic,
                 client_factory: Optional[Callable[[Any], Any]] = None,
                 timeout_s: float = 1.0,
                 tsdb: Optional[RingTSDB] = None,
                 points: int = 512) -> None:
        self._targets = targets if callable(targets) else (lambda: targets)
        self._key = key
        self._clock = clock
        self._client_factory = client_factory
        self.timeout_s = float(timeout_s)
        self.tsdb = tsdb if tsdb is not None else RingTSDB(points=points)
        self._lock = threading.Lock()
        self._last_round: Optional[Dict[str, dict]] = None  # guarded-by: _lock
        self._last_round_t: Optional[float] = None          # guarded-by: _lock
        self._last_data_t: Optional[float] = None           # guarded-by: _lock
        self._last_ok: Dict[str, float] = {}                # guarded-by: _lock
        self._first_seen: Dict[str, float] = {}             # guarded-by: _lock
        self.rounds = 0                                     # guarded-by: _lock
        self.scrapes_ok = 0                                 # guarded-by: _lock
        self.scrapes_failed = 0                             # guarded-by: _lock

    # --- one replica ---------------------------------------------------------

    def _client(self, target):
        if self._client_factory is not None:
            return self._client_factory(target)
        from ..runner.common.network import BasicClient

        # probe=False: the scrape request IS the probe — a blocking
        # ping against a dead replica would spend the whole probe
        # timeout before the round's shared deadline even starts.
        return BasicClient(None, [tuple(a) for a in target.addresses],
                           self._key or b"", probe_timeout=self.timeout_s,
                           probe=False)

    def _scrape_one(self, target) -> Dict[str, Any]:
        from .. import faults as faults_mod
        from ..serve.server import StatsRequest

        holder: Dict[str, Any] = {}
        garbage = None
        try:
            if faults_mod._active is not None:
                # Site "collect": drop raises here (scrape-dead replica),
                # delay sleeps inside the round's shared deadline,
                # garbage poisons the payload below.
                garbage = faults_mod.on_collect(target.name)
            resp = self._client(target).request(
                StatsRequest(), idempotent=False, timeout=self.timeout_s)
            stats = getattr(resp, "stats", None)
            if garbage == "garbage":
                stats = "<garbage>"
            err = _stats_error(stats)
            if err is not None:
                holder["stats_error"] = err
            else:
                holder["stats"] = stats
        except (OSError, ValueError) as e:
            holder["stats_error"] = str(e) or type(e).__name__
        return holder

    # --- one round -----------------------------------------------------------

    def scrape_round(self, now: Optional[float] = None) -> Dict[str, dict]:
        """Scrape the current roster once; returns the
        ``Router.replica_stats``-shaped snapshot (``{name: {"name",
        "role", "stats"|"stats_error"}}``) and lands every signal in
        the TSDB stamped at ``now`` (the owner's clock when omitted)."""
        t_round = self._clock() if now is None else float(now)
        targets = list(self._targets())
        entries: List[Dict[str, Any]] = [
            {"name": t.name, "role": getattr(t, "role", "unified")}
            for t in targets]
        # Private per-thread holders — see module docstring.
        holders: List[Dict[str, Any]] = [{} for _ in targets]

        if self._client_factory is not None or not targets:
            for target, holder in zip(targets, holders):
                holder.update(self._scrape_one(target))
            for entry, holder in zip(entries, holders):
                entry.update(holder)
        else:
            def fetch(target, holder) -> None:
                holder.update(self._scrape_one(target))

            threads = [threading.Thread(target=fetch, args=(tg, holder),
                                        daemon=True,
                                        name=f"collect-{tg.name}")
                       for tg, holder in zip(targets, holders)]
            for t in threads:
                t.start()
            # ONE shared deadline (timeout + connect grace) for the
            # whole round — the replica_stats discipline.
            deadline = self._clock() + self.timeout_s + 1.0
            for t in threads:
                t.join(max(0.0, deadline - self._clock()))
            for entry, holder, t in zip(entries, holders, threads):
                if t.is_alive():
                    entry["stats_error"] = \
                        f"timeout after {self.timeout_s}s"
                else:
                    entry.update(holder)

        out: Dict[str, dict] = {}
        for idx, entry in enumerate(entries):
            key = str(entry["name"])
            if key in out:   # duplicate display names stay visible
                key = f"{key}[{idx}]"
            out[key] = entry
        self._ingest(out, t_round)
        return out

    def _ingest(self, sample: Dict[str, dict], t: float) -> None:
        """Land one round in the TSDB + roster bookkeeping."""
        ok = 0
        queue_depths: List[float] = []
        ttfts: List[float] = []
        with self._lock:
            roster = set(sample)
            # Departed replicas: their history has no future readers,
            # and at elastic-churn rates keeping it would grow the
            # series set without bound.
            for name in list(self._last_ok):
                if name not in roster:
                    del self._last_ok[name]
            for name in list(self._first_seen):
                if name not in roster:
                    del self._first_seen[name]
            for name in roster - set(self._first_seen):
                self._first_seen[name] = t
        for name, entry in sample.items():
            labels = {"replica": name}
            stats = entry.get("stats")
            if stats is None:
                self.tsdb.record("scrape_ok", 0.0, t, labels)
                continue
            ok += 1
            self.tsdb.record("scrape_ok", 1.0, t, labels)
            for field in ("queue_depth", "active_slots", "ttft_ms_p99",
                          "weights_version"):
                v = stats.get(field)
                if isinstance(v, (int, float)):
                    self.tsdb.record(field, float(v), t, labels)
            qd = stats.get("queue_depth")
            if isinstance(qd, (int, float)):
                queue_depths.append(float(qd))
            tt = stats.get("ttft_ms_p99")
            if isinstance(tt, (int, float)):
                ttfts.append(float(tt))
            inter = (stats.get("qos") or {}).get("interactive") or {}
            iv = inter.get("ttft_ms_p99")
            if isinstance(iv, (int, float)):
                self.tsdb.record("interactive_ttft_ms_p99", float(iv), t,
                                 labels)
                ttfts.append(float(iv))
        from .metrics import percentile

        total = len(sample)
        self.tsdb.record("fleet_replicas", float(total), t)
        self.tsdb.record("fleet_scrape_ok_frac",
                         (ok / total) if total else 1.0, t)
        if queue_depths:
            self.tsdb.record("fleet_queue_depth_mean",
                             sum(queue_depths) / len(queue_depths), t)
        p99 = percentile(ttfts, 99)
        if p99 is not None:
            self.tsdb.record("fleet_ttft_ms_p99", p99, t)
        with self._lock:
            self.rounds += 1
            self.scrapes_ok += ok
            self.scrapes_failed += total - ok
            self._last_round = sample
            self._last_round_t = t
            if ok:
                self._last_data_t = t
                for name, entry in sample.items():
                    if "stats" in entry:
                        self._last_ok[name] = t
            stale = self._staleness_s_locked(t)
        from . import instrument as _obs

        _obs.on_collect_round(ok, total, stale)

    def forget(self, name: str) -> None:
        """Drop a retired replica's series (the controller calls this
        on scale-in; the roster diff in :meth:`_ingest` catches the
        rest)."""
        self.tsdb.forget({"replica": name})

    # --- read side -----------------------------------------------------------

    def latest_stats(self, max_age_s: Optional[float] = None,
                     now: Optional[float] = None
                     ) -> Optional[Dict[str, dict]]:
        """The newest round's snapshot, or None when there is none (or
        it is older than ``max_age_s``) — the controller's fallback
        contract: stale data is declared stale, never served fresh."""
        t = self._clock() if now is None else float(now)
        with self._lock:
            if self._last_round is None:
                return None
            if max_age_s is not None and self._last_round_t is not None \
                    and t - self._last_round_t > max_age_s:
                return None
            return self._last_round

    def staleness_s(self, now: Optional[float] = None) -> float:
        t = self._clock() if now is None else float(now)
        with self._lock:
            return self._staleness_s_locked(t)

    def _staleness_s_locked(self, t: float) -> float:
        """Age of the newest successful scrape; 0 before the first
        round ever (a plane that has not started is not yet stale)."""
        if self._last_data_t is None:
            return 0.0 if self.rounds == 0 else float("inf")
        return max(0.0, t - self._last_data_t)

    def last_ok(self) -> Dict[str, float]:
        """Per-replica time of last successful scrape (directory-
        staleness detector input)."""
        with self._lock:
            return dict(self._last_ok)

    def first_seen(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._first_seen)


# --- multi-replica one-shot scrape (metrics_dump --fleet / fleet_top) --------

def scrape_fleet(targets: Sequence[Target], key: bytes, frame_factory,
                 *, timeout_s: float = 2.0,
                 clock: Callable[[], float] = time.monotonic
                 ) -> Dict[str, dict]:
    """Concurrently send ``frame_factory()`` to every target under ONE
    shared deadline; returns ``{name: {"response": resp} |
    {"error": str}}``.  The one-shot CLI form of the collector's scrape
    path (``metrics_dump --fleet``, ``fleet_top``)."""
    from ..runner.common.network import BasicClient

    holders: List[Dict[str, Any]] = [{} for _ in targets]

    def fetch(target: Target, holder: Dict[str, Any]) -> None:
        try:
            client = BasicClient(None, [tuple(a) for a in target.addresses],
                                 key, probe_timeout=timeout_s, probe=False)
            holder["response"] = client.request(
                frame_factory(), idempotent=False, timeout=timeout_s)
        except (OSError, ValueError) as e:
            holder["error"] = str(e) or type(e).__name__

    threads = [threading.Thread(target=fetch, args=(tg, holder),
                                daemon=True, name=f"scrape-{tg.name}")
               for tg, holder in zip(targets, holders)]
    for t in threads:
        t.start()
    deadline = clock() + timeout_s + 1.0
    for t in threads:
        t.join(max(0.0, deadline - clock()))
    out: Dict[str, dict] = {}
    for target, holder, t in zip(targets, holders, threads):
        if t.is_alive():
            out[target.name] = {"error": f"timeout after {timeout_s}s"}
        else:
            out[target.name] = holder or {"error": "no response"}
    return out


# --- the composed plane ------------------------------------------------------

class TelemetryPlane:
    """Collector + SLO burn-rate book + invariant detectors + alert
    sink, advanced one round at a time (:meth:`run_round`) by whatever
    owns the cadence: a daemon loop on wall time, the sim's event heap
    on virtual time, or a test calling it directly."""

    def __init__(self, collector: FleetCollector, *,
                 slo_spec: Optional[str] = None,
                 control_probe: Optional[Callable[[], dict]] = None,
                 period_s: float = 1.0,
                 stale_after_s: float = 10.0,
                 journal_path: Optional[str] = None,
                 detect_overrides: Optional[dict] = None) -> None:
        from .detect import AlertSink, DetectorBook
        from .slo import SloBook

        self.collector = collector
        self.period_s = float(period_s)
        self.slos = SloBook(spec=slo_spec, tsdb=collector.tsdb)
        self.detectors = DetectorBook(
            collector, control_probe=control_probe, period_s=period_s,
            stale_after_s=stale_after_s, **(detect_overrides or {}))
        self.sink = AlertSink(journal_path=journal_path)

    @classmethod
    def from_config(cls, targets, *, key: Optional[bytes] = None,
                    config=None,
                    control_probe: Optional[Callable[[], dict]] = None,
                    journal_path: Optional[str] = None,
                    detect_overrides: Optional[dict] = None,
                    clock: Callable[[], float] = time.monotonic,
                    client_factory: Optional[Callable[[Any], Any]] = None,
                    timeout_s: Optional[float] = None,
                    period_s: Optional[float] = None) -> "TelemetryPlane":
        """The production wiring: collector + plane with every knob
        from the typed :class:`~..config.Config`
        (``HVD_TPU_SLO_SPEC`` / ``HVD_TPU_COLLECT_*``); ``timeout_s``/
        ``period_s`` override the knobs when a CLI flag wins (e.g.
        ``fleet_top --timeout/--watch``)."""
        from ..config import Config

        cfg = config if config is not None else Config.from_env()
        collector = FleetCollector(
            targets, key=key, clock=clock, client_factory=client_factory,
            timeout_s=(cfg.collect_timeout_s if timeout_s is None
                       else timeout_s),
            points=cfg.collect_window)
        return cls(collector, slo_spec=cfg.slo_spec,
                   control_probe=control_probe,
                   period_s=(cfg.collect_period_s if period_s is None
                             else period_s),
                   stale_after_s=cfg.collect_stale_s,
                   journal_path=journal_path,
                   detect_overrides=detect_overrides)

    def run_round(self, now: Optional[float] = None) -> List[dict]:
        """Scrape → evaluate SLOs → evaluate detectors → emit alert
        edges.  Returns the alerts that FIRED this round (rising edges
        only)."""
        t = self.collector._clock() if now is None else float(now)
        sample = self.collector.scrape_round(now=t)
        conditions = self.slos.evaluate(t)
        conditions += self.detectors.evaluate(t, sample)
        return self.sink.emit(t, conditions)
