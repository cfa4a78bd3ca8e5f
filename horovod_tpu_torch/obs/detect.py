"""Online invariant detectors: the sim's InvariantBook, live.

Counterpart of ``horovod_tpu/obs/detect.py`` (host Python, no device
work), under the reference's names.

The chaos simulator (``serve/fleet/sim.py``) proves seven SLO
invariants offline; two of them (the scale-in death spiral and the
migration convoy) were REAL control-plane bugs it caught.  This module
ports the catchable-from-telemetry subset to streaming detection over
the collector's TSDB, so the same bug class pages an operator in
production instead of waiting for the next sim run:

========================= ====================================================
detector                  sim invariant / semantics
========================= ====================================================
never_shed_interactive    ``never_shed_interactive`` — the brownout ladder
                          shed an interactive request (structurally
                          impossible; any count is a bug)
ladder_oscillation        ``no_ladder_oscillation`` — scale-in while the
                          ladder is shedding (the death-spiral signature:
                          capacity drained away from an overloaded fleet),
                          or more level transitions per window than
                          hysteresis allows
migration_convoy          ``no_migration_convoy`` — one decode replica's
                          load (queue + active slots) is both above the
                          convoy bound and far above its role's median:
                          every prefill picked the same target
directory_staleness       ``bounded_directory_staleness`` — the directory
                          still routes to a replica that has been
                          scrape-dead past the staleness bound
stuck_swap                ``swap_autoscaler_non_interference`` (the
                          mixed-version half) — a rolling swap stopped
                          making progress: replicas-at-target-version
                          flat while the fleet is still mixed
straggler_replica         serving-side ``obs/aggregate.detect_stragglers``
                          — a replica's TTFT p99 persistently exceeds
                          ``factor`` x its ROLE's median (per-role:
                          prefill and decode TTFTs are different
                          distributions by design)
collect_stale             the plane watching itself — no successful
                          scrape for longer than the staleness bound
                          (the ``collect`` fault site's degraded mode)
========================= ====================================================

Control-plane signals the replica stats cannot carry (brownout level,
scale-in counts, the directory roster, the swap target) come from a
``control_probe`` callable — the sim wires it from its own state, a
real deployment from the in-process router/controller/QoS gate.  A
missing probe (or missing keys) disables exactly the detectors that
need them: a detector must never fire on absent data.

Alert plumbing: :class:`AlertSink` episode-deduplicates (one firing
per continuous episode, re-armed on clear) and lands every edge in
the flight recorder, ``hvd_tpu_alerts_total{alert,severity}``, and a
bounded fsync'd :class:`AlertJournal` (the ``ckpt/journal.py``
torn-tail discipline — a postmortem's alert timeline must survive the
crash that caused it).
"""

from __future__ import annotations

import collections
import json
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from .aggregate import detect_stragglers
from ..utils.logging import get_logger

logger = get_logger(__name__)

__all__ = ["DETECTORS", "DetectorBook", "AlertSink", "AlertJournal"]

# The detector catalog: (id, severity).  LITERAL on purpose — hvdlint's
# observability checker (analysis/registries.py) reads it via AST and
# requires a docs/observability.md row per id, the same drift
# discipline as the span/metric catalogs.
DETECTORS = (
    ("never_shed_interactive", "page"),
    ("ladder_oscillation", "page"),
    ("migration_convoy", "page"),
    ("directory_staleness", "ticket"),
    ("stuck_swap", "ticket"),
    ("straggler_replica", "ticket"),
    ("collect_stale", "ticket"),
)

_SEVERITY = dict(DETECTORS)


class DetectorBook:
    """Streaming evaluation of every detector over one collector.

    Tunables (``detect_overrides`` on the plane): ``convoy_bound`` — a
    decode replica's queue+active load that can convoy (default 16,
    the sim's ``2 x max_slots``); ``oscillation_bound``/
    ``oscillation_window_s`` — max brownout level transitions per
    window (the sim's hysteresis bound); ``straggler_factor`` — x the
    role median (serving default 10.0, far above the training-side
    2.0: a WINDOW p99 of heavy-tailed lognormal TTFTs legitimately
    spreads ~7x across identical replicas — measured across seeded
    clean sim runs — where mean step times spread a few percent; a
    truly wedged replica is an order of magnitude out);
    ``straggler_rounds`` — consecutive flagged rounds before firing
    (transient queue spikes are not stragglers); ``swap_stuck_s`` —
    no-progress window for a rolling swap.
    """

    def __init__(self, collector, *,
                 control_probe: Optional[Callable[[], dict]] = None,
                 period_s: float = 1.0,
                 stale_after_s: float = 10.0,
                 convoy_bound: float = 16.0,
                 oscillation_bound: int = 8,
                 oscillation_window_s: float = 60.0,
                 straggler_factor: float = 10.0,
                 straggler_rounds: int = 3,
                 swap_stuck_s: float = 60.0) -> None:
        self.collector = collector
        self.control_probe = control_probe
        self.period_s = float(period_s)
        self.stale_after_s = float(stale_after_s)
        self.convoy_bound = float(convoy_bound)
        self.oscillation_bound = int(oscillation_bound)
        self.oscillation_window_s = float(oscillation_window_s)
        self.straggler_factor = float(straggler_factor)
        self.straggler_rounds = int(straggler_rounds)
        self.swap_stuck_s = float(swap_stuck_s)
        self._lock = threading.Lock()
        self._prev_probe: Dict[str, Any] = {}        # guarded-by: _lock
        self._levels: "collections.deque" = collections.deque(maxlen=4096)  # guarded-by: _lock
        self._straggler_strikes: Dict[str, int] = {}  # guarded-by: _lock
        self._swap_progress: Optional[Tuple[int, int, float]] = None  # guarded-by: _lock

    def evaluate(self, now: float, sample: Dict[str, dict]) -> List[dict]:
        """One round: returns a condition dict per detector (firing or
        not — the sink needs the clear edges too)."""
        probe = {}
        if self.control_probe is not None:
            try:
                probe = dict(self.control_probe() or {})
            except Exception as e:  # a dying probe must not kill the plane
                logger.warning("control probe failed: %s", e)
        with self._lock:
            prev = dict(self._prev_probe)
            self._prev_probe = dict(probe)
            if "brownout_level" in probe:
                self._levels.append((now, int(probe["brownout_level"])))
        conds = [
            self._shed_interactive(probe, prev),
            self._ladder_oscillation(now, probe, prev),
            self._migration_convoy(sample),
            self._directory_staleness(now, probe),
            self._stuck_swap(now, probe, sample),
            self._straggler_replica(sample),
            self._collect_stale(now),
        ]
        return [c for c in conds if c is not None]

    @staticmethod
    def _cond(det_id: str, firing: bool, detail: Any = None) -> dict:
        return {"id": det_id, "severity": _SEVERITY[det_id],
                "firing": firing, "detail": detail}

    # --- the detectors -------------------------------------------------------

    def _shed_interactive(self, probe: dict, prev: dict) -> Optional[dict]:
        cur = probe.get("shed_interactive_total")
        if cur is None:
            return None
        before = prev.get("shed_interactive_total", cur)
        fired = cur > before
        return self._cond("never_shed_interactive", fired,
                          {"shed": cur - before} if fired else None)

    def _ladder_oscillation(self, now: float, probe: dict,
                            prev: dict) -> Optional[dict]:
        level = probe.get("brownout_level")
        if level is None:
            return None
        # Primary (death-spiral) signature: the controller drained
        # capacity away WHILE the ladder was shedding.  One faulty
        # scale-in fires this on the next round.
        scale_in = probe.get("scale_in_total")
        spiral = False
        if scale_in is not None and "scale_in_total" in prev:
            shed_active = int(level) > 0 or \
                int(prev.get("brownout_level", 0)) > 0
            spiral = scale_in > prev["scale_in_total"] and shed_active
        # Secondary: more level transitions per window than the
        # hold-time hysteresis allows (the sim's oscillation bound).
        with self._lock:
            pts = [(t, lv) for t, lv in self._levels
                   if t >= now - self.oscillation_window_s]
        transitions = sum(1 for (_, a), (_, b) in zip(pts, pts[1:])
                          if a != b)
        oscillating = transitions > self.oscillation_bound
        firing = spiral or oscillating
        detail = None
        if firing:
            detail = {"spiral": spiral, "transitions": transitions,
                      "level": int(level)}
        return self._cond("ladder_oscillation", firing, detail)

    def _migration_convoy(self, sample: Dict[str, dict]) -> Optional[dict]:
        loads: Dict[str, float] = {}
        for name, entry in sample.items():
            if entry.get("role") != "decode":
                continue
            stats = entry.get("stats")
            if not isinstance(stats, dict):
                continue
            loads[name] = (float(stats.get("queue_depth") or 0)
                           + float(stats.get("active_slots") or 0))
        if len(loads) < 2:
            return self._cond("migration_convoy", False)
        import statistics

        worst = max(loads, key=lambda n: loads[n])
        peak = loads[worst]
        med = statistics.median(loads.values())
        # Both conditions: an absolute bound (a busy-but-balanced fleet
        # never fires) and a gross imbalance vs the role median (a
        # small uniformly-loaded fleet never fires).
        firing = peak >= self.convoy_bound and peak > 4.0 * (med + 1.0)
        detail = None
        if firing:
            detail = {"replica": worst, "load": peak, "median": med}
        return self._cond("migration_convoy", firing, detail)

    def _directory_staleness(self, now: float,
                             probe: dict) -> Optional[dict]:
        roster = probe.get("directory_replicas")
        if roster is None:
            return None
        last_ok = self.collector.last_ok()
        first_seen = self.collector.first_seen()
        bound = self.stale_after_s
        stale = []
        for name in roster:
            seen = last_ok.get(name, first_seen.get(name))
            if seen is not None and now - seen > bound:
                stale.append(name)
        return self._cond("directory_staleness", bool(stale),
                          {"replicas": stale[:8]} if stale else None)

    def _stuck_swap(self, now: float, probe: dict,
                    sample: Dict[str, dict]) -> Optional[dict]:
        target = probe.get("swap_target_version")
        if target is None:
            with self._lock:
                self._swap_progress = None
            return self._cond("stuck_swap", False)
        at_target = 0
        versions = 0
        for entry in sample.values():
            stats = entry.get("stats")
            if isinstance(stats, dict) and \
                    stats.get("weights_version") is not None:
                versions += 1
                if int(stats["weights_version"]) >= int(target):
                    at_target += 1
        done = versions > 0 and at_target == versions
        with self._lock:
            if done:
                self._swap_progress = None
                return self._cond("stuck_swap", False)
            prog = self._swap_progress
            if prog is None or prog[0] != int(target) \
                    or at_target > prog[1]:
                # New roll, or the roll advanced: reset the clock.
                self._swap_progress = (int(target), at_target, now)
                return self._cond("stuck_swap", False)
            stuck_for = now - prog[2]
        firing = stuck_for > self.swap_stuck_s
        detail = None
        if firing:
            detail = {"target": int(target), "at_target": at_target,
                      "replicas": versions,
                      "stuck_s": round(stuck_for, 1)}
        return self._cond("stuck_swap", firing, detail)

    def _straggler_replica(self, sample: Dict[str, dict]) -> Optional[dict]:
        by_role: Dict[str, List[Tuple[str, float]]] = {}
        for name, entry in sample.items():
            stats = entry.get("stats")
            if not isinstance(stats, dict):
                continue
            v = stats.get("ttft_ms_p99")
            if isinstance(v, (int, float)) and v > 0:
                by_role.setdefault(str(entry.get("role")), []).append(
                    (name, float(v)))
        flagged = set()
        for rows in by_role.values():
            if len(rows) < 3:   # a 2-replica "role median" is noise
                continue
            idxs = detect_stragglers([v for _, v in rows],
                                     factor=self.straggler_factor)
            flagged.update(rows[i][0] for i in idxs)
        with self._lock:
            for name in list(self._straggler_strikes):
                if name not in flagged:
                    del self._straggler_strikes[name]
            persistent = []
            for name in flagged:
                n = self._straggler_strikes.get(name, 0) + 1
                self._straggler_strikes[name] = n
                if n >= self.straggler_rounds:
                    persistent.append(name)
        return self._cond("straggler_replica", bool(persistent),
                          {"replicas": sorted(persistent)[:8]}
                          if persistent else None)

    def _collect_stale(self, now: float) -> Optional[dict]:
        stale = self.collector.staleness_s(now=now)
        firing = stale > self.stale_after_s
        return self._cond("collect_stale", firing,
                          {"staleness_s": round(stale, 1)}
                          if firing else None)


# --- alert plumbing ----------------------------------------------------------

class AlertJournal:
    """Bounded append-only fsync'd JSONL of alert edges — the
    ``ckpt/journal.py`` durability discipline, for the artifact an
    incident postmortem reads first:

    * every append is flushed + fsync'd before returning;
    * a torn final line (the fsync a crash interrupted) is truncated
      away before the first append of a resumed process, and
      :meth:`read` reports the tail as not intact;
    * past ``max_entries`` the file is compacted to its newest half
      (atomic tmp+rename) — an alert journal that grows forever would
      become the disk-filler it exists to page about.
    """

    def __init__(self, path: str, *, fsync: bool = True,
                 max_entries: int = 4096) -> None:
        self.path = os.path.abspath(path)
        self._fsync = bool(fsync)
        self.max_entries = max(2, int(max_entries))
        self._lock = threading.Lock()
        self._f = None            # guarded-by: _lock
        self._n: Optional[int] = None   # entries on disk; guarded-by: _lock

    def append(self, **entry: Any) -> None:
        data = (json.dumps(entry, separators=(",", ":"), default=str)
                + "\n").encode()
        with self._lock:
            if self._f is None:
                os.makedirs(os.path.dirname(self.path) or ".",
                            exist_ok=True)
                self._repair_torn_tail_locked()
                self._f = open(self.path, "ab")
            if self._n is None:
                with open(self.path, "rb") as rf:
                    self._n = rf.read().count(b"\n")
            self._f.write(data)
            self._f.flush()
            if self._fsync:
                os.fsync(self._f.fileno())
            self._n += 1
            if self._n > self.max_entries:
                self._compact_locked()

    def _repair_torn_tail_locked(self) -> None:
        try:
            with open(self.path, "rb+") as f:
                raw = f.read()
                if not raw or raw.endswith(b"\n"):
                    return
                cut = raw.rfind(b"\n") + 1
                f.truncate(cut)
        except FileNotFoundError:
            return
        logger.warning(
            "alert journal %s: dropped a torn %d-byte tail record",
            self.path, len(raw) - cut)

    def _compact_locked(self) -> None:
        self._f.close()
        self._f = None  # hvdlint: disable=unguarded-mutation -- _locked suffix contract: sole caller (append) holds _lock
        with open(self.path, "rb") as f:
            lines = f.read().splitlines(keepends=True)
        keep = lines[-(self.max_entries // 2):]
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.writelines(keep)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        self._n = len(keep)
        self._f = open(self.path, "ab")  # hvdlint: disable=unguarded-mutation -- _locked suffix contract: sole caller (append) holds _lock

    def read(self) -> Tuple[List[dict], bool]:
        """``(entries, intact)`` — stops at the first torn/corrupt
        line; a missing file is a fresh journal, not damage."""
        try:
            with open(self.path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            return [], True
        entries: List[dict] = []
        lines = raw.split(b"\n")
        terminated = lines and lines[-1] == b""
        body = lines[:-1] if terminated else lines
        for i, line in enumerate(body):
            if not line.strip():
                continue
            try:
                entry = json.loads(line)
                if not isinstance(entry, dict):
                    raise ValueError("alert journal line is not an object")
            except (ValueError, UnicodeDecodeError):
                return entries, False
            if not terminated and i == len(body) - 1:
                # Parsed but un-terminated: only a newline-terminated
                # line is known complete (it could be a torn prefix
                # that happens to parse).
                return entries, False
            entries.append(entry)
        return entries, True

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


class AlertSink:
    """Episode-deduplicating fan-out for alert conditions.

    A condition that stays true fires ONCE (the rising edge) and
    re-arms when it clears — a page per round would train operators to
    silence the plane.  Every edge lands in the flight recorder, the
    ``hvd_tpu_alerts_total`` counter (fire edges only) and the alert
    journal (fire and clear, so the postmortem timeline has both
    ends)."""

    def __init__(self, journal_path: Optional[str] = None) -> None:
        self.journal = AlertJournal(journal_path) if journal_path else None
        self._lock = threading.Lock()
        self._active: Dict[str, float] = {}   # id -> fire time; guarded-by: _lock
        self.fired_total = 0                  # guarded-by: _lock

    def emit(self, now: float, conditions: List[dict]) -> List[dict]:
        """Apply one round's conditions; returns the alerts that fired
        (rising edges) this round."""
        from . import flight as _flight
        from . import instrument as _obs

        fired: List[dict] = []
        cleared: List[str] = []
        with self._lock:
            for cond in conditions:
                cid = cond["id"]
                if cond["firing"]:
                    if cid not in self._active:
                        self._active[cid] = now
                        self.fired_total += 1
                        fired.append({"alert": cid, "t": now,
                                      "severity": cond["severity"],
                                      "detail": cond.get("detail")})
                elif cid in self._active:
                    del self._active[cid]
                    cleared.append(cid)
        for alert in fired:
            _obs.on_alert(alert["alert"], alert["severity"])
            _flight.record("alert", alert=alert["alert"],
                           severity=alert["severity"],
                           detail=alert["detail"])
            logger.warning("ALERT %s (%s): %s", alert["alert"],
                           alert["severity"], alert["detail"])
            if self.journal is not None:
                self.journal.append(t=now, event="fire", **{
                    "alert": alert["alert"],
                    "severity": alert["severity"],
                    "detail": alert["detail"]})
        for cid in cleared:
            _flight.record("alert_clear", alert=cid)
            if self.journal is not None:
                self.journal.append(t=now, event="clear", alert=cid)
        return fired

    def active(self) -> Dict[str, float]:
        """Currently-firing alerts ``{id: fire_time}``."""
        with self._lock:
            return dict(self._active)
