"""The port's fleet telemetry plane (``horovod_tpu_torch/obs/
{timeseries,collector,slo,detect}.py``) against the reference's.

``tests/test_obs.py``'s ``TestRingTSDB``, ``TestFleetCollector``,
``TestSloBook``, ``TestDetectorBook``, ``TestAlertPlumbing``,
``TestTelemetryPlaneRounds`` and ``TestObsChaosDrill`` on the port,
case for case.  Then the parity checks: the same seeded streams of
replica stats, scrape failures and control-probe readings, fed to both
packages' planes under one virtual clock, give the same alerts round by
round and the same journal lines; and the port's collector scrapes real
serving replicas over the HMAC wire and feeds the fleet controller's
``collector=``.
"""

import json
import os
import random
import time
import types

import pytest

from horovod_tpu import faults as jfaults
from horovod_tpu.obs import collector as jcollector
from horovod_tpu.obs import metrics as jmetrics

from horovod_tpu_torch import faults
from horovod_tpu_torch.obs import instrument
from horovod_tpu_torch.obs import metrics as pmetrics
from horovod_tpu_torch.obs.collector import (FleetCollector, Target,
                                             TelemetryPlane, parse_targets)
from horovod_tpu_torch.obs.detect import (AlertJournal, AlertSink, DETECTORS,
                                          DetectorBook)
from horovod_tpu_torch.obs.slo import SloBook
from horovod_tpu_torch.obs.timeseries import RingTSDB


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


def _value(snap, name, **labels):
    """Value of one series in a snapshot dict (0.0 when absent — the
    delta convention treats never-recorded as zero)."""
    for series in snap.get(name, []):
        if series.get("labels", {}) == {str(k): str(v)
                                        for k, v in labels.items()}:
            return series.get("value", series.get("count"))
    return 0.0


# --- tests/test_obs.py's fleet telemetry plane, on the port -------------------

class TestRingTSDB:
    def test_record_latest_window_bounded(self):
        db = RingTSDB(points=4)
        for t in range(6):
            db.record("s", float(t * 10), float(t), {"replica": "r0"})
        # points=4 keeps the newest 4 samples only.
        assert db.window("s", 0.0, {"replica": "r0"}) == [
            (2.0, 20.0), (3.0, 30.0), (4.0, 40.0), (5.0, 50.0)]
        assert db.latest("s", {"replica": "r0"}) == (5.0, 50.0)
        assert db.latest("s") is None            # unlabeled != labeled
        assert db.latest("nope") is None
        assert db.window("s", 4.5, {"replica": "r0"}) == [(5.0, 50.0)]

    def test_none_value_is_skipped_not_zero(self):
        db = RingTSDB()
        db.record("s", None, 0.0)
        assert db.latest("s") is None

    def test_rate_and_delta_are_reset_aware(self):
        db = RingTSDB()
        # Counter 0 -> 10, then a replica restart zeroes it to 3: the
        # increase is 10 + 3 (Prometheus rate() convention), never -7.
        db.record("c", 0.0, 0.0)
        db.record("c", 10.0, 1.0)
        db.record("c", 3.0, 2.0)
        assert db.delta("c", 0.0) == 13.0
        assert db.rate("c", 0.0) == 6.5
        # One sample has no rate; fabricating 0 would mask a dead series.
        db2 = RingTSDB()
        db2.record("c", 5.0, 0.0)
        assert db2.rate("c", 0.0) is None
        assert db2.delta("c", 0.0) is None

    def test_quantile_over_window(self):
        db = RingTSDB()
        for t, v in enumerate([10.0, 20.0, 30.0, 40.0]):
            db.record("lat", v, float(t))
        assert db.quantile("lat", 50, 0.0) == 30.0
        assert db.quantile("lat", 50, 2.5) == 40.0   # windowed
        assert db.quantile("lat", 50, 99.0) is None  # empty window

    def test_series_cap_drops_never_grows(self):
        db = RingTSDB(max_series=2)
        db.record("a", 1.0, 0.0, {"replica": "r0"})
        db.record("a", 1.0, 0.0, {"replica": "r1"})
        db.record("a", 1.0, 0.0, {"replica": "r2"})   # past the cap
        assert db.series_count() == 2
        assert db.dropped_series == 1
        assert db.latest("a", {"replica": "r2"}) is None
        # Existing series keep accepting samples.
        db.record("a", 2.0, 1.0, {"replica": "r0"})
        assert db.latest("a", {"replica": "r0"}) == (1.0, 2.0)

    def test_forget_and_labelsets(self):
        db = RingTSDB()
        db.record("q", 1.0, 0.0, {"replica": "r0", "role": "decode"})
        db.record("q", 2.0, 0.0, {"replica": "r1", "role": "decode"})
        db.record("z", 3.0, 0.0, {"replica": "r0"})
        assert sorted(ls["replica"] for ls in db.labelsets("q")) == \
            ["r0", "r1"]
        # forget drops every series carrying the labels (a scaled-in
        # replica's whole history).
        assert db.forget({"replica": "r0"}) == 2
        assert db.latest("q", {"replica": "r0", "role": "decode"}) is None
        assert db.latest("z", {"replica": "r0"}) is None
        assert db.latest("q", {"replica": "r1", "role": "decode"}) is not None


def _fake_fleet(stats_by_name, **kw):
    """A FleetCollector over an in-process fake transport:
    ``stats_by_name[name]`` is the stats dict one scrape returns, an
    Exception to raise, or a non-dict to serve as a garbage payload.
    The dict is read live, so tests mutate it between rounds."""
    targets = [Target(name=n) for n in stats_by_name]

    class _Client:
        def __init__(self, target):
            self._name = target.name

        def request(self, req, idempotent=True, timeout=None):
            v = stats_by_name[self._name]
            if isinstance(v, Exception):
                raise v
            return types.SimpleNamespace(stats=v)

    return FleetCollector(targets, client_factory=_Client, **kw)


class TestFleetCollector:
    def test_round_lands_per_replica_and_fleet_series(self):
        fleet = {
            "r0": {"queue_depth": 2, "active_slots": 1,
                   "ttft_ms_p99": 120.0, "weights_version": 7},
            "r1": {"queue_depth": 4, "active_slots": 3,
                   "ttft_ms_p99": 180.0, "weights_version": 7},
        }
        col = _fake_fleet(fleet)
        out = col.scrape_round(now=5.0)
        assert set(out) == {"r0", "r1"}
        assert out["r0"]["stats"]["queue_depth"] == 2
        assert col.tsdb.latest("queue_depth", {"replica": "r1"}) == \
            (5.0, 4.0)
        assert col.tsdb.latest("weights_version", {"replica": "r0"}) == \
            (5.0, 7.0)
        assert col.tsdb.latest("fleet_replicas") == (5.0, 2.0)
        assert col.tsdb.latest("fleet_scrape_ok_frac") == (5.0, 1.0)
        assert col.tsdb.latest("fleet_queue_depth_mean") == (5.0, 3.0)
        assert col.tsdb.latest("fleet_ttft_ms_p99") == (5.0, 180.0)
        assert col.rounds == 1 and col.scrapes_ok == 2
        assert col.staleness_s(now=7.0) == 2.0

    def test_dead_replica_degrades_the_entry_not_the_round(self):
        fleet = {"r0": {"queue_depth": 1, "active_slots": 0},
                 "r1": ConnectionError("replica gone")}
        col = _fake_fleet(fleet)
        out = col.scrape_round(now=1.0)
        assert "stats" in out["r0"]
        assert "replica gone" in out["r1"]["stats_error"]
        assert col.tsdb.latest("scrape_ok", {"replica": "r1"}) == \
            (1.0, 0.0)
        assert col.tsdb.latest("fleet_scrape_ok_frac") == (1.0, 0.5)
        assert col.scrapes_failed == 1

    def test_garbage_payload_never_reaches_the_tsdb(self):
        fleet = {"r0": "<html>lol</html>",
                 "r1": {"queue_depth": "NaNaNaN", "active_slots": 0}}
        col = _fake_fleet(fleet)
        out = col.scrape_round(now=1.0)
        assert "garbage stats payload" in out["r0"]["stats_error"]
        assert "garbage stats field" in out["r1"]["stats_error"]
        assert col.tsdb.latest("queue_depth", {"replica": "r0"}) is None
        assert col.tsdb.latest("queue_depth", {"replica": "r1"}) is None
        assert col.scrapes_ok == 0

    def test_latest_stats_declares_stale_never_serves_fresh(self):
        fleet = {"r0": {"queue_depth": 0, "active_slots": 0}}
        col = _fake_fleet(fleet)
        assert col.latest_stats() is None           # nothing yet
        col.scrape_round(now=10.0)
        assert col.latest_stats(max_age_s=5.0, now=12.0) is not None
        assert col.latest_stats(max_age_s=5.0, now=20.0) is None

    def test_departed_replica_bookkeeping_is_dropped(self):
        fleet = {"r0": {"queue_depth": 0, "active_slots": 0},
                 "r1": {"queue_depth": 0, "active_slots": 0}}
        targets = [Target(name="r0"), Target(name="r1")]

        class _Client:
            def __init__(self, target):
                self._name = target.name

            def request(self, req, idempotent=True, timeout=None):
                return types.SimpleNamespace(stats=fleet[self._name])

        roster = {"live": targets}
        col = FleetCollector(lambda: roster["live"], client_factory=_Client)
        col.scrape_round(now=1.0)
        assert set(col.last_ok()) == {"r0", "r1"}
        roster["live"] = targets[:1]   # r1 scaled in
        col.scrape_round(now=2.0)
        assert set(col.last_ok()) == {"r0"}
        assert set(col.first_seen()) == {"r0"}

    def test_injected_clock_runs_the_same_collector_on_virtual_time(self):
        vt = [100.0]
        fleet = {"r0": {"queue_depth": 0, "active_slots": 0}}
        col = _fake_fleet(fleet, clock=lambda: vt[0])
        col.scrape_round()                      # stamps at clock()
        assert col.tsdb.latest("scrape_ok", {"replica": "r0"})[0] == 100.0
        vt[0] = 175.0
        assert col.staleness_s() == 75.0

    def test_wedged_socket_costs_one_shared_deadline_not_one_each(self):
        """The scrape-discipline drill: 4 wedged replicas + 2 healthy,
        scraped over the real thread path — the round must cost ONE
        shared deadline (timeout + connect grace), the wedged entries
        must degrade to ``stats_error``, and a thread that outlives the
        deadline must not mutate the returned snapshot."""
        healthy = {"queue_depth": 1, "active_slots": 1}
        wedge_s = 1.6

        targets = [Target(name=f"wedged{i}") for i in range(4)] + \
                  [Target(name=f"ok{i}") for i in range(2)]
        col = FleetCollector(targets, timeout_s=0.2)

        def fake_scrape(target):
            if target.name.startswith("wedged"):
                time.sleep(wedge_s)
            return {"stats": dict(healthy)}

        col._scrape_one = fake_scrape
        t0 = time.monotonic()
        out = col.scrape_round(now=0.0)
        elapsed = time.monotonic() - t0
        # ONE deadline (0.2s timeout + 1.0s grace), not 4 x 1.6s.
        assert elapsed < wedge_s, elapsed
        for i in range(4):
            assert "timeout after" in out[f"wedged{i}"]["stats_error"]
        for i in range(2):
            assert out[f"ok{i}"]["stats"] == healthy
        # The wedged threads finish AFTER the round returned; their
        # private holders must not leak into the snapshot the caller
        # already holds.
        time.sleep(wedge_s - elapsed + 0.3)
        for i in range(4):
            assert "stats" not in out[f"wedged{i}"]
        assert col.latest_stats()["wedged0"].get("stats") is None

    def test_thousand_replica_round_is_cheap(self):
        fleet = {f"r{i:04d}": {"queue_depth": i % 7, "active_slots": 1,
                               "ttft_ms_p99": 100.0 + i % 50}
                 for i in range(1000)}
        col = _fake_fleet(fleet)
        t0 = time.monotonic()
        out = col.scrape_round(now=1.0)
        elapsed = time.monotonic() - t0
        assert len(out) == 1000
        assert col.scrapes_ok == 1000
        assert col.tsdb.latest("fleet_replicas") == (1.0, 1000.0)
        assert elapsed < 10.0, elapsed

    def test_parse_targets_grammar(self):
        t1, t2 = parse_targets("10.0.0.1:7070, :8080")
        assert t1.addresses == (("10.0.0.1", 7070),)
        assert t2.addresses == (("127.0.0.1", 8080),)
        with pytest.raises(ValueError, match="HOST:PORT"):
            parse_targets("nope")


class TestSloBook:
    SPEC = ("avail:signal=scrape_ok,target=0.9,budget=0.1,"
            "window=100,short=10,burn=2,severity=page")

    def test_fires_only_when_both_windows_burn(self):
        db = RingTSDB()
        book = SloBook(spec=self.SPEC, tsdb=db)
        # Long window bad, short window clean: the incident is over —
        # no page.
        for t in range(0, 90):
            db.record("fleet_scrape_ok_frac", 0.0, float(t))
        for t in range(90, 101):
            db.record("fleet_scrape_ok_frac", 1.0, float(t))
        (cond,) = book.evaluate(100.0)
        assert cond["id"] == "slo_burn:avail"
        assert cond["severity"] == "page"
        assert not cond["firing"]
        assert book.burn_rates()["avail"][0] > 2.0   # long still burning
        assert book.burn_rates()["avail"][1] == 0.0
        # The incident resumes: both windows burn -> fire.
        for t in range(101, 112):
            db.record("fleet_scrape_ok_frac", 0.0, float(t))
        (cond,) = book.evaluate(111.0)
        assert cond["firing"]
        assert cond["detail"]["burn_short"] >= 2.0

    def test_absent_data_never_pages(self):
        book = SloBook(spec=self.SPEC, tsdb=RingTSDB())
        assert book.evaluate(100.0) == []
        assert book.burn_rates() == {}

    def test_default_catalog_is_scrape_availability(self):
        book = SloBook()
        assert list(book.clauses) == ["availability"]
        cl = book.clauses["availability"]
        assert cl.signal == "scrape_ok" and cl.severity == "page"

    def test_burn_gauge_is_published(self):
        db = RingTSDB()
        spec = ("obs_test_gauge_slo:signal=scrape_ok,target=0.9,"
                "budget=0.5,window=10,short=5,burn=99")
        book = SloBook(spec=spec, tsdb=db)
        for t in range(0, 11):
            db.record("fleet_scrape_ok_frac", 0.0, float(t))
        book.evaluate(10.0)
        snap = instrument._reg().snapshot()
        assert _value(snap, "hvd_tpu_slo_burn_rate",
                      slo="obs_test_gauge_slo") == 2.0   # 1.0 bad / 0.5


class TestDetectorBook:
    @staticmethod
    def _sample(**replicas):
        """``name=(role, stats)`` -> a scrape-round-shaped snapshot."""
        return {name: {"name": name, "role": role, "stats": stats}
                for name, (role, stats) in replicas.items()}

    def test_missing_probe_disables_exactly_the_control_detectors(self):
        col = _fake_fleet({"r0": {"queue_depth": 0, "active_slots": 0}})
        book = DetectorBook(col)
        sample = col.scrape_round(now=0.0)
        conds = book.evaluate(0.0, sample)
        ids = {c["id"] for c in conds}
        # No control probe: the detectors that need one yield nothing —
        # a detector must never fire on absent data.
        assert "never_shed_interactive" not in ids
        assert "ladder_oscillation" not in ids
        assert "directory_staleness" not in ids
        assert not any(c["firing"] for c in conds)

    def test_shed_interactive_fires_on_the_counter_edge(self):
        col = _fake_fleet({"r0": {"queue_depth": 0, "active_slots": 0}})
        probe = {"shed_interactive_total": 0}
        book = DetectorBook(col, control_probe=lambda: dict(probe))

        def cond(t):
            return {c["id"]: c for c in book.evaluate(t, {})}

        assert not cond(0.0)["never_shed_interactive"]["firing"]
        probe["shed_interactive_total"] = 2
        c = cond(1.0)["never_shed_interactive"]
        assert c["firing"] and c["detail"] == {"shed": 2}
        assert c["severity"] == "page"
        assert not cond(2.0)["never_shed_interactive"]["firing"]

    def test_spiral_scale_in_during_shed_fires_next_round(self):
        col = _fake_fleet({"r0": {"queue_depth": 0, "active_slots": 0}})
        probe = {"brownout_level": 1, "scale_in_total": 0}
        book = DetectorBook(col, control_probe=lambda: dict(probe))
        (c,) = [c for c in book.evaluate(0.0, {})
                if c["id"] == "ladder_oscillation"]
        assert not c["firing"]
        probe["scale_in_total"] = 1    # capacity drained MID-shed
        (c,) = [c for c in book.evaluate(1.0, {})
                if c["id"] == "ladder_oscillation"]
        assert c["firing"] and c["detail"]["spiral"]

    def test_ladder_oscillation_on_transition_storm(self):
        col = _fake_fleet({"r0": {"queue_depth": 0, "active_slots": 0}})
        probe = {"brownout_level": 0}
        book = DetectorBook(col, control_probe=lambda: dict(probe),
                            oscillation_bound=2,
                            oscillation_window_s=60.0)
        for t in range(5):
            probe["brownout_level"] = t % 2
            (c,) = [c for c in book.evaluate(float(t), {})
                    if c["id"] == "ladder_oscillation"]
        assert c["firing"] and c["detail"]["transitions"] > 2

    def test_convoy_needs_bound_and_imbalance(self):
        col = _fake_fleet({})
        book = DetectorBook(col, convoy_bound=16.0)
        convoy = self._sample(
            d0=("decode", {"queue_depth": 18, "active_slots": 4}),
            d1=("decode", {"queue_depth": 1, "active_slots": 1}),
            d2=("decode", {"queue_depth": 0, "active_slots": 1}),
            p0=("prefill", {"queue_depth": 50, "active_slots": 4}))
        (c,) = [c for c in book.evaluate(0.0, convoy)
                if c["id"] == "migration_convoy"]
        assert c["firing"] and c["detail"]["replica"] == "d0"
        # Busy but BALANCED: never fires (no imbalance)...
        balanced = self._sample(
            d0=("decode", {"queue_depth": 20, "active_slots": 4}),
            d1=("decode", {"queue_depth": 20, "active_slots": 4}),
            d2=("decode", {"queue_depth": 19, "active_slots": 4}))
        (c,) = [c for c in book.evaluate(1.0, balanced)
                if c["id"] == "migration_convoy"]
        assert not c["firing"]
        # ...and neither does a skewed-but-small load (below the bound).
        small = self._sample(
            d0=("decode", {"queue_depth": 8, "active_slots": 2}),
            d1=("decode", {"queue_depth": 0, "active_slots": 0}),
            d2=("decode", {"queue_depth": 0, "active_slots": 0}))
        (c,) = [c for c in book.evaluate(2.0, small)
                if c["id"] == "migration_convoy"]
        assert not c["firing"]

    def test_directory_staleness_vs_scrape_dead_replica(self):
        fleet = {"r0": {"queue_depth": 0, "active_slots": 0},
                 "r1": {"queue_depth": 0, "active_slots": 0}}
        col = _fake_fleet(fleet)
        probe = {"directory_replicas": ["r0", "r1"]}
        book = DetectorBook(col, control_probe=lambda: dict(probe),
                            stale_after_s=5.0)
        col.scrape_round(now=0.0)
        (c,) = [c for c in book.evaluate(1.0, {})
                if c["id"] == "directory_staleness"]
        assert not c["firing"]
        fleet["r1"] = ConnectionError("wedged")
        col.scrape_round(now=4.0)
        col.scrape_round(now=8.0)
        # r1 last answered at t=0, the directory still routes to it.
        (c,) = [c for c in book.evaluate(8.0, {})
                if c["id"] == "directory_staleness"]
        assert c["firing"] and c["detail"]["replicas"] == ["r1"]

    def test_stuck_swap_fires_after_no_progress_window(self):
        col = _fake_fleet({})
        book = DetectorBook(col, swap_stuck_s=60.0)
        probe = {"swap_target_version": 2}
        book.control_probe = lambda: dict(probe)
        mixed = self._sample(
            r0=("unified", {"weights_version": 2}),
            r1=("unified", {"weights_version": 1}))

        def stuck(t, sample):
            (c,) = [c for c in book.evaluate(t, sample)
                    if c["id"] == "stuck_swap"]
            return c

        assert not stuck(0.0, mixed)["firing"]       # clock starts
        assert not stuck(30.0, mixed)["firing"]      # within the window
        c = stuck(100.0, mixed)
        assert c["firing"] and c["detail"]["at_target"] == 1
        # Progress re-arms the clock...
        done = self._sample(
            r0=("unified", {"weights_version": 2}),
            r1=("unified", {"weights_version": 2}))
        assert not stuck(101.0, done)["firing"]
        # ...and no roll in flight can never fire.
        probe.pop("swap_target_version")
        assert not stuck(200.0, mixed)["firing"]

    def test_straggler_needs_consecutive_strikes(self):
        col = _fake_fleet({})
        book = DetectorBook(col, straggler_factor=10.0,
                            straggler_rounds=3)
        slow = self._sample(
            r0=("unified", {"ttft_ms_p99": 2000.0}),
            r1=("unified", {"ttft_ms_p99": 100.0}),
            r2=("unified", {"ttft_ms_p99": 110.0}),
            r3=("unified", {"ttft_ms_p99": 95.0}))

        def straggler(t, sample):
            (c,) = [c for c in book.evaluate(t, sample)
                    if c["id"] == "straggler_replica"]
            return c

        assert not straggler(0.0, slow)["firing"]    # strike 1
        assert not straggler(1.0, slow)["firing"]    # strike 2
        c = straggler(2.0, slow)                     # strike 3: fire
        assert c["firing"] and c["detail"]["replicas"] == ["r0"]
        # A transient spike (one clean round) resets the strikes.
        clean = self._sample(
            r0=("unified", {"ttft_ms_p99": 120.0}),
            r1=("unified", {"ttft_ms_p99": 100.0}),
            r2=("unified", {"ttft_ms_p99": 110.0}),
            r3=("unified", {"ttft_ms_p99": 95.0}))
        assert not straggler(3.0, clean)["firing"]
        assert not straggler(4.0, slow)["firing"]    # strike 1 again

    def test_straggler_respects_role_boundaries(self):
        # Prefill TTFT >> decode TTFT by DESIGN: per-role medians must
        # keep a healthy prefill tier from being flagged, and a
        # 2-replica role has no meaningful median at all.
        col = _fake_fleet({})
        book = DetectorBook(col, straggler_factor=10.0,
                            straggler_rounds=1)
        sample = self._sample(
            p0=("prefill", {"ttft_ms_p99": 4000.0}),
            p1=("prefill", {"ttft_ms_p99": 4200.0}),
            d0=("decode", {"ttft_ms_p99": 40.0}),
            d1=("decode", {"ttft_ms_p99": 45.0}),
            d2=("decode", {"ttft_ms_p99": 42.0}))
        (c,) = [c for c in book.evaluate(0.0, sample)
                if c["id"] == "straggler_replica"]
        assert not c["firing"]

    def test_collect_stale_watches_the_plane_itself(self):
        fleet = {"r0": ConnectionError("down")}
        col = _fake_fleet(fleet)
        book = DetectorBook(col, stale_after_s=5.0)
        sample = col.scrape_round(now=0.0)
        # No successful scrape EVER and a round attempted: stale.
        (c,) = [c for c in book.evaluate(0.0, sample)
                if c["id"] == "collect_stale"]
        assert c["firing"]
        fleet["r0"] = {"queue_depth": 0, "active_slots": 0}
        sample = col.scrape_round(now=1.0)
        (c,) = [c for c in book.evaluate(1.0, sample)
                if c["id"] == "collect_stale"]
        assert not c["firing"]

    def test_dying_probe_must_not_kill_the_plane(self):
        col = _fake_fleet({"r0": {"queue_depth": 0, "active_slots": 0}})

        def bad_probe():
            raise RuntimeError("controller mid-restart")

        book = DetectorBook(col, control_probe=bad_probe)
        conds = book.evaluate(0.0, {})
        assert not any(c["firing"] for c in conds)

    def test_catalog_severities_are_closed(self):
        assert all(sev in ("page", "ticket") for _, sev in DETECTORS)
        assert len(dict(DETECTORS)) == len(DETECTORS)   # unique ids


class TestAlertPlumbing:
    @staticmethod
    def _cond(firing, cid="obs_test_episode", severity="ticket"):
        return {"id": cid, "severity": severity, "firing": firing,
                "detail": {"n": 1} if firing else None}

    def test_sink_dedups_per_episode_and_rearms_on_clear(self):
        sink = AlertSink()
        assert [a["alert"] for a in sink.emit(0.0, [self._cond(True)])] \
            == ["obs_test_episode"]
        # Still firing: the episode already paged.
        assert sink.emit(1.0, [self._cond(True)]) == []
        assert sink.active() == {"obs_test_episode": 0.0}
        # Clear re-arms...
        assert sink.emit(2.0, [self._cond(False)]) == []
        assert sink.active() == {}
        # ...so the next incident is a fresh page.
        assert len(sink.emit(3.0, [self._cond(True)])) == 1
        assert sink.fired_total == 2

    def test_sink_publishes_counter_and_journal(self, tmp_path):
        before = _value(instrument._reg().snapshot(),
                        "hvd_tpu_alerts_total",
                        alert="obs_test_plumbing", severity="page")
        path = str(tmp_path / "alerts.jsonl")
        sink = AlertSink(journal_path=path)
        sink.emit(1.0, [self._cond(True, cid="obs_test_plumbing",
                                   severity="page")])
        sink.emit(2.0, [self._cond(False, cid="obs_test_plumbing",
                                   severity="page")])
        after = _value(instrument._reg().snapshot(),
                       "hvd_tpu_alerts_total",
                       alert="obs_test_plumbing", severity="page")
        assert after == before + 1   # fire edges only, not clears
        entries, intact = AlertJournal(path).read()
        assert intact
        assert [(e["event"], e["alert"]) for e in entries] == [
            ("fire", "obs_test_plumbing"), ("clear", "obs_test_plumbing")]

    def test_journal_roundtrip_and_torn_tail(self, tmp_path):
        path = str(tmp_path / "j.jsonl")
        j = AlertJournal(path)
        j.append(t=1.0, event="fire", alert="a")
        j.append(t=2.0, event="clear", alert="a")
        j.close()
        entries, intact = AlertJournal(path).read()
        assert intact and len(entries) == 2
        # A crash tears the tail mid-write: read() keeps every intact
        # record and reports the damage.
        with open(path, "ab") as f:
            f.write(b'{"t":3.0,"event":"fi')
        entries, intact = AlertJournal(path).read()
        assert not intact and len(entries) == 2
        # The resumed process repairs the tail before its first append.
        j2 = AlertJournal(path)
        j2.append(t=4.0, event="fire", alert="b")
        j2.close()
        entries, intact = AlertJournal(path).read()
        assert intact
        assert [e["t"] for e in entries] == [1.0, 2.0, 4.0]

    def test_journal_unterminated_parseable_tail_is_not_trusted(
            self, tmp_path):
        # A torn prefix can happen to parse as JSON; only a
        # newline-terminated line is known complete.
        path = str(tmp_path / "j.jsonl")
        with open(path, "wb") as f:
            f.write(b'{"t":1.0,"event":"fire","alert":"a"}\n')
            f.write(b'{"t":2.0}')
        entries, intact = AlertJournal(path).read()
        assert not intact and len(entries) == 1

    def test_journal_compacts_to_newest_half(self, tmp_path):
        path = str(tmp_path / "j.jsonl")
        j = AlertJournal(path, max_entries=4)
        for i in range(5):
            j.append(t=float(i), event="fire", alert=f"a{i}")
        j.close()
        entries, intact = AlertJournal(path).read()
        assert intact
        assert [e["alert"] for e in entries] == ["a3", "a4"]


class TestTelemetryPlaneRounds:
    def test_run_round_wires_scrape_slo_detect_sink(self, tmp_path):
        fleet = {"r0": {"queue_depth": 0, "active_slots": 0},
                 "r1": {"queue_depth": 0, "active_slots": 0}}
        col = _fake_fleet(fleet)
        plane = TelemetryPlane(
            col, slo_spec=("avail:signal=scrape_ok,target=0.9,"
                           "budget=0.05,window=20,short=4,burn=2"),
            period_s=1.0, stale_after_s=100.0,
            journal_path=str(tmp_path / "alerts.jsonl"))
        for t in range(3):
            assert plane.run_round(now=float(t)) == []
        # The whole fleet goes scrape-dead: the availability SLO burns
        # through both windows and pages exactly once per episode.
        fleet["r0"] = fleet["r1"] = ConnectionError("partition")
        fired = []
        for t in range(3, 9):
            fired += plane.run_round(now=float(t))
        assert "slo_burn:avail" in [a["alert"] for a in fired]
        assert [a["alert"] for a in fired].count("slo_burn:avail") == 1
        entries, intact = plane.sink.journal.read()
        assert intact
        assert any(e["alert"] == "slo_burn:avail" and e["event"] == "fire"
                   for e in entries)


# --- the chaos drill (scripts/chaos_soak.py --mode obs) ----------------------


@pytest.mark.chaos
class TestObsChaosDrill:
    def test_collect_fault_degrades_never_stalls(self):
        """ISSUE 20 drill (chaos_soak --mode obs): a randomized
        ``collect:*`` fault (HVD_TPU_CHAOS_SEED picks the mode from the
        drop/delay/garbage menu, HVD_TPU_CHAOS_STEP the scrape round it
        hits) against a live TelemetryPlane on a virtual clock.  The
        plane must DEGRADE — the faulted round completes with a
        ``stats_error`` entry, staleness is declared, ``collect_stale``
        pages — and then RECOVER (the alert clears, rounds keep
        flowing); it must never stall or ingest a garbage payload."""
        step = max(1, int(os.environ.get("HVD_TPU_CHAOS_STEP", "3")))
        seed = int(os.environ.get("HVD_TPU_CHAOS_SEED", "0"))
        rng = random.Random(seed * 1000003 + step)
        mode = rng.choice(["drop", "delay", "garbage"])
        spec = f"collect:step={step},mode={mode}"
        if mode == "delay":
            spec += ",delay_ms=20"
        total_rounds = step + 3

        fleet = {"r0": {"queue_depth": 1, "active_slots": 1,
                        "ttft_ms_p99": 100.0}}
        col = _fake_fleet(fleet, clock=lambda: 0.0)
        # Forgiving SLO catalog: the drill asserts the DETECTOR story;
        # a 100%-loss round against the default 5% budget would
        # (correctly) also page the availability SLO and muddy it.
        plane = TelemetryPlane(
            col, slo_spec=("avail:signal=scrape_ok,target=0.9,"
                           "budget=1.0,window=600,short=60,burn=2"),
            period_s=1.0, stale_after_s=0.5)

        # Rounds are 0-indexed like the fault site's event counter:
        # ``collect:step=N`` hits the scrape of round N exactly.
        fired_by_round = {}
        t0 = time.monotonic()
        with faults.inject(spec):
            for i in range(total_rounds):
                fired_by_round[i] = plane.run_round(now=float(i))
            history = faults.history()
        elapsed = time.monotonic() - t0

        # Never stall: every planned round ran, on time (the delay mode
        # sleeps 20ms inside one scrape; everything else is virtual).
        assert col.rounds == total_rounds
        assert elapsed < 10.0, elapsed
        assert [h[0] for h in history] == ["collect"]
        assert history[0][2].startswith(mode)

        snapshot = col.tsdb.window("scrape_ok", 0.0, {"replica": "r0"})
        fired = [a["alert"] for alerts in fired_by_round.values()
                 for a in alerts]
        if mode == "delay":
            # A slow replica inside the deadline: no data was lost and
            # nothing may page.
            assert col.scrapes_failed == 0
            assert fired == []
        else:
            # drop/garbage: exactly the faulted round degrades...
            assert col.scrapes_failed == 1
            assert [t for t, v in snapshot if v == 0.0] == [float(step)]
            # ...the plane pages about ITSELF on that round (staleness
            # 1.0 > the 0.5 bound)...
            assert [a["alert"] for a in fired_by_round[step]] == \
                ["collect_stale"]
            assert fired == ["collect_stale"]
            # ...garbage never reaches the TSDB (queue_depth has no
            # sample at the faulted round)...
            qd = col.tsdb.window("queue_depth", 0.0, {"replica": "r0"})
            assert float(step) not in [t for t, _ in qd]
            # ...and the next clean round recovers: alert cleared,
            # staleness back to zero.
            assert plane.sink.active() == {}
            assert col.staleness_s(now=float(total_rounds - 1)) == 0.0


# --- against the reference ----------------------------------------------------

_ROSTER = (("p0", "prefill"), ("d0", "decode"), ("d1", "decode"),
           ("d2", "decode"), ("u0", "unified"), ("u1", "unified"),
           ("u2", "unified"))


def _stream(seed, rounds=60):
    """Seeded rounds of per-replica answers (stats, a dead replica, a
    garbage payload) and control-probe readings."""
    rng = random.Random(seed)
    out = []
    for r in range(rounds):
        answers = {}
        for name, _ in _ROSTER:
            roll = rng.random()
            if roll < 0.08:
                answers[name] = ConnectionError("wedged")
            elif roll < 0.1:
                answers[name] = "<garbage>"
            else:
                answers[name] = {
                    "queue_depth": rng.choice([0, 1, 3, 12, 30]),
                    "active_slots": rng.randint(0, 4), "max_slots": 4,
                    "ttft_ms_p99": rng.choice([None, 80.0, 95.0, 2500.0]),
                    "weights_version": rng.choice([1, 2, 2]),
                    "qos": {"interactive": {"ttft_ms_p99": rng.choice(
                        [None, 40.0, 700.0])}}}
        probe = {"brownout_level": rng.choice([0, 0, 0, 1, 2]),
                 "scale_in_total": r // 9,
                 "shed_interactive_total": r // 25,
                 "directory_replicas": ["d0", "d1", "u0"]}
        if r >= 20:
            probe["swap_target_version"] = 2
        out.append((answers, probe))
    return out


def _plane(pkg, answers_now, probe_now, journal):
    """A TelemetryPlane of ``pkg`` over the scripted transport."""
    col_mod = jcollector if pkg == "ref" else None

    class _Client:
        def __init__(self, target):
            self._name = target.name

        def request(self, req, idempotent=True, timeout=None):
            v = answers_now[0][self._name]
            if isinstance(v, Exception):
                raise v
            return types.SimpleNamespace(stats=v)

    if pkg == "ref":
        targets = [col_mod.Target(name=n, role=r) for n, r in _ROSTER]
        col = col_mod.FleetCollector(targets, client_factory=_Client,
                                     clock=lambda: 0.0, points=64)
        plane_cls = col_mod.TelemetryPlane
    else:
        targets = [Target(name=n, role=r) for n, r in _ROSTER]
        col = FleetCollector(targets, client_factory=_Client,
                             clock=lambda: 0.0, points=64)
        plane_cls = TelemetryPlane
    return plane_cls(
        col, slo_spec=("avail:signal=scrape_ok,target=0.95,budget=0.05,"
                       "window=20,short=4,burn=2;"
                       "ttft:signal=ttft_p99_ms,target=500,budget=0.2,"
                       "window=30,short=5,burn=1.5,severity=ticket;"
                       "queue:signal=queue_depth,target=10,budget=0.3,"
                       "window=10,short=3,burn=1,severity=ticket"),
        control_probe=lambda: dict(probe_now[0]), period_s=1.0,
        stale_after_s=3.0, journal_path=journal,
        detect_overrides={"oscillation_bound": 3,
                          "oscillation_window_s": 10.0,
                          "straggler_factor": 5.0, "straggler_rounds": 2,
                          "swap_stuck_s": 8.0, "convoy_bound": 16.0})


@pytest.mark.parametrize("seed", range(3))
def test_alerts_and_journal_match_the_reference(seed, tmp_path,
                                                monkeypatch):
    """One seeded stream into both packages' planes: the alerts fired
    each round, the active set, the SLO burn rates, every TSDB series
    and the journal's lines are equal."""
    for mod in (jmetrics, pmetrics):
        monkeypatch.setattr(mod, "_default", mod.MetricsRegistry())
    stream = _stream(seed)
    runs = {}
    for pkg in ("port", "ref"):
        answers_now, probe_now = [None], [None]
        journal = str(tmp_path / f"{pkg}.jsonl")
        plane = _plane(pkg, answers_now, probe_now, journal)
        trail = []
        for r, (answers, probe) in enumerate(stream):
            answers_now[0], probe_now[0] = answers, probe
            fired = plane.run_round(now=float(r))
            trail.append([(a["alert"], a["severity"], a.get("detail"))
                          for a in fired])
        db = plane.collector.tsdb
        series = {(name, tuple(sorted(ls.items()))):
                  db.window(name, 0.0, ls or None)
                  for name in ("scrape_ok", "queue_depth", "active_slots",
                               "ttft_ms_p99", "weights_version",
                               "interactive_ttft_ms_p99", "fleet_replicas",
                               "fleet_scrape_ok_frac",
                               "fleet_queue_depth_mean", "fleet_ttft_ms_p99")
                  for ls in (db.labelsets(name) or [{}])}
        plane.sink.journal.close()
        with open(journal) as f:
            lines = f.read().splitlines()
        runs[pkg] = (trail, plane.sink.active(), plane.slos.burn_rates(),
                     series, lines, plane.collector.scrapes_failed)
    assert runs["port"] == runs["ref"]
    fired = [a for rnd in runs["port"][0] for a in rnd]
    assert len({a[0] for a in fired}) >= 4, fired
    assert all(json.loads(line) for line in runs["port"][4])


def test_collector_scrapes_real_replicas_and_feeds_the_controller():
    """The port's collector over the HMAC wire: two serving replicas'
    ``StatsRequest`` answers land in the TSDB, a listening-but-silent
    replica degrades to ``stats_error`` inside the round's one deadline,
    and a ``FleetController`` wired with ``collector=`` scales on the
    collector's round instead of polling the router."""
    import socket

    from horovod_tpu_torch.serve import (ContinuousBatcher, FleetController,
                                         InferenceEngine, InferenceServer,
                                         ReplicaLauncher, ReplicaSpec,
                                         Router, SamplingParams)
    from torch_port_serve import ENGINE_DEFAULTS, KEY, fixture

    servers = [InferenceServer(
        ContinuousBatcher(InferenceEngine(fixture()[2], **ENGINE_DEFAULTS),
                          max_queue=8, default_deadline_s=30),
        key=KEY, name=f"t{i}", host="127.0.0.1") for i in range(2)]
    silent = socket.socket()
    silent.bind(("127.0.0.1", 0))
    silent.listen(1)
    try:
        servers[0]._batcher.submit([1, 2, 3], SamplingParams(
            max_new_tokens=2)).done.wait(30)
        targets = [Target(name=s.name, addresses=(("127.0.0.1", s.port),))
                   for s in servers]
        targets.append(Target(name="silent", addresses=(
            ("127.0.0.1", silent.getsockname()[1]),)))
        col = FleetCollector(targets, key=KEY, timeout_s=0.5)
        t0 = time.monotonic()
        out = col.scrape_round()
        assert time.monotonic() - t0 < 3.0
        assert out["t0"]["stats"]["requests_completed"] == 1
        assert out["t1"]["stats"]["queue_depth"] == 0
        assert "stats_error" in out["silent"]
        assert col.tsdb.latest("fleet_replicas")[1] == 3.0
        assert col.tsdb.latest("fleet_scrape_ok_frac")[1] == 2 / 3

        class _Launcher(ReplicaLauncher):
            launched = []

            def launch(self, role, host=None):
                self.launched.append(role)
                return ReplicaSpec(f"new-{len(self.launched)}",
                                   [("127.0.0.1", 1)], role=role)

            def retire(self, name):
                pass

        router = Router([ReplicaSpec(s.name, [("127.0.0.1", s.port)])
                         for s in servers], KEY)

        def no_poll(timeout=None):
            raise AssertionError("the controller must read the collector")

        router.replica_stats = no_poll
        fresh = {n: dict(e, stats=dict(e["stats"], queue_depth=9))
                 for n, e in out.items() if "stats" in e}
        col._last_round = fresh
        ctl = FleetController(router, _Launcher(), collector=col,
                              scale_out_queue=4.0, scale_in_idle_s=3600.0)
        actions = ctl.poll_once()
        assert [a["action"] for a in actions] == ["scale_out"]
        assert _Launcher.launched == ["unified"]
    finally:
        silent.close()
        for s in servers:
            s.shutdown()
