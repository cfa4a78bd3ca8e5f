"""The port's fleet simulator (``horovod_tpu_torch/serve/fleet/sim.py``,
``sim_replica.py``, ``traces.py``) against the reference's.

``tests/test_fleet_sim.py``'s cases on the port, case for case and with
its markers: the determinism and replay contracts, the SLO invariants
under seeded faults, the death-spiral and migration-reservation
regression pins on the port's ``FleetController`` and ``Router``, the
1000-replica capacity run under the reference's 60 s wall bound, the
calibration band, the transport's edge cases and the telemetry plane's
detector drills.  Beside them the oracle that the port's control plane
decides as the reference's does: for five scenarios (kills with
failover, the prefill→decode pipeline with ``dcn`` drops, a swap roll,
a ``swap:partial-fleet`` abort, a ``qos:flood`` with ``attach_telemetry``
on) the same seed, trace, explicit ``ReplicaProfile`` and fault spec give
a byte-identical ``event_log_text()`` and an equal report in both
packages, each package's fault plan armed on its own side.  The default
profile (``load_profile``) is the JAX package's recorded CPU serving
artifacts (``SERVING_r11/r14/r15.json``), in both packages.
"""

import json
import logging
import os
import time

import pytest

from horovod_tpu import faults as jfaults
import horovod_tpu.serve.fleet.sim as jax_sim
import horovod_tpu.serve.fleet.sim_replica as jax_sim_replica
import horovod_tpu.serve.fleet.traces as jax_traces

from horovod_tpu_torch import faults
import horovod_tpu_torch.serve.fleet.sim as port_sim
import horovod_tpu_torch.serve.fleet.sim_replica as port_sim_replica
import horovod_tpu_torch.serve.fleet.traces as port_traces
from horovod_tpu_torch.serve.fleet.controller import FleetController
from horovod_tpu_torch.serve.fleet.sim import FleetSim
from horovod_tpu_torch.serve.fleet.sim_replica import LocalClient
from horovod_tpu_torch.serve.fleet.traces import (DEFAULT_PROFILE,
                                                  LatencyDist,
                                                  ReplicaProfile,
                                                  load_profile, make_trace)

pytestmark = pytest.mark.sim


@pytest.fixture(autouse=True)
def _quiet_and_clean():
    # Brownout/strike warnings are load-bearing signal in production
    # logs and pure noise across thousands of simulated control rounds.
    logging.disable(logging.WARNING)
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()
    logging.disable(logging.NOTSET)


def _balance(report):
    """Exact request accounting: every arrival ends in exactly one
    terminal state or is still in flight at the horizon."""
    terminal = (report["delivered"] + report["shed"] + report["expired"]
                + sum(1 for v in report["invariants"]["violations"]
                      if v["invariant"] == "no_lost_requests"))
    return terminal + report["in_flight_at_horizon"] == report["requests"]


# --- traces + profiles -------------------------------------------------------


class TestTraces:
    def test_lognormal_fit_pins_percentiles(self):
        d = LatencyDist(120.0, 4500.0)
        import math
        assert math.isclose(math.exp(d.mu), 120.0)
        assert math.isclose(math.exp(d.mu + 2.326 * d.sigma), 4500.0,
                            rel_tol=1e-9)

    def test_mean_p99_fit_recovers_moments(self):
        import math
        d = LatencyDist.from_mean_p99(103.117, 416.492)
        mean = math.exp(d.mu + d.sigma ** 2 / 2.0)
        assert math.isclose(mean, 103.117, rel_tol=1e-6)
        assert math.isclose(d.p99_ms, 416.492, rel_tol=1e-6)

    def test_load_profile_falls_back_without_artifacts(self, tmp_path):
        prof = load_profile(root=str(tmp_path))
        assert prof.source == "defaults"
        assert prof.ttft_ms == DEFAULT_PROFILE.ttft_ms

    def test_load_profile_reads_recorded_artifacts(self, tmp_path):
        (tmp_path / "SERVING_r11.json").write_text(json.dumps({
            "summary": {"unified_ttft_ms_p50": 100.0,
                        "unified_ttft_ms_p99": 400.0,
                        "migrate_ms_mean": 50.0,
                        "migrate_ms_p99": 200.0}}))
        prof = load_profile(root=str(tmp_path))
        assert prof.ttft_ms == LatencyDist(100.0, 400.0)
        assert "SERVING_r11" in prof.source

    def test_trace_is_seeded_and_well_formed(self):
        a = make_trace(500, seed=3)
        b = make_trace(500, seed=3)
        assert a == b
        assert a != make_trace(500, seed=4)
        last = 0.0
        for req in a:
            assert req.arrival_s >= last     # arrivals ordered
            last = req.arrival_s
            assert req.qos_class in ("interactive", "standard", "batch")
            if req.qos_class == "batch":
                assert req.deadline is None
            else:
                assert req.deadline > req.arrival_s   # absolute
        ids = [r.request_id for r in a]
        assert len(set(ids)) == len(ids)


# --- determinism + replay ----------------------------------------------------


class TestDeterminism:
    SPEC = "serve:p=0.002,seed=11,mode=kill;qos:step=40,mode=invert"

    def _run(self, **kw):
        trace = make_trace(1200, seed=3, rate_rps=250.0)
        sim = FleetSim(replicas=4, seed=3, **kw)
        report = sim.run(trace, fault_spec=self.SPEC)
        return sim, report

    def test_same_seed_same_bytes_twice(self):
        sim1, rep1 = self._run()
        sim2, rep2 = self._run()
        log1 = sim1.event_log_text().encode()
        log2 = sim2.event_log_text().encode()
        assert log1 == log2          # byte-identical event logs
        assert rep1 == rep2          # and identical metrics
        assert len(log1) > 10_000    # a real run, not an empty log

    def test_different_seed_diverges(self):
        trace = make_trace(300, seed=5, rate_rps=200.0)
        a = FleetSim(replicas=4, seed=5)
        b = FleetSim(replicas=4, seed=6)
        a.run(trace, fault_spec=self.SPEC)
        b.run(trace, fault_spec=self.SPEC)
        assert a.event_log_text() != b.event_log_text()

    def test_recorded_failure_replays_to_same_violation(self):
        """The debugging contract: a config that produced an invariant
        violation re-runs to the SAME violation (same invariant, same
        virtual time, same context) with an identical event log."""
        def failing_run():
            trace = make_trace(800, seed=9, rate_rps=400.0)
            # oscillation_bound=0: the first ladder transition is a
            # violation — a deterministic stand-in for a real policy
            # bug found at fleet scale.
            sim = FleetSim(replicas=2, seed=9, oscillation_bound=0)
            report = sim.run(trace)
            return sim, report

        sim1, rep1 = failing_run()
        assert rep1["invariants"]["violations_total"] >= 1
        first = rep1["invariants"]["violations"][0]
        assert first["invariant"] == "no_ladder_oscillation"
        sim2, rep2 = failing_run()
        assert rep2["invariants"]["violations"][0] == first
        assert sim1.event_log_text() == sim2.event_log_text()


# --- SLO invariants under fault injection ------------------------------------


class TestInvariants:
    def test_overload_sheds_but_never_interactive(self):
        trace = make_trace(2000, seed=7, rate_rps=300.0)
        sim = FleetSim(replicas=4, seed=7)
        report = sim.run(trace)
        assert report["shed"] > 0                      # ladder tripped
        assert report["brownout_level_max"] >= 1
        assert report["invariants"]["violations_total"] == 0
        assert report["invariants"]["checks"]["never_shed_interactive"] \
            == report["shed"]
        assert _balance(report)

    def test_replica_kills_fail_over_without_loss(self):
        trace = make_trace(1500, seed=3, rate_rps=250.0)
        sim = FleetSim(replicas=4, seed=3)
        report = sim.run(
            trace, fault_spec="serve:p=0.003,seed=11,mode=kill")
        assert report["kills"] >= 1
        assert report["retries"] >= 1                  # orphans re-ran
        assert report["invariants"]["violations_total"] == 0
        assert _balance(report)

    def test_pipeline_migration_with_dcn_drops(self):
        trace = make_trace(1200, seed=11, rate_rps=150.0)
        sim = FleetSim(roles={"prefill": 2, "decode": 2}, seed=11)
        report = sim.run(trace, fault_spec="dcn:p=0.05,seed=4,mode=drop")
        assert report["migrations_ok"] > 0
        assert report["migrations_failed"] > 0         # drops happened
        assert report["invariants"]["violations_total"] == 0
        assert report["invariants"]["checks"]["at_most_once"] \
            == report["delivered"]
        assert _balance(report)

    def test_swap_roll_converges_fleet_version(self):
        trace = make_trace(1000, seed=5, rate_rps=150.0)
        sim = FleetSim(replicas=4, seed=5)
        report = sim.run(trace, swap_rolls=[(3.0, 42)])
        assert report["invariants"]["violations_total"] == 0
        assert report["invariants"]["checks"][
            "swap_autoscaler_non_interference"] == 1
        for rep in sim._replicas.values():
            if rep.alive:
                assert rep.weights_version == 42

    def test_partial_fleet_roll_abort_is_not_a_violation(self):
        trace = make_trace(800, seed=9, rate_rps=100.0)
        sim = FleetSim(replicas=4, seed=9)
        report = sim.run(trace, swap_rolls=[(2.0, 7)],
                         fault_spec="swap:step=2,mode=partial-fleet")
        rolls = [e for e in sim.events if e["kind"] == "swap_roll"]
        assert rolls and rolls[0]["aborted"]
        assert 0 < rolls[0]["ok"] < rolls[0]["total"]  # mixed fleet
        assert report["invariants"]["violations_total"] == 0

    def test_directory_staleness_stays_bounded_across_kills(self):
        trace = make_trace(2000, seed=13, rate_rps=200.0)
        sim = FleetSim(replicas=6, seed=13)
        report = sim.run(trace,
                         fault_spec="serve:p=0.004,seed=5,mode=kill")
        assert report["kills"] >= 1
        assert report["invariants"]["violations_total"] == 0
        assert _balance(report)

    def test_autoscaler_reacts_to_bursts(self):
        trace = make_trace(2000, seed=7, rate_rps=300.0)
        sim = FleetSim(replicas=4, seed=7)
        report = sim.run(trace)
        assert report["scale_out"] >= 1
        assert report["invariants"]["violations_total"] == 0

    def test_qos_flood_is_absorbed_by_shedding(self):
        trace = make_trace(1000, seed=17, rate_rps=150.0)
        sim = FleetSim(replicas=4, seed=17)
        report = sim.run(trace, fault_spec="qos:step=200,mode=flood")
        assert report["faults_fired"] >= 1
        assert report["requests"] > len(trace)         # flood arrived
        assert report["invariants"]["violations_total"] == 0
        assert _balance(report)


# --- the death-spiral regression pin -----------------------------------------


class _StubBrownout:
    def __init__(self, level):
        self.level = level


class _StubGate:
    def __init__(self, level):
        self.brownout = _StubBrownout(level)

    def observe(self, queue_depth_mean, interactive_ttft_p99_ms=None,
                now=None):
        return self.brownout.level


class _StubRouter:
    """Two idle unified replicas, as the controller sees them."""

    def __init__(self):
        self.qos_gate = None
        self.drained = []

    def replica_stats(self, timeout=5.0):
        stats = {"queue_depth": 0, "active_slots": 0, "max_slots": 8,
                 "ttft_ms_p99": None, "qos": {}}
        return {name: {"name": name, "role": "unified",
                       "draining": False, "stats": dict(stats)}
                for name in ("r0", "r1")}

    def drain_replica(self, name, timeout=5.0):
        self.drained.append(name)


class TestDeathSpiralRegression:
    """The control-plane weakness the simulator found in the REAL
    ``FleetController`` (fixed in ``poll_once``): at brownout level >
    0 the queues look calm precisely BECAUSE traffic is being shed, so
    an idle role is an artifact of the shed, not spare capacity.
    Scaling in shrank the fleet the un-shed backlog then re-flooded —
    shed → scale-in → overload → shed, an oscillation the
    ``no_ladder_oscillation`` invariant flagged at 1000 replicas."""

    def _controller(self, router, level):
        return FleetController(router, launcher=None, min_per_role=1,
                               scale_in_idle_s=10.0,
                               qos_gate=_StubGate(level),
                               clock=lambda: 0.0)

    def test_no_scale_in_while_shedding(self):
        router = _StubRouter()
        ctl = self._controller(router, level=1)
        ctl.poll_once(now=0.0)
        actions = ctl.poll_once(now=100.0)   # idle >> scale_in_idle_s
        assert actions == []                 # the ladder is up: hold
        assert router.drained == []

    def test_scale_in_resumes_when_ladder_clears(self):
        router = _StubRouter()
        ctl = self._controller(router, level=0)
        ctl.poll_once(now=0.0)
        actions = ctl.poll_once(now=100.0)
        assert any(a["action"] == "drain" for a in actions)
        assert router.drained == ["r1"]

    def test_idle_clock_restarts_after_brownout(self):
        """The ladder clearing must not inherit pre-brownout idle time:
        the idle clock starts from the clear, not from the last real
        traffic."""
        router = _StubRouter()
        gate = _StubGate(1)
        ctl = FleetController(router, launcher=None, min_per_role=1,
                              scale_in_idle_s=10.0, qos_gate=gate,
                              clock=lambda: 0.0)
        ctl.poll_once(now=0.0)
        ctl.poll_once(now=100.0)             # still shedding: no drain
        gate.brownout.level = 0
        actions = ctl.poll_once(now=101.0)   # cleared 1s ago: too soon
        assert actions == []
        actions = ctl.poll_once(now=112.0)   # 11s of REAL calm: drain
        assert any(a["action"] == "drain" for a in actions)

    def test_sim_scenario_stays_stable_end_to_end(self):
        """The fleet-scale scenario that exposed the spiral, on the
        fixed controller: bursty overload trips the ladder, and the
        ladder/autoscaler interplay settles without oscillation."""
        trace = make_trace(3000, seed=21, rate_rps=400.0,
                           burst_factor=5.0)
        sim = FleetSim(replicas=4, seed=21, scale_in_idle_s=5.0)
        report = sim.run(trace)
        assert report["brownout_level_max"] >= 1
        assert report["invariants"]["violations_total"] == 0
        assert _balance(report)


# --- the migration-reservation regression pin --------------------------------


class TestMigrationReservationRegression:
    """Second simulator-found control-plane weakness, pinned against
    the REAL router: the decode migration target used to carry no
    ``inflight`` until its collect started, so every concurrent
    pipeline submit saw the same least-loaded decode and the fleet
    convoyed its migrations into one receiver (``no_migration_convoy``
    tripped at 16 role-split replicas under 400 rps).  The fix
    reserves the decode's inflight slot at pick time and hands it off
    to the collect."""

    @staticmethod
    def _pipeline_router(migrated: bool = True):
        import threading

        from horovod_tpu_torch.runner.common.network import CollectRequest
        from horovod_tpu_torch.serve.router import ReplicaSpec, Router
        from horovod_tpu_torch.serve.server import (GenerateRequest,
                                                    GenerateResponse)
        from horovod_tpu_torch.utils.retry import RetryPolicy

        hold = threading.Event()      # gates the prefill generate
        entered = threading.Event()   # prefill generate has started

        class _Client:
            def __init__(self, spec):
                self.spec = spec

            def request(self, frame, idempotent=False, timeout=None):
                if isinstance(frame, GenerateRequest):
                    assert self.spec.role == "prefill"
                    entered.set()
                    assert hold.wait(10.0)
                    return GenerateResponse(
                        frame.request_id, [1], ttft_ms=1.0,
                        migrated_to=(frame.migrate_to[0]
                                     if migrated else None),
                        migrate_ms=0.5)
                if isinstance(frame, CollectRequest):
                    return GenerateResponse(frame.request_id, [1, 2])
                raise AssertionError(f"unexpected frame {frame!r}")

        specs = [ReplicaSpec("p0", [("h", 1)], role="prefill"),
                 ReplicaSpec("d0", [("h", 2)], role="decode"),
                 ReplicaSpec("d1", [("h", 3)], role="decode")]
        router = Router(specs, key=b"k",
                        retry_policy=RetryPolicy(attempts=1,
                                                 base_delay_s=0.0,
                                                 max_delay_s=0.0,
                                                 jitter=0.0),
                        client_factory=_Client)
        return router, hold, entered

    def test_decode_target_reserved_during_prefill(self):
        import threading

        router, hold, entered = self._pipeline_router()
        t = threading.Thread(
            target=lambda: router.generate([1, 2, 3], request_id="ra"))
        t.start()
        try:
            assert entered.wait(5.0)
            d0, d1 = router._find("d0"), router._find("d1")
            # The first submit ties both decodes at 0 inflight and
            # deterministically picks d0; while its prefill+migration
            # window is open the reservation must make a fresh pick
            # spread to d1 — pre-fix both would read 0 and pile on d0.
            assert (d0.inflight, d1.inflight) == (1, 0)
            assert router._pick_role("decode") is d1
        finally:
            hold.set()
            t.join(10.0)
        assert not t.is_alive()
        assert (d0.inflight, d1.inflight) == (0, 0)

    def test_fallback_releases_reservation(self):
        """A migration that falls back to the prefill replica
        (``migrated_to is None``) must not leak the decode's
        reservation."""
        router, hold, entered = self._pipeline_router(migrated=False)
        hold.set()
        resp = router.generate([1, 2, 3], request_id="rb")
        assert resp.error is None and resp.migrated_to is None
        d0, d1 = router._find("d0"), router._find("d1")
        assert (d0.inflight, d1.inflight) == (0, 0)

    def test_sim_scenario_no_convoy_end_to_end(self):
        """The scenario that exposed the convoy (role-split fleet,
        overload, kills + DCN delays, a mid-run swap roll) runs clean
        on the fixed router."""
        trace = make_trace(3000, seed=5, rate_rps=400.0)
        sim = FleetSim(replicas=16, seed=5,
                       roles={"prefill": 8, "decode": 8},
                       max_replicas=24)
        report = sim.run(
            trace,
            fault_spec="serve:p=0.003,seed=9,mode=kill;"
                       "dcn:p=0.05,seed=4,mode=delay,delay_ms=40",
            swap_rolls=[(3.0, 7)])
        assert report["invariants"]["violations_total"] == 0, \
            report["invariants"]["violations"][:4]
        assert report["migrations_ok"] > 0
        assert _balance(report)


# --- capacity + calibration -------------------------------------------------


class TestScaleAndCalibration:
    def test_thousand_replicas_ten_thousand_requests_under_budget(self):
        t0 = time.monotonic()
        trace = make_trace(10_000, seed=1, rate_rps=2000.0)
        sim = FleetSim(replicas=1000, seed=1, max_replicas=1000,
                       record_events=False)
        report = sim.run(
            trace, fault_spec="serve:p=0.001,seed=2,mode=kill")
        wall = time.monotonic() - t0
        assert wall < 60.0, f"1000-replica sim took {wall:.1f}s"
        assert report["requests"] == 10_000
        assert report["kills"] >= 1
        assert report["invariants"]["violations_total"] == 0
        assert report["invariants"]["checks_total"] > 0
        assert _balance(report)

    def test_unloaded_sim_matches_profile_percentiles(self):
        """The calibration oracle: an unloaded
        4-replica run's end-to-end TTFT percentiles must reproduce the
        measured distribution the profile was fitted from to ±15% —
        queueing is ~zero, so the pipeline + sampler is what's
        tested."""
        prof = load_profile()
        trace = make_trace(2000, seed=13, rate_rps=5.0,
                           burst_factor=1.0)
        sim = FleetSim(replicas=4, seed=13, profile=prof,
                       scale_in_idle_s=1e9)
        report = sim.run(trace)
        assert report["shed"] == 0 and report["expired"] == 0
        for got, want in ((report["ttft_ms_p50"], prof.ttft_ms.p50_ms),
                          (report["ttft_ms_p99"], prof.ttft_ms.p99_ms)):
            assert abs(got - want) / want < 0.15, (got, want)


# --- transport edge cases ----------------------------------------------------


class TestLocalClient:
    def test_dead_replica_raises_connection_error(self):
        sim = FleetSim(replicas=2, seed=0)
        name = next(iter(sim._replicas))
        sim._replicas[name].alive = False
        client = LocalClient(sim, name)
        from horovod_tpu_torch.serve.server import StatsRequest
        with pytest.raises(ConnectionError):
            client.request(StatsRequest())

    def test_generate_frames_are_rejected(self):
        sim = FleetSim(replicas=2, seed=0)
        name = next(iter(sim._replicas))
        client = LocalClient(sim, name)
        from horovod_tpu_torch.serve.server import GenerateRequest
        with pytest.raises(ConnectionError):
            client.request(GenerateRequest(request_id="x", prompt=[1]))


# --- the live telemetry plane, in-sim ---------------------------------------


def _rounds_to_fire(alerts, onset, alert_id, period_s=1.0):
    """Collection rounds from ground-truth onset to the firing edge;
    None = the detector never fired (an acceptance failure)."""
    import math

    fired = [a for a in alerts if a["alert"] == alert_id]
    if not fired:
        return None
    return max(1, math.ceil((fired[0]["t"] - onset) / period_s))


class TestTelemetryDrills:
    """The detector drills: the two historical control-plane bugs are
    re-introduced via the ``control`` fault site, and the SAME
    ``obs/collector.py`` plane production runs — scraping through the
    ``LocalClient`` transport on the virtual clock — must page within
    3 collection rounds of ground-truth onset, while clean seeded runs
    stay silent (the zero-false-alert gate)."""

    def test_death_spiral_pages_within_three_rounds(self):
        # The pre-fix bug: idle clocks tick during a shed, so the
        # controller drains capacity away from an overloaded fleet.
        sim = FleetSim(replicas=4, seed=3, max_slots=2,
                       queue_capacity=16, brownout_high=0.5,
                       brownout_low=0.2, brownout_hold_s=10.0,
                       scale_in_idle_s=1.0, record_events=False)
        sim.attach_telemetry()
        rep = sim.run(make_trace(2000, seed=3, rate_rps=120.0,
                                 burst_factor=6.0),
                      fault_spec="control:p=1.0,seed=1,mode=spiral")
        # The sim records ground truth: the first drain issued while
        # the ladder was shedding.
        onset = rep["spiral_onset_t"]
        rounds = _rounds_to_fire(sim.alerts, onset, "ladder_oscillation")
        assert rounds is not None, rep.get("alerts")
        assert rounds <= 3, (rounds, onset, sim.alerts[:4])
        (fired,) = [a for a in sim.alerts
                    if a["alert"] == "ladder_oscillation"][:1]
        assert fired["severity"] == "page"

    def test_migration_convoy_pages_within_three_rounds(self):
        # The pre-fix bug: the decode-side reservation deferred from
        # pick time to adoption, so with slow transfers + long decodes
        # every prefill piles onto the same least-loaded target.
        prof = ReplicaProfile(ttft_ms=LatencyDist(80.0, 300.0),
                              tpot_ms=LatencyDist(30.0, 60.0),
                              migrate_ms=LatencyDist(2500.0, 5000.0),
                              swap_ms=LatencyDist(950.0, 3600.0))
        sim = FleetSim(roles={"prefill": 4, "decode": 4}, seed=5,
                       max_slots=4, profile=prof, convoy_bound=8,
                       record_events=False)
        sim.attach_telemetry(detect_overrides={"convoy_bound": 8.0})
        rep = sim.run(make_trace(1200, seed=5, rate_rps=150.0,
                                 prefix_pool=4096, prefix_skew=1.0,
                                 max_new_tokens=128),
                      fault_spec="control:p=1.0,seed=2,mode=convoy")
        onsets = [v["t"] for v in rep["invariants"]["violations"]
                  if v["invariant"] == "no_migration_convoy"]
        assert onsets, "the convoy bug did not reproduce"
        rounds = _rounds_to_fire(sim.alerts, min(onsets),
                                 "migration_convoy")
        assert rounds is not None, rep.get("alerts")
        assert rounds <= 3, (rounds, min(onsets), sim.alerts[:4])

    @pytest.mark.parametrize("seed", (1, 2, 4))
    def test_clean_seeded_runs_stay_silent(self, seed):
        # Zero tolerance: a plane that false-pages on a healthy fleet
        # trains operators to silence it.
        sim = FleetSim(replicas=6, seed=seed, record_events=False)
        sim.attach_telemetry()
        rep = sim.run(make_trace(300, seed=seed, rate_rps=40.0))
        assert rep["alerts_fired"] == 0, rep["alerts"]
        assert rep["invariants"]["violations_total"] == 0
        assert sim._telemetry.collector.rounds > 0
        assert sim._telemetry.collector.scrapes_failed == 0

    def test_thousand_replica_fleet_scrapes_on_the_virtual_clock(self):
        # The clock= injection point is the whole reason the SAME
        # collector can run here: 1000 replicas per round, pure virtual
        # time, still seconds of wall time.
        t0 = time.monotonic()
        sim = FleetSim(replicas=1000, seed=1, max_replicas=1000,
                       record_events=False)
        sim.attach_telemetry()
        rep = sim.run(make_trace(2000, seed=1, rate_rps=2000.0))
        wall = time.monotonic() - t0
        col = sim._telemetry.collector
        assert col.rounds >= 1
        # Scale-in drains idle replicas as the trace tails off, so pin
        # the peak of the fleet-size series, not its final sample.
        sizes = [v for _, v in col.tsdb.window("fleet_replicas", 0.0)]
        assert max(sizes) == 1000.0, max(sizes)
        # Across 1000 lognormal replicas a 10x straggler ticket is
        # statistically expected; what must never fire is a page.
        pages = [a for a in rep["alerts"] if a["severity"] == "page"]
        assert pages == [], pages
        assert wall < 60.0, wall


# --- the chaos drill ---------------------------------------------------------


@pytest.mark.chaos
class TestChaosSim:
    """Randomized fleet-scale drill: the soak harness sweeps
    ``HVD_TPU_CHAOS_STEP``/``HVD_TPU_CHAOS_SEED`` across a fault menu
    drawn from the full vocabulary; every draw must hold every SLO
    invariant with exact request accounting."""

    MENU = (
        "serve:p=0.003,seed={s},mode=kill",
        "serve:p=0.01,seed={s},mode=migrate-drop;dcn:p=0.02,seed={s},"
        "mode=delay,delay_ms=200",
        "dcn:p=0.05,seed={s},mode=drop",
        "swap:step=1,mode=stall,delay_ms=2000",
        "qos:step={step},mode=invert",
        "qos:step={step},mode=flood",
    )

    def test_randomized_fault_sweep_holds_invariants(self):
        step = int(os.environ.get("HVD_TPU_CHAOS_STEP", "0"))
        seed = int(os.environ.get("HVD_TPU_CHAOS_SEED", "0"))
        spec = self.MENU[step % len(self.MENU)].format(
            s=seed % 97, step=50 + step % 100)
        roles = ({"prefill": 2, "decode": 2} if seed % 2
                 else None)
        sim = FleetSim(replicas=4, roles=roles, seed=seed)
        trace = make_trace(1500, seed=seed, rate_rps=200.0)
        swap_rolls = [(2.0, 5)] if "swap:" in spec else []
        report = sim.run(trace, fault_spec=spec, swap_rolls=swap_rolls)
        assert report["invariants"]["violations_total"] == 0, \
            report["invariants"]["violations"][:5]
        assert _balance(report)
        assert report["delivered"] > 0


# --- the port's simulator against the reference's -----------------------------

def _profile(traces):
    """One explicit profile in ``traces``' own classes (the defaults'
    numbers), so neither package reads the repo's artifacts."""
    return traces.ReplicaProfile(
        ttft_ms=traces.LatencyDist(120.0, 4500.0),
        tpot_ms=traces.LatencyDist(2.4, 2.8),
        migrate_ms=traces.LatencyDist(80.0, 420.0),
        swap_ms=traces.LatencyDist(950.0, 3600.0), source="parity")


# (name, FleetSim keywords, make_trace(n, keywords), run keywords,
#  attach_telemetry)
PARITY = (
    ("kills", dict(replicas=4, seed=3), (1500, dict(seed=3, rate_rps=250.0)),
     dict(fault_spec="serve:p=0.003,seed=11,mode=kill"), False),
    ("pipeline-dcn", dict(roles={"prefill": 2, "decode": 2}, seed=11),
     (1200, dict(seed=11, rate_rps=150.0)),
     dict(fault_spec="dcn:p=0.05,seed=4,mode=drop"), False),
    ("swap-roll", dict(replicas=4, seed=5), (1000, dict(seed=5,
                                                        rate_rps=150.0)),
     dict(swap_rolls=[(3.0, 42)]), False),
    ("partial-fleet", dict(replicas=4, seed=9),
     (800, dict(seed=9, rate_rps=100.0)),
     dict(swap_rolls=[(2.0, 7)],
          fault_spec="swap:step=2,mode=partial-fleet"), False),
    ("qos-flood", dict(replicas=4, seed=17),
     (1000, dict(seed=17, rate_rps=150.0)),
     dict(fault_spec="qos:step=200,mode=flood"), True),
)


def _parity_run(sim_mod, traces_mod, sim_kw, trace_args, run_kw, telemetry):
    n, trace_kw = trace_args
    sim = sim_mod.FleetSim(profile=_profile(traces_mod), **sim_kw)
    if telemetry:
        sim.attach_telemetry()
    report = sim.run(traces_mod.make_trace(n, **trace_kw), **run_kw)
    return sim, report


class TestAgainstTheReference:
    @pytest.mark.parametrize("case", PARITY, ids=[c[0] for c in PARITY])
    def test_event_log_and_report_equal_the_references(self, case):
        """The same seed, trace, profile and fault spec: a byte-identical
        event log and an equal report — the port's router, controller,
        QoS gate and queues, telemetry plane and fault plan decide as the
        reference's do, event for event."""
        name, sim_kw, trace_args, run_kw, telemetry = case
        ref, ref_report = _parity_run(jax_sim, jax_traces, sim_kw,
                                      trace_args, run_kw, telemetry)
        port, report = _parity_run(port_sim, port_traces, sim_kw,
                                   trace_args, run_kw, telemetry)
        log, ref_log = port.event_log_text(), ref.event_log_text()
        assert len(log) > 10_000
        assert log.encode() == ref_log.encode()
        assert report == ref_report
        assert report["invariants"]["violations_total"] == 0
        fired = {"kills": report["kills"],
                 "pipeline-dcn": report["migrations_failed"],
                 "swap-roll": report["invariants"]["checks"][
                     "swap_autoscaler_non_interference"],
                 "partial-fleet": sum(e["kind"] == "swap_roll"
                                      and e["aborted"]
                                      for e in port.events),
                 "qos-flood": report["faults_fired"]}[name]
        assert fired >= 1, name
        if telemetry:
            assert "alerts_fired" in report

    def test_traces_and_fits_equal_the_references(self):
        """The same seeded trace, field for field, and the same
        closed-form fits."""
        a = port_traces.make_trace(500, seed=3)
        b = jax_traces.make_trace(500, seed=3)
        assert [tuple(vars(r).values()) for r in a] == \
            [tuple(vars(r).values()) for r in b]
        for p50, p99 in ((120.0, 4500.0), (53.852, 1509.775)):
            assert port_traces.LatencyDist(p50, p99).sigma == \
                jax_traces.LatencyDist(p50, p99).sigma
        fit = port_traces.LatencyDist.from_mean_p99(103.117, 416.492)
        ref = jax_traces.LatencyDist.from_mean_p99(103.117, 416.492)
        assert (fit.p50_ms, fit.p99_ms) == (ref.p50_ms, ref.p99_ms)
        mine, theirs = port_traces.load_profile(), jax_traces.load_profile()
        for field in ("ttft_ms", "tpot_ms", "migrate_ms", "swap_ms"):
            a, b = getattr(mine, field), getattr(theirs, field)
            assert (a.p50_ms, a.p99_ms) == (b.p50_ms, b.p99_ms), field
        assert mine.source == theirs.source

    def test_module_names_match_the_references(self):
        for ref, port in ((jax_sim, port_sim),
                          (jax_sim_replica, port_sim_replica),
                          (jax_traces, port_traces)):
            names = {n for n in dir(ref) if not n.startswith("_")
                     and getattr(getattr(ref, n), "__module__", ref.__name__)
                     == ref.__name__}
            missing = sorted(n for n in names if not hasattr(port, n))
            assert names and missing == [], (ref.__name__, missing)
