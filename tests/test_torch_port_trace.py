"""The port's tracing and crash flight recorder
(``horovod_tpu_torch/obs/trace.py`` + ``flight.py``) against the
reference's.

Mirrors ``tests/test_trace.py``'s ``TestSpanBasics``, ``TestDeferredRoot``
(not its Timeline-mirror case: the port has no timeline yet),
``TestPropagation`` (in-process), ``TestClockOffset``, ``TestMerge``,
``TestCriticalPath`` and ``TestFlightRecorder`` (not its fault-site case:
``faults.py`` is not ported, so a dump's ``fault_spec`` is None and its
``fault_history`` empty).  Parity:

* the pure functions (``estimate_clock_offset``, ``merge_traces``,
  ``unresolved_parents``, ``trace_ids``, ``critical_path`` and the
  document ``dump_merged`` writes) give equal outputs on the same seeded
  inputs;
* the same span program (nested spans, roots, instants, explicit
  parents, an escaping exception) gives the same names, parent
  structure, kinds and args in both packages (ids are random, so the
  structure is compared, not the ids);
* the plan compile's span and axes gauge as the reference's;
* flight events and a dump's keys equal the reference's.
"""

import json
import os
import threading

import numpy as np
import pytest

from horovod_tpu.obs import flight as jflight
from horovod_tpu.obs import trace as jtrace

from horovod_tpu_torch.obs import flight, trace

PKGS = {"ref": (jtrace, jflight), "port": (trace, flight)}


@pytest.fixture(autouse=True)
def _clean_rings():
    """Both packages' rings start clean and enabled, and are left so."""
    for tr, fl in PKGS.values():
        tr.configure(enabled=True)
        tr.clear()
        fl.reset_for_tests()
        fl.configure(enabled=True)
    yield
    for tr, fl in PKGS.values():
        tr.configure(enabled=True, ring=2048)
        tr.clear()
        fl.reset_for_tests()


def _by_name(spans, name):
    return [s for s in spans if s["name"] == name]


# --- span semantics ---------------------------------------------------------------

class TestSpanBasics:
    def test_nested_spans_parent_under_one_trace(self):
        with trace.span("hvd_tpu_step", root=True) as root_ctx:
            with trace.span("hvd_tpu_rpc_client", kind="client") as child:
                assert child[0] == root_ctx[0]
        spans = trace.snapshot()
        (root,) = _by_name(spans, "hvd_tpu_step")
        (kid,) = _by_name(spans, "hvd_tpu_rpc_client")
        assert root["parent_id"] is None
        assert kid["parent_id"] == root["span_id"]
        assert kid["trace_id"] == root["trace_id"]
        assert root["dur_us"] >= kid["dur_us"] >= 0
        assert root["pid"] == os.getpid()

    def test_root_forces_fresh_trace(self):
        with trace.span("hvd_tpu_step", root=True):
            with trace.span("hvd_tpu_step", root=True) as inner:
                pass
        spans = trace.snapshot()
        assert len(trace.trace_ids(spans)) == 2
        inner_rec = [s for s in spans if s["span_id"] == inner[1]][0]
        assert inner_rec["parent_id"] is None

    def test_explicit_parent_grafts_remote_context(self):
        remote = ("ab" * 16, "cd" * 8)
        with trace.span("hvd_tpu_rpc_server", parent=remote, kind="server"):
            pass
        (rec,) = trace.snapshot()
        assert rec["trace_id"] == remote[0]
        assert rec["parent_id"] == remote[1]

    def test_disabled_records_nothing_and_yields_none(self):
        trace.configure(enabled=False)
        with trace.span("hvd_tpu_step", root=True) as ctx:
            assert ctx is None
            assert trace.instant("hvd_tpu_fault") is None
        assert trace.record_span("x", parent=None, start_us=0.0,
                                 dur_us=1.0) is None
        assert trace.snapshot() == []

    def test_escaping_exception_recorded_in_args(self):
        with pytest.raises(RuntimeError):
            with trace.span("hvd_tpu_step", root=True):
                raise RuntimeError("boom")
        (rec,) = trace.snapshot()
        assert rec["args"]["error"] == "RuntimeError"

    def test_instant_parents_to_current_context(self):
        with trace.span("hvd_tpu_step", root=True) as ctx:
            trace.instant("hvd_tpu_fault", args={"site": "collective"})
        fault = _by_name(trace.snapshot(), "hvd_tpu_fault")[0]
        assert fault["trace_id"] == ctx[0]
        assert fault["parent_id"] == ctx[1]
        assert fault["dur_us"] == 0.0

    def test_ring_is_bounded_and_resize_keeps_newest(self):
        trace.configure(ring=8)
        for i in range(20):
            trace.record_span("hvd_tpu_step", parent=None, start_us=float(i),
                              dur_us=1.0, args={"i": i})
        spans = trace.snapshot()
        assert len(spans) == 8
        assert [s["args"]["i"] for s in spans] == list(range(12, 20))
        trace.configure(ring=4)
        assert [s["args"]["i"] for s in trace.snapshot()] == [16, 17, 18, 19]
        assert trace.snapshot(clear=True) and trace.snapshot() == []

    def test_context_is_thread_local(self):
        seen = {}

        def worker():
            seen["ctx"] = trace.current()

        with trace.span("hvd_tpu_step", root=True):
            t = threading.Thread(target=worker)
            t.start()
            t.join()
        assert seen["ctx"] is None


def _program(tr):
    """One span program: nested spans, a second root, an explicit remote
    parent, an instant, a deferred root and an escaping exception."""
    with tr.span("hvd_tpu_step", root=True, args={"kind": "train",
                                                  "step": 0}):
        with tr.span("hvd_tpu_topo_rs_intra", args={"bytes": 64,
                                                     "kernel": "spmd"}):
            tr.instant("hvd_tpu_fault", args={"site": "dcn"})
        with tr.span("hvd_tpu_topo_xpod", args={"bytes": 32}):
            pass
    with tr.span("hvd_tpu_rpc_server", parent=("ab" * 16, "cd" * 8),
                 kind="server"):
        pass
    ctx = tr.new_context()
    with tr.use_context(ctx):
        with tr.span("hvd_tpu_serve_prefill"):
            pass
    tr.record_span("hvd_tpu_serve_request", parent=None,
                   start_us=tr.now_us() - 10.0, dur_us=10.0, ctx=ctx)
    try:
        with tr.span("hvd_tpu_plan_compile", root=True,
                     args={"spec": "data=2"}):
            raise ValueError("bad")
    except ValueError:
        pass


def _structure(spans, args=True):
    """Spans with their ids replaced by first-appearance indices (with
    ``args=False`` only the args' keys kept)."""
    ids = {}

    def index(value):
        if value is None:
            return None
        return ids.setdefault(value, len(ids))

    return [(s["name"], s["kind"], s["args"] if args else sorted(s["args"]),
             index(s["trace_id"]), index(s["span_id"]),
             index(s["parent_id"]))
            for s in spans]


def test_span_structure_matches_the_reference():
    """The same program in both packages: equal names, kinds, args and
    parent structure; equal record keys."""
    for tr, _ in PKGS.values():
        _program(tr)
    ref, port = jtrace.snapshot(), trace.snapshot()
    assert _structure(port) == _structure(ref)
    assert [sorted(s) for s in port] == [sorted(s) for s in ref]


class TestDeferredRoot:
    def test_deferred_root_joins_its_trace(self):
        ctx = trace.new_context()
        with trace.use_context(ctx):
            with trace.span("hvd_tpu_serve_prefill") as child:
                assert child[0] == ctx[0]
        t0 = trace.now_us()
        sid = trace.record_span("hvd_tpu_serve_request", parent=None,
                                start_us=t0 - 5_000.0, dur_us=5_000.0,
                                ctx=ctx)
        assert sid == ctx[1]
        spans = trace.snapshot()
        assert trace.unresolved_parents(spans) == []
        rep = trace.critical_path(spans, ctx[0])
        assert rep["root"] == "hvd_tpu_serve_request"
        assert rep["total_us"] == pytest.approx(5_000.0)

    def test_use_context_restores_previous(self):
        assert trace.current() is None
        with trace.use_context(("t" * 32, "s" * 16)):
            assert trace.current() == ("t" * 32, "s" * 16)
        assert trace.current() is None


class TestPropagation:
    def test_inject_extract_roundtrip(self):
        class Req:
            pass

        with trace.span("hvd_tpu_step", root=True) as ctx:
            req = trace.inject(Req())
        assert trace.extract(req) == ctx

    @pytest.mark.parametrize("value", [None, "not-a-pair", (1, 2),
                                       ("a", "b", "c")])
    def test_extract_rejects_garbage(self, value):
        class Req:
            pass

        req = Req()
        if value is not None:
            req._hvd_trace = value
        assert trace.extract(req) is None
        assert jtrace.extract(req) is None

    def test_inject_tolerates_slots_classes(self):
        class Slotted:
            __slots__ = ()

        with trace.span("hvd_tpu_step", root=True):
            obj = trace.inject(Slotted())
        assert trace.extract(obj) is None


# --- the pure functions -----------------------------------------------------------

class TestClockOffset:
    def test_symmetric_wire_recovers_exact_offset(self):
        samples = [(1000.0, 1400.0, 1000.0 + 200.0 + 5000.0)]
        off, err = trace.estimate_clock_offset(samples)
        assert off == pytest.approx(5000.0)
        assert err == pytest.approx(200.0)

    def test_minimum_rtt_sample_wins(self):
        good = (0.0, 100.0, 50.0 + 7000.0)
        congested = (200.0, 10200.0, 5200.0 + 7000.0 + 4000.0)
        off, err = trace.estimate_clock_offset([congested, good])
        assert off == pytest.approx(7000.0)
        assert err == pytest.approx(50.0)

    @pytest.mark.parametrize("true_skew", [-2.5e6, -137.0, 0.0, 4242.0,
                                           9.9e8])
    def test_synthetic_rtt_skew_oracle(self, true_skew):
        """The estimate lands within its error bound of the true skew, and
        equals the reference's on the same seeded samples."""
        rng = np.random.default_rng(7)
        samples = []
        t = 1e9
        for _ in range(24):
            up = 50.0 + float(rng.exponential(300.0))
            down = 50.0 + float(rng.exponential(300.0))
            samples.append((t, t + up + down, t + up + true_skew))
            t += 10_000.0
        off, err = trace.estimate_clock_offset(samples)
        assert abs(off - true_skew) <= err < 5e4
        assert (off, err) == jtrace.estimate_clock_offset(samples)

    def test_rejects_negative_rtt_and_empty(self):
        with pytest.raises(ValueError, match="negative RTT"):
            trace.estimate_clock_offset([(100.0, 50.0, 0.0)])
        with pytest.raises(ValueError):
            trace.estimate_clock_offset([])


def _mk_span(name, trace_id, span_id, parent, start, dur, rank):
    return {"name": name, "trace_id": trace_id, "span_id": span_id,
            "parent_id": parent, "kind": "internal", "start_us": start,
            "dur_us": dur, "rank": rank, "pid": 1000 + rank, "args": {}}


def _skewed_world():
    """``tests/test_trace.py``'s three processes with skewed clocks
    observing root(p0) -> mid(p1) -> leaf(p2)."""
    skews = {0: 0.0, 1: -3.7e8, 2: 2.2e9}
    true_start = {"root": 1e9, "mid": 1e9 + 10_000.0,
                  "leaf": 1e9 + 20_000.0}
    spans = {
        0: [_mk_span("hvd_tpu_step", "t1", "s-root", None,
                     true_start["root"] + skews[0], 50_000.0, 0)],
        1: [_mk_span("hvd_tpu_rpc_server", "t1", "s-mid", "s-root",
                     true_start["mid"] + skews[1], 30_000.0, 1)],
        2: [_mk_span("hvd_tpu_serve_decode", "t1", "s-leaf", "s-mid",
                     true_start["leaf"] + skews[2], 10_000.0, 2)],
    }
    return skews, true_start, spans


def _random_spans(seed: int, n: int = 40):
    """Seeded span sets over three processes: a few traces, parents drawn
    from earlier spans (some from another process, some missing)."""
    rng = np.random.default_rng(seed)
    out = {0: [], 1: [], 2: []}
    made = []
    for i in range(n):
        rank = int(rng.integers(3))
        parent = None
        if made and rng.random() < 0.8:
            parent = made[int(rng.integers(len(made)))]
        elif rng.random() < 0.3:
            parent = ("t%d" % rng.integers(3), "missing%d" % i)
        trace_id = parent[0] if parent else "t%d" % rng.integers(3)
        rec = _mk_span(f"span{rng.integers(5)}", trace_id, f"s{i}",
                       parent[1] if parent else None,
                       float(rng.uniform(0, 1e6)),
                       float(rng.uniform(0, 5e4)), rank)
        rec["args"] = {"i": i}
        out[rank].append(rec)
        made.append((trace_id, f"s{i}"))
    return out


class TestMerge:
    def test_merged_ordering_monotone_across_skewed_processes(self):
        skews, true_start, spans = _skewed_world()
        rng = np.random.default_rng(3)
        offsets = {0: 0.0}
        for rank in (1, 2):
            samples = []
            t = 5e8
            for _ in range(16):
                up = 80.0 + float(rng.exponential(150.0))
                down = 80.0 + float(rng.exponential(150.0))
                samples.append((t, t + up + down, t + up + skews[rank]))
                t += 7_000.0
            off, err = trace.estimate_clock_offset(samples)
            assert abs(off - skews[rank]) <= err
            offsets[rank] = off
        events = trace.merge_traces({
            f"rank{r}": (offsets[r], spans[r]) for r in spans})
        slices = {e["args"]["span_id"]: e for e in events if e["ph"] == "X"}
        got = [slices[s]["ts"] for s in ("s-root", "s-mid", "s-leaf")]
        assert got == sorted(got), got
        for sid, name in (("s-root", "root"), ("s-mid", "mid"),
                          ("s-leaf", "leaf")):
            assert slices[sid]["ts"] == pytest.approx(true_start[name],
                                                      abs=1e3)

    def test_cross_process_edges_draw_flow_arrows(self):
        _, _, spans = _skewed_world()
        events = trace.merge_traces(
            {f"rank{r}": (0.0, spans[r]) for r in spans})
        flows = [e for e in events if e["ph"] in ("s", "f")]
        assert sorted(e["id"] for e in flows) == \
            ["s-leaf", "s-leaf", "s-mid", "s-mid"]
        for e in flows:
            if e["ph"] == "f":
                assert e["bp"] == "e"
        names = {e["args"]["name"] for e in events if e["ph"] == "M"}
        assert names == {"rank0", "rank1", "rank2"}

    def test_unresolved_parents_detects_missing_ring(self):
        _, _, spans = _skewed_world()
        assert trace.unresolved_parents(spans[0] + spans[2]) == ["s-mid"]
        assert trace.unresolved_parents(
            spans[0] + spans[1] + spans[2]) == []

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_pure_functions_match_the_reference(self, seed):
        """``merge_traces``, ``unresolved_parents``, ``trace_ids`` and
        ``critical_path`` (every trace) equal the reference's on seeded
        span sets."""
        spans = _random_spans(seed)
        groups = {f"rank{r}": (float(r) * 1e3, s) for r, s in spans.items()}
        assert trace.merge_traces(groups) == jtrace.merge_traces(groups)
        flat = [s for r in sorted(spans) for s in spans[r]]
        assert trace.unresolved_parents(flat) == \
            jtrace.unresolved_parents(flat)
        assert trace.trace_ids(flat) == jtrace.trace_ids(flat)
        assert trace.critical_path(flat) == jtrace.critical_path(flat)
        for tid in trace.trace_ids(flat):
            assert trace.critical_path(flat, tid) == \
                jtrace.critical_path(flat, tid)

    def test_dump_merged_matches_the_reference(self, tmp_path):
        """The same span program, dumped by each package: the documents
        agree but for the ids, the times and the tool's name."""
        docs = {}
        for key, (tr, _) in PKGS.items():
            _program(tr)
            report = tr.dump_merged(str(tmp_path / f"{key}.json"),
                                    label="rank0")
            docs[key] = (json.load(open(tmp_path / f"{key}.json")), report)

        def shape(doc, report):
            meta = dict(doc["metadata"])
            assert meta.pop("tool").endswith("obs.trace.dump_merged")
            meta.pop("critical_paths")
            return (sorted(doc), doc["displayTimeUnit"], meta,
                    [(e["name"], e["ph"]) for e in doc["traceEvents"]
                     if e["ph"] in ("M", "s", "f")],
                    sorted(e["name"] for e in doc["traceEvents"]
                           if e["ph"] == "X"),
                    report["root"], sorted(report))

        assert shape(*docs["port"]) == shape(*docs["ref"])
        assert trace.dump_merged(str(tmp_path / "none.json")) is not None
        trace.clear()
        assert trace.dump_merged(str(tmp_path / "empty.json")) is None


class TestCriticalPath:
    def test_self_time_attribution_names_dominant_phase(self):
        spans = [
            _mk_span("hvd_tpu_serve_request", "t1", "a", None,
                     0.0, 100_000.0, 0),
            _mk_span("hvd_tpu_rpc_client", "t1", "b", "a",
                     1_000.0, 95_000.0, 0),
            _mk_span("hvd_tpu_rpc_server", "t1", "c", "b",
                     2_000.0, 90_000.0, 1),
            _mk_span("hvd_tpu_serve_prefill", "t1", "d", "c",
                     3_000.0, 10_000.0, 1),
            _mk_span("hvd_tpu_serve_decode", "t1", "e", "c",
                     13_000.0, 70_000.0, 1),
        ]
        rep = trace.critical_path(spans)
        assert rep["root"] == "hvd_tpu_serve_request"
        assert rep["dominant"] == "hvd_tpu_serve_decode"
        assert rep["dominant_self_us"] == pytest.approx(70_000.0)
        assert rep["path"] == ["hvd_tpu_serve_request", "hvd_tpu_rpc_client",
                               "hvd_tpu_rpc_server", "hvd_tpu_serve_decode"]
        assert rep["self_us"]["hvd_tpu_rpc_server"] == pytest.approx(
            10_000.0)
        assert rep["unresolved_parents"] == []
        assert rep == jtrace.critical_path(spans)

    def test_picks_longest_trace_by_default(self):
        spans = [
            _mk_span("hvd_tpu_step", "short", "s1", None, 0.0, 10.0, 0),
            _mk_span("hvd_tpu_step", "long", "s2", None, 0.0, 99.0, 0),
        ]
        assert trace.critical_path(spans)["trace_id"] == "long"
        assert trace.critical_path(spans, "short")["trace_id"] == "short"

    def test_empty_raises(self):
        with pytest.raises(ValueError):
            trace.critical_path([])


# --- the plan's span --------------------------------------------------------------

def test_plan_compile_span_and_axes_match_the_reference(monkeypatch):
    """``compile_plan`` runs under the root span ``hvd_tpu_plan_compile``
    (args ``{"spec": ...}``) and publishes ``hvd_tpu_plan_axes`` for the
    plan's axes, as the reference's: the same span structure for the
    default plan and a declared one (the port's world of one, the
    reference's eight slots)."""
    from horovod_tpu.obs import metrics as jmetrics
    from horovod_tpu.plan import compile_plan as jax_compile_plan

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.obs import metrics
    from horovod_tpu_torch.plan import compile_plan

    for mod in (jmetrics, metrics):
        monkeypatch.setattr(mod, "_default", mod.MetricsRegistry())
        monkeypatch.setattr(mod, "_enabled", True)
    hvd.init(device="cpu")
    try:
        trace.clear()
        plans = [compile_plan(None), compile_plan("data=1,fsdp=1")]
    finally:
        hvd.shutdown()
    ref_plans = [jax_compile_plan(None), jax_compile_plan("data=2,fsdp=4")]
    port_spans, ref_spans = trace.snapshot(), jtrace.snapshot()
    assert _structure(port_spans, args=False) == \
        _structure(ref_spans, args=False)
    assert [s["args"] for s in port_spans] == [
        {"spec": "default"}, {"spec": "data=1,fsdp=1"}]
    assert [s["args"] for s in ref_spans] == [
        {"spec": "default"}, {"spec": "data=2,fsdp=4"}]
    for plan in plans:
        snap = metrics.registry().snapshot()["hvd_tpu_plan_axes"]
        for axis, size in plan.axes:
            assert {"labels": {"axis": axis}, "value": float(size)} in snap
    ref_snap = jmetrics.registry().snapshot()["hvd_tpu_plan_axes"]
    assert {row["labels"]["axis"] for row in ref_snap} == {
        row["labels"]["axis"]
        for row in metrics.registry().snapshot()["hvd_tpu_plan_axes"]}
    assert [dict(p.axes).keys() for p in plans] == \
        [dict(p.axes).keys() for p in ref_plans]


# --- the flight recorder ---------------------------------------------------------

class TestFlightRecorder:
    def test_events_ring_bounded(self):
        flight.configure(ring=4)
        for i in range(10):
            flight.record("retry", attempt=i)
        evts = flight.events()
        assert len(evts) == 4
        assert [e["attempt"] for e in evts] == [6, 7, 8, 9]

    def test_dump_carries_events_spans_and_identity(self, tmp_path):
        flight.configure(directory=str(tmp_path))
        with trace.span("hvd_tpu_step", root=True):
            trace.instant("hvd_tpu_fault", args={"site": "collective"})
        flight.record("fault", site="collective")
        path = flight.dump("unit_test")
        assert path is not None and os.path.exists(path)
        doc = json.load(open(path))
        assert f"_r{doc['rank']}_" in os.path.basename(path)
        assert doc["reason"] == "unit_test"
        assert [e["kind"] for e in doc["events"]] == ["fault"]
        assert "hvd_tpu_fault" in {s["name"] for s in doc["spans"]}
        assert doc["fault_spec"] is None and doc["fault_history"] == []
        assert flight.last_dumps() == [path]

    def test_events_and_dump_keys_match_the_reference(self, tmp_path):
        """The same records and the same dump in both packages: equal
        events (but the time stamps), equal dump keys and file-name
        shape."""
        dumps = {}
        for key, (tr, fl) in PKGS.items():
            fl.configure(directory=str(tmp_path / key))
            with tr.span("hvd_tpu_step", root=True):
                fl.record("retry", what="rpc", attempt=1)
                fl.record("elastic_rollback", step=3)
            path = fl.dump("parity check/1")
            dumps[key] = (json.load(open(path)), os.path.basename(path),
                          [{k: v for k, v in e.items() if k != "ts_us"}
                           for e in fl.events()])
        (pdoc, pname, pevents), (rdoc, rname, revents) = (dumps["port"],
                                                          dumps["ref"])
        assert pevents == revents
        assert sorted(pdoc) == sorted(rdoc)
        # The reference's session is initialized here (rank 0); the port
        # has no world in this process, so it files its dump as "x".
        assert (pdoc["rank"], rdoc["rank"]) == ("x", "0")
        assert pname.startswith("hvd_tpu_flight_rx_p")
        assert rname.startswith("hvd_tpu_flight_r0_p")
        assert pname.endswith("_0001_parity_check_1.json")
        assert rname.endswith("_0001_parity_check_1.json")
        assert [s["name"] for s in pdoc["spans"]] == \
            [s["name"] for s in rdoc["spans"]]

    def test_dump_is_fail_soft(self, tmp_path):
        blocker = tmp_path / "not_a_dir"
        blocker.write_text("file where the dir should go")
        flight.configure(directory=str(blocker))
        assert flight.dump("nope") is None

    def test_disabled_records_nothing(self, tmp_path):
        flight.configure(enabled=False, directory=str(tmp_path))
        flight.record("fault", site="x")
        assert flight.dump("off") is None
        assert flight.events() == []

    def test_empty_directory_rearms_env_default(self, monkeypatch,
                                                tmp_path):
        monkeypatch.setenv("HVD_TPU_FLIGHT_DIR", str(tmp_path / "envd"))
        flight.configure(directory="")
        path = flight.dump("env_default")
        assert path is not None
        assert path.startswith(str(tmp_path / "envd"))
