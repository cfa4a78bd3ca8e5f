"""The port's timeline and stall inspectors (``horovod_tpu_torch/utils/
timeline.py``, ``stall.py``, ``cross_stall.py``) against the reference's.

Mirrors ``tests/test_timeline.py``, each writer case with the native
writer thread and without it.  Parity:

* the sequence of ``(tensor, phase, args)`` events the port's eager API
  writes on a 2-rank gloo world equals the reference's on the same calls
  (its 8-slot mesh; times are not compared);
* both writers emit the same event shapes (slices, counters, flows,
  cycle marks);
* the obs layer's span and counter mirrors land in the file;
* the cross-process monitor, over the native coordinator, names a
  collective one rank dispatched and the other did not.
"""

import json
import logging
import os
import tempfile
import time

import numpy as np
import pytest

import horovod_tpu as jhvd
from horovod_tpu.utils.timeline import Timeline as JTimeline

import horovod_tpu_torch as hvd
from horovod_tpu_torch.native import bindings
from horovod_tpu_torch.utils.stall import StallInspector
from horovod_tpu_torch.utils.timeline import Timeline, per_process_path

from torch_port_workers import World

N = 2


@pytest.fixture(scope="module", autouse=True)
def native_built():
    assert bindings.available()


@pytest.fixture(scope="module")
def world():
    with tempfile.TemporaryDirectory() as tmp:
        w = World(N, os.path.join(tmp, "store"))
        try:
            yield w
        finally:
            w.close()


def _open(path, use_native):
    tl = Timeline(str(path), use_native=use_native)
    assert tl.native is use_native   # the route asked for, not a fallback
    return tl


# --- the writer ---------------------------------------------------------------

def test_disabled_timeline_is_noop():
    tl = Timeline(None)
    assert not tl.enabled and not tl.native
    with tl.activity("x", "EXECUTE"):
        pass
    tl.close()


@pytest.mark.parametrize("use_native", [True, False])
def test_writers_emit_the_references_events(tmp_path, use_native):
    """The same calls on the port's writer and the reference's Python
    writer: the same events but for pid and time."""
    files = {}
    for label, cls in (("port", Timeline), ("ref", JTimeline)):
        path = tmp_path / f"{label}.json"
        tl = cls(str(path), mark_cycles=True,
                 use_native=use_native if label == "port" else False)
        tl.record("grad/w0", "EXECUTE", 10.0, 25.0, {"op": "sum"})
        tl.record('weird"name\n', "QUEUE", 1.0, 2.0)
        tl.counter("train", {"step_time_ms": 3.5, "tokens_per_s": 100.0,
                             "label": "dropped"}, ts_us=4.0)
        tl.flow("hvd_tpu_rpc_client", "abc123", "s", ts_us=1.0)
        tl.flow("hvd_tpu_rpc_client", "abc123", "f", ts_us=4.0)
        tl.mark_cycle()
        tl.close()
        files[label] = [{k: v for k, v in e.items()
                         if k not in ("pid", "tid", "ts")}
                        for e in json.load(open(path))]
    assert files["port"] == files["ref"]
    (c,) = [e for e in files["port"] if e["ph"] == "C"]
    assert c["args"] == {"step_time_ms": 3.5, "tokens_per_s": 100.0}
    (fin,) = [e for e in files["port"] if e["ph"] == "f"]
    assert fin["bp"] == "e"


@pytest.mark.parametrize("use_native", [True, False])
def test_close_mid_activity_drops_event_safely(tmp_path, use_native):
    path = tmp_path / f"race{use_native}.json"
    tl = _open(path, use_native)
    tl.record("kept", "EXECUTE", 0.0, 1.0)
    with tl.activity("x", "EXECUTE"):
        tl.close()
        assert not tl.enabled
    events = json.load(open(path))
    assert {e["args"]["tensor"] for e in events if "args" in e} == {"kept"}
    tl.close()


@pytest.mark.parametrize("use_native", [True, False])
def test_flow_after_close_is_dropped_safely(tmp_path, use_native):
    path = tmp_path / f"flowrace{use_native}.json"
    tl = _open(path, use_native)
    tl.flow("kept", "id1", "s", ts_us=1.0)
    tl.close()
    tl.flow("dropped", "id2", "f", ts_us=2.0)
    events = json.load(open(path))
    assert [e["id"] for e in events if e["ph"] in ("s", "f")] == ["id1"]


def test_flow_rejects_unknown_phase(tmp_path):
    tl = Timeline(str(tmp_path / "p.json"))
    with pytest.raises(ValueError, match="flow phase"):
        tl.flow("x", "id", "t")
    tl.close()


def test_per_process_path():
    assert per_process_path("/t/tl.json", 0) == "/t/tl.json"
    assert per_process_path("/t/tl.json", 3) == "/t/tl.json.rank3"
    assert per_process_path(None, 2) is None


# --- the session: knobs, start/stop, mirrors ----------------------------------

@pytest.mark.parametrize("use_native", [True, False])
def test_session_timeline_mirrors_spans_counters_and_rpcs(tmp_path,
                                                          monkeypatch,
                                                          use_native):
    """``HOROVOD_TIMELINE`` at init; a wrapped step's root span and its
    ``train`` counter, a span, an RPC's client/server flow and an eager
    allreduce land in the file; ``stop_timeline`` closes it."""
    import torch

    from horovod_tpu_torch.native import runtime
    from horovod_tpu_torch.obs import instrument, trace
    from horovod_tpu_torch.runner.common import network, secret

    if not use_native:
        monkeypatch.setattr(runtime, "available", lambda: False)
    path = tmp_path / "session.json"
    monkeypatch.setenv("HOROVOD_TIMELINE", str(path))
    monkeypatch.setenv("HOROVOD_TIMELINE_MARK_CYCLES", "1")
    hvd.init(device="cpu")
    try:
        assert hvd.config().timeline == str(path)
        assert hvd.timeline().native is use_native
        step = instrument.wrap_step(lambda model, batch: batch.sum())
        step(None, torch.ones(2, 8))
        with trace.span("hvd_tpu_custom"):
            pass
        key = secret.make_secret_key()
        svc = network.BasicService("svc", key)
        try:
            network.BasicClient("svc", [("127.0.0.1", svc.port)],
                                key).ping()
        finally:
            svc.shutdown()
        hvd.allreduce(torch.ones(3), name="grad")
        hvd.timeline().mark_cycle()
        hvd.stop_timeline()
        assert not hvd.timeline().enabled
    finally:
        hvd.shutdown()
    events = json.load(open(path))
    names = [(e["name"], e["ph"]) for e in events]
    assert ("hvd_tpu_step", "X") in names and ("hvd_tpu_custom", "X") in names
    (c,) = [e for e in events if e["ph"] == "C"]
    assert c["name"] == "train" and c["args"]["tokens_per_s"] > 0
    assert {"step_time_ms", "tokens_per_s"} == set(c["args"])
    flows = {e["ph"] for e in events if e["name"].startswith("hvd_tpu_rpc")
             and e["ph"] in ("s", "f")}
    assert flows == {"s", "f"}
    assert [(e["name"], e["args"]) for e in events
            if e.get("args", {}).get("tensor") == "grad"] == \
        [("ENQUEUE", {"tensor": "grad", "op": "average"}),
         ("EXECUTE", {"tensor": "grad", "op": "average"})]
    assert ("CYCLE", "i") in names


def test_unwritable_timeline_fails_init_cleanly(tmp_path, monkeypatch):
    monkeypatch.setenv("HOROVOD_TIMELINE", str(tmp_path / "no" / "t.json"))
    with pytest.raises(OSError):
        hvd.init(device="cpu")
    assert not hvd.is_initialized() and hvd.peek("timeline") is None


def test_start_timeline_and_peek(tmp_path):
    assert hvd.peek("timeline") is None
    hvd.init(device="cpu")
    try:
        assert not hvd.timeline().enabled
        assert hvd.peek("cross_monitor") is None   # a world of one
        assert isinstance(hvd.stall_inspector(), StallInspector)
        hvd.start_timeline(str(tmp_path / "t.json"), mark_cycles=True)
        assert hvd.peek("timeline") is hvd.timeline()
        assert hvd.timeline().enabled and hvd.timeline().native
    finally:
        hvd.shutdown()
    assert hvd.peek("timeline") is None
    json.load(open(tmp_path / "t.json"))   # closed by shutdown


# --- the eager API's events against the reference's ---------------------------

def _program(n: int):
    """The same calls for a world of ``n``: (call, kwargs) with numpy
    tensors (the port's rank tensor) — the reference takes a per-slot
    stack of each (``_stack``)."""
    x = np.arange(4 * n, dtype=np.float32)
    a, b = np.ones(4 * n, np.float32), np.full(2 * n, 2.0, np.float32)
    return [
        ("allreduce", dict(tensor=x, name="grad/layer0")),
        ("allreduce", dict(tensor=x, op="sum", name="sum0")),
        ("grouped_allreduce", dict(tensors=[a, b], name="grp")),
        ("grouped_allreduce", dict(tensors=[a, b], op="adasum",
                                   name="ada")),
        ("allgather", dict(tensor=x.reshape(n, 4), name="gather0")),
        ("grouped_allgather", dict(tensors=[a.reshape(n, 4),
                                            b.reshape(n, 2)], name="gg")),
        ("broadcast", dict(tensor=x, root_rank=1, name="bc")),
        ("alltoall", dict(tensor=x, name="a2a")),
        ("reducescatter", dict(tensor=x, op="sum", name="rs")),
        ("grouped_reducescatter", dict(tensors=[a, b], op="sum",
                                       name="grs")),
        ("barrier", dict(name="bar")),
    ]


def _reference_events(path: str) -> list:
    size = jhvd.size()

    def stack(v):
        return np.stack([v] * size)

    jhvd.start_timeline(path)
    try:
        for call, kwargs in _program(size):
            kwargs = {k: ([stack(t) for t in v] if isinstance(v, list)
                          else stack(v) if isinstance(v, np.ndarray) else v)
                      for k, v in kwargs.items()}
            getattr(jhvd, call)(**kwargs)
    finally:
        jhvd.stop_timeline()
    return [(e["args"]["tensor"], e["name"],
             {k: v for k, v in e["args"].items() if k != "tensor"})
            for e in json.load(open(path))
            if e["name"] in ("ENQUEUE", "EXECUTE")]


def test_eager_api_events_equal_the_references(world, tmp_path):
    want = _reference_events(str(tmp_path / "ref.json"))
    assert len(want) == 18
    got = world.run("timeline_program", path=str(tmp_path / "port.json"),
                    program=_program(N))
    assert [[e for e in r if e[1] in ("ENQUEUE", "EXECUTE")]
            for r in got] == [want] * N
    assert os.path.exists(tmp_path / "port.json.rank1")


# --- the stall inspectors -----------------------------------------------------

@pytest.fixture
def stall_records():
    records = []

    class _Capture(logging.Handler):
        def emit(self, record):
            records.append(record)

    handler = _Capture()
    logger = logging.getLogger("horovod_tpu_torch.utils.stall")
    logger.addHandler(handler)
    yield records
    logger.removeHandler(handler)


def _stall_warns() -> float:
    from horovod_tpu_torch.obs import metrics

    return sum(s["value"] for s in metrics.registry().snapshot().get(
        "hvd_tpu_stall_events_total", [])
        if dict(s["labels"]).get("kind") == "warn")


class TestStallInspector:
    def test_warns_on_idle_and_counts(self, stall_records):
        before = _stall_warns()
        si = StallInspector(enabled=True, warn_after_s=0.05)
        si.record_activity("step")
        time.sleep(0.3)
        si.stop()
        assert any("Potential stall" in r.getMessage()
                   for r in stall_records)
        assert _stall_warns() >= before + 1

    def test_heartbeat_prevents_warning(self, stall_records):
        si = StallInspector(enabled=True, warn_after_s=0.5)
        for _ in range(5):
            si.record_activity("step")
            time.sleep(0.02)
        si.stop()
        assert not any("Potential stall" in r.getMessage()
                       for r in stall_records)

    def test_shutdown_hook_fires(self):
        fired = []
        si = StallInspector(enabled=True, warn_after_s=0.02,
                            shutdown_after_s=0.05,
                            on_shutdown=lambda: fired.append(1))
        si.record_activity("step")
        time.sleep(0.4)
        si.stop()
        assert fired

    def test_pause_disarms(self, stall_records):
        si = StallInspector(enabled=True, warn_after_s=0.05)
        si.record_activity("step")
        with si.pause():
            time.sleep(0.3)
        si.stop()
        assert not any("Potential stall" in r.getMessage()
                       for r in stall_records)

    def test_disabled_never_warns(self, stall_records):
        si = StallInspector(enabled=False, warn_after_s=0.01)
        si.record_activity("step")
        time.sleep(0.1)
        si.stop()
        assert not stall_records

    def test_dispatch_heartbeats_the_session_inspector(self, monkeypatch):
        import torch

        monkeypatch.setenv("HOROVOD_STALL_CHECK_TIME_SECONDS", "30")
        hvd.init(device="cpu")
        try:
            si = hvd.stall_inspector()
            assert si._warn_after_s == 30.0
            assert si._last_activity is None
            hvd.allreduce(torch.ones(1), name="beat")
            assert si._last_activity is not None and si._thread is not None
        finally:
            hvd.shutdown()
        assert si._thread is None   # stopped by shutdown


def test_cross_process_monitor_reports_the_missing_rank(world):
    records = world.run("missing_rank_warning", warn_after_s=0.5)
    (warning,) = records[0]
    assert "'only_rank0'" in warning and "not globally ready" in warning
    assert records[1] == []
    for state in world.run("monitor_state"):
        assert state["running"] and state["failure"] is None
