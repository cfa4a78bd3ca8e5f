"""The trace arithmetic on synthetic events: the union of intervals, NCCL
exposure, attribution to ``_Flash3Backward``, the window and the
breakdown."""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench.core import trace as tr
from portbench.core.spec import load_module

BENCH = Path(__file__).resolve().parents[1]


def kernel(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def launch(ts, corr, tid=2, dur=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": dur, "tid": tid, "args": {"correlation": corr}}


def host(name, ts, dur, tid=2, cat="cpu_op"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid}


def test_union_and_minus():
    assert tr.union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [(0, 3), (5, 8)]
    assert tr.measure([(0, 2), (1, 3), (10, 11)]) == 4
    # NCCL [0, 10) and [20, 30); compute [2, 4), [8, 22), [25, 26).
    assert tr.minus([(0, 10), (20, 30)], [(2, 4), (8, 22), (25, 26)]) == 13
    assert tr.minus([(0, 1)], []) == 1
    assert tr.gaps([(1, 2), (4, 5)], (0, 6)) == [(0, 1), (2, 4), (5, 6)]


def _metric(name):
    return load_module(BENCH / "metrics" / f"{name}.py", "metric")


def test_nccl_exposure_and_idle_share():
    # Two steps in [0, 100): NCCL [10, 30) beside compute [0, 20), and
    # NCCL [60, 70) alone; compute [80, 90).
    events = [launch(0, 1, dur=0.5),
              kernel("gemm", 0, 20, 1),
              kernel("ncclDevKernel_SendRecv", 10, 20, 2),
              kernel("ncclDevKernel_AllGather_RING_LL", 60, 10, 3),
              kernel("gemm", 80, 20, 4)]
    ctx = SimpleNamespace(trace=tr.Trace(events), traced_steps=2)
    # exposed: [20, 30) and [60, 70) = 20 us over 2 steps = 0.01 ms
    assert _metric("nccl_exposed_ms_per_step").read(ctx) == pytest.approx(0.01)
    # busy [0, 30) + [60, 70) + [80, 100) = 60 of the window's 100 us
    assert _metric("device_idle_pct").read(ctx) == pytest.approx(40.0)
    ctx = SimpleNamespace(trace=tr.Trace([launch(0, 1), kernel("gemm", 0, 5, 1)]),
                          traced_steps=1)
    assert _metric("nccl_exposed_ms_per_step").read(ctx) is None


def test_attribution_to_the_backward_node():
    events = [
        host("portbench.window", 0, 100, tid=1, cat="user_annotation"),
        host("autograd::engine::evaluate_function: _Flash3Backward", 10, 20),
        host("_Flash3Backward", 11, 18),
        launch(12, 1), launch(15, 2), launch(40, 3),
        launch(13, 4, tid=3),             # another thread, same time
        kernel("mul", 20, 5, 1), kernel("bmm", 30, 4, 2),
        kernel("add", 50, 3, 3), kernel("other", 60, 2, 4),
    ]
    t = tr.Trace(events)
    under = t.launched_under("_Flash3Backward", t.device_ops(t.window()))
    assert sorted(op.name for op in under) == ["bmm", "mul"]
    assert t.window() == (0, 100)


def test_device_only_window_and_breakdown():
    events = [launch(5, 1, dur=2), launch(8, 2, dur=1),
              kernel("a", 10, 10, 1), kernel("b", 25, 5, 2),
              kernel("a", 32, 4, 2)]
    t = tr.Trace(events)
    assert t.window() == (5, 36)
    busy, window = tr.busy_and_window(t)
    assert busy == pytest.approx(19e-6)
    assert window == pytest.approx(31e-6)
    b = tr.breakdown(t)
    assert b["device_ops"][0] == ["a", pytest.approx(14e-6)]
    # gaps: [5, 10) with the host in a CUDA call at 5, [20, 25), [30, 32)
    assert b["idle_gaps"][0] == ["host in cudaLaunchKernel",
                                 pytest.approx(5e-6)]
    assert b["idle_gaps"][1][0] == "host in Python, between CUDA calls"
