"""The readers of the port's layer ranges and stage spans
(``core/spans.py``, ``metrics/*_ms_per_step.py``) on a hand-made trace:
two threads (the step's and the autograd engine's), ranges nested in the
benchmark's spans, kernels tied to their launch by correlation id, an
NCCL kernel in the wire, and one kernel launched under no range."""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench.core import trace as tr
from portbench.core.spec import load_module
from portbench.tests.test_trace import host, kernel, launch

BENCH = Path(__file__).resolve().parents[1]
MAIN, ENGINE = 1, 2
READERS = {"head_ms_per_step": "hvd_tpu_layer_head",
           "attn_layer_ms_per_step": "hvd_tpu_layer_attn",
           "mlp_ms_per_step": "hvd_tpu_layer_mlp",
           "wire_ms_per_step": "hvd_tpu_wire",
           "wire_local_ms_per_step": "hvd_tpu_wire",
           "optimizer_ms_per_step": "hvd_tpu_apply"}
NCCL = {14: "ncclDevKernel_AllGather_RING_LL(ncclDevComm*)"}


def _metric(name):
    return load_module(BENCH / "metrics" / f"{name}.py", "metric")


def ann(name, ts, dur, tid):
    return host(name, ts, dur, tid=tid, cat="user_annotation")


def events(drop=()):
    """One traced step in [0, 5000): the forward on the step's thread, the
    backward on the engine's, then the wire and the optimizer.  Kernel
    ``k`` of duration ``d`` us, launched at ``at`` on ``tid``."""
    ranges = [
        ("portbench.window", 0, 5000, MAIN), ("portbench.step", 1, 4998, MAIN),
        ("hvd_tpu_step", 2, 990, MAIN),
        ("hvd_tpu_layer_embed", 10, 10, MAIN),
        ("hvd_tpu_layer_attn", 20, 30, MAIN),
        ("hvd_tpu_layer_mlp", 50, 30, MAIN),
        ("hvd_tpu_layer_head", 80, 40, MAIN),
        ("hvd_tpu_layer_head", 200, 50, ENGINE),
        ("hvd_tpu_layer_mlp", 250, 60, ENGINE),
        ("hvd_tpu_layer_attn", 310, 90, ENGINE),
        ("_Flash3Backward", 320, 50, ENGINE),          # nested in attn
        ("hvd_tpu_layer_embed", 400, 20, ENGINE),
        ("hvd_tpu_wire", 500, 100, MAIN),
        ("hvd_tpu_apply", 700, 100, MAIN)]
    launches = [  # (corr, at, tid, kernel duration)
        (1, 12, MAIN, 5), (2, 25, MAIN, 7), (3, 55, MAIN, 11),
        (4, 85, MAIN, 13), (5, 210, ENGINE, 17), (6, 260, ENGINE, 19),
        (7, 330, ENGINE, 23), (8, 390, ENGINE, 2), (9, 405, ENGINE, 3),
        (10, 510, MAIN, 29), (11, 710, MAIN, 31),
        (12, 850, MAIN, 37),                            # under no range
        (13, 215, MAIN, 41),   # the step's thread, at the engine's head time
        (14, 520, MAIN, 43)]                            # NCCL, in the wire
    ev = [ann(n, a, d, tid) for n, a, d, tid in ranges if n not in drop]
    t = 1000
    for corr, at, tid, dur in launches:
        ev.append(launch(at, corr, tid=tid))
        ev.append(kernel(NCCL.get(corr, f"k{corr}"), t, dur, corr))
        t += dur + 1
    ev.append(kernel("after", 6000, 50, 99))            # outside the window
    return ev


def ctx_of(ev, steps=2):
    return SimpleNamespace(host_trace=tr.Trace(ev), traced_steps=steps)


# Kernel time (us) under each range: attn forward 7 + backward 23 + 2
# (_Flash3Backward's 23 lies inside attn's backward range too).
WANT_US = {"head_ms_per_step": 13 + 17, "attn_layer_ms_per_step": 7 + 23 + 2,
           "mlp_ms_per_step": 11 + 19, "wire_ms_per_step": 29 + 43,
           "wire_local_ms_per_step": 29, "optimizer_ms_per_step": 31}
EMBED_US = 5 + 3
REST_US = 37 + 41


def test_window_is_the_benchmark_span():
    t = tr.Trace(events())
    assert t.window() == (0, 5000)


@pytest.mark.parametrize("name", sorted(READERS))
def test_each_reader_sums_its_ranges_over_both_threads(name):
    assert _metric(name).read(ctx_of(events())) == pytest.approx(
        WANT_US[name] * 1e-3 / 2)


def test_unattributed_is_what_no_range_launched():
    ctx = ctx_of(events())
    rest = _metric("unattributed_ms_per_step").read(ctx)
    assert rest == pytest.approx(REST_US * 1e-3 / 2)
    total = sum(op.end - op.start for op in
                ctx.host_trace.device_ops(ctx.host_trace.window()))
    parts = sum(_metric(n).read(ctx) for n in READERS
                if n != "wire_local_ms_per_step") + rest
    # The six readers and the embeddings' ranges account for every op once.
    assert parts + EMBED_US * 1e-3 / 2 == pytest.approx(total * 1e-3 / 2)
    assert _metric("attn_layer_ms_per_step").read(ctx) >= \
        _metric("attn_bwd_ms_per_step").read(ctx)


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_whose_range_is_absent_reads_none(name):
    ev = events(drop=(READERS[name],))
    assert _metric(name).read(ctx_of(ev)) is None
    # the others still read
    other = next(n for n in READERS if n != name)
    assert _metric(other).read(ctx_of(ev)) is not None


def test_unattributed_without_any_range_reads_none():
    ev = events(drop=tuple(READERS.values()) + ("hvd_tpu_layer_embed",))
    assert _metric("unattributed_ms_per_step").read(ctx_of(ev)) is None


def test_no_device_ops_reads_none():
    ev = [e for e in events() if e.get("cat") != "kernel"]
    for name in list(READERS) + ["unattributed_ms_per_step"]:
        assert _metric(name).read(ctx_of(ev)) is None


def test_a_range_with_nothing_launched_reads_zero():
    ev = [e for e in events()
          if not (e.get("cat") == "kernel" and e["name"] == "k10")]
    assert _metric("wire_local_ms_per_step").read(ctx_of(ev)) == 0.0
    ev = [e for e in ev
          if not (e.get("cat") == "kernel" and e["name"] == NCCL[14])]
    assert _metric("wire_ms_per_step").read(ctx_of(ev)) == 0.0


def test_the_wire_is_its_local_work_and_its_nccl_kernels():
    ctx = ctx_of(events())
    nccl = _metric("wire_ms_per_step").read(ctx) - \
        _metric("wire_local_ms_per_step").read(ctx)
    assert nccl == pytest.approx(43 * 1e-3 / 2)
