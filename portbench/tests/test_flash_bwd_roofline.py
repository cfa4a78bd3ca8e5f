"""``flash_bwd_roofline`` on synthetic traces: the bound's arithmetic at
both cells' shapes, the causal half, and nothing to read when no kernel
lies under ``_Flash3Backward``."""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench.core import trace as tr
from portbench.core.spec import load_module

BENCH = Path(__file__).resolve().parents[1]
PEAKS = json.loads((BENCH / "work" / "peaks.json").read_text())[
    "NVIDIA H100 80GB HBM3"]
GPT = dict(n_layer=24, n_head=16, d_model=1024, causal=True)
BERT = dict(n_layer=24, n_head=16, d_model=1024, causal=False)


def _metric():
    return load_module(BENCH / "metrics" / "flash_bwd_roofline.py", "metric")


def _events(kernel_us, under="_Flash3Backward"):
    """One backward node holding a launch of each kernel, and one kernel
    launched outside it."""
    events = [{"ph": "X", "cat": "user_annotation", "name": "portbench.window",
               "ts": 0, "dur": 10 ** 7, "tid": 1},
              {"ph": "X", "cat": "cpu_op", "name": under, "ts": 10,
               "dur": 100, "tid": 2}]
    for i, dur in enumerate(kernel_us):
        events += [{"ph": "X", "cat": "cuda_runtime",
                    "name": "cudaLaunchKernel", "ts": 20 + i, "dur": 1,
                    "tid": 2, "args": {"correlation": i + 1}},
                   {"ph": "X", "cat": "kernel", "name": f"k{i}",
                    "ts": 1000 + 10 ** 5 * i, "dur": dur,
                    "args": {"correlation": i + 1}}]
    events += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": 500, "dur": 1, "tid": 2, "args": {"correlation": 99}},
               {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 5 * 10 ** 6,
                "dur": 12345, "args": {"correlation": 99}}]
    return events


def _ctx(shape, batch, seq, kernel_us, steps=3):
    return SimpleNamespace(host_trace=tr.Trace(_events(kernel_us)),
                           shape=shape, batch=batch, seq=seq,
                           traced_steps=steps, peaks=PEAKS)


def test_bound_at_the_gpt_cell():
    m = _metric()
    work = m.flash_bwd_call(256, 1024, 1024, 64, True)
    # five products of 2·256·1024²·64, causal halved
    assert work["flops"] == pytest.approx(85.899e9, rel=1e-4)
    # Q, O, dO, dQ, K, V, dK, dV bf16 + lse, Δ f32
    assert work["bytes"] == 8 * 256 * 1024 * 64 * 2 + 2 * 256 * 1024 * 4
    call_s = work["flops"] / 989e12               # operations bound it
    assert call_s > work["bytes"] / 3.35e12
    # 24 layers x 3 steps of calls in 2 + 3 ms of kernels under the node
    got = m.read(_ctx(GPT, 16, 1024, [2000, 3000]))
    assert got == pytest.approx(100 * call_s * 72 / 5e-3)


def test_bound_at_the_bert_cell_is_its_bytes():
    m = _metric()
    work = m.flash_bwd_call(2048, 128, 128, 64, False)
    assert work["flops"] == pytest.approx(21.475e9, rel=1e-4)
    call_s = work["bytes"] / 3.35e12
    assert call_s > work["flops"] / 989e12
    got = m.read(_ctx(BERT, 128, 128, [4000], steps=2))
    assert got == pytest.approx(100 * call_s * 48 / 4e-3)


def test_causal_counts_half_the_operations():
    m = _metric()
    full = m.flash_bwd_call(16, 2048, 2048, 64, False)
    half = m.flash_bwd_call(16, 2048, 2048, 64, True)
    assert half["flops"] == full["flops"] / 2
    assert half["bytes"] == full["bytes"]


def test_nothing_to_read_without_the_backward_node():
    ctx = SimpleNamespace(
        host_trace=tr.Trace(_events([2000], under="OtherBackward")),
        shape=GPT, batch=16, seq=1024, traced_steps=3, peaks=PEAKS)
    assert _metric().read(ctx) is None
    assert _metric().read(_ctx(GPT, 16, 1024, [2000])) is not None
    ctx.peaks = None
    assert _metric().read(ctx) is None
