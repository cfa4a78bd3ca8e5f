"""Layer ranges and stage spans of the port's train step under
``torch.profiler`` (``horovod_tpu_torch/obs/trace.py``).

A 2-layer GPT and a 2-layer BERT masked LM (flash attention, bf16
activations) go through ``make_train_step`` with a
``DistributedOptimizer`` at one rank over gloo, on the CPU:

* under the profiler, each step's host trace holds, in time order, the
  forward's ``hvd_tpu_layer_embed``, each block's ``_attn`` and ``_mlp``
  and ``hvd_tpu_layer_head``, then the backward's ranges of the same
  names in reverse order (on the CPU autograd runs the backward on the
  calling thread), then one ``hvd_tpu_wire`` and one ``hvd_tpu_apply``;
  no two of them overlap on a thread, and the flash backward node lies
  inside a backward ``hvd_tpu_layer_attn``.  The chunked heads too;
* the losses, gradients and parameters after 2 steps are bitwise those
  of the same steps without the profiler;
* without the profiler no gradient hook is registered and the span ring
  gains only ``hvd_tpu_step``, ``hvd_tpu_wire`` and ``hvd_tpu_apply``;
* a span's ring start and its profiler copy's start
  (``baseTimeNanoseconds`` + ``ts``) agree within 1 ms.
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import (BertConfig, BertForMaskedLM, GPT,
                                      GPTConfig, lm_loss_fn,
                                      masked_lm_loss_fn)
from horovod_tpu_torch.obs import metrics, trace

N_LAYER = 2
EMBED, ATTN, MLP, HEAD = ("hvd_tpu_layer_embed", "hvd_tpu_layer_attn",
                          "hvd_tpu_layer_mlp", "hvd_tpu_layer_head")
LAYERS = (EMBED, ATTN, MLP, HEAD)
STAGES = ("hvd_tpu_wire", "hvd_tpu_apply")
FORWARD = [EMBED] + [ATTN, MLP] * N_LAYER + [HEAD]
ONE_STEP = FORWARD + FORWARD[::-1] + list(STAGES)
CASES = [("gpt", 0), ("gpt", 8), ("bert", 0), ("bert", 8)]


@pytest.fixture
def world(monkeypatch):
    """One rank over gloo, a fresh metrics registry (so the step is
    instrumented) and a clean, enabled span ring."""
    monkeypatch.setattr(metrics, "_default", metrics.MetricsRegistry())
    monkeypatch.setattr(metrics, "_enabled", True)
    trace.configure(enabled=True)
    trace.clear()
    hvd.init(device="cpu")
    yield
    hvd.shutdown()
    trace.clear()


def _model(family: str, chunk: int):
    """``(model, loss_fn, batches)``: the same weights and two batches of
    4 rows on every call."""
    g = torch.Generator().manual_seed(7)
    if family == "gpt":
        cfg = GPTConfig(vocab_size=64, n_layer=N_LAYER, n_head=2,
                        d_model=32, d_ff=64, max_seq_len=16,
                        attention="flash")
        model = GPT(cfg, device="cpu", seed=3)
        tokens = torch.randint(0, 64, (2, 4, 17), generator=g)
        batches = [(t[:, :-1], t[:, 1:]) for t in tokens]
        return model, lm_loss_fn(model, vocab_chunk_size=chunk), batches
    cfg = BertConfig(vocab_size=64, n_layer=N_LAYER, n_head=2, d_model=32,
                     d_ff=64, max_seq_len=16, attention="flash")
    model = BertForMaskedLM(cfg, device="cpu", seed=3)
    ids = torch.randint(0, 64, (2, 4, 16), generator=g)
    mask = (torch.rand((2, 4, 16), generator=g) < 0.3).to(torch.int64)
    batches = [(ids[i], ids[i].roll(1, dims=-1), mask[i]) for i in range(2)]
    return model, masked_lm_loss_fn(model, vocab_chunk_size=chunk), batches


def _train(family: str, chunk: int, profiled: bool, path=None):
    """Two steps; returns the losses, each leaf's reduced gradient and
    value after them, and the profiler's Chrome trace (when profiled)."""
    model, loss_fn, batches = _model(family, chunk)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-3),
        compression=hvd.Compression.fp16)
    step = hvd.make_train_step(loss_fn, opt)
    losses = []
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for batch in batches:
                losses.append(step(model, batch))
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            doc = json.load(f)
    else:
        for batch in batches:
            losses.append(step(model, batch))
        doc = None
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return losses, grads, params, doc


def _annotations(doc, names):
    return sorted((e for e in doc["traceEvents"]
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e["name"] in names),
                  key=lambda e: e["ts"])


@pytest.mark.parametrize("family,chunk", CASES)
def test_layer_ranges_forward_then_backward(world, tmp_path, family, chunk):
    _, _, _, doc = _train(family, chunk, True, tmp_path / "t.json")
    ranges = _annotations(doc, LAYERS + STAGES)
    assert [e["name"] for e in ranges] == ONE_STEP * 2
    for name in LAYERS:   # each name twice a step: forward and backward
        want = 2 * (N_LAYER if name in (ATTN, MLP) else 1)
        assert sum(e["name"] == name for e in ranges) == 2 * want
    by_thread = {}
    for e in ranges:
        by_thread.setdefault(e["tid"], []).append(e)
    for events in by_thread.values():    # disjoint: nothing nests
        for a, b in zip(events, events[1:]):
            assert a["ts"] + a["dur"] <= b["ts"]
    # The flash backward runs inside a backward attention range.
    backward_attn = [e for i, e in enumerate(ranges)
                     if e["name"] == ATTN
                     and i % len(ONE_STEP) >= len(FORWARD)]
    nodes = [e for e in doc["traceEvents"] if e.get("ph") == "X"
             and "_Flash3Backward" in e.get("name", "")]
    assert nodes
    for node in nodes:
        assert any(r["tid"] == node["tid"] and r["ts"] <= node["ts"]
                   and node["ts"] + node["dur"] <= r["ts"] + r["dur"]
                   for r in backward_attn)
    steps = _annotations(doc, ("hvd_tpu_step",))
    assert len(steps) == 2
    for s, first in zip(steps, (0, len(ONE_STEP))):
        inside = ranges[first:first + len(ONE_STEP)]
        assert s["ts"] <= inside[0]["ts"]
        assert inside[-1]["ts"] + inside[-1]["dur"] <= s["ts"] + s["dur"]


@pytest.mark.parametrize("family,chunk", [("gpt", 0), ("bert", 0)])
def test_profiler_leaves_the_numbers_bitwise(world, tmp_path, family, chunk):
    on = _train(family, chunk, True, tmp_path / "t.json")
    off = _train(family, chunk, False)
    assert [float(x) for x in on[0]] == [float(x) for x in off[0]]
    for got, want in ((on[1], off[1]), (on[2], off[2])):
        assert got.keys() == want.keys()
        for name in got:
            assert torch.equal(got[name], want[name]), name


@pytest.mark.parametrize("family", ["gpt", "bert"])
def test_profiler_off_registers_nothing(world, monkeypatch, family):
    calls = []
    real = torch.Tensor.register_hook

    def counted(self, hook):
        calls.append(hook)
        return real(self, hook)

    monkeypatch.setattr(torch.Tensor, "register_hook", counted)
    trace.clear()      # init's plan compile
    _train(family, 0, False)
    assert calls == []
    names = [s["name"] for s in trace.snapshot()]
    assert names == ["hvd_tpu_wire", "hvd_tpu_apply", "hvd_tpu_step"] * 2


def test_ring_and_profiler_copy_share_the_clock(world, tmp_path):
    _, _, _, doc = _train("gpt", 0, True, tmp_path / "t.json")
    ring = [s for s in trace.snapshot() if s["name"] == "hvd_tpu_wire"]
    copies = _annotations(doc, ("hvd_tpu_wire",))
    assert len(ring) == len(copies) == 2
    base_us = doc["baseTimeNanoseconds"] / 1e3
    for rec, copy in zip(ring, copies):
        assert abs(base_us + copy["ts"] - rec["start_us"]) < 1e3


def test_layer_outside_a_scope_and_off_does_nothing(tmp_path):
    x = torch.ones(3, requires_grad=True) * 2

    @trace.layer_scope
    def forward(name):
        trace.layer(name, x)
        trace.layer(name, x)                 # the open name: nothing
        return trace.layer_loss((x * 3).sum())

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trace.layer(ATTN, x)                 # no scope on this thread
        y = forward(ATTN)
        y.backward()
    trace.layer(ATTN, x)                     # no profiler
    forward(MLP)
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    with open(tmp_path / "t.json") as f:
        ranges = _annotations(json.load(f), LAYERS)
    # forward ATTN, then the loss's hook opens ATTN's backward range and
    # the hook on x closes it (nothing came before ATTN).
    assert [e["name"] for e in ranges] == [ATTN, ATTN]
