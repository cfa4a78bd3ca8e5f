"""The port's QoS tier (``horovod_tpu_torch/serve/qos``) against the
reference's (``horovod_tpu/serve/qos``): the weighted-fair queue
dispatches in the same order under the same pushes (with the
``qos:mode=invert`` fault too), the brownout ladder takes the same steps
under the same clock, and the ``hvd_tpu_qos_*`` counters move alike.
Then the reference's QoS tests (``tests/test_qos.py``, without the swap
and fleet cases) on the port: budgets, preemption with the token-
identity oracle (greedy, temperature, speculative, after eviction,
chunked, after a weight flip), per-class stats and the chaos drill.
"""

import os
import random
import threading
import time

import jax
import numpy as np
import pytest

from horovod_tpu import faults as jfaults
from horovod_tpu.obs import metrics as jmetrics
from horovod_tpu.serve import BrownoutController as JaxBrownout
from horovod_tpu.serve import QosPolicy as JaxPolicy
from horovod_tpu.serve import QosQueue as JaxQueue

from horovod_tpu_torch import faults
from horovod_tpu_torch.config import parse_qos_map
from horovod_tpu_torch.obs import metrics
from horovod_tpu_torch.serve import (
    BrownoutController, BudgetExhaustedError, ContinuousBatcher,
    InferenceEngine, InferenceServer, QosGate, QosPolicy, QosQueue,
    ReplicaSpec, RequestShedError, Router, SamplingParams, ServingStats,
)
from horovod_tpu_torch.serve.qos import preempt as preempt_mod
from horovod_tpu_torch.serve.qos import validate_class

from torch_port_serve import (ENGINE_DEFAULTS, KEY, drive, fixture,
                              run_engine, torch_model)

pytestmark = pytest.mark.serving


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


@pytest.fixture
def registries(monkeypatch):
    """Fresh metrics registries in both packages."""
    monkeypatch.setattr(metrics, "_default", metrics.MetricsRegistry())
    monkeypatch.setattr(jmetrics, "_default", jmetrics.MetricsRegistry())
    monkeypatch.setattr(metrics, "_enabled", True)
    monkeypatch.setattr(jmetrics, "_enabled", True)


def _series(registry, name):
    return {tuple(s["labels"].items()): s["value"]
            for s in registry.snapshot().get(name, [])}


def _engine(**kw):
    return InferenceEngine(fixture()[2], **dict(ENGINE_DEFAULTS, **kw))


def _run(engine, slot, prompt, n, temperature=0.0):
    return run_engine(engine, slot, prompt, n, SamplingParams,
                      temperature=temperature)


class _Q:
    """Minimal ServeRequest stand-in for direct queue tests."""

    def __init__(self, rid, tenant, cls, deadline=None):
        self.request_id = rid
        self.tenant = tenant
        self.qos_class = cls
        self.deadline = deadline


# --- against the reference ----------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_wfq_dispatch_order_matches_the_reference(seed):
    """Seeded pushes over tenants, classes and shares, pops, removals
    and expiries, with ``qos:mode=invert`` armed in both packages at the
    same pop: the same requests come out in the same order."""
    rng = random.Random(seed)
    shares = {"paid": 3.0, "free": 1.0}
    port = QosQueue(QosPolicy(tenant_shares=shares))
    ref = JaxQueue(JaxPolicy(tenant_shares=shares))
    spec = f"qos:step={rng.randrange(8)},mode=invert,times=2"
    n = 0
    with faults.inject(spec), jfaults.inject(spec):
        for _ in range(150):
            op = rng.choice(["push", "push", "pop", "remove", "expire"])
            if op == "push":
                args = (f"r{n}", rng.choice(["paid", "free", "bulk"]),
                        rng.choice(["interactive", "standard", "batch"]),
                        rng.choice([None, rng.uniform(0, 50)]))
                n += 1
                port.push(_Q(*args))
                ref.push(_Q(*args))
            elif op == "pop":
                a, b = port.pop(), ref.pop()
                assert (a and a.request_id) == (b and b.request_id)
            elif op == "remove":
                rid = f"r{rng.randrange(max(1, n))}"
                a, b = port.remove(rid), ref.remove(rid)
                assert (a and a.request_id) == (b and b.request_id)
            else:
                now = rng.uniform(0, 50)
                assert [r.request_id for r in port.pop_expired(now)] == \
                    [r.request_id for r in ref.pop_expired(now)]
            assert len(port) == len(ref)
            assert port.depths() == ref.depths()
        assert faults.history() == jfaults.history()


def test_brownout_steps_match_the_reference_under_one_clock():
    rng = random.Random(3)
    kw = dict(queue_capacity=100, high=0.8, low=0.2, hold_s=5.0,
              slo_ttft_ms=100.0)
    port, ref = BrownoutController(**kw), JaxBrownout(**kw)
    now = 0.0
    for _ in range(300):
        now += rng.uniform(0.1, 3.0)
        depth = rng.choice([0, 10, 50, 90, rng.uniform(0, 100)])
        ttft = rng.choice([None, 50.0, 250.0])
        assert port.observe(depth, ttft, now=now) == \
            ref.observe(depth, ttft, now=now)
        for cls in ("interactive", "standard", "batch"):
            outcomes = []
            for ctl in (port, ref):
                try:
                    ctl.check(cls)
                    outcomes.append(None)
                except Exception as e:   # each package's own error type
                    outcomes.append((type(e).__name__, e.level,
                                     e.retry_after_s))
            assert outcomes[0] == outcomes[1]


def test_qos_counters_match_the_reference(registries):
    """The shed, budget and brownout series after the same gate traffic
    in both packages."""
    from horovod_tpu.serve import QosGate as JaxGate

    gates = []
    for gate_cls, ctl_cls, pol_cls in (
            (QosGate, BrownoutController, QosPolicy),
            (JaxGate, JaxBrownout, JaxPolicy)):
        gate = gate_cls(brownout=ctl_cls(queue_capacity=10),
                        policy=pol_cls(tenant_budgets={"t": 1.0},
                                       burst_s=10.0))
        for depth, cls, tenant in ((9, "batch", "t"), (9, "standard", "u"),
                                   (0, "interactive", "t"),
                                   (0, "interactive", "t")):
            gate.observe(depth, now=0.0)
            try:
                gate.admit(tenant, cls, 8.0)
            except Exception:
                pass
        gates.append(gate)
    for name in ("hvd_tpu_qos_sheds_total", "hvd_tpu_qos_budget_rejects_total",
                 "hvd_tpu_qos_brownout_level"):
        assert _series(metrics.registry(), name) == \
            _series(jmetrics.registry(), name), name
    assert _series(metrics.registry(), "hvd_tpu_qos_sheds_total")
    assert _series(metrics.registry(), "hvd_tpu_qos_budget_rejects_total")


# --- weighted-fair queue ------------------------------------------------------

def test_single_flow_is_fifo():
    q = QosQueue(QosPolicy())
    for i in range(6):
        q.push(_Q(f"r{i}", "default", "standard"))
    assert [q.pop().request_id for _ in range(6)] == [f"r{i}" for i in range(6)]


def test_hot_tenant_cannot_starve_small_tenant():
    q = QosQueue(QosPolicy())
    for i in range(20):
        q.push(_Q(f"hot-{i}", "hot", "standard"))
    for i in range(4):
        q.push(_Q(f"small-{i}", "small", "standard"))
    order = [q.pop().request_id for _ in range(24)]
    small_at = [i for i, rid in enumerate(order) if rid.startswith("small")]
    assert max(small_at) <= 8, order


def test_class_weights_bias_dispatch():
    q = QosQueue(QosPolicy())
    for i in range(16):
        q.push(_Q(f"i{i}", "t", "interactive"))
        q.push(_Q(f"b{i}", "t", "batch"))
    first = [q.pop().request_id for _ in range(18)]
    assert sum(1 for rid in first if rid.startswith("i")) >= 14, first


def test_tenant_shares_scale_weight():
    q = QosQueue(QosPolicy(tenant_shares={"paid": 4.0}))
    for i in range(12):
        q.push(_Q(f"paid-{i}", "paid", "standard"))
        q.push(_Q(f"free-{i}", "free", "standard"))
    first = [q.pop().request_id for _ in range(10)]
    assert sum(1 for r in first if r.startswith("paid")) >= 7, first


def test_idle_flow_banks_no_credit():
    q = QosQueue(QosPolicy())
    q.push(_Q("lazy-0", "lazy", "standard"))
    assert q.pop().request_id == "lazy-0"
    for i in range(8):
        q.push(_Q(f"busy-{i}", "busy", "standard"))
    for _ in range(6):
        q.pop()
    for i in range(4):
        q.push(_Q(f"lazy-{i + 1}", "lazy", "standard"))
    first4 = [q.pop().request_id for _ in range(4)]
    assert any(r.startswith("busy") for r in first4), first4
    assert any(r.startswith("lazy") for r in first4), first4


def test_remove_and_len():
    q = QosQueue(QosPolicy())
    q.push(_Q("a", "t", "standard"))
    q.push(_Q("b", "t", "standard"))
    assert len(q) == 2
    assert q.remove("a").request_id == "a"
    assert q.remove("a") is None
    assert len(q) == 1
    assert q.pop().request_id == "b"
    assert q.pop() is None


def test_expiry_is_heap_ordered_and_lazy():
    q = QosQueue(QosPolicy())
    q.push(_Q("d2", "t", "standard", deadline=2.0))
    q.push(_Q("d1", "t", "standard", deadline=1.0))
    q.push(_Q("never", "t", "standard"))
    q.push(_Q("d3", "t", "standard", deadline=3.0))
    assert q.pop().request_id == "d2"
    assert [r.request_id for r in q.pop_expired(2.5)] == ["d1"]
    assert q.pop_expired(2.5) == []
    assert len(q) == 2
    assert [r.request_id for r in q.pop_expired(10.0)] == ["d3"]
    assert q.pop().request_id == "never"


def test_expired_queue_requests_finish_typed():
    batcher = ContinuousBatcher(_engine(max_slots=1), default_deadline_s=0)
    blocker = batcher.submit([1, 2, 3], SamplingParams(max_new_tokens=8),
                             qos_class="standard")
    batcher.step()
    doomed = batcher.submit([4, 5], SamplingParams(max_new_tokens=4),
                            deadline_s=0.01, qos_class="batch")
    time.sleep(0.03)
    batcher.step()
    assert doomed.error == "deadline_exceeded"
    drive(batcher, lambda: blocker.done.is_set())


# --- token-bucket budgets -----------------------------------------------------

def test_budget_exhaustion_is_typed_and_retriable():
    policy = QosPolicy(tenant_budgets={"t": 10.0}, burst_s=4.0)
    assert policy.charge("t", 30.0) == 30.0   # capacity 40
    with pytest.raises(BudgetExhaustedError) as ei:
        policy.charge("t", 30.0)
    assert ei.value.tenant == "t"
    assert ei.value.retry_after_s > 0
    assert policy.charge("free", 1e6) == 0.0


def test_bucket_refills_over_time():
    policy = QosPolicy(tenant_budgets={"t": 1000.0}, burst_s=0.01)
    policy.charge("t", 10.0)
    with pytest.raises(BudgetExhaustedError):
        policy.charge("t", 10.0)
    time.sleep(0.05)
    assert policy.charge("t", 10.0) == 10.0


def test_zero_tenant_share_rejected_at_parse():
    with pytest.raises(ValueError):
        parse_qos_map("acme=0", "qos tenant shares", positive=True)
    assert parse_qos_map("acme=0", "qos tenant budgets") == {"acme": 0.0}


def test_qos_knobs_parse_at_config(monkeypatch):
    from horovod_tpu_torch.config import Config

    monkeypatch.setenv("HVD_TPU_QOS_TENANT_SHARES", "paid=0")
    with pytest.raises(ValueError):
        Config.from_env()
    monkeypatch.setenv("HVD_TPU_QOS_TENANT_SHARES", "paid=2")
    monkeypatch.setenv("HVD_TPU_SERVE_PREFILL_BUCKETS", "256,64")
    cfg = Config.from_env()
    assert QosPolicy.from_config(cfg).weight("paid", "batch") == 2.0
    assert cfg.serve_prefill_buckets == (64, 256)


def test_batcher_rejection_lands_on_obs_counter(registries):
    batcher = ContinuousBatcher(
        _engine(), default_deadline_s=0,
        qos_policy=QosPolicy(tenant_budgets={"tiny": 0.5}, burst_s=2.0))
    with pytest.raises(BudgetExhaustedError):
        batcher.submit([1] * 4, SamplingParams(max_new_tokens=16),
                       tenant="tiny")
    series = _series(metrics.registry(), "hvd_tpu_qos_budget_rejects_total")
    assert series.get((("tenant", "tiny"),), 0) >= 1, series


def test_gate_refunds_full_charge_when_fleet_fails():
    from horovod_tpu_torch.utils.retry import RetryPolicy

    gate = QosGate(policy=QosPolicy(tenant_budgets={"t": 0.5},
                                    burst_s=60.0))   # capacity 30
    router = Router([ReplicaSpec("ghost", [("127.0.0.1", 1)])], KEY,
                    retry_policy=RetryPolicy(attempts=2, base_delay_s=0.01,
                                             max_delay_s=0.02),
                    probe_timeout=0.2)
    router.attach_qos(gate)
    for _ in range(3):
        with pytest.raises(Exception) as ei:
            router.generate([1, 2, 3, 4], max_new_tokens=16, tenant="t")
        assert not isinstance(ei.value, BudgetExhaustedError), ei.value


def test_refund_returns_unused_reservation():
    policy = QosPolicy(tenant_budgets={"t": 1.0}, burst_s=40.0)
    policy.charge("t", 30.0)
    policy.refund("t", 25.0)
    assert policy.charge("t", 30.0) == 30.0


def test_batcher_admission_charges_and_rejects():
    batcher = ContinuousBatcher(
        _engine(), default_deadline_s=0,
        qos_policy=QosPolicy(tenant_budgets={"limited": 5.0}, burst_s=8.0))
    sp = SamplingParams(max_new_tokens=16)
    r1 = batcher.submit([1] * 4, sp, tenant="limited")
    batcher.submit([1] * 4, sp, tenant="limited")
    with pytest.raises(BudgetExhaustedError):
        batcher.submit([1] * 4, sp, tenant="limited")
    r4 = batcher.submit([2] * 4, sp, tenant="other")
    drive(batcher, lambda: r1.done.is_set() and r4.done.is_set())
    snap = batcher.stats.snapshot()
    assert snap["budget_rejects"] == 1
    assert snap["tenants"]["limited"]["rejected"] == 1


def test_budget_rejection_over_the_wire():
    batcher = ContinuousBatcher(
        _engine(), default_deadline_s=0,
        qos_policy=QosPolicy(tenant_budgets={"limited": 0.5},
                             burst_s=40.0))   # capacity 20
    server = InferenceServer(batcher, key=KEY, name="qos-rep",
                             host="127.0.0.1")
    router = Router([ReplicaSpec("qos-rep", [("127.0.0.1", server.port)])],
                    KEY)
    try:
        ok = router.generate([3, 4, 5], max_new_tokens=16, tenant="limited")
        assert ok.error is None and len(ok.tokens) > 0
        rej = router.generate([3, 4, 6], max_new_tokens=16, tenant="limited")
        assert rej.error.startswith("budget_exhausted")
        assert "retry_after_s" in rej.error
        assert router.replica_stats(timeout=5.0)["qos-rep"]["strikes"] == 0
    finally:
        server.shutdown()


# --- brownout ladder ----------------------------------------------------------

def _ladder(**kw):
    kw.setdefault("queue_capacity", 100)
    kw.setdefault("high", 0.8)
    kw.setdefault("low", 0.2)
    kw.setdefault("hold_s", 5.0)
    return BrownoutController(**kw)


def test_sheds_batch_first_then_standard_never_interactive():
    b = _ladder()
    b.observe(90, now=0.0)
    assert b.level == 1
    with pytest.raises(RequestShedError) as ei:
        b.check("batch")
    assert ei.value.retry_after_s > 0
    b.check("standard")
    b.check("interactive")
    b.observe(90, now=1.0)
    assert b.level == 2
    with pytest.raises(RequestShedError):
        b.check("standard")
    b.check("interactive")


def test_hysteresis_no_oscillation_in_the_band():
    b = _ladder()
    b.observe(90, now=0.0)
    for t in range(1, 20):
        b.observe(50, now=float(t))
        assert b.level == 1
    b.observe(10, now=21.0)
    b.observe(10, now=23.0)
    assert b.level == 1
    b.observe(50, now=24.0)
    b.observe(10, now=25.0)
    b.observe(10, now=29.0)
    assert b.level == 1
    b.observe(10, now=31.0)
    assert b.level == 0


def test_unbrowns_one_step_per_hold():
    b = _ladder()
    b.observe(90, now=0.0)
    b.observe(90, now=1.0)
    assert b.level == 2
    b.observe(5, now=2.0)
    b.observe(5, now=8.0)
    assert b.level == 1
    b.observe(5, now=14.0)
    assert b.level == 0


def test_slo_breach_steps_up_even_with_empty_queue():
    b = _ladder(slo_ttft_ms=100.0)
    b.observe(0, interactive_ttft_p99_ms=250.0, now=0.0)
    assert b.level == 1


def test_gate_shed_is_pre_replica():
    batcher = ContinuousBatcher(_engine(), default_deadline_s=0)
    server = InferenceServer(batcher, key=KEY, name="gate-rep",
                             host="127.0.0.1")
    router = Router([ReplicaSpec("gate-rep", [("127.0.0.1", server.port)])],
                    KEY)
    gate = QosGate(brownout=_ladder())
    router.attach_qos(gate)
    try:
        gate.observe(90, now=0.0)
        with pytest.raises(RequestShedError):
            router.generate([1, 2, 3], max_new_tokens=4, qos_class="batch")
        ok = router.generate([1, 2, 3], max_new_tokens=4,
                             qos_class="interactive")
        assert ok.error is None
        stats = router.replica_stats(timeout=5.0)
        assert stats["gate-rep"]["stats"]["requests_completed"] == 1
    finally:
        server.shutdown()


# --- deadline-aware preemption ------------------------------------------------

def test_pick_victim_is_youngest_batch():
    class R:
        def __init__(self, cls, tokens, sub):
            self.qos_class = cls
            self.tokens = [0] * tokens
            self.submitted_at = sub
            self.done = threading.Event()
    active = {0: R("interactive", 1, 1.0), 1: R("batch", 5, 2.0),
              2: R("batch", 2, 3.0)}
    slot, _ = preempt_mod.pick_victim(active)
    assert slot == 2
    assert preempt_mod.pick_victim({0: R("standard", 1, 1.0)}) is None


def _preempted_run(prompt, n_tok, steps, temperature=0.0, deadline=0.6,
                   flush=False, engine_kw=None, registry=None):
    """A batch generation preempted by a tight-deadline interactive one
    after ``steps`` steps, then run to the end."""
    engine = _engine(max_slots=1, **(engine_kw or {}))
    batcher = ContinuousBatcher(engine, default_deadline_s=0)
    breq = batcher.submit(prompt, SamplingParams(
        max_new_tokens=n_tok, temperature=temperature), qos_class="batch")
    for _ in range(steps):
        batcher.step()
    assert 0 < len(breq.tokens) < n_tok
    ireq = batcher.submit([2, 4, 6], SamplingParams(max_new_tokens=3),
                          deadline_s=deadline, qos_class="interactive")
    drive(batcher, lambda: ireq.done.is_set())
    assert ireq.error is None and len(ireq.tokens) == 3
    assert breq.preemptions == 1
    if flush:
        engine._kv.flush_cache()
    drive(batcher, lambda: breq.done.is_set())
    assert breq.error is None
    return breq, batcher


def test_preempt_resume_token_identity_greedy(registries):
    prompt, n_tok = [5, 11, 17, 23], 24
    ref = _run(_engine(max_slots=1), 0, prompt, n_tok)
    breq, batcher = _preempted_run(prompt, n_tok, steps=4)
    assert breq.tokens == ref
    assert batcher.stats.snapshot()["preemptions"] == 1
    assert breq.prefix_hit_tokens > 0
    assert _series(metrics.registry(), "hvd_tpu_qos_preemptions_total") \
        == {(): 1}


def test_preempt_resume_token_identity_temperature():
    """The generator state taken at preemption is restored after the
    tail recompute (the sole-active-slot contract): temperature
    resumption reproduces the uninterrupted run within the port."""
    prompt, n_tok = [7, 3, 9], 20
    ref = _run(_engine(max_slots=1, seed=5), 0, prompt, n_tok,
               temperature=0.8)
    breq, _ = _preempted_run(prompt, n_tok, steps=5, temperature=0.8,
                             engine_kw={"seed": 5})
    assert breq.tokens == ref


def test_resume_recomputes_after_cache_eviction():
    prompt, n_tok = [5, 11, 17, 23], 24
    ref = _run(_engine(max_slots=1), 0, prompt, n_tok)
    breq, _ = _preempted_run(prompt, n_tok, steps=4, flush=True)
    assert breq.tokens == ref


def test_resume_chunked_past_largest_bucket():
    prompt, n_tok = [3, 1, 4, 1, 5], 25
    engine = _engine(max_slots=1)
    ref = _run(_engine(max_slots=1), 0, prompt, n_tok)
    sp = SamplingParams(max_new_tokens=n_tok)
    toks = [engine.start(0, prompt, sp)]
    while len(toks) < 20:
        toks.extend(engine.step()[0])
    rng = engine.preempt_slot(0, prompt, toks)
    engine._kv.flush_cache()
    engine.resume_slot(0, prompt, toks, sp, rng=rng)
    while len(toks) < n_tok:
        toks.extend(engine.step()[0])
    engine.release(0)
    assert toks[:n_tok] == ref


def test_resume_after_weight_flip_restarts_single_version():
    _, params, _ = fixture()
    new = jax.tree.map(np.asarray, params)
    new["embed"]["embedding"] = new["embed"]["embedding"] + 0.01
    prompt, n_tok = [5, 11, 17, 23], 24
    ref_new = _run(InferenceEngine(torch_model(new), max_slots=1,
                                   prefill_buckets=(8, 16), max_seq_len=32),
                   0, prompt, n_tok)
    engine = InferenceEngine(torch_model(params),
                             **dict(ENGINE_DEFAULTS, max_slots=1))
    batcher = ContinuousBatcher(engine, default_deadline_s=0)
    breq = batcher.submit(prompt, SamplingParams(max_new_tokens=n_tok),
                          qos_class="batch")
    for _ in range(4):
        batcher.step()
    ireq = batcher.submit([2, 4, 6], SamplingParams(max_new_tokens=2),
                          deadline_s=0.6, qos_class="interactive")
    drive(batcher, lambda: ireq.done.is_set())
    assert breq.preemptions == 1
    engine.stage_params(new, version=2)
    engine.commit_staged()
    drive(batcher, lambda: breq.done.is_set())
    assert breq.error is None
    assert breq.tokens == ref_new
    assert breq.weights_version == 2


def test_preempt_resume_token_identity_speculative():
    model = fixture()[2]
    prompt, n_tok = [5, 11, 17, 23], 13
    ref = _run(_engine(max_slots=1), 0, prompt, n_tok)
    engine = _engine(max_slots=1, drafter=model, spec_k=2)
    batcher = ContinuousBatcher(engine, default_deadline_s=0)
    breq = batcher.submit(prompt, SamplingParams(max_new_tokens=n_tok,
                                                 spec=True),
                          qos_class="batch")
    batcher.step()
    assert 0 < len(breq.tokens) < n_tok
    ireq = batcher.submit([2, 4, 6], SamplingParams(max_new_tokens=2),
                          deadline_s=0.12, qos_class="interactive")
    drive(batcher, lambda: ireq.done.is_set())
    assert breq.preemptions == 1
    drive(batcher, lambda: breq.done.is_set())
    assert breq.error is None
    assert breq.tokens == ref


def test_can_resume_guards_drafter_bucket():
    model = fixture()[2]
    engine = _engine(max_slots=1, drafter=model, spec_k=2)
    assert engine.can_resume(4, 10)
    assert not engine.can_resume(10, 10)
    assert _engine(max_slots=1).can_resume(10, 18)


def test_no_preemption_when_disabled():
    batcher = ContinuousBatcher(_engine(max_slots=1), default_deadline_s=0,
                                qos_preempt=False)
    breq = batcher.submit([1, 2, 3], SamplingParams(max_new_tokens=24),
                          qos_class="batch")
    batcher.step()
    ireq = batcher.submit([2, 4], SamplingParams(max_new_tokens=2),
                          deadline_s=30.0, qos_class="interactive")
    for _ in range(6):
        batcher.step()
    assert breq.preemptions == 0
    drive(batcher, lambda: breq.done.is_set() and ireq.done.is_set())


def test_interactive_admitted_within_two_steps_under_flood():
    batcher = ContinuousBatcher(_engine(max_slots=2), default_deadline_s=0)
    batch = [batcher.submit([1, 2, 3], SamplingParams(max_new_tokens=24),
                            tenant="bulk", qos_class="batch")
             for _ in range(8)]
    batcher.step()
    batcher.step()
    ireq = batcher.submit([2, 4, 6], SamplingParams(max_new_tokens=2),
                          deadline_s=0.8, qos_class="interactive")
    steps = 0
    while ireq.first_token_at is None and steps < 2:
        batcher.step()
        steps += 1
    assert ireq.first_token_at is not None
    drive(batcher, lambda: all(r.done.is_set() for r in batch)
          and ireq.done.is_set())
    assert ireq.error is None
    assert all(r.error is None for r in batch)


def test_per_class_stats_in_snapshot():
    batcher = ContinuousBatcher(_engine(), default_deadline_s=0)
    reqs = [batcher.submit([1, 2], SamplingParams(max_new_tokens=2),
                           tenant="a", qos_class="interactive"),
            batcher.submit([3, 4], SamplingParams(max_new_tokens=2),
                           tenant="b", qos_class="batch")]
    drive(batcher, lambda: all(r.done.is_set() for r in reqs))
    snap = batcher.snapshot()
    assert snap["qos"]["interactive"]["completed"] == 1
    assert snap["qos"]["batch"]["completed"] == 1
    assert snap["qos"]["interactive"]["ttft_ms_p99"] > 0
    assert snap["qos"]["batch"]["goodput_tok_per_s"] > 0
    assert snap["tenants"]["a"]["tokens_out"] == 2
    assert "queued_by_class" in snap


def test_tenant_rollup_is_bounded():
    stats = ServingStats()
    for i in range(80):
        stats.record_request(0.01, 2, 0.02, qos_class="standard",
                             tenant=f"tenant-{i}")
    snap = stats.snapshot()
    assert len(snap["tenants"]) <= 65
    assert "other" in snap["tenants"]


def test_validate_class():
    assert validate_class(None) == "standard"
    assert validate_class("Interactive") == "interactive"
    with pytest.raises(ValueError):
        validate_class("platinum")


@pytest.mark.chaos
def test_brownout_drill_holds_interactive_slo():
    """A randomized ``qos:invert`` or ``qos:flood`` injection against a
    mixed-tenant overload: every interactive request completes inside
    the SLO while the batch flood absorbs the damage."""
    step = int(os.environ.get("HVD_TPU_CHAOS_STEP", "3"))
    seed = int(os.environ.get("HVD_TPU_CHAOS_SEED", "0"))
    mode = random.Random(seed).choice(["invert", "flood"])
    slo_ms = 1500.0
    batcher = ContinuousBatcher(
        _engine(max_slots=2), default_deadline_s=0,
        qos_policy=QosPolicy(tenant_budgets={"bulk": 200.0}, burst_s=2.0))
    inter, batch = [], []
    with faults.inject(f"qos:step={step},mode={mode},times=3"):
        for i in range(8):
            try:
                batch.append(batcher.submit(
                    [1 + i % 7, 2, 3], SamplingParams(max_new_tokens=24),
                    tenant="bulk", qos_class="batch"))
            except BudgetExhaustedError:
                pass
        batcher.step()
        batcher.step()
        for i in range(4):
            inter.append(batcher.submit(
                [2 + i, 4, 6], SamplingParams(max_new_tokens=3),
                deadline_s=slo_ms / 1e3, qos_class="interactive"))
            batcher.step()
        drive(batcher, lambda: all(r.done.is_set() for r in inter + batch))
    assert all(r.error is None for r in inter)
    p99 = batcher.stats.snapshot()["qos"]["interactive"]["ttft_ms_p99"]
    assert p99 is not None and p99 <= slo_ms
    assert all(r.error is None for r in batch)
