"""The port's observability core (``horovod_tpu_torch/obs/``: metrics,
instrument, aggregate, export, and the obs knobs of ``config``/``basics``)
against the reference's ``horovod_tpu/obs/``.

Mirrors ``tests/test_obs.py``'s ``TestRegistry``,
``TestPrometheusExposition``, ``TestStragglerDetection``,
``TestInstrumentation`` (not its tracer-bypass and timeline cases: a
torch step is never traced inside another program, and the port has no
timeline yet) and ``TestConfigKnobs`` (not its fleet-telemetry knobs),
plus parity:

* the same seeded sequence of ``inc``/``set``/``add``/``observe``/
  ``labels`` calls into both registries gives equal ``snapshot()`` dicts
  and byte-identical Prometheus text, over-cap label overflow included;
* each hook called with the same arguments in both packages leaves equal
  snapshots (and decision logs);
* the pure functions ``summarize``/``detect_stragglers`` give equal
  outputs; ``cross_rank_summary`` on a 2-rank gloo world equals
  ``summarize`` over the gathered values on every rank;
* the same environment parses to equal knob values;
* the slice end to end: a 2-layer narrow GPT, the same
  ``load_jax_params`` weights, 3 steps of ``make_train_step`` in both
  packages on one rank / one device: equal step, sample and token
  counters, equal plan records by tier (once per build, so one after 3
  steps, two after a rebuild), the microbatch gauges, and Prometheus
  texts byte-identical once the time-valued families are dropped; the
  overlap wire's plan records at two ranks equal the reference's on two
  devices.

The reference's registry is process-global: each parity test swaps a
fresh one into both packages (``monkeypatch``), so nothing recorded here
leaks into the reference's own tests.
"""

import collections
import json
import random
import re
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from horovod_tpu.config import Config as JaxConfig
from horovod_tpu.models.transformer import GPT as JaxGPT
from horovod_tpu.models.transformer import GPTConfig as JaxGPTConfig
from horovod_tpu.models.transformer import lm_loss_fn as jax_lm_loss_fn
from horovod_tpu.obs import aggregate as jagg
from horovod_tpu.obs import export as jexport
from horovod_tpu.obs import instrument as jinstr
from horovod_tpu.obs import metrics as jmetrics
from horovod_tpu.optim.distributed_optimizer import (
    make_train_step as jax_make_train_step)

import horovod_tpu_torch as hvd
from horovod_tpu_torch.config import Config
from horovod_tpu_torch.obs import aggregate, export, instrument, metrics
from horovod_tpu_torch.obs.metrics import MetricsRegistry, Ring, percentile

import torch_port_workers as workers
from test_obs import _parse_prometheus, _value

N = 2
GPT_CFG = dict(vocab_size=128, n_layer=2, n_head=4, d_model=32, d_ff=64,
               max_seq_len=16)
# Families the end-to-end text comparison drops: the time-valued ones, and
# the session plan's axes (the port's world of one, the reference's
# session of eight slots).
DROPPED = ("hvd_tpu_step_time_seconds", "hvd_tpu_tokens_per_s",
           "hvd_tpu_plan_axes")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = workers.World(N, str(tmp_path_factory.mktemp("gloo") / "store"))
    yield w
    w.close()


@pytest.fixture
def fresh(monkeypatch):
    """Fresh default registries, open gates and empty autotune logs in
    both packages: ``(reference registry, port registry)``."""
    regs = []
    for mod, instr in ((jmetrics, jinstr), (metrics, instrument)):
        reg = mod.MetricsRegistry()
        monkeypatch.setattr(mod, "_default", reg)
        monkeypatch.setattr(mod, "_enabled", True)
        monkeypatch.setattr(instr, "_autotune_log",
                            collections.deque(maxlen=64))
        regs.append(reg)
    return tuple(regs)


# --- the registry ---------------------------------------------------------------

def _drive(reg, seed: int, n_calls: int = 300) -> None:
    """A seeded sequence of registry calls: counters, gauges and
    histograms, label sets drawn from more values than the cap holds."""
    rng = random.Random(seed)
    for _ in range(n_calls):
        kind = rng.choice(("counter", "gauge", "histogram"))
        fam = getattr(reg, kind)(f"{kind[0]}{rng.randrange(3)}",
                                 rng.choice(("", "some help")))
        labels = {}
        if rng.random() < 0.7:
            labels["tier"] = rng.choice(("spmd", "slots", "overlap",
                                         "a\"b", "x\\y"))
        if rng.random() < 0.3:
            labels["op"] = f"op{rng.randrange(8)}"
        series = fam.labels(**labels) if labels else fam
        value = round(rng.uniform(0, 1e4), rng.randrange(4))
        if kind == "counter":
            series.inc(value)
        elif kind == "gauge":
            (series.set if rng.random() < 0.5 else series.add)(value)
        else:
            series.observe(value)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_seeded_calls_give_equal_snapshots_and_text(seed):
    """The same calls into both registries (window 8, a cap of 4 label
    sets) give equal snapshots (count, sum, p50/p90/p99, mean, buckets,
    the ``other="true"`` overflow series) and byte-identical Prometheus
    text."""
    ref = jmetrics.MetricsRegistry(window=8, max_label_sets=4)
    port = MetricsRegistry(window=8, max_label_sets=4)
    _drive(ref, seed)
    _drive(port, seed)
    assert port.snapshot() == ref.snapshot()
    assert any(row["labels"] == {"other": "true"}
               for rows in port.snapshot().values() for row in rows)
    text = export.render_prometheus(port)
    assert text == jexport.render_prometheus(ref)
    _parse_prometheus(text)


def test_counter_gauge_histogram_basics():
    reg = MetricsRegistry(window=8)
    reg.counter("c", "help c").inc()
    reg.counter("c").inc(2.5)
    reg.gauge("g").set(7)
    h = reg.histogram("h")
    for v in range(10):
        h.observe(float(v))
    snap = reg.snapshot()
    assert _value(snap, "c") == 3.5
    assert _value(snap, "g") == 7.0
    (hs,) = snap["h"]
    assert hs["count"] == 10 and hs["sum"] == 45.0
    assert hs["p50"] is not None and 2.0 <= hs["p50"] <= 9.0


@pytest.mark.parametrize("make,err", [
    (lambda reg: reg.counter("c").inc(-1), ">= 0"),
    (lambda reg: (reg.counter("x"), reg.gauge("x")), "already registered"),
])
def test_registry_rejects(make, err):
    with pytest.raises(ValueError, match=err):
        make(MetricsRegistry())


def test_cardinality_cap_collapses_to_overflow():
    reg = MetricsRegistry(max_label_sets=3)
    fam = reg.counter("c")
    for i in range(10):
        fam.labels(tensor=f"t{i}").inc()
    snap = reg.snapshot()
    assert len(snap["c"]) == 4
    assert _value(snap, "c", other="true") == 7.0


def test_concurrent_counter_writers_are_exact():
    import threading

    reg = MetricsRegistry()
    fam = reg.counter("n")
    barrier = threading.Barrier(8)

    def work():
        barrier.wait()
        for _ in range(1000):
            fam.inc()

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert _value(reg.snapshot(), "n") == 8000.0


def test_ring_and_percentile_primitives():
    r = Ring(4)
    for v in (1.0, 2.0, 3.0, 4.0, 5.0):
        r.append(v)
    assert r.values() == [2.0, 3.0, 4.0, 5.0]
    assert r.mean() == 3.5
    assert percentile([], 50) is None
    xs = [random.Random(9).uniform(0, 1) for _ in range(37)]
    for q in (0, 1, 50, 90, 99, 100):
        assert percentile(xs, q) == jmetrics.percentile(xs, q)


# --- Prometheus exposition --------------------------------------------------------

def test_escaping_and_label_rendering():
    reg = MetricsRegistry()
    reg.counter("esc_total", 'help with \\ and\nnewline').labels(
        path='a"b\\c\nd').inc()
    text = export.render_prometheus(reg)
    help_line = [l for l in text.splitlines() if l.startswith("# HELP")][0]
    assert help_line == "# HELP esc_total help with \\\\ and\\nnewline"
    sample = [l for l in text.splitlines() if not l.startswith("#")][0]
    assert sample == 'esc_total{path="a\\"b\\\\c\\nd"} 1'
    _parse_prometheus(text)


@pytest.mark.parametrize("window,values,lines", [
    (1024, (1.0, 2.0, 3.0), ['lat_seconds_bucket{kind="x",le="1"} 1',
                             'lat_seconds_bucket{kind="x",le="5"} 3',
                             'lat_seconds_bucket{kind="x",le="+Inf"} 3',
                             'lat_seconds_sum{kind="x"} 6',
                             'lat_seconds_count{kind="x"} 3']),
    (4, tuple(float(v) for v in range(1, 11)),
     ['lat_seconds_bucket{kind="x",le="10"} 4',
      'lat_seconds_bucket{kind="x",le="+Inf"} 10',
      'lat_seconds_count{kind="x"} 10']),
])
def test_histogram_renders_cumulative_buckets(window, values, lines):
    """Cumulative buckets over the ring's window; the evicted mass lands in
    ``+Inf``, whose count is the exact all-time count."""
    reg = MetricsRegistry(window=window)
    h = reg.histogram("lat_seconds", "latency").labels(kind="x")
    for v in values:
        h.observe(v)
    text = export.render_prometheus(reg)
    assert "# TYPE lat_seconds histogram" in text
    assert "quantile=" not in text
    for line in lines:
        assert line in text
    _parse_prometheus(text)


def test_unset_gauge_renders_no_sample():
    reg = MetricsRegistry()
    reg.gauge("g", "never set")
    text = export.render_prometheus(reg)
    assert "# TYPE g gauge" in text
    assert not [l for l in text.splitlines() if l.startswith("g ")]


def test_http_exporter_serves_both_formats(fresh):
    """The scrape port: ``/metrics`` parses into the families recorded,
    ``/metrics.json`` is the JSON snapshot; a second start returns the
    live port."""
    _, reg = fresh
    reg.counter("hvd_tpu_probe_total", "probe").labels(op="x").inc(3)
    reg.histogram("hvd_tpu_probe_seconds").observe(0.25)
    port = export.start_http_exporter(0, host="127.0.0.1")
    try:
        assert port and export.start_http_exporter(0) == port
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10) as r:
            families = _parse_prometheus(r.read().decode())
        assert {"hvd_tpu_probe_total", "hvd_tpu_probe_seconds"} <= set(
            families)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics.json",
                                    timeout=10) as r:
            doc = json.loads(r.read().decode())
        assert doc["metrics"]["hvd_tpu_probe_total"][0]["value"] == 3.0
        assert "ts_unix" in doc
    finally:
        export.stop_http_exporter()


# --- aggregation and stragglers ------------------------------------------------

@pytest.mark.parametrize("series,factor", [
    ([1.0, 1.05, 0.97, 3.2, 1.01, 0.99, 1.02, 1.0], 2.0),
    ([1.0, 1.02, 0.98, 1.01, 0.99, 1.0, 1.03, 0.97], 2.0),
    ([1.0, 1.0, 2.0], 2.0),
    ([0.0, 0.0], 2.0),
    ([5.0], 2.0),
    ([1.0, 1.0, 1.0, 3.0], 2.5),
    ([0.3, None, 0.5, 0.9], 1.5),
])
def test_pure_functions_match_the_reference(series, factor):
    """``summarize`` and ``detect_stragglers`` are pure: equal outputs on
    the same per-rank series (``tests/test_obs.py``'s cases: exactly the
    slow rank, a uniform world, the exact threshold, idle and single-rank
    worlds)."""
    assert aggregate.summarize(series) == jagg.summarize(series)
    clean = [v for v in series if v is not None]
    assert (aggregate.detect_stragglers(clean, factor)
            == jagg.detect_stragglers(clean, factor))


def test_check_publishes_gauges_and_warns_once(fresh):
    trace = [1.0, 1.0, 1.0, 4.0]
    assert aggregate.check_stragglers(trace, factor=2.0, my_rank=3) == [3]
    snap = fresh[1].snapshot()
    assert _value(snap, "hvd_tpu_straggler_suspect") == 1.0
    assert _value(snap, "hvd_tpu_step_time_skew") == 4.0
    aggregate.check_stragglers(trace, factor=2.0, my_rank=0)
    assert _value(fresh[1].snapshot(), "hvd_tpu_straggler_suspect") == 0.0


def test_cross_rank_summary_on_two_ranks(world):
    """The collective over a 2-rank gloo world: every rank returns the
    same dict, each row ``summarize`` over the gathered per-rank values;
    the step-time row flags rank 1 (means 1.0 and 3.0: 3.0 exceeds 1.2 x
    the median 2.0), and each rank publishes the gauges for its own
    index."""
    step_times = [[1.0, 1.0, 1.0], [3.0, 3.0, 3.0]]
    out = world.run("obs_cross_rank", step_times=step_times,
                    gauges=[2.0, 5.0], factor=1.2)
    assert out[0]["summary"] == out[1]["summary"]
    summary = out[0]["summary"]
    assert summary["my_gauge"] == {**jagg.summarize([2.0, 5.0]),
                                   "per_rank": [2.0, 5.0]}
    row = dict(summary["step_time_s"])
    assert row.pop("stragglers") == jagg.detect_stragglers([1.0, 3.0], 1.2)
    assert row == {**jagg.summarize([1.0, 3.0]), "per_rank": [1.0, 3.0]}
    assert [o["suspect"] for o in out] == [0.0, 1.0]
    assert [o["skew"] for o in out] == [0.5, 1.5]


# --- the hooks ------------------------------------------------------------------

HOOKS = [
    ("record_microbatch_plan", (4,), {"overlap": True}),
    ("on_fusion_plan", ("spmd",), dict(bytes_on_wire=1000, buckets=3,
                                       compression_ratio=0.25,
                                       est_cost_us=12.5, est_hidden_us=5.0)),
    ("on_collective_dispatch", ("allreduce", 4096), {}),
    ("on_collective_dispatch", ("broadcast", 0), {}),
    ("on_topo_plan", ({"hierarchical": 2, "flat": 1},),
     dict(tier_bytes={"ici": 100, "dcn": 50},
          est_cost_us={"ici": 1.5, "dcn": 3.0}, kernels={"spmd": 3},
          hbm_materializations=2)),
    ("on_topo_estimator", ("dcn", 100.0, 10.0), {}),
    ("set_plan_axes", ({"data": 2, "fsdp": 2},), {}),
    ("on_plan_relayout", (), {}),
    ("set_mfu", (41.5,), {}),
    ("set_hidden_comm_estimate", (100.0, 25.0), {}),
    ("on_autotune_window", (123.45678, {"fusion_threshold": 1 << 20}), {}),
    ("on_autotune_window", (5.0, None), {}),
    ("on_autotune_apply", ({"fusion_threshold": 1 << 22, "mode": "x"},
                           True), {}),
    ("on_retry", ("rpc connect",), {}),
    ("on_fault", ("collective",), {}),
    ("on_elastic_reset", ("rollback",), {}),
    ("on_blacklist", ("probation",), {}),
    ("on_membership_loss", (3,), {}),
    ("on_stall", ("warn",), {}),
    ("on_ckpt_save", (1.5, 100, 1), {}),
    ("on_ckpt_write", (2.0, 50), {}),
    ("on_ckpt_restore", (10,), {}),
    ("on_ckpt_journal", (7,), {}),
    ("on_ckpt_coalesced", (), {}),
    ("on_ckpt_inflight", (2,), {}),
    ("on_kv_blocks_in_use", (5,), {}),
    ("on_kv_evictions", (2,), {}),
    ("on_kv_prefix_hit", (), {}),
    ("on_kv_cow_copy", (), {}),
    ("on_spec_accept_ratio", (1.5,), {}),
    ("on_fleet_migration", (100, True, 3.0), {}),
    ("on_fleet_migration", (100, False, 3.0), {}),
    ("on_fleet_directory_hit", (), {}),
    ("on_fleet_scale_event", ("out",), {}),
    ("on_fleet_role_occupancy", ("decode", 0.5, 3), {}),
    ("on_swap", ("ok", 5.0, 10), {}),
    ("on_weights_version", (7,), {}),
    ("on_qos_shed", ("batch",), {}),
    ("on_qos_preempt", (), {}),
    ("on_qos_budget_reject", ("t1",), {}),
    ("on_qos_brownout_level", (2,), {}),
    ("on_sim_run", (10, 5, 0), {}),
    ("on_collect_round", (3, 4, 1.5), {}),
    ("on_slo_burn", ("ttft", 2.0), {}),
    ("on_alert", ("x", "page"), {}),
]


@pytest.mark.parametrize("name,args,kwargs", HOOKS,
                         ids=[f"{h[0]}-{i}" for i, h in enumerate(HOOKS)])
def test_hook_matches_the_reference(fresh, name, args, kwargs):
    """Each hook of the catalog, called twice with the same arguments in
    both packages, leaves equal snapshots, Prometheus texts and decision
    logs."""
    ref, port = fresh
    for _ in range(2):
        getattr(jinstr, name)(*args, **kwargs)
        getattr(instrument, name)(*args, **kwargs)
    assert port.snapshot() == ref.snapshot()
    assert port.snapshot()
    assert export.render_prometheus(port) == jexport.render_prometheus(ref)
    assert instrument.autotune_log() == jinstr.autotune_log()


def test_hooks_noop_when_disabled(fresh, monkeypatch):
    monkeypatch.setattr(metrics, "_enabled", False)
    for name, args, kwargs in HOOKS:
        getattr(instrument, name)(*args, **kwargs)
    assert fresh[1].snapshot() == {}
    fn = lambda model, batch: 0.0  # noqa: E731
    assert instrument.wrap_step(fn) is fn


def test_autotune_decision_log_bounded(fresh):
    for i in range(100):
        instrument.on_autotune_window(float(i), None)
    log = instrument.autotune_log()
    assert len(log) <= 64
    assert log[-1]["samples_per_s"] == 99.0


def test_wrap_step_records_steps_tokens(fresh):
    """The port's step signature ``step(model, batch, *rest)``: the batch
    is the second argument and its first tensor gives rows and tokens."""
    calls = []

    def fn(model, batch, extra):
        calls.append(extra)
        return 0.0

    wrapped = instrument.wrap_step(fn, kind="train")
    assert wrapped is not fn and wrapped._hvd_tpu_instrumented
    assert wrapped.__wrapped__ is fn
    for _ in range(3):
        wrapped(None, ({"ids": torch.ones(4, 16)}, torch.ones(4)), "x")
    snap = fresh[1].snapshot()
    assert calls == ["x"] * 3
    assert _value(snap, "hvd_tpu_steps_total", kind="train") == 3
    assert _value(snap, "hvd_tpu_samples_total") == 12
    assert _value(snap, "hvd_tpu_tokens_total") == 3 * 64
    assert _value(snap, "hvd_tpu_step_time_seconds", kind="train") == 3
    assert _value(snap, "hvd_tpu_tokens_per_s") > 0


def test_plan_records_fire_once_per_build(fresh):
    """Inside a wrapped step a plan record counts on the first call and on
    the first call of each new batch shape (where jit retraces), and is
    replayed on the others; outside any step every call counts."""
    def fn(model, batch):
        instrument.on_fusion_plan("spmd", bytes_on_wire=10, buckets=1)
        return instrument.plans_open()

    wrapped = instrument.wrap_step(fn)
    opened = [wrapped(None, torch.ones(rows, 2)) for rows in (4, 4, 4, 2, 2)]
    assert opened == [True, False, False, True, False]
    assert instrument.plans_open()
    instrument.wrap_step(fn)(None, torch.ones(4, 2))   # a rebuild
    instrument.on_fusion_plan("spmd", bytes_on_wire=10, buckets=1)
    snap = fresh[1].snapshot()
    assert _value(snap, "hvd_tpu_fusion_traces_total", tier="spmd") == 4
    assert _value(snap, "hvd_tpu_wire_bytes_total", tier="spmd") == 40


# --- the knobs ------------------------------------------------------------------

OBS_FIELDS = ("metrics", "metrics_port", "metrics_window", "straggler_factor",
              "trace", "trace_ring", "flight", "flight_dir", "flight_ring")


@pytest.mark.parametrize("env", [
    {},
    {"HVD_TPU_METRICS": "0", "HVD_TPU_METRICS_PORT": "9100",
     "HVD_TPU_METRICS_WINDOW": "64", "HVD_TPU_STRAGGLER_FACTOR": "3.5",
     "HVD_TPU_TRACE": "off", "HVD_TPU_TRACE_RING": "16",
     "HVD_TPU_FLIGHT": "no", "HVD_TPU_FLIGHT_DIR": "/tmp/fl",
     "HVD_TPU_FLIGHT_RING": "8"},
    {"HOROVOD_METRICS": "yes", "HOROVOD_METRICS_PORT": "9200",
     "HVD_TPU_METRICS_PORT": "1", "HOROVOD_TRACE_RING": "4"},
])
def test_knobs_parse_as_the_reference(monkeypatch, env):
    """The same environment parses to equal values in both packages
    (``HOROVOD_`` before ``HVD_TPU_``)."""
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    port, ref = Config.from_env(), JaxConfig.from_env()
    assert {f: getattr(port, f) for f in OBS_FIELDS} == \
        {f: getattr(ref, f) for f in OBS_FIELDS}
    if env:
        assert port.metrics_port in (9100, 9200)


@pytest.mark.parametrize("key,value,err", [
    ("HVD_TPU_STRAGGLER_FACTOR", "0.8", "STRAGGLER_FACTOR"),
    ("HVD_TPU_METRICS_WINDOW", "0", "METRICS_WINDOW"),
    ("HVD_TPU_TRACE_RING", "0", "TRACE_RING"),
])
def test_bad_knobs_fail_at_init(monkeypatch, key, value, err):
    monkeypatch.setenv(key, value)
    for config in (Config, JaxConfig):
        with pytest.raises(ValueError, match=err):
            config.from_env()


def test_init_configures_gates_and_serves_the_port(monkeypatch):
    """``init`` pins the three gates from the config and serves
    ``/metrics`` on ``HVD_TPU_METRICS_PORT`` + rank; ``shutdown`` stops
    it; the registry keeps its counts across a re-init."""
    from horovod_tpu_torch.obs import flight, trace

    from horovod_tpu_torch.basics import _free_port

    port = _free_port()
    monkeypatch.setenv("HVD_TPU_METRICS_PORT", str(port))
    monkeypatch.setenv("HVD_TPU_TRACE_RING", "64")
    monkeypatch.setenv("HVD_TPU_FLIGHT", "0")
    metrics.registry().counter("hvd_tpu_reinit_probe_total").inc()
    try:
        hvd.init(device="cpu")
        assert hvd.basics.metrics_port() == port
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10) as r:
            assert "hvd_tpu_reinit_probe_total" in _parse_prometheus(
                r.read().decode())
        assert trace._ring.maxlen == 64 and not flight.enabled()
        hvd.shutdown()
        assert export._server is None
        monkeypatch.delenv("HVD_TPU_METRICS_PORT")
        hvd.init(device="cpu")
        assert hvd.basics.metrics_port() is None
        assert _value(metrics.registry().snapshot(),
                      "hvd_tpu_reinit_probe_total") >= 1
    finally:
        hvd.shutdown()
        monkeypatch.undo()
        trace.configure(enabled=True, ring=2048)
        flight.configure(enabled=True)


# --- the slice end to end ------------------------------------------------------

def _jax_gpt():
    """The reference's narrow GPT, its params as numpy and 4 x 16 tokens
    (with the next-token column)."""
    model = JaxGPT(JaxGPTConfig(**GPT_CFG, attention="full",
                                dtype=jnp.float32))
    tokens = np.random.RandomState(7).randint(
        0, GPT_CFG["vocab_size"], (4, 17)).astype(np.int32)
    params = model.init(jax.random.PRNGKey(3),
                        jnp.asarray(tokens[:1, :-1]))["params"]
    return model, jax.tree.map(np.asarray, params), tokens


def _drop_families(text: str) -> str:
    return "\n".join(line for line in text.splitlines()
                     if not any(name in line for name in DROPPED))


@pytest.mark.parametrize("microbatches", [None, 2])
def test_gpt_slice_counters_match_the_reference(fresh, microbatches):
    """Three AdamW steps of a 2-layer narrow GPT through each package's
    ``make_train_step`` (the port on a world of one, the reference on one
    device), from the same weights, then one step of a second build (the
    autotuner's rebuild): equal counters and plan records, one plan
    record per build, and byte-identical Prometheus texts without the
    time-valued families and the session plan's axes; losses within
    1e-5."""
    from horovod_tpu_torch.models import GPT, GPTConfig, load_jax_params
    from horovod_tpu_torch.models import lm_loss_fn

    ref_reg, port_reg = fresh
    jmodel, params, tokens = _jax_gpt()
    batch = (tokens[:, :-1], tokens[:, 1:])
    tx = optax.adamw(3e-4)
    mesh = Mesh(np.array(jax.devices()[:1]), ("hvd",))

    def jax_build():
        return jax_make_train_step(jax_lm_loss_fn(jmodel), tx, mesh=mesh,
                                   donate=False, microbatches=microbatches)

    # Inputs already placed as the step's outputs are, so that jit traces
    # once for the 3 steps (a new input sharding would retrace).
    replicated = NamedSharding(mesh, PartitionSpec())
    jp = jax.device_put(params, replicated)
    js = jax.device_put(tx.init(jp), replicated)
    ref_losses = []
    step = jax_build()
    for _ in range(3):
        jp, js, loss = step(jp, js, batch)
        ref_losses.append(float(loss))
    ref_snap = ref_reg.snapshot()
    jax_build()(jp, js, batch)

    hvd.init(device="cpu")
    try:
        model = GPT(GPTConfig(**GPT_CFG, attention="full",
                              dtype=torch.float32), device="cpu")
        load_jax_params(model, params)
        opt = torch.optim.AdamW(model.parameters(), lr=3e-4,
                                weight_decay=1e-4)
        tbatch = tuple(torch.from_numpy(b).long() for b in batch)

        def build():
            return hvd.make_train_step(lm_loss_fn(model), opt,
                                       microbatches=microbatches)

        step = build()
        losses = [float(step(model, tbatch)) for _ in range(3)]
        port_snap = port_reg.snapshot()
        build()(model, tbatch)
    finally:
        hvd.shutdown()
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)

    for snap, want in ((port_snap, ref_snap),
                       (port_reg.snapshot(), ref_reg.snapshot())):
        for name, labels in (("hvd_tpu_steps_total", {"kind": "train"}),
                             ("hvd_tpu_step_time_seconds",
                              {"kind": "train"}),
                             ("hvd_tpu_samples_total", {}),
                             ("hvd_tpu_tokens_total", {}),
                             ("hvd_tpu_fusion_traces_total",
                              {"tier": "spmd"}),
                             ("hvd_tpu_wire_bytes_total", {"tier": "spmd"}),
                             ("hvd_tpu_wire_bytes_per_step",
                              {"tier": "spmd"}),
                             ("hvd_tpu_fusion_buckets", {"tier": "spmd"}),
                             ("hvd_tpu_microbatches", {}),
                             ("hvd_tpu_overlap_reduce", {})):
            assert _value(snap, name, **labels) == _value(want, name,
                                                          **labels), name
    assert _value(port_snap, "hvd_tpu_steps_total", kind="train") == 3
    assert _value(port_snap, "hvd_tpu_tokens_total") == 3 * 4 * 16
    assert _value(port_snap, "hvd_tpu_fusion_traces_total", tier="spmd") == 1
    assert _value(port_reg.snapshot(), "hvd_tpu_fusion_traces_total",
                  tier="spmd") == 2
    assert _value(port_snap, "hvd_tpu_microbatches") == (microbatches or 0)
    assert _drop_families(export.render_prometheus(port_reg)) == \
        _drop_families(jexport.render_prometheus(ref_reg))


def test_overlap_wire_plan_records_at_two_ranks(world, fresh):
    """``microbatches=2`` on the overlap wire over two ranks: the port's
    plan records (``overlap`` tier bytes and buckets, the microbatch
    gauges) equal the reference's on two devices, once for 3 steps and
    once more after a rebuild."""
    from test_torch_port_microbatch import _data, _jax_loss

    x, y = _data()
    out = world.run("obs_plan_records", x=x, y=y, steps=3, microbatches=2)
    mesh = Mesh(np.array(jax.devices()[:N]), ("hvd",))
    params = {"w": jnp.zeros((5,), jnp.float32),
              "b": jnp.zeros((), jnp.float32)}
    tx = optax.sgd(0.1)

    def build():
        return jax_make_train_step(_jax_loss, tx, mesh=mesh, donate=False,
                                   microbatches=2, overlap=True)

    replicated = NamedSharding(mesh, PartitionSpec())
    p = jax.device_put(params, replicated)
    step, state = build(), jax.device_put(tx.init(p), replicated)
    for _ in range(3):
        p, state, _ = step(p, state, (x, y))
    ref = [fresh[0].snapshot()]
    build()(p, state, (x, y))
    ref.append(fresh[0].snapshot())
    keys = [("hvd_tpu_fusion_traces_total", {"tier": "overlap"}),
            ("hvd_tpu_wire_bytes_total", {"tier": "overlap"}),
            ("hvd_tpu_wire_bytes_per_step", {"tier": "overlap"}),
            ("hvd_tpu_fusion_buckets", {"tier": "overlap"}),
            ("hvd_tpu_compression_ratio", {}),
            ("hvd_tpu_microbatches", {}), ("hvd_tpu_overlap_reduce", {})]
    for r in range(N):
        for got, want, traces in ((out[r]["first"], ref[0], 1),
                                  (out[r]["rebuilt"], ref[1], 2)):
            for name, labels in keys:
                assert _value(got, name, **labels) == \
                    _value(want, name, **labels), name
            assert _value(got, "hvd_tpu_fusion_traces_total",
                          tier="overlap") == traces
            assert _value(got, "hvd_tpu_overlap_reduce") == 1.0
