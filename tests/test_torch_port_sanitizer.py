"""hvdsan on the port: ``horovod_tpu_torch/analysis/sanitizer.py``.

The mirror of ``tests/test_sanitizer.py`` on the port's classes:

* **The racy fixtures** — hvdsan catches cross-thread guarded-field
  accesses the static ``locks.py`` checker provably misses (read sites
  and wrong-object locks), with a correct Eraser lockset witness; a
  correctly guarded fixture passes clean.
* **The resource-lifecycle audit** — a seeded leaked KV block / buffer
  set / elastic slot is reported at audit, and a balanced lifecycle
  passes; the KV leak is also seeded through the real serving engine.
* **Plumbing** — ``install`` over the real package and an exact
  ``uninstall``, the violations metric, the exclusive-state exemption,
  and ``init``/``shutdown`` from several threads at once.

Every fixture (``tests/torch_port_sanitize.py``) uninstalls and resets
the forced mode on teardown.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from horovod_tpu_torch.analysis import sanitizer
from horovod_tpu_torch.analysis.core import LintConfig, run_checks
from horovod_tpu_torch.analysis.locks import LockChecker

from torch_port_sanitize import leak_audit, san, san_soft  # noqa: F401

pytestmark = [pytest.mark.analysis, pytest.mark.sanitize]


def _box_class():
    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            self._items = []

        def guarded_append(self, x):
            with self._lock:
                self._items.append(x)

        def unguarded_read(self):
            return len(self._items)

        def guarded_read(self):
            with self._lock:
                return len(self._items)

    sanitizer.instrument_class(Box, {"_items": "_lock"}, owner="fixture.Box")
    return Box


# The same fixture as source, for the static-miss proof: locks.py sees
# only WRITE sites, so the unguarded READ below is invisible to it.
BOX_SOURCE = """
import threading

class Box:
    def __init__(self):
        self._lock = threading.Lock()
        self._items = []   # guarded-by: _lock

    def guarded_append(self, x):
        with self._lock:
            self._items.append(x)

    def unguarded_read(self):
        return len(self._items)
"""


# --- the acceptance fixture: static miss, runtime catch ---------------------

def test_static_checker_provably_misses_read_site(tmp_path):
    pkg = tmp_path / "horovod_tpu_torch"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "m.py").write_text(BOX_SOURCE)
    fs = run_checks(LintConfig(root=tmp_path), checker_classes=[LockChecker])
    assert fs == [], "\n".join(f.format() for f in fs)


def test_hvdsan_catches_unguarded_cross_thread_read(san):
    Box = _box_class()
    box = Box()
    stop = threading.Event()

    def writer():
        while not stop.is_set():
            box.guarded_append(1)

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    try:
        for _ in range(1000):
            if len(sanitizer.violations()) or box.guarded_read() > 0:
                break
        with pytest.raises(sanitizer.SanitizerError, match="_items"):
            for _ in range(1000):
                box.unguarded_read()
    finally:
        stop.set()
        t.join(timeout=5.0)
    assert not t.is_alive()
    vs = [v for v in sanitizer.violations() if v["kind"] == "lock-assert"]
    assert vs, "violation must be recorded, not just raised"
    witness = vs[0]["witness"]
    assert len(witness["threads"]) >= 2
    assert witness["lockset"] == []


def test_hvdsan_catches_two_threads_mutating_without_lock(san_soft):
    Box = _box_class()
    box = Box()
    box._items.append(0)          # main thread: exclusive state

    def racy_writer():
        box._items = box._items + [1]   # second thread, no lock

    t = threading.Thread(target=racy_writer)
    t.start()
    t.join(timeout=5.0)
    assert not t.is_alive()
    vs = [v for v in sanitizer.violations() if v["kind"] == "lock-assert"]
    assert vs and "fixture.Box._items" == vs[0]["where"]
    assert vs[0]["witness"]["lockset"] == []


def test_correctly_guarded_fixture_is_clean(san):
    Box = _box_class()
    box = Box()

    def writer():
        for i in range(200):
            box.guarded_append(i)

    threads = [threading.Thread(target=writer) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10.0)
    assert not any(t.is_alive() for t in threads)
    for _ in range(100):
        box.guarded_read()
    assert sanitizer.violations() == []


def test_lockset_pass_catches_wrong_object_lock(san_soft):
    class Holder:
        def __init__(self):
            self._lock = threading.Lock()

    class Shared:
        def __init__(self):
            self.state = 0

    sanitizer.instrument_class(Holder, {"_ignore": "_lock"},
                               owner="fixture.Holder")
    sanitizer.instrument_class(Shared, {"state": "Peer._lock"},
                               owner="fixture.Shared")
    h1, h2, obj = Holder(), Holder(), Shared()

    def t1():
        with h1._lock:
            obj.state += 1

    def t2():
        with h2._lock:
            obj.state += 1

    obj.state = 0                  # main: exclusive
    a = threading.Thread(target=t1)
    b = threading.Thread(target=t2)
    a.start()
    a.join(timeout=5.0)
    b.start()
    b.join(timeout=5.0)
    assert not a.is_alive() and not b.is_alive()
    kinds = {v["kind"] for v in sanitizer.violations()}
    assert "lockset" in kinds, sanitizer.violations()
    ls = [v for v in sanitizer.violations() if v["kind"] == "lockset"][0]
    assert ls["witness"]["lockset"] == []
    assert len(ls["witness"]["threads"]) >= 2


def test_exclusive_state_never_asserts(san):
    Box = _box_class()
    box = Box()
    for i in range(50):
        box._items.append(i)      # no lock, but single-threaded
        box.unguarded_read()
    assert sanitizer.violations() == []


# --- resource-lifecycle audit ------------------------------------------------

def test_pool_leak_audit_catches_seeded_leak(san):
    from horovod_tpu_torch.serve.kv.pool import BlockPool

    table = np.zeros((2, 4), np.int32)
    pool = BlockPool(6, 2, table, copy_block=lambda s, d: None)
    pool.begin_request(0, [1, 2, 3, 4, 5])
    pool.ensure_writable(0, 0, 5)      # prefill allocates the chain
    assert pool.blocks_in_use() > 0
    leaks = sanitizer.audit_check(record=False)
    assert leaks and "kv_pool" in leaks[0]
    pool.release(0)
    assert sanitizer.audit_check(record=False) == []


def test_buffer_pool_leak_audit(san):
    from horovod_tpu_torch.ckpt.snapshot import BufferPool

    pool = BufferPool(2)
    bufs = pool.acquire()
    assert bufs is not None
    leaks = sanitizer.audit_check(record=False)
    assert leaks and "buffer_pool" in leaks[0]
    pool.release(bufs)
    assert sanitizer.audit_check(record=False) == []


def test_elastic_slot_leak_audit(san):
    from horovod_tpu_torch.elastic.driver import ElasticDriver

    class FakeDiscovery:
        def find_available_hosts_and_slots(self):
            return {"hostA": 2}

    driver = ElasticDriver(FakeDiscovery(), poll_interval_s=3600.0)
    driver.poll_once()
    host = driver.reserve_slot()
    assert host == "hostA"
    leaks = sanitizer.audit_check(record=False)
    assert leaks and "elastic_slots" in leaks[0]
    driver.release_slot(host)
    assert sanitizer.audit_check(record=False) == []


def test_audit_baseline_delta_charges_only_new_leaks(san):
    from horovod_tpu_torch.ckpt.snapshot import BufferPool

    pool = BufferPool(3)
    inherited = pool.acquire()            # pre-existing state
    assert inherited is not None
    baseline = sanitizer.audit_baseline()
    assert sanitizer.audit_check(record=False, baseline=baseline) == []
    fresh = pool.acquire()                # leaked during "this test"
    leaks = sanitizer.audit_check(record=False, baseline=baseline)
    assert leaks and "baseline 1" in leaks[0]
    pool.release(fresh)
    assert sanitizer.audit_check(record=False, baseline=baseline) == []
    pool.release(inherited)


def test_audit_records_resource_leak_violation(san_soft):
    from horovod_tpu_torch.ckpt.snapshot import BufferPool

    pool = BufferPool(1)
    pool.acquire()
    leaks = sanitizer.audit_check()           # record=True path
    assert leaks
    kinds = {v["kind"] for v in sanitizer.violations()}
    assert "resource-leak" in kinds


def _tiny_engine():
    from horovod_tpu_torch.models import GPT, GPTConfig
    from horovod_tpu_torch.serve import InferenceEngine

    torch.manual_seed(0)
    model = GPT(GPTConfig(vocab_size=97, n_layer=2, n_head=2, d_model=32,
                          d_ff=64, max_seq_len=32, dtype=torch.float32),
                device="cpu")
    return InferenceEngine(model, max_slots=2, prefill_buckets=(8, 16),
                           max_seq_len=32, kv_cache="paged", kv_block=4)


def test_engine_kv_leak_is_caught_and_release_clears_it(san, leak_audit):
    """The KV leak seeded through the real engine: a request started and
    never released holds its blocks at audit; releasing it balances the
    pool, so the test's own leak audit passes."""
    from horovod_tpu_torch.serve import SamplingParams

    engine = _tiny_engine()
    first = engine.start(0, [1, 2, 3, 4, 5, 6, 7], SamplingParams(
        max_new_tokens=4))
    assert 0 <= first < 97
    engine.step()
    leaks = sanitizer.audit_check(record=False)
    assert leaks and "kv_pool" in leaks[0], leaks
    engine.release(0)
    assert sanitizer.audit_check(record=False) == []


# --- plumbing ----------------------------------------------------------------

def test_violations_metric_recorded(san_soft, monkeypatch):
    from horovod_tpu_torch.obs import metrics as obs_metrics

    monkeypatch.setattr(obs_metrics, "_default",
                        obs_metrics.MetricsRegistry())
    monkeypatch.setattr(obs_metrics, "_enabled", True)
    Box = _box_class()
    box = Box()
    box._items.append(0)

    def racy():
        box._items = []

    t = threading.Thread(target=racy)
    t.start()
    t.join(timeout=5.0)
    assert sanitizer.violations()
    snap = obs_metrics.registry().snapshot()
    series = {tuple(sorted(s["labels"].items())): s["value"]
              for s in snap["hvd_tpu_sanitizer_violations_total"]}
    assert series[(("kind", "lock-assert"),)] >= 1


def test_guard_inventory_covers_annotated_modules():
    inv = sanitizer.guard_inventory()
    assert inv["modules"] >= 25, inv["modules"]
    assert inv["attributes"] >= 100
    for mod in ("horovod_tpu_torch.serve.kv.pool",
                "horovod_tpu_torch.ckpt.snapshot",
                "horovod_tpu_torch.elastic.driver"):
        assert mod in inv["guards"], mod


def _descriptors_on_port_classes():
    import importlib

    found = []
    for mod, classes in sanitizer.collect_class_guards().items():
        module = importlib.import_module(mod)
        for name in classes:
            cls = getattr(module, name)
            for attr, value in vars(cls).items():
                if isinstance(value, (sanitizer._GuardedAttr,
                                      sanitizer._LockAttr)):
                    found.append(f"{mod}.{name}.{attr}")
    return found


def test_install_instruments_real_package_and_uninstall_restores(san):
    from horovod_tpu_torch.serve.fleet.directory import PrefixDirectory

    before = dict(vars(PrefixDirectory))
    stats = sanitizer.install()
    try:
        assert stats["installed"] and stats["modules"] >= 25, stats
        assert stats["skipped"] == [], stats["skipped"]
        assert stats["attributes"] >= 100
        assert sanitizer.install()["attributes"] == 0   # idempotent
        assert isinstance(vars(PrefixDirectory)["_lock"],
                          sanitizer._LockAttr)
        d = PrefixDirectory(block_tokens=2, max_entries=8)
        d.record((1, 2), "r1")

        def reader():
            d.lookup((1, 2))

        t = threading.Thread(target=reader)
        t.start()
        t.join(timeout=5.0)
        assert not t.is_alive()
        assert [v for v in sanitizer.violations()
                if "directory" in v["where"].lower()] == []
    finally:
        sanitizer.uninstall()
    assert not sanitizer.installed()
    assert dict(vars(PrefixDirectory)) == before
    assert _descriptors_on_port_classes() == []
    assert d.lookup((1, 2)) == ["r1"]    # an instrumented instance lives on


def test_init_and_shutdown_from_threads_at_once():
    """``basics.init``/``shutdown`` take the lifecycle lock: four threads
    racing ``init`` build one session and one world, four racing
    ``shutdown`` tear it down once, and none raises."""
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import basics

    hvd.shutdown()
    had_group = dist.is_initialized()   # adopted, then left as found
    errors, sessions = [], []
    barrier = threading.Barrier(4)

    def run(fn):
        try:
            barrier.wait(timeout=10.0)
            fn()
            sessions.append(basics._session)
        except BaseException as e:   # reported below
            errors.append(repr(e))

    for fn in (lambda: hvd.init(device="cpu"), hvd.shutdown):
        sessions.clear()
        threads = [threading.Thread(target=run, args=(fn,))
                   for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in threads)
        assert errors == []
        if fn is hvd.shutdown:
            assert sessions == [None] * 4
        else:
            assert len({id(s) for s in sessions}) == 1 and sessions[0]
    assert not hvd.is_initialized()
    assert dist.is_initialized() == had_group


def test_no_descriptor_left_on_port_classes():
    """Runs last in this file: whatever the tests above installed, the
    port's classes carry no sanitizer descriptor for the next file."""
    assert not sanitizer.installed()
    assert _descriptors_on_port_classes() == []
    assert sanitizer.mode() in ("off", "raise", "soft")
