"""The port's weight hot-swap (``horovod_tpu_torch/serve/swap.py``, the
server's ``SwapRequest`` / ``RollbackRequest``, the router's
``swap_replica`` / ``rollback_replica``, the controller's ``roll_swap`` /
``rollback``) against the reference's.

``tests/test_swap.py``'s ``TestStoreWatchAndDiff``,
``TestSubscriberSwap``, ``TestFlipBarrier``, ``TestWireAndRouter``,
``TestRollingFleetSwap`` and ``TestChaosDrill`` on the port.  The
reference fixture's three independent parameter sets (``PRNGKey(100 +
v)``) are converted by ``load_jax_params``; a step holds the port
model's named parameters, written through the port's checkpoint store.
The token oracle for a version is the reference's ``InferenceEngine``
serving that version's parameters (one JAX engine a process, its
weights flipped by its own ``stage_params`` / ``commit_staged``), so
after each swap the port's greedy tokens equal the JAX engine's.
"""

import functools
import os
import random
import threading
import time

import jax
import jax.numpy as jnp
import pytest
import torch

from horovod_tpu import faults as jfaults
from horovod_tpu.serve import InferenceEngine as JaxEngine
from horovod_tpu.serve import SamplingParams as JaxSampling

from horovod_tpu_torch import faults
from horovod_tpu_torch.ckpt import (AsyncCheckpointer, ShardStore,
                                    diff_manifest, take_snapshot)
from horovod_tpu_torch.serve import (
    ContinuousBatcher, FleetController, InferenceEngine, InferenceServer,
    ReplicaKilledError, ReplicaLauncher, ReplicaSpec, Router,
    SamplingParams, SwapAbandonedError, SwapRejectedError,
    WeightSubscriber,
)
from horovod_tpu_torch.serve.swap import leaf_digests
from horovod_tpu_torch.utils.retry import RetryPolicy

from torch_port_serve import KEY, jax_pair, torch_model

pytestmark = pytest.mark.serving

PROMPT = [3, 1, 4, 1, 5, 9, 2, 6]


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


@functools.lru_cache(maxsize=None)
def _jax_versions():
    """(flax GPT, {v: params}) for the three independent inits."""
    jm, _ = jax_pair()
    return jm, {v: jm.init(jax.random.PRNGKey(100 + v),
                           jnp.zeros((1, 8), jnp.int32))["params"]
                for v in (1, 2, 3)}


def _tree(v):
    """Version ``v`` as the port model's ``{name: tensor}``."""
    model = torch_model(_jax_versions()[1][v])
    return {n: p.detach().clone() for n, p in model.named_parameters()}


@functools.lru_cache(maxsize=None)
def _jax_engine():
    jm, versions = _jax_versions()
    return JaxEngine(jm, versions[1], max_slots=1, prefill_buckets=(8, 16),
                     max_seq_len=32, kv_block=4)


@functools.lru_cache(maxsize=None)
def _ref_tokens(v, prompt, n):
    """The reference engine's greedy tokens on version ``v``."""
    engine = _jax_engine()
    engine.stage_params(_jax_versions()[1][v], v)
    engine.commit_staged()
    toks = [engine.start(0, list(prompt), JaxSampling(max_new_tokens=n))]
    while len(toks) < n:
        toks.extend(engine.step()[0])
    engine.release(0)
    return toks[:n]


def _ref(v, prompt=PROMPT, n=5):
    return _ref_tokens(v, tuple(prompt), n)


def _write_versions(directory, step_versions):
    store = ShardStore(str(directory))
    for step, v in sorted(step_versions.items()):
        store.write_step(take_snapshot(_tree(v), step=step), world=1,
                         scheme="dp")
    return store


def _engine(v=1, version=1, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("prefill_buckets", (8, 16))
    kw.setdefault("max_seq_len", 32)
    kw.setdefault("kv_block", 4)
    return InferenceEngine(torch_model(_jax_versions()[1][v]),
                           weights_version=version, **kw)


def _replica(tmp_path, name="rep", v=1, version=1, start=True):
    batcher = ContinuousBatcher(_engine(v, version), max_queue=32,
                                default_deadline_s=60)
    return InferenceServer(batcher, key=KEY, name=name, host="127.0.0.1",
                           start_batcher=start, swap_store=str(tmp_path),
                           subscribe=False)


def _running(engine):
    batcher = ContinuousBatcher(engine, max_queue=8, default_deadline_s=60)
    batcher.start()
    return batcher


def _serve(batcher, prompt=PROMPT, n=5):
    req = batcher.submit(prompt, SamplingParams(max_new_tokens=n))
    assert req.done.wait(timeout=30)
    assert req.error is None
    return req.tokens


def _same_weights(engine, tree):
    got = engine.params
    return set(got) == set(tree) and all(
        got[n].dtype == tree[n].dtype and torch.equal(got[n], tree[n])
        for n in tree)


# --- tests/test_swap.py::TestStoreWatchAndDiff ----------------------------------

class TestStoreWatchAndDiff:
    def test_newest_intact_step_skips_damaged(self, tmp_path):
        store = _write_versions(tmp_path, {1: 1, 2: 2, 3: 3})
        assert store.newest_intact_step() == 3
        with open(os.path.join(store.step_dir(3), "manifest.json"), "w") as f:
            f.write("{ torn json")
        assert store.newest_intact_step() == 2
        assert store.newest_intact_step(min_step=2) is None

    def test_diff_pulls_only_changed_shards_byte_counted(self, tmp_path):
        """Boot weights saved from the engine's parameters diff as
        unchanged: ``leaf_digests`` keys them under the manifest's
        paths."""
        t1 = _tree(1)
        first = sorted(t1)[0]
        t2 = dict(t1, **{first: t1[first] + 1.0})
        store = ShardStore(str(tmp_path))
        store.write_step(take_snapshot(t1, step=1), world=1, scheme="dp")
        store.write_step(take_snapshot(t2, step=2), world=1, scheme="dp")
        have = {path: digest for path, (digest, _)
                in leaf_digests(_engine().params).items()}
        manifest = store.validate_step(2)
        by_file, changed, nbytes = diff_manifest(manifest, have)
        assert list(changed.values()) == [repr(first)]
        assert nbytes == t1[first].numel() * 4
        by1, changed1, nbytes1 = diff_manifest(store.validate_step(1), have)
        assert not by1 and not changed1 and nbytes1 == 0
        _, changed_all, nbytes_all = diff_manifest(manifest, {})
        assert len(changed_all) == len(manifest.entries)
        assert nbytes_all == manifest.nbytes

    def test_bf16_leaf_digests_as_the_store_records_it(self, tmp_path):
        """A bf16 parameter is recorded as its ``V2`` bytes: the engine's
        live leaf and the stored one diff as unchanged, and the pulled
        leaf stages back to the same bf16 bits."""
        tree = {"w": torch.randn(4, 3).to(torch.bfloat16)}
        store = ShardStore(str(tmp_path))
        store.write_step(take_snapshot(tree, step=1), world=1, scheme="dp")
        manifest = store.validate_step(1)
        have = {p: d for p, (d, _) in leaf_digests(tree).items()}
        assert diff_manifest(manifest, have)[2] == 0
        (leaf_id, entry), = manifest.entries.items()
        arr = store.read_leaves(1, {entry["file"]: [leaf_id]},
                                manifest)[leaf_id]
        assert arr.dtype.kind == "V" and arr.dtype.itemsize == 2
        # The engine stages such a leaf from its raw bf16 bits.
        engine = _engine()
        live = engine.params
        name = "lm_head.kernel"
        low = live[name].detach().to(torch.bfloat16)
        staged = {n: p.detach() for n, p in live.items()}
        staged[name] = low.view(torch.int16).numpy().view("V2")
        engine.stage_params(staged, 2)
        assert torch.equal(engine._staged_params[name], low.float())
        engine.discard_staged()


# --- tests/test_swap.py::TestSubscriberSwap -------------------------------------

class TestSubscriberSwap:
    def test_poll_swaps_and_pulls_only_changed_bytes(self, tmp_path):
        _write_versions(tmp_path, {1: 1, 2: 2})
        engine = _engine()
        batcher = _running(engine)
        try:
            sub = WeightSubscriber(batcher, str(tmp_path), deadline_s=60)
            assert sub.version == 1
            assert sub.poll_once() == 2
            assert engine.weights_version == 2
            manifest = sub.store.validate_step(2)
            assert 0 < sub.last_swap["pulled_bytes"] < manifest.nbytes
            assert sub.last_swap["pulled_leaves"] < \
                sub.last_swap["total_leaves"]
            assert sub.poll_once() is None
            assert _serve(batcher) == _ref(2)
            assert _same_weights(engine, _tree(2))
        finally:
            batcher.stop()

    def test_straddling_request_matches_pre_swap_reference(self, tmp_path):
        _write_versions(tmp_path, {1: 1, 2: 2})
        engine = _engine()
        batcher = _running(engine)
        try:
            sub = WeightSubscriber(batcher, str(tmp_path), deadline_s=60)
            req = batcher.submit(PROMPT, SamplingParams(max_new_tokens=8))
            deadline = time.monotonic() + 30
            while req.first_token_at is None:
                assert time.monotonic() < deadline
                time.sleep(0.002)
            assert sub.swap_to(2) == 2
            assert req.done.wait(timeout=30) and req.error is None
            assert req.tokens == _ref(1, n=8)
            assert _serve(batcher, n=8) == _ref(2, n=8)
        finally:
            batcher.stop()

    def test_corrupt_shard_rejected_keeps_old_weights(self, tmp_path):
        _write_versions(tmp_path, {1: 1, 2: 2})
        engine = _engine()
        batcher = _running(engine)
        try:
            sub = WeightSubscriber(batcher, str(tmp_path), retries=2,
                                   deadline_s=60)
            with faults.inject("swap:p=1,mode=corrupt-shard"):
                with pytest.raises(SwapRejectedError,
                                   match="digest verification"):
                    sub.swap_to(2)
                assert len([h for h in faults.history()
                            if h[0] == "swap"]) == 2
            assert engine.weights_version == 1 and sub.version == 1
            assert engine.staged_version() is None
            assert _serve(batcher) == _ref(1)
            with faults.inject("swap:p=1,mode=corrupt-shard"):
                assert sub.poll_once() is None
        finally:
            batcher.stop()

    def test_corrupt_shard_single_fault_retry_recovers(self, tmp_path):
        _write_versions(tmp_path, {1: 1, 2: 2})
        engine = _engine()
        batcher = _running(engine)
        try:
            sub = WeightSubscriber(batcher, str(tmp_path), retries=3,
                                   deadline_s=60)
            with faults.inject("swap:step=0,mode=corrupt-shard"):
                assert sub.swap_to(2) == 2
                assert len([h for h in faults.history()
                            if h[0] == "swap"]) == 1
            assert engine.weights_version == 2
        finally:
            batcher.stop()

    def test_stall_past_deadline_abandons(self, tmp_path):
        _write_versions(tmp_path, {1: 1, 2: 2})
        engine = _engine()
        batcher = _running(engine)
        try:
            sub = WeightSubscriber(batcher, str(tmp_path), deadline_s=0.15)
            with faults.inject("swap:p=1,mode=stall,delay_ms=400"):
                with pytest.raises(SwapAbandonedError):
                    sub.swap_to(2)
            assert engine.weights_version == 1
            assert engine.staged_version() is None
        finally:
            batcher.stop()

    def test_rollback_restores_journaled_step_bit_identically(self,
                                                              tmp_path):
        with AsyncCheckpointer(str(tmp_path), world=1, scheme="dp",
                               async_save=False) as ckpt:
            for step in (1, 2):
                ckpt.save(step, _tree(step))
                ckpt.journal_step(step)
            journaled = [e["step"] for e in ckpt.journal.read()[0]]
        assert journaled == [1, 2]
        engine = _engine()
        batcher = _running(engine)
        try:
            sub = WeightSubscriber(batcher, str(tmp_path), deadline_s=60)
            assert sub.swap_to(2) == 2
            with pytest.raises(SwapRejectedError, match="older"):
                sub.swap_to(1)
            assert sub.swap_to(1, rollback=True) == 1
            assert sub.last_swap["rollback"] is True
            assert _same_weights(engine, _tree(1))
            assert _serve(batcher) == _ref(1)
        finally:
            batcher.stop()

    def test_rollback_pins_forward_watch(self, tmp_path):
        _write_versions(tmp_path, {1: 1, 2: 2})
        engine = _engine()
        batcher = _running(engine)
        try:
            sub = WeightSubscriber(batcher, str(tmp_path), deadline_s=60)
            assert sub.poll_once() == 2
            assert sub.swap_to(1, rollback=True) == 1
            assert sub.poll_once() is None
            assert engine.weights_version == 1
            assert sub.swap_to(2, _from_poll=True) == 1
            assert engine.weights_version == 1
            assert sub.swap_to(2) == 2
            assert sub.poll_once() is None
        finally:
            batcher.stop()

    def test_noop_swap_reports_zero_pull(self, tmp_path):
        _write_versions(tmp_path, {1: 1, 2: 2})
        server = _replica(tmp_path, name="rep-0")
        try:
            router = Router([ReplicaSpec("rep-0",
                                         [("127.0.0.1", server.port)])], KEY)
            first = router.swap_replica("rep-0", 2, timeout=60.0)
            assert first.error is None and first.pulled_bytes > 0
            again = router.swap_replica("rep-0", 2, timeout=60.0)
            assert again.error is None and again.weights_version == 2
            assert again.pulled_bytes == 0
        finally:
            server.shutdown()

    def test_prefix_cache_flushed_on_flip(self, tmp_path):
        _write_versions(tmp_path, {1: 1, 2: 2})
        engine = _engine()
        batcher = _running(engine)
        try:
            _serve(batcher, n=4)
            assert engine.prefix_probe(PROMPT) > 0
            sub = WeightSubscriber(batcher, str(tmp_path), deadline_s=60)
            assert sub.swap_to(2) == 2
            assert engine.prefix_probe(PROMPT) == 0
            assert _serve(batcher, n=4) == _ref(2, n=4)
        finally:
            batcher.stop()


# --- tests/test_swap.py::TestFlipBarrier ----------------------------------------

class TestFlipBarrier:
    def test_flip_waits_for_inflight_and_runs_between_bursts(self):
        engine = _engine()
        batcher = ContinuousBatcher(engine, max_queue=8,
                                    default_deadline_s=60)
        req = batcher.submit(PROMPT, SamplingParams(max_new_tokens=4))
        batcher.step()
        engine.stage_params(_tree(2), 2)
        result = {}

        def flip():
            result["version"] = batcher.flip_at_barrier(
                engine.commit_staged, timeout=30.0)

        t = threading.Thread(target=flip, daemon=True)
        t.start()
        deadline = time.monotonic() + 30
        while not req.done.is_set():
            assert time.monotonic() < deadline
            batcher.step()
            if not req.done.is_set():
                assert engine.weights_version == 1
        while "version" not in result and time.monotonic() < deadline:
            batcher.step()
            time.sleep(0.01)
        t.join(timeout=10)
        assert result["version"] == 2 and engine.weights_version == 2
        assert req.tokens == _ref(1, n=4)

    def test_flip_holds_admission_until_flipped(self):
        engine = _engine()
        batcher = ContinuousBatcher(engine, max_queue=8,
                                    default_deadline_s=60)
        first = batcher.submit(PROMPT, SamplingParams(max_new_tokens=6))
        batcher.step()
        engine.stage_params(_tree(2), 2)
        t = threading.Thread(
            target=lambda: batcher.flip_at_barrier(engine.commit_staged,
                                                   timeout=30.0),
            daemon=True)
        t.start()
        deadline = time.monotonic() + 10
        while not batcher.snapshot()["swap_pending"]:
            assert time.monotonic() < deadline
            time.sleep(0.002)
        second = batcher.submit([2, 7, 1, 8, 2, 8],
                                SamplingParams(max_new_tokens=4))
        while not first.done.is_set():
            batcher.step()
            if not first.done.is_set():
                assert batcher.snapshot()["queue_depth"] == 1
        while not second.done.is_set():
            assert time.monotonic() < deadline + 20
            batcher.step()
            time.sleep(0.002)
        t.join(timeout=10)
        assert first.tokens == _ref(1, n=6)
        assert second.tokens == _ref(2, [2, 7, 1, 8, 2, 8], 4)

    def test_kill_mid_flip_fails_over_not_mixed(self):
        engine = _engine()
        batcher = ContinuousBatcher(engine, max_queue=8,
                                    default_deadline_s=60)
        req = batcher.submit(PROMPT, SamplingParams(max_new_tokens=4))
        engine.stage_params(_tree(2), 2)
        caught = {}

        def flip():
            try:
                batcher.flip_at_barrier(engine.commit_staged, timeout=30.0)
            except ReplicaKilledError as e:
                caught["err"] = e

        t = threading.Thread(target=flip, daemon=True)
        t.start()
        with faults.inject("swap:step=0,mode=kill-mid-flip"):
            with pytest.raises(ReplicaKilledError):
                deadline = time.monotonic() + 30
                while time.monotonic() < deadline:
                    batcher.step()
                    time.sleep(0.005)
        t.join(timeout=10)
        assert "err" in caught and batcher.dead
        assert engine.weights_version == 1
        assert _same_weights(engine, _tree(1))
        assert req.done.is_set() and req.error == "replica_killed"

    def test_withdrawn_flip_never_commits(self):
        engine = _engine()
        batcher = ContinuousBatcher(engine, max_queue=8,
                                    default_deadline_s=60)
        req = batcher.submit(PROMPT, SamplingParams(max_new_tokens=6))
        batcher.step()
        engine.stage_params(_tree(2), 2)
        with pytest.raises(TimeoutError):
            batcher.flip_at_barrier(engine.commit_staged, timeout=0.05)
        while not req.done.is_set():
            batcher.step()
        for _ in range(3):
            batcher.step()
        assert engine.weights_version == 1
        assert engine.staged_version() == 2
        engine.discard_staged()

    def test_die_releases_barrier_waiter(self):
        engine = _engine()
        batcher = ContinuousBatcher(engine, max_queue=8,
                                    default_deadline_s=60)
        engine.stage_params(_tree(2), 2)
        caught = {}

        def flip():
            try:
                batcher.flip_at_barrier(engine.commit_staged, timeout=30.0)
            except ReplicaKilledError as e:
                caught["err"] = str(e)

        t = threading.Thread(target=flip, daemon=True)
        t.start()
        time.sleep(0.05)
        batcher._die("test shutdown")
        t.join(timeout=10)
        assert not t.is_alive() and "replica_killed" in caught["err"]


# --- tests/test_swap.py::TestWireAndRouter --------------------------------------

class TestWireAndRouter:
    def test_swap_and_rollback_frames_over_wire(self, tmp_path):
        _write_versions(tmp_path, {1: 1, 2: 2})
        server = _replica(tmp_path, name="rep-0")
        try:
            router = Router(
                [ReplicaSpec("rep-0", [("127.0.0.1", server.port)])], KEY,
                retry_policy=RetryPolicy(attempts=4, base_delay_s=0.02,
                                         max_delay_s=0.2))
            resp = router.swap_replica("rep-0", 2, timeout=60.0)
            assert resp.error is None and resp.weights_version == 2
            assert resp.pulled_bytes > 0 and resp.swap_ms is not None
            stats = router.replica_stats(timeout=5.0)
            assert stats["rep-0"]["weights_version"] == 2
            assert stats["rep-0"]["stats"]["weights_version"] == 2
            assert stats["rep-0"]["stats"]["swaps_completed"] == 1
            out = router.generate(PROMPT, max_new_tokens=4)
            assert out.error is None and out.weights_version == 2
            assert out.tokens == _ref(2, n=4)
            rb = router.rollback_replica("rep-0", 1, timeout=60.0)
            assert rb.error is None and rb.weights_version == 1
            out = router.generate(PROMPT, max_new_tokens=4,
                                  request_id="after-rollback")
            assert out.tokens == _ref(1, n=4)
        finally:
            server.shutdown()

    def test_swap_without_store_answers_terminal_error(self):
        batcher = ContinuousBatcher(_engine(), max_queue=8,
                                    default_deadline_s=60)
        server = InferenceServer(batcher, key=KEY, name="bare",
                                 host="127.0.0.1")
        try:
            router = Router([ReplicaSpec("bare",
                                         [("127.0.0.1", server.port)])], KEY)
            resp = router.swap_replica("bare", 2, timeout=10.0)
            assert resp.error == "no_swap_store"
            assert resp.weights_version == 1
            assert router.generate(PROMPT, max_new_tokens=3).error is None
        finally:
            server.shutdown()

    def test_swap_to_missing_step_rejected_old_weights_serving(self,
                                                               tmp_path):
        _write_versions(tmp_path, {1: 1})
        server = _replica(tmp_path, name="rep-0")
        try:
            router = Router([ReplicaSpec("rep-0",
                                         [("127.0.0.1", server.port)])], KEY)
            resp = router.swap_replica("rep-0", 7, timeout=30.0)
            assert resp.error is not None and "rejected" in resp.error
            assert resp.weights_version == 1
            assert router.generate(PROMPT, max_new_tokens=3).error is None
        finally:
            server.shutdown()

    def test_directory_hit_requires_version_match(self):
        router = Router([ReplicaSpec("a", [("127.0.0.1", 1)]),
                         ReplicaSpec("b", [("127.0.0.1", 2)])], KEY)
        rep_a = router._find("a")
        key = tuple(range(router._affinity_block))
        router._note_version(rep_a, 1)
        router._note_affinity(key, rep_a, 1)
        with router._lock:
            fully = list(router._replicas)
            assert router._resident_locked(key, fully) is rep_a
        router._note_version(rep_a, 2)
        with router._lock:
            assert router._resident_locked(key, fully) is None
        router._note_affinity(key, rep_a, 2)
        with router._lock:
            assert router._resident_locked(key, fully) is rep_a

    def test_adopt_refuses_mismatched_version_kv(self):
        batcher = ContinuousBatcher(_engine(version=2), max_queue=8,
                                    default_deadline_s=60)
        manifest = {"request_id": "m-1", "prompt": PROMPT, "tokens": [5],
                    "weights_version": 1,
                    "sampling": {"max_new_tokens": 4, "temperature": 0.0,
                                 "top_k": 0, "stop_token": None,
                                 "spec": False}}
        with pytest.raises(ValueError, match="version_mismatch"):
            batcher.adopt(manifest, torch.zeros((2, 2, 4, 2, 16)),
                          torch.zeros((2, 2, 4, 2, 16)))


# --- tests/test_swap.py::TestRollingFleetSwap -----------------------------------

class _NullLauncher(ReplicaLauncher):
    def launch(self, role, host=None):
        raise AssertionError("the swap drill never launches replicas")

    def retire(self, name):
        pass


def _fleet(tmp_path, v=1, n=2):
    servers = [_replica(tmp_path, name=f"rep-{i}", v=v) for i in range(n)]
    router = Router(
        [ReplicaSpec(s.name, [("127.0.0.1", s.port)]) for s in servers],
        KEY, retry_policy=RetryPolicy(attempts=10, base_delay_s=0.02,
                                      max_delay_s=0.3))
    return servers, router, FleetController(router, _NullLauncher(),
                                            min_per_role=1)


class TestRollingFleetSwap:
    def test_roll_swap_bounded_and_converges(self, tmp_path):
        _write_versions(tmp_path, {1: 1, 2: 2})
        servers, router, controller = _fleet(tmp_path)
        try:
            outcomes = controller.roll_swap(2, max_concurrent=1,
                                            timeout=60.0)
            assert [o["replica"] for o in outcomes] == ["rep-0", "rep-1"]
            assert all(o["ok"] and o["weights_version"] == 2
                       for o in outcomes)
            stats = router.replica_stats(timeout=5.0)
            assert all(e["weights_version"] == 2 for e in stats.values())
            assert router.generate(PROMPT,
                                   max_new_tokens=4).tokens == _ref(2, n=4)
            assert controller.events[-1]["action"] == "swap"
        finally:
            for s in servers:
                s.shutdown()

    @pytest.mark.chaos
    def test_partial_fleet_mixed_versions_stay_correct(self, tmp_path):
        _write_versions(tmp_path, {1: 1, 2: 2})
        servers, router, controller = _fleet(tmp_path)
        try:
            with faults.inject("swap:step=1,mode=partial-fleet"):
                outcomes = controller.roll_swap(2, max_concurrent=1,
                                                timeout=60.0)
            assert outcomes[0]["ok"] and outcomes[0]["weights_version"] == 2
            assert not outcomes[1]["ok"]
            assert outcomes[1]["error"] == "roll_aborted"
            refs = {v: _ref(v, n=4) for v in (1, 2)}
            assert refs[1] != refs[2]
            for i in range(8):
                out = router.generate(PROMPT, max_new_tokens=4,
                                      request_id=f"mixed-{i}")
                assert out.error is None
                assert out.tokens == refs[out.weights_version]
            assert all(o["ok"] for o in controller.roll_swap(2,
                                                             timeout=60.0))
            out = router.generate(PROMPT, max_new_tokens=4,
                                  request_id="converged")
            assert out.tokens == refs[2]
        finally:
            for s in servers:
                s.shutdown()


# --- tests/test_swap.py::TestChaosDrill -----------------------------------------

class TestChaosDrill:
    @pytest.mark.chaos
    def test_hot_swap_chaos_drill(self, tmp_path):
        chaos_step = int(os.environ.get("HVD_TPU_CHAOS_STEP", "2"))
        chaos_seed = int(os.environ.get("HVD_TPU_CHAOS_SEED", "0"))
        rng = random.Random(chaos_seed * 1000003 + chaos_step)
        n_swaps, n_tok = 5, 4
        step_v = {s: 1 + (s - 1) % 3 for s in range(1, n_swaps + 2)}
        _write_versions(tmp_path, step_v)
        refs = {s: _ref(v, n=n_tok) for s, v in step_v.items()}
        assert refs[1] != refs[2] != refs[3]
        servers, router, controller = _fleet(tmp_path)
        results, lock, threads = [], threading.Lock(), []
        stop = threading.Event()

        def fire(rid):
            try:
                resp = router.generate(PROMPT, max_new_tokens=n_tok,
                                       request_id=rid)
                row = {"id": rid, "error": resp.error, "tokens": resp.tokens,
                       "version": resp.weights_version}
            except Exception as e:
                row = {"id": rid, "error": str(e), "tokens": None,
                       "version": None}
            with lock:
                results.append(row)

        def load_loop():
            j = 0
            while not stop.is_set():
                for _ in range(2):
                    th = threading.Thread(target=fire, args=(f"drill-{j}",),
                                          daemon=True)
                    th.start()
                    threads.append(th)
                    j += 1
                stop.wait(0.15)

        try:
            loader = threading.Thread(target=load_loop, daemon=True)
            loader.start()
            for s in range(2, n_swaps + 2):
                mode = rng.choice([None, None, "corrupt-shard", "stall",
                                   "partial-fleet"])
                spec = {"corrupt-shard": "swap:p=1,mode=corrupt-shard",
                        "stall": "swap:p=1,mode=stall,delay_ms=40",
                        "partial-fleet": f"swap:step={rng.randrange(3)},"
                                         f"mode=partial-fleet"}.get(mode)
                if spec is None:
                    outcomes = controller.roll_swap(s, timeout=60.0)
                else:
                    with faults.inject(spec):
                        outcomes = controller.roll_swap(s, timeout=60.0)
                if mode == "corrupt-shard":
                    assert not any(o["ok"] for o in outcomes), outcomes
                elif mode in (None, "stall"):
                    assert all(o["ok"] for o in outcomes), outcomes
                time.sleep(0.2)
            rb = controller.rollback(1, timeout=60.0)
            assert all(o["ok"] for o in rb), rb
            time.sleep(0.3)
            stop.set()
            loader.join(timeout=10)
            for th in threads:
                th.join(timeout=60)
        finally:
            stop.set()
            engines = [s._batcher.engine for s in servers]
            for s in servers:
                s.shutdown()
        with lock:
            rows = list(results)
        assert rows, "the load loop produced no requests"
        dropped = [r for r in rows if r["error"] is not None]
        assert not dropped, f"dropped {len(dropped)}: {dropped[:3]}"
        for r in rows:
            assert r["version"] in refs and r["tokens"] == refs[r["version"]]
        want = _tree(1)
        for engine in engines:
            assert _same_weights(engine, want)
            assert engine.weights_version == 1
