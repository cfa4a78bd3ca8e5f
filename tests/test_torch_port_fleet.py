"""The port's disaggregated fleet (``horovod_tpu_torch/serve/fleet/``:
KV migration with per-block digests, the role-aware router pipeline,
drain-and-retire and the fleet controller) against the reference's.

First the parity checks: the digests of the same f32 and bf16 bytes
equal the reference's, a manifest the port's prefill replica put on the
wire verifies with the reference's ``verify_digests``, and the same
scripted stats and clock give both ``FleetController``s the same event
log.  Then ``tests/test_fleet.py``'s ``TestKvExportImport``,
``TestMigrationWire``, ``TestMigrateFaults``,
``TestReplicaStatsConcurrent``, ``TestDrainLifecycle``,
``TestFleetController`` and ``TestChaosFleet`` on the port, over the
HMAC wire on loopback, with the reference's fixture model converted by
``load_jax_params``: every token stream is the full forward's greedy
stream, which the migrated pipeline's is also held to against the JAX
model.
"""

import os
import socket
import time

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from horovod_tpu import faults as jfaults
from horovod_tpu.serve import FleetController as JaxController
from horovod_tpu.serve import ReplicaLauncher as JaxLauncher
from horovod_tpu.serve import ReplicaSpec as JaxSpec
from horovod_tpu.serve.fleet import migration as jmigration

from horovod_tpu_torch import faults
from horovod_tpu_torch.config import parse_fault_spec
from horovod_tpu_torch.elastic.driver import ElasticDriver, FixedDiscovery
from horovod_tpu_torch.serve import (
    ContinuousBatcher, FleetController, InferenceEngine, InferenceServer,
    ReplicaDrainingError, ReplicaLauncher, ReplicaSpec, Router,
    SamplingParams,
)
from horovod_tpu_torch.serve.fleet import migration
from horovod_tpu_torch.serve.kv import BlockPool, KVPoolExhaustedError
from horovod_tpu_torch.utils.retry import RetryPolicy

from torch_port_serve import ENGINE_DEFAULTS, KEY, fixture, greedy_reference

pytestmark = pytest.mark.serving


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


def _engine(**kw):
    kw = dict(ENGINE_DEFAULTS, kv_block=4, **kw)
    return InferenceEngine(fixture()[2], **kw)


def _ref(prompt, n):
    return greedy_reference(fixture()[2], prompt, n)


def _jax_greedy(prompt, n):
    """The reference model's own full-forward greedy stream."""
    jm, params, _ = fixture()
    seq, out = list(prompt), []
    for _ in range(n):
        logits = jm.apply({"params": params}, jnp.asarray([seq], jnp.int32))
        out.append(int(jnp.argmax(logits[0, -1])))
        seq.append(out[-1])
    return out


def _drive(engine, slot, n):
    toks = []
    while len(toks) < n:
        toks.extend(engine.step()[slot])
    return toks[:n]


def _replica(name, role="unified", engine_kw=None, **server_kw):
    batcher = ContinuousBatcher(_engine(**(engine_kw or {})), max_queue=16,
                                default_deadline_s=60, role=role)
    return InferenceServer(batcher, key=KEY, name=name, host="127.0.0.1",
                           **server_kw)


def _fast_router(replicas, **kw):
    kw.setdefault("retry_policy", RetryPolicy(attempts=8, base_delay_s=0.02,
                                              max_delay_s=0.2))
    kw.setdefault("probation_s", 30.0)
    return Router(replicas, KEY, **kw)


def _spec(server):
    return ReplicaSpec(server.name, [("127.0.0.1", server.port)],
                       role=server.role)


# --- against the reference ----------------------------------------------------

def _kv_words(seed, shape=(2, 3, 4, 2, 8)):
    """Random 16-bit words as (port bf16 tensor, reference bf16 array)."""
    words = np.random.RandomState(seed).randint(
        0, 1 << 16, size=shape).astype(np.uint16)
    port = torch.from_numpy(words.view(np.int16).copy()).view(torch.bfloat16)
    return port, words.view(ml_dtypes.bfloat16)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_digests_equal_the_reference_bit_for_bit(dtype):
    """``block_digests`` and ``shard_digests`` of the same bytes, f32
    tensors against numpy, bf16 tensors against ml_dtypes' bf16."""
    if dtype == "f32":
        k = np.random.RandomState(0).randn(2, 3, 4, 2, 8).astype(np.float32)
        v = np.random.RandomState(1).randn(2, 3, 4, 2, 8).astype(np.float32)
        kt, vt = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    else:
        kt, k = _kv_words(0)
        vt, v = _kv_words(1)
    got = migration.block_digests(kt, vt)
    assert got == jmigration.block_digests(k, v) and len(set(got)) == 3
    assert (migration.shard_digests(kt, vt, 2)
            == jmigration.shard_digests(k, v, 2))
    manifest = {"n_blocks": 3, "digests": got,
                "shard_digests": migration.shard_digests(kt, vt, 2)}
    jmigration.verify_digests(manifest, k, v)
    migration.verify_shard_digests(manifest, 1, kt[:, :, :, 1:],
                                   vt[:, :, :, 1:])
    bad = kt.clone()
    bad.reshape(-1).view(torch.uint8)[:4] ^= 0xFF
    with pytest.raises(migration.MigrationError, match="digest"):
        migration.verify_digests(manifest, bad, vt)


def test_port_manifest_verifies_with_the_reference():
    """The manifest and blocks a port prefill replica streams (captured
    at the decode replica's receive buffer) verify with the reference's
    ``verify_digests``; the reassembled blocks are the sender's."""
    pre = _replica("pre-m", role="prefill", migrate_chunk_bytes=1)
    dec = _replica("dec-m", role="decode")
    seen = []
    add = dec._migrations.add

    def capture(frame):
        out = add(frame)
        if out is not None:
            seen.append(out)
        return out

    dec._migrations.add = capture
    try:
        prompt = [9, 8, 7, 6, 5, 4, 3, 2, 1]
        resp = _fast_router([_spec(pre), _spec(dec)]).generate(
            prompt, max_new_tokens=4)
        assert resp.error is None and resp.migrated_to == "dec-m"
        (manifest, k, v), = seen
        assert manifest["n_blocks"] == 3 and k.dtype == torch.float32
        jmigration.verify_digests(manifest, k.numpy(), v.numpy())
        assert manifest["prompt"] == prompt and len(manifest["tokens"]) == 1
        assert resp.tokens == _jax_greedy(prompt, 4)
    finally:
        pre.shutdown()
        dec.shutdown()


class _ScriptedRouter:
    """The reference test's deterministic stats source, built for either
    package (``spec_cls`` makes the launched replicas' entries)."""

    def __init__(self, entries):
        self.entries = entries
        self.added, self.removed, self.drained, self.undrained = [], [], [], []

    def replica_stats(self, timeout=5.0):
        return {name: dict(e, stats=dict(e["stats"])) if "stats" in e
                else dict(e) for name, e in self.entries.items()}

    def add_replica(self, spec):
        self.added.append(spec.name)
        self.entries[spec.name] = _stats_entry(spec.name, spec.role)

    def remove_replica(self, name):
        if name == "unified-last":
            raise ValueError("cannot remove the last replica")
        self.removed.append(name)
        self.entries.pop(name, None)

    def drain_replica(self, name, timeout=5.0):
        self.drained.append(name)
        if name in self.entries:
            self.entries[name]["draining"] = True

    def undrain_replica(self, name, timeout=5.0):
        self.undrained.append(name)
        if name in self.entries:
            self.entries[name]["draining"] = False


def _stats_entry(name, role, queue=0, active=0, ttft_p99=None):
    return {"name": name, "role": role, "healthy": True,
            "draining": False, "strikes": 0, "inflight": 0,
            "completed": 0, "failed": 0,
            "stats": {"queue_depth": queue, "active_slots": active,
                      "max_slots": 2, "ttft_ms_p99": ttft_p99}}


def _launcher_for(base, spec_cls):
    class Launcher(base):
        def __init__(self):
            self.launched, self.retired = [], []

        def launch(self, role, host=None):
            self.launched.append((role, host))
            return spec_cls(f"{role}-new-{len(self.launched) - 1}",
                            [("127.0.0.1", 1)], role=role)

        def retire(self, name):
            self.retired.append(name)

    return Launcher()


def _script_rounds(seed):
    """A seeded script of per-round mutations over a mixed fleet."""
    import random

    rng = random.Random(seed)
    rounds = []
    for _ in range(14):
        muts = []
        for name in ("prefill-0", "decode-0", "decode-1", "unified-0",
                     "unified-last"):
            roll = rng.random()
            if roll < 0.2:
                muts.append((name, "queue", rng.choice([0, 0, 2, 9])))
            elif roll < 0.35:
                muts.append((name, "active", rng.choice([0, 1, 2])))
            elif roll < 0.45:
                muts.append((name, "ttft", rng.choice([None, 100.0, 900.0])))
            elif roll < 0.5:
                muts.append((name, "blip", None))
        forced = rng.choice([None, None, None, "drain", "scale"])
        rounds.append((rng.choice([0.0, 5.0, 40.0]), muts, forced))
    return rounds


@pytest.mark.parametrize("seed", range(3))
def test_controller_events_match_the_reference(seed):
    """The same scripted stats, forced actions and virtual clock, fed to
    both packages' controllers: every round's actions and the whole
    ``events`` log are equal."""
    logs = {}
    for pkg, ctl_cls, launcher_base, spec_cls in (
            ("port", FleetController, ReplicaLauncher, ReplicaSpec),
            ("ref", JaxController, JaxLauncher, JaxSpec)):
        entries = {n: _stats_entry(n, n.rsplit("-", 1)[0].split("-")[0])
                   for n in ("prefill-0", "decode-0", "decode-1",
                             "unified-0")}
        entries["unified-last"] = _stats_entry("unified-last", "unified")
        router = _ScriptedRouter(entries)
        launcher = _launcher_for(launcher_base, spec_cls)
        clock = {"t": 1000.0}
        ctl = ctl_cls(router, launcher, scale_out_queue=4.0,
                      scale_out_ttft_ms=500.0, scale_in_idle_s=30.0,
                      drain_deadline_s=60.0, max_replicas=9,
                      clock=lambda: clock["t"])
        trail = []
        for dt, muts, forced in _script_rounds(seed):
            clock["t"] += dt
            for name, what, val in muts:
                e = router.entries.get(name)
                if e is None:
                    continue
                if what == "blip":
                    e.pop("stats", None)
                    e["stats_error"] = "timeout after 2.0s"
                    continue
                e.pop("stats_error", None)
                e.setdefault("stats", _stats_entry(name, e["role"])["stats"])
                key = {"queue": "queue_depth", "active": "active_slots",
                       "ttft": "ttft_ms_p99"}[what]
                e["stats"][key] = val
            if forced == "drain" and "unified-last" in router.entries:
                ctl.drain_and_retire("unified-last")
            elif forced == "scale":
                ctl.scale_out("decode")
            trail.append(ctl.poll_once())
        logs[pkg] = (trail, list(ctl.events), launcher.launched,
                     launcher.retired, router.drained, router.undrained)
    assert logs["port"] == logs["ref"]
    assert logs["port"][1], "the script must make the controller act"


# --- tests/test_fleet.py::TestKvExportImport ------------------------------------

class TestKvExportImport:
    def test_greedy_identity(self):
        prompt, n = [3, 1, 4, 1, 5, 9, 2, 6], 6
        a, b = _engine(seed=7), _engine(seed=99)
        t0 = a.start(0, prompt, SamplingParams(max_new_tokens=n))
        nb, k, v = a.export_slot_kv(0)
        assert nb == 2 and k.shape[1] == 2
        b.import_slot_kv(0, prompt, k, v, t0,
                         SamplingParams(max_new_tokens=n))
        got = [t0] + _drive(b, 0, n - 1)
        assert got == _ref(prompt, n) == _jax_greedy(prompt, n)

    def test_temperature_identity_with_rng(self):
        prompt, n = [3, 1, 4, 1, 5, 9, 2, 6], 6
        sp = SamplingParams(max_new_tokens=n, temperature=0.8, top_k=5)
        ref = _engine(seed=7)
        want = [ref.start(0, prompt, sp)] + _drive(ref, 0, n - 1)
        a, b = _engine(seed=7), _engine(seed=12345)
        t0 = a.start(0, prompt, sp)
        nb, k, v = a.export_slot_kv(0)
        b.import_slot_kv(0, prompt, k, v, t0, sp, rng=a.export_rng())
        assert [t0] + _drive(b, 0, n - 1) == want

    def test_spec_identity(self):
        prompt, n = [2, 7, 1, 8, 2, 8], 8
        sp = SamplingParams(max_new_tokens=n, spec=True)
        a = _engine()
        b = _engine(drafter=fixture()[2], spec_k=2)
        t0 = a.start(0, prompt, sp)
        nb, k, v = a.export_slot_kv(0)
        b.import_slot_kv(0, prompt, k, v, t0, sp)
        assert [t0] + _drive(b, 0, n - 1) == _ref(prompt, n)
        assert b.spec_verify_steps > 0

    def test_export_after_prefix_hit_still_complete(self):
        pre = [11, 12, 13, 14, 15, 16, 17, 18]
        a = _engine()
        a.start(0, pre + [1], SamplingParams(max_new_tokens=2))
        _drive(a, 0, 1)
        a.release(0)
        prompt, n = pre + [2], 5
        t0 = a.start(0, prompt, SamplingParams(max_new_tokens=n))
        assert a.prefix_hit_tokens(0) >= 8
        nb, k, v = a.export_slot_kv(0)
        b = _engine()
        b.import_slot_kv(0, prompt, k, v, t0,
                         SamplingParams(max_new_tokens=n))
        assert [t0] + _drive(b, 0, n - 1) == _ref(prompt, n)

    def test_digest_verification_rejects_corruption(self):
        a = _engine()
        a.start(0, [5, 6, 7, 8, 9], SamplingParams(max_new_tokens=2))
        nb, k, v = a.export_slot_kv(0)
        manifest = {"n_blocks": nb, "digests": migration.block_digests(k, v)}
        migration.verify_digests(manifest, k, v)
        bad = k.clone()
        bad.reshape(-1).view(torch.uint8)[:8] ^= 0xFF
        with pytest.raises(migration.MigrationError, match="digest"):
            migration.verify_digests(manifest, bad, v)

    def test_import_validates_chain_length(self):
        a = _engine()
        t0 = a.start(0, [5, 6, 7, 8, 9], SamplingParams(max_new_tokens=2))
        nb, k, v = a.export_slot_kv(0)
        with pytest.raises(ValueError, match="does not cover"):
            _engine().import_slot_kv(0, [5, 6, 7, 8, 9], k[:, :1],
                                     v[:, :1], t0,
                                     SamplingParams(max_new_tokens=2))

    def test_bind_imported_pool_accounting(self):
        table = np.zeros((2, 4), np.int32)
        pool = BlockPool(10, 4, table, lambda s, d: None)
        chain = pool.bind_imported(0, 2)
        assert len(chain) == 2 and pool.blocks_in_use() == 2
        assert list(table[0, :2]) == chain
        with pytest.raises(RuntimeError, match="already has a chain"):
            pool.bind_imported(0, 1)
        pool.index_prompt(0, [1, 2, 3, 4, 5, 6, 7, 8])
        pool.release(0)
        assert pool.blocks_in_use() == 0
        assert pool.probe([1, 2, 3, 4, 5, 6, 7, 8]) == 7

    def test_bind_imported_rolls_back_on_exhaustion(self):
        table = np.zeros((2, 6), np.int32)
        pool = BlockPool(4, 4, table, lambda s, d: None)
        with pytest.raises(KVPoolExhaustedError):
            pool.bind_imported(0, 5)
        assert pool.blocks_in_use() == 0
        assert len(pool.bind_imported(0, 3)) == 3

    def test_frame_planner_bounds_frames(self):
        for plan in (migration.plan_frames, jmigration.plan_frames):
            assert plan(5, 100, 250) == [(0, 2), (2, 4), (4, 5)]
            assert plan(3, 100, 10) == [(0, 1), (1, 2), (2, 3)]
            assert plan(2, 100, 10 ** 9) == [(0, 2)]


# --- tests/test_fleet.py::TestMigrationWire -------------------------------------

class TestMigrationWire:
    def test_pipeline_greedy_identity(self):
        pre = _replica("pre-0", role="prefill")
        dec = _replica("dec-0", role="decode")
        try:
            router = _fast_router([_spec(pre), _spec(dec)])
            prompt = [3, 1, 4, 1, 5, 9, 2, 6]
            resp = router.generate(prompt, max_new_tokens=6)
            assert resp.error is None
            assert resp.tokens == _ref(prompt, 6) == _jax_greedy(prompt, 6)
            assert resp.migrated_to == "dec-0"
            assert resp.migrate_ms is not None and resp.migrate_ms > 0
            stats = router.replica_stats(timeout=3.0)
            assert stats["pre-0"]["stats"]["requests_completed"] == 1
            assert stats["dec-0"]["stats"]["requests_completed"] == 1
        finally:
            pre.shutdown()
            dec.shutdown()

    def test_pipeline_temperature_identity(self):
        prompt, n = [3, 1, 4, 1, 5, 9, 2, 6], 6
        sp = SamplingParams(max_new_tokens=n, temperature=0.7, top_k=4)
        ref = _engine(seed=7)
        want = [ref.start(0, prompt, sp)] + _drive(ref, 0, n - 1)
        pre = _replica("pre-t", role="prefill", engine_kw={"seed": 7})
        dec = _replica("dec-t", role="decode", engine_kw={"seed": 4242})
        try:
            resp = _fast_router([_spec(pre), _spec(dec)]).generate(
                prompt, max_new_tokens=n, temperature=0.7, top_k=4)
            assert resp.error is None and resp.migrated_to == "dec-t"
            assert resp.tokens == want
        finally:
            pre.shutdown()
            dec.shutdown()

    def test_pipeline_spec_identity(self):
        pre = _replica("pre-s", role="prefill")
        dec = _replica("dec-s", role="decode",
                       engine_kw={"drafter": fixture()[2], "spec_k": 2})
        try:
            router = _fast_router([_spec(pre), _spec(dec)])
            prompt = [2, 7, 1, 8, 2, 8]
            resp = router.generate(prompt, max_new_tokens=8, spec=True)
            assert resp.error is None and resp.migrated_to == "dec-s"
            assert resp.tokens == _ref(prompt, 8)
            snap = router.replica_stats(timeout=3.0)
            assert snap["dec-s"]["stats"]["spec_verify_steps"] > 0
        finally:
            pre.shutdown()
            dec.shutdown()

    def test_chunked_transfer_identity(self):
        pre = _replica("pre-c", role="prefill", migrate_chunk_bytes=1)
        dec = _replica("dec-c", role="decode")
        try:
            prompt = [9, 8, 7, 6, 5, 4, 3, 2, 1]
            resp = _fast_router([_spec(pre), _spec(dec)]).generate(
                prompt, max_new_tokens=5)
            assert resp.error is None and resp.migrated_to == "dec-c"
            assert resp.tokens == _ref(prompt, 5)
        finally:
            pre.shutdown()
            dec.shutdown()

    def test_directory_hit_lands_on_decode_replica(self):
        base = list(range(20, 36))
        ekw = {"prefill_buckets": (8, 24)}
        pre = _replica("pre-d", role="prefill", engine_kw=ekw)
        dec = _replica("dec-d", role="decode", engine_kw=ekw)
        try:
            router = _fast_router([_spec(pre), _spec(dec)])
            first = router.generate(base + [1, 2], max_new_tokens=4,
                                    request_id="dir-0")
            assert first.error is None and first.migrated_to == "dec-d"
            second = router.generate(base + [3, 4], max_new_tokens=4,
                                     request_id="dir-1")
            assert second.error is None and second.migrated_to is None
            assert second.tokens == _ref(base + [3, 4], 4)
            stats = router.replica_stats(timeout=3.0)
            assert stats["dec-d"]["stats"]["requests_completed"] == 2
            assert stats["dec-d"]["stats"]["prefix_hits"] >= 1
            assert stats["pre-d"]["stats"]["requests_completed"] == 1
        finally:
            pre.shutdown()
            dec.shutdown()


# --- tests/test_fleet.py::TestMigrateFaults -------------------------------------

class TestMigrateFaults:
    def test_spec_grammar(self):
        for mode in ("migrate", "migrate-drop", "migrate-delay"):
            assert parse_fault_spec(
                f"serve:step=0,mode={mode}")["serve"].mode == mode
        with pytest.raises(ValueError, match="unknown mode"):
            parse_fault_spec("serve:step=0,mode=migrate-corrupt-all")

    def test_migrate_modes_fire_only_at_transfer_boundary(self):
        with faults.inject("serve:p=1.0,mode=migrate"):
            assert faults.on_serve_request("GenerateRequest") is None
            assert faults.on_serve_decode() is False
            assert faults.on_serve_evict() is False
            assert faults.on_serve_migrate() == "migrate"

    def _run_faulted(self, spec_str):
        pre = _replica("pre-f", role="prefill")
        dec = _replica("dec-f", role="decode")
        try:
            router = _fast_router([_spec(pre), _spec(dec)])
            prompt = [6, 5, 4, 3, 2, 1, 7, 8]
            with faults.inject(spec_str):
                resp = router.generate(prompt, max_new_tokens=6)
                fired = [h for h in faults.history() if h[0] == "serve"]
            assert resp.error is None
            assert resp.tokens == _ref(prompt, 6)
            return resp, fired, dec
        finally:
            pre.shutdown()
            dec.shutdown()

    def test_corrupt_block_fails_digest_and_recomputes(self):
        resp, fired, dec = self._run_faulted("serve:step=0,mode=migrate")
        assert fired == [("serve", 0, "migrate")]
        assert resp.migrated_to is None
        # Nothing unverified reached the receiver's pool.
        assert dec._batcher.engine.kv_stats()["kv_blocks_in_use"] == 0

    def test_migrate_drop_falls_back_locally(self):
        resp, fired, _ = self._run_faulted("serve:step=0,mode=migrate-drop")
        assert fired == [("serve", 0, "migrate-drop")]
        assert resp.migrated_to is None

    def test_migrate_delay_slows_but_migrates(self):
        t0 = time.monotonic()
        resp, fired, _ = self._run_faulted(
            "serve:step=0,mode=migrate-delay,delay_ms=150")
        assert time.monotonic() - t0 >= 0.15
        assert fired == [("serve", 0, "migrate-delay")]
        assert resp.migrated_to == "dec-f"


# --- tests/test_fleet.py::TestReplicaStatsConcurrent ----------------------------

class TestReplicaStatsConcurrent:
    def test_dead_replicas_cost_one_timeout_not_each(self):
        live = _replica("live-0")
        socks, specs = [], []
        for i in range(3):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            s.listen(1)
            socks.append(s)
            specs.append(ReplicaSpec(f"wedged-{i}",
                                     [("127.0.0.1", s.getsockname()[1])]))
        try:
            router = _fast_router([_spec(live)] + specs, probe_timeout=1.0)
            t0 = time.monotonic()
            stats = router.replica_stats(timeout=1.0)
            assert time.monotonic() - t0 < 2.5
            assert "stats" in stats["live-0"]
            for i in range(3):
                assert "stats_error" in stats[f"wedged-{i}"]
                assert stats[f"wedged-{i}"]["role"] == "unified"
        finally:
            live.shutdown()
            for s in socks:
                s.close()


# --- tests/test_fleet.py::TestDrainLifecycle ------------------------------------

class TestDrainLifecycle:
    def test_batcher_drain_rejects_new_finishes_inflight(self):
        b = ContinuousBatcher(_engine(), max_queue=8, default_deadline_s=30)
        req = b.submit([1, 2, 3], SamplingParams(max_new_tokens=4))
        b.drain()
        with pytest.raises(ReplicaDrainingError):
            b.submit([4, 5], SamplingParams(max_new_tokens=2))
        for _ in range(50):
            if req.done.is_set():
                break
            b.step()
        assert req.error is None and len(req.tokens) == 4
        snap = b.snapshot()
        assert snap["draining"] is True and snap["queue_depth"] == 0

    def test_undrain_reverses_a_drain_end_to_end(self):
        srv = _replica("ud-a")
        try:
            router = _fast_router([_spec(srv)])
            router.drain_replica("ud-a")
            with pytest.raises(Exception):
                router.generate([1, 2], max_new_tokens=2, request_id="ud-0")
            router.undrain_replica("ud-a")
            resp = router.generate([1, 2], max_new_tokens=2,
                                   request_id="ud-1")
            assert resp.error is None and len(resp.tokens) == 2
            assert srv._batcher.draining is False
        finally:
            srv.shutdown()

    def test_router_shifts_load_off_draining_replica(self):
        a, b = _replica("dr-a"), _replica("dr-b")
        try:
            router = _fast_router([_spec(a), _spec(b)])
            router.drain_replica("dr-a")
            for i in range(3):
                assert router.generate([i + 1, 2],
                                       max_new_tokens=2).error is None
            stats = router.replica_stats(timeout=3.0)
            assert stats["dr-a"]["draining"] is True
            assert stats["dr-a"]["stats"]["requests_completed"] == 0
            assert stats["dr-b"]["stats"]["requests_completed"] == 3
            assert stats["dr-a"]["strikes"] == 0
        finally:
            a.shutdown()
            b.shutdown()


# --- tests/test_fleet.py::TestFleetController -----------------------------------

def _fake(entries):
    return _ScriptedRouter(entries), _launcher_for(ReplicaLauncher,
                                                   ReplicaSpec)


class TestFleetController:
    def test_scale_out_on_queue_saturation(self):
        router, launcher = _fake({
            "decode-0": _stats_entry("decode-0", "decode", queue=9),
            "prefill-0": _stats_entry("prefill-0", "prefill", queue=0)})
        c = FleetController(router, launcher, scale_out_queue=4.0,
                            scale_in_idle_s=3600.0)
        assert [(a["action"], a["role"]) for a in c.poll_once()] == \
            [("scale_out", "decode")]
        assert launcher.launched == [("decode", None)]
        assert router.added == ["decode-new-0"]

    def test_scale_out_on_ttft(self):
        router, launcher = _fake({
            "prefill-0": _stats_entry("prefill-0", "prefill",
                                      ttft_p99=900.0)})
        c = FleetController(router, launcher, scale_out_queue=1e9,
                            scale_out_ttft_ms=500.0, scale_in_idle_s=3600.0)
        c.poll_once()
        assert launcher.launched == [("prefill", None)]

    def test_idle_role_drains_then_retires(self):
        router, launcher = _fake({
            "decode-0": _stats_entry("decode-0", "decode"),
            "decode-1": _stats_entry("decode-1", "decode")})
        c = FleetController(router, launcher, scale_out_queue=100.0,
                            scale_in_idle_s=0.0, min_per_role=1)
        assert [a["action"] for a in c.poll_once()] == ["drain"]
        assert router.drained == ["decode-1"]
        assert c.draining() == ["decode-1"]
        assert [a["action"] for a in c.poll_once()] == ["retire"]
        assert router.removed == ["decode-1"]
        assert launcher.retired == ["decode-1"]
        assert c.poll_once() == []

    def test_drain_deadline_forces_retire(self):
        router, launcher = _fake({
            "unified-0": _stats_entry("unified-0", "unified"),
            "unified-1": _stats_entry("unified-1", "unified", queue=3,
                                      active=2)})
        c = FleetController(router, launcher, scale_out_queue=100.0,
                            scale_in_idle_s=3600.0, drain_deadline_s=100.0)
        c.drain_and_retire("unified-1")
        assert c.poll_once() == []
        actions = c.poll_once(now=time.monotonic() + 200.0)
        assert [a["action"] for a in actions] == ["retire"]
        assert actions[0]["forced"] is True

    def test_unreachable_drain_waits_for_deadline(self):
        entries = {"unified-0": _stats_entry("unified-0", "unified"),
                   "unified-1": _stats_entry("unified-1", "unified")}
        router, launcher = _fake(entries)
        c = FleetController(router, launcher, scale_out_queue=100.0,
                            scale_in_idle_s=3600.0, drain_deadline_s=100.0)
        c.drain_and_retire("unified-1")
        del entries["unified-1"]["stats"]
        entries["unified-1"]["stats_error"] = "timeout after 2.0s"
        assert c.poll_once() == []
        assert launcher.retired == []
        actions = c.poll_once(now=time.monotonic() + 200.0)
        assert [a["action"] for a in actions] == ["retire"]

    def test_last_replica_retire_refusal_does_not_wedge(self):
        router, launcher = _fake({
            "unified-last": _stats_entry("unified-last", "unified")})
        c = FleetController(router, launcher, scale_out_queue=100.0,
                            scale_in_idle_s=3600.0)
        c.drain_and_retire("unified-last")
        assert c.poll_once() == []
        assert c.draining() == []
        assert launcher.retired == []
        assert router.undrained == ["unified-last"]
        c.poll_once()

    def test_reservation_released_when_host_leaves(self):
        disc = FixedDiscovery({"h1": 1})
        driver = ElasticDriver(disc, poll_interval_s=3600.0)
        driver.poll_once()
        assert driver.reserve_slot() == "h1"
        assert driver.reserve_slot() is None
        disc.hosts = {}
        driver.poll_once()
        disc.hosts = {"h1": 1}
        driver.poll_once()
        assert driver.reserved_slots() == 0
        assert driver.reserve_slot() == "h1"

    def test_placement_rides_elastic_discovery(self):
        driver = ElasticDriver(FixedDiscovery({"h1": 1}),
                               poll_interval_s=3600.0)
        driver.poll_once()
        router, launcher = _fake({
            "decode-0": _stats_entry("decode-0", "decode", queue=9)})
        c = FleetController(router, launcher, driver=driver,
                            scale_out_queue=4.0, scale_in_idle_s=3600.0)
        spec = c.scale_out("decode")
        assert spec is not None
        assert launcher.launched == [("decode", "h1")]
        assert driver.reserved_slots() == 1
        assert c.scale_out("decode") is None
        router.entries["decode-0"]["stats"]["queue_depth"] = 0
        c.drain_and_retire(spec.name)
        router.entries.pop(spec.name, None)
        c.poll_once()
        assert driver.reserved_slots() == 0


# --- tests/test_fleet.py::TestChaosFleet ----------------------------------------

class _LocalLauncher(ReplicaLauncher):
    """Real in-process replicas for the scale cycle."""

    def __init__(self):
        self.servers, self.n = {}, 0

    def launch(self, role, host=None):
        name = f"{role}-x{self.n}"
        self.n += 1
        self.servers[name] = _replica(name, role=role)
        return _spec(self.servers[name])

    def retire(self, name):
        srv = self.servers.pop(name, None)
        if srv is not None:
            srv.shutdown()

    def shutdown_all(self):
        for srv in self.servers.values():
            srv.shutdown()
        self.servers.clear()


@pytest.mark.chaos
class TestChaosFleet:
    def test_kill_mid_migration_and_scale_cycle(self):
        fault_step = int(os.environ.get("HVD_TPU_CHAOS_STEP", "0")) % 12
        seed = int(os.environ.get("HVD_TPU_CHAOS_SEED", "0"))
        fleet = [_replica("chaos-pre", role="prefill"),
                 _replica("chaos-d0", role="decode"),
                 _replica("chaos-d1", role="decode")]
        launcher = _LocalLauncher()
        try:
            router = _fast_router(
                [_spec(s) for s in fleet],
                retry_policy=RetryPolicy(attempts=10, base_delay_s=0.02,
                                         max_delay_s=0.2))
            responses = {}
            with faults.inject(f"serve:step={fault_step},seed={seed},"
                               f"mode=kill"):
                for i in range(8):
                    rid = f"fleet-{i}"
                    resp = router.generate([i + 1, i + 2, i + 3, i + 4],
                                           max_new_tokens=6, request_id=rid)
                    assert resp.error is None, (i, resp.error)
                    assert len(resp.tokens) == 6 and rid not in responses
                    responses[rid] = resp
                kills = [h for h in faults.history() if h[0] == "serve"]
            assert len(kills) == 1, kills
            assert sum(s.dead for s in fleet) == 1
            for i in range(8):
                assert responses[f"fleet-{i}"].tokens == _ref(
                    [i + 1, i + 2, i + 3, i + 4], 6), i
            again = router.generate([99], max_new_tokens=2,
                                    request_id="fleet-0")
            assert again is responses["fleet-0"]
            controller = FleetController(
                router, launcher, scale_in_idle_s=3600.0,
                drain_deadline_s=30.0, stats_timeout_s=2.0)
            spec = controller.scale_out("decode")
            assert spec is not None
            r = router.generate([41, 42, 43, 44], max_new_tokens=3,
                                request_id="fleet-post")
            assert r.error is None
            assert r.tokens == _ref([41, 42, 43, 44], 3)
            controller.drain_and_retire(spec.name)
            deadline = time.monotonic() + 20.0
            while controller.draining() and time.monotonic() < deadline:
                controller.poll_once()
                time.sleep(0.05)
            assert controller.draining() == []
            assert spec.name not in launcher.servers
            after = router.generate([7, 7, 7, 7], max_new_tokens=2,
                                    request_id="fleet-after")
            assert after.error is None
        finally:
            launcher.shutdown_all()
            for s in fleet:
                s.shutdown()
