"""The port's router, server and prefix directory
(``horovod_tpu_torch/serve/{router,server}.py``, ``serve/fleet/
directory.py``) against the reference's: the same scripted replica
answers under one virtual clock give the same routes, strikes, benches,
half-open probes, failovers and errors; the directory answers alike.
Then the reference's wire tests (``tests/test_serving.py::
TestReplicaGroups``, ``TestServerRouter``, ``TestRouterPrefixAffinity``,
``TestChaosServeFailover``) on the port, over the HMAC wire on
loopback, and the requests and keywords that wait for later slices.
"""

import os
import random
import time

import pytest

from horovod_tpu import faults as jfaults
from horovod_tpu.serve import GenerateResponse as JaxResponse
from horovod_tpu.serve import PrefixDirectory as JaxDirectory
from horovod_tpu.serve import ReplicaSpec as JaxSpec
from horovod_tpu.serve import Router as JaxRouter
from horovod_tpu.utils.retry import RetryPolicy as JaxRetry

import horovod_tpu_torch as hvd
from horovod_tpu_torch import faults
from horovod_tpu_torch.runner.common.network import (BasicClient,
                                                     DrainRequest)
from horovod_tpu_torch.serve import (
    ContinuousBatcher, GenerateRequest, GenerateResponse, InferenceEngine,
    InferenceServer, NoHealthyReplicasError, PrefixDirectory,
    QueueFullError, ReplicaSpec, Router, RollbackRequest, SamplingParams,
    ShardFollower, ShardServer, SwapRequest, SwapResponse,
    register_replica_process_sets, replica_slot_groups,
)
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


def _replica(name, **batcher_kw):
    batcher_kw.setdefault("max_queue", 8)
    batcher_kw.setdefault("default_deadline_s", 30.0)
    engine_kw = dict(ENGINE_DEFAULTS, **batcher_kw.pop("engine_kw", {}))
    b = ContinuousBatcher(InferenceEngine(fixture()[2], **engine_kw),
                          **batcher_kw)
    return InferenceServer(b, key=KEY, name=name, host="127.0.0.1")


def _fast_router(replicas, **kw):
    kw.setdefault("retry_policy", RetryPolicy(attempts=8, base_delay_s=0.02,
                                              max_delay_s=0.1))
    kw.setdefault("probation_s", 30.0)
    return Router(replicas, KEY, **kw)


def _spec(server):
    return ReplicaSpec(server.name, [("127.0.0.1", server.port)])


# --- against the reference ----------------------------------------------------

class _Script:
    """A scripted transport: each replica answers from a seeded draw
    (ok, busy, replica_killed, draining, a wire error) and logs who was
    asked; the same script drives both packages' routers."""

    OUTCOMES = ("ok", "ok", "ok", "busy", "replica_killed", "wire",
                "draining")

    def __init__(self, seed, resp_cls):
        self.rng = random.Random(seed)
        self.resp_cls = resp_cls
        self.log = []

    def factory(self, spec):
        script = self

        class Client:
            def request(self, req, idempotent=True, timeout=None):
                kind = type(req).__name__
                script.log.append((spec.name, kind))
                if kind != "GenerateRequest":
                    return None
                outcome = script.rng.choice(script.OUTCOMES)
                if outcome == "wire":
                    raise ConnectionError("scripted wire death")
                if outcome == "ok":
                    return script.resp_cls(req.request_id,
                                           list(req.prompt[:2]))
                return script.resp_cls(req.request_id, None, error=outcome)

        return Client()


def _route(router, prompt, rid):
    try:
        resp = router.generate(prompt, max_new_tokens=4, request_id=rid)
        return ("ok", resp.tokens, resp.error)
    except Exception as e:
        return ("raised", type(e).__name__)


def _health(router):
    return [(r.spec.name, r.strikes, r.dead_until, r.draining, r.completed,
             r.failed) for r in router._replicas]


@pytest.mark.parametrize("seed", range(4))
def test_failover_and_probation_match_the_reference(seed):
    """Scripted answers (successes, busy, kills, drains, wire deaths)
    under a virtual clock that crosses probation windows: every
    request's outcome, every replica asked, and the strikes, benches and
    counters after each request equal the reference router's."""
    clock = {"t": 0.0}
    routers = {}
    for name, router_cls, spec_cls, retry_cls, resp_cls in (
            ("port", Router, ReplicaSpec, RetryPolicy, GenerateResponse),
            ("ref", JaxRouter, JaxSpec, JaxRetry, JaxResponse)):
        script = _Script(seed, resp_cls)
        specs = [spec_cls(f"r{i}", [("127.0.0.1", 1 + i)])
                 for i in range(3)]
        router = router_cls(specs, KEY, strikes=2, probation_s=5.0,
                            retry_policy=retry_cls(attempts=4,
                                                   base_delay_s=0.0),
                            clock=lambda: clock["t"],
                            client_factory=script.factory)
        routers[name] = (router, script)
    rng = random.Random(1000 + seed)
    for i in range(40):
        t = rng.uniform(0.0, 3.0)
        prompt = [rng.randrange(1, 9) for _ in range(rng.choice([3, 16, 20]))]
        results = {}
        for name, (router, script) in routers.items():
            clock["t"] = i * 1.0 + t
            results[name] = (_route(router, prompt, f"q{i}"),
                             _health(router))
        assert results["port"] == results["ref"], i
    assert routers["port"][1].log == routers["ref"][1].log


def test_prefix_directory_matches_the_reference():
    rng = random.Random(7)
    port, ref = PrefixDirectory(4, max_entries=6), JaxDirectory(4, max_entries=6)
    reps = ["a", "b", "c"]
    for _ in range(200):
        key = tuple(rng.randrange(3) for _ in range(4))
        op = rng.choice(["record", "lookup", "discard", "invalidate"])
        if op == "record":
            rep, ver = rng.choice(reps), rng.choice([None, 1, 2])
            port.record(key, rep, version=ver)
            ref.record(key, rep, version=ver)
        elif op == "lookup":
            assert port.lookup_versioned(key) == ref.lookup_versioned(key)
        elif op == "discard":
            rep = rng.choice(reps)
            port.discard(key, rep)
            ref.discard(key, rep)
        else:
            rep = rng.choice(reps)
            assert port.invalidate_replica(rep) == ref.invalidate_replica(rep)
        assert len(port) == len(ref) and port.stats() == ref.stats()
    assert port.key_for([1, 2, 3]) is None
    assert port.key_for(list(range(6))) == (0, 1, 2, 3)


# --- replica groups -----------------------------------------------------------

def test_slot_groups_partition_the_mesh():
    assert replica_slot_groups(2, world_size=8) == [[0, 1, 2, 3],
                                                    [4, 5, 6, 7]]
    assert replica_slot_groups(8, world_size=8) == [[i] for i in range(8)]
    with pytest.raises(ValueError):
        replica_slot_groups(3, world_size=8)


def test_register_replica_process_sets_idempotent():
    hvd.init(device="cpu")
    try:
        created = register_replica_process_sets(1)
        assert [list(ps.ranks) for ps in created] == replica_slot_groups(1)
        again = register_replica_process_sets(1)
        assert [ps.process_set_id for ps in again] == \
            [ps.process_set_id for ps in created]
        with pytest.raises(ValueError):
            register_replica_process_sets(2)
    finally:
        hvd.shutdown()


# --- server and router over the wire ------------------------------------------

def test_generate_over_the_wire():
    model = fixture()[2]
    srv = _replica("r0")
    try:
        router = _fast_router([_spec(srv)])
        resp = router.generate([3, 1, 4], max_new_tokens=5)
        assert resp.error is None
        assert resp.tokens == greedy_reference(model, [3, 1, 4], 5)
        assert resp.ttft_ms is not None and resp.ttft_ms > 0
        assert resp.weights_version == 0
    finally:
        srv.shutdown()


def test_stats_endpoint():
    srv = _replica("r0")
    try:
        router = _fast_router([_spec(srv)])
        router.generate([1, 2], max_new_tokens=3)
        entry = router.replica_stats()["r0"]
        assert entry["healthy"] is True
        assert entry["completed"] == 1
        assert entry["stats"]["requests_completed"] == 1
        assert entry["stats"]["tokens_out"] == 3
    finally:
        srv.shutdown()


def test_prompt_too_long_is_terminal():
    srv = _replica("r0")
    try:
        router = _fast_router([_spec(srv)])
        resp = router.generate(list(range(30)), max_new_tokens=2)
        assert resp.error.startswith("prompt_too_long")
    finally:
        srv.shutdown()


def test_busy_replica_fails_over():
    full = _replica("full", max_queue=1)
    ok = _replica("ok")
    try:
        full._batcher._stop.set()
        full._batcher._thread.join(timeout=5)
        for _ in range(20):
            try:
                full._batcher.submit([1], SamplingParams())
            except QueueFullError:
                break
        router = _fast_router([_spec(full), _spec(ok)])
        for i in range(3):
            resp = router.generate([i + 1, 2], max_new_tokens=3)
            assert resp.error is None, (i, resp.error)
    finally:
        full.shutdown()
        ok.shutdown()


def test_drop_fault_is_absorbed_by_failover():
    srv = _replica("r0")
    try:
        router = _fast_router([_spec(srv)], strikes=5, probation_s=0.05)
        with faults.inject("serve:step=0,mode=drop"):
            resp = router.generate([2, 3], max_new_tokens=3)
            assert [h[2] for h in faults.history()] == ["drop:"
                                                        "GenerateRequest"]
        assert resp.error is None and len(resp.tokens) == 3
    finally:
        srv.shutdown()


def test_delay_fault_slows_but_succeeds():
    srv = _replica("r0")
    try:
        router = _fast_router([_spec(srv)])
        with faults.inject("serve:step=0,mode=delay,delay_ms=150"):
            t0 = time.monotonic()
            resp = router.generate([2, 3], max_new_tokens=2)
            assert time.monotonic() - t0 >= 0.15
        assert resp.error is None
    finally:
        srv.shutdown()


def test_empty_prompt_is_terminal_not_a_replica_crash():
    srv = _replica("r0")
    try:
        router = _fast_router([_spec(srv)])
        resp = router.generate([], max_new_tokens=2)
        assert resp.error.startswith("invalid_request"), resp.error
        assert router.replica_stats()["r0"]["healthy"] is True
    finally:
        srv.shutdown()


def test_half_open_probation_rehabilitates_replica():
    srv = _replica("r0")
    try:
        router = _fast_router([_spec(srv)], strikes=1, probation_s=0.05)
        rep = router._replicas[0]
        router._strike(rep, fatal=True)
        assert rep.dead_until is not None
        time.sleep(0.06)
        resp = router.generate([1, 2], max_new_tokens=2)
        assert resp.error is None
        assert rep.dead_until is None and rep.strikes == 0
    finally:
        srv.shutdown()


def test_all_replicas_dead_raises():
    srv = _replica("r0")
    srv.shutdown()
    router = _fast_router([_spec(srv)],
                          retry_policy=RetryPolicy(attempts=2,
                                                   base_delay_s=0.01),
                          strikes=1, probation_s=30.0)
    with pytest.raises((NoHealthyReplicasError, ConnectionError)):
        router.generate([1], max_new_tokens=2)


def test_drained_replica_is_shielded_then_readmitted():
    a, b = _replica("da"), _replica("db")
    try:
        router = _fast_router([_spec(a), _spec(b)])
        router.drain_replica("da")
        assert a._batcher.draining
        for i in range(3):
            assert router.generate([i + 1, 5], max_new_tokens=2).error is None
        assert a._batcher.stats.snapshot()["requests_completed"] == 0
        router.undrain_replica("da")
        assert not a._batcher.draining
        assert router.replica_stats()["da"]["draining"] is False
    finally:
        a.shutdown()
        b.shutdown()


def test_later_slices_are_refused_not_ignored():
    """The swap requests and a migrating GenerateRequest are served (a
    replica with no store answers ``no_swap_store``; a unified replica
    runs a request that names a decode target itself); the router's
    swap calls and a prefill+decode fleet run; ``tp_peers=`` makes the
    server a tensor-parallel replica's leader, its batcher dispatching
    to a :class:`ShardFollower` (the wire is
    ``tests/test_torch_port_tp_serving.py``'s)."""
    srv = _replica("r0")
    try:
        client = BasicClient("r0", [("127.0.0.1", srv.port)], KEY)
        for req in (SwapRequest(3), RollbackRequest(2)):
            resp = client.request(req, idempotent=False)
            assert isinstance(resp, SwapResponse)
            assert resp.error == "no_swap_store"
            assert resp.weights_version == 0
        resp = client.request(GenerateRequest(
            "m", [1, 2], max_new_tokens=3,
            migrate_to=("dec", [("127.0.0.1", 1)])), idempotent=False)
        assert resp.error is None and resp.migrated_to is None
        assert resp.tokens == greedy_reference(fixture()[2], [1, 2], 3)
        router = _fast_router([_spec(srv)])
        assert router.swap_replica("r0", 3).error == "no_swap_store"
        assert router.rollback_replica("r0", 2).error == "no_swap_store"
        pre = _replica("p", role="prefill")
        dec = _replica("d", role="decode")
        try:
            fleet = _fast_router([
                ReplicaSpec("p", [("127.0.0.1", pre.port)], role="prefill"),
                ReplicaSpec("d", [("127.0.0.1", dec.port)], role="decode")])
            out = fleet.generate([1, 2], max_new_tokens=2)
        finally:
            pre.shutdown()
            dec.shutdown()
        assert out.error is None and out.migrated_to == "d"
        assert out.tokens == greedy_reference(fixture()[2], [1, 2], 2)
        assert client.request(DrainRequest(cancel=True),
                              idempotent=False) is not None
    finally:
        srv.shutdown()
    batcher = ContinuousBatcher(InferenceEngine(fixture()[2],
                                                **ENGINE_DEFAULTS))
    shard = ShardServer(InferenceEngine(fixture()[2], **ENGINE_DEFAULTS),
                        KEY, name="x", host="127.0.0.1")
    try:
        leader = InferenceServer(batcher, key=KEY, host="127.0.0.1",
                                 start_batcher=False,
                                 tp_peers=[("x", [("127.0.0.1",
                                                   shard.port)])])
        leader.shutdown()
        assert isinstance(batcher._lockstep, ShardFollower)
        assert batcher._lockstep.n_shards == 1
    finally:
        shard.shutdown()


# --- prefix affinity ----------------------------------------------------------

def test_pick_prefers_resident_replica():
    router = _fast_router([ReplicaSpec("r0", [("127.0.0.1", 1)]),
                           ReplicaSpec("r1", [("127.0.0.1", 2)])])
    key = tuple(range(16))
    r1 = router._replicas[1]
    router._note_affinity(key, r1)
    for _ in range(4):
        assert router._pick(key) is r1
    r1.dead_until = time.monotonic() + 60.0
    assert router._pick(key) is router._replicas[0]
    r1.dead_until = None
    r1.inflight = router._affinity_slack + 1
    assert router._pick(key) is router._replicas[0]
    r1.inflight = 0
    assert router._pick(key) is r1
    assert router._prefix_key([1, 2, 3]) is None


def test_same_prefix_requests_land_on_one_replica():
    a, b = _replica("aff-a"), _replica("aff-b")
    try:
        router = _fast_router([_spec(a), _spec(b)])
        prompt = list(range(16))           # one full default block
        for i in range(4):
            resp = router.generate(prompt, max_new_tokens=2,
                                   request_id=f"aff-{i}")
            assert resp.error is None
        assert sorted(r.completed for r in router._replicas) == [0, 4]
    finally:
        a.shutdown()
        b.shutdown()


# --- chaos: a replica killed mid-decode ----------------------------------------

@pytest.mark.chaos
@pytest.mark.parametrize("spec", [False, True])
def test_replica_kill_mid_decode_fails_over(spec):
    """Kill a replica mid-decode (mid speculative decode too): every
    request completes on the survivor with the greedy tokens, none lost,
    none duplicated, and a replayed request id returns the cached
    response."""
    seed = int(os.environ.get("HVD_TPU_CHAOS_SEED", "0"))
    fault_step = int(os.environ.get("HVD_TPU_CHAOS_STEP", "3"))
    fault_step = fault_step % 10 if spec else fault_step
    model = fixture()[2]
    kw = ({"engine_kw": {"kv_cache": "paged", "kv_block": 4,
                         "drafter": model, "spec_k": 2}} if spec else {})
    a, b = _replica("replica-a", **kw), _replica("replica-b", **kw)
    try:
        router = _fast_router(
            [_spec(a), _spec(b)],
            retry_policy=RetryPolicy(attempts=10, base_delay_s=0.02,
                                     max_delay_s=0.2))
        responses = {}
        with faults.inject(f"serve:step={fault_step},seed={seed},mode=kill"):
            for i in range(6):
                rid = f"chaos-{i}"
                resp = router.generate([i + 1, i + 2, i + 3],
                                       max_new_tokens=6, request_id=rid,
                                       spec=spec)
                assert resp.error is None, (i, resp.error)
                assert resp.request_id == rid
                assert rid not in responses
                responses[rid] = resp
            kills = [h for h in faults.history() if h[0] == "serve"]
        assert kills == [("serve", fault_step, "kill")], kills
        assert sorted([a.dead, b.dead]) == [False, True]
        for i in range(6):
            assert responses[f"chaos-{i}"].tokens == greedy_reference(
                model, [i + 1, i + 2, i + 3], 6)
        again = router.generate([99], max_new_tokens=2, request_id="chaos-0")
        assert again is responses["chaos-0"]
    finally:
        a.shutdown()
        b.shutdown()
