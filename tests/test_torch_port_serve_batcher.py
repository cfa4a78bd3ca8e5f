"""The port's continuous batcher (``horovod_tpu_torch/serve/batcher.py``)
against the reference's (``horovod_tpu/serve/batcher.py``): the same
greedy traffic through both gives the same tokens, prefix hits and
pool statistics.  Then the reference's batcher tests
(``tests/test_serving.py::TestBatcher``, ``TestServeFaultSite``,
``TestChaosServeEvict``), with the stop-token test's stop token chosen
where it first appears (R2), the weight flip at a step boundary, and the
entry points that wait for later slices.
"""

import os
import random
import sys
import threading
import time

import pytest

from horovod_tpu import faults as jfaults
from horovod_tpu.serve import ContinuousBatcher as JaxBatcher
from horovod_tpu.serve import SamplingParams as JaxSampling

from horovod_tpu_torch import faults
from horovod_tpu_torch.config import parse_fault_spec
from horovod_tpu_torch.serve import (ContinuousBatcher, InferenceEngine,
                                     PromptTooLongError, QueueFullError,
                                     ReplicaKilledError, SamplingParams)
from horovod_tpu_torch.serve.engine import resolved_config

from torch_port_serve import (ENGINE_DEFAULTS, fixture, first_own_index,
                              greedy_reference, pump, torch_model)

pytestmark = pytest.mark.serving


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


def _batcher(model=None, **kw):
    kw.setdefault("max_queue", 8)
    kw.setdefault("default_deadline_s", 30.0)
    engine_kw = dict(ENGINE_DEFAULTS, **kw.pop("engine_kw", {}))
    model = model if model is not None else fixture()[2]
    return ContinuousBatcher(InferenceEngine(model, **engine_kw), **kw)


def test_traffic_matches_the_reference_batcher():
    """Six greedy requests over two paged slots, three sharing a
    prefix: the same tokens, prefix hits and pool statistics as the
    JAX batcher's."""
    from horovod_tpu.serve import InferenceEngine as JaxEngine

    jm, params, model = fixture()
    engine_kw = dict(ENGINE_DEFAULTS, kv_cache="paged", kv_block=4)
    jb = JaxBatcher(JaxEngine(jm, params, **engine_kw), max_queue=8,
                    default_deadline_s=0)
    pb = ContinuousBatcher(InferenceEngine(model, **engine_kw), max_queue=8,
                           default_deadline_s=0)
    pre = [21, 22, 23, 24, 25, 26]
    prompts = [pre + [1], [4, 5], pre + [2, 9], [7, 7, 7, 7, 7], pre + [3],
               list(range(1, 12))]
    out = {}
    for name, b, cls in (("port", pb, SamplingParams),
                         ("ref", jb, JaxSampling)):
        reqs = [b.submit(p, cls(max_new_tokens=5)) for p in prompts]
        pump(b, reqs)
        snap = b.snapshot()
        out[name] = ([(r.tokens, r.prefix_hit_tokens, r.error)
                      for r in reqs],
                     {k: snap[k] for k in (
                         "requests_completed", "tokens_out", "prefix_hits",
                         "prefix_hit_ratio", "kv_blocks_in_use",
                         "kv_blocks_cached", "kv_cow_copies_total",
                         "kv_prefix_hits_total", "kv_prefix_tokens_shared",
                         "active_slots", "queue_depth")})
    assert out["port"] == out["ref"]
    assert out["port"][1]["prefix_hits"] >= 2


def test_completes_more_requests_than_slots():
    model = fixture()[2]
    b = _batcher()
    reqs = [b.submit([i + 1, i + 2], SamplingParams(max_new_tokens=4))
            for i in range(6)]
    pump(b, reqs)
    for i, r in enumerate(reqs):
        assert r.error is None, (i, r.error)
        assert r.tokens == greedy_reference(model, [i + 1, i + 2], 4)
    snap = b.snapshot()
    assert snap["requests_completed"] == 6
    assert snap["occupancy_mean"] > 0
    assert snap["ttft_ms_p50"] > 0


def test_backpressure_rejects_when_full():
    b = _batcher(max_queue=2)
    b.submit([1], SamplingParams(max_new_tokens=2))
    b.submit([2], SamplingParams(max_new_tokens=2))
    with pytest.raises(QueueFullError):
        b.submit([3], SamplingParams(max_new_tokens=2))
    assert b.snapshot()["requests_rejected"] == 1


def test_deadline_expires_queued_request():
    b = _batcher()
    r = b.submit([1, 2], SamplingParams(max_new_tokens=4), deadline_s=0.01)
    time.sleep(0.05)
    b.step()
    assert r.done.is_set()
    assert r.error == "deadline_exceeded"
    assert b.snapshot()["requests_expired"] == 1


def test_deadline_expires_inflight_request():
    b = _batcher()
    r = b.submit([1, 2], SamplingParams(max_new_tokens=1000), deadline_s=0.2)
    b.step()               # admitted + first token
    assert not r.done.is_set()
    time.sleep(0.25)
    b.step()
    assert r.error == "deadline_exceeded"
    assert len(b.engine.free_slots()) == b.engine.max_slots


def test_stop_token_ends_generation():
    """The stop token is a generated token that appears nowhere before
    its own index, so generation must end exactly there.  The
    reference's test takes ``ref[2]`` of prompt [7, 8], whose greedy
    run here repeats one token, so it stops after one (R2); prompt [1]
    has a token first seen at index 2 or later."""
    model = fixture()[2]
    prompt = [1]
    ref = greedy_reference(model, prompt, 8)
    i = first_own_index(ref, start=2)
    assert i is not None, ref
    b = _batcher()
    r = b.submit(prompt, SamplingParams(max_new_tokens=8, stop_token=ref[i]))
    pump(b, [r])
    assert r.tokens == ref[:i + 1]   # stop token included, then ends


def test_boundary_length_prompt_rejected_at_submit():
    b = _batcher(engine_kw={"prefill_buckets": (32,)})
    with pytest.raises(PromptTooLongError):
        b.submit(list(range(32)), SamplingParams(max_new_tokens=2))
    assert b.queue_depth() == 0


def test_cancel_frees_queue_entry_and_slot():
    b = _batcher()   # 2 slots
    running = [b.submit([i + 1], SamplingParams(max_new_tokens=10))
               for i in range(2)]
    b.step()
    b.step()
    assert len(b.engine.free_slots()) == 0
    queued = b.submit([9], SamplingParams(max_new_tokens=10))
    assert b.cancel(queued.request_id) is True
    assert queued.error == "cancelled" and queued.done.is_set()
    assert b.queue_depth() == 0
    assert b.cancel(running[0].request_id) is True
    assert running[0].error == "cancelled"
    assert b.cancel("no-such-request") is False
    assert len(b.engine.free_slots()) == 1
    pump(b, [running[1]])
    assert running[1].error is None and len(running[1].tokens) == 10


def test_cancel_from_another_thread_mid_decode():
    """Handler threads cancel while the batcher thread decodes: the
    slot comes back, the survivor finishes exactly."""
    model = fixture()[2]
    b = _batcher(engine_kw={"kv_cache": "paged", "kv_block": 4})
    step = b.engine.step

    def slow_step():
        time.sleep(0.02)   # 25 decodes outlast the cancel by far
        return step()

    b.engine.step = slow_step
    doomed = b.submit([3, 3, 3], SamplingParams(max_new_tokens=25))
    keep = b.submit([4, 5], SamplingParams(max_new_tokens=12))
    b.start()
    try:
        while len(doomed.tokens) < 2:
            time.sleep(0.001)
        t = threading.Thread(target=b.cancel, args=(doomed.request_id,))
        t.start()
        t.join()
        assert keep.done.wait(30)
    finally:
        b.stop()
    assert doomed.error == "cancelled"
    assert keep.tokens == greedy_reference(model, [4, 5], 12)
    assert b.engine.kv_stats()["kv_blocks_in_use"] == 0


def test_concurrent_submit_and_cancel_keep_the_pool_whole():
    """More client threads than cores submit and cancel against the
    running batcher with a short switch interval: every request ends
    exactly once, whole (the greedy tokens) or cancelled, and every slot
    and block comes back."""
    model = fixture()[2]
    b = _batcher(max_queue=64, engine_kw={"kv_cache": "paged", "kv_block": 4})
    n_threads = 2 * len(os.sched_getaffinity(0))
    results, lock = [], threading.Lock()

    def client(i):
        rng = random.Random(i)
        for j in range(3):
            r = b.submit([1 + (i + j) % 40, 2, 3],
                         SamplingParams(max_new_tokens=rng.randint(2, 8)))
            if rng.random() < 0.4:
                time.sleep(rng.random() * 0.002)
                b.cancel(r.request_id)
            if r.done.wait(60):
                with lock:
                    results.append(r)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    b.start()
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        b.stop()
    assert len(results) == 3 * n_threads
    assert len({r.request_id for r in results}) == len(results)
    refs = {}
    for r in results:
        assert r.error in (None, "cancelled"), r.error
        if r.error is None:
            key = (tuple(r.prompt), r.sampling.max_new_tokens)
            if key not in refs:
                refs[key] = greedy_reference(model, r.prompt, key[1])
            assert r.tokens == refs[key]
    assert b.engine.kv_stats()["kv_blocks_in_use"] == 0
    assert len(b.engine.free_slots()) == b.engine.max_slots


def test_max_new_tokens_capped_by_config():
    b = _batcher()
    r = b.submit([1], SamplingParams(max_new_tokens=10 ** 6))
    assert r.sampling.max_new_tokens == resolved_config().serve_max_new_tokens


def test_admission_interleaves_with_decode():
    b = _batcher()
    long_req = b.submit([1, 2, 3], SamplingParams(max_new_tokens=12))
    b.step()
    late = b.submit([4, 5], SamplingParams(max_new_tokens=2))
    b.step()
    assert late.first_token_at is not None
    assert not long_req.done.is_set()
    pump(b, [long_req, late])
    assert long_req.error is None and late.error is None


def test_batcher_snapshot_carries_kv_and_prefix_stats():
    model = fixture()[2]
    b = _batcher(engine_kw={"kv_cache": "paged", "kv_block": 4})
    pre = [21, 22, 23, 24, 25, 26, 27, 28]
    r1 = b.submit(pre + [1], SamplingParams(max_new_tokens=3))
    pump(b, [r1])
    r2 = b.submit(pre + [2], SamplingParams(max_new_tokens=3))
    pump(b, [r2])
    assert r2.prefix_hit_tokens >= 8
    snap = b.snapshot()
    assert snap["prefix_hits"] == 1
    assert snap["prefix_hit_ratio"] == 0.5
    assert snap["kv_prefix_hits_total"] >= 1
    assert snap["kv_blocks_in_use"] == 0
    assert r2.tokens == greedy_reference(model, pre + [2], 3)


def test_weight_flip_runs_at_a_step_boundary():
    """A flip waits for the in-flight generation to finish on the old
    weights, holds admission meanwhile, then serves the new version."""
    jm, params, model = fixture()
    import jax
    import numpy as np

    new = jax.tree.map(np.asarray, params)
    new["lm_head"]["kernel"] = new["lm_head"]["kernel"] * 1.5
    b = _batcher(model=torch_model(params),
                 engine_kw={"kv_cache": "paged", "kv_block": 4})
    first = b.submit([5, 6, 7], SamplingParams(max_new_tokens=6))
    b.step()
    b.engine.stage_params(new, version=7)
    holder = {}
    t = threading.Thread(target=lambda: holder.setdefault(
        "v", b.flip_at_barrier(b.engine.commit_staged, timeout=30)))
    t.start()
    while b.snapshot()["swap_pending"] is False:
        time.sleep(0.001)
    second = b.submit([5, 6, 7], SamplingParams(max_new_tokens=6))
    pump(b, [first, second])
    t.join(10)
    assert holder["v"] == 7
    assert first.weights_version == 0 and second.weights_version == 7
    assert first.tokens == greedy_reference(model, [5, 6, 7], 6)
    assert second.tokens == greedy_reference(torch_model(new), [5, 6, 7], 6)
    assert b.snapshot()["swaps_completed"] == 1


def test_prefill_role_without_migrator_serves_itself():
    model = fixture()[2]
    b = _batcher(role="prefill")
    assert b.role == "prefill"
    r = b.submit([2, 3], SamplingParams(max_new_tokens=4))
    pump(b, [r])
    assert r.tokens == greedy_reference(model, [2, 3], 4)
    with pytest.raises(ValueError, match="role"):
        _batcher(role="router")


def test_fleet_and_tensor_parallel_hooks_wait_for_their_slices():
    """The fleet's hooks are ported (the migrator installs; ``adopt``
    refuses a dense cache as the reference's does), and so is
    tensor-parallel lockstep: ``set_lockstep`` installs the follower
    dispatch (its wire is ``tests/test_torch_port_tp_serving.py``'s)."""
    b = _batcher()
    migrator = lambda *a: True  # noqa: E731
    b.set_migrator(migrator)
    assert b._migrator is migrator
    lockstep = lambda *a: []  # noqa: E731
    b.set_lockstep(lockstep)
    assert b._lockstep is lockstep
    manifest = {"request_id": "m", "prompt": [1, 2], "tokens": [3],
                "sampling": {"max_new_tokens": 2, "temperature": 0.0,
                             "top_k": 0, "stop_token": None,
                             "spec": False}}
    with pytest.raises(ValueError, match="paged"):
        _batcher(engine_kw={"kv_cache": "dense"}).adopt(manifest, None,
                                                        None)


# --- the serve fault site -----------------------------------------------------

def test_serve_spec_parses():
    c = parse_fault_spec("serve:step=3,mode=kill")["serve"]
    assert (c.step, c.mode) == (3, "kill")
    c = parse_fault_spec("serve:p=0.2,seed=5,mode=drop")["serve"]
    assert (c.p, c.seed, c.mode) == (0.2, 5, "drop")
    with pytest.raises(ValueError, match="mode"):
        parse_fault_spec("serve:step=1,mode=corrupt")


def test_kill_fires_at_the_decode_dispatch():
    """``serve:mode=kill`` at decode event 2: the batcher dies, every
    queued and in-flight request fails back ``replica_killed`` once,
    new work is refused."""
    b = _batcher()
    reqs = [b.submit([i + 1, 2], SamplingParams(max_new_tokens=8))
            for i in range(3)]
    with faults.inject("serve:step=2,mode=kill"):
        with pytest.raises(ReplicaKilledError):
            for _ in range(20):
                b.step()
        assert faults.history() == [("serve", 2, "kill")]
    assert b.dead
    assert all(r.error == "replica_killed" for r in reqs)
    with pytest.raises(ReplicaKilledError):
        b.submit([1], SamplingParams())
    assert b.snapshot()["requests_failed"] == 3


@pytest.mark.chaos
def test_evict_pressure_never_serves_stale_blocks():
    """``serve:mode=evict`` at an allocation event: an evicted then
    readmitted prefix recomputes, never serves stale blocks."""
    seed = int(os.environ.get("HVD_TPU_CHAOS_SEED", "0"))
    fault_step = int(os.environ.get("HVD_TPU_CHAOS_STEP", "3")) % 8
    model = fixture()[2]
    b = _batcher(engine_kw={"kv_cache": "paged", "kv_block": 4})
    pre = [31, 32, 33, 34, 35, 36, 37, 38]
    prime = b.submit(pre + [88], SamplingParams(max_new_tokens=4))
    pump(b, [prime])
    with faults.inject(f"serve:step={fault_step},seed={seed},mode=evict"):
        for i in range(8):
            prompt = pre + [i + 1]
            r = b.submit(prompt, SamplingParams(max_new_tokens=4))
            pump(b, [r])
            assert r.error is None, (i, r.error)
            assert r.tokens == greedy_reference(model, prompt, 4), i
        evicts = [h for h in faults.history()
                  if h[0] == "serve" and h[2].startswith("evict")]
    assert evicts == [("serve", fault_step, "evict")], evicts
    assert b.snapshot()["kv_evictions_total"] > 0
