"""The port's serving engine and GPT's KV-cache paths against the JAX
reference (``horovod_tpu/serve/engine.py``,
``horovod_tpu/models/transformer.py``), on the reference's serving
fixture (2 layers, d_model 32, 2 heads, vocab 97, f32) with the same
weights.

Held: the cache paths' logits and K/V within 1e-5 of flax's (dense and
paged, a prompt ending mid-block whose padding reads the trash rows);
greedy tokens identical to the JAX engine's on the dense, paged and
speculative paths (self-drafter and a bad drafter), at mixed depths,
through copy-on-write and eviction, with the same pool bookkeeping; a
decode's logits within 1e-5; then the reference's engine tests
(``tests/test_serving.py``) on the port's engine against the port's
full-forward argmax loop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models.transformer import init_kv_cache as jax_init_kv_cache
from horovod_tpu.serve.engine import InferenceEngine as JaxEngine
from horovod_tpu.serve.engine import SamplingParams as JaxSampling

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import GPT, GPTConfig
from horovod_tpu_torch.models.transformer import init_kv_cache
from horovod_tpu_torch.serve import (InferenceEngine, PromptTooLongError,
                                     SamplingParams)

from torch_port_serve import (CFG, ENGINE_DEFAULTS, VOCAB, fixture,
                              greedy_reference, jax_pair, run_engine,
                              torch_model)

pytestmark = pytest.mark.serving

TOL = 1e-5


def _engine(**kw):
    _, _, model = fixture()
    kw = dict(ENGINE_DEFAULTS, **kw)
    return InferenceEngine(model, **kw)


def _jax_engine(**kw):
    jm, params, _ = fixture()
    kw = dict(ENGINE_DEFAULTS, **kw)
    return JaxEngine(jm, params, **kw)


def _run(engine, slot, prompt, n, **kw):
    return run_engine(engine, slot, prompt, n, SamplingParams, **kw)


def _jrun(engine, slot, prompt, n, **kw):
    return run_engine(engine, slot, prompt, n, JaxSampling, **kw)


def _close(a, b, tol=TOL):
    a = np.asarray(a, np.float32)
    b = np.asarray(b.detach() if torch.is_tensor(b) else b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a - b).max()) if a.size else 0.0
    assert err <= tol, err


# --- GPT's KV-cache paths -----------------------------------------------------

def test_dense_cache_prefill_and_decode_match_flax():
    """Prefill a [2, 8] chunk into a dense cache, then decode one token
    a row at different depths: logits and both caches within 1e-5."""
    jm, params, model = fixture()
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, VOCAB, (2, 8)).astype(np.int32)
    pos = np.tile(np.arange(8, dtype=np.int32), (2, 1))
    jcache = jax_init_kv_cache(jm.config, 2, 16)
    jlog, jcache = jm.apply({"params": params}, jnp.asarray(tokens),
                            kv_caches=jcache, positions=jnp.asarray(pos))
    cache = init_kv_cache(model.config, 2, 16, device="cpu")
    with torch.inference_mode():
        log, cache = model(torch.from_numpy(tokens).long(), kv_caches=cache,
                           positions=torch.from_numpy(pos).long())
    _close(jlog, log)
    for jc, c in zip(jcache, cache):
        _close(jc["k"], c["k"])
        _close(jc["v"], c["v"])
    step = rng.randint(0, VOCAB, (2, 1)).astype(np.int32)
    dpos = np.array([[8], [5]], np.int32)
    jlog, jcache = jm.apply({"params": params}, jnp.asarray(step),
                            kv_caches=jcache, positions=jnp.asarray(dpos))
    with torch.inference_mode():
        log, cache = model(torch.from_numpy(step).long(), kv_caches=cache,
                           positions=torch.from_numpy(dpos).long())
    _close(jlog, log)
    for jc, c in zip(jcache, cache):
        _close(jc["k"], c["k"])


def test_paged_prompt_ending_mid_block_reads_clamped_trash_rows():
    """A prompt of 6 tokens in an 8-bucket with 4-token blocks: rows 6
    and 7 route to the trash column (view position 35, past the
    32-row positional table).  JAX clamps that embedding read; the port
    clamps it explicitly — no index error, and the valid rows' logits
    and the chunk's K/V within 1e-5 of flax's."""
    jm, params, model = fixture()
    blk, n_blocks, bps = 4, 12, 8
    sv = (bps + 1) * blk
    rng = np.random.RandomState(1)
    h, d = CFG["n_head"], CFG["d_model"] // CFG["n_head"]
    pools = [(rng.randn(n_blocks, blk, h, d).astype(np.float32),
              rng.randn(n_blocks, blk, h, d).astype(np.float32))
             for _ in range(CFG["n_layer"])]
    table = np.zeros((1, bps + 1), np.int32)
    table[0, :2] = [3, 7]
    tokens = rng.randint(0, VOCAB, (1, 8)).astype(np.int32)
    idx = np.arange(8)
    pos = np.where(idx < 6, idx, sv - 1).astype(np.int32)[None]
    assert pos.max() >= CFG["max_seq_len"]
    jcaches = [{"k_pool": jnp.asarray(k), "v_pool": jnp.asarray(v),
                "table": jnp.asarray(table)} for k, v in pools]
    jlog, jchunk = jm.apply({"params": params}, jnp.asarray(tokens),
                            kv_caches=jcaches, positions=jnp.asarray(pos))
    caches = [{"k_pool": torch.from_numpy(k), "v_pool": torch.from_numpy(v),
               "table": torch.from_numpy(table).long()} for k, v in pools]
    with torch.inference_mode():
        log, chunk = model(torch.from_numpy(tokens).long(), kv_caches=caches,
                           positions=torch.from_numpy(pos).long())
    _close(np.asarray(jlog)[:, :6], log[:, :6])
    for jc, c in zip(jchunk, chunk):
        _close(jc["k"], c["k"])
        _close(jc["v"], c["v"])
    # The pools themselves are untouched by the model (the engine
    # scatters the chunk).
    for (k, _), c in zip(pools, caches):
        assert np.array_equal(k, c["k_pool"].numpy())
    # And through the engine: the same prompt prefills with no error.
    eng = _engine(kv_cache="paged", kv_block=blk)
    prompt = [int(t) for t in tokens[0, :6]]
    assert _run(eng, 0, prompt, 4) == greedy_reference(model, prompt, 4)


def test_cache_path_refuses_sequence_attentions_and_needs_positions():
    _, params, _ = fixture()
    ring = torch_model(params, {"attention": "ring"})
    cache = init_kv_cache(ring.config, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="KV-cache decode"):
        ring(torch.zeros((1, 2), dtype=torch.long), kv_caches=cache,
             positions=torch.zeros((1, 2), dtype=torch.long))
    _, _, model = fixture()
    with pytest.raises(ValueError, match="positions"):
        model(torch.zeros((1, 2), dtype=torch.long), kv_caches=cache)


def test_tensor_parallel_replica_not_ported_yet():
    with pytest.raises(NotImplementedError, match="queue A item 4"):
        _engine(tp=2)


# --- the port's engine against the JAX engine --------------------------------

def _mixed_depth(engine, run_cls):
    """The reference's mixed-depth interleaving (test_paged_matches_
    dense_mixed_depth): slot 0 four deep when slot 1 starts."""
    p0, p1 = [3, 1, 4, 1, 5], [9, 2, 6]
    a = [engine.start(0, p0, run_cls(max_new_tokens=8))]
    for _ in range(3):
        a.extend(engine.step()[0])
    b = [engine.start(1, p1, run_cls(max_new_tokens=4))]
    for _ in range(3):
        toks = engine.step()
        a.extend(toks[0])
        b.extend(toks[1])
    return a, b


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_mixed_depth_tokens_and_caches_match_jax_engine(kv):
    """Greedy tokens identical to the JAX engine's; the caches (dense
    rows or paged pools) within 1e-5; the block tables, the pool's
    stats and the first-call counts identical."""
    kw = {"kv_cache": kv, "kv_block": 4}
    je, pe = _jax_engine(**kw), _engine(**kw)
    assert _mixed_depth(pe, SamplingParams) == _mixed_depth(je, JaxSampling)
    if kv == "paged":
        assert np.array_equal(je._table, pe._table)
        for jp, p in zip(je._pools, pe._pools):
            _close(jp["k"], p["k"])
            _close(jp["v"], p["v"])
    else:
        for jc, c in zip(je._caches, pe._caches):
            _close(jc["k"], c["k"])
            _close(jc["v"], c["v"])
    assert pe.kv_stats() == je.kv_stats()
    assert dict(pe.trace_counts) == dict(je.trace_counts)


def test_decode_logits_within_tolerance_of_jax_engine():
    """After the same two prefills, one decode's logits over the paged
    pools: the port's within 1e-5 of the reference's."""
    kw = {"kv_cache": "paged", "kv_block": 4}
    je, pe = _jax_engine(**kw), _engine(**kw)
    for eng, cls in ((je, JaxSampling), (pe, SamplingParams)):
        eng.start(0, [3, 1, 4, 1, 5], cls(max_new_tokens=8))
        eng.start(1, [9, 2, 6, 5, 3, 5, 8, 9, 7], cls(max_new_tokens=8))
    jm, params, model = fixture()
    toks = np.array([je._last_tokens[0], je._last_tokens[1]], np.int32)
    pos = np.array([5, 9], np.int32)
    jlog, _ = jm.apply({"params": params}, jnp.asarray(toks[:, None]),
                       kv_caches=je._paged_caches(je._pools,
                                                  jnp.asarray(je._table)),
                       positions=jnp.asarray(pos[:, None]))
    with torch.inference_mode():
        log, _ = model(torch.from_numpy(toks[:, None]).long(),
                       kv_caches=pe._paged_caches(
                           torch.from_numpy(pe._table).long()),
                       positions=torch.from_numpy(pos[:, None]).long())
    _close(jlog, log)
    assert pe.step() == je.step()


@pytest.mark.parametrize("drafter", ["self", "bad"])
@pytest.mark.parametrize("k", [1, 4])
def test_speculative_tokens_match_jax_engine(drafter, k):
    """Speculative decoding with the target as its own drafter and with
    an unrelated 1-layer drafter: the same tokens as the JAX engine's,
    the same acceptance counters."""
    jm, params, model = fixture()
    if drafter == "self":
        jd, td = (jm, params), model
    else:
        dcfg = {"n_layer": 1, "d_model": 16, "d_ff": 32}
        djm, dparams = jax_pair(dcfg, seed=99)
        jd, td = (djm, dparams), torch_model(dparams, dcfg)
    kw = {"kv_cache": "paged", "kv_block": 4, "spec_k": k}
    je = _jax_engine(drafter=jd, **kw)
    pe = _engine(drafter=td, **kw)
    for prompt in ([3, 14, 15], list(range(10))):
        got = _run(pe, 0, prompt, 7, spec=True)
        assert got == _jrun(je, 0, prompt, 7, spec=True), prompt
        assert got == greedy_reference(model, prompt, 7)
    assert pe.kv_stats() == je.kv_stats()


def test_cow_and_eviction_bookkeeping_match_jax_engine():
    """Shared prefixes diverging (COW), then distinct prefixes on a
    floor-sized pool (eviction): the same tokens, tables, prefix probes
    and pool stats as the JAX engine after every request."""
    kw = {"kv_cache": "paged", "kv_block": 4, "kv_blocks": 1 + 2 * 8}
    je, pe = _jax_engine(**kw), _engine(**kw)
    pre = [11, 12, 13, 14, 15, 16]
    prompts = [pre + [1], pre + [2]] + [
        [(50 + 9 * i + j) % VOCAB for j in range(9)] for i in range(6)]
    prompts.append(pre + [1])
    for i, prompt in enumerate(prompts):
        slot = i % 2
        assert _run(pe, slot, prompt, 4) == _jrun(je, slot, prompt, 4), i
        assert np.array_equal(pe._table, je._table)
        assert pe.kv_stats() == je.kv_stats(), i
        assert pe.prefix_probe(pre + [1]) == je.prefix_probe(pre + [1])
    stats = pe.kv_stats()
    assert stats["kv_cow_copies_total"] > 0
    assert stats["kv_evictions_total"] > 0


def test_temperature_sampling_reproduces_within_the_port():
    """The port draws from a torch.Generator seeded from ``seed``: the
    same seed gives the same tokens, another seed others (the JAX
    engine's PRNG stream has no bitwise torch twin)."""
    def run(seed):
        eng = _engine(seed=seed)
        return _run(eng, 0, [9, 8, 7], 8, temperature=0.9, top_k=20)

    assert run(7) == run(7)
    assert run(7) != run(8)


def test_export_rng_and_import_slot_kv_continue_token_identically():
    """Export a slot's KV and the generator state after prefill, import
    both into a second engine: its generation equals the first
    engine's uninterrupted one (greedy and at temperature)."""
    for temp in (0.0, 0.8):
        a = _engine(kv_cache="paged", kv_block=4, max_slots=1, seed=3)
        b = _engine(kv_cache="paged", kv_block=4, max_slots=1, seed=11)
        prompt = [5, 11, 17, 23, 29, 2]
        sp = SamplingParams(max_new_tokens=10, temperature=temp)
        first = a.start(0, prompt, sp)
        n_blocks, k, v = a.export_slot_kv(0)
        assert n_blocks == 2 and tuple(k.shape[:2]) == (CFG["n_layer"], 2)
        rng = a.export_rng()
        b.import_slot_kv(0, prompt, k, v, first, sp, rng=rng)
        want, got = [first], [first]
        for _ in range(9):
            want.extend(a.step()[0])
            got.extend(b.step()[0])
        assert got == want, temp
        assert b.trace_counts["kv_import"] == 1


def test_staged_weights_flip_and_flush_the_prefix_cache():
    """stage → commit re-points the parameters (a new version serves
    the new weights' tokens and the old prefix cache is flushed);
    discard leaves the live weights alone."""
    jm, params, model = fixture()
    new = jax.tree.map(np.asarray, params)
    new["embed"]["embedding"] = new["embed"]["embedding"] + 0.01
    fresh = torch_model(new)
    eng = InferenceEngine(torch_model(params), **ENGINE_DEFAULTS,
                          kv_cache="paged", kv_block=4)
    prompt = [5, 11, 17, 23, 4, 4]
    old = _run(eng, 0, prompt, 6)
    assert eng.prefix_probe(prompt) > 0
    eng.stage_params(new, version=3)
    assert eng.staged_version() == 3
    eng.discard_staged()
    assert eng.staged_version() is None and eng.weights_version == 0
    eng.stage_params(new, version=3)
    assert eng.commit_staged() == 3
    assert eng.weights_version == 3
    assert eng.prefix_probe(prompt) == 0
    assert _run(eng, 0, prompt, 6) == greedy_reference(fresh, prompt, 6)
    assert old == greedy_reference(model, prompt, 6)
    with pytest.raises(RuntimeError, match="no staged"):
        eng.commit_staged()
    with pytest.raises(ValueError, match="missing"):
        eng.stage_params({"pos_embed": new["pos_embed"]}, version=4)


# --- the reference's engine tests (tests/test_serving.py) ---------------------

def test_greedy_decode_matches_full_forward_argmax():
    _, _, model = fixture()
    engine = _engine()
    for prompt in ([3, 14, 15, 92, 6], [1], list(range(10))):
        assert _run(engine, 0, prompt, 6) == \
            greedy_reference(model, prompt, 6), prompt


def test_bucketing_bounds_recompiles():
    """The port's counterpart of a trace is a program's first call on a
    shape: one per prefill bucket and one decode."""
    engine = _engine(kv_cache="dense")
    _run(engine, 0, [1, 2, 3], 3)        # bucket 8
    _run(engine, 0, [4, 5, 6, 7, 8], 3)  # bucket 8 again
    _run(engine, 1, list(range(12)), 3)  # bucket 16
    assert engine.trace_counts == {"prefill_8": 1, "prefill_16": 1,
                                   "decode": 1}, engine.trace_counts


def test_prompt_too_long_raises():
    engine = _engine()
    with pytest.raises(PromptTooLongError):
        engine.start(0, list(range(17)), SamplingParams())
    with pytest.raises(PromptTooLongError):
        engine.bucket_for(100)


def test_top_k_one_equals_greedy():
    engine = _engine()
    greedy = _run(engine, 0, [5, 6, 7], 6)
    assert _run(engine, 0, [5, 6, 7], 6, temperature=1.3, top_k=1) == greedy


def test_slot_reuse_does_not_leak_stale_cache():
    _, _, model = fixture()
    for kv in ("dense", "paged"):
        engine = _engine(kv_cache=kv, kv_block=4)
        _run(engine, 0, list(range(10)), 5)   # dirty the slot
        assert _run(engine, 0, [2, 4, 6], 5) == \
            greedy_reference(model, [2, 4, 6], 5)


def test_mixed_depth_batch_decodes_independently():
    _, _, model = fixture()
    a, b = _mixed_depth(_engine(kv_cache="dense"), SamplingParams)
    assert a[:7] == greedy_reference(model, [3, 1, 4, 1, 5], 7)
    assert b == greedy_reference(model, [9, 2, 6], 4)


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_generation_uses_every_cache_position(kv):
    """Prompt n in an S-position cache yields S - n + 1 tokens."""
    engine = _engine(kv_cache=kv, kv_block=5)
    toks = [engine.start(0, [1, 2], SamplingParams(max_new_tokens=10 ** 6))]
    while not engine.slot_full(0):
        toks.extend(engine.step()[0])
    assert len(toks) == engine.max_seq_len - 2 + 1


def test_timeline_records_serving_phases(tmp_path):
    path = str(tmp_path / "serve_timeline.json")
    hvd.init(device="cpu")
    try:
        hvd.start_timeline(path)
        _run(_engine(), 0, [1, 2, 3], 3)
    finally:
        hvd.shutdown()
    text = open(path).read()
    assert "SERVE_PREFILL" in text
    assert "SERVE_DECODE" in text


def test_paged_matches_dense_mixed_depth():
    dense = _mixed_depth(_engine(kv_cache="dense"), SamplingParams)
    paged = _mixed_depth(_engine(kv_cache="paged", kv_block=4),
                         SamplingParams)
    assert paged == dense


def test_block_not_aligned_to_seq_len():
    _, _, model = fixture()
    eng = _engine(kv_cache="paged", kv_block=5)
    assert _run(eng, 0, [7, 3, 9], 6) == greedy_reference(model, [7, 3, 9], 6)


def test_cow_when_shared_prefix_diverges():
    _, _, model = fixture()
    eng = _engine(kv_cache="paged", kv_block=4)
    pre = [11, 12, 13, 14, 15, 16]
    pa, pb = pre + [1], pre + [2]
    assert _run(eng, 0, pa, 5) == greedy_reference(model, pa, 5)
    stats0 = eng.kv_stats()
    assert _run(eng, 1, pb, 5) == greedy_reference(model, pb, 5)
    stats1 = eng.kv_stats()
    assert stats1["kv_prefix_hits_total"] > stats0["kv_prefix_hits_total"]
    assert stats1["kv_cow_copies_total"] > stats0["kv_cow_copies_total"]
    assert eng.trace_counts["kv_copy"] == 1


def test_cow_between_two_live_requests():
    _, _, model = fixture()
    eng = _engine(kv_cache="paged", kv_block=4)
    pa = [5, 6, 7, 8, 9]
    pb = [5, 6, 7, 8, 9, 3]
    a = [eng.start(0, pa, SamplingParams(max_new_tokens=8))]
    a.extend(eng.step()[0])       # slot 0 writes INTO the tail block
    b = [eng.start(1, pb, SamplingParams(max_new_tokens=6))]
    assert eng.prefix_hit_tokens(1) == 5
    for _ in range(4):
        toks = eng.step()
        a.extend(toks[0])
        b.extend(toks[1])
    assert a[:6] == greedy_reference(model, pa, 6)
    assert b[:5] == greedy_reference(model, pb, 5)
    assert eng.kv_stats()["kv_cow_copies_total"] >= 1


def test_eviction_under_pressure_recomputes():
    _, _, model = fixture()
    eng = _engine(kv_cache="paged", kv_block=4, kv_blocks=1 + 2 * 8)
    first = [40, 41, 42, 43, 44, 45, 46, 47, 48]
    got = _run(eng, 0, first, 4)
    assert got == greedy_reference(model, first, 4)
    assert eng.prefix_probe(first) > 0
    for i in range(8):
        _run(eng, 0, [(50 + 9 * i + j) % VOCAB for j in range(9)], 4)
    assert eng.kv_stats()["kv_evictions_total"] > 0
    assert eng.prefix_probe(first) == 0
    assert _run(eng, 0, first, 4) == got


def test_pool_budget_floor_validated():
    with pytest.raises(ValueError, match="floor"):
        _engine(kv_cache="paged", kv_block=4, kv_blocks=8)


def test_out_of_vocab_prompt_rejected_at_admission():
    eng = _engine(kv_cache="paged", kv_block=4)
    with pytest.raises(ValueError, match="vocabulary"):
        eng.start(0, [1, 2, VOCAB], SamplingParams())
    with pytest.raises(ValueError, match="vocabulary"):
        eng.start(0, [-1], SamplingParams())
    assert eng.kv_stats()["kv_blocks_in_use"] == 0


@pytest.mark.parametrize("k", [1, 2, 4])
def test_greedy_identity_self_drafter(k):
    _, _, model = fixture()
    eng = _engine(kv_cache="paged", kv_block=4, drafter=model, spec_k=k)
    for prompt in ([3, 14, 15], [1], list(range(10))):
        assert _run(eng, 0, prompt, 7, spec=True) == \
            greedy_reference(model, prompt, 7), (k, prompt)
    assert eng.kv_stats()["spec_accept_per_verify"] == k + 1


def test_mixed_spec_and_plain_slots_share_the_batch():
    _, _, model = fixture()
    eng = _engine(kv_cache="paged", kv_block=4, drafter=model, spec_k=3)
    a = [eng.start(0, [3, 1, 4], SamplingParams(max_new_tokens=9, spec=True))]
    b = [eng.start(1, [9, 2], SamplingParams(max_new_tokens=9,
                                             temperature=0.8, top_k=10))]
    for _ in range(8):
        toks = eng.step()
        a.extend(toks.get(0, []))
        b.extend(toks.get(1, []))
        if len(a) >= 9 and len(b) >= 3:
            break
    assert a[:9] == greedy_reference(model, [3, 1, 4], 9)
    assert len(b) >= 3 and all(0 <= t < VOCAB for t in b)
    assert len(b) < len(a)
    assert eng.kv_stats()["spec_accept_per_verify"] == 4.0


def test_spec_cap_at_cache_end_is_exact():
    """A burst never writes past the cache; the drafter's last draft
    rows past its dense cache drop their writes, as JAX's do."""
    _, _, model = fixture()
    eng = _engine(kv_cache="paged", kv_block=4, drafter=model, spec_k=4,
                  max_seq_len=16, prefill_buckets=(8,))
    prompt = [1, 2]
    toks = [eng.start(0, prompt, SamplingParams(max_new_tokens=10 ** 6,
                                                spec=True))]
    while not eng.slot_full(0):
        toks.extend(eng.step()[0])
    want_n = eng.max_seq_len - len(prompt) + 1
    assert len(toks) == want_n
    assert toks == greedy_reference(model, prompt, want_n)


def test_spec_requires_paged_and_a_matching_drafter():
    _, _, model = fixture()
    with pytest.raises(ValueError, match="paged"):
        _engine(kv_cache="dense", drafter=model)
    other = GPT(GPTConfig(**dict(CFG, vocab_size=VOCAB + 1),
                          dtype=torch.float32), device="cpu")
    with pytest.raises(ValueError, match="vocabulary"):
        _engine(kv_cache="paged", drafter=other)


def test_paged_and_spec_paths_run_under_deterministic_algorithms():
    """The trash block takes duplicate scatter indices (every padding
    row of a prefill, every rejected draft row); with deterministic
    algorithms on, no op of the paged or speculative path refuses, and
    the valid rows' tokens are unchanged."""
    _, _, model = fixture()
    want = greedy_reference(model, [3, 1, 4, 1, 5, 9], 9)
    torch.use_deterministic_algorithms(True)
    try:
        for kw in ({}, {"drafter": model, "spec_k": 3}):
            eng = _engine(kv_cache="paged", kv_block=4, **kw)
            assert _run(eng, 0, [3, 1, 4, 1, 5, 9], 9,
                        spec=bool(kw)) == want
    finally:
        torch.use_deterministic_algorithms(False)
