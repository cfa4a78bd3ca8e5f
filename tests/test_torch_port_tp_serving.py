"""Tensor-parallel serving replicas: the port's head-sharded engine
(``InferenceEngine(tp=, devices=)``, ``models.transformer.
tensor_parallel_replica``), ``serve/tp.py``'s lockstep wire, per-shard
KV migration and the swap's shard pull, against the JAX reference.

``tests/test_tp_serving.py``'s cases on the port, case for case and with
its markers (the tp = 4 twins of the engine-heavy oracle cases on the
slow tier), at its sizes: vocab 97, 2 layers, 4 heads, d_model 32, f32,
weights from ``PRNGKey(0)`` converted by ``load_jax_params``, the shards
on ``devices=["cpu"] * tp``.  Beside them: the port's tp = 2 greedy
tokens equal the JAX engine's at tp = 1 and tp = 2 (the JAX engine on
the 8 forced host devices of ``tests/conftest.py``); the port's tp = 2
logits equal its tp = 1 logits bit for bit for prefill, decode and the
speculative verify; a tp = 2 sender migrating to a tp = 1 receiver and
back; a tp = 2 engine pulling a swap by shards; the single-strike
failover of a lockstep replica behind a ``Router`` in one process; and
the public names of ``serve`` and ``serve.fleet``.  Sampled tokens are
compared within the port only: the two packages' sampling streams
differ on purpose (``ROADMAP.md``, "Sampling draws from a
``torch.Generator``").
"""

import functools

import numpy as np
import pytest
import torch

import horovod_tpu.plan as jax_plan
import horovod_tpu.serve as jax_serve
import horovod_tpu.serve.fleet as jax_fleet
from horovod_tpu.serve import InferenceEngine as JaxEngine
from horovod_tpu.serve import SamplingParams as JaxSampling
from horovod_tpu.serve.fleet import migration as jax_migration

import horovod_tpu_torch.serve as port_serve
import horovod_tpu_torch.serve.fleet as port_fleet
from horovod_tpu_torch import faults
from horovod_tpu_torch.ckpt import ShardStore, take_snapshot
from horovod_tpu_torch.models.transformer import (ColumnShards,
                                                  init_kv_cache,
                                                  tensor_parallel_replica)
from horovod_tpu_torch.plan import (P, tp_owned_slice, tp_param_spec,
                                    tp_plan)
from horovod_tpu_torch.serve import (
    ContinuousBatcher, InferenceEngine, InferenceServer, ReplicaKilledError,
    ReplicaSpec, Router, SamplingParams, ShardFollower, ShardLockstepError,
    ShardServer, WeightSubscriber,
)
from horovod_tpu_torch.serve.fleet.migration import (
    MigrationError, block_digests, shard_digests, verify_shard_digests,
)
from horovod_tpu_torch.serve.tp import step_digest
from horovod_tpu_torch.utils.retry import RetryPolicy

from torch_port_serve import (KEY, greedy_reference, jax_pair, run_engine,
                              torch_model)

pytestmark = pytest.mark.serving

# n_head=4 so tp in {1, 2, 4} all divide the head count.
CFG4 = {"n_head": 4}


@functools.lru_cache(maxsize=None)
def _pair():
    """(flax GPT, params, the port's GPT holding them)."""
    jm, params = jax_pair(CFG4)
    return jm, params, torch_model(params, CFG4)


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    faults.clear()
    yield
    faults.clear()


def _kw(kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("prefill_buckets", (8, 16))
    kw.setdefault("max_seq_len", 32)
    kw.setdefault("kv_cache", "paged")
    kw.setdefault("kv_block", 4)
    kw.setdefault("seed", 7)
    return kw


def _engine(tp=1, **kw):
    if tp > 1:
        kw.setdefault("devices", ["cpu"] * tp)
    return InferenceEngine(_pair()[2], tp=tp, **_kw(kw))


def _jax_engine(tp=1, **kw):
    jm, params, _ = _pair()
    return JaxEngine(jm, params, tp=tp, **_kw(kw))


def _decode(engine, slot, prompt, n, **sampling_kw):
    return run_engine(engine, slot, prompt, n, SamplingParams, **sampling_kw)


class _Tap:
    """Stands in for an engine's model and keeps every logits tensor
    its forwards return (prefill, decode and the speculative verify
    call the model; the drafter is a model of its own)."""

    def __init__(self, model):
        self.__dict__["_model"] = model
        self.__dict__["logits"] = []

    def __call__(self, *args, **kw):
        out = self._model(*args, **kw)
        self.logits.append(out[0].detach().clone())
        return out

    def __getattr__(self, name):
        return getattr(self._model, name)


def _tapped(engine):
    engine._model = _Tap(engine._model)
    return engine._model


# --- tests/test_tp_serving.py::TestPlanHelpers ----------------------------------

class TestPlanHelpers:
    def test_param_spec_shards_only_column_parallel_kernels(self):
        w = np.zeros((32, 96))
        b = np.zeros((96,))
        cases = [("h0/attn/qkv/kernel", w, 2, P(None, "tensor")),
                 ("h0/mlp/up/kernel", w, 2, P(None, "tensor")),
                 ("h0/attn/qkv/bias", b, 2, P("tensor")),
                 ("h0/attn/out/kernel", w, 2, P()),
                 ("h0/mlp/down/kernel", w, 2, P()),
                 ("wte/embedding", w, 2, P()),
                 ("h0/attn/qkv/kernel", w, 1, P()),
                 ("h0/attn/qkv/kernel", np.zeros((32, 97)), 2, P())]
        for path, leaf, tp, want in cases:
            assert tp_param_spec(path, leaf, tp) == want, path
            assert tuple(jax_plan.tp_param_spec(path, leaf, tp)) == \
                tuple(want), path
        # The port's dotted parameter names follow the same rule.
        assert tp_param_spec("block_0.attn.qkv.kernel", w, 2) == \
            P(None, "tensor")
        assert tp_param_spec("block_0.attn.out.kernel", w, 2) == P()

    @pytest.mark.parametrize("tp", [2, 4])
    def test_owned_slices_tile_exactly(self, tp):
        shape = (12, 32)
        spans = [tp_owned_slice("any/leaf", shape, tp, r)
                 for r in range(tp)]
        assert spans == [jax_plan.tp_owned_slice("any/leaf", shape, tp, r)
                         for r in range(tp)]
        assert {s[0] for s in spans} == {1}     # largest divisible dim
        ends = sorted((s[1], s[2]) for s in spans)
        assert ends[0][0] == 0 and ends[-1][1] == 32
        for (a, b), (c, d) in zip(ends, ends[1:]):
            assert b == c                       # contiguous, no overlap
        arr = np.arange(12 * 32, dtype=np.float32).reshape(shape)
        parts = [arr[:, s[1]:s[2]] for s in sorted(spans,
                                                   key=lambda s: s[1])]
        np.testing.assert_array_equal(np.concatenate(parts, axis=1), arr)

    def test_owned_slice_indivisible_is_unsharded(self):
        assert tp_owned_slice("x", (7, 13), 2, 0) is None
        assert tp_owned_slice("x", (8, 8), 1, 0) is None

    def test_tp_plan_builds_tensor_mesh(self):
        """Without ``devices`` the rank plan (the reference's ``tensor``
        mesh of 2); with it a replica's device list, used as given."""
        plan = tp_plan(2)
        assert plan.mesh.axis_names == ("tensor",)
        assert plan.axes == (("tensor", 2),)
        assert jax_plan.tp_plan(2).mesh.devices.size == 2
        assert tp_plan(2, devices=["cpu", "cpu"]) == (
            torch.device("cpu"), torch.device("cpu"))
        with pytest.raises(ValueError, match="needs 2 shard devices"):
            tp_plan(2, devices=["cpu"])
        if torch.cuda.device_count() < 2:
            with pytest.raises(RuntimeError, match="CUDA devices"):
                tp_plan(2, devices="cuda")


# --- tests/test_tp_serving.py::TestTokenIdentityOracle -------------------------

class TestTokenIdentityOracle:
    PROMPT = [5, 6, 7, 8, 9]

    def _greedy_and_temperature(self, degrees):
        """Greedy and seeded temperature + top-k sampling, the same
        request sequence on a tp = 1 and a tp = N engine: identical
        streams, since the logits are identical bit for bit and the
        sampling streams seed-deterministic."""
        outs = {}
        for deg in degrees:
            eng = _engine(tp=deg)
            outs[deg] = (
                _decode(eng, 0, self.PROMPT, 8),
                _decode(eng, 0, self.PROMPT, 8, temperature=0.8, top_k=10),
            )
        base = outs[degrees[0]]
        assert all(outs[d] == base for d in degrees), outs
        assert base[0] == greedy_reference(_pair()[2], self.PROMPT, 8)

    def test_greedy_and_temperature_identity(self):
        self._greedy_and_temperature((1, 2))

    @pytest.mark.slow
    def test_greedy_and_temperature_identity_tp4(self):
        self._greedy_and_temperature((1, 4))

    def test_prefix_hit_and_cow_identity(self):
        """Prefix hit: a second request sharing the first one's prompt
        prefix hits the sharded engine's cache and decodes as tp = 1
        does.  COW: two live requests share a partial tail block, then
        diverge; the copy happens on every shard's pool."""
        pre = [11, 12, 13, 14, 15, 16, 17, 18]     # two full blocks
        pa, pb = pre + [1], pre + [2]
        ca = [5, 6, 7, 8, 9]
        cb = [5, 6, 7, 8, 9, 3]
        outs = {}
        for tp in (1, 2):
            eng = _engine(tp=tp)
            a = _decode(eng, 0, pa, 5)
            hits0 = eng.kv_stats()["kv_prefix_hits_total"]
            b = _decode(eng, 1, pb, 5)
            assert eng.kv_stats()["kv_prefix_hits_total"] > hits0
            x = [eng.start(0, ca, SamplingParams(max_new_tokens=8))]
            x.extend(eng.step()[0])
            y = [eng.start(1, cb, SamplingParams(max_new_tokens=6))]
            assert eng.prefix_hit_tokens(1) == 5
            for _ in range(4):
                toks = eng.step()
                x.extend(toks[0])
                y.extend(toks[1])
            assert eng.kv_stats()["kv_cow_copies_total"] >= 1
            eng.release(0)
            eng.release(1)
            outs[tp] = (a, b, x, y)
        assert outs[2] == outs[1], outs

    def _spec_identity(self, degrees):
        """Self-drafted speculative decode on the sharded engine: the
        drafter runs unsharded on the first shard's device and the
        burst equals tp = 1's, with the same full acceptance."""
        outs, ratios = {}, {}
        for deg in degrees:
            eng = _engine(tp=deg, drafter=_pair()[2], spec_k=3)
            toks = [eng.start(0, self.PROMPT,
                              SamplingParams(max_new_tokens=9, spec=True))]
            while len(toks) < 9:
                toks.extend(eng.step()[0])
            eng.release(0)
            outs[deg] = toks[:9]
            ratios[deg] = eng.kv_stats()["spec_accept_per_verify"]
        base = outs[degrees[0]]
        assert all(outs[d] == base for d in degrees), outs
        assert all(ratios[d] == 4.0 for d in degrees), ratios

    def test_speculative_batch_identity(self):
        self._spec_identity((1, 2))

    @pytest.mark.slow
    def test_speculative_batch_identity_tp4(self):
        self._spec_identity((1, 4))

    def test_greedy_tokens_equal_the_jax_engines(self):
        """The port's tp = 2 greedy tokens are the JAX engine's at tp = 1
        and at tp = 2 (two of the forced host devices), one prompt per
        slot at two depths."""
        prompts = ([5, 6, 7, 8, 9], [3, 1, 4, 1, 5, 9, 2, 6, 5, 3])
        got = {}
        for name, eng, sampling in (
                ("port tp=2", _engine(tp=2), SamplingParams),
                ("jax tp=1", _jax_engine(tp=1), JaxSampling),
                ("jax tp=2", _jax_engine(tp=2), JaxSampling)):
            got[name] = [run_engine(eng, s, p, 8, sampling)
                         for s, p in enumerate(prompts)]
        assert got["port tp=2"] == got["jax tp=1"] == got["jax tp=2"], got

    @pytest.mark.parametrize("tp", [2, 4])
    def test_logits_bitwise_prefill_decode_verify(self, tp):
        """Every logits tensor of the tp engine's forwards — the prefill
        chunks, the batched decode, the speculative verify — equals tp =
        1's bit for bit (f32)."""
        logits = {}
        for deg in (1, tp):
            eng = _engine(tp=deg, drafter=_pair()[2], spec_k=3)
            tap = _tapped(eng)
            eng.start(0, self.PROMPT, SamplingParams(max_new_tokens=8))
            eng.start(1, [3, 1, 4, 1, 5, 9, 2, 6, 5, 3],
                      SamplingParams(max_new_tokens=8))
            for _ in range(3):
                eng.step()                          # plain decode
            eng.release(0)
            eng.start(0, [2, 7, 1, 8],
                      SamplingParams(max_new_tokens=8, spec=True))
            for _ in range(2):
                eng.step()                          # draft + verify
            assert eng.spec_verify_steps > 0
            logits[deg] = tap.logits
        assert len(logits[1]) == len(logits[tp]) == 8
        for a, b in zip(logits[1], logits[tp]):
            assert a.dtype == b.dtype == torch.float32
            assert torch.equal(a, b)

    def test_replica_forward_bitwise_dense_cache(self):
        """The model-level replica (no engine): the full forward and the
        dense-cache prefill and decode equal the unsharded model's bit
        for bit, and the whole kernels reassemble exactly.  The replica
        takes a block's cache as a list, one cache of ``H / tp`` heads a
        shard (the engine hands it paged pools in that form)."""
        model = _pair()[2]
        cfg = model.config
        d = cfg.d_model // cfg.n_head

        def shard_caches(tp):
            shape = (2, 16, cfg.n_head // tp, d)
            return [[{"k": torch.zeros(shape, dtype=cfg.dtype),
                      "v": torch.zeros(shape, dtype=cfg.dtype)}
                     for _ in range(tp)] for _ in range(cfg.n_layer)]

        replica = tensor_parallel_replica(model, ["cpu", "cpu"])
        blk, src = replica.block_0, model.block_0
        assert isinstance(blk.attn.qkv, ColumnShards)
        assert torch.equal(blk.attn.qkv.whole(), src.attn.qkv.kernel)
        assert torch.equal(blk.mlp.up.whole(), src.mlp.up.kernel)
        assert replica.lm_head.kernel is not model.lm_head.kernel
        toks = torch.tensor([[5, 6, 7, 8, 9, 1, 2, 3], [9, 8, 7, 6, 5, 4,
                                                        3, 2]])
        pos = torch.arange(8).repeat(2, 1)
        with torch.inference_mode():
            assert torch.equal(model(toks), replica(toks))
            c1 = init_kv_cache(model.config, 2, 16, "cpu")
            c2 = shard_caches(2)
            a, _ = model(toks, kv_caches=c1, positions=pos)
            b, _ = replica(toks, kv_caches=c2, positions=pos)
            assert torch.equal(a, b)
            nxt, at = torch.tensor([[4], [1]]), torch.tensor([[8], [8]])
            a, _ = model(nxt, kv_caches=c1, positions=at)
            b, _ = replica(nxt, kv_caches=c2, positions=at)
            assert torch.equal(a, b)


# --- tests/test_tp_serving.py::TestShardedPoolGeometry -------------------------

class TestShardedPoolGeometry:
    def test_stats_fields_tp1_vs_tp2(self):
        model = _pair()[2]
        s1 = _engine(tp=1).kv_stats()
        s2 = _engine(tp=2).kv_stats()
        assert s1["tp_degree"] == 1 and s2["tp_degree"] == 2
        assert s1["heads"] == model.config.n_head
        assert s2["heads"] == model.config.n_head // 2
        # Same block budget (one host state); each shard's pool holds
        # half the bytes a block.
        assert s2["kv_blocks_total"] == s1["kv_blocks_total"]
        assert s2["bytes_per_block"] * 2 == s1["bytes_per_block"]
        assert (_jax_engine(tp=2).kv_stats()["bytes_per_block"]
                == s2["bytes_per_block"])

    def test_head_divisibility_enforced(self):
        with pytest.raises(ValueError, match="divide"):
            _engine(tp=3)

    def test_tp_requires_paged_kv(self):
        with pytest.raises(ValueError, match="paged"):
            _engine(tp=2, kv_cache="dense")


# --- tests/test_tp_serving.py::TestShardMigrationDigests -----------------------

def _blocks(n_layer=2, n_blocks=3, block=4, heads=4, d=8):
    rng = np.random.default_rng(3)
    shape = (n_layer, n_blocks, block, heads, d)
    return (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)),
            torch.from_numpy(rng.standard_normal(shape).astype(np.float32)))


def _replica(name, role="unified", tp=1, **server_kw):
    batcher = ContinuousBatcher(_engine(tp=tp), max_queue=16,
                                default_deadline_s=60, role=role)
    return InferenceServer(batcher, key=KEY, name=name, host="127.0.0.1",
                           **server_kw)


def _spec(server):
    return ReplicaSpec(server.name, [("127.0.0.1", server.port)],
                       role=server.role)


def _router(servers, **kw):
    kw.setdefault("retry_policy", RetryPolicy(attempts=8, base_delay_s=0.02,
                                              max_delay_s=0.2))
    kw.setdefault("probation_s", 30.0)
    return Router([_spec(s) for s in servers], KEY, **kw)


class _Frames:
    """Records the migration frames a receiving server accepted."""

    def __init__(self, server):
        self.frames = []
        add = server._migrations.add

        def tapped(frame):
            self.frames.append((frame.shard, frame.n_shards, frame.seq,
                                frame.manifest))
            return add(frame)

        server._migrations.add = tapped


class TestShardMigrationDigests:
    def test_shard_digests_verify_per_shard(self):
        k, v = _blocks()
        manifest = {"n_blocks": 3, "shard_digests": shard_digests(k, v, 2)}
        hs = k.shape[3] // 2
        for s in range(2):
            verify_shard_digests(manifest, s,
                                 k[:, :, :, s * hs:(s + 1) * hs],
                                 v[:, :, :, s * hs:(s + 1) * hs])

    def test_corrupt_shard_rejected_others_pass(self):
        k, v = _blocks()
        manifest = {"n_blocks": 3, "shard_digests": shard_digests(k, v, 2)}
        hs = k.shape[3] // 2
        bad_k = k[:, :, :, :hs].clone()
        bad_k[0, 1, 0, 0, 0] += 1.0
        with pytest.raises(MigrationError):
            verify_shard_digests(manifest, 0, bad_k, v[:, :, :, :hs])
        verify_shard_digests(manifest, 1, k[:, :, :, hs:], v[:, :, :, hs:])

    def test_shard_digests_concatenate_to_full(self):
        """The head-wise split loses nothing, and the per-shard digests
        are the reference's for the same numbers."""
        k, v = _blocks()
        full = block_digests(k, v)
        hs = k.shape[3] // 2
        rk = torch.cat([k[:, :, :, :hs], k[:, :, :, hs:]], dim=3)
        rv = torch.cat([v[:, :, :, :hs], v[:, :, :, hs:]], dim=3)
        assert block_digests(rk, rv) == full
        assert shard_digests(k, v, 2) == jax_migration.shard_digests(
            k.numpy(), v.numpy(), 2)

    def test_tp_export_equals_tp1_export(self):
        """A tp = 2 engine exports every head, in shard order: its
        chain's K/V equal a tp = 1 engine's bit for bit."""
        prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5]
        out = {}
        for tp in (1, 2):
            eng = _engine(tp=tp)
            eng.start(0, prompt, SamplingParams(max_new_tokens=4))
            out[tp] = eng.export_slot_kv(0)
        assert out[1][0] == out[2][0] == 3
        assert torch.equal(out[1][1], out[2][1])
        assert torch.equal(out[1][2], out[2][2])

    def test_tp_sender_streams_shards_to_tp1_receiver(self):
        """A tp = 2 prefill replica streams one connection a head shard,
        the manifest on every shard's first frame; the tp = 1 decode
        replica verifies both shards and decodes the greedy tokens.  A
        tp = 1 sender to a tp = 2 receiver binds the heads back into the
        shards' pools."""
        prompt = [3, 1, 4, 1, 5, 9, 2, 6]
        want = greedy_reference(_pair()[2], prompt, 6)
        for pre_tp, dec_tp in ((2, 1), (1, 2)):
            pre = _replica(f"pre-{pre_tp}", role="prefill", tp=pre_tp)
            dec = _replica(f"dec-{dec_tp}", role="decode", tp=dec_tp)
            frames = _Frames(dec)
            try:
                resp = _router([pre, dec]).generate(prompt,
                                                    max_new_tokens=6)
            finally:
                pre.shutdown()
                dec.shutdown()
            assert resp.error is None and resp.migrated_to == dec.name
            assert resp.tokens == want
            shards = sorted({(s, n) for s, n, _, _ in frames.frames})
            assert shards == [(s, pre_tp) for s in range(pre_tp)]
            firsts = [m for _, _, seq, m in frames.frames if seq == 0]
            assert len(firsts) == pre_tp and all(m is not None
                                                 for m in firsts)
            if pre_tp == 2:
                assert firsts[0]["tp_degree"] == 2
                assert len(firsts[0]["shard_digests"]) == 2

    def test_corrupt_shard_rejected_sender_decodes_locally(self):
        """``serve:mode=migrate`` damages the first shard's bytes after
        the digests: the receiver rejects the transfer before binding
        anything and the tp = 2 sender decodes the request itself."""
        prompt = [6, 5, 4, 3, 2, 1, 7, 8]
        pre = _replica("pre-bad", role="prefill", tp=2)
        dec = _replica("dec-bad", role="decode")
        try:
            with faults.inject("serve:step=0,mode=migrate"):
                resp = _router([pre, dec]).generate(prompt,
                                                    max_new_tokens=6)
                fired = [h for h in faults.history() if h[0] == "serve"]
            assert dec._batcher.engine.kv_stats()["kv_blocks_in_use"] == 0
        finally:
            pre.shutdown()
            dec.shutdown()
        assert fired == [("serve", 0, "migrate")]
        assert resp.error is None and resp.migrated_to is None
        assert resp.tokens == greedy_reference(_pair()[2], prompt, 6)


    def test_any_shard_error_fails_the_transfer(self, monkeypatch):
        """A shard whose stream dies on an error that is not the wire's
        (here building its frame raises ``ValueError``) fails the whole
        transfer: the tp = 2 sender decodes the request itself and the
        receiver binds nothing.  The reference's shard threads catch
        only ``OSError`` / ``MigrationError``, so there the transfer
        counts as a success with a shard missing."""
        import horovod_tpu_torch.serve.fleet.migration as port_migration

        frame_cls = port_migration.KvMigrateRequest

        def frame(*args, **kw):
            if kw.get("shard") == 1:
                raise ValueError("shard 1 cannot build its frame")
            return frame_cls(*args, **kw)

        monkeypatch.setattr(port_migration, "KvMigrateRequest", frame)
        outcomes = []
        monkeypatch.setattr(port_migration._obs, "on_fleet_migration",
                            lambda nbytes, ok, ms: outcomes.append(ok))
        prompt = [2, 7, 1, 8, 2, 8, 1, 8]
        pre = _replica("pre-err", role="prefill", tp=2)
        dec = _replica("dec-err", role="decode")
        try:
            resp = _router([pre, dec]).generate(prompt, max_new_tokens=6)
            assert dec._batcher.engine.kv_stats()["kv_blocks_in_use"] == 0
        finally:
            pre.shutdown()
            dec.shutdown()
        assert outcomes == [False]
        assert resp.error is None and resp.migrated_to is None
        assert resp.tokens == greedy_reference(_pair()[2], prompt, 6)


# --- tests/test_tp_serving.py::TestSwapShardPull -------------------------------

class TestSwapShardPull:
    def test_owned_bytes_sum_to_full(self):
        shapes = [(32, 96), (96,), (31, 7), (16, 16)]
        total = sum(int(np.prod(s)) * 4 for s in shapes)
        per_shard = [0, 0]
        for shape in shapes:
            for r in range(2):
                span = tp_owned_slice("leaf", shape, 2, r)
                if span is None:
                    per_shard[r] += int(np.prod(shape)) * 4
                else:
                    dim, start, stop = span
                    n = int(np.prod(shape)) // shape[dim] * (stop - start)
                    per_shard[r] += n * 4
        indivisible = 31 * 7 * 4
        assert per_shard[0] == per_shard[1]
        assert sum(per_shard) == total + indivisible

    def test_tp_engine_pulls_by_shard_and_flips(self, tmp_path):
        """Step 2 moves three leaves (a sharded ``qkv``, a sharded
        ``up``, a replicated ``ln_f.scale``): a tp = 2 replica pulls
        them by shard (the shards' bytes sum to the whole diff: every
        leaf divides), stages the sharded layout, flips, and serves
        step 2's tokens; its parameters are step 2's bit for bit."""
        model = _pair()[2]
        t1 = {n: p.detach().clone() for n, p in model.named_parameters()}
        gen = torch.Generator().manual_seed(2)
        moved = ("block_1.attn.qkv.kernel", "block_1.mlp.up.kernel",
                 "ln_f.scale")
        t2 = dict(t1)
        for name in moved:
            t2[name] = t1[name] + torch.randn(t1[name].shape, generator=gen)
        store = ShardStore(str(tmp_path))
        for step, tree in ((1, t1), (2, t2)):
            store.write_step(take_snapshot(tree, step=step), world=1,
                             scheme="dp")
        engine = _engine(tp=2, weights_version=1)
        batcher = ContinuousBatcher(engine, max_queue=8,
                                    default_deadline_s=60)
        batcher.start()
        try:
            sub = WeightSubscriber(batcher, str(tmp_path), deadline_s=60)
            assert sub.poll_once() == 2
            last = sub.last_swap
            req = batcher.submit([5, 6, 7, 8, 9],
                                 SamplingParams(max_new_tokens=6))
            assert req.done.wait(timeout=30) and req.error is None
        finally:
            batcher.stop()
        full = sum(t2[n].numel() * 4 for n in moved)
        assert last["tp"] == 2 and last["pulled_leaves"] == 3
        assert last["pulled_bytes_full"] == full
        assert sum(last["pulled_bytes_per_shard"]) == full
        assert last["pulled_bytes"] == max(last["pulled_bytes_per_shard"])
        assert engine.weights_version == 2
        got = engine.params
        assert all(torch.equal(got[n], t2[n]) for n in t2)
        ref = InferenceEngine(torch_model(_pair()[1], CFG4), **_kw({}))
        ref.stage_params(t2, 2)
        ref.commit_staged()
        assert req.tokens == _decode(ref, 0, [5, 6, 7, 8, 9], 6)


# --- tests/test_tp_serving.py::TestLockstepWire --------------------------------

class TestLockstepWire:
    def _pair(self):
        leader = _engine()
        follower = _engine()
        shard = ShardServer(follower, KEY, name="shard-1", host="127.0.0.1")
        batcher = ContinuousBatcher(leader, max_queue=8)
        batcher.set_lockstep(ShardFollower(
            [("shard-1", [("127.0.0.1", shard.port)])], KEY, timeout=30.0))
        return leader, follower, shard, batcher

    def test_follower_mirrors_then_lost_shard_kills_replica(self):
        """One request decodes in lockstep (the follower's slot state
        mirrors the leader's, its tokens the same), then the shard dies
        mid-decode and the WHOLE replica dies with it."""
        leader, follower, shard, batcher = self._pair()
        req = batcher.submit([5, 6, 7, 8, 9],
                             SamplingParams(max_new_tokens=6))
        while not req.done.is_set():
            batcher.step()
        assert req.error is None and len(req.tokens) == 6
        assert follower.free_slots() == leader.free_slots()
        got = _decode(follower, 0, [5, 6, 7, 8, 9], 6)
        assert req.tokens == got
        req2 = batcher.submit([5, 6, 7, 8, 9],
                              SamplingParams(max_new_tokens=16))
        batcher.step()                        # prefill + first decode
        shard.shutdown()                      # the shard dies
        with pytest.raises(ReplicaKilledError, match="shard_rank_lost"):
            for _ in range(20):
                batcher.step()
        assert req2.error == "replica_killed"
        with pytest.raises(ReplicaKilledError):
            batcher.submit([1, 2, 3], SamplingParams())

    def test_follower_refusal_kills_replica(self):
        """A not-ok answer (not just a dead socket) is as fatal: the
        follower's engine state can no longer be trusted."""
        leader, follower, shard, batcher = self._pair()
        try:
            fw = batcher._lockstep
            with pytest.raises(ShardLockstepError, match="refused"):
                fw("start", {"slot": 99, "prompt": [1], "sampling": None})
        finally:
            shard.shutdown()

    def test_step_digest_is_order_invariant(self):
        a = {0: [3, 4], 1: [5]}
        b = {1: [5], 0: [3, 4]}
        assert step_digest(a) == step_digest(b)
        assert step_digest(a) != step_digest({0: [3, 4], 1: [6]})
        from horovod_tpu.serve.tp import step_digest as jax_digest
        assert step_digest(a) == jax_digest(a)


@pytest.mark.chaos
def test_shard_kill_single_strike_failover_in_process():
    """``tests/multiproc/test_tp_serving_mp.py``'s property in one
    process on loopback: a lockstep replica (a leader
    ``InferenceServer(tp_peers=)`` and a follower ``ShardServer``, each
    driving a whole engine) beside a tp = 1 survivor behind a
    ``Router``.  ``serve:step=3,mode=kill`` lands on the follower's
    second decode dispatch (the leader's own check is event 2, the
    follower's next): the whole replica dies once with
    ``shard_rank_lost``, the router benches it with one strike, and all
    12 requests complete with the greedy tokens."""
    follower = ShardServer(_engine(), KEY, name="shard-1", host="127.0.0.1")
    tp_server = InferenceServer(
        ContinuousBatcher(_engine(), max_queue=16, default_deadline_s=60),
        key=KEY, name="tp-replica", host="127.0.0.1",
        tp_peers=[("shard-1", [("127.0.0.1", follower.port)])])
    solo = InferenceServer(
        ContinuousBatcher(_engine(), max_queue=16, default_deadline_s=60),
        key=KEY, name="solo", host="127.0.0.1")
    try:
        router = _router([tp_server, solo], probation_s=300.0,
                         retry_policy=RetryPolicy(attempts=10,
                                                  base_delay_s=0.05,
                                                  max_delay_s=0.5))
        responses = {}
        with faults.inject("serve:step=3,mode=kill"):
            for i in range(12):
                rid = f"req-{i}"
                resp = router.generate([i + 1, i + 2, i + 3],
                                       max_new_tokens=6, request_id=rid)
                assert resp.error is None, (i, resp.error)
                assert len(resp.tokens) == 6 and resp.request_id == rid
                responses[rid] = resp.tokens
            kills = [h for h in faults.history() if h[0] == "serve"]
        assert kills == [("serve", 3, "kill")], kills
        assert tp_server.dead and not solo.dead
        assert tp_server._batcher._killed.startswith("shard_rank_lost")
        assert follower._dead == "injected shard kill mid-decode"
        for i in range(12):
            assert responses[f"req-{i}"] == greedy_reference(
                _pair()[2], [i + 1, i + 2, i + 3], 6)
        stats = router.replica_stats()
        assert [k for k, v in stats.items() if not v["healthy"]] == \
            ["tp-replica"]
        assert stats["solo"]["healthy"]
    finally:
        for s in (tp_server, solo, follower):
            s.shutdown()


def test_serve_names_match_the_reference():
    """Every public name of ``horovod_tpu.serve`` and
    ``horovod_tpu.serve.fleet`` exists in the port."""
    assert {"tp", "ShardServer", "ShardFollower"} <= set(dir(jax_serve))
    for ref, port in ((jax_serve, port_serve), (jax_fleet, port_fleet)):
        names = {n for n in dir(ref) if not n.startswith("_")}
        missing = sorted(n for n in names if not hasattr(port, n))
        assert missing == [], (ref.__name__, missing)
