"""The port's async sharded durable state (``horovod_tpu_torch/ckpt/``)
against the reference's (``horovod_tpu/ckpt/``).

Two kinds of test, on the CPU:

* the reference's own oracles of ``tests/test_ckpt.py`` (snapshot,
  journal, ownership, restore planning, the async writer and
  checkpointer, restore precedence, the fault modes, the kill-mid-save
  drill, the knobs and the compat tier's digest offload), run on the
  port's modules over the same numpy trees;
* parity: the same seeded numpy trees through both packages give equal
  path strings, per-leaf and tree digests, owner maps, skeletons,
  manifest text (but ``created_unix``) and restore plans, bit for bit;
  a step either package's ``ShardStore`` writes, a bf16 leaf included,
  restores in the other; a journal either wrote reads the same in the
  other; and the flight events of a damaged-step resume are the
  reference's.  F9's two repairs (the optimizer state the step objects
  hold, through ``state_dict``) are held here too.
"""

import copy
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from horovod_tpu_torch import faults
from horovod_tpu_torch.ckpt import (
    AsyncCheckpointer, AsyncWriter, BufferPool, CheckpointCorruptionError,
    Manifest, ManifestError, ShardStore, StepJournal, assign_owners,
    plan_restore, pytree_digest, take_snapshot,
)
from horovod_tpu_torch.ckpt.manifest import build_skeleton, skeleton_fill
from horovod_tpu_torch.ckpt.snapshot import (tree_flatten_with_path,
                                             tree_leaves)
from horovod_tpu_torch.config import Config, parse_fault_spec
from horovod_tpu_torch.elastic import ElasticSampler, TorchState
from horovod_tpu_torch.elastic.state import HorovodInternalError
from horovod_tpu_torch.obs import flight


def _tree(scale=1.0):
    return {
        "params": {"w": np.arange(24.0).reshape(4, 6) * scale,
                   "b": np.ones((6,)) * scale},
        "opt": [np.zeros((4,)), np.full((3, 3), 7.0) * scale],
        "step": 5,
    }


def _leaves_equal(a, b):
    la = tree_leaves(a)
    lb = tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        xa, ya = np.asarray(x), np.asarray(y)
        assert xa.dtype == ya.dtype
        np.testing.assert_array_equal(xa, ya)


def _flight_kinds():
    return [e["kind"] for e in flight.events()]


# --- snapshot ----------------------------------------------------------------

class TestSnapshot:
    def test_digest_matches_pytree_digest(self):
        tree = _tree()
        snap = take_snapshot(tree)
        assert snap.digest() == pytree_digest(tree)

    def test_snapshot_owns_its_bytes(self):
        src = np.arange(8.0)
        tree = {"w": src}
        snap = take_snapshot(tree)
        src[:] = -1.0   # the live buffer moves on; the snapshot must not
        np.testing.assert_array_equal(
            snap.leaves[0].array, np.arange(8.0))

    def test_buffer_pool_reuse(self):
        pool = BufferPool(1)
        tree = _tree()
        s1 = take_snapshot(tree, pool=pool)
        bufs1 = [leaf.array for leaf in s1.leaves]
        s1.release()
        s2 = take_snapshot(tree, pool=pool)
        bufs2 = [leaf.array for leaf in s2.leaves]
        # Steady state allocates nothing: the same host buffers cycle.
        assert all(b1 is b2 for b1, b2 in zip(bufs1, bufs2))
        s2.release()

    def test_pool_exhaustion_falls_back_to_fresh_alloc(self):
        pool = BufferPool(1)
        tree = _tree()
        s1 = take_snapshot(tree, pool=pool)         # holds the one set
        s2 = take_snapshot(tree, pool=pool)         # must not block
        assert s2.leaves[0].array is not s1.leaves[0].array
        _leaves_equal(s1.tree(), s2.tree())
        s1.release()
        s2.release()

    def test_nbytes_accounts_every_leaf(self):
        snap = take_snapshot({"a": np.zeros((4,), np.float32),
                              "b": np.zeros((2, 2), np.float64)})
        assert snap.nbytes == 4 * 4 + 4 * 8


# --- journal -----------------------------------------------------------------

class TestStepJournal:
    def test_append_read_roundtrip(self, tmp_path):
        j = StepJournal(str(tmp_path / "j.jsonl"))
        j.append(1, rng=[0, 1], cursor=4)
        j.append(2, rng=[0, 2], cursor=8)
        entries, intact = j.read()
        assert intact
        assert [e["step"] for e in entries] == [1, 2]
        assert entries[1]["cursor"] == 8
        assert j.last_step() == 2
        j.close()

    def test_every_append_is_on_disk(self, tmp_path):
        path = str(tmp_path / "j.jsonl")
        j = StepJournal(path)
        j.append(7, x=1)
        # No close, no flush from the caller: the contract is that the
        # line is durable when append() returns.
        with open(path) as f:
            assert json.loads(f.read().splitlines()[0])["step"] == 7
        j.close()

    def test_duplicate_steps_last_wins(self, tmp_path):
        j = StepJournal(str(tmp_path / "j.jsonl"))
        for step, tag in [(1, "a"), (2, "b"), (2, "b2"), (3, "c")]:
            j.append(step, tag=tag)
        tail = j.entries_after(1)
        assert [(e["step"], e["tag"]) for e in tail] == [(2, "b2"),
                                                         (3, "c")]
        j.close()

    def test_torn_final_line_tolerated(self, tmp_path):
        path = str(tmp_path / "j.jsonl")
        j = StepJournal(path)
        j.append(1, x=1)
        j.append(2, x=2)
        j.close()
        with open(path, "ab") as f:
            f.write(b'{"step": 3, "x"')     # the fsync the crash cut
        flight.reset_for_tests()
        entries, intact = StepJournal(path).read()
        assert not intact
        assert [e["step"] for e in entries] == [1, 2]
        assert "ckpt_journal_corrupt" in _flight_kinds()

    def test_corrupt_mid_file_stops_deterministically(self, tmp_path):
        path = str(tmp_path / "j.jsonl")
        j = StepJournal(path)
        for s in (1, 2, 3, 4):
            j.append(s)
        j.close()
        raw = open(path, "rb").read().splitlines(keepends=True)
        raw[1] = b"\x00garbage\x00\n"
        with open(path, "wb") as f:
            f.writelines(raw)
        flight.reset_for_tests()
        entries, intact = StepJournal(path).read()
        assert not intact
        assert [e["step"] for e in entries] == [1]   # stops at the cut
        assert "ckpt_journal_corrupt" in _flight_kinds()

    def test_missing_file_is_fresh_not_damage(self, tmp_path):
        entries, intact = StepJournal(str(tmp_path / "nope.jsonl")).read()
        assert entries == [] and intact

    def test_resumed_appends_repair_a_torn_tail(self, tmp_path):
        # Double-crash scenario: crash 1 tears line 2; the restarted
        # process appends steps 2-3; crash 2.  Without tail repair the
        # first post-restart entry concatenates onto the partial record
        # and EVERY later entry is unreadable.
        path = str(tmp_path / "j.jsonl")
        j = StepJournal(path)
        j.append(1, x=1)
        j.append(2, x=2)
        j.close()
        with open(path, "rb+") as f:
            raw = f.read()
            f.truncate(len(raw) - 7)       # tear line 2 mid-record
        j2 = StepJournal(path)             # the restarted process
        j2.append(2, x=22)
        j2.append(3, x=3)
        j2.close()
        entries, intact = StepJournal(path).read()
        assert intact
        assert [(e["step"], e["x"]) for e in entries] == \
            [(1, 1), (2, 22), (3, 3)]


# --- manifest / ownership ----------------------------------------------------

class TestOwnership:
    LEAVES = [("a", 400), ("b", 300), ("c", 200), ("d", 100), ("e", 96)]

    def test_dp_is_rank0_only(self):
        owners = assign_owners(self.LEAVES, world=4, scheme="dp")
        assert set(owners.values()) == {0}

    def test_zero_balances_bytes(self):
        owners = assign_owners(self.LEAVES, world=2, scheme="zero")
        load = {0: 0, 1: 0}
        sizes = dict(self.LEAVES)
        for path, rank in owners.items():
            load[rank] += sizes[path]
        # Greedy biggest-first: within one max-leaf of balanced.
        assert abs(load[0] - load[1]) <= 400

    def test_assignment_is_deterministic(self):
        a = assign_owners(self.LEAVES, world=3, scheme="fsdp")
        b = assign_owners(list(reversed(self.LEAVES)), world=3,
                          scheme="fsdp")
        assert a == b

    def test_unknown_scheme_rejected(self):
        with pytest.raises(ValueError, match="scheme"):
            assign_owners(self.LEAVES, world=2, scheme="wat")

    def test_skeleton_roundtrip_normalizes_containers(self):
        from collections import namedtuple

        Opt = namedtuple("Opt", ["mu", "count"])
        tree = {"opt": Opt(mu={"w": np.ones(2)}, count=np.zeros(())),
                "lst": (np.zeros(1), np.ones(1))}
        flat, _ = tree_flatten_with_path(tree)
        ids = [f"l{i:05d}" for i in range(len(flat))]
        skel = build_skeleton([p for p, _ in flat], ids)
        lookup = {i: np.asarray(leaf) for i, (_, leaf) in zip(ids, flat)}
        rebuilt = skeleton_fill(skel, lookup)
        # namedtuple → dict, tuple → list: the orbax normalization.
        assert isinstance(rebuilt["opt"], dict)
        assert isinstance(rebuilt["lst"], list)
        np.testing.assert_array_equal(rebuilt["opt"]["mu"]["w"],
                                      np.ones(2))
        assert pytree_digest(rebuilt) == pytree_digest(tree)


class TestRestorePlanning:
    def _manifest(self, tmp_path, world=4):
        with AsyncCheckpointer(str(tmp_path / "z"), async_save=False,
                               world=world, rank=0,
                               scheme="zero") as ck:
            ck.save(1, _tree())
            return ck, ck._store.read_manifest(1)

    def test_resize_plans_cover_disjointly(self, tmp_path):
        _, m = self._manifest(tmp_path)
        for new_world in (2, 4, 8):
            seen = []
            total = 0
            for r in range(new_world):
                plan = plan_restore(m, rank=r, world=new_world)
                seen.extend(plan.leaf_ids)
                total += plan.nbytes
            assert sorted(seen) == sorted(m.entries)   # exactly once
            assert total == m.nbytes                   # no byte twice

    def test_bytes_move_only_to_owners(self, tmp_path):
        ck, m = self._manifest(tmp_path)
        plan, payload = ck.restore_shard(rank=1, world=2)
        assert plan.nbytes < m.nbytes       # a shard, not the tree
        assert plan.nbytes == sum(np.asarray(v).nbytes
                                  for v in payload.values())

    def test_resized_shards_reassemble_exactly(self, tmp_path):
        ck, m = self._manifest(tmp_path)
        merged = {}
        for r in range(8):                  # N=4 → N′=8 resize
            _, payload = ck.restore_shard(rank=r, world=8)
            merged.update(payload)
        by_path = {e["path"]: leaf_id
                   for leaf_id, e in m.entries.items()}
        full = ck.restore()
        flat, _ = tree_flatten_with_path(full)
        from horovod_tpu_torch.ckpt.snapshot import path_string

        for path, leaf in flat:
            np.testing.assert_array_equal(merged[path_string(path)],
                                          np.asarray(leaf))
        assert len(merged) == len(by_path)

    def test_dp_restore_is_rank0_only(self, tmp_path):
        with AsyncCheckpointer(str(tmp_path / "dp"), async_save=False,
                               world=4, rank=0, scheme="dp") as ck:
            ck.save(1, _tree())
            p0, payload = ck.restore_shard(rank=0, world=4)
            p1, empty = ck.restore_shard(rank=1, world=4)
        assert p0.nbytes > 0 and payload
        assert p1.nbytes == 0 and empty == {}


# --- async writer ------------------------------------------------------------

class TestAsyncWriter:
    def test_writes_in_order(self):
        got = []
        w = AsyncWriter(got.append, inflight=8)
        for i in range(5):
            w.submit(i)
        w.wait_until_finished()
        w.close()
        assert got == [0, 1, 2, 3, 4]

    def test_bounded_queue_coalesces_oldest(self):
        gate = threading.Event()
        done, dropped = [], []

        def slow(item):
            gate.wait(5.0)
            done.append(item)

        w = AsyncWriter(slow, inflight=2, on_drop=dropped.append)
        w.submit("a")                     # starts writing, blocks
        time.sleep(0.05)
        w.submit("b")
        w.submit("c")
        w.submit("d")                     # queue full: b coalesced away
        gate.set()
        w.wait_until_finished()
        w.close()
        assert dropped == ["b"]
        assert done == ["a", "c", "d"]    # newest state survived
        assert w.dropped() == 1

    def test_error_surfaces_on_caller(self):
        def boom(item):
            raise RuntimeError(f"disk on fire: {item}")

        w = AsyncWriter(boom, inflight=2)
        w.submit("x")
        time.sleep(0.1)
        with pytest.raises(RuntimeError, match="disk on fire"):
            w.submit("y")
        w.close()

    def test_error_surfaces_on_wait_and_close(self):
        w = AsyncWriter(lambda item: 1 / 0, inflight=2)
        w.submit("x")
        with pytest.raises(ZeroDivisionError):
            w.wait_until_finished()
        w.submit("y")
        with pytest.raises(ZeroDivisionError):
            w.close()

    def test_wait_timeout_raises_rather_than_lying(self):
        gate = threading.Event()
        w = AsyncWriter(lambda item: gate.wait(10.0), inflight=2)
        w.submit("x")
        with pytest.raises(TimeoutError, match="NOT yet durable"):
            w.wait_until_finished(timeout=0.2)
        gate.set()
        w.wait_until_finished()
        w.close()

    def test_no_coalesce_mode_backpressures_instead_of_dropping(self):
        gate = threading.Event()
        done, dropped = [], []

        def slow(item):
            gate.wait(5.0)
            done.append(item)

        w = AsyncWriter(slow, inflight=1, coalesce=False,
                        on_drop=dropped.append)
        w.submit("a")
        time.sleep(0.05)
        w.submit("b")                     # fills the queue

        t = threading.Thread(target=lambda: w.submit("c"))
        t.start()
        time.sleep(0.1)
        assert t.is_alive()               # blocked, not dropping
        gate.set()
        t.join(5.0)
        w.wait_until_finished()
        w.close()
        assert done == ["a", "b", "c"]    # every item written
        assert dropped == [] and w.dropped() == 0

    def test_close_without_drain_releases_queued_items(self):
        gate = threading.Event()
        dropped = []
        w = AsyncWriter(lambda item: gate.wait(5.0), inflight=4,
                        on_drop=dropped.append)
        w.submit("a")
        time.sleep(0.05)
        w.submit("q1")
        w.submit("q2")
        gate.set()
        w.close(drain=False)
        # Queued items must be RELEASED (buffer-pool return), not
        # silently leaked.
        assert dropped == ["q1", "q2"]

    def test_discard_pending_clears_queue_and_error(self):
        gate = threading.Event()
        done = []

        def slow(item):
            if item == "bad":
                raise RuntimeError("bad item")
            gate.wait(5.0)
            done.append(item)

        w = AsyncWriter(slow, inflight=4)
        w.submit("bad")
        time.sleep(0.1)                   # error stored
        dropped = []
        w2 = AsyncWriter(slow, inflight=4, on_drop=dropped.append)
        w2.submit("a")
        time.sleep(0.05)
        w2.submit("queued1")
        w2.submit("queued2")
        assert w2.discard_pending() == 2
        assert dropped == ["queued1", "queued2"]
        gate.set()
        w2.wait_until_finished()
        w2.close()
        assert done == ["a"]
        # The failed writer's stored error is cleared by discard too.
        assert w.discard_pending() == 0
        w.submit("ok-now-it-raises-nothing")  # no stored error
        gate.set()
        w.close()


# --- the checkpointer --------------------------------------------------------

class TestAsyncCheckpointer:
    def test_async_byte_identical_to_sync(self, tmp_path):
        """THE equivalence oracle: async and sync saves restore
        byte-identical trees, and both match the live tree's digest."""
        tree = _tree(scale=3.0)
        with AsyncCheckpointer(str(tmp_path / "s"),
                               async_save=False) as sync_ck:
            sync_ck.save(1, tree)
            got_sync = sync_ck.restore()
        with AsyncCheckpointer(str(tmp_path / "a"),
                               async_save=True) as async_ck:
            async_ck.save(1, tree)
            async_ck.wait_until_finished()
            got_async = async_ck.restore()
        _leaves_equal(got_sync, got_async)
        assert pytree_digest(got_sync) == pytree_digest(got_async) \
            == pytree_digest(tree)
        m_sync = ShardStore(str(tmp_path / "s")).read_manifest(1)
        m_async = ShardStore(str(tmp_path / "a")).read_manifest(1)
        assert m_sync.tree_digest == m_async.tree_digest

    def test_duplicate_step_skipped_force_overwrites(self, tmp_path):
        with AsyncCheckpointer(str(tmp_path / "d"),
                               async_save=False) as ck:
            assert ck.save(1, _tree())
            assert not ck.save(1, _tree(scale=9.0))
            got = ck.restore(1, fallback=False)
            np.testing.assert_array_equal(
                np.asarray(got["params"]["b"]), np.ones(6))
            assert ck.save(1, _tree(scale=9.0), force=True)
            got = ck.restore(1, fallback=False)
            np.testing.assert_array_equal(
                np.asarray(got["params"]["b"]), np.ones(6) * 9.0)

    def test_retention_prunes_oldest(self, tmp_path):
        with AsyncCheckpointer(str(tmp_path / "r"), async_save=False,
                               max_to_keep=2) as ck:
            for s in (1, 2, 3, 4):
                ck.save(s, _tree(scale=float(s)))
            assert ck.all_steps() == [3, 4]
            assert ck.latest_step() == 4

    def test_save_stall_excludes_write(self, tmp_path):
        """The headline contract: save() returns after the snapshot;
        the (deliberately slow) write happens behind it."""
        gate = threading.Event()
        ck = AsyncCheckpointer(str(tmp_path / "q"), async_save=True)
        orig = ck._store.write_step

        def slow_write(*a, **kw):
            gate.wait(5.0)
            return orig(*a, **kw)

        ck._store.write_step = slow_write
        t0 = time.perf_counter()
        assert ck.save(1, _tree())
        stall = time.perf_counter() - t0
        assert stall < 1.0                 # did not wait for the write
        assert ck._inflight() >= 1
        gate.set()
        ck.wait_until_finished()
        assert ck.all_steps() == [1]
        ck.close()

    def test_non_primary_process_never_writes(self, tmp_path,
                                              monkeypatch):
        # The single-rename commit protocol and the shared journal file
        # have exactly one writer, rank 0: another rank's save() and
        # journal_step() are no-ops (it may still restore).
        monkeypatch.setattr(AsyncCheckpointer, "_primary_process",
                            staticmethod(lambda: False))
        ck = AsyncCheckpointer(str(tmp_path / "np"), async_save=False)
        assert ck.save(1, _tree()) is False
        ck.journal_step(1, cursor=4)
        assert ck.all_steps() == []
        assert not os.path.exists(ck.journal.path)
        ck.close()

    def test_duplicate_step_queued_but_uncommitted_returns_false(
            self, tmp_path):
        # The duplicate check must see steps still in the writer queue:
        # otherwise save() returns True for a tree the store will later
        # silently skip (the first queued save wins the commit).
        gate = threading.Event()
        ck = AsyncCheckpointer(str(tmp_path / "dq"), async_save=True)
        orig = ck._store.write_step

        def slow_write(*a, **kw):
            gate.wait(5.0)
            return orig(*a, **kw)

        ck._store.write_step = slow_write
        assert ck.save(1, _tree(scale=1.0))
        assert not ck.save(1, _tree(scale=9.0))   # queued, not on disk
        gate.set()
        ck.wait_until_finished()
        got = ck.restore(1, fallback=False)
        np.testing.assert_array_equal(np.asarray(got["params"]["b"]),
                                      np.ones(6))
        assert ck.save(2, _tree(scale=2.0))       # step set was cleaned
        ck.close()

    def test_pool_evicts_stale_leaves(self, tmp_path):
        pool = BufferPool(1)
        s1 = take_snapshot({"old": np.zeros(1024, np.float32)},
                           pool=pool)
        s1.release()
        s2 = take_snapshot({"new": np.zeros(8, np.float32)}, pool=pool)
        # The 'old' leaf's buffer must be evicted, not pinned forever.
        assert set(s2._buffers) == {"'new'"}
        s2.release()

    def test_writer_error_surfaces_on_next_save(self, tmp_path):
        ck = AsyncCheckpointer(str(tmp_path / "e"), async_save=True)
        ck._store.write_step = lambda *a, **kw: 1 / 0
        ck.save(1, _tree())
        time.sleep(0.2)
        with pytest.raises(ZeroDivisionError):
            ck.save(2, _tree())

    def test_template_casts_dtypes(self, tmp_path):
        with AsyncCheckpointer(str(tmp_path / "t"),
                               async_save=False) as ck:
            ck.save(1, {"x": np.ones((4,), np.float32)})
            template = {"x": np.zeros((4,), np.float16)}
            got = ck.restore(template=template)
        assert np.asarray(got["x"]).dtype == np.float16

    def test_template_matches_by_key_path_not_position(self, tmp_path):
        # Restored trees are dict-normalized (sorted-key flatten order)
        # while a namedtuple template flattens in FIELD order —
        # positional pairing would silently swap weight and bias.
        from collections import namedtuple

        P = namedtuple("P", ["weight", "bias"])   # w before b: unsorted
        tree = {"params": P(weight=np.arange(4.0),
                            bias=np.ones((2,)) * 5.0)}
        with AsyncCheckpointer(str(tmp_path / "nt"),
                               async_save=False) as ck:
            ck.save(1, tree)
            template = {"params": P(weight=np.zeros((4,), np.float32),
                                    bias=np.zeros((2,), np.float32))}
            got = ck.restore(template=template)
        np.testing.assert_array_equal(np.asarray(got["params"].weight),
                                      np.arange(4.0, dtype=np.float32))
        np.testing.assert_array_equal(np.asarray(got["params"].bias),
                                      np.full((2,), 5.0, np.float32))

    def test_metrics_land_in_registry(self, tmp_path):
        from horovod_tpu_torch.obs import metrics as obs_metrics

        with AsyncCheckpointer(str(tmp_path / "m"),
                               async_save=True) as ck:
            ck.save(1, _tree())
            ck.wait_until_finished()
            ck.restore()
            ck.journal_step(1, rng=[0, 1])
        snap = obs_metrics.registry().snapshot()
        assert "hvd_tpu_ckpt_save_stall_us" in snap
        assert "hvd_tpu_ckpt_write_us" in snap
        assert "hvd_tpu_ckpt_inflight" in snap
        kinds = {dict(s["labels"]).get("kind")
                 for s in snap["hvd_tpu_ckpt_bytes_total"]}
        assert {"snapshot", "write", "restore", "journal"} <= kinds

    def test_save_restore_spans_recorded(self, tmp_path):
        from horovod_tpu_torch.obs import trace as trace_mod

        trace_mod.clear()
        with AsyncCheckpointer(str(tmp_path / "sp"),
                               async_save=True) as ck:
            ck.save(1, _tree())
            ck.wait_until_finished()
            ck.restore()
        names = {s["name"] for s in trace_mod.snapshot()}
        assert {"hvd_tpu_ckpt_save", "hvd_tpu_ckpt_offload",
                "hvd_tpu_ckpt_write",
                "hvd_tpu_ckpt_restore"} <= names


# --- restore precedence (satellite) ------------------------------------------

class TestRestorePrecedence:
    def _seed(self, tmp_path, *, journal_to=None, snap_steps=(2, 4)):
        ck = AsyncCheckpointer(str(tmp_path / "p"), async_save=False)
        for s in snap_steps:
            ck.save(s, _tree(scale=float(s)))
        if journal_to is not None:
            for s in range(1, journal_to + 1):
                ck.journal_step(s, rng=[0, s], cursor=s * 4)
        return ck

    def test_journal_ahead_of_snapshot_replays_to_exact(self, tmp_path):
        flight.reset_for_tests()
        ck = self._seed(tmp_path, journal_to=7)
        info = ck.resume()
        assert info.snapshot_step == 4
        assert [e["step"] for e in info.replay] == [5, 6, 7]
        assert info.exact_step == 7
        assert info.journal_intact
        assert "ckpt_resume" in _flight_kinds()
        ck.close()

    def test_journal_missing_resumes_at_snapshot(self, tmp_path):
        flight.reset_for_tests()
        ck = self._seed(tmp_path, journal_to=None)
        info = ck.resume()
        assert info.snapshot_step == 4 and info.exact_step == 4
        assert info.replay == []
        assert "ckpt_resume" in _flight_kinds()
        ck.close()

    def test_journal_corrupt_midline_uses_intact_prefix(self, tmp_path):
        ck = self._seed(tmp_path, journal_to=8)
        path = ck.journal.path
        ck.close()
        raw = open(path, "rb").read().splitlines(keepends=True)
        raw[6] = b"}{ not json\n"          # corrupt step 7's line
        with open(path, "wb") as f:
            f.writelines(raw)
        flight.reset_for_tests()
        ck2 = AsyncCheckpointer(str(tmp_path / "p"), async_save=False)
        info = ck2.resume()
        assert info.snapshot_step == 4
        assert [e["step"] for e in info.replay] == [5, 6]
        assert info.exact_step == 6        # deterministic: intact prefix
        assert not info.journal_intact
        kinds = _flight_kinds()
        assert "ckpt_journal_corrupt" in kinds
        assert "ckpt_resume" in kinds
        ck2.close()

    def test_manifest_missing_shard_falls_back(self, tmp_path):
        ck = self._seed(tmp_path, journal_to=5)
        step_dir = ck._store.step_dir(4)
        m = ck._store.read_manifest(4)
        os.unlink(os.path.join(step_dir, m.files()[0]))
        flight.reset_for_tests()
        info = ck.resume()
        assert info.snapshot_step == 2     # newest INTACT step
        assert [e["step"] for e in info.replay] == [3, 4, 5]
        assert info.exact_step == 5
        kinds = _flight_kinds()
        assert "ckpt_step_damaged" in kinds
        assert "ckpt_resume" in kinds
        ck.close()

    def test_parseable_but_mangled_manifest_falls_back(self, tmp_path):
        # A torn write can leave JSON that parses but is structurally
        # wrong (entry missing 'file', nbytes garbage): that must feed
        # the fallback scan, never escape as a raw KeyError/TypeError.
        ck = self._seed(tmp_path, journal_to=5)
        mpath = os.path.join(ck._store.step_dir(4), Manifest.FILENAME)
        with open(mpath) as f:
            doc = json.load(f)
        first = sorted(doc["entries"])[0]
        del doc["entries"][first]["file"]
        doc["entries"][sorted(doc["entries"])[1]]["nbytes"] = "garbage"
        with open(mpath, "w") as f:
            json.dump(doc, f)
        got = ck.restore()                 # falls back to step 2
        np.testing.assert_array_equal(np.asarray(got["params"]["b"]),
                                      np.ones(6) * 2.0)
        info = ck.resume()
        assert info.snapshot_step == 2 and info.exact_step == 5
        ck.close()

    def test_explicit_step_never_falls_back(self, tmp_path):
        ck = self._seed(tmp_path)
        step_dir = ck._store.step_dir(4)
        m = ck._store.read_manifest(4)
        os.unlink(os.path.join(step_dir, m.files()[0]))
        with pytest.raises(ManifestError):
            ck.restore(4, fallback=False)
        got = ck.restore(2, fallback=False)
        np.testing.assert_array_equal(np.asarray(got["params"]["b"]),
                                      np.ones(6) * 2.0)
        ck.close()

    def test_latest_with_fallback_disabled_fails_fast(self, tmp_path):
        # restore(fallback=False) without a step must honor the
        # caller's choice (fail fast and alert), not silently degrade
        # to stale state.
        ck = self._seed(tmp_path)
        m = ck._store.read_manifest(4)
        os.unlink(os.path.join(ck._store.step_dir(4), m.files()[0]))
        with pytest.raises(ManifestError):
            ck.restore(fallback=False)
        ck.close()

    def test_digest_mismatch_detected_and_skipped(self, tmp_path):
        # Tamper a manifest digest (the content/metadata disagreement a
        # flipped block that still CRCs would produce): the per-leaf
        # digest check must reject step 4 and fall back to step 2.
        ck = self._seed(tmp_path)
        mpath = os.path.join(ck._store.step_dir(4), Manifest.FILENAME)
        with open(mpath) as f:
            doc = json.load(f)
        first = sorted(doc["entries"])[0]
        doc["entries"][first]["digest"] = "0" * 64
        with open(mpath, "w") as f:
            json.dump(doc, f)
        got = ck.restore()                 # falls back to step 2
        np.testing.assert_array_equal(np.asarray(got["params"]["b"]),
                                      np.ones(6) * 2.0)
        with pytest.raises(CheckpointCorruptionError):
            ck.restore(4, fallback=False)
        ck.close()

    def test_bitflipped_shard_detected_and_skipped(self, tmp_path):
        # A flipped disk block breaks the zip CRC — same verdict, same
        # fallback, via CheckpointCorruptionError.
        ck = self._seed(tmp_path)
        m = ck._store.read_manifest(4)
        victim = os.path.join(ck._store.step_dir(4), m.files()[0])
        size = os.path.getsize(victim)
        with open(victim, "r+b") as f:
            f.seek(size // 2)
            chunk = f.read(64)
            f.seek(size // 2)
            f.write(bytes(b ^ 0xFF for b in chunk))
        got = ck.restore()
        np.testing.assert_array_equal(np.asarray(got["params"]["b"]),
                                      np.ones(6) * 2.0)
        ck.close()

    def test_all_steps_damaged_raises_corruption_error(self, tmp_path):
        ck = self._seed(tmp_path)
        for s in (2, 4):
            m = ck._store.read_manifest(s)
            os.unlink(os.path.join(ck._store.step_dir(s), m.files()[0]))
        with pytest.raises(CheckpointCorruptionError):
            ck.restore()
        with pytest.raises(FileNotFoundError):
            ck.resume()
        ck.close()


# --- fault modes -------------------------------------------------------------

class TestCheckpointFaultModes:
    def test_new_modes_parse(self):
        for mode in ("stall", "partial-manifest", "crash-before-rename"):
            clauses = parse_fault_spec(f"checkpoint:step=2,mode={mode}")
            assert clauses["checkpoint"].mode == mode

    def test_unknown_mode_rejected(self):
        with pytest.raises(ValueError, match="unknown mode"):
            parse_fault_spec("checkpoint:step=2,mode=wat")

    def test_crash_before_rename_never_commits(self, tmp_path):
        d = str(tmp_path / "c")
        with faults.inject("checkpoint:step=2,mode=crash-before-rename"):
            ck = AsyncCheckpointer(d, async_save=False)
            ck.save(1, _tree())
            with pytest.raises(HorovodInternalError,
                               match="crash-before-rename"):
                ck.save(2, _tree())
            assert ck.all_steps() == [1]
            assert [h[:2] for h in faults.history()] == [("checkpoint",
                                                          2)]
            ck.close()
        # The tmp dir a real crash would leave is invisible to restore.
        ck2 = AsyncCheckpointer(d, async_save=False)
        assert ck2.latest_step() == 1
        ck2.close()

    def test_crash_mid_async_save_surfaces_on_barrier(self, tmp_path):
        with faults.inject("checkpoint:step=2,mode=crash-before-rename"):
            ck = AsyncCheckpointer(str(tmp_path / "a"), async_save=True)
            ck.save(1, _tree())
            ck.save(2, _tree())            # returns: stall is a snapshot
            with pytest.raises(HorovodInternalError):
                ck.wait_until_finished()
            assert ck.all_steps() == [1]
            ck.discard_pending()
            ck.close()

    def test_partial_manifest_damages_exactly_one_shard(self, tmp_path):
        with faults.inject("checkpoint:step=1,mode=partial-manifest"):
            ck = AsyncCheckpointer(str(tmp_path / "pm"),
                                   async_save=False, world=2,
                                   scheme="zero")
            ck.save(1, _tree())
            m = ck._store.read_manifest(1)
            present = [f for f in m.files() if os.path.exists(
                os.path.join(ck._store.step_dir(1), f))]
            assert len(present) == len(m.files()) - 1
            with pytest.raises(ManifestError):
                ck._store.validate_step(1)
            ck.close()

    def test_corrupt_and_partial_still_work_on_shard_store(self, tmp_path):
        for mode in ("corrupt", "partial"):
            d = str(tmp_path / mode)
            with faults.inject(f"checkpoint:step=2,mode={mode}"):
                ck = AsyncCheckpointer(d, async_save=False)
                ck.save(1, _tree(scale=1.0))
                ck.save(2, _tree(scale=2.0))
                got = ck.restore()         # falls back to step 1
                np.testing.assert_array_equal(
                    np.asarray(got["params"]["b"]), np.ones(6))
                ck.close()

    def test_stall_acceptance_async_under_10pct_of_sync(self, tmp_path):
        """Acceptance: with a deliberately slow filesystem (stall
        fault, 250 ms per save), the async save stall is <10% of the
        synchronous save wall — deterministic, no disk-speed luck."""
        tree = _tree()
        with faults.inject("checkpoint:p=1.0,mode=stall,delay_ms=250"):
            ck = AsyncCheckpointer(str(tmp_path / "sync"),
                                   async_save=False)
            t0 = time.perf_counter()
            ck.save(1, tree)
            sync_wall = time.perf_counter() - t0
            ck.close()
        with faults.inject("checkpoint:p=1.0,mode=stall,delay_ms=250"):
            ck = AsyncCheckpointer(str(tmp_path / "async"),
                                   async_save=True)
            t0 = time.perf_counter()
            ck.save(1, tree)
            async_stall = time.perf_counter() - t0
            ck.wait_until_finished()
            ck.close()
        assert sync_wall >= 0.25
        assert async_stall < 0.1 * sync_wall, (async_stall, sync_wall)


# --- THE chaos drill ---------------------------------------------------------
# A deterministic train loop over an ElasticSampler-style cursor, saved
# through the async checkpointer on a 2-simulated-pod (world=2, zero)
# partition, killed mid-run by an injected checkpoint fault, resumed
# via the journal, resized to world=4, and compared byte-for-byte
# against an uninterrupted reference run.

TOTAL_STEPS = 12
RESIZE_AT = 8          # world 2 → 4 (N → 2N)
SAVE_EVERY = 2
N_SAMPLES = 64
BATCH = 4
LR = np.float32(0.05)


def _data_order(seed=11):
    return np.random.RandomState(seed).permutation(N_SAMPLES)


def _samples():
    return (np.arange(N_SAMPLES, dtype=np.float32)[:, None]
            * np.linspace(0.5, 1.5, 8, dtype=np.float32)[None, :])


def _apply_step(params, order, cursor):
    batch = _samples()[order[cursor:cursor + BATCH]]
    return {"w": params["w"] + LR * batch.mean(axis=0)}, cursor + BATCH


def _drill(ckpt_dir, fault_spec=None, kill_after=None):
    """Run the loop (phase A), optionally dying on an injected fault or
    at ``kill_after``; then resume in a 'fresh process' (phase B) at
    the doubled world size and run to completion.  Returns (params,
    executed_step_list)."""
    order = _data_order()
    params = {"w": np.zeros(8, np.float32)}
    cursor = 0
    executed = []
    died_at = None

    def run_phase(ck, start_step, stop_after=None):
        nonlocal params, cursor
        for step in range(start_step, TOTAL_STEPS + 1):
            params, cursor = _apply_step(params, order, cursor)
            executed.append(step)
            ck.journal_step(step, cursor=cursor, rng=[0, step])
            if step % SAVE_EVERY == 0:
                ck.save(step, params)
            if stop_after is not None and step >= stop_after:
                return step
        return TOTAL_STEPS

    ctx = faults.inject(fault_spec) if fault_spec else None
    if ctx:
        ctx.__enter__()
    try:
        ck = AsyncCheckpointer(ckpt_dir, async_save=True, world=2,
                               scheme="zero", max_to_keep=10)
        try:
            last = run_phase(ck, 1, stop_after=kill_after)
            if kill_after is None:
                ck.wait_until_finished()
        except HorovodInternalError:
            died_at = executed[-1]
        else:
            if kill_after is not None and kill_after < TOTAL_STEPS:
                died_at = last
        # Simulated process death: no close(), no barrier — the writer
        # thread is abandoned exactly as a SIGKILL would abandon it.
    finally:
        if ctx:
            ctx.__exit__(None, None, None)

    if died_at is None:
        return params, executed

    # ---- "fresh process": resume from disk + journal ----
    ck2 = AsyncCheckpointer(ckpt_dir, async_save=True, world=4,
                            scheme="zero", max_to_keep=10)
    info = ck2.resume()
    assert info.exact_step == died_at, (info.exact_step, died_at)
    if info.tree is None:
        # Every snapshot was damaged/uncommitted: journal-only recovery
        # replays the whole run from scratch — still exact.
        params = {"w": np.zeros(8, np.float32)}
        cursor = 0
    else:
        params = {"w": np.asarray(info.tree["w"], np.float32).copy()}
        # Rewind the data cursor to the snapshot's position (the
        # journal entry AT the snapshot step holds it; step*BATCH is
        # its closed form here), then replay to the exact step.
        cursor = info.snapshot_step * BATCH
    for entry in info.replay:
        step = int(entry["step"])
        params, cursor = _apply_step(params, order, cursor)
        executed.append(step)
        assert cursor == int(entry["cursor"])   # journal agrees
    assert executed[-1] == died_at              # zero lost steps
    # ---- continue (resized world) to completion ----
    run_phase(ck2, died_at + 1)
    ck2.wait_until_finished()
    ck2.close()
    return params, executed


class TestKillMidSaveDrill:
    def _chaos_knobs(self):
        step = int(os.environ.get("HVD_TPU_CHAOS_STEP", "6"))
        seed = int(os.environ.get("HVD_TPU_CHAOS_SEED", "0"))
        import random

        rng = random.Random(seed)
        mode = rng.choice(("crash-before-rename", "partial-manifest",
                           "corrupt", "partial", "stall"))
        # Clamp onto a step the loop actually saves.
        save_steps = list(range(SAVE_EVERY, TOTAL_STEPS + 1, SAVE_EVERY))
        fault_step = save_steps[step % len(save_steps)]
        return fault_step, mode

    def test_kill_mid_async_save_resumes_exact(self, tmp_path):
        """THE acceptance e2e: kill mid-async-save (crash-before-rename
        at step 6's save), resume from the journal at the exact step,
        finish across the 2→4 resize, byte-identical to the reference."""
        ref_params, ref_steps = _drill(str(tmp_path / "ref"))
        assert ref_steps == list(range(1, TOTAL_STEPS + 1))

        params, executed = _drill(
            str(tmp_path / "chaos"),
            fault_spec="checkpoint:step=6,mode=crash-before-rename")
        np.testing.assert_array_equal(params["w"], ref_params["w"])
        # Every step 1..TOTAL ran; the replayed tail ran exactly the
        # steps the kill threw away, none twice after the resume point.
        assert sorted(set(executed)) == list(range(1, TOTAL_STEPS + 1))

    def test_randomized_fault_mode_drill(self, tmp_path):
        """chaos_soak --mode ckpt entry point: HVD_TPU_CHAOS_STEP/_SEED
        pick the injected save step and the fault mode; every mode must
        resume exact and match the reference."""
        fault_step, mode = self._chaos_knobs()
        ref_params, _ = _drill(str(tmp_path / "ref"))
        params, executed = _drill(
            str(tmp_path / "chaos"),
            fault_spec=f"checkpoint:step={fault_step},mode={mode},"
                       f"delay_ms=50",
            # Damage modes don't raise — the run "dies" two steps later.
            kill_after=min(TOTAL_STEPS - 1, fault_step + 2))
        np.testing.assert_array_equal(params["w"], ref_params["w"])
        assert sorted(set(executed)) == list(range(1, TOTAL_STEPS + 1))


# --- knobs -------------------------------------------------------------------

class TestCkptKnobs:
    def test_async_knob_parses(self, monkeypatch):
        monkeypatch.setenv("HVD_TPU_CKPT_ASYNC", "0")
        assert Config.from_env().ckpt_async is False
        monkeypatch.setenv("HVD_TPU_CKPT_ASYNC", "1")
        assert Config.from_env().ckpt_async is True

    def test_inflight_knob_validated(self, monkeypatch):
        monkeypatch.setenv("HVD_TPU_CKPT_INFLIGHT", "3")
        assert Config.from_env().ckpt_inflight == 3
        monkeypatch.setenv("HVD_TPU_CKPT_INFLIGHT", "0")
        with pytest.raises(ValueError, match="CKPT_INFLIGHT"):
            Config.from_env()

    def test_checkpointer_defaults_from_config(self, tmp_path,
                                               monkeypatch):
        monkeypatch.setenv("HVD_TPU_CKPT_ASYNC", "0")
        import horovod_tpu_torch.basics as basics

        monkeypatch.setattr(basics, "is_initialized", lambda: False)
        ck = AsyncCheckpointer(str(tmp_path / "k"))
        assert ck.async_save is False
        ck.close()


# --- compat tier (the digest-offload satellite) ------------------------------

class TestCompatDigestOffload:
    def test_digest_computed_off_the_caller_thread(self, tmp_path,
                                                   monkeypatch):
        """ISSUE 9 satellite: the sha256 sidecar is computed from the
        offloaded snapshot buffers on the writer thread — a slow digest
        must not bill the step loop."""
        from horovod_tpu_torch.checkpoint import Checkpointer
        from horovod_tpu_torch.ckpt.snapshot import Snapshot

        seen_threads = []
        orig = Snapshot.digest
        DIGEST_S = 3.0

        def spying_digest(self):
            seen_threads.append(threading.current_thread().name)
            time.sleep(DIGEST_S)
            return orig(self)

        monkeypatch.setattr(Snapshot, "digest", spying_digest)
        tree = _tree()
        # Baseline: the same save with digesting off.  The write
        # itself may cost ~1 s of jitter on a busy host, so the bound
        # must be RELATIVE — a billed 3 s digest clears it, an
        # offloaded one cannot.
        with Checkpointer(str(tmp_path / "base"), async_save=False,
                          verify=False) as ck:
            t0 = time.perf_counter()
            ck.save(1, tree)
            base_wall = time.perf_counter() - t0
        d = str(tmp_path / "ck")
        with Checkpointer(d, async_save=False, verify=True) as ck:
            t0 = time.perf_counter()
            ck.save(1, tree)
            save_wall = time.perf_counter() - t0
            ck.wait_until_finished()
        assert save_wall < base_wall + DIGEST_S - 1.0, \
            (save_wall, base_wall)         # the 3 s digest not billed
        assert seen_threads and all("digest" in t for t in seen_threads)
        assert os.path.exists(os.path.join(d, "digests", "1.json"))

    def test_pending_sidecar_blocks_silent_unverified_restore(
            self, tmp_path):
        """A crash between the data commit and the digest write must
        not let restore silently skip verification: the synchronous
        'pending' marker makes the step unverifiable → fallback."""
        from horovod_tpu_torch.checkpoint import Checkpointer

        d = str(tmp_path / "ck")
        with Checkpointer(d, async_save=False) as ck:
            ck.save(1, _tree(scale=1.0))
            ck.save(2, _tree(scale=2.0))
            ck.wait_until_finished()
        # Simulate the crash window: step 2's sidecar back to pending.
        with open(os.path.join(d, "digests", "2.json"), "w") as f:
            json.dump({"step": 2, "pending": True}, f)
        with Checkpointer(d, async_save=False) as ck:
            got = ck.restore()             # falls back to verified 1
            np.testing.assert_array_equal(
                np.asarray(got["params"]["b"]), np.ones(6))
            with pytest.raises(CheckpointCorruptionError,
                               match="pending"):
                ck.restore(2)
        # verify=False deliberately accepts the unverifiable step.
        with Checkpointer(d, async_save=False, verify=False) as ck:
            got = ck.restore(2)
            np.testing.assert_array_equal(
                np.asarray(got["params"]["b"]), np.ones(6) * 2.0)

    def test_sidecar_digest_matches_snapshot_and_tree(self, tmp_path):
        from horovod_tpu_torch.checkpoint import Checkpointer

        tree = _tree()
        d = str(tmp_path / "ck")
        with Checkpointer(d, async_save=False) as ck:
            ck.save(1, tree)
            ck.wait_until_finished()
        with open(os.path.join(d, "digests", "1.json")) as f:
            sidecar = json.load(f)["digest"]
        assert sidecar == pytree_digest(tree)


# --- elastic integration (TorchState) ----------------------------------------

def _linear(seed: int = 0) -> torch.nn.Linear:
    m = torch.nn.Linear(3, 2)
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(rs.randn(2, 3).astype(np.float32)))
        m.bias.copy_(torch.from_numpy(rs.randn(2).astype(np.float32)))
    return m


class TestElasticDurable:
    def test_attach_durable_saves_on_commit(self, tmp_path):
        with AsyncCheckpointer(str(tmp_path / "el"),
                               async_save=True) as ck:
            state = TorchState(model=_linear(0), step=0)
            state.attach_durable(ck, step_attr="step")
            state.step = 3
            with torch.no_grad():
                state.model.weight.fill_(3.0)
            state.commit()
            ck.wait_until_finished()
            assert ck.latest_step() == 3
            resumed = TorchState(model=_linear(1), step=0)
            resumed.load_from(ck)
        np.testing.assert_array_equal(resumed.model.weight.detach().numpy(),
                                      np.full((2, 3), 3.0, np.float32))
        assert int(resumed.step) == 3

    def test_optimizer_state_rides_as_leaves_and_one_json_leaf(
            self, tmp_path):
        """The optimizer's tensors are leaves of their own (a manifest
        splits them across owners); its int keys, hyperparameters and
        the betas tuple ride as one JSON leaf and load back exactly."""
        model = _linear(0)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-2)
        model(torch.ones(4, 3)).sum().backward()
        opt.step()
        with AsyncCheckpointer(str(tmp_path / "opt"), async_save=False,
                               world=2, scheme="zero") as ck:
            state = TorchState(model=model, optimizer=opt, step=1)
            state.attach_durable(ck)
            state.commit()
            paths = {e["path"] for e in
                     ck._store.read_manifest(1).entries.values()}
            assert "'trees'/'optimizer'/'/state/0/exp_avg'" in paths
            assert "'optimizer'/'__state_json__'" in paths
            m2 = _linear(5)
            o2 = torch.optim.AdamW(m2.parameters(), lr=5.0)
            TorchState(model=m2, optimizer=o2, step=0).load_from(ck)
        sd, sd2 = opt.state_dict(), o2.state_dict()
        assert sd["param_groups"] == sd2["param_groups"]
        for i in sd["state"]:
            for key, val in sd["state"][i].items():
                assert torch.equal(val, sd2["state"][i][key])

    def test_sampler_cursor_rides_the_journal_and_save(self, tmp_path):
        with AsyncCheckpointer(str(tmp_path / "sm"),
                               async_save=False) as ck:
            sampler = ElasticSampler(num_samples=16, batch_size=2,
                                     shuffle=True, seed=3)
            state = TorchState(model=_linear(), step=0, sampler=sampler)
            state.attach_durable(ck, step_attr="step")
            for batch in sampler:
                sampler.record_batch(batch)
                state.step += 1
                state.journal_step()
                if state.step == 3:
                    break
            state.commit()
            entries, intact = ck.journal.read()
            assert intact and len(entries) == 3
            assert entries[-1]["sampler"]["num_processed"] == 6
            assert "processed_indices" not in entries[-1]["sampler"]
            resumed = TorchState(
                model=_linear(), step=0,
                sampler=ElasticSampler(num_samples=16, batch_size=2,
                                       shuffle=True, seed=3))
            resumed.load_from(ck)
            assert isinstance(resumed.sampler, ElasticSampler)
            assert len(resumed.sampler.processed_indices) == 6
            assert int(resumed.step) == 3

    def test_load_from_without_live_helper_fails_loudly(self, tmp_path):
        with AsyncCheckpointer(str(tmp_path / "lf"),
                               async_save=False) as ck:
            sampler = ElasticSampler(num_samples=8, batch_size=2)
            state = TorchState(model=_linear(), step=1, sampler=sampler)
            state.attach_durable(ck)
            state.commit()
            bare = TorchState(model=_linear(), step=0)
            with pytest.raises(ValueError, match="sampler"):
                bare.load_from(ck)

    def test_rollback_discards_pending_and_clears_error(self, tmp_path):
        ck = AsyncCheckpointer(str(tmp_path / "rb"), async_save=True)
        state = TorchState(model=_linear(), step=0)
        state.attach_durable(ck)
        state.commit()
        ck.wait_until_finished()
        ck._store.write_step = lambda *a, **kw: 1 / 0   # disk dies
        state.step = 1
        state.commit()
        time.sleep(0.2)
        state.restore()     # the elastic rollback path
        ck._store.write_step = lambda *a, **kw: None
        state.step = 2
        state.commit()
        ck.wait_until_finished()
        ck.close()


# --- parity with the reference ----------------------------------------------

import jax  # noqa: E402
import ml_dtypes  # noqa: E402
from collections import namedtuple  # noqa: E402

from horovod_tpu.ckpt import AsyncCheckpointer as JAsyncCheckpointer  # noqa: E402
from horovod_tpu.ckpt import ShardStore as JShardStore  # noqa: E402
from horovod_tpu.ckpt import StepJournal as JStepJournal  # noqa: E402
from horovod_tpu.ckpt import manifest as jmanifest  # noqa: E402
from horovod_tpu.ckpt import snapshot as jsnapshot  # noqa: E402
from horovod_tpu.obs import flight as jflight  # noqa: E402
from horovod_tpu.obs import metrics as jmetrics  # noqa: E402
from horovod_tpu_torch.ckpt import manifest as tmanifest  # noqa: E402
from horovod_tpu_torch.ckpt import snapshot as tsnapshot  # noqa: E402
from horovod_tpu_torch.obs import metrics as tmetrics  # noqa: E402

Pair = namedtuple("Pair", ["mu", "nu"])


def _seeded_tree(seed: int = 0):
    """Nested dicts (unsorted keys), lists, tuples, a namedtuple, an empty
    subtree and scalars, in several dtypes."""
    rs = np.random.RandomState(seed)
    return {
        "zeta": {"w": rs.randn(5, 7).astype(np.float32),
                 "b": rs.randn(7).astype(np.float64)},
        "alpha": [rs.randint(-9, 9, (3,)).astype(np.int32),
                  (rs.randn(2, 2).astype(np.float32), np.int64(4))],
        "opt": Pair(mu=rs.randn(11).astype(np.float32),
                    nu=np.abs(rs.randn(11)).astype(np.float32)),
        "mask": rs.rand(6) > 0.5,
        "none": None,
        "step": 17,
    }


def _leaf_rows(pkg_snapshot, flatten, tree):
    flat, _ = flatten(tree)
    return [(pkg_snapshot.path_string(p),
             pkg_snapshot.leaf_record_digest(pkg_snapshot.path_string(p),
                                             np.asarray(leaf)).hex())
            for p, leaf in flat]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paths_and_digests_equal_the_reference(seed):
    tree = _seeded_tree(seed)
    ref = _leaf_rows(jsnapshot, jax.tree_util.tree_flatten_with_path, tree)
    got = _leaf_rows(tsnapshot, tsnapshot.tree_flatten_with_path, tree)
    assert got == ref
    assert tsnapshot.pytree_digest(tree) == jsnapshot.pytree_digest(tree)
    assert take_snapshot(tree).leaf_digests() == \
        jsnapshot.take_snapshot(tree).leaf_digests()


@pytest.mark.parametrize("scheme", ["dp", "zero", "fsdp"])
def test_owner_maps_and_skeletons_equal_the_reference(scheme):
    tree = _seeded_tree(3)
    rows = [(leaf.path_str, int(leaf.array.nbytes))
            for leaf in take_snapshot(tree).leaves]
    for world in (1, 2, 3, 5, 8):
        assert tmanifest.assign_owners(rows, world, scheme) == \
            jmanifest.assign_owners(rows, world, scheme)
    jflat, _ = jax.tree_util.tree_flatten_with_path(tree)
    tflat, _ = tsnapshot.tree_flatten_with_path(tree)
    ids = [f"l{i:05d}" for i in range(len(jflat))]
    assert tmanifest.build_skeleton([p for p, _ in tflat], ids) == \
        jmanifest.build_skeleton([p for p, _ in jflat], ids)


def _manifest_doc(store, step):
    doc = json.loads(store.read_manifest(step).to_json())
    doc.pop("created_unix")
    return doc


@pytest.mark.parametrize("world,scheme", [(1, "dp"), (4, "zero"),
                                          (3, "fsdp")])
def test_manifests_and_restore_plans_equal_the_reference(tmp_path, world,
                                                         scheme):
    tree = _seeded_tree(4)
    tstore, jstore = ShardStore(str(tmp_path / "t")), \
        JShardStore(str(tmp_path / "j"))
    tstore.write_step(take_snapshot(tree, step=3), world=world,
                      scheme=scheme)
    jstore.write_step(jsnapshot.take_snapshot(tree, step=3), world=world,
                      scheme=scheme)
    assert _manifest_doc(tstore, 3) == _manifest_doc(jstore, 3)
    tm, jm = tstore.read_manifest(3), jstore.read_manifest(3)
    for new_world in (1, 2, 4, 8):
        for r in range(new_world):
            tp = plan_restore(tm, rank=r, world=new_world)
            jp = jmanifest.plan_restore(jm, rank=r, world=new_world)
            assert (tp.by_file, tp.nbytes, tp.leaf_ids) == \
                (jp.by_file, jp.nbytes, jp.leaf_ids)


def _bf16_pair(seed: int = 5):
    """The same bf16 values as an ml_dtypes array (the reference's leaf)
    and a torch tensor (the port's)."""
    x = np.random.RandomState(seed).randn(4, 6).astype(np.float32)
    return x.astype(ml_dtypes.bfloat16), torch.from_numpy(x).to(
        torch.bfloat16)


def test_cross_read_in_both_directions_with_a_bf16_leaf(tmp_path):
    """A step the reference's ShardStore writes restores in the port, and
    the other way round, bf16 leaf included: equal manifests (but
    ``created_unix``) and tree digests, equal bytes back.  The port
    verifies the bf16 leaf; the reference's own check refuses one it
    wrote itself (``<V2`` written, ``|V2`` read: R4), so it reads both
    steps unverified, and the bf16-free leaves verified."""
    base = _seeded_tree(6)
    ref_bf16, port_bf16 = _bf16_pair()
    jtree = {**base, "h": ref_bf16}
    ttree = {**base, "h": port_bf16}
    jstore = JShardStore(str(tmp_path / "j"))
    tstore = ShardStore(str(tmp_path / "t"))
    jstore.write_step(jsnapshot.take_snapshot(jtree, step=2), world=2,
                      scheme="zero")
    tstore.write_step(take_snapshot(ttree, step=2), world=2, scheme="zero")
    assert _manifest_doc(tstore, 2) == _manifest_doc(jstore, 2)
    assert tsnapshot.pytree_digest(ttree) == jsnapshot.pytree_digest(jtree)
    bits = port_bf16.view(torch.int16).numpy()
    # The reference's step, in the port (verified): every leaf.
    got = ShardStore(str(tmp_path / "j")).read_tree(2)
    assert tsnapshot.pytree_digest(got) == tsnapshot.pytree_digest(ttree)
    np.testing.assert_array_equal(got["h"].view(np.int16), bits)
    assert torch.equal(tsnapshot.to_tensor(got["h"], torch.bfloat16),
                       port_bf16)
    np.testing.assert_array_equal(got["zeta"]["w"], base["zeta"]["w"])
    # The port's step, in the reference.
    back = JShardStore(str(tmp_path / "t")).read_tree(2, verify=False)
    np.testing.assert_array_equal(back["h"].view(np.int16), bits)
    for leaf, ref in ((back["zeta"]["w"], base["zeta"]["w"]),
                      (back["opt"]["mu"], base["opt"].mu),
                      (back["alpha"][1][0], base["alpha"][1][0])):
        np.testing.assert_array_equal(leaf, ref)
    jm = jstore.read_manifest(2)
    plain = {i: e for i, e in jm.entries.items() if e["dtype"] != "<V2"}
    by_file = {}
    for leaf_id, e in plain.items():
        by_file.setdefault(e["file"], []).append(leaf_id)
    JShardStore(str(tmp_path / "t")).read_leaves(
        2, by_file, JShardStore(str(tmp_path / "t")).read_manifest(2),
        verify=True)
    with pytest.raises(Exception, match="digest"):
        jstore.read_tree(2)          # R4: the reference's own bf16 step


def test_torch_tree_digest_equals_the_numpy_tree_digest():
    """A tree of torch tensors digests as its numpy twin in the
    reference: the port's checkpoints of a model carry the reference's
    digests."""
    tree = _seeded_tree(7)
    ttree = {"zeta": {k: torch.from_numpy(v) for k, v in
                      tree["zeta"].items()},
             "opt": Pair(*(torch.from_numpy(v) for v in tree["opt"]))}
    jtree = {"zeta": tree["zeta"], "opt": tree["opt"]}
    assert tsnapshot.pytree_digest(ttree) == jsnapshot.pytree_digest(jtree)


def test_journals_cross_read(tmp_path):
    """A journal either package wrote reads the same in the other, torn
    tail repair included."""
    rng_state = torch.Generator().manual_seed(3).get_state()
    jpath, tpath = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    for journal_cls, path in ((JStepJournal, jpath), (StepJournal, tpath)):
        j = journal_cls(path)
        for s in (1, 2, 2, 3):
            j.append(s, rng=[0, s], cursor=4 * s,
                     sampler={"epoch": 0, "num_processed": s})
        j.close()
    for path in (jpath, tpath):
        je, ji = JStepJournal(path).read()
        te, ti = StepJournal(path).read()
        strip = [{k: v for k, v in e.items() if k != "t_unix"} for e in je]
        assert strip == [{k: v for k, v in e.items() if k != "t_unix"}
                         for e in te] and ji and ti
        assert [e["step"] for e in StepJournal(path).entries_after(1)] == \
            [e["step"] for e in JStepJournal(path).entries_after(1)]
    # The port journals a torch generator's state and tensors as lists.
    j = StepJournal(tpath)
    j.append(4, rng=rng_state, loss=torch.tensor(1.5))
    j.close()
    last = JStepJournal(tpath).read()[0][-1]
    assert last["rng"] == rng_state.tolist() and last["loss"] == 1.5


def test_damaged_step_resume_flight_events_equal_the_reference(tmp_path):
    """The flight events of a resume past a damaged newest step (missing
    shard) and a torn journal line are the reference's, kind by kind and
    field by field (paths aside)."""
    tree = _seeded_tree(8)
    events = []
    for ck_cls, fl, tag in ((JAsyncCheckpointer, jflight, "j"),
                            (AsyncCheckpointer, flight, "t")):
        ck = ck_cls(str(tmp_path / tag), async_save=False)
        for s in (2, 4):
            ck.save(s, tree)
        for s in range(1, 7):
            ck.journal_step(s, rng=[0, s], cursor=s * 4)
        m = ck._store.read_manifest(4)
        os.unlink(os.path.join(ck._store.step_dir(4), m.files()[0]))
        with open(ck.journal.path, "ab") as f:
            f.write(b'{"step": 7')
        fl.reset_for_tests()
        info = ck.resume()
        assert (info.snapshot_step, info.exact_step) == (2, 6)
        events.append([{k: v for k, v in e.items()
                        if k not in ("ts_us", "path", "error")}
                       for e in fl.events()])
        ck.close()
    assert events[1] == events[0]


def test_ckpt_counters_equal_the_reference(tmp_path, monkeypatch):
    """The same saves, coalescing writer, restore and journal give equal
    ``hvd_tpu_ckpt_*`` counters (bytes by kind, coalesced, journal) in
    both packages' registries."""
    import types

    from horovod_tpu.ckpt import journal as jjournal
    from horovod_tpu_torch.ckpt import journal as tjournal

    regs = []
    for mod in (jmetrics, tmetrics):
        reg = mod.MetricsRegistry()
        monkeypatch.setattr(mod, "_default", reg)
        monkeypatch.setattr(mod, "_enabled", True)
        regs.append(reg)
    for mod in (jjournal, tjournal):     # a journal line carries the time
        monkeypatch.setattr(mod, "time",
                            types.SimpleNamespace(time=lambda: 1.5e9))
    tree = _seeded_tree(9)
    for ck_cls, writer_cls, tag in (
            (JAsyncCheckpointer, __import__(
                "horovod_tpu.ckpt", fromlist=["AsyncWriter"]).AsyncWriter,
             "j"),
            (AsyncCheckpointer, AsyncWriter, "t")):
        with ck_cls(str(tmp_path / tag), async_save=False) as ck:
            for s in (1, 2, 3):
                ck.save(s, tree)
                ck.journal_step(s, cursor=s)
            ck.restore()
        gate = threading.Event()
        w = writer_cls(lambda item: gate.wait(5.0), inflight=1)
        w.submit("a")
        time.sleep(0.05)
        w.submit("b")
        w.submit("c")                      # b coalesced away
        gate.set()
        w.close()

    def counters(reg):
        snap = reg.snapshot()
        return {name: sorted((tuple(sorted(dict(s["labels"]).items())),
                              s["value"]) for s in series)
                for name, series in snap.items()
                if name.startswith("hvd_tpu_ckpt_") and name.endswith(
                    "_total")}

    assert counters(regs[1]) == counters(regs[0])
    assert "hvd_tpu_ckpt_coalesced_total" in counters(regs[1])


# --- F9: the state the step objects hold goes through state_dict -------------

import horovod_tpu_torch as thvd  # noqa: E402


@pytest.fixture
def session():
    thvd.init(device="cpu")
    yield
    thvd.shutdown()


_F9 = np.random.RandomState(12)
_F9_W = _F9.randn(4, 8).astype(np.float32)
_F9_B = _F9.randn(4).astype(np.float32)
_F9_DATA = [(_F9.randn(16, 8).astype(np.float32),
             _F9.randn(16, 4).astype(np.float32)) for _ in range(3)]
_F9_LR = 1e-2


def _f9_model() -> torch.nn.Linear:
    m = torch.nn.Linear(8, 4)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(_F9_W))
        m.bias.copy_(torch.from_numpy(_F9_B))
    return m


def _f9_loss(m, batch):
    x, y = batch
    return ((m(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).mean()


def _f9_dopt(m):
    return thvd.DistributedOptimizer(
        torch.optim.AdamW(m.parameters(), lr=_F9_LR),
        named_parameters=m.named_parameters(),
        compression=thvd.Compression.int8, error_feedback=True)


def _f9_dp_step(m, opt, i):
    opt.zero_grad()
    _f9_loss(m, _F9_DATA[i]).backward()
    opt.step()


def test_distributed_optimizer_state_dict_resumes_bit_for_bit(session):
    """A one-rank int8+EF DistributedOptimizer takes 2 steps; its
    state_dict (residual, accumulator and calls with the AdamW state)
    loaded into a fresh optimizer on a fresh copy of the model gives the
    original's step 3 bit for bit.  Before the repair the residual was
    dropped and step 3 left the trajectory."""
    m, opt = _f9_model(), None
    opt = _f9_dopt(m)
    for i in range(2):
        _f9_dp_step(m, opt, i)
    assert max(float(r.abs().max()) for r in opt.residual.values()) > 0
    sd, msd = copy.deepcopy(opt.state_dict()), copy.deepcopy(m.state_dict())
    m2 = _f9_model()
    m2.load_state_dict(msd)
    opt2 = _f9_dopt(m2)
    opt2.load_state_dict(sd)
    _f9_dp_step(m, opt, 2)
    _f9_dp_step(m2, opt2, 2)
    for a, b in zip(m.parameters(), m2.parameters()):
        assert torch.equal(a, b)
    for name, r in opt.residual.items():
        assert torch.equal(opt2.residual[name], r)
    assert set(sd["horovod_tpu_torch"]) == {"residual", "accumulator",
                                            "calls"}


def _f9_zero():
    return thvd.make_zero_train_step(
        _f9_loss, lambda shards: torch.optim.AdamW(shards, lr=_F9_LR),
        compression=thvd.Compression.int8, error_feedback=True)


def test_zero_step_state_dict_resumes_bit_for_bit(session):
    """The same for make_zero_train_step: the shard optimizer's state and
    the residual round-trip through the step's state_dict (loaded before
    the fresh step's first call, which builds its shards from the
    model)."""
    m, step = _f9_model(), _f9_zero()
    for i in range(2):
        step(m, _F9_DATA[i])
    sd, msd = copy.deepcopy(step.state_dict()), copy.deepcopy(m.state_dict())
    assert set(sd) == {"optimizer", "residual"}   # no state_dict at 48c91b0
    m2, step2 = _f9_model(), _f9_zero()
    m2.load_state_dict(msd)
    step2.load_state_dict(sd)
    step(m, _F9_DATA[2])
    step2(m2, _F9_DATA[2])
    for a, b in zip(m.parameters(), m2.parameters()):
        assert torch.equal(a, b)
    for name, r in step.state.residual.items():
        assert torch.equal(step2.state.residual[name], r)


def test_residual_after_two_steps_matches_the_reference(session):
    """The port's residual after 2 int8+EF AdamW steps against the
    reference's ``DistributedOptimizerState.residual`` on the same numpy
    inputs, on the reference's SPMD wire (``ops/quantization.py``; a
    one-device mesh, compiled at backend optimization level 0, R1)."""
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh

    from horovod_tpu.ops.compression import Compression as JCompression
    from horovod_tpu.optim.distributed_optimizer import (
        DistributedOptimizer as JDistributedOptimizer, make_train_step)

    def loss_fn(params, batch):
        x, y = batch
        return jnp.mean((x @ params["weight"].T + params["bias"] - y) ** 2)

    tx = JDistributedOptimizer(optax.adamw(_F9_LR, weight_decay=1e-2),
                               compression=JCompression.int8,
                               error_feedback=True)
    step = make_train_step(loss_fn, tx,
                           mesh=Mesh(np.array(jax.devices()[:1]), ("hvd",)),
                           donate=False)
    params = {"weight": jnp.asarray(_F9_W), "bias": jnp.asarray(_F9_B)}
    state = tx.init(params)
    for i in range(2):
        params, state, _ = step(params, state, tuple(
            jnp.asarray(a) for a in _F9_DATA[i]))
    m = _f9_model()
    opt = _f9_dopt(m)
    for i in range(2):
        _f9_dp_step(m, opt, i)
    for name in ("weight", "bias"):
        np.testing.assert_allclose(opt.residual[name].numpy(),
                                   np.asarray(state.residual[name]),
                                   rtol=0, atol=1e-6)


# --- the whole-tree tier (tests/test_checkpoint.py, but its orbax-message
# --- case, R3) ----------------------------------------------------------------

from horovod_tpu_torch.checkpoint import (  # noqa: E402
    Checkpointer, latest_step, restore, save, should_save_on_this_host,
)


class TestCheckpointer:
    def test_save_restore_roundtrip(self, tmp_path):
        tree = {"params": {"w": np.arange(6.0).reshape(2, 3)},
                "step": np.int64(7)}
        with Checkpointer(str(tmp_path / "ckpt")) as ckpt:
            assert ckpt.save(1, tree)
            ckpt.wait_until_finished()
            got = ckpt.restore(1)
        np.testing.assert_allclose(np.asarray(got["params"]["w"]),
                                   np.arange(6.0).reshape(2, 3))
        assert int(got["step"]) == 7

    def test_latest_and_retention(self, tmp_path):
        with Checkpointer(str(tmp_path / "ckpt"), max_to_keep=2,
                          async_save=False) as ckpt:
            for s in (1, 2, 3):
                ckpt.save(s, {"x": np.full((2,), float(s))})
            assert ckpt.latest_step() == 3
            kept = list(ckpt.all_steps())
            assert 3 in kept and len(kept) <= 2
            got = ckpt.restore()  # latest by default
        np.testing.assert_allclose(np.asarray(got["x"]), [3.0, 3.0])

    def test_restore_missing_raises(self, tmp_path):
        with Checkpointer(str(tmp_path / "empty"), async_save=False) as ckpt:
            with pytest.raises(FileNotFoundError):
                ckpt.restore()

    def test_oneshot_helpers(self, tmp_path):
        d = str(tmp_path / "oneshot")
        save(d, 5, {"v": np.ones((3,))})
        assert latest_step(d) == 5
        got = restore(d)
        np.testing.assert_allclose(np.asarray(got["v"]), np.ones(3))

    def test_should_save_on_this_host(self):
        assert should_save_on_this_host() is True  # rank 0 / no session


def _fill_steps(directory, steps=(1, 2, 3)):
    with Checkpointer(directory, async_save=False, max_to_keep=10) as ckpt:
        for s in steps:
            ckpt.save(s, {"x": np.full((4,), float(s)), "epoch": s})


def _corrupt_step(directory, step):
    """Bit-flip the largest file of a step dir (what a torn write or a
    flipped disk block looks like to the restore path)."""
    from horovod_tpu_torch.checkpoint import _damage_step_dir

    _damage_step_dir(directory, step, "corrupt")


class TestPytreeDigest:
    def test_stable_and_content_sensitive(self):
        a = {"w": np.ones((2, 2)), "n": 3}
        assert pytree_digest(a) == pytree_digest(
            {"w": np.ones((2, 2)), "n": 3})
        assert pytree_digest(a) != pytree_digest(
            {"w": np.ones((2, 2)), "n": 4})
        assert pytree_digest(a) != pytree_digest(
            {"v": np.ones((2, 2)), "n": 3})  # key path matters

    def test_sidecar_written_next_to_save(self, tmp_path):
        d = str(tmp_path / "ck")
        _fill_steps(d, steps=(1,))
        assert os.path.exists(os.path.join(d, "digests", "1.json"))

    def test_container_normalization_invariant(self):
        # A save/restore round trip turns namedtuples into dicts (and
        # reorders leaves: field order vs sorted keys) — not a content
        # change, so the digest must not change.
        from collections import namedtuple

        Opt = namedtuple("Opt", ["mu", "count"])  # non-alphabetical
        as_nt = {"opt": Opt(mu={"w": np.ones((2,))},
                            count=np.zeros((), np.int32))}
        as_dict = {"opt": {"count": np.zeros((), np.int32),
                           "mu": {"w": np.ones((2,))}}}
        assert pytree_digest(as_nt) == pytree_digest(as_dict)
        assert pytree_digest([np.ones(3), np.zeros(2)]) == \
            pytree_digest((np.ones(3), np.zeros(2)))

    def test_namedtuple_state_restores_verified(self, tmp_path):
        # End to end: the optax-shaped tree must restore WITHOUT
        # tripping digest verification (regression: GetAttrKey vs
        # DictKey paths made every such checkpoint look corrupt).
        from collections import namedtuple

        Opt = namedtuple("Opt", ["mu", "count"])
        tree = {"opt": Opt(mu={"w": np.full((2,), 5.0)},
                           count=np.asarray(9, np.int32))}
        d = str(tmp_path / "ck")
        with Checkpointer(d, async_save=False) as ckpt:
            ckpt.save(1, tree)
        with Checkpointer(d, async_save=False) as ckpt:
            got = ckpt.restore()  # latest path: would fall back/raise
        assert int(got["opt"]["count"]) == 9
        np.testing.assert_allclose(np.asarray(got["opt"]["mu"]["w"]),
                                   [5.0, 5.0])


class TestRestoreFallback:
    def test_corrupted_latest_falls_back_to_newest_intact(self, tmp_path):
        d = str(tmp_path / "ck")
        _fill_steps(d)
        _corrupt_step(d, 3)
        with Checkpointer(d, async_save=False) as ckpt:
            got = ckpt.restore()  # latest (3) is damaged -> step 2
        np.testing.assert_allclose(np.asarray(got["x"]), [2.0] * 4)
        assert int(got["epoch"]) == 2

    def test_explicit_step_never_falls_back(self, tmp_path):
        d = str(tmp_path / "ck")
        _fill_steps(d)
        _corrupt_step(d, 3)
        with Checkpointer(d, async_save=False) as ckpt:
            with pytest.raises(Exception):
                ckpt.restore(3)
            # ...while the intact explicit step still restores.
            got = ckpt.restore(1)
        assert int(got["epoch"]) == 1

    def test_template_restore_skips_byte_digest(self, tmp_path):
        # A template restore transforms content (here: a dtype cast) —
        # that is not corruption, so digest verification must not fire.
        d = str(tmp_path / "ck")
        _fill_steps(d, steps=(1,))
        template = {"x": torch.zeros((4,), dtype=torch.bfloat16), "epoch": 0}
        with Checkpointer(d, async_save=False) as ckpt:
            got = ckpt.restore(template=template)
        assert got["x"].dtype == torch.bfloat16

    def test_all_steps_corrupt_raises_corruption_error(self, tmp_path):
        d = str(tmp_path / "ck")
        _fill_steps(d, steps=(1, 2))
        _corrupt_step(d, 1)
        _corrupt_step(d, 2)
        with Checkpointer(d, async_save=False) as ckpt:
            with pytest.raises(CheckpointCorruptionError):
                ckpt.restore()

    def test_injected_corrupt_save_triggers_fallback(self, tmp_path):
        """The fault-site flow end to end: checkpoint:step=3,mode=corrupt
        damages step 3 as it is written; restore degrades to step 2."""
        d = str(tmp_path / "ck")
        with faults.inject("checkpoint:step=3,mode=corrupt"):
            _fill_steps(d)
            assert [h[:2] for h in faults.history()] == [("checkpoint", 3)]
        with Checkpointer(d, async_save=False) as ckpt:
            got = ckpt.restore()
        assert int(got["epoch"]) == 2

    def test_injected_partial_save_triggers_fallback(self, tmp_path):
        d = str(tmp_path / "ck")
        with faults.inject("checkpoint:step=2,mode=partial"):
            _fill_steps(d, steps=(1, 2))
        with Checkpointer(d, async_save=False) as ckpt:
            got = ckpt.restore()
        assert int(got["epoch"]) == 1

    def test_verify_off_skips_digests(self, tmp_path):
        d = str(tmp_path / "ck")
        with Checkpointer(d, async_save=False, verify=False) as ckpt:
            ckpt.save(1, {"x": np.ones((2,))})
        assert not os.path.exists(os.path.join(d, "digests"))
        with Checkpointer(d, async_save=False, verify=False) as ckpt:
            np.testing.assert_allclose(np.asarray(ckpt.restore()["x"]),
                                       [1.0, 1.0])


class TestElasticDurableTier:
    def test_state_save_load(self, tmp_path):
        state = TorchState(model=_linear(0), epoch=3)
        with Checkpointer(str(tmp_path / "el"), async_save=False) as ckpt:
            state.save_to(ckpt, step=3)
            resumed = TorchState(model=_linear(1), epoch=0)
            resumed.load_from(ckpt)
        np.testing.assert_array_equal(
            resumed.model.weight.detach().numpy(),
            _linear(0).weight.detach().numpy())
        assert int(resumed.epoch) == 3


def test_compat_sidecar_holds_the_reference_digest(tmp_path):
    """The whole-tree tier's sidecar holds the reference's digest of the
    same numpy tree, and a torch tree of the same values digests the
    same; the step restores verified."""
    from horovod_tpu.ckpt.snapshot import pytree_digest as jdigest

    tree = _seeded_tree(10)
    tree.pop("none")
    d = str(tmp_path / "ck")
    with Checkpointer(d, async_save=True) as ck:
        ck.save(1, tree)
        ck.wait_until_finished()
        got = ck.restore()
    with open(os.path.join(d, "digests", "1.json")) as f:
        assert json.load(f)["digest"] == jdigest(tree)
    assert pytree_digest(got) == jdigest(tree)
