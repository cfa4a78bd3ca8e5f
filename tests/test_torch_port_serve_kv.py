"""The port's paged-KV bookkeeping (``horovod_tpu_torch/serve/kv``)
against the reference's (``horovod_tpu/serve/kv``): the same seeded
sequences of admissions, writes, indexing, releases, flushes, imports
and forced evictions leave bitwise the same block tables, refcounts,
chains, LRU order, free list, device-copy calls, drained eviction keys
and stats; the prefix trie answers every lookup alike.  Then the
reference's allocator tests (``tests/test_serving.py::
TestBlockPoolUnit``) on the port's pool.
"""

import random

import numpy as np
import pytest

from horovod_tpu import faults as jfaults
from horovod_tpu.serve.kv import BlockPool as JaxBlockPool
from horovod_tpu.serve.kv import PrefixIndex as JaxPrefixIndex

from horovod_tpu_torch import faults
from horovod_tpu_torch.serve.kv import (BlockPool, KVPoolExhaustedError,
                                        PrefixIndex, TRASH_BLOCK)

pytestmark = pytest.mark.serving


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


def _pool(cls, blocks=10, block_tokens=4, slots=2, cols=4):
    table = np.zeros((slots, cols), np.int32)
    copies = []
    pool = cls(blocks, block_tokens, table,
               lambda s, d: copies.append((s, d)))
    return pool, table, copies


def _state(pool, table, copies):
    """Everything a pool holds, in comparable form."""
    return dict(table=table.tolist(), copies=list(copies),
                ref=sorted(pool._ref.items()),
                chains=sorted((s, list(c)) for s, c in pool._chains.items()),
                evictable=list(pool._evictable), free=list(pool._free),
                owners=sorted(pool._index._owners), stats=pool.stats())


def _prompt(rng, families):
    """A prompt from a few families sharing prefixes, diverging at
    random depths (full-block and mid-block sharing both happen)."""
    base = families[rng.randrange(len(families))]
    cut = rng.randrange(1, len(base) + 1)
    tail = [rng.randrange(50, 60) for _ in range(rng.randrange(0, 6))]
    return base[:cut] + tail


def _ops(seed, n_ops=120):
    rng = random.Random(seed)
    families = [[rng.randrange(1, 40) for _ in range(14)] for _ in range(3)]
    ops = []
    for _ in range(n_ops):
        kind = rng.choice(["admit", "admit", "write", "release", "probe",
                           "flush", "import"])
        slot = rng.randrange(3)
        if kind == "admit":
            ops.append(("admit", slot, _prompt(rng, families)))
        elif kind == "write":
            ops.append(("write", slot, rng.randrange(0, 20),
                        rng.randrange(1, 5)))
        elif kind == "import":
            ops.append(("import", slot, rng.randrange(1, 4)))
        else:
            ops.append((kind, slot, _prompt(rng, families)))
    return ops


def _apply(pool, op, live):
    """One operation; returns its observable result (or the error's
    type name)."""
    kind, slot = op[0], op[1]
    try:
        if kind == "admit":
            if slot in live:
                pool.release(slot)
                live.discard(slot)
            hit = pool.begin_request(slot, op[2])
            pool.ensure_writable(slot, hit, len(op[2]) - hit)
            pool.index_prompt(slot, op[2])
            live.add(slot)
            return hit
        if kind == "write":
            pool.ensure_writable(slot, op[2], op[3])
            return None
        if kind == "release":
            pool.release(slot)
            live.discard(slot)
            return None
        if kind == "probe":
            return pool.probe(op[2])
        if kind == "flush":
            return (pool.flush_cache(), pool.drain_evicted_keys())
        if slot in live:
            pool.release(slot)
            live.discard(slot)
        chain = pool.bind_imported(slot, op[2])
        live.add(slot)
        return chain
    except (KVPoolExhaustedError, RuntimeError, ValueError) as e:
        return type(e).__name__


@pytest.mark.parametrize("seed", range(6))
def test_pool_bookkeeping_bitwise_the_reference(seed):
    """Seeded operation sequences, with the ``serve:mode=evict`` fault
    armed in both packages at the same allocation event: identical
    results and identical pool state after every operation."""
    pools = {name: _pool(cls, blocks=14, slots=3, cols=7)
             for name, cls in (("port", BlockPool), ("ref", JaxBlockPool))}
    live = {"port": set(), "ref": set()}
    spec = f"serve:step={3 + seed},mode=evict"
    with faults.inject(spec), jfaults.inject(spec):
        for i, op in enumerate(_ops(seed)):
            got = _apply(pools["port"][0], op, live["port"])
            want = _apply(pools["ref"][0], op, live["ref"])
            assert got == want, (i, op, got, want)
            assert _state(*pools["port"]) == _state(*pools["ref"]), (i, op)
        assert faults.history() == jfaults.history()
    assert pools["port"][0].drain_evicted_keys() == \
        pools["ref"][0].drain_evicted_keys()


@pytest.mark.parametrize("seed", range(3))
def test_prefix_index_answers_as_the_reference(seed):
    rng = random.Random(100 + seed)
    families = [[rng.randrange(1, 30) for _ in range(13)] for _ in range(3)]
    port, ref = PrefixIndex(4), JaxPrefixIndex(4)
    next_block = 1
    for _ in range(80):
        prompt = _prompt(rng, families)
        kind = rng.choice(["insert", "lookup", "lookup", "remove"])
        if kind == "insert":
            chain = list(range(next_block, next_block + len(prompt) // 4 + 1))
            next_block += len(chain)
            port.insert(prompt, chain)
            ref.insert(prompt, chain)
        elif kind == "lookup":
            assert port.lookup(prompt) == ref.lookup(prompt)
        else:
            blk = rng.randrange(1, max(2, next_block))
            assert port.leading_key(blk) == ref.leading_key(blk)
            assert sorted(port.remove_subtree(blk)) == \
                sorted(ref.remove_subtree(blk))
        assert sorted(port._owners) == sorted(ref._owners)
        assert len(port) == len(ref)


# --- the reference's allocator tests ------------------------------------------

def test_full_block_sharing_increfs_partial_cows():
    pool, table, copies = _pool(BlockPool)
    p = [1, 2, 3, 4, 5, 6, 7, 8]
    assert pool.begin_request(0, p + [9]) == 0
    pool.ensure_writable(0, 0, 9)
    pool.index_prompt(0, p + [9])
    hit = pool.begin_request(1, p + [9])
    assert hit == 8                      # both full blocks shared
    assert copies == []                  # read-only: no COW
    pool.ensure_writable(1, 8, 1)
    assert copies == []
    pool.release(1)
    hit = pool.begin_request(1, p + [9, 7])
    assert hit == 9                      # 2 full blocks + 1 partial
    assert len(copies) == 1              # COW fired exactly once
    pool.ensure_writable(1, 9, 1)        # owned copy: no second COW
    assert len(copies) == 1
    assert table[0, 3] == TRASH_BLOCK and table[1, 3] == TRASH_BLOCK


def test_release_parks_indexed_blocks_then_evicts_lru():
    pool, _, _ = _pool(BlockPool, blocks=5)    # 4 usable
    pool.begin_request(0, [1, 2, 3, 4, 5])
    pool.ensure_writable(0, 0, 5)
    pool.index_prompt(0, [1, 2, 3, 4, 5])
    pool.release(0)
    assert pool.blocks_in_use() == 0
    assert pool.probe([1, 2, 3, 4, 5]) == 4
    pool.begin_request(0, list(range(10, 19)))
    pool.ensure_writable(0, 0, 9)
    assert pool.stats()["kv_evictions_total"] > 0
    assert pool.probe([1, 2, 3, 4, 5]) == 0


def test_ensure_writable_after_release_is_noop():
    pool, table, _ = _pool(BlockPool)
    pool.begin_request(0, [1, 2, 3, 4, 5])
    pool.ensure_writable(0, 0, 5)
    pool.release(0)                      # concurrent cancel landed
    pool.ensure_writable(0, 5, 1)        # batcher's stale dispatch
    assert pool.blocks_in_use() == 0     # no ghost allocation
    assert (table[0] == 0).all()         # row stays all-trash


def test_forced_evict_fault_drops_cache():
    pool, _, _ = _pool(BlockPool)
    pool.begin_request(0, [1, 2, 3, 4, 5])
    pool.ensure_writable(0, 0, 5)
    pool.index_prompt(0, [1, 2, 3, 4, 5])
    pool.release(0)
    assert pool.probe([1, 2, 3, 4, 5]) > 0
    with faults.inject("serve:step=0,mode=evict"):
        pool.begin_request(1, [9, 9, 9, 9, 9])
        pool.ensure_writable(1, 0, 5)    # first alloc fires evict
    assert pool.probe([1, 2, 3, 4, 5]) == 0
    assert pool.stats()["kv_evictions_total"] >= 2


def test_prefix_trie_partial_and_mid_block_divergence():
    idx = PrefixIndex(4)
    idx.insert([1, 2, 3, 4, 5, 6], [10, 11])   # 1 full + partial(2)
    blocks, partial = idx.lookup([1, 2, 3, 4, 5, 6, 7])
    assert blocks == [10] and partial == (11, 2)
    blocks, partial = idx.lookup([1, 2, 9, 9])
    assert blocks == [] and partial == (10, 2)
    freed = idx.remove_subtree(10)
    assert sorted(freed) == [10, 11]           # subtree pruned
    assert idx.lookup([1, 2, 3, 4, 5, 6]) == ([], None)


def test_bind_imported_rolls_back_on_exhaustion():
    """A chain that cannot be allocated whole leaves nothing behind."""
    pool, _, _ = _pool(BlockPool, blocks=4)    # 3 usable
    with pytest.raises(KVPoolExhaustedError):
        pool.bind_imported(0, 5)
    assert pool.blocks_in_use() == 0
    assert pool.bind_imported(0, 3) == [1, 2, 3]


def test_pool_needs_two_blocks():
    with pytest.raises(ValueError, match="trash"):
        _pool(BlockPool, blocks=1)
