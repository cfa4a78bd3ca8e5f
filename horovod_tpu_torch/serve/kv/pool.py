"""Refcounted block pool: the host-side allocator behind paged KV.

Counterpart of ``horovod_tpu/serve/kv/pool.py``: the same tables,
refcounts, evictions and stats after the same operations.  The engine's
device pools are torch tensors; this module touches none of them.

One :class:`BlockPool` manages the block ids of one engine's
preallocated per-layer device pools (``[num_blocks, block, H, D]``;
the device tensors themselves live in the engine).  Responsibilities:

* **Allocation** — block ids come from a free list; block 0 is
  reserved as the *trash block*: unmapped block-table entries point at
  it, and the engine's programs route every invalid write (padding,
  rejected speculative tokens, positions past the cache) there, so the
  compiled code needs no masking lattice around scatter/gather.
* **Refcounting + prefix sharing** — a request's chain in the
  :class:`~.prefix.PrefixIndex` increfs every
  matched block; full prompt blocks are shared read-only across
  requests.  A *partial* match (the shared block's tail rows will be
  written by the new request's suffix) is **copy-on-write**: the first
  divergent write forces a private copy (``copy_block`` device
  callback), counted in ``cow_copies_total``.
* **LRU eviction** — a released request's blocks stay resident (and
  indexed) while unreferenced, so the next request with the same
  prefix hits; under allocation pressure the least-recently-used
  unreferenced block (and its unreachable subtree) is evicted and its
  prefix entries dropped — a readmitted prefix then *recomputes*,
  never serves stale blocks.  The ``serve:mode=evict`` fault fires at
  the allocation event and force-evicts the whole cache (the seeded
  pressure drill).

Thread safety: the batcher thread drives prefill/decode, but
``release`` arrives from RPC handler threads (cancel paths), so every
mutation runs under one lock.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional

from ... import faults as faults_mod
from ...obs import instrument as _obs
from .prefix import PrefixIndex

TRASH_BLOCK = 0


class KVPoolExhaustedError(RuntimeError):
    """Every block is referenced by an active request — the pool was
    sized below ``1 + slots * blocks_per_slot`` (the engine validates
    that floor, so this is unreachable through the public API)."""


class BlockPool:
    """Host-side block allocator + prefix-sharing state for one engine.

    ``table`` is the engine's ``[slots, blocks_per_slot + 1]`` int32
    block-table array (the last column is permanently 0 — the trash
    column the engine's programs clamp invalid positions into); the pool
    keeps it in sync with each slot's chain.  ``copy_block(src, dst)``
    is the engine's device copy (COW and partial-prefix
    admission use it).
    """

    def __init__(self, num_blocks: int, block_tokens: int, table,
                 copy_block, *, heads: Optional[int] = None,
                 tp_degree: int = 1,
                 bytes_per_block: Optional[int] = None) -> None:
        if num_blocks < 2:
            raise ValueError(
                f"block pool needs >= 2 blocks (one is the reserved "
                f"trash block), got {num_blocks}")
        self.num_blocks = int(num_blocks)
        self.block = int(block_tokens)
        # Tensor-parallel geometry (docs/tp_serving.md): under TP each
        # shard device holds only ``heads`` (= H/tp) heads of every
        # block, and ``bytes_per_block`` is that per-shard footprint —
        # capacity math, not allocation state.  Block ids, refcounts,
        # the prefix index, and the trash-block discipline are
        # rank-invariant host state: every shard of a replica sees the
        # SAME table, so ``kv_blocks_in_use`` keeps fleet-comparable
        # semantics at any TP degree (a block is in use once per
        # replica, never once per shard).
        self.heads = None if heads is None else int(heads)
        self.tp_degree = int(tp_degree)
        self.bytes_per_block = (None if bytes_per_block is None
                                else int(bytes_per_block))
        self._table = table                       # guarded-by: _lock
        self._copy_block = copy_block
        self._lock = threading.Lock()
        self._free: "collections.deque" = collections.deque(
            range(1, num_blocks))                 # guarded-by: _lock
        self._ref: Dict[int, int] = {}            # guarded-by: _lock
        self._chains: Dict[int, List[int]] = {}   # guarded-by: _lock
        # LRU of unreferenced-but-indexed blocks (eviction candidates).
        self._evictable: "collections.OrderedDict" = \
            collections.OrderedDict()             # guarded-by: _lock
        self._index = PrefixIndex(block_tokens)   # guarded-by: _lock
        # Leading-block keys whose depth-0 block was evicted since the
        # last drain — piggybacked on response frames so the fleet's
        # global prefix directory can drop the entry (bounded: a missed
        # key only costs the directory one stale-route retry).
        self._evicted_keys: "collections.deque" = collections.deque(
            maxlen=256)                           # guarded-by: _lock
        self.evictions_total = 0                  # guarded-by: _lock
        self.cow_copies_total = 0                 # guarded-by: _lock
        self.prefix_hits_total = 0                # guarded-by: _lock
        self.prefix_tokens_shared = 0             # guarded-by: _lock
        from ...analysis import sanitizer as _san

        _san.maybe_register("kv_pool", self)

    # --- read side ----------------------------------------------------------

    def blocks_in_use(self) -> int:
        with self._lock:
            return len(self._ref)

    def probe(self, prompt) -> int:
        """Resident-prefix length for ``prompt`` (no side effects) —
        the batcher's admission-time lookup and the router's affinity
        signal."""
        with self._lock:
            blocks, partial = self._lock_free_match(prompt)
            return self._hit_tokens(len(prompt), blocks, partial)

    def stats(self) -> Dict:
        with self._lock:
            return {
                "kv_blocks_total": self.num_blocks - 1,
                "kv_blocks_in_use": len(self._ref),
                "kv_blocks_cached": len(self._evictable),
                "kv_evictions_total": self.evictions_total,
                "kv_cow_copies_total": self.cow_copies_total,
                "kv_prefix_hits_total": self.prefix_hits_total,
                "kv_prefix_tokens_shared": self.prefix_tokens_shared,
                "heads": self.heads,
                "tp_degree": self.tp_degree,
                "bytes_per_block": self.bytes_per_block,
            }

    def chain_blocks(self, slot: int) -> List[int]:
        """Copy of ``slot``'s live block chain (the KV-migration
        transfer manifest: only these non-trash blocks move)."""
        with self._lock:
            return list(self._chains.get(slot, ()))

    def flush_cache(self) -> int:
        """Drop EVERY cached (unreferenced) block and its prefix-index
        subtree; returns the count freed.  The weight hot-swap flip
        calls this (serve/swap.py): resident KV was computed under the
        OLD weights, and a later prefix hit against it under the new
        weights would emit silently wrong tokens — the one failure mode
        a swap must never trade for its TTFT win.  Evicted leading
        keys land in the normal eviction-notification queue, so the
        fleet's global prefix directory learns too."""
        with self._lock:
            before = self.evictions_total
            self._evict_cached_locked()
            return self.evictions_total - before

    def drain_evicted_keys(self) -> List[tuple]:
        """Leading-block keys evicted since the last drain (consumed:
        the caller owns notifying the prefix directory)."""
        with self._lock:
            out = list(self._evicted_keys)
            self._evicted_keys.clear()
            return out

    # --- request lifecycle --------------------------------------------------

    def bind_imported(self, slot: int, n_blocks: int) -> List[int]:
        """Allocate a fresh ``n_blocks``-long chain for ``slot`` whose
        K/V content arrives over the wire (live KV migration) instead
        of from local prefill.  No prefix match runs — the sender's
        blocks are bound verbatim so the decode continues
        token-identically; ``index_prompt`` afterwards makes the
        imported prefix shareable here like any locally-computed one."""
        if n_blocks < 1:
            raise ValueError(f"n_blocks must be >= 1, got {n_blocks}")
        with self._lock:
            if slot in self._chains:
                raise RuntimeError(f"slot {slot} already has a chain")
            chain: List[int] = []
            try:
                for _ in range(n_blocks):
                    nb = self._alloc_locked()
                    self._ref[nb] = 1
                    chain.append(nb)
            except Exception:
                # Mid-chain exhaustion: blocks already allocated are
                # not yet attached to any chain, so nothing would ever
                # release them — roll them back before propagating or
                # every failed adoption under pressure leaks pool.
                for nb in chain:
                    self._ref.pop(nb, None)
                    self._free.append(nb)
                raise
            self._chains[slot] = chain
            self._write_table_locked(slot)
            self._publish_in_use_locked()
            return chain

    def begin_request(self, slot: int, prompt) -> int:
        """Bind ``slot`` to the longest resident prefix of ``prompt``:
        incref fully matched blocks (shared read-only), COW-copy a
        partial source (its tail rows will be written by the suffix),
        and write the slot's table row.  Returns the number of prefix
        tokens whose K/V need no recompute (always < len(prompt): the
        sampler needs the last prompt token's logits, so at least one
        suffix token always runs)."""
        n = len(prompt)
        with self._lock:
            blocks, partial = self._lock_free_match(prompt)
            chain: List[int] = []
            for b in blocks:
                self._ref[b] = self._ref.get(b, 0) + 1
                self._evictable.pop(b, None)
                chain.append(b)
            plen = 0
            if partial is not None:
                src, plen = partial
                # Copy-on-write at first divergent write — which is the
                # suffix's first token, known to land inside this block,
                # so the private copy happens at admission.
                nb = self._alloc_locked()
                self._copy_block(src, nb)
                self._ref[nb] = 1
                chain.append(nb)
                self.cow_copies_total += 1
                _obs.on_kv_cow_copy()
            self._chains[slot] = chain
            self._write_table_locked(slot)
            hit = len(blocks) * self.block + plen
            if hit > 0:
                self.prefix_hits_total += 1
                self.prefix_tokens_shared += hit
                _obs.on_kv_prefix_hit()
            self._publish_in_use_locked()
            return hit

    def ensure_writable(self, slot: int, start: int, n: int) -> None:
        """Make positions ``[start, start + n)`` of ``slot`` writable:
        allocate chain blocks that do not exist yet and COW any shared
        block in the write range (refcount > 1 means another request
        still reads it).

        A slot with NO chain entry was released concurrently (router
        cancel between the batcher's active-snapshot and this call) —
        allocating for it would create a ghost chain nothing ever
        releases (a permanent block leak), so the call is a no-op: the
        slot's table row is already all-trash and the in-flight decode
        writes harmlessly into block 0."""
        if n <= 0:
            return
        with self._lock:
            chain = self._chains.get(slot)
            if chain is None:
                return
            first = start // self.block
            last = (start + n - 1) // self.block
            if last < len(chain) and all(
                    self._ref.get(chain[j], 0) == 1
                    for j in range(first, last + 1)):
                # Hot-path fast exit: the range is covered by blocks
                # this slot exclusively owns — true for kv_block - 1 of
                # every kv_block decode tokens, so the per-token cost
                # is one lock + one range check, not a table rewrite
                # and gauge publish.
                return
            for j in range(first, last + 1):
                if j < len(chain):
                    b = chain[j]
                    if self._ref.get(b, 0) > 1:
                        nb = self._alloc_locked()
                        self._copy_block(b, nb)
                        self._ref[b] -= 1
                        self._ref[nb] = 1
                        chain[j] = nb
                        self.cow_copies_total += 1
                        _obs.on_kv_cow_copy()
                else:
                    while len(chain) <= j:
                        nb = self._alloc_locked()
                        self._ref[nb] = 1
                        chain.append(nb)
            self._write_table_locked(slot)
            self._publish_in_use_locked()

    def index_prompt(self, slot: int, prompt) -> None:
        """Register ``slot``'s prompt blocks in the prefix index (after
        prefill wrote them): full blocks as trie edges, the partial
        tail as a partial leaf.  Indexed blocks outlive the request —
        release parks them in the LRU instead of freeing."""
        with self._lock:
            chain = self._chains.get(slot)
            if chain:
                self._index.insert(list(prompt), chain)

    def release(self, slot: int) -> None:
        """Drop ``slot``'s references; unreferenced blocks stay
        resident (LRU) while indexed, return to the free list
        otherwise.  The table row is zeroed (everything points at the
        trash block again)."""
        with self._lock:
            chain = self._chains.pop(slot, None) or []
            for b in chain:
                r = self._ref.get(b, 0) - 1
                if r > 0:
                    self._ref[b] = r
                    continue
                self._ref.pop(b, None)
                if self._index.is_indexed(b):
                    self._evictable[b] = True
                    self._evictable.move_to_end(b)
                else:
                    self._free.append(b)
            self._table[slot, :] = TRASH_BLOCK
            self._publish_in_use_locked()

    # --- internals ----------------------------------------------------------

    def _lock_free_match(self, prompt):
        """Index match trimmed so at least one suffix token remains
        (deduplicated between probe and begin_request); caller holds
        the lock."""
        n = len(prompt)
        blocks, partial = self._index.lookup(prompt)
        while blocks and len(blocks) * self.block > n - 1:
            partial = (blocks.pop(), self.block)
        if partial is not None:
            src, plen = partial
            plen = min(plen, n - 1 - len(blocks) * self.block)
            partial = (src, plen) if plen > 0 else None
        return blocks, partial

    def _hit_tokens(self, n: int, blocks, partial) -> int:
        return len(blocks) * self.block + (partial[1] if partial else 0)

    def _write_table_locked(self, slot: int) -> None:
        chain = self._chains.get(slot, [])
        self._table[slot, :len(chain)] = chain  # hvdlint: disable=unguarded-mutation -- _locked suffix contract: every caller holds _lock
        self._table[slot, len(chain):] = TRASH_BLOCK  # hvdlint: disable=unguarded-mutation -- _locked suffix contract: every caller holds _lock

    def _publish_in_use_locked(self) -> None:
        _obs.on_kv_blocks_in_use(len(self._ref))

    def _alloc_locked(self) -> int:
        # The evict fault's event coordinate: one event per allocation.
        if faults_mod._active is not None and faults_mod.on_serve_evict():
            self._evict_cached_locked()
        if not self._free:
            while self._evictable and not self._free:
                b, _ = self._evictable.popitem(last=False)   # oldest
                self._free_subtree_locked(b)
        if not self._free:
            raise KVPoolExhaustedError(
                f"all {self.num_blocks - 1} KV blocks referenced by "
                f"active requests; raise HVD_TPU_SERVE_KV_BLOCKS")
        return self._free.popleft()

    def _evict_cached_locked(self) -> None:
        """Forced pressure (``serve:mode=evict``): drop every cached
        unreferenced block — a readmitted prefix must recompute."""
        while self._evictable:
            b, _ = self._evictable.popitem(last=False)
            self._free_subtree_locked(b)

    def _free_subtree_locked(self, block: int) -> None:
        key = self._index.leading_key(block)
        if key is not None:
            self._evicted_keys.append(key)
        freed = self._index.remove_subtree(block) or [block]
        n = 0
        for d in freed:
            if self._ref.get(d, 0):
                # Unreachable-but-referenced (an active chain still
                # reads it): unlinking from the index is enough — the
                # block frees normally at release.
                continue
            self._ref.pop(d, None)  # hvdlint: disable=unguarded-mutation -- _locked suffix contract: every caller holds _lock
            self._evictable.pop(d, None)
            self._free.append(d)
            n += 1
        self.evictions_total += n  # hvdlint: disable=unguarded-mutation -- _locked suffix contract: every caller holds _lock
        if n:
            _obs.on_kv_evictions(n)
