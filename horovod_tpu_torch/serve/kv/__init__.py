"""Paged KV-cache serving: block pool, prefix sharing, COW.

Counterpart of ``horovod_tpu/serve/kv``.  Instead of one dense
``[slots, S, H, D]`` row per request, every layer keeps ONE
preallocated ``[num_blocks, block, H, D]`` pool and each request maps
its sequence onto a chain of fixed-size token blocks through a
host-side block table.  Identical prompt prefixes resolve to the same
physical blocks (radix-trie prefix index), divergent writes
copy-on-write, and unreferenced prefix blocks are LRU-evicted under
pressure.

The device pools and the programs that read them live in
:mod:`..engine`; :class:`BlockPool` (allocation, refcounts, COW,
eviction) and :class:`PrefixIndex` (token-trie lookup) here are host
bookkeeping only, so the allocator tests need no model.

Knobs: ``HVD_TPU_SERVE_KV`` (``paged``/``dense``),
``HVD_TPU_SERVE_KV_BLOCK`` (tokens per block),
``HVD_TPU_SERVE_KV_BLOCKS`` (pool budget; 0 = auto),
``HVD_TPU_SERVE_SPEC_K`` (speculative draft length).
"""

from .pool import BlockPool, KVPoolExhaustedError, TRASH_BLOCK  # noqa: F401
from .prefix import PrefixIndex  # noqa: F401
