"""Global prefix directory: leading-block keys → resident replicas.

Counterpart of ``horovod_tpu/serve/fleet/directory.py``,
line for line: host-side bookkeeping with no model in it, so the
port keeps its own copy.

The router-tier promotion of ``serve/kv/prefix.py``'s radix index: the
per-replica trie answers "which of MY blocks hold this prefix"; this
directory answers "which REPLICA holds this prefix", so a system-prompt
hit anywhere in the fleet routes to resident KV instead of a cold
prefill.  It subsumes the single-replica affinity map the router
carried before: entries now track *every* replica a prefix is
resident on (a migration leaves the prefix on both the prefill source
and the decode target), most-recently-confirmed first.

Consistency rules (docs/serving.md):

* entries are **hints**, never correctness — a stale route costs one
  cache miss (the prefix recomputes), so the directory can be lossy in
  both directions;
* a replica's entries are dropped when the router benches it (replica
  death) and when an eviction notification for the key arrives
  piggybacked on one of its response frames
  (``GenerateResponse.evicted_prefixes`` ←
  ``BlockPool.drain_evicted_keys``);
* capacity is bounded LRU — at "millions of users" scale the directory
  must not grow with distinct-prefix count.

Keys are the first ``block_tokens`` token IDs of a prompt — the same
granularity every replica's prefix index shares at, so a key match is
(at least) a one-block cache hit on the resident replica.  Replicas
are opaque hashable handles (the router passes its internal replica
states); the directory never touches the wire.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

_MISSING = object()   # stored values may legitimately be None (no version)


class PrefixDirectory:
    """Bounded, thread-safe leading-block-key → replicas map."""

    def __init__(self, block_tokens: int, max_entries: int = 4096) -> None:
        if block_tokens < 1:
            raise ValueError(
                f"block_tokens must be >= 1, got {block_tokens}")
        self.block = int(block_tokens)
        self.max_entries = int(max_entries)
        self._lock = threading.Lock()
        # key -> OrderedDict(replica -> True); both levels LRU (last =
        # most recently confirmed resident).
        self._entries: "OrderedDict[tuple, OrderedDict]" = OrderedDict()  # guarded-by: _lock
        self.records_total = 0        # guarded-by: _lock
        self.hits_total = 0           # guarded-by: _lock
        self.invalidations_total = 0  # guarded-by: _lock

    def key_for(self, prompt) -> Optional[Tuple[int, ...]]:
        """Directory key for ``prompt``: its leading block's token IDs
        (None for prompts shorter than one block — nothing block-sized
        to share)."""
        if len(prompt) < self.block:
            return None
        return tuple(int(t) for t in prompt[:self.block])

    def record(self, key: tuple, replica, version=None) -> None:
        """Confirm ``key`` resident on ``replica`` (served a request
        whose prefix starts with it, or adopted a migration of it).
        ``version`` tags which weights the resident KV was computed
        under (serve/swap.py): a later lookup must only route to the
        replica while it still serves that version — resident KV from
        OLD weights served against NEW weights would be silently wrong,
        the one failure mode a hot-swap may never trade for its TTFT
        win."""
        if key is None:
            return
        with self._lock:
            reps = self._entries.get(key)
            if reps is None:
                reps = self._entries[key] = OrderedDict()
            reps[replica] = version
            reps.move_to_end(replica)
            self._entries.move_to_end(key)
            self.records_total += 1
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)

    def lookup(self, key: Optional[tuple]) -> List:
        """Replicas with ``key`` resident, most recently confirmed
        first (the caller filters for health/load)."""
        return [rep for rep, _ in self.lookup_versioned(key)]

    def lookup_versioned(self, key: Optional[tuple]) -> List[tuple]:
        """``[(replica, recorded weights version), ...]``, most
        recently confirmed first — the router's mixed-version routing
        rule compares the recorded version against the replica's
        CURRENT one and falls back to a recompute on mismatch."""
        if key is None:
            return []
        with self._lock:
            reps = self._entries.get(key)
            if not reps:
                return []
            self._entries.move_to_end(key)
            self.hits_total += 1
            return [(rep, reps[rep]) for rep in reversed(reps)]

    def discard(self, key: tuple, replica) -> None:
        """Eviction notification: ``replica`` no longer holds ``key``
        (its depth-0 block was evicted)."""
        with self._lock:
            reps = self._entries.get(key)
            if reps is None:
                return
            if reps.pop(replica, _MISSING) is not _MISSING:
                self.invalidations_total += 1
            if not reps:
                del self._entries[key]

    def invalidate_replica(self, replica) -> int:
        """Drop every entry naming ``replica`` (replica death /
        retirement); returns how many entries were dropped."""
        n = 0
        with self._lock:
            for key in list(self._entries):
                reps = self._entries[key]
                if reps.pop(replica, _MISSING) is not _MISSING:
                    n += 1
                if not reps:
                    del self._entries[key]
            self.invalidations_total += n
        return n

    def replicas(self) -> List[str]:
        """Names of every replica the directory currently references —
        the telemetry plane's ``directory_staleness`` detector compares
        this roster against the collector's last-successful-scrape
        times (obs/detect.py)."""
        names = set()
        with self._lock:
            for reps in self._entries.values():
                for rep in reps:
                    spec = getattr(rep, "spec", None)
                    names.add(getattr(spec, "name", None) or str(rep))
        return sorted(names)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> Dict:
        with self._lock:
            return {
                "directory_keys": len(self._entries),
                "directory_records_total": self.records_total,
                "directory_hits_total": self.hits_total,
                "directory_invalidations_total": self.invalidations_total,
            }
