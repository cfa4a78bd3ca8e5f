"""Radix/trie prefix index over token-ID blocks.

Counterpart of ``horovod_tpu/serve/kv/prefix.py``, line for line: pure
host bookkeeping, so the port keeps its own copy.

Maps token prefixes to resident KV blocks so identical prompt prefixes
(system prompts shared across millions of requests) resolve to the same
physical blocks.  The trie is keyed by *full-block* token tuples — one
edge per ``block_tokens``-sized chunk — plus per-node *partial* leaves
for prompt tails that do not fill a block.  A partial leaf (or a full
block matched only part-way) can still be shared: the reader uses the
first ``r`` rows of the block and copy-on-writes before its first
divergent write (``pool.BlockPool`` owns that protocol; this module is
pure host-side bookkeeping and never touches device memory).

Ownership registry: every block this index references is registered in
``_owners`` so eviction can unlink it (and its now-unreachable subtree)
in O(subtree).  Blocks whose content duplicates an already-indexed node
are simply not registered — one chain of physical blocks per distinct
prefix.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple


class _Node:
    __slots__ = ("block", "children", "partials")

    def __init__(self, block: Optional[int]) -> None:
        self.block = block
        # full-block token tuple -> child node
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        # partial token tuple (< block_tokens) -> block id
        self.partials: Dict[Tuple[int, ...], int] = {}


def _common_prefix(a: Tuple[int, ...], b: Tuple[int, ...]) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


class PrefixIndex:
    """Trie over token-ID blocks; see the module docstring."""

    def __init__(self, block_tokens: int) -> None:
        if block_tokens < 1:
            raise ValueError(f"block_tokens must be >= 1, got {block_tokens}")
        self.block = int(block_tokens)
        self._root = _Node(None)
        # block id -> ("full"|"partial", parent node, edge key, node|None)
        self._owners: Dict[int, Tuple[str, _Node, Tuple[int, ...],
                                      Optional[_Node]]] = {}

    def __len__(self) -> int:
        return len(self._owners)

    def is_indexed(self, block: int) -> bool:
        return block in self._owners

    def leading_key(self, block: int) -> Optional[Tuple[int, ...]]:
        """The root-level edge key (the first ``block_tokens`` token
        IDs) when ``block`` is a depth-0 full block, else None — the
        granularity the fleet's global prefix directory keys on, so an
        eviction of a depth-0 block is exactly the event that
        invalidates a directory entry."""
        info = self._owners.get(block)
        if info is None:
            return None
        kind, parent, key, _ = info
        return key if kind == "full" and parent is self._root else None

    def lookup(self, prompt) -> Tuple[List[int],
                                      Optional[Tuple[int, int]]]:
        """Longest resident match for ``prompt``: a chain of fully
        matched blocks plus, optionally, one ``(block, shared_tokens)``
        partial source whose leading rows extend the match (a partial
        leaf, or a full block whose tokens diverge mid-block)."""
        B = self.block
        node = self._root
        blocks: List[int] = []
        i, n = 0, len(prompt)
        while i + B <= n:
            child = node.children.get(tuple(prompt[i:i + B]))
            if child is None:
                break
            blocks.append(child.block)
            node = child
            i += B
        rest = tuple(prompt[i:])
        best: Optional[Tuple[int, int]] = None
        if rest:
            for key, blk in node.partials.items():
                m = _common_prefix(key, rest)
                if m > 0 and (best is None or m > best[1]):
                    best = (blk, m)
            for key, child in node.children.items():
                m = _common_prefix(key, rest)
                if m > 0 and (best is None or m > best[1]):
                    best = (child.block, m)
        return blocks, best

    def insert(self, prompt, chain: List[int]) -> None:
        """Register ``chain``'s blocks for ``prompt``'s prefix: one
        trie edge per full block, the partial tail (if any) as a
        partial leaf.  Blocks duplicating an existing node (another
        physical copy of the same prefix) stay unregistered — the index
        keeps exactly one chain per distinct prefix."""
        B = self.block
        node = self._root
        i, bi, n = 0, 0, len(prompt)
        while i + B <= n and bi < len(chain):
            key = tuple(prompt[i:i + B])
            child = node.children.get(key)
            if child is None:
                blk = chain[bi]
                if blk in self._owners:   # already indexed elsewhere
                    return
                child = _Node(blk)
                node.children[key] = child
                self._owners[blk] = ("full", node, key, child)
            node = child
            i += B
            bi += 1
        if i < n and bi < len(chain):
            key = tuple(prompt[i:])
            blk = chain[bi]
            if key not in node.partials and blk not in self._owners:
                node.partials[key] = blk
                self._owners[blk] = ("partial", node, key, None)

    def remove_subtree(self, block: int) -> List[int]:
        """Unlink ``block`` from the trie and return every indexed
        block that became unreachable (the block itself plus, for a
        full-block node, its whole subtree — a chain is only reachable
        through its ancestors)."""
        info = self._owners.pop(block, None)
        if info is None:
            return []
        kind, parent, key, node = info
        if kind == "partial":
            parent.partials.pop(key, None)
            return [block]
        parent.children.pop(key, None)
        freed: List[int] = []
        stack = [node]
        while stack:
            cur = stack.pop()
            if cur.block is not None:
                freed.append(cur.block)
                self._owners.pop(cur.block, None)
            for blk in cur.partials.values():
                freed.append(blk)
                self._owners.pop(blk, None)
            stack.extend(cur.children.values())
        return freed
