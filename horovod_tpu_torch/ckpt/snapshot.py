"""Snapshot-and-offload: the one device→host copy durability costs.

Counterpart of ``horovod_tpu/ckpt/snapshot.py``.  At the step boundary
the caller pays exactly ONE device→host copy of the tree into
host-owned buffers (a :class:`Snapshot`); the shard write, the sha256
digests and the fsync happen on the writer thread against those frozen
buffers.

The copy dispatches by device, leaf by leaf:

* a CUDA tensor is copied into a **pinned** host tensor with
  ``copy_(non_blocking=True)`` on a side stream that first waits on the
  current stream (so the copy reads the parameters the step finished
  writing); :func:`take_snapshot` records one event after the last copy
  and waits on it before it returns, so the writer thread never reads
  bytes the copy has not landed, and the next step may overwrite the
  parameters at once;
* a CPU tensor or an array is copied on the host.

:class:`BufferPool` keeps one buffer set per in-flight snapshot
(``HVD_TPU_CKPT_INFLIGHT`` + 1), so steady-state saving allocates
nothing.

Trees are nested dicts, lists and tuples (namedtuples by field) of
tensors, numpy arrays and scalars; ``None`` is an empty subtree.  The
walk (:func:`tree_flatten_with_path`) is jax's: dict keys sorted, path
tokens ``repr(key)`` and ``repr(idx)``, so path strings, per-leaf digests
and :func:`pytree_digest` equal the reference's for the same numpy tree.
numpy has no bfloat16: a bf16 leaf is stored as its 2-byte view under
the reference's dtype string ``<V2`` (ml_dtypes' bfloat16), and reads
back as bf16 through a template or the live tensor's dtype.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "Snapshot", "SnapshotLeaf", "BufferPool", "take_snapshot",
    "is_snapshotable", "pytree_digest", "leaf_record_digest",
    "tree_flatten_with_path", "tree_unflatten", "path_string",
    "BF16_DTYPE_STR", "to_numpy", "to_tensor",
]

# ml_dtypes' bfloat16 ``dtype.str``: the reference writes it into the
# manifest and its digests; a stored bf16 leaf reads back as ``|V2``.
BF16_DTYPE_STR = "<V2"


# --- the tree walk ------------------------------------------------------------

class DictKey:
    """A dict entry (jax's ``DictKey``; also a namedtuple field)."""

    __slots__ = ("key",)

    def __init__(self, key) -> None:
        self.key = key

    def __repr__(self) -> str:
        return f"DictKey(key={self.key!r})"


class SequenceKey:
    """A list or tuple slot (jax's ``SequenceKey``)."""

    __slots__ = ("idx",)

    def __init__(self, idx: int) -> None:
        self.idx = idx

    def __repr__(self) -> str:
        return f"SequenceKey(idx={self.idx!r})"


class _Leaf:
    """The leaf marker of a tree's structure."""


_LEAF = _Leaf()


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_flatten_with_path(tree: Any) -> Tuple[List[Tuple[tuple, Any]], Any]:
    """``([(path, leaf), ...], structure)`` in jax's flatten order: dict
    keys sorted, sequences in order, namedtuples by field, ``None`` no
    leaf.  ``structure`` rebuilds the containers (:func:`tree_unflatten`)
    and holds no leaf."""
    out: List[Tuple[tuple, Any]] = []

    def walk(node, path):
        if node is None:
            return None
        if isinstance(node, dict):
            keys = sorted(node)
            return (dict, keys, [walk(node[k], path + (DictKey(k),))
                                 for k in keys])
        if _is_namedtuple(node):
            return (type(node), None,
                    [walk(getattr(node, f), path + (DictKey(f),))
                     for f in node._fields])
        if isinstance(node, (list, tuple)):
            return (type(node), None,
                    [walk(v, path + (SequenceKey(i),))
                     for i, v in enumerate(node)])
        out.append((path, node))
        return _LEAF

    structure = walk(tree, ())
    return out, structure


def tree_unflatten(structure: Any, leaves: List[Any]) -> Any:
    """Rebuild a tree of :func:`tree_flatten_with_path`'s structure from
    its leaves, in flatten order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if node is _LEAF:
            return next(it)
        kind, keys, children = node
        built = [build(c) for c in children]
        if kind is dict:
            return dict(zip(keys, built))
        if hasattr(kind, "_fields"):
            return kind(*built)
        return kind(built)

    return build(structure)


def tree_leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in tree_flatten_with_path(tree)[0]]


def _key_token(entry) -> str:
    """One path entry as a container-agnostic token (the reference's:
    ``repr`` of the key, field name or index)."""
    for attr in ("key", "name", "idx"):
        if hasattr(entry, attr):
            return repr(getattr(entry, attr))
    return repr(entry)


def path_string(path: Tuple[Any, ...]) -> str:
    return "/".join(_key_token(e) for e in path)


# --- leaves as numpy ----------------------------------------------------------

def to_numpy(leaf: Any) -> np.ndarray:
    """A host numpy copy of one leaf (bf16 as its ``V2`` view)."""
    if torch.is_tensor(leaf):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.array(leaf, copy=True)


def dtype_str(arr: np.ndarray) -> str:
    """The dtype string of a leaf's record: ``<V2`` for a 2-byte void
    leaf (bf16, written or read back), as the reference writes
    ml_dtypes' bfloat16."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return BF16_DTYPE_STR
    return arr.dtype.str


def to_tensor(arr: np.ndarray, dtype: Optional[torch.dtype] = None,
              device=None) -> torch.Tensor:
    """A restored numpy leaf as a tensor of ``dtype`` (a ``V2`` leaf is
    bf16's bytes)."""
    arr = np.asarray(arr)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    if dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    return t.to(device) if device is not None else t


# --- digests ------------------------------------------------------------------

def leaf_record_digest(path_str: str, arr: np.ndarray) -> bytes:
    """The per-leaf record the tree digest is built from: sha256 over
    (key path, dtype string, shape, raw bytes)."""
    r = hashlib.sha256()
    r.update(path_str.encode())
    r.update(dtype_str(arr).encode())
    r.update(repr(arr.shape).encode())
    # The bytes through the buffer protocol: no copy of the leaf.
    r.update(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
    return r.digest()


def combine_leaf_digests(records: List[bytes]) -> str:
    """Order-insensitive combination (sorted), the reference's."""
    h = hashlib.sha256()
    for record in sorted(records):
        h.update(record)
    return h.hexdigest()


def pytree_digest(tree: Any) -> str:
    """Content digest of a tree: sha256 over per-leaf records of (key
    path, dtype, shape, raw bytes), combined order-insensitively."""
    flat, _ = tree_flatten_with_path(tree)
    return combine_leaf_digests(
        [leaf_record_digest(path_string(path), to_numpy(leaf))
         for path, leaf in flat])


def is_snapshotable(tree: Any) -> bool:
    """Every leaf of a port tree lives in this process."""
    return True


# --- the snapshot -------------------------------------------------------------

class SnapshotLeaf:
    """One offloaded leaf: its typed key path, the stable path string
    (digests, manifests) and the host buffer."""

    __slots__ = ("path", "path_str", "array")

    def __init__(self, path: Tuple[Any, ...], path_str: str,
                 array: np.ndarray) -> None:
        self.path = path
        self.path_str = path_str
        self.array = array


class Snapshot:
    """A frozen host copy of one tree at one step.  The writer thread
    reads it; nothing mutates it after :func:`take_snapshot` returns."""

    def __init__(self, step: int, leaves: List[SnapshotLeaf],
                 treedef, buffers: Optional[Dict[str, Any]],
                 pool: Optional["BufferPool"]) -> None:
        self.step = int(step)
        self.leaves = leaves
        self.treedef = treedef
        self._buffers = buffers
        self._pool = pool

    @property
    def nbytes(self) -> int:
        return sum(int(leaf.array.nbytes) for leaf in self.leaves)

    def tree(self) -> Any:
        """The (numpy) tree with the original container structure."""
        return tree_unflatten(self.treedef,
                              [leaf.array for leaf in self.leaves])

    def digest(self) -> str:
        """Tree digest from the snapshot buffers, equal to
        ``pytree_digest(tree)``."""
        return combine_leaf_digests(
            [leaf_record_digest(leaf.path_str, leaf.array)
             for leaf in self.leaves])

    def leaf_digests(self) -> Dict[str, str]:
        """Per-leaf hex digests keyed by path string (manifest rows)."""
        return {leaf.path_str: leaf_record_digest(leaf.path_str,
                                                  leaf.array).hex()
                for leaf in self.leaves}

    def release(self) -> None:
        """Return pooled buffers (write finished, or the snapshot was
        coalesced away).  Idempotent."""
        if self._pool is not None and self._buffers is not None:
            self._pool.release(self._buffers)
        self._buffers = None
        self._pool = None


class BufferPool:
    """Reusable host buffer sets, one per concurrently live snapshot.

    ``acquire`` hands out a dict keyed by leaf path;
    :func:`take_snapshot` copies into a matching (dtype, shape) buffer and
    replaces a mismatched one.  An exhausted pool falls back to fresh
    allocation rather than blocking the step loop."""

    def __init__(self, depth: int) -> None:
        self._lock = threading.Lock()
        self._free: List[Dict[str, Any]] = [
            {} for _ in range(max(1, int(depth)))]
        self._outstanding = 0   # guarded-by: _lock

    def acquire(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            if self._free:
                self._outstanding += 1
                return self._free.pop()
        return None

    def release(self, buffers: Dict[str, Any]) -> None:
        with self._lock:
            self._free.append(buffers)
            self._outstanding -= 1

    def outstanding(self) -> int:
        with self._lock:
            return self._outstanding


def _host_view(buf: torch.Tensor) -> np.ndarray:
    if buf.dtype == torch.bfloat16:
        return buf.view(torch.int16).numpy().view("V2")
    return buf.numpy()


def take_snapshot(tree: Any, *, step: int = 0,
                  pool: Optional[BufferPool] = None) -> Snapshot:
    """Copy ``tree`` into owned (pooled when possible) host buffers:
    the whole of what a save costs the step loop."""
    flat, treedef = tree_flatten_with_path(tree)
    buffers = pool.acquire() if pool is not None else None
    if buffers:
        live = {path_string(p) for p, _ in flat}
        for key in [k for k in buffers if k not in live]:
            del buffers[key]
    leaves: List[SnapshotLeaf] = []
    side = None
    for path, leaf in flat:
        pstr = path_string(path)
        old = buffers.get(pstr) if buffers is not None else None
        if torch.is_tensor(leaf):
            src = leaf.detach()
            on_card = src.device.type == "cuda"
            if not (torch.is_tensor(old) and old.dtype == src.dtype
                    and old.shape == src.shape
                    and old.is_pinned() == on_card):
                old = torch.empty(src.shape, dtype=src.dtype,
                                  pin_memory=on_card)
                if buffers is not None:
                    buffers[pstr] = old
            if on_card:
                if side is None:
                    side = torch.cuda.Stream(device=src.device)
                    side.wait_stream(torch.cuda.current_stream(src.device))
                with torch.cuda.stream(side):
                    old.copy_(src, non_blocking=True)
            else:
                old.copy_(src)
            arr = _host_view(old)
        else:
            arr = np.asarray(leaf)
            if isinstance(old, np.ndarray) and old.dtype == arr.dtype \
                    and old.shape == arr.shape:
                np.copyto(old, arr)
                arr = old
            else:
                arr = np.array(arr, copy=True)
                if buffers is not None:
                    buffers[pstr] = arr
        leaves.append(SnapshotLeaf(path, pstr, arr))
    if side is not None:
        done = torch.cuda.Event()
        done.record(side)
        done.synchronize()
    return Snapshot(step, leaves, treedef, buffers, pool)
