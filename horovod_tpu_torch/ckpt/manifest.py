"""Per-step shard manifests: who owns which leaves, and where they are.

A monolithic checkpoint makes every restore move every byte to every
rank.  The manifest makes ownership explicit: each step's save records,
per leaf, the shard file holding it, the rank set that owns it, its
sha256 digest and byte size — so an elastic resize N→N′ computes, from
metadata alone, exactly which bytes each NEW rank must read, and a
damaged step is detected at manifest granularity (a referenced file
missing or the wrong size) without deserializing anything.

Ownership schemes mirror the optimizer partitions:

* ``dp`` — replicated data parallelism: rank 0 owns everything (only
  rank 0 writes, exactly like the reference examples' rank-0 gating);
  restore loads on rank 0 and broadcasts.
* ``zero`` / ``fsdp`` — leaf-granularity partition of the state across
  ranks (DeepSpeed-stage-1 style): leaves are assigned greedily,
  biggest first, to the least-loaded rank — deterministic, and within
  ~max-leaf of byte-balanced.  A width change just recomputes the
  assignment over the same leaf set; the manifest maps each needed
  leaf back to the old shard file that holds it.

The container *skeleton* (dicts/lists with leaves replaced by ids) is
stored alongside, so a fresh process can rebuild the tree without a
template — with the same normalization orbax applies (tuples → lists,
namedtuples/custom nodes → dicts), which the digest is already
invariant to.

Counterpart of ``horovod_tpu/ckpt/manifest.py``: the same JSON text,
owner maps and restore plans, bit for bit.  Key paths come from the
port's own tree walk (``ckpt/snapshot.py``), whose entries carry the
same ``key``/``idx``/``name`` attributes as jax's.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "SCHEMES", "Manifest", "ManifestError", "assign_owners",
    "shard_filename", "plan_restore", "RestorePlan", "diff_manifest",
]

SCHEMES = ("dp", "zero", "fsdp")

_LEAF_MARK = "__leaf__"


class ManifestError(ValueError):
    """A manifest that cannot be trusted: unparseable, missing fields,
    or referencing shard content that is not there."""


def shard_filename(rank: int) -> str:
    return f"shard_r{int(rank):05d}.npz"


def assign_owners(leaves: Sequence[Tuple[str, int]], world: int,
                  scheme: str) -> Dict[str, int]:
    """``{path_str: owner_rank}`` for every leaf.  ``dp`` pins all to
    rank 0; ``zero``/``fsdp`` balance bytes greedily (stable: sorted by
    (-nbytes, path), ties to the lowest-loaded, lowest-numbered rank) —
    every rank computes the identical assignment from the identical
    leaf set, no coordination needed."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown ownership scheme {scheme!r}; expected "
                         f"one of {SCHEMES}")
    world = max(1, int(world))
    if scheme == "dp":
        return {path: 0 for path, _ in leaves}
    load = [0] * world
    owners: Dict[str, int] = {}
    for path, nbytes in sorted(leaves, key=lambda x: (-int(x[1]), x[0])):
        rank = min(range(world), key=lambda r: (load[r], r))
        owners[path] = rank
        load[rank] += int(nbytes)
    return owners


# --- container skeleton ------------------------------------------------------

def build_skeleton(paths: Sequence[Tuple[Any, ...]],
                   leaf_ids: Sequence[str]) -> Any:
    """Nested dict/list skeleton from typed key paths, leaves replaced
    by ``{"__leaf__": id}`` markers.  Dict keys and attribute names
    become string keys; sequence positions become list slots — the
    orbax-compatible normalization the digest already tolerates."""
    if not paths:
        return {}
    if len(paths) == 1 and len(paths[0]) == 0:
        return {_LEAF_MARK: leaf_ids[0]}   # bare-leaf tree

    root: Dict[Any, Any] = {}
    for path, leaf_id in zip(paths, leaf_ids):
        node = root
        for i, entry in enumerate(path):
            key = _entry_key(entry)
            if i == len(path) - 1:
                node[key] = {_LEAF_MARK: leaf_id}
            else:
                node = node.setdefault(key, {})
    return _listify(root)


def _entry_key(entry) -> Any:
    if hasattr(entry, "idx"):          # SequenceKey / FlattenedIndexKey
        return int(entry.idx)
    for attr in ("key", "name"):       # DictKey / GetAttrKey
        if hasattr(entry, attr):
            return str(getattr(entry, attr))
    return str(entry)


def _listify(node: Any) -> Any:
    """Dicts whose keys are exactly 0..n-1 ints came from sequences —
    rebuild them as lists (tuples normalize to lists, like orbax)."""
    if isinstance(node, dict):
        if _LEAF_MARK in node and len(node) == 1:
            return node
        rebuilt = {k: _listify(v) for k, v in node.items()}
        if rebuilt and all(isinstance(k, int) for k in rebuilt):
            idxs = sorted(rebuilt)
            if idxs == list(range(len(idxs))):
                return [rebuilt[i] for i in idxs]
        return {str(k): v for k, v in rebuilt.items()}
    return node


def skeleton_fill(skeleton: Any, lookup: Dict[str, Any]) -> Any:
    """Rebuild a tree from the skeleton and ``{leaf_id: array}``."""
    if isinstance(skeleton, dict):
        if set(skeleton) == {_LEAF_MARK}:
            return lookup[skeleton[_LEAF_MARK]]
        return {k: skeleton_fill(v, lookup) for k, v in skeleton.items()}
    if isinstance(skeleton, list):
        return [skeleton_fill(v, lookup) for v in skeleton]
    return skeleton


# --- the manifest ------------------------------------------------------------

class Manifest:
    """One step's shard map: ``entries[leaf_id] = {path, file, owners,
    digest, nbytes, dtype, shape}`` plus the skeleton and the combined
    tree digest.  JSON on disk, one per step directory."""

    FILENAME = "manifest.json"

    def __init__(self, *, step: int, world: int, scheme: str,
                 entries: Dict[str, Dict[str, Any]], skeleton: Any,
                 tree_digest: str, created_unix: float = 0.0) -> None:
        self.step = int(step)
        self.world = int(world)
        self.scheme = scheme
        self.entries = entries
        self.skeleton = skeleton
        self.tree_digest = tree_digest
        self.created_unix = created_unix

    @property
    def nbytes(self) -> int:
        return sum(int(e["nbytes"]) for e in self.entries.values())

    def files(self) -> List[str]:
        return sorted({e["file"] for e in self.entries.values()})

    def to_json(self) -> str:
        return json.dumps({
            "format": "hvd_tpu_ckpt_manifest_v1",
            "step": self.step,
            "world": self.world,
            "scheme": self.scheme,
            "created_unix": self.created_unix,
            "tree_digest": self.tree_digest,
            "skeleton": self.skeleton,
            "entries": self.entries,
        }, indent=1, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "Manifest":
        try:
            doc = json.loads(text)
            return cls(step=doc["step"], world=doc["world"],
                       scheme=doc["scheme"], entries=doc["entries"],
                       skeleton=doc["skeleton"],
                       tree_digest=doc["tree_digest"],
                       created_unix=doc.get("created_unix", 0.0))
        except (ValueError, KeyError, TypeError) as e:
            raise ManifestError(f"unreadable manifest: {e}") from e

    @classmethod
    def read(cls, path: str) -> "Manifest":
        try:
            with open(path) as f:
                text = f.read()
        except OSError as e:
            raise ManifestError(f"manifest missing/unreadable: {e}") from e
        return cls.from_json(text)


class RestorePlan:
    """What one rank must read to restore at a (possibly new) world
    size: leaf ids grouped by shard file, and the byte total — computed
    from metadata only, before any data moves."""

    def __init__(self, *, rank: int, world: int,
                 by_file: Dict[str, List[str]], nbytes: int,
                 leaf_ids: List[str]) -> None:
        self.rank = rank
        self.world = world
        self.by_file = by_file
        self.nbytes = nbytes
        self.leaf_ids = leaf_ids


def diff_manifest(manifest: Manifest,
                  have: Dict[str, str]) -> Tuple[Dict[str, List[str]],
                                                 Dict[str, str], int]:
    """Pull plan for a weight hot-swap (serve/swap.py): which of
    ``manifest``'s leaves differ from the running version.

    ``have`` maps key-path → leaf digest of the version currently
    serving.  Returns ``(by_file, changed, nbytes)``: changed leaf ids
    grouped by shard file (the shape :meth:`ShardStore.read_leaves`
    takes), ``{leaf_id: path}`` for the changed set, and the byte total
    the pull will move — a fine-tune step that touched 2 of 40 leaves
    pulls 2 leaves of bytes, decided from metadata alone."""
    by_file: Dict[str, List[str]] = {}
    changed: Dict[str, str] = {}
    nbytes = 0
    for leaf_id, entry in manifest.entries.items():
        path = entry["path"]
        if have.get(path) == entry["digest"]:
            continue
        changed[leaf_id] = path
        by_file.setdefault(entry["file"], []).append(leaf_id)
        nbytes += int(entry["nbytes"])
    for ids in by_file.values():
        ids.sort()
    return by_file, changed, nbytes


def plan_restore(manifest: Manifest, *, rank: int,
                 world: Optional[int] = None,
                 scheme: Optional[str] = None) -> RestorePlan:
    """Re-derive ownership at the NEW world size over the manifest's
    leaf set and map this rank's leaves back to the shard files that
    hold them.  ``world``/``scheme`` default to the manifest's own (the
    no-resize restore); a width change re-shards — leaves migrate
    between ranks purely by reading different manifest rows."""
    world = manifest.world if world is None else int(world)
    scheme = manifest.scheme if scheme is None else scheme
    if not 0 <= rank < max(1, world):
        raise ValueError(f"rank {rank} outside world {world}")
    leaves = [(e["path"], int(e["nbytes"]))
              for e in manifest.entries.values()]
    owners = assign_owners(leaves, world, scheme)
    by_path = {e["path"]: (leaf_id, e)
               for leaf_id, e in manifest.entries.items()}
    by_file: Dict[str, List[str]] = {}
    leaf_ids: List[str] = []
    nbytes = 0
    for path, owner in owners.items():
        if owner != rank:
            continue
        leaf_id, entry = by_path[path]
        by_file.setdefault(entry["file"], []).append(leaf_id)
        leaf_ids.append(leaf_id)
        nbytes += int(entry["nbytes"])
    for ids in by_file.values():
        ids.sort()
    return RestorePlan(rank=rank, world=world, by_file=by_file,
                       nbytes=nbytes, leaf_ids=sorted(leaf_ids))
