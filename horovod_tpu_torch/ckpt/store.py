"""Sharded on-disk step store: atomic commits, member-level reads.

Layout (one directory per checkpointed run)::

    <dir>/steps/<N>/manifest.json        # the shard map (manifest.py)
    <dir>/steps/<N>/shard_r00000.npz     # rank 0's leaves, one zip member per leaf
    <dir>/steps/<N>/shard_r00001.npz
    <dir>/.tmp-<N>-<pid>-<k>/            # in-progress write (never read)

Write protocol: everything lands in a tmp directory, every file (and
the directory) is fsync'd, then ONE atomic ``os.replace`` commits the
step.  A crash at any earlier point leaves only an ignorable tmp dir —
the "crash-before-rename" fault mode is exactly that cut.

Storage is uncompressed ``.npz`` (zip-of-arrays) rather than orbax for
the sharded tier deliberately: zip members are independently readable,
so a restore plan that needs 3 leaves out of a 40-leaf shard moves ~3
leaves of bytes (``np.load`` is lazy per member).  orbax 0.7 has no
subset restore — it stays the engine of the monolithic compat tier
(``horovod_tpu.checkpoint``), where whole-tree semantics are the point.

Integrity: per-leaf sha256 digests live in the manifest (computed from
the snapshot buffers on the writer thread — never billed to the step
loop) and are verified on read; a step is *intact* when its manifest
parses and every referenced shard file exists with a plausible size.

Counterpart of ``horovod_tpu/ckpt/store.py`` in the same on-disk format:
a step either package wrote restores in the other.  A bf16 leaf is
stored as its 2-byte view and recorded under the reference's ``<V2``;
it reads back as ``|V2``, which the port's digest maps back to ``<V2``
(the reference's own check refuses such a leaf; ROADMAP queue C, R4).
"""

from __future__ import annotations

import logging
import os
import shutil
import time
from typing import Any, Dict, List, Optional

import numpy as np

from .errors import CheckpointCorruptionError
from .manifest import (Manifest, ManifestError, RestorePlan, assign_owners,
                       build_skeleton, shard_filename, skeleton_fill)
from .snapshot import (Snapshot, combine_leaf_digests, dtype_str,
                       leaf_record_digest)

logger = logging.getLogger(__name__)

__all__ = ["ShardStore"]


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def bitflip_middle(victim: str, nbytes: int = 64) -> int:
    """XOR-flip ``nbytes`` at the middle of ``victim`` — THE simulated
    flipped-disk-block damage, shared by both storage tiers' fault
    application so the chaos model cannot drift between them.  Returns
    the number of bytes flipped."""
    size = os.path.getsize(victim)
    with open(victim, "r+b") as f:
        f.seek(size // 2)
        chunk = f.read(nbytes) or b"\0"
        f.seek(size // 2)
        f.write(bytes(b ^ 0xFF for b in chunk))
    return len(chunk)


class ShardStore:
    def __init__(self, directory: str, *, fsync: bool = True) -> None:
        self._dir = os.path.abspath(directory)
        self._fsync = bool(fsync)
        self._tmp_seq = 0

    @property
    def directory(self) -> str:
        return self._dir

    def _steps_dir(self) -> str:
        return os.path.join(self._dir, "steps")

    def step_dir(self, step: int) -> str:
        return os.path.join(self._steps_dir(), str(int(step)))

    def steps(self) -> List[int]:
        """Committed steps, ascending.  Only a directory whose atomic
        rename happened is listed — tmp dirs are invisible by
        construction."""
        try:
            names = os.listdir(self._steps_dir())
        except OSError:
            return []
        return sorted(int(n) for n in names if n.isdigit())

    def newest_intact_step(self,
                           min_step: Optional[int] = None) -> Optional[int]:
        """Newest committed step that passes manifest-granularity
        validation — the weight-hot-swap subscriber's watch primitive
        (serve/swap.py polls this; a damaged newest step is skipped, so
        a torn upload never becomes a serving version).  ``min_step``
        short-circuits the scan: steps at or below it are not even
        validated (the subscriber already runs one of them)."""
        for step in reversed(self.steps()):
            if min_step is not None and step <= min_step:
                return None
            try:
                self.validate_step(step)
                return step
            except ManifestError:
                continue
        return None

    # --- write ---------------------------------------------------------------

    def write_step(self, snapshot: Snapshot, *, world: int, scheme: str,
                   force: bool = False) -> Optional[Manifest]:
        """Write one step from a snapshot; returns its manifest, or
        None when the step already exists (and ``force`` is off).

        This process writes EVERY rank's shard file: the single-rename
        commit protocol has exactly one writer per step.  (A true
        multi-writer deployment needs a different protocol — per-rank
        commits with the manifest written last — and would live behind
        a new method, not a flag on this one.)
        """
        from .. import faults as faults_mod

        step = int(snapshot.step)
        target = self.step_dir(step)
        if os.path.isdir(target) and not force:
            return None

        mode = None
        if faults_mod._active is not None:
            # One event per save attempt; ``stall`` sleeps inside the
            # hook (a slow filesystem), damage modes come back for the
            # store to apply at the right point in the protocol.
            mode = faults_mod.on_checkpoint_save(step)

        leaf_ids = [f"l{i:05d}" for i in range(len(snapshot.leaves))]
        by_path = {leaf.path_str: (leaf_id, leaf)
                   for leaf_id, leaf in zip(leaf_ids, snapshot.leaves)}
        owners = assign_owners(
            [(leaf.path_str, int(leaf.array.nbytes))
             for leaf in snapshot.leaves], world, scheme)

        entries: Dict[str, Dict[str, Any]] = {}
        per_rank: Dict[int, Dict[str, np.ndarray]] = {}
        for path_str, owner in owners.items():
            leaf_id, leaf = by_path[path_str]
            arr = leaf.array
            if arr.dtype == object:
                raise TypeError(
                    f"checkpoint leaf {path_str!r} has object dtype — "
                    f"only array-convertible leaves are storable")
            entries[leaf_id] = {
                "path": path_str,
                "file": shard_filename(owner),
                "owners": [owner],
                "digest": leaf_record_digest(path_str, arr).hex(),
                "nbytes": int(arr.nbytes),
                "dtype": dtype_str(arr),
                "shape": list(arr.shape),
            }
            per_rank.setdefault(owner, {})[leaf_id] = arr

        # The tree digest combines the leaf records just taken (one
        # sha256 pass over the bytes, not two).
        manifest = Manifest(
            step=step, world=int(world), scheme=scheme, entries=entries,
            skeleton=build_skeleton([leaf.path for leaf in snapshot.leaves],
                                    leaf_ids),
            tree_digest=combine_leaf_digests(
                [bytes.fromhex(e["digest"]) for e in entries.values()]),
            created_unix=time.time())

        self._tmp_seq += 1
        tmp = os.path.join(
            self._dir, f".tmp-{step}-{os.getpid()}-{self._tmp_seq}")
        os.makedirs(tmp, exist_ok=True)
        for rank, arrays in sorted(per_rank.items()):
            path = os.path.join(tmp, shard_filename(rank))
            with open(path, "wb") as f:
                np.savez(f, **arrays)
                f.flush()
                if self._fsync:
                    os.fsync(f.fileno())
        mpath = os.path.join(tmp, Manifest.FILENAME)
        with open(mpath, "w") as f:
            f.write(manifest.to_json())
            f.flush()
            if self._fsync:
                os.fsync(f.fileno())
        if self._fsync:
            _fsync_path(tmp)

        if mode == "crash-before-rename":
            # Everything written, nothing committed: the exact cut a
            # process death between the last fsync and the rename
            # leaves behind.  The tmp dir stays on disk (as a real
            # crash's would); restore never looks at it.
            from ..elastic.state import HorovodInternalError

            raise HorovodInternalError(
                f"injected checkpoint crash-before-rename at step {step}"
                f" (data written to {tmp}, commit never happened)")

        os.makedirs(self._steps_dir(), exist_ok=True)
        if force and os.path.isdir(target):
            # Deferred until the replacement is fully written and
            # fsync'd: a crash during the (long) write must leave the
            # OLD step intact, not neither.
            shutil.rmtree(target)
        os.replace(tmp, target)
        if self._fsync:
            _fsync_path(self._steps_dir())

        if mode in ("corrupt", "partial", "partial-manifest") \
                and _damage_host():
            self._apply_damage(target, manifest, mode)
        return manifest

    def _apply_damage(self, step_dir: str, manifest: Manifest,
                      mode: str) -> None:
        shards = [os.path.join(step_dir, f) for f in manifest.files()]
        shards = [p for p in shards if os.path.exists(p)]
        if not shards:
            logger.warning("fault: no shard files to damage under %s",
                           step_dir)
            return
        if mode == "partial-manifest":
            # The manifest stays intact but references a shard that is
            # not there — the metadata/data split failure mode the
            # manifest-granularity intact check exists for.
            victim = min(shards, key=os.path.getsize)
            os.unlink(victim)
            logger.warning("fault: deleted %s (manifest now dangling)",
                           victim)
            return
        victim = max(shards, key=os.path.getsize)
        if mode == "partial":
            os.unlink(victim)
            logger.warning("fault: deleted %s (partial write)", victim)
            return
        flipped = bitflip_middle(victim)
        logger.warning("fault: corrupted %d bytes of %s", flipped,
                       victim)

    def delete_step(self, step: int) -> None:
        shutil.rmtree(self.step_dir(step), ignore_errors=True)

    # --- read ----------------------------------------------------------------

    def read_manifest(self, step: int) -> Manifest:
        return Manifest.read(os.path.join(self.step_dir(step),
                                          Manifest.FILENAME))

    def validate_step(self, step: int) -> Manifest:
        """Manifest-granularity intactness: the manifest parses and
        every referenced shard file exists and is at least as large as
        the payload it claims.  Raises ``ManifestError`` otherwise —
        no array data is deserialized."""
        manifest = self.read_manifest(step)
        step_dir = self.step_dir(step)
        need: Dict[str, int] = {}
        try:
            # Structural validation: a torn write can leave JSON that
            # parses but is mangled (entry missing 'file'/'nbytes',
            # nbytes='garbage', a non-dict entry).  That is manifest
            # damage — it must feed the fallback scan, never escape it
            # as a raw KeyError/TypeError.
            for entry in manifest.entries.values():
                if not isinstance(entry.get("path"), str) \
                        or not isinstance(entry.get("digest"), str):
                    raise ValueError("entry missing path/digest")
                need[str(entry["file"])] = need.get(
                    str(entry["file"]), 0) + int(entry["nbytes"])
        except (KeyError, TypeError, ValueError, AttributeError) as e:
            raise ManifestError(
                f"step {step}: structurally damaged manifest entry: "
                f"{type(e).__name__}: {e}") from e
        for fname, nbytes in sorted(need.items()):
            path = os.path.join(step_dir, fname)
            try:
                size = os.path.getsize(path)
            except OSError as e:
                raise ManifestError(
                    f"step {step}: manifest references missing shard "
                    f"{fname}: {e}") from e
            if size < nbytes:
                raise ManifestError(
                    f"step {step}: shard {fname} holds {size} bytes but "
                    f"the manifest claims {nbytes} of payload")
        return manifest

    def read_leaves(self, step: int, by_file: Dict[str, List[str]],
                    manifest: Manifest, *,
                    verify: bool = True) -> Dict[str, np.ndarray]:
        """Read exactly the requested leaf ids (grouped by shard file,
        as a :class:`RestorePlan` yields them); ``np.load`` is lazy per
        zip member, so bytes moved ≈ bytes requested.  With ``verify``,
        each leaf is checked against its manifest digest."""
        import zipfile

        step_dir = self.step_dir(step)
        out: Dict[str, np.ndarray] = {}
        for fname, leaf_ids in sorted(by_file.items()):
            path = os.path.join(step_dir, fname)
            try:
                with np.load(path, allow_pickle=False) as z:
                    for leaf_id in leaf_ids:
                        out[leaf_id] = z[leaf_id]
            except (OSError, ValueError, KeyError, EOFError,
                    zipfile.BadZipFile) as e:
                # Bit-flipped members fail the zip CRC before our
                # digest even runs — same verdict either way.
                raise CheckpointCorruptionError(
                    f"step {step}: shard {fname} unreadable: {e}") from e
        if verify:
            for leaf_id, arr in out.items():
                entry = manifest.entries[leaf_id]
                got = leaf_record_digest(entry["path"], arr).hex()
                if got != entry["digest"]:
                    raise CheckpointCorruptionError(
                        f"step {step}: leaf {entry['path']} failed "
                        f"digest verification")
        return out

    def read_tree(self, step: int, *, verify: bool = True) -> Any:
        """Full-tree restore: every leaf, rebuilt into the manifest's
        container skeleton (tuples→lists / namedtuples→dicts
        normalization, same as the orbax tier)."""
        manifest = self.validate_step(step)
        by_file: Dict[str, List[str]] = {}
        for leaf_id, entry in manifest.entries.items():
            by_file.setdefault(entry["file"], []).append(leaf_id)
        leaves = self.read_leaves(step, by_file, manifest, verify=verify)
        try:
            return skeleton_fill(manifest.skeleton, leaves)
        except (KeyError, TypeError) as e:
            # A skeleton referencing a leaf id with no entry is the
            # same torn-manifest class as above.
            raise ManifestError(
                f"step {step}: skeleton/entries mismatch: "
                f"{type(e).__name__}: {e}") from e

    def read_shard(self, step: int, plan: RestorePlan, *,
                   verify: bool = True) -> Dict[str, np.ndarray]:
        """One rank's restore: only the plan's leaves move.  Returns
        ``{path_str: array}`` (the caller scatter/gathers them into its
        partition)."""
        manifest = self.validate_step(step)
        leaves = self.read_leaves(step, plan.by_file, manifest,
                                  verify=verify)
        return {manifest.entries[leaf_id]["path"]: arr
                for leaf_id, arr in leaves.items()}


def _damage_host() -> bool:
    """Apply injected damage on exactly one rank, rank 0 (two ranks
    XOR-flipping the same bytes would cancel out — a false-green chaos
    run)."""
    from .. import basics

    return not basics.is_initialized() or basics.rank() == 0
