"""AsyncCheckpointer: snapshot-and-offload durable state, end to end.

The user-facing class of :mod:`horovod_tpu.ckpt` — what the elastic
tier and the training loop talk to:

* ``save(step, tree)`` costs the caller ONE device→host snapshot
  (:mod:`.snapshot`) and returns; a bounded background writer
  (:mod:`.writer`, ``HVD_TPU_CKPT_ASYNC`` / ``HVD_TPU_CKPT_INFLIGHT``)
  does the sharded write + digests + fsync (:mod:`.store`), coalescing
  back-to-back saves (drop-oldest-unwritten) when the disk is slower
  than the save cadence.  Writer failures surface on the next
  ``save``/``wait_until_finished``/``close``.
* ``journal_step(step, rng=…, sampler=…, knobs=…)`` appends one fsync'd
  line of step metadata (:mod:`.journal`) — cheap enough for every
  step, so recovery replays to the exact failed step.
* ``restore``/``restore_shard`` read the newest *intact* step (intact
  decided at manifest granularity), falling back deterministically and
  leaving a flight-recorder event when a newer step is damaged.
* ``resume()`` is the recovery entry point: newest intact snapshot +
  the journal tail past it + the exact step to end up at.

Save/restore stall and write time land in the obs registry
(``hvd_tpu_ckpt_save_stall_us`` / ``_write_us`` / ``_bytes_total`` /
``_inflight``), and the ``hvd_tpu_ckpt_save``/``_restore`` spans gain
``offload``/``write`` children.

Counterpart of ``horovod_tpu/ckpt/checkpointer.py``.  The world and rank
come from the port's session; the primary process, the one writer of
the single-rename commit and of the journal, is rank 0.  Restored trees
are numpy; a ``template`` of tensors casts them back by key path, onto
the template leaves' dtypes and devices.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .errors import CheckpointCorruptionError
from .journal import StepJournal, _jsonable
from .manifest import ManifestError, RestorePlan, plan_restore
from .snapshot import (BufferPool, Snapshot, is_snapshotable, path_string,
                       take_snapshot, to_tensor, tree_flatten_with_path,
                       tree_leaves, tree_unflatten)
from .store import ShardStore
from .writer import AsyncWriter
from ..obs import trace as trace_mod

logger = logging.getLogger(__name__)

__all__ = ["AsyncCheckpointer", "ResumeInfo"]


class ResumeInfo:
    """Everything recovery needs: the restored tree at
    ``snapshot_step``, the journal entries to replay (ordered, past the
    snapshot), and ``exact_step`` — where the run actually was when it
    died.  ``replay`` empty means the snapshot IS the exact step."""

    def __init__(self, *, tree: Any, snapshot_step: Optional[int],
                 replay: List[Dict[str, Any]], exact_step: int,
                 journal_intact: bool) -> None:
        self.tree = tree
        self.snapshot_step = snapshot_step
        self.replay = replay
        self.exact_step = exact_step
        self.journal_intact = journal_intact


def _resolved_config():
    from .. import basics
    from ..config import Config

    return basics.config() if basics.is_initialized() else Config.from_env()


class AsyncCheckpointer:
    """Async sharded durable state under ``directory``.

    ``world``/``rank``/``scheme`` declare the ownership partition the
    manifests record (``dp``: rank-0-only, as the reference examples
    gate it; ``zero``/``fsdp``: leaves byte-balanced across ranks).
    They default to the live world (or 1×``dp`` pre-init) and exist as
    parameters so elastic drills and benchmarks can simulate N→N′
    resizes on one controller.
    """

    def __init__(self, directory: str, *,
                 world: Optional[int] = None,
                 rank: Optional[int] = None,
                 scheme: str = "dp",
                 async_save: Optional[bool] = None,
                 inflight: Optional[int] = None,
                 verify: Optional[bool] = None,
                 max_to_keep: int = 3,
                 journal: bool = True,
                 fsync: bool = True) -> None:
        cfg = _resolved_config()
        if async_save is None:
            async_save = cfg.ckpt_async
        if inflight is None:
            inflight = cfg.ckpt_inflight
        if verify is None:
            verify = cfg.checkpoint_digest
        if world is None or rank is None:
            world = world if world is not None else self._live_world()
            rank = rank if rank is not None else self._live_rank(world)
        self._world = max(1, int(world))
        self._rank = int(rank)
        # The shard store's single-rename commit protocol has exactly
        # ONE writer per step, and the journal is one shared file: in
        # a real multi-controller world only the primary process
        # writes (every process may restore).  Simulated worlds
        # (world=N on one controller) are unaffected — there is one
        # process.
        self._is_writer = self._primary_process()
        self._scheme = scheme
        self._verify = bool(verify)
        self._max_to_keep = max(1, int(max_to_keep))
        self._store = ShardStore(directory, fsync=fsync)
        self._pool = BufferPool(int(inflight) + 1)
        self._writer = AsyncWriter(
            self._write_one, inflight=int(inflight),
            on_drop=self._drop) if async_save else None
        self._journal = StepJournal(
            os.path.join(self._store.directory, "journal.jsonl"),
            fsync=fsync) if journal else None
        import threading

        self._pending_lock = threading.Lock()
        self._pending_steps: set = set()   # guarded-by: _pending_lock

    @staticmethod
    def _live_world() -> int:
        from .. import basics

        return basics.size() if basics.is_initialized() else 1

    @staticmethod
    def _primary_process() -> bool:
        from .. import basics

        return not basics.is_initialized() or basics.rank() == 0

    @staticmethod
    def _live_rank(world: int) -> int:
        from .. import basics

        return basics.rank() % max(1, world) if basics.is_initialized() else 0

    # --- properties ----------------------------------------------------------

    @property
    def directory(self) -> str:
        return self._store.directory

    @property
    def journal(self) -> Optional[StepJournal]:
        return self._journal

    @property
    def async_save(self) -> bool:
        return self._writer is not None

    def latest_step(self) -> Optional[int]:
        steps = self._store.steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        return self._store.steps()

    # --- save ----------------------------------------------------------------

    def save(self, step: int, tree: Any, *, force: bool = False) -> bool:
        """Snapshot ``tree`` and hand it to the writer; returns as soon
        as the host copy exists.  False when ``step`` is already
        committed (and ``force`` is off).  A writer failure from an
        EARLIER save raises here — async saves never fail silently."""
        from ..obs import instrument as _obs

        if not self._is_writer:
            # Non-primary controllers must not race the single-writer
            # commit (the losing os.replace would raise ENOTEMPTY and
            # poison the writer) nor N-fold-amplify the write.
            return False
        with trace_mod.span("hvd_tpu_ckpt_save",
                            args={"step": int(step), "async":
                                  self._writer is not None}):
            with self._pending_lock:
                queued = int(step) in self._pending_steps
            if not force and (queued
                              or int(step) in self._store.steps()):
                # Also catches a step still in the writer queue: its
                # eventual commit would make the store skip THIS tree
                # silently while we had returned True for it.
                return False
            if not is_snapshotable(tree):
                raise ValueError(
                    "tree spans non-addressable devices; the sharded "
                    "tier needs host-addressable leaves")
            t0 = time.perf_counter()
            with trace_mod.span("hvd_tpu_ckpt_offload",
                                args={"step": int(step)}):
                snap = take_snapshot(tree, step=int(step),
                                     pool=self._pool)
            with self._pending_lock:
                self._pending_steps.add(int(step))
            try:
                if self._writer is not None:
                    self._writer.submit((snap, force))
                else:
                    self._write_one((snap, force))
            except BaseException:
                # An EARLIER save's failure surfacing here must not
                # leak this snapshot's pooled buffers.
                snap.release()
                self._unqueue(int(step))
                raise
            stall_us = (time.perf_counter() - t0) * 1e6
            _obs.on_ckpt_save(stall_us, snap.nbytes, self._inflight())
        return True

    def _inflight(self) -> int:
        return self._writer.depth() if self._writer is not None else 0

    def _unqueue(self, step: int) -> None:
        with self._pending_lock:
            self._pending_steps.discard(int(step))

    def _drop(self, item: Tuple[Snapshot, bool]) -> None:
        item[0].release()
        self._unqueue(item[0].step)

    def _write_one(self, item: Tuple[Snapshot, bool]) -> None:
        from ..obs import instrument as _obs

        snap, force = item
        try:
            t0 = time.perf_counter()
            with trace_mod.span("hvd_tpu_ckpt_write",
                                args={"step": snap.step,
                                      "nbytes": snap.nbytes}):
                manifest = self._store.write_step(
                    snap, world=self._world, scheme=self._scheme,
                    force=force)
                if manifest is not None:
                    self._prune()
            _obs.on_ckpt_write((time.perf_counter() - t0) * 1e6,
                               snap.nbytes)
        finally:
            snap.release()
            self._unqueue(snap.step)
            _obs.on_ckpt_inflight(self._inflight())

    def _prune(self) -> None:
        steps = self._store.steps()
        for old in steps[:-self._max_to_keep]:
            self._store.delete_step(old)

    # --- journal -------------------------------------------------------------

    def journal_step(self, step: int, *, rng: Any = None,
                     sampler: Any = None,
                     knobs: Optional[Dict[str, Any]] = None,
                     **extra: Any) -> None:
        """Append one step's replay metadata (no-op when the journal is
        disabled).  ``rng`` is any array-like key; ``sampler`` anything
        with a ``state_dict()`` (the elastic sampler's cursor) or an
        already-plain dict; ``knobs`` the autotune snapshot."""
        if self._journal is None or not self._is_writer:
            return
        meta: Dict[str, Any] = dict(extra)
        if rng is not None:
            meta["rng"] = (_jsonable(rng) if isinstance(rng, torch.Generator)
                           or torch.is_tensor(rng)
                           else np.asarray(rng).tolist())
        if sampler is not None:
            state_dict = getattr(sampler, "state_dict", None)
            sd = state_dict() if callable(state_dict) else sampler
            if isinstance(sd, dict) and "processed_indices" in sd:
                # The full index list grows by batch-size EVERY step —
                # journaling it raw would make the fsync'd line (and
                # the file) quadratic in run length.  The compact
                # cursor is sufficient for replay: the snapshot's
                # durable save carries the full cursor, and replay
                # re-steps the sampler deterministically from there.
                compact = {k: v for k, v in sd.items()
                           if k != "processed_indices"}
                compact["num_processed"] = len(sd["processed_indices"])
                sd = compact
            meta["sampler"] = sd
        if knobs is not None:
            meta["knobs"] = dict(knobs)
        self._journal.append(int(step), **meta)

    # --- restore -------------------------------------------------------------

    def _drain_for_read(self) -> None:
        """Land pending writes before reading; a writer failure here is
        recorded, not raised — restore IS the recovery path and must
        work with whatever is intact on disk."""
        if self._writer is None:
            return
        try:
            self._writer.wait_until_finished()
        except BaseException as e:
            from ..obs import flight as _flight

            _flight.record("ckpt_async_save_failed", error=str(e)[:300])
            logger.warning("pending async save failed (%s); restoring "
                           "from what is on disk", e)

    def restore(self, step: Optional[int] = None,
                template: Optional[Any] = None,
                fallback: Optional[bool] = None) -> Any:
        """Restore the full tree at ``step`` (default: newest intact).
        An explicitly-requested step never falls back; the latest-step
        path degrades through older steps at manifest granularity,
        leaving a flight-recorder event per damaged step.  ``template``
        is accepted for API parity and used only to cast leaf dtypes."""
        from ..obs import instrument as _obs

        self._drain_for_read()
        with trace_mod.span("hvd_tpu_ckpt_restore",
                            args={"step": -1 if step is None
                                  else int(step)}):
            if fallback is None:
                fallback = step is None
            if step is not None and not fallback:
                tree = self._store.read_tree(int(step),
                                             verify=self._verify)
                return self._apply_template(tree, template)
            candidates = sorted(self._store.steps(), reverse=True)
            if step is not None:
                candidates = [s for s in candidates if s <= int(step)]
            if not candidates:
                raise FileNotFoundError(
                    f"no checkpoint found under {self.directory}")
            if not fallback:
                # The caller explicitly disabled degradation (fail fast
                # and alert): a damaged newest step must raise, never
                # silently hand back stale state.
                tree = self._store.read_tree(candidates[0],
                                             verify=self._verify)
                return self._apply_template(tree, template)
            errors: List[str] = []
            for s in candidates:
                try:
                    tree = self._store.read_tree(s, verify=self._verify)
                except (ManifestError, CheckpointCorruptionError,
                        OSError) as e:
                    errors.append(f"step {s}: {type(e).__name__}: {e}")
                    self._record_damage(s, e)
                    continue
                if errors:
                    logger.warning(
                        "restored checkpoint step %d after newer "
                        "step(s) failed: %s", s, "; ".join(errors))
                _obs.on_ckpt_restore(
                    sum(int(leaf.nbytes) for leaf in
                        _np_leaves(tree)))
                return self._apply_template(tree, template)
            raise CheckpointCorruptionError(
                f"no intact checkpoint under {self.directory}: "
                f"{'; '.join(errors)}")

    @staticmethod
    def _apply_template(tree: Any, template: Optional[Any]) -> Any:
        """Cast restored leaves into the template's structure, dtypes and
        devices, matched BY KEY PATH (the restored tree is container
        normalized; positional pairing could swap fields).  A tensor leaf
        of the template restores as a tensor (a stored ``V2`` leaf as
        bf16), any other as a numpy array of its dtype."""
        if template is None:
            return tree
        flat, _ = tree_flatten_with_path(tree)
        by_path = {path_string(p): leaf for p, leaf in flat}
        t_flat, t_def = tree_flatten_with_path(template)
        if len(by_path) != len(t_flat):
            raise ValueError(
                f"template/checkpoint key mismatch: {len(t_flat)} "
                f"template leaves vs {len(by_path)} restored")
        cast = []
        for path, t_leaf in t_flat:
            key = path_string(path)
            if key not in by_path:
                raise ValueError(
                    f"template/checkpoint key mismatch: template leaf "
                    f"{key} not in the restored tree")
            if torch.is_tensor(t_leaf):
                cast.append(to_tensor(by_path[key], t_leaf.dtype,
                                      t_leaf.device))
            else:
                cast.append(np.asarray(by_path[key],
                                       dtype=np.asarray(t_leaf).dtype))
        return tree_unflatten(t_def, cast)

    def _record_damage(self, step: int, err: BaseException) -> None:
        from ..obs import flight as _flight

        _flight.record("ckpt_step_damaged", step=int(step),
                       error=f"{type(err).__name__}: {str(err)[:200]}")
        logger.warning("checkpoint step %d unusable (%s); trying older "
                       "step", step, err)

    def restore_shard(self, *, rank: int, world: Optional[int] = None,
                      scheme: Optional[str] = None,
                      step: Optional[int] = None
                      ) -> Tuple[RestorePlan, Dict[str, np.ndarray]]:
        """One (possibly resized) rank's restore: re-derive ownership
        at the new ``world`` and move only this rank's bytes.  Returns
        the plan (metadata: files touched, bytes moved) and the
        ``{key-path: array}`` payload.  Same latest-intact fallback as
        :meth:`restore`."""
        self._drain_for_read()
        with trace_mod.span("hvd_tpu_ckpt_restore",
                            args={"rank": int(rank),
                                  "world": int(world or 0)}):
            from ..obs import instrument as _obs

            candidates = ([int(step)] if step is not None
                          else sorted(self._store.steps(), reverse=True))
            if not candidates:
                raise FileNotFoundError(
                    f"no checkpoint found under {self.directory}")
            errors: List[str] = []
            for s in candidates:
                try:
                    manifest = self._store.validate_step(s)
                    plan = plan_restore(manifest, rank=int(rank),
                                        world=world, scheme=scheme)
                    payload = self._store.read_shard(
                        s, plan, verify=self._verify)
                except (ManifestError, CheckpointCorruptionError,
                        OSError) as e:
                    if step is not None:
                        raise
                    errors.append(f"step {s}: {e}")
                    self._record_damage(s, e)
                    continue
                _obs.on_ckpt_restore(plan.nbytes)
                return plan, payload
            raise CheckpointCorruptionError(
                f"no intact checkpoint under {self.directory}: "
                f"{'; '.join(errors)}")

    # --- recovery ------------------------------------------------------------

    def resume(self) -> ResumeInfo:
        """Recovery entry point: restore the newest intact snapshot,
        then hand back the journal tail past it — the caller replays
        those steps (same rng keys, same sampler cursors) to land on
        ``exact_step`` with zero lost steps instead of silently
        rewinding to the snapshot."""
        from ..obs import flight as _flight

        tree = None
        snap_step: Optional[int] = None
        self._drain_for_read()
        candidates = sorted(self._store.steps(), reverse=True)
        errors: List[str] = []
        for s in candidates:
            try:
                tree = self._store.read_tree(s, verify=self._verify)
                snap_step = s
                break
            except (ManifestError, CheckpointCorruptionError,
                    OSError) as e:
                errors.append(f"step {s}: {e}")
                self._record_damage(s, e)
        replay: List[Dict[str, Any]] = []
        intact = True
        if self._journal is not None:
            entries, intact = self._journal.read()
            replay = self._journal.entries_after(
                snap_step if snap_step is not None else -1,
                entries=entries)
        if snap_step is None and not replay:
            raise FileNotFoundError(
                f"no intact checkpoint under {self.directory}"
                + (f" ({'; '.join(errors)})" if errors else ""))
        if snap_step is None:
            # Every snapshot is gone/damaged but the journal survived:
            # recovery starts from scratch and replays the WHOLE run's
            # metadata — still lands on the exact step, still no
            # silent rewind.
            logger.warning(
                "no intact snapshot under %s; journal alone drives "
                "recovery (%d steps to replay)", self.directory,
                len(replay))
        exact = (int(replay[-1]["step"]) if replay
                 else int(snap_step))
        _flight.record("ckpt_resume",
                       snapshot_step=-1 if snap_step is None
                       else int(snap_step),
                       exact_step=exact, replay=len(replay),
                       journal_intact=intact,
                       fallbacks=len(errors))
        logger.info("resume: snapshot step %s + %d journaled step(s) "
                    "→ exact step %d%s", snap_step, len(replay), exact,
                    "" if intact else " (journal tail torn)")
        return ResumeInfo(tree=tree, snapshot_step=snap_step,
                          replay=replay, exact_step=exact,
                          journal_intact=intact)

    # --- lifecycle -----------------------------------------------------------

    def wait_until_finished(self,
                            timeout: Optional[float] = None) -> None:
        """Barrier: every submitted save is on disk when this returns;
        raises the first writer failure otherwise."""
        if self._writer is not None:
            self._writer.wait_until_finished(timeout=timeout)

    def discard_pending(self) -> int:
        """Elastic-rollback hook: queued (unstarted) saves hold
        pre-rollback state — drop them and clear any stored writer
        error so recovery starts clean.  Returns the count dropped."""
        if self._writer is None:
            return 0
        return self._writer.discard_pending()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close(drain=True)
        if self._journal is not None:
            self._journal.close()

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        # On a clean exit surface writer errors; while an exception is
        # already unwinding, don't replace it with a secondary failure.
        if exc and exc[0] is not None:
            try:
                self.close()
            except BaseException:
                logger.warning("checkpoint close failed during "
                               "exception unwind (original error wins)")
            return
        self.close()


def _np_leaves(tree: Any) -> List[np.ndarray]:
    return [np.asarray(leaf) for leaf in tree_leaves(tree)]
