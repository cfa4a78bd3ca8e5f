"""Monolithic whole-tree tier (the ``horovod_tpu_torch.checkpoint`` API).

Counterpart of ``horovod_tpu/ckpt/compat.py``, with ``torch.save`` in
place of orbax's ``CheckpointManager`` (the GPU host has neither orbax
nor safetensors): step ``N`` is ``<dir>/<N>/checkpoint.pt``, written to
a temporary file and renamed, and loaded with ``weights_only=True``.
Leaves are stored as tensors (a bf16 tensor as bf16; numpy arrays as
the tensors they convert to) in orbax's normalized containers
(namedtuples become dicts, tuples lists), so a restore hands back CPU
tensors in dicts and lists.

The rest is the reference's: the digest sidecar (``digests/<N>.json``,
the sha256 of :func:`~.snapshot.pytree_digest`, computed from ONE host
snapshot on a background thread; a ``pending`` marker before it
lands), verified restore, the fallback to the newest intact step, and
the ``checkpoint`` fault site's damage modes mapped onto this layout.
The one writer of sidecars and of injected damage is rank 0.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import shutil
import time
from typing import Any, List, Optional

import numpy as np
import torch

from . import snapshot as snapshot_mod
from .errors import CheckpointCorruptionError
from .manifest import build_skeleton, skeleton_fill
from .snapshot import pytree_digest
from .writer import AsyncWriter
from .. import faults as faults_mod
from ..obs import trace as trace_mod
from ..utils.retry import RetryPolicy, retry_call

logger = logging.getLogger(__name__)

__all__ = [
    "Checkpointer", "CheckpointCorruptionError", "pytree_digest",
    "save", "restore", "latest_step", "should_save_on_this_host",
]

_FILENAME = "checkpoint.pt"


def should_save_on_this_host() -> bool:
    """True on the process that writes host-local artifacts: rank 0 (the
    reference examples' ``if hvd.rank() == 0: save_checkpoint()``)."""
    from .. import basics

    return not basics.is_initialized() or basics.rank() == 0


def _key_token(entry) -> str:
    return snapshot_mod._key_token(entry)


def _digestable(tree: Any) -> bool:
    return snapshot_mod.is_snapshotable(tree)


def _storable(leaf: Any) -> Any:
    """A snapshot leaf as ``torch.save`` stores it under
    ``weights_only``: arrays as tensors (``V2`` as bf16), Python scalars
    and strings as they are."""
    if isinstance(leaf, np.ndarray):
        if leaf.dtype.kind in "US":
            return str(leaf)
        return snapshot_mod.to_tensor(leaf)
    return leaf


class _StepFiles:
    """Step-numbered ``torch.save`` files under one directory, with the
    retention rules of orbax's manager (``max_to_keep`` newest, plus
    every ``keep_period``-th step)."""

    def __init__(self, directory: str, *, max_to_keep: int,
                 keep_period: Optional[int]) -> None:
        self._dir = directory
        self._max_to_keep = max_to_keep
        self._keep_period = keep_period

    def path(self, step: int) -> str:
        return os.path.join(self._dir, str(int(step)), _FILENAME)

    def all_steps(self) -> List[int]:
        try:
            names = os.listdir(self._dir)
        except OSError:
            return []
        return sorted(int(n) for n in names if n.isdigit()
                      and os.path.isdir(os.path.join(self._dir, n)))

    def write(self, step: int, tree: Any) -> None:
        step_dir = os.path.dirname(self.path(step))
        tmp = step_dir + f".tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        with open(os.path.join(tmp, _FILENAME), "wb") as f:
            torch.save(tree, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.isdir(step_dir):
            shutil.rmtree(step_dir)
        os.replace(tmp, step_dir)
        self._prune()

    def _prune(self) -> None:
        steps = self.all_steps()
        for old in steps[:-self._max_to_keep]:
            if self._keep_period and old % self._keep_period == 0:
                continue
            shutil.rmtree(os.path.join(self._dir, str(old)),
                          ignore_errors=True)

    def read(self, step: int) -> Any:
        return torch.load(self.path(step), map_location="cpu",
                          weights_only=True)


class Checkpointer:
    """Step-numbered whole-tree checkpoints in ``directory``: async
    writes (training continues while the previous step flushes), bounded
    retention, optional ``keep_period``, and (``verify=True``) the
    digest-sidecar integrity tier."""

    def __init__(self, directory: str, *, max_to_keep: int = 3,
                 keep_period: Optional[int] = None,
                 async_save: bool = True,
                 verify: Optional[bool] = None,
                 restore_retries: int = 2):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._files = _StepFiles(self._dir, max_to_keep=max(1, max_to_keep),
                                 keep_period=keep_period)
        if verify is None:
            from .. import basics

            verify = (basics.config().checkpoint_digest
                      if basics.is_initialized() else True)
        self._verify = bool(verify)
        self._restore_policy = RetryPolicy(attempts=max(1, restore_retries),
                                           base_delay_s=0.5, max_delay_s=5.0)
        self._async = bool(async_save)
        self._pool = snapshot_mod.BufferPool(3)
        # The background jobs (an async save's write, every digest) run
        # on one queue that never drops a job (coalesce=False): a dropped
        # job would lose a step or skip its verification.
        self._writer = AsyncWriter(self._write_job, inflight=2,
                                   coalesce=False,
                                   on_drop=lambda job: job[1].release(),
                                   name="hvd-tpu-ckpt-digest")

    @property
    def directory(self) -> str:
        return self._dir

    # --- digest sidecars ----------------------------------------------------

    def _digest_dir(self) -> str:
        return os.path.join(self._dir, "digests")

    def _digest_path(self, step: int) -> str:
        return os.path.join(self._digest_dir(), f"{int(step)}.json")

    def _write_sidecar(self, step: int, doc: dict) -> None:
        if not should_save_on_this_host():
            return
        os.makedirs(self._digest_dir(), exist_ok=True)
        tmp = self._digest_path(step) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, self._digest_path(step))

    # Sentinel returned by _read_digest for a sidecar whose real hash
    # never landed (the digest job died with the process).
    _PENDING = "__pending__"

    def _read_digest(self, step: int) -> Optional[str]:
        try:
            with open(self._digest_path(step)) as f:
                doc = json.load(f)
            if doc.get("pending"):
                return self._PENDING
            return doc["digest"]
        except (OSError, ValueError, KeyError):
            return None

    def _prune_digests(self) -> None:
        """Drop sidecars of steps retention already deleted."""
        if not should_save_on_this_host():
            return
        keep = set(self.all_steps())
        try:
            names = os.listdir(self._digest_dir())
        except OSError:
            return
        for name in names:
            stem = name.partition(".")[0]
            if stem.isdigit() and int(stem) not in keep:
                try:
                    os.unlink(os.path.join(self._digest_dir(), name))
                except OSError:
                    pass

    def _write_step(self, step: int, snap) -> None:
        """Write a snapshot as orbax normalizes a tree (namedtuples to
        dicts, tuples to lists; the manifest's skeleton), so that
        ``weights_only`` loads it and the digest does not move."""
        ids = [f"l{i:05d}" for i in range(len(snap.leaves))]
        tree = skeleton_fill(
            build_skeleton([leaf.path for leaf in snap.leaves], ids),
            {i: _storable(leaf.array) for i, leaf in zip(ids, snap.leaves)})
        with trace_mod.span("hvd_tpu_ckpt_write", args={"step": int(step)}):
            self._files.write(step, tree)

    def _write_job(self, job) -> None:
        """The background job of one save: the step's write (an async
        save) and its digest sidecar, both from the snapshot's host
        buffers (the step loop pays for neither)."""
        step, snap, write, digest = job
        try:
            if write:
                self._write_step(step, snap)
            if digest:
                self._write_sidecar(step, {"step": int(step),
                                           "digest": snap.digest(),
                                           "nleaves": len(snap.leaves)})
            self._prune_digests()
        finally:
            snap.release()

    # --- save / restore -----------------------------------------------------

    def save(self, step: int, tree: Any, *, force: bool = False) -> bool:
        """Write ``tree`` as checkpoint ``step`` (async by default) plus
        its digest sidecar.  False when the step exists and ``force`` is
        off."""
        with trace_mod.span("hvd_tpu_ckpt_save", args={"step": int(step)}):
            return self._traced_save(step, tree, force=force)

    def _traced_save(self, step: int, tree: Any, *, force: bool) -> bool:
        from ..obs import instrument as _obs

        t0 = time.perf_counter()
        if not force and int(step) in self.all_steps():
            return False
        saved = should_save_on_this_host()
        snap = None
        if saved:
            with trace_mod.span("hvd_tpu_ckpt_offload",
                                args={"step": int(step)}):
                snap = snapshot_mod.take_snapshot(tree, step=int(step),
                                                  pool=self._pool)
            if not self._async:
                self._write_step(int(step), snap)
            if self._verify:
                # Before the job is queued: a crash in the gap leaves a
                # step restore sees as unverifiable, never as verified.
                self._write_sidecar(int(step), {"step": int(step),
                                                "pending": True})
            self._writer.submit((int(step), snap, self._async,
                                 self._verify))
        if faults_mod._active is not None:
            # Every rank ticks its plan (site counters stay in lockstep)
            # but only the writer applies the damage, to the stored
            # artifact, so the write must land first.
            mode = faults_mod.on_checkpoint_save(int(step))
            if mode is not None and saved:
                self.wait_until_finished()
                _damage_step_dir(self._dir, int(step), mode)
        _obs.on_ckpt_save((time.perf_counter() - t0) * 1e6,
                          snap.nbytes if snap is not None else 0,
                          self._writer.depth())
        return saved

    def _restore_step(self, step: int) -> Any:
        return retry_call(
            lambda: self._files.read(step),
            policy=self._restore_policy,
            retry_on=(OSError,),
            # A missing file (torn/partial write) is deterministic:
            # retrying it only delays the fallback scan.
            give_up_on=(FileNotFoundError,),
            describe=f"checkpoint restore step {step}",
        )

    def _verified_restore(self, step: int, template: Optional[Any]) -> Any:
        with trace_mod.span("hvd_tpu_ckpt_restore",
                            args={"step": int(step)}):
            got = self._restore_step(step)
            # Verification is byte exact, so it holds as-saved restores
            # only: a template legitimately transforms the content.
            if self._verify and template is None:
                want = self._read_digest(step)
                if want == self._PENDING:
                    raise CheckpointCorruptionError(
                        f"checkpoint step {step} has a pending digest "
                        f"sidecar (a crash cut the digest write) — it "
                        f"cannot be verified; restore an older "
                        f"verified step or pass verify=False")
                if want is not None and pytree_digest(got) != want:
                    raise CheckpointCorruptionError(
                        f"checkpoint step {step} failed digest "
                        f"verification under {self._dir}")
            if template is not None:
                from .checkpointer import AsyncCheckpointer

                flat, structure = snapshot_mod.tree_flatten_with_path(got)
                got = AsyncCheckpointer._apply_template(
                    snapshot_mod.tree_unflatten(
                        structure,
                        [snapshot_mod.to_numpy(leaf) for _, leaf in flat]),
                    template)
            return got

    def restore(self, step: Optional[int] = None,
                template: Optional[Any] = None,
                fallback: Optional[bool] = None) -> Any:
        """Restore checkpoint ``step`` (default: latest).  With
        ``fallback`` (default: on when ``step`` is None), a step that
        fails to load or to verify degrades to the newest older step
        that passes.  An explicitly requested step never falls back."""
        try:
            self.wait_until_finished()
        except BaseException as e:
            from ..obs import flight as _flight

            _flight.record("ckpt_async_save_failed", error=str(e)[:300])
            logger.warning("pending digest/save work failed (%s); "
                           "restoring from what is on disk", e)
        if fallback is None:
            fallback = step is None
        if step is not None:
            return self._verified_restore(step, template)
        candidates = sorted(self.all_steps(), reverse=True)
        if not candidates:
            raise FileNotFoundError(f"no checkpoint found under {self._dir}")
        if not fallback:
            return self._verified_restore(candidates[0], template)
        # Damage: digest mismatch, I/O errors and the decode errors
        # torch.load raises on torn files.  With a template a ValueError
        # is most likely a template mismatch, a caller bug that would
        # fail on every step, so it propagates as itself.
        damage = (CheckpointCorruptionError, OSError, UnicodeDecodeError,
                  KeyError, EOFError, RuntimeError, pickle.UnpicklingError)
        if template is None:
            damage = damage + (ValueError,)
        errors: List[str] = []
        for s in candidates:
            try:
                got = self._verified_restore(s, template)
                if errors:
                    logger.warning(
                        "restored checkpoint step %d after newer step(s) "
                        "failed: %s", s, "; ".join(errors))
                return got
            except damage as e:
                errors.append(f"step {s}: {type(e).__name__}: {e}")
                from ..obs import flight as _flight

                _flight.record("ckpt_step_damaged", step=int(s),
                               error=f"{type(e).__name__}: {str(e)[:200]}")
                logger.warning("checkpoint step %d unusable (%s); trying "
                               "older step", s, e)
        raise CheckpointCorruptionError(
            f"no intact checkpoint under {self._dir}: {'; '.join(errors)}")

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        return self._files.all_steps()

    def wait_until_finished(self) -> None:
        """Block until pending saves and digest sidecars are on disk."""
        self._writer.wait_until_finished()

    def close(self) -> None:
        self._writer.close(drain=True)

    def __enter__(self) -> "Checkpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.wait_until_finished()
        self.close()


def _damage_step_dir(directory: str, step: int, mode: str) -> None:
    """Apply the fault plan's checkpoint damage to this layout:
    ``corrupt`` bit-flips the largest file of the step; ``partial``
    deletes it; ``partial-manifest`` deletes the smallest;
    ``crash-before-rename`` removes the step directory (the commit that
    never happened).  ``stall`` never reaches here (the hook sleeps)."""
    step_dir = os.path.join(directory, str(step))
    if mode == "crash-before-rename":
        shutil.rmtree(step_dir, ignore_errors=True)
        logger.warning("fault: removed %s (commit never happened)",
                       step_dir)
        return
    victims: List[str] = []
    for root, _, files in os.walk(step_dir):
        for name in files:
            path = os.path.join(root, name)
            try:
                if os.path.getsize(path) > 0:
                    victims.append(path)
            except OSError:
                pass
    if not victims:
        logger.warning("fault: no files to damage under %s", step_dir)
        return
    if mode == "partial-manifest":
        victim = min(victims, key=os.path.getsize)
        try:
            os.unlink(victim)
        except FileNotFoundError:
            pass
        logger.warning("fault: deleted %s (metadata dangling)", victim)
        return
    victim = max(victims, key=os.path.getsize)
    if mode == "partial":
        try:
            os.unlink(victim)
        except FileNotFoundError:
            pass
        logger.warning("fault: deleted %s (partial write)", victim)
        return
    from .store import bitflip_middle

    flipped = bitflip_middle(victim)
    logger.warning("fault: corrupted %d bytes of %s", flipped, victim)


def save(directory: str, step: int, tree: Any) -> None:
    """One-shot synchronous save."""
    with Checkpointer(directory, async_save=False) as ckpt:
        ckpt.save(step, tree)


def restore(directory: str, step: Optional[int] = None,
            template: Optional[Any] = None) -> Any:
    """One-shot restore."""
    with Checkpointer(directory, async_save=False) as ckpt:
        return ckpt.restore(step, template)


def latest_step(directory: str) -> Optional[int]:
    with Checkpointer(directory, async_save=False) as ckpt:
        return ckpt.latest_step()
