"""Zero-downtime weight hot-swap: checkpoint store → serving replica.

Counterpart of ``horovod_tpu/serve/swap.py``.  The port's leaves are the
engine's named parameters (``InferenceEngine.params``, ``{name:
tensor}``), digested under the key paths the port's ``AsyncCheckpointer``
records for the same tree: a trainer that saves
``dict(model.named_parameters())`` writes steps whose unchanged leaves
diff as unchanged against a replica serving that model.  A subscriber
seeded with another tree (``params=``) diffs against that tree's paths.

The train→serve loop's last hop (docs/hot_swap.md): a trainer commits
steps into a :class:`~..ckpt.store.ShardStore`; each serving
replica runs a :class:`WeightSubscriber` that

1. **subscribes** — polls the store for a newer *intact* step
   (``ShardStore.newest_intact_step``: manifest-granularity validation,
   so a torn upload never becomes a serving version);
2. **diffs** — compares the new manifest's per-leaf digests against the
   running version (``ckpt.manifest.diff_manifest``) and pulls ONLY the
   changed shards, lazily per ``.npz`` member, verifying every pulled
   leaf against its manifest digest;
3. **stages** — builds the full new param tree (pulled leaves + cached
   unchanged ones) alongside the live params and hands it to the
   engine (``InferenceEngine.stage_params``);
4. **flips** — asks the batcher for its swap barrier
   (``ContinuousBatcher.flip_at_barrier``): admission holds, in-flight
   generations finish on the version they started on, and the engine's
   param reference swaps atomically between decode bursts — then the
   prefix cache is flushed (resident KV was computed under the old
   weights; stale KV against new weights is the silent-wrongness bug
   the mixed-version routing rule exists for).

**Every failure degrades to "keep serving the old weights", never to
dropped or wrong tokens**: a digest mismatch discards the staged pull
and retries under :class:`~..utils.retry.RetryPolicy`
(``HVD_TPU_SWAP_RETRIES``); a pull stalled past
``HVD_TPU_SWAP_DEADLINE_S`` is abandoned and flight-recorded; a replica
killed at the flip barrier fails over through the router exactly like
any other replica death (the flip is one atomic reference swap, so a
replica is always on exactly one version).

**Rollback** rides the same path: ``swap_to(step, rollback=True)``
re-points the replica at any journaled step still intact in the store —
the ``RollbackRequest`` wire frame (serve/server.py) and the fleet
controller's ``roll_swap(..., rollback=True)`` drive it fleet-wide.

Fault site ``swap`` (``HVD_TPU_FAULT_SPEC``): ``corrupt-shard`` and
``stall`` fire here at the pull; ``kill-mid-flip`` fires at the
batcher's barrier; ``partial-fleet`` at the controller's roll.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

import numpy as np

from .. import faults as faults_mod
from ..ckpt.errors import CheckpointCorruptionError
from ..ckpt.manifest import Manifest, ManifestError, diff_manifest
from ..ckpt.snapshot import (leaf_record_digest, path_string, to_numpy,
                             tree_flatten_with_path)
from ..ckpt.store import ShardStore
from ..obs import flight as flight_mod
from ..obs import instrument as _obs
from ..obs import trace as trace_mod
from ..utils.logging import get_logger
from ..utils.retry import RetryPolicy, retry_call
from .batcher import ReplicaKilledError
from .engine import resolved_config

logger = get_logger(__name__)

__all__ = ["WeightSubscriber", "SwapRejectedError", "SwapAbandonedError",
           "SwapFailedError", "leaf_digests"]


class SwapRejectedError(RuntimeError):
    """The pulled step failed verification (damaged manifest, digest
    mismatch, unreadable shard) — the staged pull was discarded and the
    replica keeps serving the old weights."""


class SwapAbandonedError(RuntimeError):
    """The pull/stage/flip ran past ``HVD_TPU_SWAP_DEADLINE_S`` — the
    swap was withdrawn and the replica keeps serving the old weights."""


class SwapFailedError(RuntimeError):
    """The flip itself could not run (replica died at the barrier /
    engine error) — never a half-applied state: the param reference
    either swapped atomically or it did not."""


def leaf_digests(tree: Any) -> Dict[str, tuple]:
    """``{key-path: (digest-hex, host-array)}`` for a param tree (the
    engine's ``{name: tensor}`` or any nested mapping) — the
    subscriber's running-version leaf cache, in exactly the digest
    format the shard manifests record (a bf16 leaf as its ``V2``
    bytes), so boot weights saved by the trainer diff as unchanged."""
    flat, _ = tree_flatten_with_path(tree)
    out: Dict[str, tuple] = {}
    for path, leaf in flat:
        arr = to_numpy(leaf)
        pstr = path_string(path)
        out[pstr] = (leaf_record_digest(pstr, arr).hex(), arr)
    return out


class WeightSubscriber:
    """Per-replica live-deployment agent over one checkpoint store.

    ``batcher`` is the replica's :class:`ContinuousBatcher` (the flip
    rides its barrier); ``directory`` the ``ShardStore`` root the
    trainer commits into.  The running version seeds from the engine's
    live params (version ``engine.weights_version``) unless ``params``/
    ``version`` say otherwise — seeding from the same tree the trainer
    saved makes the first swap pull only what actually changed.

    Drive it with :meth:`poll_once` (deterministic — tests, drills) or
    :meth:`start`/:meth:`stop` (background polling thread — what the
    serving endpoint does).  After a rollback the forward watch is
    PINNED (newer store steps are the weights just rolled back from);
    the next explicit forward :meth:`swap_to` unpins it.
    """

    def __init__(self, batcher, directory: str, *,
                 params: Any = None,
                 version: Optional[int] = None,
                 poll_s: Optional[float] = None,
                 deadline_s: Optional[float] = None,
                 retries: Optional[int] = None) -> None:
        cfg = resolved_config()
        self._batcher = batcher
        self._engine = batcher.engine
        self._store = ShardStore(directory)
        self.poll_s = float(poll_s if poll_s is not None
                            else cfg.swap_poll_s)
        self.deadline_s = float(deadline_s if deadline_s is not None
                                else cfg.swap_deadline_s)
        self._policy = RetryPolicy(
            attempts=int(retries if retries is not None
                         else cfg.swap_retries),
            base_delay_s=0.1, max_delay_s=2.0)
        self._lock = threading.Lock()
        # One swap at a time per replica: the background poller and a
        # controller SwapRequest otherwise race the engine's single
        # staging slot (the loser's discard would wipe the winner's
        # staged tree mid-flip).
        self._swap_lock = threading.Lock()
        seed_tree = params if params is not None else self._engine.params
        self._have = leaf_digests(seed_tree)      # guarded-by: _lock
        self._version = int(version if version is not None
                            else self._engine.weights_version)  # guarded-by: _lock
        # Set by a rollback: the forward watch is PINNED — newer steps
        # already in the store are exactly the weights just rolled back
        # from, and the poller re-deploying them within one poll period
        # would silently undo the operator's rollback.  Only an
        # explicit forward swap (SwapRequest / swap_to call) clears it.
        self._hold_at: Optional[int] = None       # guarded-by: _lock
        # Last completed swap's pull accounting (tests + bench read
        # it); replaced wholesale by one atomic assignment, never
        # mutated in place, so readers need no lock.
        self.last_swap: Dict[str, Any] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    @property
    def store(self) -> ShardStore:
        return self._store

    # --- subscription --------------------------------------------------------

    def poll_once(self) -> Optional[int]:
        """One watch tick: swap to the newest intact step newer than
        the running version, if any.  Returns the new version, or None
        when the store holds nothing newer.  Failures are absorbed
        (logged + flight-recorded + counted) — the poll loop must
        outlive every bad upload."""
        with self._lock:
            current = self._version
            held = self._hold_at is not None
        if held:
            # Rolled back: the newer steps in the store are the weights
            # the operator just backed away from — auto-deploy stays
            # paused until an explicit forward swap unpins the watch.
            return None
        step = self._store.newest_intact_step(min_step=current)
        if step is None:
            return None
        try:
            return self.swap_to(step, _from_poll=True)
        except (SwapRejectedError, SwapAbandonedError,
                SwapFailedError) as e:
            logger.warning("hot-swap to step %d not applied (%s); "
                           "still serving version %d", step, e, current)
            return None

    def start(self) -> None:
        """Background subscription: poll every ``poll_s`` seconds until
        :meth:`stop`."""
        if self._thread is not None:
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(timeout=self.poll_s):
                try:
                    self.poll_once()
                except ReplicaKilledError:
                    return          # replica dead: nothing left to swap
                except Exception:   # defensive: the watch must survive
                    logger.exception("weight-subscriber poll failed")

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="weight-subscriber")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # --- the swap ------------------------------------------------------------

    def swap_to(self, step: int, *, rollback: bool = False,
                _from_poll: bool = False) -> int:
        """Pull, stage and flip to ``step``.  Forward swaps require a
        newer step; ``rollback=True`` re-points at any intact step (the
        journaled-step rollback path) and PINS the forward watch so the
        poller cannot re-deploy the rolled-back-from steps.  Returns
        the new version.  Serialized per subscriber — a poller tick and
        a controller ``SwapRequest`` cannot race the engine's single
        staging slot.

        Raises :class:`SwapRejectedError` after ``HVD_TPU_SWAP_RETRIES``
        failed verification attempts, :class:`SwapAbandonedError` past
        the deadline, :class:`SwapFailedError`/``ReplicaKilledError``
        when the flip could not run — in every case the old weights are
        still serving and nothing staged survives."""
        with self._swap_lock:
            return self._swap_to_locked(int(step), rollback=rollback,
                                        from_poll=_from_poll)

    def swap_to_info(self, step: int, *,
                     rollback: bool = False) -> Dict[str, Any]:
        """:meth:`swap_to` plus THIS swap's own pull accounting, read
        atomically under the swap lock — a concurrent poller swap
        cannot replace ``last_swap`` between the flip and the read (the
        ``SwapResponse`` wire path uses this)."""
        with self._swap_lock:
            version = self._swap_to_locked(int(step), rollback=rollback,
                                           from_poll=False)
            return dict(self.last_swap, version=version)

    def _swap_to_locked(self, step: int, *, rollback: bool,
                        from_poll: bool) -> int:
        with self._lock:
            current = self._version
            if from_poll and self._hold_at is not None:
                # The pin landed while this poller tick waited on the
                # swap lock (an operator rollback just finished) — the
                # tick must NOT redeploy the rolled-back-from step.
                return current
        if step == current:
            # No-op (the replica is already there — a re-rolled step,
            # or the poller won the race): report it as one, not as the
            # PREVIOUS swap's pull.
            self.last_swap = {"step": step, "pulled_leaves": 0,
                              "total_leaves": 0, "pulled_bytes": 0,
                              "total_bytes": 0, "ms": 0.0,
                              "rollback": rollback, "noop": True}
            with self._lock:
                if rollback:
                    self._hold_at = step       # "hold here" still pins
                elif not from_poll:
                    self._hold_at = None
            return current
        if step < current and not rollback:
            raise SwapRejectedError(
                f"step {step} is older than the running version "
                f"{current}; use rollback for a deliberate re-point")
        t0 = time.monotonic()
        pulled_total = [0]
        try:
            with trace_mod.span("hvd_tpu_swap",
                                args={"step": step, "from": current,
                                      "rollback": rollback}):
                result = retry_call(
                    lambda: self._attempt(step, t0, pulled_total),
                    policy=self._policy,
                    retry_on=(SwapRejectedError,),
                    describe=f"weight swap to step {step}")
        except SwapRejectedError as e:
            self._engine.discard_staged()
            _obs.on_swap("rejected", nbytes=pulled_total[0])
            flight_mod.record("swap_rejected", step=step,
                              error=str(e)[:200])
            raise
        except SwapAbandonedError as e:
            self._engine.discard_staged()
            _obs.on_swap("abandoned", nbytes=pulled_total[0])
            flight_mod.record("swap_abandoned", step=step,
                              error=str(e)[:200])
            raise
        except (SwapFailedError, ReplicaKilledError) as e:
            self._engine.discard_staged()
            _obs.on_swap("failed", nbytes=pulled_total[0])
            flight_mod.record("swap_failed", step=step,
                              error=str(e)[:200])
            raise
        ms = (time.monotonic() - t0) * 1e3
        with self._lock:
            if rollback:
                # Pin the forward watch: the steps above this one are
                # the weights just rolled back from — the poller must
                # not silently un-do the operator (only the next
                # explicit forward swap unpins).
                self._hold_at = step
            elif not from_poll:
                self._hold_at = None
        _obs.on_swap("ok", ms=ms, nbytes=pulled_total[0])
        flight_mod.record("weights_swapped", step=step,
                          from_version=current, rollback=rollback,
                          pulled_bytes=result["pulled_bytes"],
                          ms=round(ms, 3))
        self.last_swap = dict(result, ms=round(ms, 3), rollback=rollback)
        logger.info("weights hot-swapped: version %d -> %d (%d/%d "
                    "leaves pulled, %d bytes, %.1f ms%s)", current,
                    step, result["pulled_leaves"],
                    result["total_leaves"], result["pulled_bytes"], ms,
                    " [rollback]" if rollback else "")
        return step

    def _remaining(self, t0: float) -> float:
        """Budget left before the swap is abandoned (docs/hot_swap.md
        failure matrix: a stalled pull must not pin staged buffers and
        a pending barrier forever).  ``deadline_s=0`` means no
        deadline; the barrier wait still carries a 7-day liveness
        backstop (every wait in this codebase is bounded)."""
        if self.deadline_s <= 0:
            return 7 * 86400.0
        left = self.deadline_s - (time.monotonic() - t0)
        if left <= 0:
            raise SwapAbandonedError(
                f"swap past the {self.deadline_s}s deadline "
                f"(HVD_TPU_SWAP_DEADLINE_S)")
        return left

    def _attempt(self, step: int, t0: float, pulled_total) -> Dict:
        """One pull+stage+flip attempt.  ``SwapRejectedError`` is the
        retryable verdict; everything else is terminal for this swap."""
        self._remaining(t0)
        try:
            manifest = self._store.validate_step(step)
        except ManifestError as e:
            raise SwapRejectedError(f"step {step} not intact: {e}") from e
        with self._lock:
            have = {path: digest for path, (digest, _)
                    in self._have.items()}
        by_file, changed, nbytes = diff_manifest(manifest, have)
        mode = (faults_mod.on_swap_pull()
                if faults_mod._active is not None else None)
        leaves: Dict[str, np.ndarray] = {}
        if by_file:
            try:
                # verify=False: verification happens HERE so the
                # corrupt-shard fault (and any real rot between
                # validate and read) is caught by the same check.
                leaves = self._store.read_leaves(step, by_file, manifest,
                                                 verify=False)
            except (CheckpointCorruptionError, ManifestError,
                    OSError) as e:
                raise SwapRejectedError(
                    f"step {step} unreadable: {e}") from e
            pulled_total[0] += sum(int(a.nbytes) for a in leaves.values())
        if mode == "corrupt-shard" and leaves:
            # Damage AFTER the read, BEFORE verification: the manifest
            # declares the true digests, so the check below MUST reject
            # this pull (the wrong-weights-never drill).
            victim = sorted(leaves)[0]
            bad = np.array(leaves[victim], copy=True)
            flat = bad.reshape(-1).view(np.uint8)
            flat[: min(16, flat.size)] ^= 0xFF
            leaves[victim] = bad
        for leaf_id, arr in leaves.items():
            entry = manifest.entries[leaf_id]
            if leaf_record_digest(entry["path"],
                                  arr).hex() != entry["digest"]:
                raise SwapRejectedError(
                    f"step {step}: leaf {entry['path']} failed digest "
                    f"verification; staged pull discarded")
        tp = int(getattr(self._engine, "tp", 1) or 1)
        shard_bytes = (self._shard_pull(leaves, manifest, tp)
                       if tp > 1 and leaves else None)
        self._remaining(t0)
        tree = self._merge(manifest, leaves)
        self._engine.stage_params(tree, step)
        try:
            version = self._batcher.flip_at_barrier(
                self._engine.commit_staged,
                timeout=self._remaining(t0))
        except TimeoutError as e:
            self._engine.discard_staged()
            raise SwapAbandonedError(str(e)) from e
        except RuntimeError as e:
            if isinstance(e, ReplicaKilledError):
                raise
            self._engine.discard_staged()
            raise SwapFailedError(str(e)) from e
        if version is None:   # defensive: a barrier that lost its result
            raise SwapFailedError("flip reported no version")
        # Commit the leaf cache only once the flip really happened.
        with self._lock:
            new_have: Dict[str, tuple] = {}
            for leaf_id, entry in manifest.entries.items():
                path = entry["path"]
                arr = (leaves[leaf_id] if leaf_id in leaves
                       else self._have[path][1])
                new_have[path] = (entry["digest"], arr)
            self._have = new_have
            self._version = int(version)
        out = {
            "step": step,
            "pulled_leaves": len(changed),
            "total_leaves": len(manifest.entries),
            "pulled_bytes": nbytes,
            "total_bytes": manifest.nbytes,
        }
        if shard_bytes is not None:
            # Per-shard accounting (docs/tp_serving.md): shards pull in
            # parallel, so the replica's store-traffic critical path is
            # the WIDEST shard, not the sum — that max is what
            # ``pulled_bytes`` means on a TP replica.  The tp=1
            # equivalent (the whole manifest diff) stays available as
            # ``pulled_bytes_full`` for the bench's ratio.
            out["tp"] = tp
            out["pulled_bytes_per_shard"] = shard_bytes
            out["pulled_bytes_full"] = nbytes
            out["pulled_bytes"] = max(shard_bytes)
        return out

    def _shard_pull(self, leaves: Dict[str, np.ndarray],
                    manifest: Manifest, tp: int):
        """The bytes each of ``tp`` shards pulls of ``leaves``: of a
        leaf the planner's ownership rule divides
        (``plan.tp_owned_slice``), the shard's contiguous slice; of a
        leaf too small to divide, the whole leaf (every shard pulls it).
        A replica whose shards read the store separately moves ~1/tp of
        the diff a shard.  One process reads the store once here, so
        the counts follow from the slices' spans and ``leaves`` stays as
        it is (the reference carves each leaf and joins the parts back,
        an equal array)."""
        from ..plan import tp_owned_slice

        per_shard = [0] * tp
        for leaf_id, arr in leaves.items():
            path = manifest.entries[leaf_id]["path"]
            for r in range(tp):
                owned = tp_owned_slice(path, arr.shape, tp, r)
                if owned is None:
                    per_shard[r] += int(arr.nbytes)
                    continue
                dim, start, stop = owned
                per_shard[r] += (int(arr.nbytes) // arr.shape[dim]
                                 * (stop - start))
        return per_shard

    def _merge(self, manifest: Manifest,
               leaves: Dict[str, np.ndarray]) -> Any:
        """Full new tree: pulled leaves + the running version's cached
        unchanged arrays, rebuilt into the manifest's skeleton."""
        from ..ckpt.manifest import skeleton_fill

        lookup: Dict[str, np.ndarray] = dict(leaves)
        with self._lock:
            for leaf_id, entry in manifest.entries.items():
                if leaf_id in lookup:
                    continue
                cached = self._have.get(entry["path"])
                if cached is None:
                    # diff said unchanged but we hold no copy — cannot
                    # happen through diff_manifest (absent paths always
                    # count as changed); defend anyway.
                    raise SwapRejectedError(
                        f"leaf {entry['path']} neither pulled nor "
                        f"cached")
                lookup[leaf_id] = cached[1]
        try:
            return skeleton_fill(manifest.skeleton, lookup)
        except (KeyError, TypeError) as e:
            raise SwapRejectedError(
                f"step {manifest.step}: skeleton/entries mismatch: "
                f"{e}") from e
