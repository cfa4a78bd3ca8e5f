"""Bounded background writer: the thread that owns the filesystem.

The step loop's entire durability cost is the snapshot; everything
slower lands here.  Contracts (each pinned by tests):

* **Bounded in-flight queue** (``HVD_TPU_CKPT_INFLIGHT``): at most N
  snapshots wait for the disk.  Holding unbounded snapshots would turn
  a slow filesystem into a host-OOM.
* **Coalescing, drop-oldest-unwritten**: when the queue is full, the
  OLDEST queued (not-yet-started) item is dropped to admit the new one
  — back-to-back saves against a stalled disk keep the newest state
  durable-bound instead of queueing history.  Dropped items are
  released via ``on_drop`` (buffer-pool return) and counted.
* **Exceptions surface on the caller**: a writer-thread failure is
  stored and re-raised from the next ``submit`` / ``wait_until_finished``
  / ``close`` — an async save must never fail silently.
* ``wait_until_finished`` / ``close`` are the barriers: when they
  return (without raising), everything submitted is on disk.

Counterpart of ``horovod_tpu/ckpt/writer.py``, with the same
``hvd_tpu_ckpt_*`` counters and flight events.
"""

from __future__ import annotations

import logging
import threading
from collections import deque
from typing import Any, Callable, List, Optional

logger = logging.getLogger(__name__)

__all__ = ["AsyncWriter"]


class AsyncWriter:
    def __init__(self, write_fn: Callable[[Any], None], *,
                 inflight: int = 2,
                 on_drop: Optional[Callable[[Any], None]] = None,
                 coalesce: bool = True,
                 name: str = "hvd-tpu-ckpt-writer") -> None:
        self._write_fn = write_fn
        self._inflight = max(1, int(inflight))
        self._on_drop = on_drop
        # coalesce=False: a full queue BLOCKS submit (backpressure)
        # instead of dropping the oldest item — for queues where every
        # item matters (the compat tier's digest sidecars: a dropped
        # job would silently skip verification for that step).
        self._coalesce = bool(coalesce)
        self._name = name
        self._cv = threading.Condition()
        self._pending: "deque" = deque()      # guarded-by: _cv
        self._busy = False                    # guarded-by: _cv
        self._error: Optional[BaseException] = None  # guarded-by: _cv
        self._closed = False                  # guarded-by: _cv
        self._dropped = 0                     # guarded-by: _cv
        self._thread: Optional[threading.Thread] = None  # guarded-by: _cv

    # --- caller side ---------------------------------------------------------

    def submit(self, item: Any) -> None:
        """Enqueue one write.  Raises a stored writer-thread exception
        first (the failure of an EARLIER save surfaces here), then a
        ``RuntimeError`` if closed."""
        dropped: List[Any] = []
        with self._cv:
            self._raise_pending_locked()
            if self._closed:
                raise RuntimeError(f"{self._name}: submit after close()")
            if self._coalesce:
                while len(self._pending) >= self._inflight:
                    dropped.append(self._pending.popleft())
                    self._dropped += 1
            else:
                # Backpressure must never drop data, but a silent
                # forever-block against a wedged disk is a hang: wait in
                # bounded slices and leave a flight-recorder trail each
                # time one expires, so a stuck submit ships evidence.
                while not self._cv.wait_for(
                        lambda: len(self._pending) < self._inflight
                        or self._error is not None or self._closed,
                        timeout=60.0):
                    logger.warning(
                        "%s: submit backpressured >60s (writer stuck "
                        "against a slow filesystem?)", self._name)
                    from ..obs import flight as _flight

                    _flight.record("ckpt_backpressure", writer=self._name,
                                   depth=len(self._pending))
                self._raise_pending_locked()
                if self._closed:
                    # close() won the race while we were blocked: the
                    # writer may already have exited — accepting the
                    # item would silently lose it.
                    raise RuntimeError(
                        f"{self._name}: closed while submit was "
                        f"backpressured")
            self._pending.append(item)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name=self._name, daemon=True)
                self._thread.start()
            self._cv.notify_all()
        for old in dropped:
            logger.warning("%s: coalesced a queued save (disk slower "
                           "than the save cadence); newest state wins",
                           self._name)
            from ..obs import instrument as _obs

            _obs.on_ckpt_coalesced()
            if self._on_drop is not None:
                self._on_drop(old)

    def depth(self) -> int:
        """Queued + in-progress writes right now (the in-flight gauge)."""
        with self._cv:
            return len(self._pending) + (1 if self._busy else 0)

    def dropped(self) -> int:
        with self._cv:
            return self._dropped

    def wait_until_finished(self, timeout: Optional[float] = None) -> None:
        """Block until the queue is drained and the writer is idle,
        then surface any stored exception.  With a ``timeout``, an
        expiry with writes still in flight raises ``TimeoutError`` —
        this is a durability barrier and must never silently return
        with data not yet on disk."""
        with self._cv:
            drained = self._cv.wait_for(
                lambda: (not self._pending and not self._busy)
                or self._error is not None,
                timeout=timeout)
            # Let a failure that happened while OTHER items were still
            # queued drain them first only if no error: an error stops
            # the wait immediately (the caller must learn now).
            self._raise_pending_locked()
            if not drained:
                raise TimeoutError(
                    f"{self._name}: writes still in flight after "
                    f"{timeout}s — data is NOT yet durable")

    def discard_pending(self) -> int:
        """Drop every queued-but-unstarted write and clear any stored
        error (the elastic rollback path: queued snapshots are
        pre-rollback state, and a poisoned error must not resurface
        mid-recovery).  Returns the number discarded."""
        with self._cv:
            dropped = list(self._pending)
            self._pending.clear()
            self._error = None
            self._cv.notify_all()
        if self._on_drop is not None:
            for old in dropped:
                self._on_drop(old)
        return len(dropped)

    def close(self, *, drain: bool = True) -> None:
        """Stop the writer.  ``drain=True`` (default) finishes queued
        writes first; surfaces any stored exception either way.  If the
        thread cannot drain within the timeout (a filesystem stalled
        for minutes), raises rather than returning with writes still in
        flight — close() is a durability barrier and must never lie."""
        dropped: List[Any] = []
        with self._cv:
            if not drain:
                dropped = list(self._pending)
                self._pending.clear()
            self._closed = True
            self._cv.notify_all()
            thread = self._thread
        if self._on_drop is not None:
            for old in dropped:
                self._on_drop(old)
        if thread is not None:
            thread.join(timeout=60.0)
            if thread.is_alive():
                raise RuntimeError(
                    f"{self._name}: writer failed to drain within 60s "
                    f"(a write is still in flight — data may not be "
                    f"durable)")
        with self._cv:
            self._raise_pending_locked()

    # --- writer thread -------------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    # Bounded idle tick (not a deadline): a missed
                    # notify can only cost one slice, never a wedge.
                    self._cv.wait(timeout=1.0)
                if not self._pending and self._closed:
                    return
                item = self._pending.popleft()
                self._busy = True
                self._cv.notify_all()   # unblock a backpressured submit
            try:
                self._write_fn(item)
            except BaseException as e:   # surfaced on the caller
                with self._cv:
                    if self._error is None:
                        self._error = e
                    else:
                        logger.warning("%s: additional write failure "
                                       "suppressed behind the first: %s",
                                       self._name, e)
            finally:
                with self._cv:
                    self._busy = False
                    self._cv.notify_all()

    def _raise_pending_locked(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None  # hvdlint: disable=unguarded-mutation -- _locked suffix contract: every caller holds _cv
            raise err
