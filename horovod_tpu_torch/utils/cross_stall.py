"""Cross-process stall and failure monitor over the native Coordinator.

Horovod's stall inspector runs inside the rank-0 C++ controller, which
sees every rank's Requests and so can name a stall ("tensor X missing
from ranks {...}").  Counterpart of ``horovod_tpu/utils/cross_stall.py``,
the same monitor for the port's process groups:

* every collective dispatch reports its name here
  (``ops.collectives._dispatch``);
* a daemon thread batches the names into wire ``Request``s through the
  native tensor queue and drives the native TCP
  :class:`~..native.runtime.Coordinator` (rank 0 hosts the C++
  ``Controller``, which computes global readiness as the reference's
  ``ComputeResponseList`` does);
* a name this process dispatched that is not ready on every rank within
  the stall window gives the reference's missing-rank warning;
* a dead peer breaks the negotiate cycle and is logged as a coordinator
  failure;
* each negotiate cycle is marked on the timeline under
  ``HOROVOD_TIMELINE_MARK_CYCLES`` (the reference marks none).

A sidecar: the data plane (torch.distributed) never waits on it.
:func:`basics.init` starts it on every rank of a world of two or more.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Set

from .logging import get_logger

logger = get_logger(__name__)


class CrossProcessMonitor:
    """Drives one negotiate cycle per ``interval_s``; see module doc."""

    def __init__(self, coordinator, warn_after_s: float = 60.0,
                 interval_s: float = 2.0) -> None:
        from ..native.runtime import NativeTensorQueue

        self._coord = coordinator
        self._warn_after = float(warn_after_s)
        self._interval = float(interval_s)
        self._pending: Dict[str, float] = {}   # name -> first-submit time
        self._reported: Set[str] = set()
        # The reference's TensorQueue in its reference role: framework
        # threads push dispatch reports, the background cycle drains.
        # _inflight is the producer-side dedup (pushed or pending): a
        # name is pushed at most once per unresolved flight, so the hot
        # dispatch path costs one lock + set probe for repeats and the
        # queue stays bounded by the distinct-name count.
        self._queue = NativeTensorQueue()
        self._inflight: Set[str] = set()   # guarded-by: _inflight_lock
        self._inflight_lock = threading.Lock()
        self._stop = threading.Event()
        self.failure: Optional[str] = None
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="hvd-torch-cross-stall")
        self._thread.start()

    # called from every collective dispatch (ops.collectives._dispatch)
    def record_dispatch(self, name: str) -> None:
        from ..native.runtime import Request

        try:
            with self._inflight_lock:
                if self._stop.is_set() or name in self._inflight:
                    return
                self._inflight.add(name)
                # Under the lock: stop() holds it while tearing the
                # queue down, so the handle cannot be freed mid-push.
                self._queue.push(Request(rank=self._coord.rank, name=name))
        except Exception:
            pass  # a monitoring sidecar must never break a dispatch

    @staticmethod
    def _mark_cycle() -> None:
        """One ``CYCLE`` mark on the live timeline a negotiate cycle, when
        ``HOROVOD_TIMELINE_MARK_CYCLES`` is on: this loop is the port's
        background coordination cycle, the one Horovod's marks time."""
        from .. import basics

        tl = basics.peek("timeline")
        if tl is not None:
            tl.mark_cycle()

    def _resolve(self, name: str) -> None:
        self._pending.pop(name, None)
        self._reported.discard(name)
        with self._inflight_lock:
            self._inflight.discard(name)

    def _loop(self) -> None:
        while not self._stop.is_set():
            drained = {r.name: r for r in self._queue.drain()}
            batch = sorted(n for n in drained if n not in self._pending)
            now = time.monotonic()
            reqs = [drained[n] for n in batch]
            try:
                resps = self._coord.negotiate(reqs)
            except Exception as e:
                if not self._stop.is_set():
                    self.failure = str(e)
                    logger.warning(
                        "cross-process monitor lost the coordinator (%s): "
                        "a peer process likely failed or shut down", e)
                return
            self._mark_cycle()
            for n in batch:
                self._pending.setdefault(n, now)
            for resp in resps:
                for n in resp.names:
                    self._resolve(n)
            for n, t0 in list(self._pending.items()):
                if now - t0 > self._warn_after and n not in self._reported:
                    self._reported.add(n)
                    logger.warning(
                        "collective %r was dispatched by this process but "
                        "is not globally ready after %.0fs — one or more "
                        "peer ranks have not dispatched it (reference: "
                        "stall inspector missing-ranks warning)",
                        n, now - t0)
            self._stop.wait(self._interval)

    def stop(self) -> None:
        self._stop.set()
        try:
            self._coord.shutdown()   # unblocks an in-flight negotiate
        except Exception:
            pass
        self._thread.join(5.0)
        try:
            self._coord.close()
        except Exception:
            pass
        if self._thread.is_alive():
            # The loop may still touch the queue: leaking one small
            # native queue beats a use-after-free.
            return
        with self._inflight_lock:   # excludes a racing record_dispatch
            try:
                self._queue.close()
            except Exception:
                pass
