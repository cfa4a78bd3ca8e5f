"""Stall detection: a heartbeat watchdog.

Horovod's ``horovod/common/stall_inspector.cc`` warns when a tensor was
submitted on some ranks but not all for ``HOROVOD_STALL_CHECK_TIME_
SECONDS``, and can shut the job down after ``HOROVOD_STALL_SHUTDOWN_
TIME_SECONDS``.  Counterpart of ``horovod_tpu/utils/stall.py``: a
process cannot see its peers' submissions, so this inspector is a
host-side watchdog.  Every collective dispatch (``ops.collectives.
_dispatch``) heartbeats it; a daemon thread warns when no heartbeat came
within the window, counts ``hvd_tpu_stall_events_total{kind}`` through
``obs.instrument.on_stall`` and can end the process so an elastic
driver notices.  The cross-rank view (which ranks are missing) is
:mod:`.cross_stall`'s.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional

from .logging import get_logger

logger = get_logger(__name__)


class StallInspector:
    def __init__(self, enabled: bool = True, warn_after_s: float = 60.0,
                 shutdown_after_s: float = 0.0,
                 on_shutdown: Optional[Callable[[], None]] = None) -> None:
        self._enabled = enabled and warn_after_s > 0
        self._warn_after_s = warn_after_s
        self._shutdown_after_s = shutdown_after_s
        self._on_shutdown = on_shutdown or (lambda: os._exit(17))
        self._lock = threading.Lock()
        self._last_activity: Optional[float] = None  # guarded-by: _lock
        self._warned = False                         # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        """Arm the watchdog (first heartbeat arms it implicitly too)."""
        if not self._enabled or self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._watch, name="hvd-torch-stall-inspector", daemon=True
        )
        self._thread.start()

    def record_activity(self, what: str = "step") -> None:
        """Heartbeat — called by the training loop / collective API."""
        if not self._enabled:
            return
        with self._lock:
            self._last_activity = time.monotonic()
            self._warned = False
        if self._thread is None:
            self.start()

    def pause(self):
        """Context manager disarming the watchdog across known-idle spans
        (evaluation, checkpoint writes) so healthy non-collective work is
        not reported — the reference never fires on idleness at all (it
        tracks some-but-not-all-ranks tensor submission), so without this
        the watchdog would be strictly noisier.

        Usage::

            with hvd.stall_inspector().pause():
                evaluate(...)
        """
        import contextlib

        @contextlib.contextmanager
        def _pause():
            with self._lock:
                self._last_activity = None  # disarm
            try:
                yield
            finally:
                self.record_activity("resume")

        return _pause()

    def _watch(self) -> None:
        while not self._stop.wait(min(self._warn_after_s / 4, 5.0)):
            with self._lock:
                last = self._last_activity
                warned = self._warned
            if last is None:
                continue
            idle = time.monotonic() - last
            if idle > self._warn_after_s and not warned:
                logger.warning(
                    "Potential stall: no collective/step activity for %.0f s "
                    "(threshold %.0f s). One or more peer processes may have "
                    "stopped participating — or this process is doing long "
                    "host-side work; wrap that in stall_inspector().pause().",
                    idle, self._warn_after_s,
                )
                from ..obs import flight as _flight
                from ..obs import instrument as _obs

                _obs.on_stall("warn")
                _flight.record("stall_warn", idle_s=round(idle, 1))
                with self._lock:
                    self._warned = True
            if self._shutdown_after_s > 0 and idle > self._shutdown_after_s:
                logger.error(
                    "Stall exceeded shutdown threshold (%.0f s); aborting.",
                    self._shutdown_after_s,
                )
                from ..obs import flight as _flight
                from ..obs import instrument as _obs

                _obs.on_stall("shutdown")
                # The default shutdown hook is os._exit — the dump is
                # the only record of what this process was doing.
                _flight.record("stall_shutdown", idle_s=round(idle, 1))
                _flight.dump("stall_shutdown")
                self._on_shutdown()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
