"""Crash flight recorder: the postmortem that survives the crash.

Counterpart of ``horovod_tpu/obs/flight.py``, a copy of it.  It keeps a
**bounded per-process ring** of recovery-relevant events (fault
firings, retry attempts, elastic rollbacks/resizes, stall escalations)
and dumps it (JSON, rank-tagged) together with the span ring
(``obs/trace.py``) when something goes wrong, so the failure ships its
own postmortem: what fired where, what was in flight (the span ring
holds the step traces), and what recovery did about it.

A dump also carries the armed fault spec and its firing history
(``faults.active_spec()`` and ``faults.history()``), as the reference's
does.

Everything here is fail-soft: a recorder that raises inside a crash
path would replace the real failure with its own.  Hot-path contract:
``enabled()`` is one boolean check (``HVD_TPU_FLIGHT``, default on);
recording is a deque append under a lock.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import tempfile
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

__all__ = ["enabled", "configure", "record", "dump", "events",
           "last_dumps", "reset_for_tests"]

_TRUE = {"1", "true", "yes", "on"}

_lock = threading.Lock()
_enabled: Optional[bool] = None          # guarded-by: _lock (lazy env gate)
_dir: Optional[str] = None               # guarded-by: _lock (lazy env)
_events: "deque" = deque(maxlen=512)     # guarded-by: _lock
_dumps: "deque" = deque(maxlen=32)       # guarded-by: _lock (recent paths)
_seq = 0                                 # guarded-by: _lock


def enabled() -> bool:
    """One boolean per call site (``HVD_TPU_FLIGHT``, default on);
    resolved lazily so pre-init layers agree with the post-init Config,
    which pins it via :func:`configure`."""
    global _enabled
    if _enabled is None:
        with _lock:
            if _enabled is None:
                raw = os.environ.get("HOROVOD_FLIGHT") \
                    or os.environ.get("HVD_TPU_FLIGHT")
                _enabled = True if raw is None \
                    else raw.strip().lower() in _TRUE
    return _enabled


def _directory() -> str:
    # Default under tempdir, not cwd: fault firings dump unconditionally
    # (chaos drills fire hundreds), and a recorder that litters the
    # working directory would get turned off.
    global _dir
    if _dir is None:
        with _lock:
            if _dir is None:
                _dir = os.environ.get("HOROVOD_FLIGHT_DIR") \
                    or os.environ.get("HVD_TPU_FLIGHT_DIR") \
                    or os.path.join(tempfile.gettempdir(), "hvd_tpu_flight")
    return _dir


def configure(enabled: Optional[bool] = None,
              directory: Optional[str] = None,
              ring: Optional[int] = None) -> None:
    """Pin the gate / dump directory / event-ring size from the
    resolved Config (``hvd.init``).  Resizing keeps the newest events —
    the record spans elastic re-inits like every other obs surface."""
    global _enabled, _dir, _events
    with _lock:
        if enabled is not None:
            _enabled = bool(enabled)
        if directory is not None:
            # "" re-arms the lazy env/tempdir default (an init whose
            # Config left the knob unset must not inherit a stale pin).
            _dir = str(directory) or None
        if ring is not None and int(ring) != _events.maxlen:
            _events = deque(_events, maxlen=max(1, int(ring)))


def record(kind: str, **detail: Any) -> None:
    """Append one event to the ring (``kind`` from the closed set the
    call sites use: ``fault``, ``retry``, ``elastic_rollback``,
    ``elastic_resize``, ``replica_died``, ``stall_warn``...).  Detail
    values must be JSON-serializable scalars/short strings — the dump
    is read by humans mid-incident."""
    if not enabled():
        return
    evt = {"ts_us": time.time_ns() / 1e3, "kind": kind, **detail}
    with _lock:
        _events.append(evt)


def events() -> List[Dict[str, Any]]:
    """Copy of the event ring, oldest first."""
    with _lock:
        return [dict(e) for e in _events]


def _rank_tag() -> str:
    from . import trace as _trace

    rank = _trace.process_rank()
    # "x", not "0": a never-initialized process (router, launcher) must
    # not file its postmortems as training rank 0's.
    return "x" if rank is None else str(rank)


def dump(reason: str) -> Optional[str]:
    """Write the postmortem JSON; returns its path (None when disabled
    or the write failed — **never raises**: the recorder must not
    replace the real failure with its own).

    The artifact carries: the event ring, the span ring (the in-flight
    step/request traces at the moment of death), the armed fault spec +
    firing history, and enough identity (rank/pid/host) that a fleet's
    dumps can be correlated."""
    if not enabled():
        return None
    global _seq
    try:
        from .. import faults as _faults
        from . import trace as _trace

        with _lock:
            _seq += 1
            seq = _seq
        rank = _rank_tag()
        safe_reason = "".join(c if c.isalnum() or c in "-_" else "_"
                              for c in reason)[:48] or "dump"
        directory = _directory()
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(
            directory,
            f"hvd_tpu_flight_r{rank}_p{os.getpid()}_{seq:04d}"
            f"_{safe_reason}.json")
        payload = {
            "reason": reason,
            "ts_unix": time.time(),
            "rank": rank,
            "pid": os.getpid(),
            "host": socket.gethostname(),
            "fault_spec": _faults.active_spec(),
            "fault_history": _faults.history(),
            "events": events(),
            "spans": _trace.snapshot(),
        }
        with open(path, "w") as f:
            json.dump(payload, f, indent=1, default=str)
        with _lock:
            _dumps.append(path)
        logger.warning("flight recorder dumped: %s (%s)", path, reason)
        return path
    except Exception as e:   # fail-soft by contract
        logger.warning("flight recorder dump failed (%s): %s", reason, e)
        return None


def last_dumps() -> List[str]:
    """Paths of recent dumps from this process, oldest first."""
    with _lock:
        return list(_dumps)


def reset_for_tests() -> None:
    """Drop events + dump bookkeeping and unpin the lazy env gates
    (tests only — a live process keeps its record across re-inits)."""
    global _enabled, _dir, _seq
    with _lock:
        _events.clear()
        _dumps.clear()
        _seq = 0
        _enabled = None
        _dir = None
