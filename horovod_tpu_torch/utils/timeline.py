"""Chrome-trace timeline of collective lifecycles.

Horovod's ``horovod/common/timeline.cc``: a background-thread JSON
writer, activated by ``HOROVOD_TIMELINE=<path>``, with cycle marks under
``HOROVOD_TIMELINE_MARK_CYCLES``.  Counterpart of
``horovod_tpu/utils/timeline.py``: the same events, names and
arguments.  The eager collective API records ``ENQUEUE`` (the call
prepares its work) and ``EXECUTE`` (the work is started on the group),
the obs layer mirrors its finished spans (slices, flow arrows for RPCs)
and the train step's counters (``train``: ``step_time_ms``,
``tokens_per_s``).  The file is the ``chrome://tracing`` / Perfetto
JSON array.

Each process writes its own file (:func:`per_process_path`: rank 0 the
path itself, rank r ``<path>.rank<r>``).  On-device detail comes from
:func:`profiler_trace` (``torch.profiler``).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Optional


class Timeline:
    """Thread-safe Chrome-trace event writer.

    Events use the `ph` convention of the trace-event format: ``X``
    (complete, with ``dur``) events per phase, ``i`` (instant) for cycle
    marks — matching what the reference emits closely enough that the same
    tooling renders both.

    Backend: prefers the native background-thread writer
    (``native/src/timeline.cc``, the reference's writer-thread design),
    falling back to inline Python writes when the native library is
    unavailable; :attr:`native` says which one writes.
    """

    def __init__(self, path: Optional[str], mark_cycles: bool = False,
                 use_native: bool = True) -> None:
        self._path = path
        self._mark_cycles = mark_cycles
        self._lock = threading.Lock()
        self._file = None     # guarded-by: _lock
        self._native = None   # guarded-by: _lock
        self._first = True    # guarded-by: _lock
        self._t0 = time.perf_counter_ns()
        if path:
            if use_native:
                try:
                    from ..native import runtime as _nrt

                    if _nrt.available():
                        self._native = _nrt.NativeTimeline(
                            path, mark_cycles=mark_cycles)
                except Exception:
                    self._native = None
            if self._native is None:
                self._file = open(path, "w", buffering=1)
                self._file.write("[\n")

    @property
    def native(self) -> bool:
        """True while the native writer thread writes the file."""
        with self._lock:
            return self._native is not None

    @property
    def enabled(self) -> bool:
        # Locked read: start_timeline/stop_timeline swap the file from
        # other threads while obs mirrors consult this per event.
        with self._lock:
            return self._file is not None or self._native is not None

    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self._t0) / 1e3

    def _emit(self, event: dict) -> None:
        # No unlocked fast-path read: an uncontended lock acquire costs
        # nanoseconds and the double-checked peek was a (benign-looking)
        # read-site race on the guarded handle.
        with self._lock:
            if self._file is None:
                return
            prefix = "" if self._first else ",\n"
            self._first = False
            self._file.write(prefix + json.dumps(event))

    def record(self, name: str, phase: str, start_us: float, dur_us: float,
               args: Optional[dict] = None) -> None:
        """One complete event: e.g. tensor 'grad/kernel0', phase EXECUTE."""
        native = self._native  # snapshot: close() may null it concurrently
        if native is not None:
            body = ", ".join(f"{json.dumps(str(k))}: {json.dumps(v)}"
                             for k, v in (args or {}).items())
            native.record(name, phase, start_us, dur_us, body)
            return
        self._emit({
            "name": phase, "cat": "collective", "ph": "X",
            "ts": start_us, "dur": dur_us,
            "pid": os.getpid(), "tid": hash(name) % (1 << 31),
            "args": {"tensor": name, **(args or {})},
        })

    def counter(self, name: str, values: Optional[dict] = None,
                ts_us: Optional[float] = None) -> None:
        """Chrome-trace counter (``"C"``) event: one counter *track* per
        ``name``, one series per key of ``values`` — how scraped gauges
        (obs/export) and traces line up on the same Perfetto time axis
        (the step wrapper mirrors step_time_ms / tokens_per_s here each
        step).  Non-numeric values are dropped: the trace viewer's
        counter tracks plot numbers only."""
        series = {k: float(v) for k, v in (values or {}).items()
                  if isinstance(v, (int, float))}
        if not series:
            return
        ts = self._now_us() if ts_us is None else ts_us
        native = self._native
        if native is not None:
            body = ", ".join(f"{json.dumps(str(k))}: {json.dumps(v)}"
                             for k, v in series.items())
            native.counter(name, ts, body)
            return
        self._emit({
            "name": name, "cat": "counter", "ph": "C", "ts": ts,
            "pid": os.getpid(), "tid": 0, "args": series,
        })

    def flow(self, name: str, flow_id: str, phase: str,
             ts_us: Optional[float] = None) -> None:
        """Chrome-trace flow event: ``phase`` is ``"s"`` (start, at the
        producing slice) or ``"f"`` (finish, at the consuming slice),
        bound by ``flow_id`` — how a cross-process span edge (an RPC
        client span on one rank, its server span on another) renders as
        an arrow once per-process files are merged (the tracing layer
        keys flows by the client span id; see docs/tracing.md)."""
        if phase not in ("s", "f"):
            raise ValueError(f"flow phase must be 's' or 'f', got {phase!r}")
        ts = self._now_us() if ts_us is None else ts_us
        native = self._native
        if native is not None:
            native.flow(name, phase, str(flow_id), ts)
            return
        event = {
            "name": name, "cat": "flow", "ph": phase, "id": str(flow_id),
            "ts": ts, "pid": os.getpid(), "tid": 0,
        }
        if phase == "f":
            event["bp"] = "e"   # bind to the enclosing slice
        self._emit(event)

    def mark_cycle(self) -> None:
        """Instant marker per dispatch cycle (reference:
        ``HOROVOD_TIMELINE_MARK_CYCLES``)."""
        if not self._mark_cycles:
            return
        native = self._native
        if native is not None:
            native.mark_cycle(self._now_us())
            return
        self._emit({
            "name": "CYCLE", "cat": "cycle", "ph": "i",
            "ts": self._now_us(), "pid": os.getpid(), "tid": 0, "s": "p",
        })

    @contextlib.contextmanager
    def activity(self, name: str, phase: str, args: Optional[dict] = None):
        """Context manager timing one phase of one named tensor/op."""
        if not self.enabled:
            yield
            return
        start = self._now_us()
        try:
            yield
        finally:
            # Re-check after the yield: a timeline closed mid-activity
            # (elastic reset tearing down hvd state while a step is in
            # flight) must drop the event, not hand it to a writer whose
            # file/native handle is already gone.
            if self.enabled:
                self.record(name, phase, start, self._now_us() - start,
                            args)

    def close(self) -> None:
        with self._lock:
            if self._native is not None:
                self._native.close()
                self._native = None
            if self._file is not None:
                self._file.write("\n]\n")
                self._file.close()
                self._file = None


def per_process_path(path: Optional[str], rank: int) -> Optional[str]:
    """One writer a file: rank 0 keeps ``path``, rank r writes
    ``<path>.rank<r>`` (the reference's ``basics._per_process_path``),
    so a path shared by every rank of a job neither truncates nor
    interleaves.  Applied in the library at ``init``, so it holds on
    every launch path."""
    if path and rank > 0:
        return f"{path}.rank{rank}"
    return path


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """The card's side of the timeline: a ``torch.profiler`` trace of the
    block (CPU and CUDA activities), written to ``log_dir`` as a Chrome
    trace, the counterpart of the reference's ``jax.profiler`` trace."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof
