"""Reading ``torch.profiler``'s trace: device intervals, their union,
attribution to the host op that launched them, and the breakdown.

The trace is the profiler's Chrome trace (``export_chrome_trace``), read
back as events.  Times are microseconds on the host's clock, device
events included (the profiler aligns them).  A device operation is an
event of category ``kernel``, ``gpu_memcpy`` or ``gpu_memset``; its
launch is the ``cuda_runtime`` or ``cuda_driver`` event with the same
``correlation`` id, on the host thread that launched it.  The
benchmark's own host spans are ``record_function`` ranges named
``portbench.*``.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
SPAN_PREFIX = "portbench."
WINDOW_SPAN = "portbench.window"

Interval = Tuple[float, float]


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: float
    end: float
    correlation: Optional[int]
    cat: str


@dataclasses.dataclass
class HostOp:
    name: str
    tid: int
    start: float
    end: float


class Trace:
    """The events of one rank's trace."""

    def __init__(self, events: Iterable[dict]) -> None:
        self.device: List[DeviceOp] = []
        self.launch: Dict[int, Tuple[int, float]] = {}   # corr -> (tid, ts)
        self.host: List[HostOp] = []
        self.api: List[HostOp] = []                      # CUDA API calls
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts = float(e.get("ts", 0.0))
            end = ts + float(e.get("dur", 0.0))
            args = e.get("args") or {}
            if cat in DEVICE_CATS:
                self.device.append(DeviceOp(e.get("name", ""), ts, end,
                                            args.get("correlation"), cat))
            elif cat in LAUNCH_CATS:
                self.api.append(HostOp(e.get("name", ""), e.get("tid"), ts,
                                       end))
                if "correlation" in args:
                    self.launch[args["correlation"]] = (e.get("tid"), ts)
            elif cat in HOST_CATS:
                self.host.append(HostOp(e.get("name", ""), e.get("tid"), ts,
                                        end))
        self.device.sort(key=lambda op: op.start)

    @classmethod
    def load(cls, path) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        events = data["traceEvents"] if isinstance(data, dict) else data
        return cls(events)

    # -- host spans --
    def spans(self, name: str) -> List[HostOp]:
        return sorted((h for h in self.host if h.name == name),
                      key=lambda h: h.start)

    def window(self) -> Optional[Interval]:
        """The traced window: the benchmark's ``portbench.window`` span,
        or in a trace of the device alone (no host ops), from the first
        CUDA call to the end of the last device operation."""
        spans = self.spans(WINDOW_SPAN)
        if spans:
            return spans[0].start, spans[-1].end
        if not self.device:
            return None
        first = min([a.start for a in self.api] + [self.device[0].start])
        return first, max(op.end for op in self.device)

    # -- device intervals --
    def device_ops(self, within: Optional[Interval] = None,
                   kernels_only: bool = False) -> List[DeviceOp]:
        ops = [op for op in self.device
               if not kernels_only or op.cat == "kernel"]
        if within is None:
            return ops
        lo, hi = within
        return [op for op in ops if op.end > lo and op.start < hi]

    def launched_under(self, host_name: str,
                       ops: Sequence[DeviceOp]) -> List[DeviceOp]:
        """The ops whose launch lies inside a host op whose name holds
        ``host_name``, on the thread that launched them."""
        by_tid: Dict[int, List[Interval]] = {}
        for h in self.host:
            if host_name in h.name:
                by_tid.setdefault(h.tid, []).append((h.start, h.end))
        merged = {tid: union(iv) for tid, iv in by_tid.items()}
        starts = {tid: [a for a, _ in iv] for tid, iv in merged.items()}
        out = []
        for op in ops:
            tid, ts = self.launch.get(op.correlation, (None, None))
            if tid not in merged:
                continue
            i = bisect.bisect_right(starts[tid], ts) - 1
            if i >= 0 and merged[tid][i][1] >= ts:
                out.append(op)
        return out


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """Sorted, disjoint intervals covering the same time."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def measure(intervals: Iterable[Interval]) -> float:
    return sum(b - a for a, b in union(intervals))


def clip(intervals: Iterable[Interval], window: Interval) -> List[Interval]:
    lo, hi = window
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


def minus(a: Iterable[Interval], b: Iterable[Interval]) -> float:
    """The time covered by ``a`` and not by ``b``."""
    ua, ub = union(a), union(b)
    covered = 0.0
    j = 0
    for lo, hi in ua:
        while j < len(ub) and ub[j][1] <= lo:
            j += 1
        k = j
        while k < len(ub) and ub[k][0] < hi:
            covered += min(hi, ub[k][1]) - max(lo, ub[k][0])
            k += 1
    return sum(hi - lo for lo, hi in ua) - covered


def gaps(busy: Sequence[Interval], window: Interval) -> List[Interval]:
    """The idle stretches of ``window`` between the ``busy`` intervals."""
    out, t = [], window[0]
    for a, b in union(clip(busy, window)):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t < window[1]:
        out.append((t, window[1]))
    return out


def host_label(trace: Trace, t: float) -> str:
    """What the host was doing at ``t``: the innermost benchmark span and
    host op open then, or in a trace of the device alone, the CUDA call
    open then (none: the host was in Python between CUDA calls)."""
    def innermost(cands):
        open_ = [h for h in cands if h.start <= t <= h.end]
        return min(open_, key=lambda h: h.end - h.start).name if open_ else None

    if not trace.host:
        return f"host in {innermost(trace.api) or 'Python, between CUDA calls'}"
    mine = innermost(h for h in trace.host if h.name.startswith(SPAN_PREFIX))
    op = innermost(h for h in trace.host
                   if not h.name.startswith(SPAN_PREFIX))
    return f"{mine or 'outside the steps'}: {op or 'no host op'}"


def breakdown(trace: Trace, top: int = 10) -> dict:
    """``{"device_ops": [[name, s], ...], "idle_gaps": [[label, s], ...]}``
    over the traced window: the device operations with the most time
    (summed by name) and the longest idle gaps, labelled by the host."""
    window = trace.window()
    if window is None:
        return {"device_ops": [], "idle_gaps": []}
    ops = trace.device_ops(window)
    by_name: Dict[str, float] = {}
    for op in ops:
        by_name[op.name] = by_name.get(op.name, 0.0) + (op.end - op.start)
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps([(op.start, op.end) for op in ops], window),
                  key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[name[:200], us * 1e-6] for name, us in device_ops],
            "idle_gaps": [[host_label(trace, a)[:200], (b - a) * 1e-6]
                          for a, b in idle]}


def busy_and_window(trace: Trace) -> Optional[Tuple[float, float]]:
    """``(busy_s, window_s)``: the union of device operations inside the
    traced window, and its length; None without a window or device ops."""
    window = trace.window()
    if window is None:
        return None
    ops = trace.device_ops(window)
    if not ops:
        return None
    busy = measure(clip([(op.start, op.end) for op in ops], window))
    return busy * 1e-6, (window[1] - window[0]) * 1e-6
