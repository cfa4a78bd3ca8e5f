"""Cross-rank distributed tracing: W3C-style span contexts.

Counterpart of ``horovod_tpu/obs/trace.py``, a copy of it but for where
a rank comes from (:func:`process_rank` reads ``torch.distributed``) and
for the profiler's copy of each span and the layer ranges (below).
Each finished span is mirrored onto the live timeline
(``basics.timeline``) as a slice, with flow arrows for RPC spans.  Every
*step* gets an identity that survives process boundaries:

* a **trace** is one step (``make_train_step``/``make_spmd_train_step``
  — rooted by ``obs.instrument.wrap_step``);
* a **span** is one timed hop/phase inside it (the topology schedule's
  stages, ``topo/schedule.py``; a plan compile);
* the context on the wire is ``(trace_id, span_id)`` hex strings
  (W3C ``traceparent`` minus flags), attached to a request object as
  ``_hvd_trace`` (:func:`inject`/:func:`extract`).

Finished spans land in a **bounded per-process ring** (the crash flight
recorder ``obs/flight.py`` dumps it postmortem).

Timestamps are **unix microseconds** (``time.time_ns``): each process
stamps with its own wall clock, and :func:`estimate_clock_offset`
(Cristian's algorithm over ping RTTs — the minimum-RTT sample bounds the
error by RTT/2) corrects residual skew when :func:`merge_traces` merges
per-process span sets into ONE Chrome-trace file.  :func:`critical_path`
then reports which hop/phase dominated a trace's wall time.

Hot-path contract: one :func:`enabled` check per call site;
``HVD_TPU_TRACE=0`` turns every span into a single boolean test.

**The profiler's copy.**  While a ``torch.profiler`` session records
(:func:`profiling`, one module-flag read), :func:`span` also opens a
``record_function`` range of the same name, so the span shows in the
profiler's host trace as a ``user_annotation`` and the kernels launched
inside it are tied to it by correlation id.  The ring and the profiler
share one clock: the profiler stamps the host's realtime clock too, so a
span's ``start_us`` and its copy's ``baseTimeNanoseconds / 1e3 + ts`` in
the exported Chrome trace differ by the time between the two stamps
(``tests/test_torch_port_layer_spans.py`` holds them within 1 ms).

**Layer ranges** (:func:`layer_scope`, :func:`layer`,
:func:`layer_loss`) are the model's fine-grained ranges, for the
profiler alone: no ring entry, no timeline slice, no ids, and nothing at
all (one boolean check) while no profiler records.  A model's forward
is a chain of adjacent ranges on its thread (embeddings, each block's
attention and MLP sublayers, the loss head); each switch hooks the
gradient of the tensor that enters the new layer, so the backward, on
the autograd engine's thread, runs the same names in reverse order:
the loss's hook opens the last layer's range, the hook of each layer's
input closes that layer's range and opens the one before it, and the
engine's final callback closes the first layer's.
"""

from __future__ import annotations

import contextlib
import functools
import os
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "enabled", "configure", "span", "record_span", "instant", "current",
    "new_context", "use_context", "process_rank",
    "now_us", "inject", "extract", "snapshot", "clear",
    "estimate_clock_offset", "merge_traces", "unresolved_parents",
    "critical_path", "trace_ids", "dump_merged",
    "profiling", "layer_scope", "layer", "layer_loss",
]

_TRUE = {"1", "true", "yes", "on"}

_lock = threading.Lock()
_enabled: Optional[bool] = None          # guarded-by: _lock (lazy env gate)
_ring: "deque" = deque(maxlen=2048)      # guarded-by: _lock
_tls = threading.local()                 # .ctx = (trace_id, span_id) or None


def enabled() -> bool:
    """The per-call-site gate.  Resolved lazily from ``HVD_TPU_TRACE``
    (default on, like ``HVD_TPU_METRICS``) so pre-init layers — the
    launcher's RPC clients, the elastic driver — agree with the
    post-init Config; :func:`configure` (``hvd.init``) pins it."""
    global _enabled
    if _enabled is None:
        with _lock:
            if _enabled is None:
                raw = os.environ.get("HOROVOD_TRACE") \
                    or os.environ.get("HVD_TPU_TRACE")
                _enabled = True if raw is None \
                    else raw.strip().lower() in _TRUE
    return _enabled


def configure(enabled: Optional[bool] = None,
              ring: Optional[int] = None) -> None:
    """Pin the gate / resize the span ring from the resolved Config
    (``hvd.init``).  Resizing keeps the newest spans — never clears
    recorded history across elastic re-inits."""
    global _enabled, _ring
    with _lock:
        if enabled is not None:
            _enabled = bool(enabled)
        if ring is not None and int(ring) != _ring.maxlen:
            _ring = deque(_ring, maxlen=max(1, int(ring)))


def now_us() -> float:
    """Unix wall-clock microseconds — the cross-process span clock (the
    merge step corrects per-process skew; see module docstring)."""
    return time.time_ns() / 1e3


def _new_id(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


def process_rank() -> Optional[int]:
    """This process's rank for span/scrape tagging: the live
    ``torch.distributed`` world when initialized, else the launch env
    (``HVD_TPU_PROCESS_ID``), else None.  The one lookup every tagging
    site (spans, flight dumps) shares."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:
        pass
    raw = os.environ.get("HVD_TPU_PROCESS_ID")
    try:
        return int(raw) if raw is not None else None
    except ValueError:
        return None


def current() -> Optional[Tuple[str, str]]:
    """The calling thread's live ``(trace_id, span_id)`` context, or
    None outside any span."""
    return getattr(_tls, "ctx", None)


def new_context() -> Tuple[str, str]:
    """Mint a fresh root ``(trace_id, span_id)`` identity without
    recording anything — for a span whose interval is only known after
    the fact (record it at completion with ``record_span(ctx=...)``);
    install it with :func:`use_context` so work done meanwhile parents
    under it."""
    return (_new_id(16), _new_id(8))


@contextlib.contextmanager
def use_context(ctx: Optional[Tuple[str, str]]):
    """Install ``ctx`` as the calling thread's current context for the
    block (no span is recorded — pair with :func:`new_context` /
    ``record_span(ctx=...)`` for deferred spans)."""
    prev = current()
    _tls.ctx = ctx
    try:
        yield ctx
    finally:
        _tls.ctx = prev


def _append(rec: Dict[str, Any]) -> None:
    with _lock:
        _ring.append(rec)


def _emit_timeline(rec: Dict[str, Any]) -> None:
    """Mirror one finished span onto the live framework Timeline (slice
    + flow endpoints for RPC spans).  Timeline timestamps are relative
    to ITS clock, so the slice is anchored by how long ago the span
    *ended* on the wall clock — a reconstructed span (``record_span``
    with historical timing) lands where it happened, not ending at
    "now"."""
    try:
        from .. import basics

        tl = basics.peek("timeline")   # fail-soft: None pre-init
        if tl is None or not tl.enabled:
            return
        lag = max(0.0, now_us() - (rec["start_us"] + rec["dur_us"]))
        end = tl._now_us() - lag
        start = max(0.0, end - rec["dur_us"])
        tl.record(rec["trace_id"][:8], rec["name"], start, rec["dur_us"],
                  {"trace_id": rec["trace_id"], "span_id": rec["span_id"],
                   "parent_id": rec["parent_id"]})
        if rec["kind"] == "client":
            tl.flow(rec["name"], rec["span_id"], "s", ts_us=start)
        elif rec["kind"] == "server" and rec["parent_id"]:
            tl.flow(rec["name"], rec["parent_id"], "f", ts_us=start)
    except Exception:
        pass   # observability never takes down the path being observed


def record_span(name: str, *, parent: Optional[Tuple[str, str]],
                start_us: float, dur_us: float, kind: str = "internal",
                args: Optional[Dict[str, Any]] = None,
                ctx: Optional[Tuple[str, str]] = None) -> Optional[str]:
    """Record one finished span with explicit timing (reconstructed
    phases — the batcher's queued/decode windows — where a context
    manager cannot wrap the interval).  ``parent=None`` roots a fresh
    trace.  ``ctx`` records the span AS a pre-minted
    :func:`new_context` identity — how a deferred root (a request whose
    total latency is only known at completion, with child phases
    already recorded against the context) joins its own trace.  Returns
    the span id (None when tracing is off)."""
    if not enabled():
        return None
    if parent is not None:
        trace_id, parent_id = parent
    else:
        trace_id, parent_id = _new_id(16), None
    if ctx is not None:
        trace_id = str(ctx[0])
    rec = {
        "name": name,
        "trace_id": trace_id,
        "span_id": str(ctx[1]) if ctx is not None else _new_id(8),
        "parent_id": parent_id,
        "kind": kind,
        "start_us": float(start_us),
        "dur_us": max(0.0, float(dur_us)),
        "rank": process_rank(),
        "pid": os.getpid(),
        "args": dict(args) if args else {},
    }
    _append(rec)
    _emit_timeline(rec)
    return rec["span_id"]


def instant(name: str, args: Optional[Dict[str, Any]] = None) -> Optional[str]:
    """Zero-duration span at *now*, parented to the calling thread's
    context (a point event that must survive in the flight ring — fault
    firings use this)."""
    if not enabled():
        return None
    return record_span(name, parent=current(), start_us=now_us(),
                       dur_us=0.0, kind="instant", args=args)


@contextlib.contextmanager
def span(name: str, *, root: bool = False,
         parent: Optional[Tuple[str, str]] = None, kind: str = "internal",
         args: Optional[Dict[str, Any]] = None):
    """Context manager timing one span; yields the new ``(trace_id,
    span_id)`` context (None when tracing is off) and installs it as the
    thread's current context for the duration, so nested spans and RPC
    clients parent correctly without plumbing.

    ``root=True`` forces a fresh trace (the step loop / router
    admission); ``parent`` grafts onto an explicit remote context (the
    server side of an RPC).  An escaping exception is recorded in the
    span's args as ``error`` and re-raised."""
    if not enabled():
        yield None
        return
    # The profiler's copy opens first, so that its start and the ring's
    # are stamped back to back.
    copy = _range_enter(name) if profiling() else None
    if root:
        ctx_parent: Optional[Tuple[str, str]] = None
    elif parent is not None:
        ctx_parent = (str(parent[0]), str(parent[1]))
    else:
        ctx_parent = current()
    if ctx_parent is not None:
        trace_id, parent_id = ctx_parent
    else:
        trace_id, parent_id = _new_id(16), None
    ctx = (trace_id, _new_id(8))
    prev = current()
    _tls.ctx = ctx
    start = now_us()
    span_args = dict(args) if args else {}
    try:
        yield ctx
    except BaseException as e:
        span_args["error"] = type(e).__name__
        raise
    finally:
        if copy is not None:
            _range_exit(copy)
        _tls.ctx = prev
        rec = {
            "name": name,
            "trace_id": trace_id,
            "span_id": ctx[1],
            "parent_id": parent_id,
            "kind": kind,
            "start_us": start,
            "dur_us": max(0.0, now_us() - start),
            "rank": process_rank(),
            "pid": os.getpid(),
            "args": span_args,
        }
        _append(rec)
        _emit_timeline(rec)


# --- the profiler's ranges ---------------------------------------------------

def profiling() -> bool:
    """True while a ``torch.profiler`` (or autograd profiler) session
    records: one read of the profiler module's flag, False before torch
    is imported."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and getattr(prof, "_is_profiler_enabled", False)


def _range_enter(name: str):
    import torch

    return torch.ops.profiler._record_function_enter_new(name, None)


def _range_exit(handle) -> None:
    import torch

    torch.ops.profiler._record_function_exit._RecordFunction(handle)


class _Chain:
    """The open layer range of one thread's forward, or of the backward
    on one thread: its name and the profiler's handle."""

    __slots__ = ("name", "handle")

    def __init__(self) -> None:
        self.name: Optional[str] = None
        self.handle = None

    def switch(self, name: Optional[str]) -> None:
        if self.handle is not None:
            _range_exit(self.handle)
        self.name = name
        self.handle = _range_enter(name) if name is not None else None


class _LayerRanges:
    """:func:`layer_scope`'s context: the outermost one on a thread owns
    the chain and closes its last range on exit; inner ones join."""

    __slots__ = ("owner",)

    def __enter__(self) -> None:
        self.owner = getattr(_tls, "layers", None) is None
        if self.owner:
            _tls.layers = _Chain()

    def __exit__(self, *exc) -> bool:
        if self.owner:
            chain, _tls.layers = _tls.layers, None
            chain.switch(None)
        return False


def layer_scope(fn):
    """Decorate a model's ``forward`` or a loss function around it to
    run in the scope of one forward's layer chain: :func:`layer`
    switches the chain's range, and the outermost scope on the thread
    ends the last one.  While no profiler records, a plain call."""
    @functools.wraps(fn)
    def scoped(*args, **kwargs):
        if not profiling():
            return fn(*args, **kwargs)
        with _LayerRanges():
            return fn(*args, **kwargs)

    return scoped


def layer(name: str, x=None) -> None:
    """Inside :func:`layer_scope`, end the forward's open layer range
    and open ``name``; ``x``, the tensor entering the layer, gets a
    gradient hook that ends ``name``'s backward range and opens the
    range of the layer before it.  Switching to the open name, or with
    no scope on the thread, does nothing; no hook without a gradient."""
    if not profiling():
        return
    chain = getattr(_tls, "layers", None)
    if chain is None or chain.name == name:
        return
    before = chain.name
    chain.switch(name)
    if x is not None and x.requires_grad:
        x.register_hook(functools.partial(_backward_into, before))


def layer_loss(loss):
    """Hook ``loss`` (the chain's output) so that its gradient opens the
    backward range of the forward's last layer; returns ``loss``."""
    if profiling() and loss.requires_grad:
        chain = getattr(_tls, "layers", None)
        if chain is not None:
            loss.register_hook(functools.partial(_backward_into, chain.name))
    return loss


def _backward_into(name: Optional[str], _grad) -> None:
    """A layer hook, on the thread that runs the backward: end the
    range open there and open ``name``'s (None: none).  The first
    opening of a backward queues the engine's final callback, which
    ends the last range."""
    chain = getattr(_tls, "backward", None)
    if chain is None:
        chain = _tls.backward = _Chain()
    if chain.name is None and name is not None:
        from torch.autograd import Variable

        Variable._execution_engine.queue_callback(
            functools.partial(chain.switch, None))
    chain.switch(name)


# --- wire propagation --------------------------------------------------------

def inject(obj: Any, ctx: Optional[Tuple[str, str]] = None) -> Any:
    """Attach the context to an outbound request object (instance
    attribute — the pickled payload carries it, the HMAC frame format
    doesn't change).  No-op without a context."""
    ctx = ctx if ctx is not None else current()
    if ctx is not None:
        try:
            obj._hvd_trace = (str(ctx[0]), str(ctx[1]))
        except AttributeError:
            pass   # __slots__ classes opt out of propagation
    return obj


def extract(obj: Any) -> Optional[Tuple[str, str]]:
    """Read a propagated context off an inbound request (None when the
    peer didn't trace, or predates tracing)."""
    ctx = getattr(obj, "_hvd_trace", None)
    if (isinstance(ctx, (tuple, list)) and len(ctx) == 2
            and all(isinstance(x, str) for x in ctx)):
        return (ctx[0], ctx[1])
    return None


# --- ring access -------------------------------------------------------------

def snapshot(clear: bool = False) -> List[Dict[str, Any]]:
    """Copy of the span ring, oldest first (the ``TraceRequest`` payload
    and the flight recorder's span section).  ``clear=True`` drains it
    (a collector that owns the spans it fetched)."""
    with _lock:
        out = [dict(r) for r in _ring]
        if clear:
            _ring.clear()
    return out


def clear() -> None:
    with _lock:
        _ring.clear()


# --- clock-offset estimation (Cristian over ping RTTs) -----------------------

def estimate_clock_offset(
        samples: Sequence[Tuple[float, float, float]]) -> Tuple[float, float]:
    """Estimate a peer's clock offset from RTT samples.

    Each sample is ``(send_us, recv_us, peer_us)`` on the local clock /
    the peer's clock: the local process sent a ping at ``send_us``, got
    the answer at ``recv_us``, and the answer carried the peer's clock
    reading ``peer_us`` .  Assuming the wire
    is roughly symmetric, the peer stamped at the local midpoint, so
    ``offset = peer_us - (send_us + recv_us) / 2`` with error bounded by
    RTT/2 — the **minimum-RTT** sample gives the tightest bound
    (Cristian's algorithm).  Returns ``(offset_us, error_bound_us)``;
    ``local + offset ≈ peer``.
    """
    if not samples:
        raise ValueError("estimate_clock_offset needs at least one sample")
    best = None
    for send_us, recv_us, peer_us in samples:
        rtt = recv_us - send_us
        if rtt < 0:
            raise ValueError(f"negative RTT sample: send={send_us} "
                             f"recv={recv_us}")
        off = peer_us - (send_us + recv_us) / 2.0
        if best is None or rtt < best[1]:
            best = (off, rtt)
    return best[0], best[1] / 2.0


# --- merge + critical path ---------------------------------------------------

def _span_tid(rec: Dict[str, Any]) -> int:
    """Stable per-trace lane so each trace renders as its own row.
    Our ids are hex, but merged files may carry foreign ones — fall
    back to a stable string hash."""
    tid = str(rec["trace_id"])
    try:
        return int(tid[:8], 16) & 0x7FFFFFFF
    except ValueError:
        import zlib

        return zlib.crc32(tid.encode()) & 0x7FFFFFFF


def merge_traces(groups: Dict[str, Tuple[float, List[Dict[str, Any]]]]
                 ) -> List[Dict[str, Any]]:
    """Merge per-process span sets into ONE Chrome-trace event list.

    ``groups`` maps a process label (e.g. ``rank0`` / ``router``) to
    ``(offset_us, spans)`` where ``offset_us`` converts that process's
    clock onto the reference clock (``ref + offset = theirs``, i.e. the
    :func:`estimate_clock_offset` output against the reference process
    — each span's ``start_us`` has the offset *subtracted*).  Emits
    process-name metadata, one ``"X"`` slice per span (args carry the
    span identity), and ``"s"``/``"f"`` flow pairs for every
    parent→child edge that crosses processes, so Perfetto draws the
    causal arrow between ranks."""
    events: List[Dict[str, Any]] = []
    where: Dict[str, Tuple[int, int, float]] = {}  # span_id -> (pid, tid, ts)
    spans_flat: List[Tuple[int, Dict[str, Any], float]] = []
    for pid, (label, (offset_us, spans)) in enumerate(sorted(groups.items()),
                                                     start=1):
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": label}})
        for rec in spans:
            ts = float(rec["start_us"]) - float(offset_us)
            spans_flat.append((pid, rec, ts))
            where[rec["span_id"]] = (pid, _span_tid(rec), ts)
    for pid, rec, ts in spans_flat:
        events.append({
            "name": rec["name"], "cat": "trace", "ph": "X",
            "ts": ts, "dur": rec["dur_us"], "pid": pid,
            "tid": _span_tid(rec),
            "args": {"trace_id": rec["trace_id"],
                     "span_id": rec["span_id"],
                     "parent_id": rec["parent_id"],
                     "rank": rec.get("rank"), **rec.get("args", {})},
        })
    for pid, rec, ts in spans_flat:
        parent = rec.get("parent_id")
        if not parent or parent not in where:
            continue
        ppid, ptid, pts = where[parent]
        if ppid == pid:
            continue   # in-process nesting needs no arrow
        fid = rec["span_id"]
        events.append({"name": rec["name"], "cat": "trace", "ph": "s",
                       "id": fid, "ts": pts, "pid": ppid, "tid": ptid})
        events.append({"name": rec["name"], "cat": "trace", "ph": "f",
                       "bp": "e", "id": fid, "ts": ts, "pid": pid,
                       "tid": _span_tid(rec)})
    events.sort(key=lambda e: e.get("ts", 0.0))
    return events


def unresolved_parents(spans: Iterable[Dict[str, Any]]) -> List[str]:
    """Parent ids referenced by some span but present in none — the
    merge-completeness check (a trace whose every parent resolves was
    collected whole)."""
    ids = {r["span_id"] for r in spans}
    return sorted({r["parent_id"] for r in spans
                   if r.get("parent_id") and r["parent_id"] not in ids})


def trace_ids(spans: Iterable[Dict[str, Any]]) -> List[str]:
    """Distinct trace ids, by first appearance."""
    seen: List[str] = []
    for r in spans:
        if r["trace_id"] not in seen:
            seen.append(r["trace_id"])
    return seen


def dump_merged(path: str, label: Optional[str] = None,
                report: bool = True) -> Optional[Dict[str, Any]]:
    """Write this process's span ring as a self-contained merged trace
    artifact (the single-process degenerate of :func:`merge_traces`, at
    offset 0).  Returns the
    headline critical-path report (largest trace), or None when the
    ring is empty."""
    import json

    spans = snapshot()
    if label is None:
        rank = process_rank()
        label = f"rank{rank}" if rank is not None else f"pid{os.getpid()}"
    reports: List[Dict[str, Any]] = []
    if spans and report:
        reports = sorted((critical_path(spans, tid)
                          for tid in trace_ids(spans)),
                         key=lambda r: -r["total_us"])
    doc = {
        "traceEvents": merge_traces({label: (0.0, spans)}),
        "displayTimeUnit": "ms",
        "metadata": {
            "tool": "horovod_tpu_torch obs.trace.dump_merged",
            "processes": {label: {"spans": len(spans),
                                  "clock_offset_us": 0.0}},
            "traces": len(trace_ids(spans)),
            "spans": len(spans),
            "unresolved_parents": unresolved_parents(spans),
            **({"critical_paths": reports} if reports else {}),
        },
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, default=str)
    return reports[0] if reports else None


def critical_path(spans: Sequence[Dict[str, Any]],
                  trace_id: Optional[str] = None) -> Dict[str, Any]:
    """Per-trace critical-path report: which hop/phase dominated.

    Picks ``trace_id`` (default: the trace with the longest root span),
    builds the parent tree, and charges each span its **self time**
    (duration minus its direct children's durations, clamped at 0 —
    time spent in that hop itself, not delegated further).  The
    ``dominant`` entry names the span family with the largest summed
    self time: for a serve trace that is the phase that dominated TTFT
    or total latency; for a step trace, the hop that dominated step
    time.  ``path`` is the greedy longest-child walk from the root."""
    spans = [r for r in spans]
    if not spans:
        raise ValueError("critical_path needs at least one span")
    if trace_id is None:
        roots = [r for r in spans if not r.get("parent_id")]
        pick = max(roots or spans, key=lambda r: r["dur_us"])
        trace_id = pick["trace_id"]
    trace = [r for r in spans if r["trace_id"] == trace_id]
    by_id = {r["span_id"]: r for r in trace}
    children: Dict[Optional[str], List[Dict[str, Any]]] = {}
    for r in trace:
        parent = r.get("parent_id")
        children.setdefault(parent if parent in by_id else None,
                            []).append(r)
    self_us: Dict[str, float] = {}
    for r in trace:
        kids = children.get(r["span_id"], [])
        own = max(0.0, r["dur_us"] - sum(k["dur_us"] for k in kids))
        self_us[r["name"]] = self_us.get(r["name"], 0.0) + own
    roots = children.get(None, [])
    root = max(roots, key=lambda r: r["dur_us"]) if roots \
        else max(trace, key=lambda r: r["dur_us"])
    path = [root["name"]]
    node = root
    while True:
        kids = children.get(node["span_id"], [])
        if not kids:
            break
        node = max(kids, key=lambda k: k["dur_us"])
        path.append(node["name"])
    dominant = max(self_us.items(), key=lambda kv: kv[1])
    return {
        "trace_id": trace_id,
        "root": root["name"],
        "total_us": root["dur_us"],
        "dominant": dominant[0],
        "dominant_self_us": dominant[1],
        "path": path,
        "self_us": dict(sorted(self_us.items(),
                               key=lambda kv: -kv[1])),
        "unresolved_parents": unresolved_parents(trace),
    }
