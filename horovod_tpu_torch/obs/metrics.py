"""Process-wide metrics registry: Counter / Gauge / Histogram.

Counterpart of ``horovod_tpu/obs/metrics.py``, a copy of it: the same
families, the same bounded rings and label cap, the same snapshot
shape, so the two packages' registries compare equal for the same
calls and render the same Prometheus text (:mod:`.export`).  Every
layer that computes a signal (the train step's wall time, the fusion
planner's wire bytes, the autotuner's windows) records it into ONE
registry, and one export surface serves all of it.

Design constraints, in priority order:

* **Bounded memory.** Histograms keep samples in fixed-size rings
  (exact ``count``/``sum`` survive eviction); label cardinality per
  family is capped (beyond the cap, series collapse into one
  ``other="true"`` overflow series with a warn-once).
* **Thread safety.** Writers are the training loop and the scrape
  endpoint's threads; one registry lock serializes them (recording is
  a few dict/float ops, never on a device-blocking path).
* **Hot-path gate.** ``HVD_TPU_METRICS=0`` turns every instrumentation
  call site into a single function call returning False
  (:func:`enabled`).
"""

from __future__ import annotations

import collections
import logging
import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "percentile", "Ring", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "registry", "enabled", "configure",
    "BUCKET_BOUNDS",
]

# Prometheus-style cumulative bucket ladder for the text exposition
# (obs/export.py).  Log-spaced 1-5 decades so one ladder covers the
# repo's units: step/TTFT latencies in ms (1..5e4), wire bytes and
# token counts (up to 5e8).  Finite-bucket counts come from the ring's
# recent window; the evicted mass is attributed to ``+Inf``, whose
# count is the exact all-time ``count`` — monotonicity holds because
# every finite cumulative count <= len(ring) <= count.
BUCKET_BOUNDS = tuple(
    base * (10.0 ** exp) for exp in range(-3, 9) for base in (1.0, 5.0))


def percentile(samples: Sequence[float], q: float) -> Optional[float]:
    """Nearest-rank percentile (q in [0, 100]); None on no samples —
    callers omit the field rather than report a fabricated 0."""
    if not samples:
        return None
    xs = sorted(samples)
    idx = min(len(xs) - 1, max(0, int(round(q / 100.0 * (len(xs) - 1)))))
    return xs[idx]


class Ring:
    """Fixed-size sample ring — THE bounded-memory pattern shared by
    every rolling statistic.  Not itself thread-safe: owners (the
    registry) hold their own lock around mutation and snapshot."""

    __slots__ = ("_samples",)

    def __init__(self, window: int) -> None:
        self._samples: "collections.deque" = collections.deque(
            maxlen=max(1, int(window)))

    def append(self, value: float) -> None:
        self._samples.append(value)

    def values(self) -> List[float]:
        return list(self._samples)

    def mean(self) -> Optional[float]:
        if not self._samples:
            return None
        return sum(self._samples) / len(self._samples)

    def percentile(self, q: float) -> Optional[float]:
        return percentile(list(self._samples), q)

    def __len__(self) -> int:
        return len(self._samples)


class Counter:
    """Monotonic counter series (one label set)."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.RLock) -> None:
        self._lock = lock
        self.value = 0.0        # guarded-by: _lock

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        with self._lock:
            self.value += n


class Gauge:
    """Last-value gauge series (one label set)."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.RLock) -> None:
        self._lock = lock
        self.value: Optional[float] = None   # guarded-by: _lock

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def add(self, n: float) -> None:
        with self._lock:
            self.value = (self.value or 0.0) + float(n)


class Histogram:
    """Ring-backed distribution series: exact ``count``/``sum`` plus
    percentiles over the most recent ``window`` observations."""

    __slots__ = ("_lock", "_ring", "count", "sum")

    def __init__(self, lock: threading.RLock, window: int) -> None:
        self._lock = lock
        self._ring = Ring(window)   # guarded-by: _lock
        self.count = 0              # guarded-by: _lock
        self.sum = 0.0              # guarded-by: _lock

    def observe(self, v: float) -> None:
        with self._lock:
            self.count += 1
            self.sum += float(v)
            self._ring.append(float(v))

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            xs = self._ring.values()
            out: Dict[str, Any] = {"count": self.count, "sum": self.sum}
        for q in (50, 90, 99):
            out[f"p{q}"] = percentile(xs, q)
        out["mean"] = (sum(xs) / len(xs)) if xs else None
        out["buckets"] = self._buckets(xs)
        return out

    @staticmethod
    def _buckets(xs: List[float]) -> List[Tuple[float, int]]:
        """Cumulative ``(le, count)`` pairs over the ring window for the
        finite ``BUCKET_BOUNDS`` ladder (``+Inf`` is the exporter's job:
        its count is the exact all-time ``count``, so the window's
        evicted mass lands there and cumulative monotonicity holds)."""
        sorted_xs = sorted(xs)
        out: List[Tuple[float, int]] = []
        i = 0
        for le in BUCKET_BOUNDS:
            while i < len(sorted_xs) and sorted_xs[i] <= le:
                i += 1
            out.append((le, i))
        return out


_KIND_CLASSES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricFamily:
    """One named metric with labeled series (children).

    ``labels(tier="spmd")`` returns the series for that label set,
    creating it up to the registry's cardinality cap; past the cap all
    new label sets share one ``other="true"`` overflow series so an
    unbounded label value (a tensor name, a request id) cannot grow the
    registry without bound."""

    def __init__(self, name: str, kind: str, help: str, *,
                 lock: threading.RLock, window: int,
                 max_label_sets: int) -> None:
        self.name = name
        self.kind = kind
        self.help = help
        self._lock = lock
        self._window = window
        self._max_label_sets = max_label_sets
        self._children: Dict[Tuple[Tuple[str, str], ...], Any] = {}  # guarded-by: _lock
        self._overflowed = False                                     # guarded-by: _lock

    _OVERFLOW_KEY = (("other", "true"),)

    def _make(self):
        if self.kind == "histogram":
            return Histogram(self._lock, self._window)
        return _KIND_CLASSES[self.kind](self._lock)

    def labels(self, **labelset: Any):
        key = tuple(sorted((str(k), str(v)) for k, v in labelset.items()))
        with self._lock:
            child = self._children.get(key)
            if child is not None:
                return child
            if len(self._children) >= self._max_label_sets:
                if not self._overflowed:
                    self._overflowed = True
                    logging.getLogger(__name__).warning(
                        "metric %s exceeded %d label sets; further series "
                        "collapse into %s=%s", self.name,
                        self._max_label_sets, *self._OVERFLOW_KEY[0])
                child = self._children.get(self._OVERFLOW_KEY)
                if child is None:
                    child = self._children[self._OVERFLOW_KEY] = self._make()
                return child
            child = self._children[key] = self._make()
            return child

    # Label-less convenience: family acts as its own default series.
    def _default(self):
        return self.labels()

    def inc(self, n: float = 1.0) -> None:
        self._default().inc(n)

    def set(self, v: float) -> None:
        self._default().set(v)

    def add(self, n: float) -> None:
        self._default().add(n)

    def observe(self, v: float) -> None:
        self._default().observe(v)

    def series(self) -> List[Dict[str, Any]]:
        """JSON-ready snapshot of every labeled series."""
        with self._lock:
            items = list(self._children.items())
        out = []
        for key, child in items:
            row: Dict[str, Any] = {"labels": dict(key)}
            if self.kind == "histogram":
                row.update(child.summary())
            else:
                row["value"] = child.value
            out.append(row)
        return out


class MetricsRegistry:
    """Thread-safe family registry; one per process by default
    (:func:`registry`).  ``window`` sizes new histograms' rings
    (``HVD_TPU_METRICS_WINDOW``); ``max_label_sets`` caps per-family
    cardinality."""

    def __init__(self, window: int = 1024, max_label_sets: int = 64) -> None:
        self._lock = threading.RLock()
        self.window = int(window)
        self.max_label_sets = int(max_label_sets)
        self._families: Dict[str, MetricFamily] = {}   # guarded-by: _lock

    def _family(self, name: str, kind: str, help: str,
                window: Optional[int] = None) -> MetricFamily:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind:
                    raise ValueError(
                        f"metric {name!r} already registered as {fam.kind}, "
                        f"cannot re-register as {kind}")
                if help and not fam.help:
                    fam.help = help
                return fam
            fam = MetricFamily(
                name, kind, help, lock=self._lock,
                window=window or self.window,
                max_label_sets=self.max_label_sets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "") -> MetricFamily:
        return self._family(name, "counter", help)

    def gauge(self, name: str, help: str = "") -> MetricFamily:
        return self._family(name, "gauge", help)

    def histogram(self, name: str, help: str = "",
                  window: Optional[int] = None) -> MetricFamily:
        return self._family(name, "histogram", help, window=window)

    def collect(self) -> List[Dict[str, Any]]:
        """Sorted, JSON-ready family snapshots — the one iteration
        surface both exporters (Prometheus text and JSON) render from,
        so they can never disagree on content."""
        with self._lock:
            fams = sorted(self._families.values(), key=lambda f: f.name)
        return [{"name": f.name, "kind": f.kind, "help": f.help,
                 "series": f.series()} for f in fams]

    def snapshot(self) -> Dict[str, List[Dict[str, Any]]]:
        """``{name: [series...]}`` — the compact JSON shape embedded in
        bench artifacts and the ``MetricsRequest`` payload."""
        return {f["name"]: f["series"] for f in self.collect()}

    def reset(self) -> None:
        """Drop every family (tests; a live process never resets — an
        elastic re-init keeps counters, like ``faults`` keeps its
        counters, so rates stay meaningful across recoveries)."""
        with self._lock:
            self._families.clear()


_default = MetricsRegistry()

_TRUE = {"1", "true", "yes", "on"}
_enabled: Optional[bool] = None


def registry() -> MetricsRegistry:
    """The process-wide default registry (always usable, even pre-init:
    layers that record before ``hvd.init`` — fault arming, the elastic
    driver — must not lose their counts)."""
    return _default


def enabled() -> bool:
    """The instrumentation gate every hook checks first.  Resolved from
    ``HVD_TPU_METRICS`` lazily (default on) so pre-init layers agree
    with the post-init Config; :func:`configure` (called by
    ``hvd.init``) pins the resolved value."""
    global _enabled
    if _enabled is None:
        raw = os.environ.get("HOROVOD_METRICS") \
            or os.environ.get("HVD_TPU_METRICS")
        _enabled = True if raw is None else raw.strip().lower() in _TRUE
    return _enabled


def configure(enabled: Optional[bool] = None,
              window: Optional[int] = None) -> None:
    """Pin the gate / histogram window from the resolved Config
    (``hvd.init``).  Never clears recorded data — see
    :meth:`MetricsRegistry.reset`."""
    global _enabled
    if enabled is not None:
        _enabled = bool(enabled)
    if window is not None:
        _default.window = max(1, int(window))
