"""Bounded in-memory ring TSDB: the telemetry plane's working set.

Counterpart of ``horovod_tpu/obs/timeseries.py`` (host Python, no device
work), under the reference's names.

The fleet collector (:mod:`~.collector`) lands one sample
per replica per signal per round; SLO burn-rate evaluation
(:mod:`~.slo`) and the online invariant detectors
(:mod:`~.detect`) query windows of that history.  A real
TSDB is the wrong dependency for a control plane that must keep working
while the rest of the fleet burns, so this is the smallest thing that
answers their queries:

* a **series** is ``(name, sorted label tuple) -> deque[(t, value)]``,
  bounded to the newest ``points`` samples (``HVD_TPU_COLLECT_WINDOW``)
  — memory is O(series x points) forever, same discipline as
  :class:`~.metrics.Ring`;
* **series cardinality is capped** (a 1000-replica fleet at ~8 signals
  each is ~8k series; past ``max_series`` new series are dropped and
  counted, never grown — the TSDB must not become the leak it exists
  to find);
* queries are **windowed**: :meth:`latest`, :meth:`window`,
  :meth:`rate` (counter delta over a window, reset-aware) and
  :meth:`quantile` (nearest-rank over a window, reusing
  :func:`~.metrics.percentile`);
* **time is injected** — every write carries an explicit timestamp from
  the owner's clock, so the same TSDB runs under
  ``serve/fleet/sim.py``'s virtual clock and wall time unchanged.

One lock serializes everything: writers are the collector's scrape
threads, readers are the SLO/detector evaluation and ``fleet_top``;
each operation is a few dict/deque ops, never on a device-blocking
path.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional, Tuple

from .metrics import percentile

__all__ = ["RingTSDB"]

LabelSet = Tuple[Tuple[str, str], ...]


def _key(name: str, labels: Optional[Dict[str, str]]) -> Tuple[str, LabelSet]:
    if not labels:
        return name, ()
    return name, tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class RingTSDB:
    """Bounded multi-series ring of ``(t, value)`` samples.

    ``points`` bounds each series' history; ``max_series`` bounds the
    series count (drops past the cap are counted in
    :attr:`dropped_series`, warn-once — the overflow contract of
    :class:`~.metrics.MetricFamily`, minus the merged
    overflow series: a merged *time* series would interleave unrelated
    replicas' samples and poison every windowed query).
    """

    def __init__(self, points: int = 512, max_series: int = 16384) -> None:
        self.points = max(1, int(points))
        self.max_series = max(1, int(max_series))
        self._lock = threading.RLock()
        self._series: Dict[Tuple[str, LabelSet], "collections.deque"] = {}  # guarded-by: _lock
        self.dropped_series = 0        # guarded-by: _lock
        self._overflow_warned = False  # guarded-by: _lock

    # --- write ---------------------------------------------------------------

    def record(self, name: str, value: float, t: float,
               labels: Optional[Dict[str, str]] = None) -> None:
        """Append one sample at time ``t`` (the owner's clock — wall or
        virtual).  Non-numeric values are the caller's bug; ``None`` is
        skipped (an absent stat is absent, not zero)."""
        if value is None:
            return
        key = _key(name, labels)
        with self._lock:
            ring = self._series.get(key)
            if ring is None:
                if len(self._series) >= self.max_series:
                    self.dropped_series += 1
                    if not self._overflow_warned:
                        self._overflow_warned = True
                        from ..utils.logging import get_logger

                        get_logger(__name__).warning(
                            "tsdb exceeded %d series; new series are "
                            "dropped (first: %s%s)", self.max_series,
                            name, dict(key[1]))
                    return
                ring = self._series[key] = collections.deque(
                    maxlen=self.points)
            ring.append((float(t), float(value)))

    def forget(self, labels: Dict[str, str]) -> int:
        """Drop every series whose labels include ``labels`` (a scaled-in
        replica's history has no future readers).  Returns the count."""
        want = set(_key("", labels)[1])
        with self._lock:
            doomed = [k for k in self._series if want <= set(k[1])]
            for k in doomed:
                del self._series[k]
        return len(doomed)

    # --- read ----------------------------------------------------------------

    def latest(self, name: str, labels: Optional[Dict[str, str]] = None
               ) -> Optional[Tuple[float, float]]:
        """Newest ``(t, value)`` of the series, or None."""
        with self._lock:
            ring = self._series.get(_key(name, labels))
            if not ring:
                return None
            return ring[-1]

    def window(self, name: str, since: float,
               labels: Optional[Dict[str, str]] = None
               ) -> List[Tuple[float, float]]:
        """Samples with ``t >= since``, oldest first."""
        with self._lock:
            ring = self._series.get(_key(name, labels))
            if not ring:
                return []
            return [(t, v) for t, v in ring if t >= since]

    def rate(self, name: str, since: float,
             labels: Optional[Dict[str, str]] = None) -> Optional[float]:
        """Counter increase per second over the window — reset-aware:
        a drop between consecutive samples (replica restart zeroed the
        counter) contributes the post-reset absolute value, the
        Prometheus ``rate()`` convention.  None without >= 2 samples
        (one point has no rate; fabricating 0 would mask a dead
        series)."""
        pts = self.window(name, since, labels)
        if len(pts) < 2:
            return None
        span = pts[-1][0] - pts[0][0]
        if span <= 0:
            return None
        total = 0.0
        for (_, prev), (_, cur) in zip(pts, pts[1:]):
            total += (cur - prev) if cur >= prev else cur
        return total / span

    def delta(self, name: str, since: float,
              labels: Optional[Dict[str, str]] = None) -> Optional[float]:
        """Reset-aware counter increase over the window (the numerator
        of :meth:`rate` — detectors compare increases, not rates, when
        the round cadence is the natural unit)."""
        pts = self.window(name, since, labels)
        if len(pts) < 2:
            return None
        total = 0.0
        for (_, prev), (_, cur) in zip(pts, pts[1:]):
            total += (cur - prev) if cur >= prev else cur
        return total

    def quantile(self, name: str, q: float, since: float,
                 labels: Optional[Dict[str, str]] = None
                 ) -> Optional[float]:
        """Nearest-rank percentile (q in [0, 100]) of the windowed
        values; None on an empty window."""
        pts = self.window(name, since, labels)
        return percentile([v for _, v in pts], q)

    def labelsets(self, name: str) -> List[Dict[str, str]]:
        """Every label set recorded under ``name`` — how detectors fan
        out over per-replica series without knowing the fleet roster."""
        with self._lock:
            return [dict(ls) for (n, ls) in self._series if n == name]

    def series_count(self) -> int:
        with self._lock:
            return len(self._series)
