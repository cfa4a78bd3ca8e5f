"""Cross-rank aggregation and straggler detection.

Counterpart of ``horovod_tpu/obs/aggregate.py``.  Per-rank gauges answer
"how is THIS process doing"; operators need the fleet view and, above
all, *which rank is slow*.  Each rank contributes its recent mean step
time (and any other gauges) over :func:`..functions.allgather_object`,
the world reduces to min/max/mean/p99, and ranks whose step time
exceeds ``HVD_TPU_STRAGGLER_FACTOR`` x the world median are flagged: a
warn-once log naming the rank plus a ``hvd_tpu_straggler_suspect`` gauge
(1 on the suspect rank) any scraper can alert on.

The detector itself (:func:`detect_stragglers`) is a pure function of a
per-rank series, so a test drives it with synthetic skew without a
multi-process world.
"""

from __future__ import annotations

import logging
import statistics
from typing import Dict, List, Optional, Sequence

from . import metrics as _m

logger = logging.getLogger(__name__)

__all__ = ["summarize", "detect_stragglers", "cross_rank_summary",
           "check_stragglers"]


def summarize(values: Sequence[float]) -> Dict[str, Optional[float]]:
    """min/max/mean/p99 of one gauge across ranks (empty → all None)."""
    xs = [float(v) for v in values if v is not None]
    if not xs:
        return {"min": None, "max": None, "mean": None, "p99": None}
    return {
        "min": min(xs),
        "max": max(xs),
        "mean": sum(xs) / len(xs),
        "p99": _m.percentile(xs, 99),
    }


def detect_stragglers(per_rank: Sequence[float],
                      factor: float = 2.0) -> List[int]:
    """Ranks whose value exceeds ``factor`` x the world median.

    Pure and deterministic — every rank computes the identical verdict
    from the identical gathered trace.  A non-positive median (idle or
    clock-skewed world) flags nobody: skew is only meaningful against
    real work.  ``factor`` must be > 1 (enforced at config parse); at
    exactly the threshold a rank is NOT flagged, so a perfectly uniform
    world never alarms."""
    xs = [float(v) for v in per_rank]
    if len(xs) < 2:
        return []
    med = statistics.median(xs)
    if med <= 0.0:
        return []
    return [i for i, v in enumerate(xs) if v > factor * med]


def _local_step_time_mean() -> Optional[float]:
    """This rank's recent mean step time from the live registry's ring
    (None before the first instrumented step)."""
    snap = _m.registry().snapshot().get("hvd_tpu_step_time_seconds", [])
    means = [row.get("mean") for row in snap if row.get("mean") is not None]
    if not means:
        return None
    return sum(means) / len(means)


_warned_stragglers: set = set()


def check_stragglers(per_rank: Sequence[float], *,
                     factor: Optional[float] = None,
                     my_rank: Optional[int] = None) -> List[int]:
    """Run the detector over a gathered per-rank trace and publish the
    verdict: ``hvd_tpu_straggler_suspect`` (1 on flagged ranks, 0
    elsewhere), ``hvd_tpu_step_time_skew`` (this rank's value / world
    median) and a warn-once log per newly-flagged rank set."""
    from .. import basics

    if factor is None:
        factor = (basics.config().straggler_factor
                  if basics.is_initialized() else 2.0)
    if my_rank is None:
        my_rank = basics.rank() if basics.is_initialized() else 0
    flagged = detect_stragglers(per_rank, factor)
    if _m.enabled():
        reg = _m.registry()
        reg.gauge("hvd_tpu_straggler_suspect",
                  "1 when this rank's step time exceeds "
                  "HVD_TPU_STRAGGLER_FACTOR x the world median").set(
                      1.0 if my_rank in flagged else 0.0)
        xs = [float(v) for v in per_rank]
        if xs and 0 <= my_rank < len(xs):
            med = statistics.median(xs)
            if med > 0:
                reg.gauge("hvd_tpu_step_time_skew",
                          "this rank's step time / world median").set(
                              xs[my_rank] / med)
    key = tuple(flagged)
    if flagged and key not in _warned_stragglers:
        _warned_stragglers.add(key)
        logger.warning(
            "straggler suspect(s): rank(s) %s exceed %.2fx the world "
            "median step time (per-rank means: %s)", flagged, factor,
            ["%.4f" % float(v) for v in per_rank])
    return flagged


def cross_rank_summary(extra_gauges: Optional[Dict[str, float]] = None, *,
                       factor: Optional[float] = None) -> Dict[str, Dict]:
    """Collective: gather per-rank telemetry over
    :func:`..functions.allgather_object` and reduce to fleet statistics.
    Every rank must call it; every rank returns the identical summary.

    Gathers each rank's mean step time plus any caller-provided scalar
    gauges; returns ``{name: {min,max,mean,p99,per_rank}}`` and runs
    straggler detection on the step-time trace (publishing the
    ``straggler_suspect`` verdict on each rank for its own index)."""
    from ..functions import allgather_object

    local: Dict[str, Optional[float]] = {
        "step_time_s": _local_step_time_mean(),
    }
    if extra_gauges:
        local.update({str(k): (None if v is None else float(v))
                      for k, v in extra_gauges.items()})
    gathered: List[Dict[str, Optional[float]]] = allgather_object(
        local, name="obs_cross_rank")
    out: Dict[str, Dict] = {}
    for name in sorted({k for d in gathered for k in d}):
        per_rank = [d.get(name) for d in gathered]
        row = summarize(per_rank)
        row["per_rank"] = per_rank
        out[name] = row
    step_times = [d.get("step_time_s") for d in gathered]
    if all(v is not None for v in step_times) and step_times:
        out["step_time_s"]["stragglers"] = check_stragglers(
            [float(v) for v in step_times], factor=factor)
    return out
