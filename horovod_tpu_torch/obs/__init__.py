"""Training telemetry (``horovod_tpu_torch.obs``).

Counterpart of ``horovod_tpu/obs/``'s core: one process-wide registry
every layer records into, one export surface every operator scrapes
from, with the reference's metric, span and label names letter for
letter (``docs/metrics.md`` and ``docs/tracing.md`` describe both
packages):

* :mod:`.metrics` — thread-safe Counter/Gauge/Histogram registry
  (bounded rings, bounded label cardinality).
* :mod:`.instrument` — the hooks wired into the train step, fusion
  planner, collectives dispatch, topology schedule, mesh plan and
  autotuner (and those of the layers still to port).
* :mod:`.aggregate` — cross-rank min/max/mean/p99 over
  ``functions.allgather_object`` plus straggler detection
  (``HVD_TPU_STRAGGLER_FACTOR``).
* :mod:`.export` — Prometheus text exposition + JSON snapshot, served on
  the local scrape port ``HVD_TPU_METRICS_PORT`` (+ the rank).
* :mod:`.trace` — W3C-style span contexts rooted per train step, the
  bounded span ring, clock-offset estimation, merge and critical path.
* :mod:`.flight` — crash flight recorder: a bounded event ring dumped
  rank-tagged with the span ring.

Knobs (read at ``hvd.init``): ``HVD_TPU_METRICS`` (default on),
``HVD_TPU_METRICS_PORT``, ``HVD_TPU_METRICS_WINDOW``,
``HVD_TPU_STRAGGLER_FACTOR``, ``HVD_TPU_TRACE``, ``HVD_TPU_TRACE_RING``,
``HVD_TPU_FLIGHT``, ``HVD_TPU_FLIGHT_DIR``, ``HVD_TPU_FLIGHT_RING``.
The fleet telemetry plane (``timeseries``, ``collector``, ``slo``,
``detect``) comes with the serving stack.
"""

from . import aggregate, export, flight, instrument, metrics, trace  # noqa: F401

__all__ = ["aggregate", "export", "flight", "instrument", "metrics", "trace"]
