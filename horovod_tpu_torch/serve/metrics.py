"""Serving observability: TTFT/TPOT/occupancy accounting.

Counterpart of ``horovod_tpu/serve/metrics.py``,
line for line: host-side bookkeeping with no model in it, so the
port keeps its own copy.

The two latencies that define an LLM serving SLO are time-to-first-token
(TTFT: admission + prefill) and time-per-output-token (TPOT: decode
cadence under continuous batching).  Both are recorded per request by
the batcher and aggregated here into percentile snapshots with the same
JSON-friendly shape the reference's serving bench emits.

Bounded memory: samples live in fixed-size rings — a serving process
that handles millions of requests must not grow its stats linearly.
The ring and percentile primitives live in :mod:`..obs.metrics` (the
unified telemetry layer); this module keeps the serving-specific
snapshot shape (``percentile`` stays importable from here).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from ..obs.metrics import Ring, percentile  # noqa: F401 (re-export)

# Bounded per-tenant rollup: the same discipline as the obs registry's
# 64-series cap — a serving process must not grow stats with the tenant
# population; the overflow bucket absorbs the tail.
_MAX_TENANTS = 64
_OVERFLOW_TENANT = "other"


class _ClassStats:
    """Per-QoS-class latency/goodput rollup (caller holds the stats
    lock — single-owner helper, the ``_locked`` contract)."""

    __slots__ = ("ttft_s", "tpot_s", "completed", "expired", "failed",
                 "tokens_out")

    def __init__(self, window: int) -> None:
        self.ttft_s = Ring(window)
        self.tpot_s = Ring(window)
        self.completed = 0
        self.expired = 0
        self.failed = 0
        self.tokens_out = 0


class ServingStats:
    """Thread-safe rolling serving metrics (one instance per batcher).

    ``record_request`` is called once per *finished* request;
    ``record_step`` once per batcher scheduling step (occupancy is a
    per-step sample, weighting busy and idle periods equally —
    the signal that says "add replicas" vs "shrink the fleet").
    """

    def __init__(self, window: int = 4096,
                 weights_version: int = 0) -> None:
        self._lock = threading.Lock()
        self._ttft_s = Ring(window)       # guarded-by: _lock
        self._tpot_s = Ring(window)       # guarded-by: _lock
        self._occupancy = Ring(window)    # guarded-by: _lock
        self._queue_depth = Ring(window)  # guarded-by: _lock
        self.completed = 0                # guarded-by: _lock
        self.rejected = 0                 # guarded-by: _lock
        self.expired = 0                  # guarded-by: _lock
        self.failed = 0                   # guarded-by: _lock
        self.tokens_out = 0               # guarded-by: _lock
        self.prefix_hits = 0              # guarded-by: _lock
        self.prefix_misses = 0            # guarded-by: _lock
        # Weight hot-swap (serve/swap.py): the checkpoint step the
        # replica's weights came from (seeded from the engine at
        # batcher construction, advanced only by flips — ONE consistent
        # path, never shadow-overwritten) and how many flips it
        # survived.
        self.weights_version = int(weights_version)  # guarded-by: _lock
        self.swaps_completed = 0          # guarded-by: _lock
        # Multi-tenant QoS rollups (serve/qos/; docs/qos.md): per-class
        # latency/goodput, bounded per-tenant token accounting, and the
        # preemption/shed/budget counters the SLO dashboards read.
        self._window = window
        self._classes: Dict[str, _ClassStats] = {}  # guarded-by: _lock
        self._tenants: Dict[str, Dict] = {}         # guarded-by: _lock
        self.preemptions = 0              # guarded-by: _lock
        self.budget_rejects = 0           # guarded-by: _lock
        self._t0 = time.monotonic()

    def _class_locked(self, qos_class: Optional[str]) -> _ClassStats:
        cls = qos_class or "standard"
        st = self._classes.get(cls)
        if st is None:
            st = self._classes[cls] = _ClassStats(self._window)  # hvdlint: disable=unguarded-mutation -- _locked suffix contract: every caller holds _lock
        return st

    def _tenant_locked(self, tenant: Optional[str]) -> Dict:
        name = tenant or "default"
        row = self._tenants.get(name)
        if row is None:
            if len(self._tenants) >= _MAX_TENANTS:
                name = _OVERFLOW_TENANT   # bounded: the tail collapses
                row = self._tenants.get(name)
            if row is None:
                row = self._tenants[name] = {"completed": 0,  # hvdlint: disable=unguarded-mutation -- _locked suffix contract: every caller holds _lock
                                             "tokens_out": 0,
                                             "rejected": 0}
        return row

    def record_request(self, ttft_s: float, n_tokens: int,
                       total_s: float, qos_class: Optional[str] = None,
                       tenant: Optional[str] = None) -> None:
        with self._lock:
            self.completed += 1
            self.tokens_out += n_tokens
            self._ttft_s.append(ttft_s)
            tpot = None
            if n_tokens > 1 and total_s > ttft_s:
                # TPOT is the inter-token cadence after the first token.
                tpot = (total_s - ttft_s) / (n_tokens - 1)
                self._tpot_s.append(tpot)
            cls = self._class_locked(qos_class)
            cls.completed += 1
            cls.tokens_out += n_tokens
            cls.ttft_s.append(ttft_s)
            if tpot is not None:
                cls.tpot_s.append(tpot)
            trow = self._tenant_locked(tenant)
            trow["completed"] += 1
            trow["tokens_out"] += n_tokens

    def tpot_estimate_s(self) -> Optional[float]:
        """Mean observed decode cadence (the preemption wait
        estimator's input); None before any multi-token completion."""
        with self._lock:
            vals = self._tpot_s.values()
            return sum(vals) / len(vals) if vals else None

    def record_preempted(self) -> None:
        """One batch generation evicted-and-requeued for an
        interactive deadline (serve/qos/preempt.py)."""
        with self._lock:
            self.preemptions += 1

    def record_budget_rejected(self, tenant: Optional[str] = None) -> None:
        """One admission rejected by a tenant's token budget."""
        with self._lock:
            self.budget_rejects += 1
            self._tenant_locked(tenant)["rejected"] += 1

    def record_step(self, active: int, slots: int, queued: int) -> None:
        with self._lock:
            self._occupancy.append(active / max(1, slots))
            self._queue_depth.append(queued)

    def record_prefix(self, hit: bool) -> None:
        """One prefill binding: did the prompt's prefix hit resident KV
        blocks (serve/kv/)?  Ratio lands in the snapshot — the signal
        that says the fleet's routing keeps prefixes warm."""
        with self._lock:
            if hit:
                self.prefix_hits += 1
            else:
                self.prefix_misses += 1

    def set_weights_version(self, version: int) -> None:
        """One completed hot-swap flip: the replica now serves
        ``version`` (the checkpoint step)."""
        with self._lock:
            self.weights_version = int(version)
            self.swaps_completed += 1

    def record_rejected(self) -> None:
        with self._lock:
            self.rejected += 1

    def record_expired(self, qos_class: Optional[str] = None) -> None:
        with self._lock:
            self.expired += 1
            self._class_locked(qos_class).expired += 1

    def record_failed(self, qos_class: Optional[str] = None) -> None:
        with self._lock:
            self.failed += 1
            self._class_locked(qos_class).failed += 1

    def snapshot(self) -> Dict:
        """One JSON-ready dict — the serving bench summary fields and
        the ``StatsRequest`` wire payload share this shape."""
        with self._lock:
            ttft = self._ttft_s.values()
            tpot = self._tpot_s.values()
            occ = self._occupancy.values()
            queued = self._queue_depth.values()
            elapsed = max(1e-9, time.monotonic() - self._t0)
            bound = self.prefix_hits + self.prefix_misses
            out = {
                "requests_completed": self.completed,
                "requests_rejected": self.rejected,
                "requests_expired": self.expired,
                "requests_failed": self.failed,
                "weights_version": self.weights_version,
                "swaps_completed": self.swaps_completed,
                "tokens_out": self.tokens_out,
                "tok_per_s": round(self.tokens_out / elapsed, 3),
                "prefix_hits": self.prefix_hits,
                "prefix_hit_ratio": (round(self.prefix_hits / bound, 4)
                                     if bound else None),
                "occupancy_mean": (round(sum(occ) / len(occ), 4)
                                   if occ else None),
                "queue_depth_mean": (round(sum(queued) / len(queued), 2)
                                     if queued else None),
            }
            for name, samples in (("ttft_ms", ttft), ("tpot_ms", tpot)):
                for q in (50, 99):
                    v = percentile(samples, q)
                    out[f"{name}_p{q}"] = (round(v * 1e3, 3)
                                           if v is not None else None)
            # Multi-tenant QoS block (serve/qos/): per-class latency
            # percentiles + goodput (successfully delivered tokens/s),
            # the bounded per-tenant rollup, and the policy counters.
            # Sheds are deliberately ABSENT here: shedding happens at
            # the ROUTER tier (brownout gate) before a replica ever
            # sees the request — the counters live on the obs registry
            # (hvd_tpu_qos_sheds_total) and the gate's snapshot, and a
            # structurally-zero per-replica shed field would only
            # mislead operators during an active brownout.
            qos: Dict[str, Dict] = {}
            for cls, st in sorted(self._classes.items()):
                row: Dict = {
                    "completed": st.completed, "expired": st.expired,
                    "failed": st.failed,
                    "tokens_out": st.tokens_out,
                    "goodput_tok_per_s": round(st.tokens_out / elapsed, 3),
                }
                for name, ring in (("ttft_ms", st.ttft_s),
                                   ("tpot_ms", st.tpot_s)):
                    vals = ring.values()
                    for q in (50, 99):
                        v = percentile(vals, q)
                        row[f"{name}_p{q}"] = (round(v * 1e3, 3)
                                               if v is not None else None)
                qos[cls] = row
            out["qos"] = qos
            out["tenants"] = {t: dict(r)
                              for t, r in sorted(self._tenants.items())}
            out["preemptions"] = self.preemptions
            out["budget_rejects"] = self.budget_rejects
            return out
