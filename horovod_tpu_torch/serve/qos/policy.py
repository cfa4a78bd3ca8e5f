"""QoS classes, per-tenant token-bucket budgets, typed rejections.

Counterpart of ``horovod_tpu/serve/qos/policy.py``,
line for line: host-side bookkeeping with no model in it, so the
port keeps its own copy.

The policy layer of the SLO-aware multi-tenant scheduler
(docs/qos.md): three service classes —

* ``interactive`` — deadline-protected traffic.  Never shed by the
  brownout ladder; may preempt batch generations to make its deadline.
* ``standard`` — the default class.  Shed only at the deepest brownout
  level, after batch.
* ``batch`` — throughput traffic.  First to be preempted and first to
  be shed; its requests are the ones that absorb overload.

Each ``(tenant, class)`` pair is one *flow* of the weighted-fair
scheduler (``sched.py``); a flow's weight is ``class weight × tenant
share`` (``HVD_TPU_QOS_CLASS_WEIGHTS`` / ``HVD_TPU_QOS_TENANT_SHARES``).

**Token-bucket budgets** bound each tenant's token throughput (prompt
plus generated tokens, ``HVD_TPU_QOS_TENANT_BUDGETS`` tokens/second
with ``rate × HVD_TPU_QOS_BURST_S`` of burst capacity).  A request is
charged ``len(prompt) + max_new_tokens`` at admission — the
*reservation*, since the generation cap is what it may consume — and
the unused remainder is refunded at completion.  An exhausted bucket
raises :class:`BudgetExhaustedError`, a **typed retriable rejection**
carrying ``retry_after_s`` (when the bucket will cover the request)
so a well-behaved client backs off instead of hammering; the
alternative — queueing the over-budget request — would let one tenant
convert its excess into everyone's latency.

Shedding (:class:`RequestShedError`) is the brownout ladder's typed
rejection (``brownout.py``); it lives here so the wire layer imports
one error taxonomy.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from ...config import QOS_CLASSES, parse_qos_map

DEFAULT_CLASS = "standard"
# Built-in WFQ weights, overridden per class by the config grammar.
_DEFAULT_WEIGHTS = {"interactive": 8.0, "standard": 4.0, "batch": 1.0}


class QosError(RuntimeError):
    """Base of the QoS rejection taxonomy (typed, retriable)."""

    retry_after_s: float = 0.0


class BudgetExhaustedError(QosError):
    """The tenant's token bucket cannot cover this request.  Retriable
    by the CLIENT after ``retry_after_s`` — never by the router on
    another replica (the budget is policy, not replica health)."""

    def __init__(self, tenant: str, need: float, retry_after_s: float):
        super().__init__(
            f"tenant {tenant!r} over its token budget ({need:.0f} tokens "
            f"needed); retry after {retry_after_s:.2f}s")
        self.tenant = tenant
        self.retry_after_s = retry_after_s


class RequestShedError(QosError):
    """Brownout shed: the fleet is overloaded and this request's class
    is being dropped to protect higher classes (batch first, then
    standard, never interactive).  Retriable after ``retry_after_s`` —
    a typed answer, not a timeout, so the client learns *why* and
    *when*, and the shed costs the fleet nothing."""

    def __init__(self, qos_class: str, level: int, retry_after_s: float):
        super().__init__(
            f"brownout level {level}: shedding {qos_class!r} traffic; "
            f"retry after {retry_after_s:.2f}s")
        self.qos_class = qos_class
        self.level = level
        self.retry_after_s = retry_after_s


def validate_class(qos_class: Optional[str]) -> str:
    cls = (qos_class or DEFAULT_CLASS).lower()
    if cls not in QOS_CLASSES:
        raise ValueError(f"unknown QoS class {cls!r}; expected one of "
                         f"{QOS_CLASSES}")
    return cls


class TokenBucket:
    """One tenant's refilling token budget; caller holds the policy
    lock (single-owner helper, the ``_locked`` contract)."""

    def __init__(self, rate_per_s: float, burst_s: float) -> None:
        self.rate = float(rate_per_s)
        self.capacity = max(1.0, self.rate * float(burst_s))
        self.tokens = self.capacity
        self._last = time.monotonic()

    def _refill_locked(self, now: float) -> None:
        self.tokens = min(self.capacity,
                          self.tokens + (now - self._last) * self.rate)
        self._last = now

    def take_locked(self, n: float, now: float) -> Optional[float]:
        """Charge ``n`` tokens; returns None on success, else the
        seconds until the bucket would cover ``n``."""
        self._refill_locked(now)
        if self.tokens >= n:
            self.tokens -= n
            return None
        deficit = min(n, self.capacity) - self.tokens
        return deficit / self.rate if self.rate > 0 else float("inf")

    def refund_locked(self, n: float) -> None:
        self.tokens = min(self.capacity, self.tokens + max(0.0, n))


class QosPolicy:
    """Resolved QoS policy for one admission tier (a batcher, or the
    router's gate): flow weights + per-tenant budgets.  Thread-safe —
    charges arrive from every RPC handler thread at once."""

    def __init__(self, *,
                 class_weights: Optional[Dict[str, float]] = None,
                 tenant_shares: Optional[Dict[str, float]] = None,
                 tenant_budgets: Optional[Dict[str, float]] = None,
                 default_budget: float = 0.0,
                 burst_s: float = 2.0) -> None:
        weights = dict(_DEFAULT_WEIGHTS)
        weights.update(class_weights or {})
        self.class_weights = weights
        self.tenant_shares = dict(tenant_shares or {})
        self.burst_s = float(burst_s)
        self.default_budget = float(default_budget)
        self._budget_rates = dict(tenant_budgets or {})
        self._lock = threading.Lock()
        self._buckets: Dict[str, TokenBucket] = {}  # guarded-by: _lock

    @classmethod
    def from_config(cls, cfg) -> "QosPolicy":
        """Build from the ``HVD_TPU_QOS_*`` knobs (grammar already
        validated at init by config.py)."""
        return cls(
            class_weights=parse_qos_map(cfg.qos_class_weights,
                                        "qos class weights", QOS_CLASSES),
            tenant_shares=(parse_qos_map(cfg.qos_tenant_shares,
                                         "qos tenant shares",
                                         positive=True)
                           if cfg.qos_tenant_shares else None),
            tenant_budgets=(parse_qos_map(cfg.qos_tenant_budgets,
                                          "qos tenant budgets")
                            if cfg.qos_tenant_budgets else None),
            default_budget=cfg.qos_default_budget,
            burst_s=cfg.qos_burst_s)

    def weight(self, tenant: str, qos_class: str) -> float:
        """One flow's WFQ weight: class weight × tenant share."""
        return (self.class_weights.get(qos_class,
                                       _DEFAULT_WEIGHTS[DEFAULT_CLASS])
                * self.tenant_shares.get(tenant, 1.0))

    def _bucket_locked(self, tenant: str) -> Optional[TokenBucket]:
        bucket = self._buckets.get(tenant)
        if bucket is None:
            rate = self._budget_rates.get(tenant, self.default_budget)
            if rate <= 0:
                return None   # unlimited tenant: no bucket at all
            bucket = TokenBucket(rate, self.burst_s)
            self._buckets[tenant] = bucket  # hvdlint: disable=unguarded-mutation -- _locked suffix contract: every caller holds _lock
        return bucket

    def charge(self, tenant: str, n_tokens: float) -> float:
        """Charge ``n_tokens`` against ``tenant``'s budget; returns the
        amount charged (0 for unlimited tenants) or raises
        :class:`BudgetExhaustedError` with the retry hint."""
        with self._lock:
            bucket = self._bucket_locked(tenant)
            if bucket is None:
                return 0.0
            retry = bucket.take_locked(float(n_tokens), time.monotonic())
        if retry is not None:
            raise BudgetExhaustedError(tenant, n_tokens, retry)
        return float(n_tokens)

    def refund(self, tenant: str, n_tokens: float) -> None:
        """Return unused reservation (completed request emitted fewer
        tokens than its cap)."""
        if n_tokens <= 0:
            return
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is not None:
                bucket.refund_locked(float(n_tokens))

    def limited_tenants(self) -> Dict[str, float]:
        """Configured rate per budget-limited tenant (stats surface)."""
        out = dict(self._budget_rates)
        return {t: r for t, r in out.items() if r > 0}
