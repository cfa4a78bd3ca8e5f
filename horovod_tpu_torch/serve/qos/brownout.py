"""Graceful brownout: class-ordered shedding with hysteresis.

Counterpart of ``horovod_tpu/serve/qos/brownout.py``,
line for line: host-side bookkeeping with no model in it, so the
port keeps its own copy.

The router-tier overload valve (docs/qos.md).  Driven by the SAME
signals the fleet controller reads — mean queue depth and interactive
p99 TTFT from the replicas' stats snapshots — a
:class:`BrownoutController` walks a shed ladder:

====== ==========================================
level  shedding
====== ==========================================
0      nothing (normal service)
1      ``batch`` requests answered with a typed
       retriable rejection
2      ``batch`` + ``standard`` shed
====== ==========================================

``interactive`` is **never** shed: the ladder tops out one class short
by construction, so overload degrades throughput traffic first and
latency-SLO traffic last — the opposite of what an unprioritized queue
does (interactive drowns in batch arrivals and times out).

**Hysteresis** (the no-oscillation property the tests pin): the ladder
steps UP the moment the overload signal crosses
``HVD_TPU_QOS_BROWNOUT_HIGH`` (shedding late costs SLOs), but steps
DOWN one level at a time, each step only after the signal has stayed
below ``HVD_TPU_QOS_BROWNOUT_LOW`` for ``HVD_TPU_QOS_BROWNOUT_HOLD_S``
straight — the band between LOW and HIGH holds the current level, so a
load level that hovers at the threshold cannot flap shed/un-shed every
control round (which would turn the batch tier into a strobe light).

A shed answers with :class:`~.policy.RequestShedError` — typed and retriable (``retry_after_s`` = the hold
window) rather than a timeout: the client learns why and when, and the
shed request costs the fleet zero slots.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from ...obs import instrument as _obs
from ...utils.logging import get_logger
from .policy import BudgetExhaustedError, QosPolicy, RequestShedError

logger = get_logger(__name__)

# Shed order: batch first, then standard.  Interactive is absent by
# construction — the ladder cannot reach it.
SHED_ORDER = ("batch", "standard")
MAX_LEVEL = len(SHED_ORDER)


class BrownoutController:
    """The shed ladder for one router (thread-safe: observed by the
    control loop, consulted by every request thread)."""

    def __init__(self, *, queue_capacity: int,
                 high: float = 0.75, low: float = 0.25,
                 hold_s: float = 5.0, slo_ttft_ms: float = 0.0,
                 clock=None) -> None:
        if not 0.0 <= low < high:
            raise ValueError(
                f"brownout thresholds need 0 <= low < high, got "
                f"low={low} high={high}")
        self.queue_capacity = max(1, int(queue_capacity))
        self.high = float(high)
        self.low = float(low)
        self.hold_s = float(hold_s)
        self.slo_ttft_ms = float(slo_ttft_ms)
        # Injectable monotonic clock for the hold/hysteresis timers —
        # a simulator can run the ladder under virtual
        # time; default is the real clock.
        self._clock = clock if clock is not None else time.monotonic
        self._lock = threading.Lock()
        self._level = 0                    # guarded-by: _lock
        self._calm_since: Optional[float] = None  # guarded-by: _lock

    @classmethod
    def from_config(cls, cfg) -> "BrownoutController":
        """Build from the ``HVD_TPU_QOS_BROWNOUT_*`` /
        ``HVD_TPU_QOS_SLO_TTFT_MS`` knobs; the queue capacity the
        thresholds are fractions of is the serving admission bound
        (``HVD_TPU_SERVE_QUEUE_DEPTH``)."""
        return cls(queue_capacity=cfg.serve_queue_depth,
                   high=cfg.qos_brownout_high,
                   low=cfg.qos_brownout_low,
                   hold_s=cfg.qos_brownout_hold_s,
                   slo_ttft_ms=cfg.qos_slo_ttft_ms)

    @property
    def level(self) -> int:
        with self._lock:
            return self._level

    def observe(self, queue_depth_mean: float,
                interactive_ttft_p99_ms: Optional[float] = None,
                now: Optional[float] = None) -> int:
        """Feed one control-round's signals; returns the (possibly
        stepped) level.  ``now`` is injectable for deterministic
        hysteresis tests."""
        now = self._clock() if now is None else now
        frac = queue_depth_mean / self.queue_capacity
        slo_breached = (self.slo_ttft_ms > 0
                        and interactive_ttft_p99_ms is not None
                        and interactive_ttft_p99_ms > self.slo_ttft_ms)
        overload = frac > self.high or slo_breached
        calm = frac < self.low and not slo_breached
        with self._lock:
            old = self._level
            if overload:
                self._level = min(self._level + 1, MAX_LEVEL)
                self._calm_since = None
            elif calm and self._level > 0:
                if self._calm_since is None:
                    self._calm_since = now
                elif now - self._calm_since >= self.hold_s:
                    self._level -= 1
                    # Each un-brown step earns its own full hold: a
                    # straight drop 2 -> 0 would re-admit the whole
                    # backlog at once and re-trigger the overload.
                    self._calm_since = now
            else:
                # The hysteresis band (or still loaded): hold level AND
                # restart the calm clock — un-browning needs hold_s of
                # uninterrupted calm, not hold_s total.
                self._calm_since = None
            level = self._level
        if level != old:
            logger.warning("brownout level %d -> %d (queue %.2f of "
                           "capacity%s)", old, level, frac,
                           ", interactive SLO breached" if slo_breached
                           else "")
        _obs.on_qos_brownout_level(level)
        return level

    def check(self, qos_class: str) -> None:
        """Raise :class:`RequestShedError` when ``qos_class`` is shed
        at the current level."""
        with self._lock:
            level = self._level
        if level <= 0 or qos_class not in SHED_ORDER:
            return
        if SHED_ORDER.index(qos_class) < level:
            _obs.on_qos_shed(qos_class)
            raise RequestShedError(qos_class, level,
                                   retry_after_s=self.hold_s)


class QosGate:
    """Router-level admission: per-tenant rate limits + brownout.

    Attached via ``Router.attach_qos``; ``admit`` runs before any
    replica is touched, so a shed or over-budget request costs the
    fleet nothing.  ``policy`` is optional — a gate may be
    brownout-only (budgets enforced at the batcher tier instead;
    enabling both tiers with the same budget map double-charges, see
    docs/qos.md's recipes)."""

    def __init__(self, *, brownout: Optional[BrownoutController] = None,
                 policy: Optional[QosPolicy] = None) -> None:
        self.brownout = brownout
        self.policy = policy

    @classmethod
    def from_config(cls, cfg, *,
                    policy: Optional[QosPolicy] = None) -> "QosGate":
        """The standard router-tier wiring: a brownout ladder from the
        ``HVD_TPU_QOS_*`` knobs, budgets only when explicitly handed a
        policy (batcher-tier budgets are the default — see
        docs/qos.md)."""
        return cls(brownout=BrownoutController.from_config(cfg),
                   policy=policy)

    def admit(self, tenant: str, qos_class: str,
              n_tokens: float = 0.0) -> float:
        """Shed check then budget charge; returns the tokens charged
        (refund the unused part via :meth:`refund` after completion).
        Raises :class:`RequestShedError` / :class:`BudgetExhaustedError`
        — both typed and retriable by the CLIENT."""
        from ... import faults as faults_mod

        if self.brownout is not None:
            self.brownout.check(qos_class)
        if self.policy is None or n_tokens <= 0:
            return 0.0
        if faults_mod._active is not None and faults_mod.on_qos_admit():
            return 0.0   # injected flood: this tenant's budget is waived
        try:
            return self.policy.charge(tenant, n_tokens)
        except BudgetExhaustedError:
            _obs.on_qos_budget_reject(tenant)
            raise

    def refund(self, tenant: str, n_tokens: float) -> None:
        if self.policy is not None:
            self.policy.refund(tenant, n_tokens)

    def observe(self, queue_depth_mean: float,
                interactive_ttft_p99_ms: Optional[float] = None,
                now: Optional[float] = None) -> int:
        """Forward one control round's signals to the ladder (no-op
        gate without a brownout controller)."""
        if self.brownout is None:
            return 0
        return self.brownout.observe(queue_depth_mean,
                                     interactive_ttft_p99_ms, now=now)

    def snapshot(self) -> Dict:
        out: Dict = {"brownout_level": (self.brownout.level
                                        if self.brownout else 0)}
        if self.policy is not None:
            out["limited_tenants"] = self.policy.limited_tenants()
        return out
