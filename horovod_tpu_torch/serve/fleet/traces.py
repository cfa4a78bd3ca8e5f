"""Trace generation and latency profiles for the fleet simulator.

Counterpart of ``horovod_tpu/serve/fleet/traces.py``, draw for draw.
Two inputs parameterize :mod:`~.sim`:

* **Traces** — seeded open-loop request streams (:func:`make_trace`):
  burst-modulated Poisson arrivals over a tenant × QoS-class mix, with
  a Zipf-skewed prefix pool at the directory's block granularity so
  prefix-directory routing has real hit structure to exercise.
  Open-loop matters: arrivals never wait for completions, so overload
  actually overloads (a closed loop throttles itself and never trips
  the brownout ladder).

* **Replica profiles** — service-time distributions: lognormal fits
  (:class:`LatencyDist`) recovered in closed form from a p50/p99 (or
  mean/p99) pair.  :func:`load_profile` reads the repo's recorded
  serving artifacts (``SERVING_r11.json`` fleet TTFT and migration,
  ``SERVING_r14.json`` swap latency, ``SERVING_r15.json`` per-class
  TPOT).  Those files are CPU runs of the JAX package, not readings of
  this port on a GPU: a profile of the port on the card is fitted from
  its own readings (``ReplicaProfile(LatencyDist(...), ...)``).  Every
  draw goes through ``random.Random(seed)``: the same seed gives the
  same trace and the same service draws.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import random
from typing import Dict, List, Optional, Sequence, Tuple

# z-score of the 99th percentile of the standard normal: the lognormal
# fit solves  p99 = exp(mu + Z_P99 * sigma)  against  p50 = exp(mu).
Z_P99 = 2.326

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))


@dataclasses.dataclass(frozen=True)
class LatencyDist:
    """A fitted lognormal service-time distribution (milliseconds)."""

    p50_ms: float
    p99_ms: float

    @property
    def mu(self) -> float:
        return math.log(max(1e-6, self.p50_ms))

    @property
    def sigma(self) -> float:
        return max(0.0, (math.log(max(1e-6, self.p99_ms)) - self.mu)
                   / Z_P99)

    @classmethod
    def from_mean_p99(cls, mean_ms: float, p99_ms: float) -> "LatencyDist":
        """Fit from a recorded (mean, p99) pair: with
        ``mean = exp(mu + sigma²/2)`` and ``p99 = exp(mu + Z·sigma)``,
        sigma solves the quadratic ``sigma²/2 − Z·sigma + ln(p99/mean)
        = 0`` (smaller root — the tail-consistent branch)."""
        mean_ms = max(1e-6, float(mean_ms))
        p99_ms = max(mean_ms, float(p99_ms))
        gap = math.log(p99_ms / mean_ms)
        disc = max(0.0, Z_P99 * Z_P99 - 2.0 * gap)
        sigma = Z_P99 - math.sqrt(disc)
        p50 = mean_ms * math.exp(-sigma * sigma / 2.0)
        return cls(p50_ms=p50, p99_ms=p50 * math.exp(Z_P99 * sigma))

    def sample(self, rng: random.Random) -> float:
        """One draw in milliseconds (always > 0)."""
        return math.exp(self.mu + self.sigma * rng.gauss(0.0, 1.0))


@dataclasses.dataclass(frozen=True)
class ReplicaProfile:
    """What one simulated replica costs, per operation."""

    ttft_ms: LatencyDist        # queue-free first-token service time
    tpot_ms: LatencyDist        # per-token decode time
    migrate_ms: LatencyDist     # prefill→decode KV transfer
    swap_ms: LatencyDist        # weight hot-swap pull+flip
    source: str = "defaults"


# Fallback when no artifacts are on disk: round numbers in the regime
# the JAX package's recorded CPU benches measured.
DEFAULT_PROFILE = ReplicaProfile(
    ttft_ms=LatencyDist(120.0, 4500.0),
    tpot_ms=LatencyDist(2.4, 2.8),
    migrate_ms=LatencyDist(80.0, 420.0),
    swap_ms=LatencyDist(950.0, 3600.0),
)


def _summary(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc.get("summary", doc) if isinstance(doc, dict) else None


def load_profile(root: Optional[str] = None) -> ReplicaProfile:
    """Build the replica profile from the recorded ``SERVING_r*``
    artifacts under ``root`` (the repo root by default: the JAX
    package's CPU runs); any missing artifact falls back to
    :data:`DEFAULT_PROFILE`'s numbers for its fields — the sim runs
    without them too."""
    root = root or _REPO
    r11 = _summary(os.path.join(root, "SERVING_r11.json")) or {}
    r14 = _summary(os.path.join(root, "SERVING_r14.json")) or {}
    r15 = _summary(os.path.join(root, "SERVING_r15.json")) or {}
    used = [name for name, doc in (("SERVING_r11", r11),
                                   ("SERVING_r14", r14),
                                   ("SERVING_r15", r15)) if doc]
    ttft = DEFAULT_PROFILE.ttft_ms
    if "unified_ttft_ms_p50" in r11:
        # The unified tier's measured submit→first-token distribution —
        # the per-replica service cost the fleet policies sit on top of.
        ttft = LatencyDist(float(r11["unified_ttft_ms_p50"]),
                           float(r11["unified_ttft_ms_p99"]))
    tpot = DEFAULT_PROFILE.tpot_ms
    if "batch_tpot_ms_p99" in r15:
        # r15 records per-class TPOT p99s only; the p50 estimate rides
        # the lower class p99 (TPOT is tight on CPU — the classes'
        # p99s bracket a narrow band).
        hi = max(float(r15.get("interactive_tpot_ms_p99", 0.0)),
                 float(r15["batch_tpot_ms_p99"]))
        lo = min(float(r15.get("interactive_tpot_ms_p99", hi)),
                 float(r15["batch_tpot_ms_p99"]))
        tpot = LatencyDist(0.9 * lo, hi)
    migrate = DEFAULT_PROFILE.migrate_ms
    if "migrate_ms_mean" in r11:
        migrate = LatencyDist.from_mean_p99(float(r11["migrate_ms_mean"]),
                                            float(r11["migrate_ms_p99"]))
    swap = DEFAULT_PROFILE.swap_ms
    if "swap_latency_ms_mean" in r14:
        swap = LatencyDist.from_mean_p99(
            float(r14["swap_latency_ms_mean"]),
            float(r14["swap_latency_ms_max"]))
    return ReplicaProfile(ttft_ms=ttft, tpot_ms=tpot, migrate_ms=migrate,
                          swap_ms=swap,
                          source=",".join(used) if used else "defaults")


@dataclasses.dataclass(frozen=True)
class SimRequest:
    """One traced request.  Field names duck-type the ``ServeRequest``
    shape :class:`~..qos.sched.QosQueue` schedules
    (``request_id``/``tenant``/``qos_class``/``deadline``);
    ``deadline`` is ABSOLUTE virtual time (arrival + the class's
    relative deadline), None for batch."""

    request_id: str
    arrival_s: float
    tenant: str
    qos_class: str
    prompt: Tuple[int, ...]
    max_new_tokens: int
    deadline: Optional[float]

    @property
    def submitted_at(self) -> float:
        return self.arrival_s


# Relative deadlines per class (virtual seconds): interactive is SLO
# traffic, batch rides without one (preemption fodder).
CLASS_DEADLINE_S = {"interactive": 10.0, "standard": 60.0, "batch": None}

DEFAULT_CLASS_MIX = (("interactive", 0.2), ("standard", 0.3),
                     ("batch", 0.5))
DEFAULT_TENANTS = ("alice", "bob", "bulk")


def make_trace(n_requests: int, *, seed: int = 0,
               rate_rps: float = 200.0,
               burst_factor: float = 4.0,
               burst_period_s: float = 10.0,
               burst_duty: float = 0.3,
               class_mix: Sequence[Tuple[str, float]] = DEFAULT_CLASS_MIX,
               tenants: Sequence[str] = DEFAULT_TENANTS,
               prefix_pool: int = 64,
               prefix_skew: float = 3.0,
               block_tokens: int = 16,
               suffix_tokens: int = 16,
               max_new_tokens: int = 16) -> List[SimRequest]:
    """A seeded bursty open-loop trace of ``n_requests``.

    Arrivals are a burst-modulated Poisson process: for the first
    ``burst_duty`` of every ``burst_period_s`` window the rate is
    ``rate_rps × burst_factor``, else ``rate_rps`` — the on/off bursts
    that trip (and must then calmly un-trip) the brownout ladder.
    Prompts share leading blocks drawn from a ``prefix_pool`` with
    power-law skew ``prefix_skew`` (higher = hotter head), at the
    directory's ``block_tokens`` granularity.
    """
    if n_requests <= 0:
        raise ValueError(f"trace needs n_requests > 0, got {n_requests}")
    rng = random.Random(seed)
    classes = [c for c, _ in class_mix]
    weights = [w for _, w in class_mix]
    out: List[SimRequest] = []
    t = 0.0
    for i in range(n_requests):
        in_burst = (t % burst_period_s) < burst_period_s * burst_duty
        rate = rate_rps * (burst_factor if in_burst else 1.0)
        t += rng.expovariate(max(1e-9, rate))
        qos_class = rng.choices(classes, weights=weights)[0]
        tenant = tenants[i % len(tenants)]
        # Zipf-ish head: u**skew concentrates mass near index 0.
        hot = int(prefix_pool * (rng.random() ** prefix_skew))
        hot = min(prefix_pool - 1, hot)
        prefix = tuple(7000 + hot * block_tokens + j
                       for j in range(block_tokens))
        suffix = tuple(rng.randrange(1, 4096)
                       for _ in range(suffix_tokens))
        rel = CLASS_DEADLINE_S.get(qos_class)
        out.append(SimRequest(
            request_id=f"r{i:07d}",
            arrival_s=t,
            tenant=tenant,
            qos_class=qos_class,
            prompt=prefix + suffix,
            max_new_tokens=max_new_tokens,
            deadline=(t + rel) if rel is not None else None,
        ))
    return out
