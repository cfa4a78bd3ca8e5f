"""Declarative SLOs evaluated as multi-window burn-rate alerts.

Counterpart of ``horovod_tpu/obs/slo.py`` (host Python, no device
work), under the reference's names.

The Google-SRE alerting geometry ("Alerting on SLOs", SRE workbook):
an SLO grants an error budget — ``budget`` = the allowed bad fraction
of collection rounds over ``window_s`` — and the alert condition is
the measured bad fraction burning that budget at >= ``burn``x the
sustainable rate in BOTH the long window (sensitivity: a slow leak
still trips it) and a short confirmation window (reset speed: the
alert un-fires quickly once the incident ends, and a brief ancient
spike cannot keep paging).  Burn rate 1.0 means exactly exhausting the
budget at the window's end; the classic page threshold 14.4 means
"burning a 30-day budget in 2 days".

The catalog comes from ``HVD_TPU_SLO_SPEC`` (grammar parsed/validated
in :mod:`..config` — see docs/observability.md), falling
back to :data:`DEFAULT_SLO_SPEC`.  Signals are CLOSED
(``config.SLO_SIGNALS``): each maps to one fleet-level series the
collector lands every round, with the bad-round predicate defined
here — an open signal set would reintroduce the
alert-that-never-fires typo class the grammar exists to kill.

Every evaluation updates ``hvd_tpu_slo_burn_rate{slo}``; the
fire/clear edges are the :class:`~.detect.AlertSink`'s
job, shared with the invariant detectors.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from .timeseries import RingTSDB

__all__ = ["DEFAULT_SLO_SPEC", "SloBook"]

# Applied when HVD_TPU_SLO_SPEC is unset: scrape-plane availability is
# the one objective every deployment shares (latency/queue targets are
# workload policy — a default number would false-page half the fleets
# it runs on).  10% of replicas scrape-dead, sustained at 2x the 5%
# budget across 10min/1min windows, pages.
DEFAULT_SLO_SPEC = ("availability:signal=scrape_ok,target=0.9,budget=0.05,"
                    "window=600,short=60,burn=2,severity=page")

# signal -> (fleet series written by obs/collector.py, bad-round
# predicate direction: "gt" = bad when value > target, "lt" = bad when
# value < target).
_SIGNAL_SERIES = {
    "ttft_p99_ms": ("fleet_ttft_ms_p99", "gt"),
    "queue_depth": ("fleet_queue_depth_mean", "gt"),
    "scrape_ok": ("fleet_scrape_ok_frac", "lt"),
}


class SloBook:
    """The parsed SLO catalog plus its burn-rate evaluation over the
    collector's TSDB."""

    def __init__(self, spec: Optional[str] = None,
                 tsdb: Optional[RingTSDB] = None) -> None:
        from ..config import parse_slo_spec

        self.clauses = parse_slo_spec(spec if spec and spec.strip()
                                      else DEFAULT_SLO_SPEC)
        self.tsdb = tsdb if tsdb is not None else RingTSDB()
        self._lock = threading.Lock()
        # Last evaluated burn rates, {slo: (burn_long, burn_short)} —
        # fleet_top's SLO panel reads this between rounds.
        self._burns: Dict[str, tuple] = {}   # guarded-by: _lock

    def _bad_frac(self, series: str, direction: str, target: float,
                  since: float) -> Optional[float]:
        pts = self.tsdb.window(series, since)
        if not pts:
            return None
        if direction == "gt":
            bad = sum(1 for _, v in pts if v > target)
        else:
            bad = sum(1 for _, v in pts if v < target)
        return bad / len(pts)

    def evaluate(self, now: float) -> List[dict]:
        """One evaluation round: per SLO, the long/short-window burn
        rates and the firing condition (both windows >= the clause's
        ``burn``).  Returns the condition list the
        :class:`~.detect.AlertSink` consumes; SLOs whose
        series have no samples yet yield nothing (absent data must not
        page)."""
        from . import instrument as _obs

        out: List[dict] = []
        burns: Dict[str, tuple] = {}
        for name, cl in self.clauses.items():
            series, direction = _SIGNAL_SERIES[cl.signal]
            long_frac = self._bad_frac(series, direction, cl.target,
                                       now - cl.window_s)
            short_frac = self._bad_frac(series, direction, cl.target,
                                        now - cl.short_s)
            if long_frac is None or short_frac is None:
                continue
            burn_long = long_frac / cl.budget
            burn_short = short_frac / cl.budget
            burns[name] = (burn_long, burn_short)
            _obs.on_slo_burn(name, burn_long)
            out.append({
                "id": f"slo_burn:{name}",
                "severity": cl.severity,
                "firing": burn_long >= cl.burn and burn_short >= cl.burn,
                "detail": {"signal": cl.signal, "target": cl.target,
                           "burn_long": round(burn_long, 4),
                           "burn_short": round(burn_short, 4),
                           "threshold": cl.burn},
            })
        with self._lock:
            self._burns = burns
        return out

    def burn_rates(self) -> Dict[str, tuple]:
        """``{slo: (burn_long, burn_short)}`` from the last round."""
        with self._lock:
            return dict(self._burns)
