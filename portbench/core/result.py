"""From the ranks' numbers to the run's last line.

Each rank reduces its run to :func:`summary`; rank 0 joins the ranks'
summaries in :func:`line`.  End-to-end metrics are the benchmark's
own measurements (:data:`END_TO_END`); each per-layer metric is read by
``metrics/<name>.py``'s ``read(ctx)`` from rank 0's trace, and is left
out of the line when the reader finds nothing to read (returns None).
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import sys
from typing import Callable, Dict, List, Optional

from . import trace as tr
from .spec import Cell, family_module, metric_module

GIB = 2 ** 30


@dataclasses.dataclass
class MetricContext:
    """What a per-layer reader may read: the cell and its shapes, rank 0's
    two traces of ``traced_steps`` steps each, and its untraced window."""
    cell: Cell
    shape: dict
    world: int
    batch: int                 # rows a rank
    seq: int
    trace: tr.Trace            # the device's alone
    host_trace: tr.Trace       # with the host's ops and spans
    traced_steps: int
    window: dict               # steps, wall_s, host_s of the untraced window
    leaf_numels: List[int]
    peaks: Optional[dict]      # work/peaks.json's entry for the card


def per_layer(cell: Cell, ctx: MetricContext) -> Dict[str, float]:
    values = {}
    for m in cell.per_layer:
        value = metric_module(cell, m["name"]).read(ctx)
        if value is not None:
            values[m["name"]] = value
    return values


def summary(cell: Cell, out: dict, device_name: str, peaks) -> dict:
    """One rank's numbers, JSON-ready: the trace is reduced to busy and
    window seconds (every rank), and to the per-layer values and the
    breakdown (rank 0)."""
    win = out["window"]
    s = dict(rank=out["rank"], setup_s=out["setup_s"],
             peak_bytes=out["peak_bytes"],
             steps=win["steps"], wall_s=win["wall_s"], failed=win["failed"],
             device=device_name)
    if out["rank"] == 0:
        s["step_s"] = win["step_s"]
    trace = out.get("trace")
    if trace is not None:
        bw = tr.busy_and_window(trace)
        if bw is not None:
            s["busy_s"], s["window_trace_s"] = bw
        if out["rank"] == 0:
            t = cell.traffic
            ctx = MetricContext(
                cell=cell, shape=family_module(cell).model_shape(cell.config),
                world=cell.chips, batch=int(t["batch_per_rank"]),
                seq=int(t["seq_len"]), trace=trace,
                host_trace=out["host_trace"],
                traced_steps=int(cell.workload["trace_steps"]), window=win,
                leaf_numels=out["leaf_numels"], peaks=peaks)
            s["per_layer"] = per_layer(cell, ctx)
            s["breakdown"] = tr.breakdown(trace)
    return s


def _samples_per_s(cell, ranks):
    r0 = ranks[0]
    rows = int(cell.traffic["batch_per_rank"]) * len(ranks)
    return r0["steps"] * rows / r0["wall_s"]


def _step_ms_p90(cell, ranks):
    ms = [s * 1e3 for s in ranks[0]["step_s"]]
    if len(ms) < 2:
        return ms[0]
    return statistics.quantiles(ms, n=10, method="inclusive")[8]


END_TO_END: Dict[str, Callable] = {
    "samples_per_s": _samples_per_s,
    "step_ms_p90": _step_ms_p90,
    "peak_mem_gib": lambda cell, ranks: max(r["peak_bytes"] for r in ranks) / GIB,
    "setup_s": lambda cell, ranks: max(r["setup_s"] for r in ranks),
}


def _plain(x):
    """A number JSON can hold: a non-finite float becomes its name."""
    if isinstance(x, float) and not math.isfinite(x):
        return repr(x)
    return x


def line(cell: Cell, ranks: List[dict], trace: bool, correct: bool,
         shown: dict, power: str) -> dict:
    metrics = {}
    if trace:
        for name, value in ranks[0].get("per_layer", {}).items():
            unit = next(m["unit"] for m in cell.per_layer if m["name"] == name)
            metrics[name] = {"value": value, "unit": unit}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": END_TO_END[m["name"]](cell, ranks),
                                  "unit": m["unit"]}
    device = {"platform": "gpu", "kind": ranks[0]["device"],
              "count": len(ranks),
              "memory_peak_bytes": max(r["peak_bytes"] for r in ranks),
              "power_limit": power}
    result = {"correct": correct, "attempted": ranks[0]["steps"],
              "failed": max(r["failed"] for r in ranks), "metrics": metrics,
              "device": device}
    if trace:
        busy = [r["busy_s"] for r in ranks if "busy_s" in r]
        wins = [r["window_trace_s"] for r in ranks if "window_trace_s" in r]
        if busy:
            device["busy_s"] = statistics.fmean(busy)
            device["window_s"] = statistics.fmean(wins)
        result["breakdown"] = ranks[0].get("breakdown",
                                           {"device_ops": [], "idle_gaps": []})
    result["limits"] = {k: {kk: _plain(vv) for kk, vv in v.items()}
                        for k, v in shown.items()}
    return result


def print_line(result: dict, shown: dict) -> None:
    """The numbers compared, each beside its limit, as the last lines of
    standard error; the result as the last line of standard output."""
    import json

    sys.stdout.flush()
    for name, v in shown.items():
        print(f"{name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
