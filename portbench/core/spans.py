"""Device time under the port's own ranges in the host trace.

The port opens a ``record_function`` range for each of its stage spans
(``hvd_tpu_wire``, ``hvd_tpu_apply``) and, while the profiler records,
for each layer of the model, forward on the step's thread and backward
on the autograd engine's (``horovod_tpu_torch/obs/trace.py``).  They
show in the trace as ``user_annotation`` events.  A device operation
lies under a range when its launch (the CUDA call with its correlation
id) lies inside a range of that name on the launching thread; the
ranges of one thread never overlap, so no operation lies under two.
A program without the ranges, or a trace without device operations (no
card), reads None.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Sequence

from .trace import DeviceOp, Interval, Trace, union

LAYERS = ("hvd_tpu_layer_embed", "hvd_tpu_layer_attn", "hvd_tpu_layer_mlp",
          "hvd_tpu_layer_head")
STAGES = ("hvd_tpu_wire", "hvd_tpu_apply")
EVERY = LAYERS + STAGES


def under(trace: Trace, names: Iterable[str],
          ops: Sequence[DeviceOp]) -> Optional[List[DeviceOp]]:
    """The ``ops`` launched inside a host range named exactly one of
    ``names``, on the launching thread; None when there are no ``ops``
    or the trace holds no such range."""
    names = set(names)
    if not ops:
        return None
    by_tid: Dict[int, List[Interval]] = {}
    for h in trace.host:
        if h.name in names:
            by_tid.setdefault(h.tid, []).append((h.start, h.end))
    if not by_tid:
        return None
    merged = {tid: union(iv) for tid, iv in by_tid.items()}
    starts = {tid: [a for a, _ in iv] for tid, iv in merged.items()}
    out = []
    for op in ops:
        tid, ts = trace.launch.get(op.correlation, (None, None))
        if tid not in merged:
            continue
        i = bisect.bisect_right(starts[tid], ts) - 1
        if i >= 0 and merged[tid][i][1] >= ts:
            out.append(op)
    return out


def _ms_per_step(ops: Sequence[DeviceOp], steps: int) -> float:
    return sum(op.end - op.start for op in ops) * 1e-3 / steps


def ms_per_step(ctx, *names: str, nccl: bool = True) -> Optional[float]:
    """Device ms a step of the ops launched under ``names`` in the
    traced steps (every thread), over ``ctx.traced_steps``; with
    ``nccl=False`` without NCCL's kernels."""
    trace = ctx.host_trace
    ops = under(trace, names, trace.device_ops(trace.window()))
    if ops is None:
        return None
    if not nccl:
        ops = [op for op in ops if "nccl" not in op.name.lower()]
    return _ms_per_step(ops, ctx.traced_steps)


def unattributed_ms_per_step(ctx) -> Optional[float]:
    """Device ms a step of the ops in the traced steps launched under
    none of :data:`EVERY`; None when the trace holds none of them."""
    trace = ctx.host_trace
    ops = trace.device_ops(trace.window())
    inside = under(trace, EVERY, ops)
    if inside is None:
        return None
    seen = {id(op) for op in inside}
    return _ms_per_step([op for op in ops if id(op) not in seen],
                        ctx.traced_steps)
