"""Weighted-fair admission queue: stride/virtual-time scheduling plus

Counterpart of ``horovod_tpu/serve/qos/sched.py``,
line for line: host-side bookkeeping with no model in it, so the
port keeps its own copy.
a deadline min-heap.

Replaces the batcher's FIFO admission queue (docs/qos.md).  Every
``(tenant, class)`` pair is one *flow*; backlogged flows are served in
virtual-finish-time order — the stride discipline:

* a flow's **stride** is ``STRIDE_UNIT / weight`` (weight = class
  weight × tenant share, ``policy.QosPolicy.weight``);
* each dispatch advances the flow's virtual finish time by one stride,
  so over any interval a backlogged flow receives slots in proportion
  to its weight — one hot tenant's flood advances its own clock past
  everyone else's and *cannot starve the rest* (the fairness bound of
  stride scheduling: a flow's service lag is at most one request);
* a flow that goes idle and returns re-enters at ``max(its old clock,
  the global virtual time)`` — it cannot bank credit while idle and
  then burst past active flows.

With a single flow (no tenants configured) the discipline degenerates
to exact FIFO, so the QoS queue is always on — unconfigured servers
behave precisely as before.

**Deadline expiry is a min-heap**, not a queue scan: the old
``_expire`` walked the whole queue under the lock every step, an
O(queue) cost per step that scaled with exactly the overload the
deadline machinery exists to survive.  Entries are lazily invalidated
(pop/remove drop the id from the live set), so expiry is
O(expired · log n) amortized.

Thread safety: the batcher calls under its own lock already, but
cancel/expiry also arrive from RPC handler threads — every method
takes the queue's own lock (always acquired *after* the batcher's,
never the reverse: no lock-order cycle).

The ``qos`` fault site's ``invert`` mode fires at :meth:`pop` — the
scheduler dispatches the LOWEST-priority backlogged flow instead, a
priority-inversion bug injected on purpose (the chaos drill for the
preemption/brownout safety net).
"""

from __future__ import annotations

import collections
import heapq
import itertools
import threading
from typing import Dict, List, Optional, Tuple

from ... import faults as faults_mod

# Virtual-time unit: one weight-1.0 dispatch advances a flow's clock by
# this much.  Any constant works; a large one keeps strides integral-ish
# for readable debugging.
STRIDE_UNIT = 1 << 20


class _Flow:
    __slots__ = ("queue", "vfinish", "weight")

    def __init__(self, weight: float, vtime: float) -> None:
        self.queue: "collections.deque" = collections.deque()
        self.vfinish = vtime
        self.weight = max(1e-6, float(weight))


class QosQueue:
    """Weighted-fair admission queue over ``ServeRequest``-shaped
    items (anything with ``request_id``/``tenant``/``qos_class``/
    ``deadline`` attributes)."""

    def __init__(self, policy) -> None:
        self._policy = policy
        self._lock = threading.Lock()
        self._flows: Dict[Tuple[str, str], _Flow] = {}  # guarded-by: _lock
        self._vtime = 0.0                               # guarded-by: _lock
        self._by_id: Dict[str, object] = {}             # guarded-by: _lock
        self._heap: List[tuple] = []                    # guarded-by: _lock
        self._seq = itertools.count()

    def __len__(self) -> int:
        with self._lock:
            return len(self._by_id)

    def depths(self) -> Dict[str, int]:
        """Queued requests per class (the brownout/controller signal)."""
        out: Dict[str, int] = {}
        with self._lock:
            for (_, cls), flow in self._flows.items():
                if flow.queue:
                    out[cls] = out.get(cls, 0) + len(flow.queue)
        return out

    # --- admission ----------------------------------------------------------

    def push(self, req) -> None:
        key = (req.tenant, req.qos_class)
        with self._lock:
            flow = self._flows.get(key)
            if flow is None:
                flow = _Flow(self._policy.weight(*key), self._vtime)
                self._flows[key] = flow
            elif not flow.queue:
                # Reactivation: no banked credit from the idle period.
                flow.vfinish = max(flow.vfinish, self._vtime)
            flow.queue.append(req)
            self._by_id[req.request_id] = req
            if req.deadline is not None:
                heapq.heappush(self._heap,
                               (req.deadline, next(self._seq), req))

    # --- dispatch -----------------------------------------------------------

    def pop(self):
        """Next request in weighted-fair order (None when empty)."""
        invert = (faults_mod._active is not None
                  and faults_mod.on_qos_pick())
        with self._lock:
            backlogged = [(flow.vfinish, key, flow)
                          for key, flow in self._flows.items()
                          if flow.queue]
            if not backlogged:
                return None
            pick = max(backlogged) if invert else min(backlogged)
            vfinish, _, flow = pick
            self._vtime = max(self._vtime, min(b[0] for b in backlogged))
            req = flow.queue.popleft()
            flow.vfinish = vfinish + STRIDE_UNIT / flow.weight
            self._by_id.pop(req.request_id, None)
            return req

    # --- removal ------------------------------------------------------------

    def remove(self, request_id: str):
        """Take one queued request out by id (cancel); returns it or
        None.  The deadline-heap entry dies lazily."""
        with self._lock:
            req = self._by_id.pop(request_id, None)
            if req is None:
                return None
            flow = self._flows.get((req.tenant, req.qos_class))
            if flow is not None:
                try:
                    flow.queue.remove(req)
                except ValueError:
                    pass
            return req

    def pop_expired(self, now: float) -> list:
        """Every queued request whose deadline passed — O(expired ·
        log n): the heap's top is the earliest deadline, so one peek
        per step suffices when nothing expired."""
        out = []
        with self._lock:
            while self._heap and self._heap[0][0] <= now:
                _, _, req = heapq.heappop(self._heap)
                if self._by_id.pop(req.request_id, None) is None:
                    continue   # already dispatched/cancelled: stale entry
                flow = self._flows.get((req.tenant, req.qos_class))
                if flow is not None:
                    try:
                        flow.queue.remove(req)
                    except ValueError:
                        pass
                out.append(req)
        return out

    def drain(self) -> list:
        """Remove and return everything queued (replica death)."""
        with self._lock:
            out = list(self._by_id.values())
            self._by_id.clear()
            self._heap.clear()
            for flow in self._flows.values():
                flow.queue.clear()
            return out

    # --- scheduling probes --------------------------------------------------

    def urgent(self, qos_class: str = "interactive"
               ) -> Optional[tuple]:
        """``(deadline, request)`` of the most urgent queued request of
        ``qos_class`` — earliest deadline first, then (for the SLO-TTFT
        trigger, which needs deadline-less requests too) earliest
        submitted.  None when the class has nothing queued.  Scans only
        that class's flows — under overload the protected class's queue
        is short by construction (everything else sheds/preempts
        first)."""
        best = None
        with self._lock:
            for (_, cls), flow in self._flows.items():
                if cls != qos_class:
                    continue
                for req in flow.queue:
                    key = ((0, req.deadline) if req.deadline is not None
                           else (1, getattr(req, "submitted_at", 0.0)))
                    if best is None or key < best[0]:
                        best = (key, req)
        if best is None:
            return None
        return best[1].deadline, best[1]
