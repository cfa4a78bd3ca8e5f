"""Deterministic, seedable fault injection for chaos-testing recovery.

At production scale failures are the steady state — "Collective
Communication for 100k+ GPUs" (PAPERS.md) reports that fault handling,
not raw busbw, dominates fleet-level goodput.  This module makes every
recovery path exercisable on demand: named injection *sites* are
threaded through the recovery-relevant layers, and a **fault plan**
declares what fires where:

========== ===================================================== =====================
site       threaded through                                      actions (``mode=``)
========== ===================================================== =====================
collective ``ops/collectives.py`` dispatch heartbeat             ``raise`` (HorovodInternalError)
fusion     ``ops/fusion.py`` two-phase apply (trace time)        ``raise``
accumulate microbatch-loop boundary of the overlap-scheduled     ``raise``
           train steps (trace time; one event per microbatch)
discovery  ``elastic/driver.py`` ScriptDiscovery + poll          ``flap``/``timeout``/``error``
rpc        ``runner/common/network.py`` BasicClient calls        ``drop``/``delay``
checkpoint ``ckpt/store.py`` write + ``checkpoint.py`` save      ``corrupt``/``partial``/``stall``/
                                                                 ``partial-manifest``/``crash-before-rename``
serve      ``serve/server.py`` request handler (drop/delay);     ``drop``/``delay``/``kill``/
           ``serve/batcher.py`` step dispatch (kill: decode on   ``evict``/``migrate``/
           decode replicas, the migration handoff on prefill     ``migrate-drop``/
           replicas); ``serve/kv/pool.py`` block allocation      ``migrate-delay``
           (evict); ``serve/fleet/migration.py`` KV-transfer
           boundary (migrate*)
dcn        ``topo/schedule.py`` cross-pod exchange step only     ``drop``/``delay``/``partition``
           (trace time; intra-pod phases never fire)
swap       ``serve/swap.py`` shard pull (corrupt-shard/stall),   ``corrupt-shard``/``stall``/
           ``serve/batcher.py`` flip barrier (kill-mid-flip),    ``kill-mid-flip``/
           ``serve/fleet/controller.py`` rolling-swap boundary   ``partial-fleet``
           (partial-fleet)
qos        ``serve/qos/sched.py`` WFQ pop (invert);              ``invert``/``flood``
           ``serve/batcher.py`` + ``serve/qos/brownout.py``
           admission budget charge (flood)
collect    ``obs/collector.py`` per-replica scrape boundary      ``drop``/``delay``/``garbage``
           (the fleet telemetry plane's read path)
control    ``serve/fleet/controller.py`` poll (spiral: skip the  ``spiral``/``convoy``
           shed-active scale-in guard); ``serve/fleet/sim.py``
           migration admission (convoy: skip the decode-side
           reservation) — re-introduces the two control-plane
           bugs the chaos sim caught, so the live detectors
           can prove they fire
========== ===================================================== =====================

A plan comes from ``HVD_TPU_FAULT_SPEC`` (grammar parsed in
:mod:`horovod_tpu.config`; e.g. ``collective:step=40;discovery:flap=0.2,
seed=7``) or the :func:`inject` context manager.  Triggers are
**deterministic**: ``step=N`` fires on the N-th event at the site (the
checkpointer matches its own step number instead — the domain step is
the reproducible coordinate there), ``p=x`` draws from a per-site
``random.Random(seed)``, so the same spec over the same call sequence
fires the identical failure sequence on every run — the property that
makes a chaos failure debuggable.  :func:`history` records every firing
for cross-run comparison.

Counterpart of ``horovod_tpu/faults.py``, the same sites, grammar and
firing rules.  The port threads ``collective`` (the eager collectives'
dispatch), ``fusion`` (the two-phase apply), ``accumulate`` (the
microbatch boundary, once per build of a step, as the reference's
trace), ``dcn`` (the cross-pod stage of the hierarchical executors),
``checkpoint`` (``ckpt/store.py`` and ``ckpt/compat.py``) and
``discovery`` (``elastic/driver.py``); the other sites' callers are not
ported yet, their hooks are.

Hot-path contract: when no plan is active, ``_active is None`` and every
instrumented call site guards on exactly that — zero work per dispatch.
"""

from __future__ import annotations

import contextlib
import random
import threading
import time
from typing import Dict, List, Optional, Tuple

from .config import FaultClause, parse_fault_spec
import logging

logger = logging.getLogger(__name__)

__all__ = [
    "configure", "clear", "inject", "active_spec", "history",
    "on_collective", "on_fusion", "on_accumulate", "on_discovery_script",
    "on_discovery_hosts", "on_rpc", "on_checkpoint_save",
    "on_serve_request", "on_serve_decode", "on_serve_evict",
    "on_serve_migrate", "on_dcn", "on_swap_pull", "on_swap_flip",
    "on_swap_roll", "on_qos_pick", "on_qos_admit", "on_collect",
    "on_control",
]


class _SiteState:
    """Runtime state of one clause: event counter, firing count, and the
    clause's private RNG (determinism: one RNG per site, never shared)."""

    def __init__(self, clause: FaultClause) -> None:
        self.clause = clause
        self.rng = random.Random(clause.seed)
        self.counter = 0   # events observed at this site
        self.fired = 0

    def _budget(self) -> int:
        if self.clause.times is not None:
            return self.clause.times
        # A step fault is a one-shot by default (inject once, watch the
        # recovery); a probability fault keeps flipping coins.
        return 1 if self.clause.step is not None else (1 << 30)

    def should_fire(self, domain_step: Optional[int] = None) -> bool:
        idx = self.counter
        self.counter += 1
        if self.fired >= self._budget():
            return False
        if self.clause.step is not None:
            at = domain_step if domain_step is not None else idx
            if at == self.clause.step:
                self.fired += 1
                return True
            if self.clause.p <= 0.0:
                return False
        if self.clause.p > 0.0 and self.rng.random() < self.clause.p:
            self.fired += 1
            return True
        return False


class FaultPlan:
    """An armed fault plan: per-site state plus the firing history."""

    def __init__(self, clauses: Dict[str, FaultClause], raw: str) -> None:
        self.raw = raw
        self._sites = {site: _SiteState(c) for site, c in clauses.items()}
        self.history: List[Tuple[str, int, str]] = []  # guarded-by: _lock
        self._dumped_sites: set = set()                # guarded-by: _lock
        self._lock = threading.Lock()

    def site(self, name: str) -> Optional[_SiteState]:
        return self._sites.get(name)

    def fire(self, site: str, mode: str, at: int, detail: str = "") -> None:
        with self._lock:
            self.history.append((site, at, mode + (f":{detail}" if detail
                                                   else "")))
            first_for_site = site not in self._dumped_sites
            self._dumped_sites.add(site)
        from .obs import flight as _flight
        from .obs import instrument as _obs
        from .obs import trace as _trace

        _obs.on_fault(site)
        # The firing lands in the dispatching thread's live trace (a
        # collective fault parents under the step span, a serve fault
        # under the request) and in the flight recorder, which dumps
        # on the FIRST firing per site: a chaos failure's postmortem
        # must exist even if recovery never runs, but a probability-mode
        # site firing on every dispatch must not turn the hot path into
        # per-firing file I/O (every firing still lands in the ring, so
        # the terminal-error dump carries the full record).
        _trace.instant("hvd_tpu_fault",
                       args={"site": site, "mode": mode, "at": at,
                             "detail": detail})
        _flight.record("fault", site=site, mode=mode, at=at, detail=detail)
        if first_for_site:
            _flight.dump(f"fault_{site}")
        logger.warning("fault injected: site=%s mode=%s at=%d %s",
                       site, mode, at, detail)


_active: Optional[FaultPlan] = None   # guarded-by: _lock
_lock = threading.Lock()


def configure(spec: Optional[str]) -> None:
    """Arm (or disarm, with ``None``/empty) the process-wide fault plan.
    Arming restarts counters/RNGs: a fresh, reproducible failure
    sequence.  ``hvd.init`` arms only a *changed* spec, so the sequence
    spans the whole process across elastic re-inits; call this (or
    :func:`inject`) explicitly to restart it."""
    global _active
    with _lock:
        if not spec:
            _active = None
            return
        _active = FaultPlan(parse_fault_spec(spec), spec)
        logger.warning("fault plan armed: %s", spec)


def clear() -> None:
    configure(None)


def active_spec() -> Optional[str]:
    return _active.raw if _active is not None else None


def history() -> List[Tuple[str, int, str]]:
    """Copy of the firing history ``[(site, at, action), ...]`` — the
    cross-run reproducibility artifact."""
    plan = _active
    if plan is None:
        return []
    with plan._lock:
        return list(plan.history)


@contextlib.contextmanager
def inject(spec: str):
    """Context-manager fault plan (tests/chaos drivers)::

        with faults.inject("collective:step=3"):
            train(state)

    Restores the previous plan (with its live counters) on exit."""
    global _active
    with _lock:
        prev = _active
        plan = FaultPlan(parse_fault_spec(spec), spec)
        _active = plan
    try:
        yield plan
    finally:
        with _lock:
            if _active is plan:
                _active = prev


# --- site hooks --------------------------------------------------------------
# Call sites guard on ``faults._active is not None`` before calling these,
# so an unset plan costs one module-attribute read per dispatch.

def _internal_error(msg: str):
    from .elastic.state import HorovodInternalError

    return HorovodInternalError(msg)


def on_collective(name: str = "") -> None:
    """Site ``collective`` — raises ``HorovodInternalError`` when the
    plan fires (the reference's a-collective-failed signal)."""
    plan = _active
    if plan is None:
        return
    st = plan.site("collective")
    if st is None:
        return
    at = st.counter
    if st.should_fire():
        plan.fire("collective", "raise", at, name)
        raise _internal_error(
            f"injected collective fault at dispatch #{at} ({name})")


def on_fusion(stage: str = "two_phase") -> None:
    """Site ``fusion`` — fires inside the two-phase apply (trace time:
    the failure surfaces while building the fused program)."""
    plan = _active
    if plan is None:
        return
    st = plan.site("fusion")
    if st is None:
        return
    at = st.counter
    if st.should_fire():
        plan.fire("fusion", "raise", at, stage)
        raise _internal_error(f"injected fusion fault at trace #{at} ({stage})")


def on_accumulate(microbatch: int = 0) -> None:
    """Site ``accumulate`` — fires at the microbatch-loop boundary of
    the overlap-scheduled train steps (trace time, like ``fusion``: the
    failure surfaces while the gradient-accumulation program is being
    built).  One event per microbatch boundary, so
    ``accumulate:step=N`` targets the N-th boundary of the trace."""
    plan = _active
    if plan is None:
        return
    st = plan.site("accumulate")
    if st is None:
        return
    at = st.counter
    if st.should_fire():
        plan.fire("accumulate", "raise", at, f"microbatch={microbatch}")
        raise _internal_error(
            f"injected accumulate fault at boundary #{at} "
            f"(microbatch {microbatch})")


def on_dcn(stage: str = "xpod") -> None:
    """Site ``dcn`` — fires ONLY at the cross-pod exchange step of a
    hierarchical collective schedule (``topo/schedule.py``), never at
    the intra-pod phases: the slow inter-pod tier is the link that
    actually fails in multi-pod fleets, and a chaos drill should hit
    exactly it.  Trace time, like ``fusion`` — the failure surfaces
    while the cross-pod exchange is being emitted.  ``drop`` and
    ``partition`` raise ``HorovodInternalError`` (partition carries the
    pods-unreachable message recovery tooling greps for); ``delay``
    sleeps ``delay_ms`` (a congested DCN link stretching trace/compile
    time)."""
    plan = _active
    if plan is None:
        return
    st = plan.site("dcn")
    if st is None:
        return
    at = st.counter
    if st.should_fire():
        mode = st.clause.mode or "drop"
        plan.fire("dcn", mode, at, stage)
        if mode == "delay":
            time.sleep(st.clause.delay_ms / 1000.0)
            return
        if mode == "partition":
            raise _internal_error(
                f"injected dcn partition at exchange #{at} ({stage}): "
                f"cross-pod peers unreachable")
        raise _internal_error(
            f"injected dcn drop at exchange #{at} ({stage})")


def on_discovery_script(script: str = "") -> None:
    """Site ``discovery`` (modes ``timeout``/``error``) — fires before
    the discovery script runs, as the script's failure would."""
    import subprocess

    plan = _active
    if plan is None:
        return
    st = plan.site("discovery")
    if st is None or st.clause.mode == "flap":
        return
    at = st.counter
    if st.should_fire():
        mode = st.clause.mode or "error"
        plan.fire("discovery", mode, at, script)
        if mode == "timeout":
            raise subprocess.TimeoutExpired(script or "<discovery>",
                                            timeout=0.0)
        raise subprocess.CalledProcessError(1, script or "<discovery>",
                                            stderr="injected discovery fault")


def on_discovery_hosts(hosts: Dict[str, int]) -> Dict[str, int]:
    """Site ``discovery`` (mode ``flap``) — drop each discovered host
    independently with probability ``p`` (seeded): a flapping host set."""
    plan = _active
    if plan is None:
        return hosts
    st = plan.site("discovery")
    if st is None or st.clause.mode != "flap":
        return hosts
    at = st.counter
    st.counter += 1
    if st.fired >= st._budget():  # times=N caps flapping polls too
        return hosts
    kept = {}
    dropped = []
    for host in sorted(hosts):  # sorted: draw order is reproducible
        if st.rng.random() < st.clause.p:
            dropped.append(host)
        else:
            kept[host] = hosts[host]
    if dropped:
        st.fired += 1
        plan.fire("discovery", "flap", at, ",".join(dropped))
    return kept


def on_rpc(op: str = "") -> None:
    """Site ``rpc`` — ``drop`` raises ``ConnectionError`` before the
    request is written; ``delay`` sleeps ``delay_ms`` (a slow peer)."""
    plan = _active
    if plan is None:
        return
    st = plan.site("rpc")
    if st is None:
        return
    at = st.counter
    if st.should_fire():
        mode = st.clause.mode or "drop"
        plan.fire("rpc", mode, at, op)
        if mode == "delay":
            time.sleep(st.clause.delay_ms / 1000.0)
            return
        raise ConnectionError(f"injected rpc drop at call #{at} ({op})")


def on_serve_request(op: str = "") -> Optional[str]:
    """Site ``serve`` (modes ``drop``/``delay``) — fires in the serving
    endpoint's request handler.  ``delay`` sleeps ``delay_ms`` here (a
    slow replica) and returns None; ``drop`` returns ``"drop"`` — the
    server closes the connection without a response, so the router sees
    a mid-frame peer death, exactly what a crashed replica looks like
    on the wire.  ``kill``/``evict``/``migrate*`` clauses never fire
    here (their event coordinates are the batcher step dispatch,
    :func:`on_serve_decode`, the KV block allocation,
    :func:`on_serve_evict`, and the fleet's KV-transfer boundary,
    :func:`on_serve_migrate`)."""
    plan = _active
    if plan is None:
        return None
    st = plan.site("serve")
    if st is None or st.clause.mode in ("kill", "evict") \
            or (st.clause.mode or "").startswith("migrate"):
        return None
    at = st.counter
    if st.should_fire():
        mode = st.clause.mode or "drop"
        plan.fire("serve", mode, at, op)
        if mode == "delay":
            time.sleep(st.clause.delay_ms / 1000.0)
            return None
        return "drop"
    return None


def on_serve_decode() -> bool:
    """Site ``serve`` (mode ``kill``) — fires at the continuous
    batcher's step dispatch: each event is one real decode step (or,
    on a prefill-role fleet replica, one KV-migration handoff — prefill
    replicas never dispatch decode, so the handoff is their step
    event), so ``serve:step=N,mode=kill`` reproducibly kills whichever
    replica executes the N-th dispatch in the process.  Returns True
    when the replica must die mid-stream (the batcher raises
    ``ReplicaKilled`` and fails its in-flight requests — the
    router-failover drill)."""
    plan = _active
    if plan is None:
        return False
    st = plan.site("serve")
    if st is None or st.clause.mode != "kill":
        return False
    at = st.counter
    if st.should_fire():
        plan.fire("serve", "kill", at)
        return True
    return False


def on_serve_evict() -> bool:
    """Site ``serve`` (mode ``evict``) — fires at the paged KV pool's
    block-allocation events (``serve/kv/pool.py``): each event is one
    real block allocation, so ``serve:step=N,mode=evict`` reproducibly
    applies forced page-eviction pressure at the N-th allocation in the
    process.  Returns True when the pool must evict every unreferenced
    cached block before allocating — the stale-prefix drill: an evicted
    prefix that is readmitted later must recompute, never serve stale
    blocks."""
    plan = _active
    if plan is None:
        return False
    st = plan.site("serve")
    if st is None or st.clause.mode != "evict":
        return False
    at = st.counter
    if st.should_fire():
        plan.fire("serve", "evict", at)
        return True
    return False


def on_serve_migrate() -> Optional[str]:
    """Site ``serve`` (modes ``migrate``/``migrate-drop``/
    ``migrate-delay``) — fires at the disaggregated fleet's KV-transfer
    boundary (``serve/fleet/migration.py``): each event is one
    prefill→decode KV migration, so ``serve:step=N,mode=migrate``
    reproducibly damages the N-th migration in the process.  Returns
    the mode for the sender to apply: ``migrate`` corrupts one block's
    payload AFTER the digests were computed (the receiver's per-block
    digest check must reject the transfer — the wrong-tokens-never
    drill), ``migrate-drop`` fails the transfer on the wire, and
    ``migrate-delay`` sleeps ``delay_ms`` here (a congested DCN link
    under the KV stream) and returns None."""
    plan = _active
    if plan is None:
        return None
    st = plan.site("serve")
    if st is None or not (st.clause.mode or "").startswith("migrate"):
        return None
    at = st.counter
    if st.should_fire():
        mode = st.clause.mode or "migrate"
        plan.fire("serve", mode, at)
        if mode == "migrate-delay":
            time.sleep(st.clause.delay_ms / 1000.0)
            return None
        return mode
    return None


def on_swap_pull() -> Optional[str]:
    """Site ``swap`` (modes ``corrupt-shard``/``stall``) — fires at the
    weight subscriber's shard pull (``serve/swap.py``): each event is
    one pull attempt, so ``swap:step=N,mode=corrupt-shard`` damages the
    N-th pull in the process.  ``stall`` sleeps ``delay_ms`` here (a
    slow checkpoint store — the deadline-abandon drill) and returns
    None; ``corrupt-shard`` is returned for the subscriber to apply
    AFTER the bytes were read but BEFORE its digest verification — the
    manifest describes the true content, so verification MUST reject
    the pull and the replica MUST keep serving the old weights."""
    plan = _active
    if plan is None:
        return None
    st = plan.site("swap")
    if st is None or st.clause.mode in ("kill-mid-flip", "partial-fleet"):
        return None
    at = st.counter
    if st.should_fire():
        mode = st.clause.mode or "corrupt-shard"
        plan.fire("swap", mode, at)
        if mode == "stall":
            time.sleep(st.clause.delay_ms / 1000.0)
            return None
        return mode
    return None


def on_swap_flip() -> bool:
    """Site ``swap`` (mode ``kill-mid-flip``) — fires at the batcher's
    swap barrier, the instant before the engine's param reference would
    flip: each event is one flip, so ``swap:step=N,mode=kill-mid-flip``
    reproducibly kills whichever replica executes the N-th flip in the
    process.  Returns True when the replica must die — the flip is a
    single atomic reference swap, so the dead replica is on exactly one
    version and the router fails its work over exactly as for any other
    replica death."""
    plan = _active
    if plan is None:
        return False
    st = plan.site("swap")
    if st is None or st.clause.mode != "kill-mid-flip":
        return False
    at = st.counter
    if st.should_fire():
        plan.fire("swap", "kill-mid-flip", at)
        return True
    return False


def on_swap_roll() -> bool:
    """Site ``swap`` (mode ``partial-fleet``) — fires at the fleet
    controller's rolling-swap batch boundary
    (``serve/fleet/controller.py``): each event is one batch of
    replicas about to be told to swap (one replica per event at
    ``HVD_TPU_SWAP_MAX_CONCURRENT=1``), so
    ``swap:step=N,mode=partial-fleet`` aborts the roll before its N-th
    batch.  Returns True when the roll must stop there, leaving the
    fleet mixed-version — the drill for the router's version-matched
    prefix routing (stale KV against new weights is the
    silent-wrongness bug this rule exists for)."""
    plan = _active
    if plan is None:
        return False
    st = plan.site("swap")
    if st is None or st.clause.mode != "partial-fleet":
        return False
    at = st.counter
    if st.should_fire():
        plan.fire("swap", "partial-fleet", at)
        return True
    return False


def on_qos_pick() -> bool:
    """Site ``qos`` (mode ``invert``) — fires at the WFQ scheduler's
    pop (``serve/qos/sched.py``): each event is one queue dispatch, so
    ``qos:step=N,mode=invert`` reproducibly inverts the N-th pick in
    the process — the scheduler dispatches from the LOWEST-priority
    backlogged flow instead of the highest, a priority-inversion bug
    injected on purpose.  Returns True when the pick must invert; the
    drill asserts the deadline-preemption and brownout layers still
    hold the interactive SLO through the inversion."""
    plan = _active
    if plan is None:
        return False
    st = plan.site("qos")
    if st is None or st.clause.mode != "invert":
        return False
    at = st.counter
    if st.should_fire():
        plan.fire("qos", "invert", at)
        return True
    return False


def on_qos_admit() -> bool:
    """Site ``qos`` (mode ``flood``) — fires at the admission budget
    charge (``serve/qos/policy.py`` consumers: the batcher's admission
    and the router's QoS gate): each event is one charge, so
    ``qos:step=N,mode=flood`` reproducibly waives the tenant's token
    bucket at the N-th charge — one tenant floods past its budget, and
    weighted-fair queueing must still keep the other tenants' share of
    the slots.  Returns True when the charge must be waived."""
    plan = _active
    if plan is None:
        return False
    st = plan.site("qos")
    if st is None or st.clause.mode != "flood":
        return False
    at = st.counter
    if st.should_fire():
        plan.fire("qos", "flood", at)
        return True
    return False


def on_collect(target: str = "") -> Optional[str]:
    """Site ``collect`` — fires at the fleet collector's per-replica
    scrape boundary (``obs/collector.py``): each event is one replica
    scrape attempt, so ``collect:step=N,mode=drop`` reproducibly fails
    the N-th scrape in the process.  ``drop`` raises
    ``ConnectionError`` (the replica is scrape-dead; the collector must
    record ``stats_error`` and keep the round moving); ``delay`` sleeps
    ``delay_ms`` here (a wedged replica — the round's ONE shared
    deadline must absorb it) and returns None; ``garbage`` is returned
    for the collector to substitute an unparseable payload BEFORE its
    validation — the validator must reject it, never feed garbage
    samples into the TSDB."""
    plan = _active
    if plan is None:
        return None
    st = plan.site("collect")
    if st is None:
        return None
    at = st.counter
    if st.should_fire():
        mode = st.clause.mode or "drop"
        plan.fire("collect", mode, at, target)
        if mode == "delay":
            time.sleep(st.clause.delay_ms / 1000.0)
            return None
        if mode == "garbage":
            return "garbage"
        raise ConnectionError(
            f"injected collect drop at scrape #{at} ({target})")
    return None


def on_control(mode: str) -> bool:
    """Site ``control`` — re-introduces a control-plane bug the chaos
    sim caught (the detector-proof drill; docs/observability.md).  Each
    caller names the ``mode`` it implements and only fires on a clause
    armed with exactly that mode: ``spiral`` fires at the fleet
    controller's poll (``serve/fleet/controller.py``) and makes it skip
    the shed-active scale-in guard for that poll; ``convoy`` fires at
    the sim's migration admission (``serve/fleet/sim.py``) and makes it
    skip the decode-side reservation at pick time.  Returns True when
    the caller must take the buggy path."""
    plan = _active
    if plan is None:
        return False
    st = plan.site("control")
    if st is None or st.clause.mode != mode:
        return False
    at = st.counter
    if st.should_fire():
        plan.fire("control", mode, at)
        return True
    return False


def on_checkpoint_save(step: int) -> Optional[str]:
    """Site ``checkpoint`` — fires for this checkpoint ``step`` (the
    domain step, so ``checkpoint:step=2`` targets checkpoint 2
    regardless of how many saves preceded it).  ``stall`` sleeps
    ``delay_ms`` here (a slow filesystem — on the async tier this runs
    on the writer thread, so the step loop must NOT feel it) and
    returns None; the damage modes (``corrupt``/``partial``/
    ``partial-manifest``/``crash-before-rename``) are returned for the
    store to apply at the right point of its write protocol."""
    plan = _active
    if plan is None:
        return None
    st = plan.site("checkpoint")
    if st is None:
        return None
    if st.should_fire(domain_step=step):
        mode = st.clause.mode or "corrupt"
        plan.fire("checkpoint", mode, step)
        if mode == "stall":
            time.sleep(st.clause.delay_ms / 1000.0)
            return None
        return mode
    return None


# Arm from the environment at import time so pre-init layers (the
# elastic driver, the runner's task agents) honor the spec too;
# ``hvd.init`` arms changed/programmatic specs.  A malformed spec must
# not break ``import horovod_tpu`` — it warns here and raises with the
# full message at ``hvd.init`` (config validation).
def _configure_from_env() -> None:
    import os

    spec = os.environ.get("HOROVOD_FAULT_SPEC") \
        or os.environ.get("HVD_TPU_FAULT_SPEC")
    if spec:
        try:
            configure(spec)
        except ValueError as e:
            logger.warning("ignoring malformed HVD_TPU_FAULT_SPEC at "
                           "import (%s); hvd.init() will reject it", e)


_configure_from_env()
