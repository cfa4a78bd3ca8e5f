"""Instrumentation hooks: where each layer's signals enter the registry.

Counterpart of ``horovod_tpu/obs/instrument.py``, with its whole hook
catalog (the hooks of layers the port has not reached yet included), the
reference's metric, span and label names letter for letter, and the
hot-path contract: one ``enabled()`` check, then a few dict/float ops,
no device work (no ``torch.cuda.synchronize()``), no exceptions that
could take down the path being observed.

Eager torch has no trace time, so three contracts are the port's own:

* **Plan records fire once per build of the step.**  The reference
  records its fusion, microbatch and topology plans while ``jax.jit``
  traces the step, once per trace; the port's counterpart of a trace is
  a built step (``make_train_step``'s ``build()``, the autotuner's
  rebuild): :func:`build_step` lets the first call of a build (and the
  first call on each new batch shape, where jit would retrace) record,
  and closes :func:`plans_open` for the calls that replay it, with the
  metrics on or off (the fault sites read it too).  So
  ``hvd_tpu_fusion_traces_total`` and the per-trace byte counters count
  what the reference's jitted step counts.  Outside a wrapped step (an
  eager call of ``fused_allreduce_pytree``) every call records, as the
  reference's eager calls do.
* **Stage spans fire every step.**  The topology schedule's stage spans
  (``hvd_tpu_topo_rs_intra`` / ``_xpod`` / ``_ag_intra``) wrap the eager
  stages on every step, under that step's root ``hvd_tpu_step``; the
  trace ring (``HVD_TPU_TRACE_RING``) bounds them.
* **No tracer bypass.**  A torch step is never traced inside another
  program, so :func:`wrap_step` has no bypass.  Each step mirrors its
  ``step_time_ms`` and ``tokens_per_s`` onto the live timeline's
  counter track (:func:`_timeline_counter`).

Label cardinality discipline: ``tier``/``site``/``kind``/``transition``
labels come from closed sets; the collective ``op`` label is the entry
point's kind (7 values); the retry ``what`` label is the first token of
the call-site description, not the full string.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Any, Dict, Optional

from . import metrics as _m
from . import trace as _trace

__all__ = [
    "enabled", "plans_open", "recording_plans", "record_microbatch_plan",
    "build_step", "wrap_step", "on_fusion_plan", "on_collective_dispatch",
    "on_retry",
    "on_fault", "on_elastic_reset", "on_blacklist", "on_membership_loss",
    "on_stall", "on_autotune_window", "on_autotune_apply", "autotune_log",
    "set_mfu", "set_hidden_comm_estimate", "on_topo_plan",
    "on_topo_estimator", "on_ckpt_save", "on_ckpt_write",
    "on_ckpt_restore", "on_ckpt_journal", "on_ckpt_coalesced",
    "on_ckpt_inflight", "on_qos_shed", "on_qos_preempt",
    "on_qos_budget_reject", "on_qos_brownout_level",
    "plan_compile_span", "set_plan_axes", "on_plan_relayout",
    "on_alert", "on_slo_burn", "on_collect_round",
]


# The hot-path gate, re-exported so call sites import one module.
enabled = _m.enabled


def _reg() -> _m.MetricsRegistry:
    return _m.registry()


# --- train step --------------------------------------------------------------

# Closed while a built step replays a plan its first call recorded (module
# docstring); thread-local, as the step runs on its caller's thread.
_replay = threading.local()


def plans_open() -> bool:
    """True where a plan record counts: outside a wrapped step, and on
    the first call of a build (or on a new batch shape)."""
    return not getattr(_replay, "on", False)


def recording_plans() -> bool:
    """The gate of a plan record's call site: metrics on and
    :func:`plans_open`, checked before the record's arguments are
    computed, so a replayed step pays one check."""
    return _m.enabled() and plans_open()


@contextlib.contextmanager
def _replaying(on: bool):
    prev = getattr(_replay, "on", False)
    _replay.on = on
    try:
        yield
    finally:
        _replay.on = prev


def _leaves(batch) -> list:
    from ..optim.distributed_optimizer import _batch_leaves

    return _batch_leaves(batch)


def _batch_rows_tokens(batch) -> "tuple[int, int]":
    """(rows, tokens) from the batch's first tensor (the reference's
    flatten order): rows = leading dim; tokens = rows x seq when it is
    at least 2-D (the LM convention), else rows.  The port's batch is
    this rank's rows."""
    leaves = _leaves(batch)
    if not leaves:
        return 0, 0
    shape = tuple(leaves[0].shape)
    rows = int(shape[0]) if len(shape) >= 1 else 1
    tokens = rows * int(shape[1]) if len(shape) >= 2 else rows
    return rows, tokens


def _signature(batch) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in _leaves(batch))


def _first_of_shape(traced: set, batch) -> bool:
    """True on a build's first call with ``batch``'s shapes (where jit
    would trace); notes the shapes."""
    sig = _signature(batch)
    first = sig not in traced
    traced.add(sig)
    return first


def build_step(step_fn, *, kind: str = "train"):
    """A built step: :func:`wrap_step` when metrics are on, else
    ``step_fn`` behind the build boundary alone, so :func:`plans_open`
    (which the fault sites read) closes on replays whether or not
    metrics are on."""
    if _m.enabled():
        return wrap_step(step_fn, kind=kind)
    traced: set = set()

    def bounded_step(model, batch, *rest):
        with _replaying(not _first_of_shape(traced, batch)):
            return step_fn(model, batch, *rest)

    bounded_step.__wrapped__ = step_fn
    return bounded_step


def wrap_step(step_fn, *, kind: str = "train"):
    """Wrap a built train step ``step(model, batch, *rest)`` with per-call
    accounting: a step-time histogram, step/sample/token counters, a
    tokens/s gauge, one root span ``hvd_tpu_step`` a call, and the
    topology estimator's feed.

    The recorded time is dispatch-to-dispatch wall time on the host: no
    hook waits for the device.  Once a step launches more work than the
    CUDA launch queue holds, the host blocks on the queue and the time
    converges to the device's step time.

    The first call (and the first on each new batch shape) records the
    step's plans; later calls replay them with :func:`plans_open` False
    (module docstring).  Returns ``step_fn`` unchanged when metrics are
    off."""
    if not _m.enabled():
        return step_fn

    reg = _reg()
    hist = reg.histogram(
        "hvd_tpu_step_time_seconds",
        "train-step dispatch-to-dispatch wall time").labels(kind=kind)
    steps = reg.counter("hvd_tpu_steps_total",
                        "train steps dispatched").labels(kind=kind)
    samples = reg.counter("hvd_tpu_samples_total",
                          "global batch rows consumed")
    tokens = reg.counter("hvd_tpu_tokens_total",
                         "tokens consumed (rows x seq for >=2-D batches)")
    rate = reg.gauge("hvd_tpu_tokens_per_s",
                     "instantaneous tokens/s of the last step")

    step_seq = itertools.count()
    traced: set = set()

    def instrumented_step(model, batch, *rest):
        replay = not _first_of_shape(traced, batch)
        t0 = time.perf_counter()
        # One trace per step (docs/tracing.md): the root every span this
        # call causes parents under.
        with _trace.span("hvd_tpu_step", root=True,
                         args={"kind": kind, "step": next(step_seq)}):
            with _replaying(replay):
                out = step_fn(model, batch, *rest)
        dt = time.perf_counter() - t0
        rows, toks = _batch_rows_tokens(batch)
        hist.observe(dt)
        steps.inc()
        samples.inc(rows)
        tokens.inc(toks)
        if dt > 0:
            rate.set(toks / dt)
        _timeline_counter("train" if kind == "train" else kind, {
            "step_time_ms": dt * 1e3,
            "tokens_per_s": (toks / dt) if dt > 0 else 0.0,
        })
        _refine_topo_estimator(dt)
        return out

    instrumented_step._hvd_tpu_instrumented = True  # introspection/tests
    instrumented_step.__wrapped__ = step_fn
    return instrumented_step


def _timeline_counter(name: str, values: Dict[str, float]) -> None:
    """Mirror gauges onto the live timeline's counter track (nothing
    when no timeline is open)."""
    from .. import basics

    tl = basics.peek("timeline")   # fail-soft: None pre-init
    if tl is not None and tl.enabled:
        tl.counter(name, values)


def set_hidden_comm_estimate(wire_us: float, hidden_us: float) -> None:
    """Record a hidden-communication estimate computed outside a full
    schedule plan (``fusion.estimate_overlap_hidden_fraction`` — the
    microbatch overlap wire's model, where per-microbatch compute time
    is known: the benches' FLOPs-based path)."""
    if not _m.enabled():
        return
    reg = _reg()
    reg.gauge("hvd_tpu_est_wire_cost_us",
              "cost-model makespan of the latest schedule").set(wire_us)
    reg.gauge("hvd_tpu_est_hidden_us",
              "cost-model wire time hidden under compute").set(hidden_us)
    if wire_us > 0:
        reg.gauge("hvd_tpu_hidden_comm_frac",
                  "hidden / total modeled wire time").set(
                      hidden_us / wire_us)


def set_mfu(pct: float) -> None:
    """Record model-FLOPs utilization, computed where the FLOPs are
    known (``utils.mfu`` via the benchmarks' AOT-compiled cost)."""
    if not _m.enabled():
        return
    _reg().gauge("hvd_tpu_mfu_pct",
                 "model FLOPs utilization, percent of chip peak").set(pct)


def record_microbatch_plan(mb: int, *, overlap: bool) -> None:
    """Plan record of the accumulation schedule the step was built with
    (``_microbatch_grads``), once per build."""
    if not recording_plans():
        return
    reg = _reg()
    reg.gauge("hvd_tpu_microbatches",
              "gradient-accumulation microbatches per step").set(mb)
    reg.gauge("hvd_tpu_overlap_reduce",
              "1 when the microbatch wire is overlap-scheduled").set(
                  1.0 if overlap else 0.0)


def _refine_topo_estimator(step_time_s: float) -> None:
    """Feed one finished step into the topo cost estimator (the online
    α/β refinement loop of docs/topology.md).  No-op — one module
    check — unless a topo schedule compiled this step's wire."""
    from ..topo import costmodel as _topo_cost

    est = _topo_cost._estimator
    if est is not None:
        est.refine_from_step(step_time_s)


# --- ops: fusion planner + collectives dispatch ------------------------------

def on_fusion_plan(tier: str, *, bytes_on_wire: int, buckets: int,
                   compression_ratio: Optional[float] = None,
                   est_cost_us: Optional[float] = None,
                   est_hidden_us: Optional[float] = None) -> None:
    """Plan record from the fusion layer, once per build.  ``tier`` is
    the wire that was planned (``spmd`` single-phase, ``two_phase``,
    ``overlap``, ``schedule``); counters accumulate planned bytes per
    build (the step then replays the plan every call), gauges hold the
    latest per-step plan."""
    if not recording_plans():
        return
    reg = _reg()
    reg.counter("hvd_tpu_wire_bytes_total",
                "bytes put on the wire, by tier (host tier: per "
                "dispatch; SPMD tiers: per trace — the compiled plan "
                "replays each step)").labels(tier=tier).inc(bytes_on_wire)
    reg.counter("hvd_tpu_fusion_traces_total",
                "fusion plans built, by tier").labels(tier=tier).inc()
    reg.gauge("hvd_tpu_wire_bytes_per_step",
              "planned wire bytes per step, by tier").labels(
                  tier=tier).set(bytes_on_wire)
    reg.gauge("hvd_tpu_fusion_buckets",
              "buckets in the latest fusion plan, by tier").labels(
                  tier=tier).set(buckets)
    if compression_ratio is not None:
        reg.gauge("hvd_tpu_compression_ratio",
                  "wire bytes / exact bytes of the latest plan").set(
                      compression_ratio)
    if est_cost_us is not None:
        reg.gauge("hvd_tpu_est_wire_cost_us",
                  "cost-model makespan of the latest schedule").set(
                      est_cost_us)
    if est_hidden_us is not None:
        reg.gauge("hvd_tpu_est_hidden_us",
                  "cost-model wire time hidden under compute").set(
                      est_hidden_us)
        if est_cost_us:
            reg.gauge("hvd_tpu_hidden_comm_frac",
                      "hidden / total modeled wire time").set(
                          est_hidden_us / est_cost_us)


def on_collective_dispatch(op: str, nbytes: int) -> None:
    """Eager-API dispatch accounting (``ops/collectives.py``'s public
    entry points): one event per dispatch, with this rank's payload
    bytes."""
    if not _m.enabled():
        return
    reg = _reg()
    reg.counter("hvd_tpu_collective_dispatch_total",
                "slot-tier collective dispatches, by op").labels(
                    op=op).inc()
    if nbytes > 0:
        reg.counter("hvd_tpu_wire_bytes_total", "").labels(
            tier="slots").inc(nbytes)


# --- topology-aware scheduling (horovod_tpu/topo/) ---------------------------

def on_topo_plan(algo_buckets: Dict[str, int], *,
                 tier_bytes: Dict[str, int],
                 est_cost_us: Dict[str, float],
                 kernels: Optional[Dict[str, int]] = None,
                 hbm_materializations: Optional[int] = None) -> None:
    """Plan record of one compiled topo plan (all buckets of one fused
    apply), once per build: per-tier wire bytes (counters accumulate per
    build,
    like the fusion tiers; the compiled program replays the plan every
    step), the cost model's per-tier makespan, the per-algorithm
    bucket counts (``algo`` labels come from the closed
    flat/two_phase/hierarchical set), the per-lowering-backend bucket
    counts (``kernel`` ∈ {spmd, pallas}) and the plan's structural HBM
    intermediate count (the fused-collective tier's TPU-side win,
    asserted by structure since the CPU bench can't time HBM)."""
    if not recording_plans():
        return
    reg = _reg()
    for algo, buckets in algo_buckets.items():
        reg.counter("hvd_tpu_topo_schedules_total",
                    "topo schedules compiled, by algorithm").labels(
                        algo=algo).inc(buckets)
    for kern, buckets in (kernels or {}).items():
        reg.counter("hvd_tpu_topo_kernel_schedules_total",
                    "topo schedules compiled, by lowering backend").labels(
                        kernel=kern).inc(buckets)
    if hbm_materializations is not None:
        reg.gauge("hvd_tpu_topo_hbm_materializations",
                  "standalone HBM intermediates the latest topo plan "
                  "materializes around its compressed collectives "
                  "(0 for fused ICI steps)").set(hbm_materializations)
    for tier, nbytes in tier_bytes.items():
        reg.counter("hvd_tpu_topo_wire_bytes_total",
                    "bytes the compiled topo schedule puts on each "
                    "tier's wire (per trace; the program replays the "
                    "plan every step)").labels(tier=tier).inc(nbytes)
        reg.gauge("hvd_tpu_topo_wire_bytes_per_step",
                  "latest topo plan's per-step bytes, by tier").labels(
                      tier=tier).set(nbytes)
    for tier, cost in est_cost_us.items():
        reg.gauge("hvd_tpu_topo_est_cost_us",
                  "cost-model makespan of the latest topo schedule, "
                  "by tier").labels(tier=tier).set(cost)


def on_topo_estimator(tier: str, alpha_us: float,
                      beta_gbps: float) -> None:
    """The online estimator's current per-tier α/β point
    (``topo/costmodel.OnlineEstimator``)."""
    if not _m.enabled():
        return
    reg = _reg()
    reg.gauge("hvd_tpu_topo_cost_alpha_us",
              "estimated per-hop launch latency, by tier").labels(
                  tier=tier).set(alpha_us)
    reg.gauge("hvd_tpu_topo_cost_beta_gbps",
              "estimated per-hop bandwidth, by tier").labels(
                  tier=tier).set(beta_gbps)


# --- mesh plan (horovod_tpu/plan/; docs/mesh_plan.md) ------------------------

def plan_compile_span(spec: str):
    """Span around one :func:`plan.compile_plan` build — mesh
    construction plus per-axis process-set registration.  Rooted: plan
    compiles happen at init and at autotune re-layout boundaries, never
    inside a step dispatch."""
    return _trace.span("hvd_tpu_plan_compile", root=True,
                       args={"spec": spec})


def set_plan_axes(axes: Dict[str, int]) -> None:
    """Publish the live plan's axis sizes (one gauge series per declared
    axis — the closed MESH_AXES set bounds cardinality).  Stale axes
    from a previous layout keep their last value; the relayout counter
    marks which scrape windows straddle a flip."""
    if not _m.enabled():
        return
    reg = _reg()
    for axis, size in axes.items():
        reg.gauge("hvd_tpu_plan_axes",
                  "live mesh-plan axis sizes, by axis").labels(
                      axis=axis).set(size)


def on_plan_relayout() -> None:
    """One autotune layout flip: the session plan was rebuilt (new mesh
    factorization + process sets) at a re-jit boundary."""
    if not _m.enabled():
        return
    _reg().counter("hvd_tpu_plan_relayouts_total",
                   "mesh-plan layout rebuilds (autotune re-jit "
                   "boundaries)").inc()


# --- durable state (horovod_tpu/ckpt/; docs/checkpointing.md) ----------------

def on_ckpt_save(stall_us: float, nbytes: int, inflight: int) -> None:
    """One save's caller-visible cost: the stall the step loop paid
    (async tier: the device→host snapshot; sync tier: the whole write),
    the snapshot bytes offloaded, and the writer queue depth after
    enqueue."""
    if not _m.enabled():
        return
    reg = _reg()
    reg.histogram("hvd_tpu_ckpt_save_stall_us",
                  "wall time a checkpoint save billed the caller "
                  "(async: one device->host snapshot)").observe(stall_us)
    if nbytes > 0:
        reg.counter("hvd_tpu_ckpt_bytes_total",
                    "checkpoint bytes moved, by kind (snapshot = "
                    "device->host offload, write = shard files to "
                    "disk, restore = shard bytes read, journal = "
                    "step-metadata appends)").labels(
                        kind="snapshot").inc(nbytes)
    reg.gauge("hvd_tpu_ckpt_inflight",
              "checkpoint writer queue depth (queued + writing)").set(
                  inflight)


def on_ckpt_write(write_us: float, nbytes: int) -> None:
    """One background write's wall time + bytes (writer thread)."""
    if not _m.enabled():
        return
    reg = _reg()
    reg.histogram("hvd_tpu_ckpt_write_us",
                  "background checkpoint write wall time (shard files "
                  "+ manifest + fsync)").observe(write_us)
    if nbytes > 0:
        reg.counter("hvd_tpu_ckpt_bytes_total", "").labels(
            kind="write").inc(nbytes)


def on_ckpt_restore(nbytes: int) -> None:
    """Bytes one restore actually moved (a sharded N→N′ restore moves
    only the leaves the rank owns — this is the number that proves it)."""
    if not _m.enabled():
        return
    if nbytes > 0:
        _reg().counter("hvd_tpu_ckpt_bytes_total", "").labels(
            kind="restore").inc(nbytes)


def on_ckpt_journal(nbytes: int) -> None:
    """One fsync'd journal append."""
    if not _m.enabled():
        return
    _reg().counter("hvd_tpu_ckpt_bytes_total", "").labels(
        kind="journal").inc(nbytes)


def on_ckpt_coalesced() -> None:
    """A queued save was dropped to admit a newer one (the disk is
    slower than the save cadence; newest state wins)."""
    if not _m.enabled():
        return
    _reg().counter("hvd_tpu_ckpt_coalesced_total",
                   "queued checkpoint saves coalesced away "
                   "(drop-oldest-unwritten)").inc()


def on_ckpt_inflight(depth: int) -> None:
    """Writer queue depth after a write retired."""
    if not _m.enabled():
        return
    _reg().gauge("hvd_tpu_ckpt_inflight", "").set(depth)


# --- recovery layers ---------------------------------------------------------

def on_retry(what: str) -> None:
    """One retry attempt (``utils.retry.retry_call``).  ``what`` is the
    first token of the call-site description — a closed set (``rpc``,
    ``discovery``, ``restore``...), not the full free-form string."""
    if not _m.enabled():
        return
    _reg().counter("hvd_tpu_retries_total",
                   "retry attempts, by call-site family").labels(
                       what=(what.split() or ["call"])[0]).inc()


def on_fault(site: str) -> None:
    """One injected-fault firing (``faults.FaultPlan.fire``)."""
    if not _m.enabled():
        return
    _reg().counter("hvd_tpu_faults_fired_total",
                   "injected fault firings, by site").labels(
                       site=site).inc()


def on_elastic_reset(kind: str) -> None:
    """One elastic reset (``rollback`` on HorovodInternalError,
    ``resize`` on HostsUpdatedInterrupt)."""
    if not _m.enabled():
        return
    _reg().counter("hvd_tpu_elastic_resets_total",
                   "elastic resets, by cause").labels(kind=kind).inc()


def on_blacklist(transition: str) -> None:
    """Host blacklist lifecycle (``elastic.driver``): ``blacklisted``,
    ``probation`` (decay half-open), ``cleared`` (success after
    probation)."""
    if not _m.enabled():
        return
    _reg().counter("hvd_tpu_host_blacklist_total",
                   "host blacklist transitions").labels(
                       transition=transition).inc()


def on_membership_loss(hosts: int) -> None:
    """Discovery declared membership lost (K consecutive failures);
    ``hosts`` is the fleet size that was dropped."""
    if not _m.enabled():
        return
    reg = _reg()
    reg.counter("hvd_tpu_discovery_membership_loss_total",
                "discovery membership-loss events").inc()
    reg.gauge("hvd_tpu_discovery_lost_hosts",
              "host count at the last membership loss").set(hosts)


def on_stall(kind: str) -> None:
    """Stall-inspector escalation: ``warn`` or ``shutdown``."""
    if not _m.enabled():
        return
    _reg().counter("hvd_tpu_stall_events_total",
                   "stall-inspector escalations").labels(kind=kind).inc()


# --- paged KV serving (serve/kv/; docs/serving.md) ---------------------------

def on_kv_blocks_in_use(n: int) -> None:
    """Referenced-block count after any pool mutation (the serving
    occupancy signal the "add replicas" decision reads)."""
    if not _m.enabled():
        return
    _reg().gauge("hvd_tpu_serve_kv_blocks_in_use",
                 "KV pool blocks referenced by active requests").set(n)


def on_kv_evictions(n: int = 1) -> None:
    """``n`` cached prefix blocks evicted under allocation pressure
    (or the ``serve:mode=evict`` fault)."""
    if not _m.enabled():
        return
    _reg().counter("hvd_tpu_serve_kv_evictions_total",
                   "KV blocks evicted from the prefix cache").inc(n)


def on_kv_prefix_hit() -> None:
    """One admission whose prompt prefix was resident (skipped
    prefill compute)."""
    if not _m.enabled():
        return
    _reg().counter("hvd_tpu_serve_kv_prefix_hits_total",
                   "admissions that hit a resident prompt prefix").inc()


def on_kv_cow_copy() -> None:
    """One copy-on-write block copy (first divergent write into a
    shared block)."""
    if not _m.enabled():
        return
    _reg().counter("hvd_tpu_serve_kv_cow_copies_total",
                   "copy-on-write KV block copies").inc()


def on_spec_accept_ratio(ratio: float) -> None:
    """Speculative decoding's rolling accepted-tokens-per-verify-step
    ratio (1.0 = drafts never accepted = plain decode cadence)."""
    if not _m.enabled():
        return
    _reg().gauge("hvd_tpu_serve_spec_accepted_ratio",
                 "emitted tokens per speculative verify step").set(ratio)


# --- disaggregated serving fleet (serve/fleet/; docs/serving.md) -------------

def on_fleet_migration(nbytes: int, ok: bool, ms: float) -> None:
    """One prefill→decode KV migration attempt: outcome-labelled count,
    payload bytes (only successful transfers bill the wire), and the
    per-migration latency gauge the bench reads."""
    if not _m.enabled():
        return
    reg = _reg()
    reg.counter("hvd_tpu_fleet_migrations_total",
                "prefill->decode KV migrations").labels(
                    outcome="ok" if ok else "failed").inc()
    if ok:
        reg.counter("hvd_tpu_fleet_migrated_bytes_total",
                    "KV bytes moved prefill->decode").inc(nbytes)
        reg.gauge("hvd_tpu_fleet_migrate_ms",
                  "last KV migration's wall time").set(ms)


def on_fleet_directory_hit() -> None:
    """One request routed to resident KV by the global prefix
    directory (a cache hit anywhere in the fleet)."""
    if not _m.enabled():
        return
    _reg().counter("hvd_tpu_fleet_directory_hits_total",
                   "requests routed by the global prefix "
                   "directory").inc()


def on_fleet_scale_event(direction: str) -> None:
    """One elastic fleet action: ``direction`` is ``out`` (replica
    launched) or ``in`` (replica drained and retired)."""
    if not _m.enabled():
        return
    _reg().counter("hvd_tpu_fleet_scale_events_total",
                   "fleet controller scale actions").labels(
                       direction=direction).inc()


def on_fleet_role_occupancy(role: str, occupancy: float,
                            replicas: int) -> None:
    """Per-role fleet load after a controller poll: mean slot
    occupancy and live replica count for one role class."""
    if not _m.enabled():
        return
    reg = _reg()
    reg.gauge("hvd_tpu_fleet_role_occupancy",
              "mean slot occupancy per replica role").labels(
                  role=role).set(occupancy)
    reg.gauge("hvd_tpu_fleet_replicas",
              "live replicas per role").labels(role=role).set(replicas)


# --- zero-downtime weight hot-swap (serve/swap.py; docs/hot_swap.md) ---------

def on_swap(outcome: str, ms: float = 0.0, nbytes: int = 0) -> None:
    """One hot-swap attempt's terminal outcome: ``ok`` (fleet serving
    the new version), ``rejected`` (digest/manifest verification failed
    — old weights kept), ``abandoned`` (pull past the deadline — old
    weights kept) or ``failed`` (flip never ran: replica died / barrier
    error).  ``ms`` is the store-newer→flipped wall time (successes
    only); ``nbytes`` bills the shard bytes actually pulled, whatever
    the outcome — a swap retry loop's wasted wire is an operator
    signal."""
    if not _m.enabled():
        return
    reg = _reg()
    reg.counter("hvd_tpu_swap_total",
                "weight hot-swap attempts").labels(outcome=outcome).inc()
    if nbytes:
        reg.counter("hvd_tpu_swap_bytes_pulled_total",
                    "shard bytes pulled by weight hot-swaps").inc(nbytes)
    if outcome == "ok":
        reg.gauge("hvd_tpu_swap_ms",
                  "last successful hot-swap's wall time").set(ms)


def on_weights_version(version: int) -> None:
    """The serving version this replica flipped to (the checkpoint
    step number) — scraped per replica, a mixed-version fleet is
    visible as divergent gauge values."""
    if not _m.enabled():
        return
    _reg().gauge("hvd_tpu_replica_weights_version",
                 "checkpoint step this replica's weights came "
                 "from").set(version)


# --- multi-tenant QoS scheduling (serve/qos/; docs/qos.md) -------------------

def on_qos_shed(qos_class: str) -> None:
    """One request shed by the brownout ladder; ``qos_class`` comes
    from the closed QOS_CLASSES set (interactive is structurally
    absent — the ladder cannot shed it)."""
    if not _m.enabled():
        return
    _reg().counter("hvd_tpu_qos_sheds_total",
                   "requests shed by the brownout ladder, by "
                   "class").labels(cls=qos_class).inc()


def on_qos_preempt() -> None:
    """One batch generation evicted-and-requeued so an interactive
    request makes its deadline (serve/qos/preempt.py)."""
    if not _m.enabled():
        return
    _reg().counter("hvd_tpu_qos_preemptions_total",
                   "batch generations preempted for interactive "
                   "deadlines").inc()


def on_qos_budget_reject(tenant: str) -> None:
    """One admission rejected by a tenant's token budget.  The
    ``tenant`` label is open-ended by nature — it rides the registry's
    64-series cardinality cap (overflow collapses to ``other``), the
    contract hvdlint's tenant-cardinality check enforces."""
    if not _m.enabled():
        return
    _reg().counter("hvd_tpu_qos_budget_rejects_total",
                   "admissions rejected by per-tenant token "
                   "budgets").labels(tenant=tenant).inc()


def on_qos_brownout_level(level: int) -> None:
    """The brownout ladder's current level (0 = full service, 1 = batch
    shed, 2 = batch + standard shed)."""
    if not _m.enabled():
        return
    _reg().gauge("hvd_tpu_qos_brownout_level",
                 "brownout shed-ladder level").set(level)


# --- fleet chaos simulator (serve/fleet/sim.py; docs/fleet_sim.md) -----------


def on_sim_run(events: int, checks: int, violations: int) -> None:
    """One completed fleet-simulation run: events processed, invariant
    checks evaluated, and violations found (the number that must stay
    zero — bench_regress gates it with zero tolerance)."""
    if not _m.enabled():
        return
    reg = _reg()
    reg.counter("hvd_tpu_sim_events_total",
                "discrete events processed by fleet-sim runs").inc(
                    events)
    reg.counter("hvd_tpu_sim_invariant_checks_total",
                "SLO invariant checks evaluated by fleet-sim "
                "runs").inc(checks)
    reg.counter("hvd_tpu_sim_invariant_violations_total",
                "SLO invariant violations found by fleet-sim "
                "runs").inc(violations)
    reg.gauge("hvd_tpu_sim_last_violations",
              "invariant violations in the most recent fleet-sim "
              "run").set(violations)


# --- fleet telemetry plane (obs/collector.py; docs/observability.md) ---------


def on_collect_round(ok: int, total: int, staleness_s: float) -> None:
    """One completed fleet scrape round: replicas that answered, the
    roster size, and the scrape plane's own data staleness (how old the
    newest successful scrape is — the gauge operators watch when the
    COLLECTOR, not the fleet, is what's dying)."""
    if not _m.enabled():
        return
    reg = _reg()
    reg.counter("hvd_tpu_collect_rounds_total",
                "fleet telemetry scrape rounds completed").inc()
    reg.counter("hvd_tpu_collect_scrapes_total",
                "per-replica scrape attempts, by outcome").labels(
                    outcome="ok").inc(ok)
    if total - ok > 0:
        reg.counter("hvd_tpu_collect_scrapes_total",
                    "per-replica scrape attempts, by outcome").labels(
                        outcome="error").inc(total - ok)
    reg.gauge("hvd_tpu_collect_staleness_seconds",
              "age of the newest successful replica scrape").set(
                  staleness_s)


def on_slo_burn(slo: str, burn: float) -> None:
    """The long-window burn rate of one SLO after an evaluation round
    (1.0 = exactly consuming the error budget at the sustainable
    rate).  The ``slo`` label comes from the parsed HVD_TPU_SLO_SPEC
    catalog — operator-bounded cardinality."""
    if not _m.enabled():
        return
    _reg().gauge("hvd_tpu_slo_burn_rate",
                 "long-window error-budget burn rate per SLO").labels(
                     slo=slo).set(burn)


def on_alert(alert: str, severity: str) -> None:
    """One alert FIRING edge from the telemetry plane (SLO burn or
    invariant detector; episode-deduplicated by the sink — a
    still-firing alert increments once per episode, not per round).
    ``alert`` comes from the detector/SLO catalogs
    (docs/observability.md), ``severity`` from the closed
    page/ticket set."""
    if not _m.enabled():
        return
    _reg().counter("hvd_tpu_alerts_total",
                   "telemetry-plane alert firings, by alert and "
                   "severity").labels(alert=alert,
                                      severity=severity).inc()


# --- autotune decision log ---------------------------------------------------

# Bounded decision log: the JSON snapshot carries it verbatim (the
# Prometheus surface gets only the counters/gauges — a log is not a
# time series).
_autotune_log: "collections.deque" = collections.deque(maxlen=64)


def on_autotune_window(samples_per_s: float,
                       suggestion: Optional[Dict[str, Any]]) -> None:
    """One scored autotune window and the manager's response."""
    if not _m.enabled():
        return
    reg = _reg()
    reg.counter("hvd_tpu_autotune_windows_total",
                "scored autotune windows").inc()
    reg.gauge("hvd_tpu_autotune_samples_per_s",
              "last scored window's samples/s").set(samples_per_s)
    if suggestion is not None:
        reg.counter("hvd_tpu_autotune_proposals_total",
                    "autotune knob proposals").inc()
    _autotune_log.append({
        "event": "window",
        "samples_per_s": round(float(samples_per_s), 3),
        "proposal": dict(suggestion) if suggestion is not None else None,
    })


def on_autotune_apply(applied: Dict[str, Any], frozen: bool) -> None:
    """A proposal was installed (re-jit boundary); ``frozen`` marks the
    terminal freeze at the best point."""
    if not _m.enabled():
        return
    reg = _reg()
    reg.counter("hvd_tpu_autotune_applied_total",
                "autotune proposals applied (re-jits)").inc()
    reg.gauge("hvd_tpu_autotune_frozen",
              "1 once the tuner froze at its best point").set(
                  1.0 if frozen else 0.0)
    for knob, value in applied.items():
        try:
            v = float(value)
        except (TypeError, ValueError):
            continue
        reg.gauge("hvd_tpu_autotune_knob",
                  "last applied autotune knob value").labels(
                      knob=knob).set(v)
    _autotune_log.append({
        "event": "freeze" if frozen else "apply",
        "applied": dict(applied),
    })


def autotune_log() -> list:
    """Copy of the bounded decision log (JSON snapshot payload)."""
    return list(_autotune_log)
