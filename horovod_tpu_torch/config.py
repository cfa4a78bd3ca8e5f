"""Runtime knobs read from the environment at :func:`basics.init`.

Counterpart of ``horovod_tpu/config.py``, holding only the knobs this
port reads.  Each knob is looked up as ``HOROVOD_<NAME>`` first, then
``HVD_TPU_<NAME>``, as the reference resolves them.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off", "")
COMPRESSIONS = ("none", "fp16", "bf16", "int8")
# Schedule algorithms the topology compiler can emit or be pinned to
# (HVD_TPU_TOPO_SCHEDULE), and the lowering backends a compiled
# schedule records (HVD_TPU_TOPO_KERNEL; the port lowers both onto its
# one int8 wire, see topo/schedule.py).
TOPO_SCHEDULES = ("off", "auto", "flat", "two_phase", "hierarchical")
TOPO_KERNELS = ("spmd", "pallas")

# The α–β cost model's defaults (per-collective launch latency in µs,
# per-hop wire bandwidth in GB/s), shared with the planner's fallbacks
# before init (ops/fusion.py).
DEFAULT_COST_ALPHA_US = 10.0
DEFAULT_COST_BETA_GBPS = 100.0


def _env(name: str) -> Optional[str]:
    """Look up ``HOROVOD_<name>`` then ``HVD_TPU_<name>``."""
    for prefix in ("HOROVOD_", "HVD_TPU_"):
        val = os.environ.get(prefix + name)
        if val is not None:
            return val
    return None


def _env_bool(name: str, default: bool) -> bool:
    val = _env(name)
    if val is None:
        return default
    if val.strip().lower() in _TRUE:
        return True
    if val.strip().lower() in _FALSE:
        return False
    raise ValueError(f"Boolean env var {name!r} has unparseable value {val!r}")


def _env_int(name: str, default: int) -> int:
    val = _env(name)
    if val is None:
        return default
    try:
        return int(val)
    except ValueError as e:
        raise ValueError(
            f"Integer env var {name!r} has unparseable value {val!r}") from e


def _env_pos_int(name: str, default: int) -> int:
    """Like :func:`_env_int` but the value must be >= 1 (count knobs
    where 0 would silently disable a requested feature)."""
    v = _env_int(name, default)
    if v < 1:
        raise ValueError(f"Env var {name!r} must be >= 1, got {v}")
    return v


def _env_float(name: str, default: float) -> float:
    val = _env(name)
    if val is None:
        return default
    try:
        return float(val)
    except ValueError as e:
        raise ValueError(
            f"Float env var {name!r} has unparseable value {val!r}") from e


def _env_opt_int(name: str) -> Optional[int]:
    """Like :func:`_env_int` but unset stays None (knobs where unset and
    any explicit value mean different things)."""
    if _env(name) is None:
        return None
    return _env_int(name, 0)


def _env_straggler_factor() -> float:
    """``HVD_TPU_STRAGGLER_FACTOR`` must exceed 1: at <= 1x the world
    median, half the world (or all of it) is "straggling" by
    definition, a misconfiguration that must fail at init."""
    v = _env_float("STRAGGLER_FACTOR", 2.0)
    if v <= 1.0:
        raise ValueError(
            f"Env var 'STRAGGLER_FACTOR' must be > 1.0 (a rank is a "
            f"straggler when its step time exceeds factor x the world "
            f"median), got {v}")
    return v


def _env_choice(name: str, default: Optional[str], choices) -> Optional[str]:
    """Enumerated string knob; a typo'd value fails at init."""
    val = _env(name)
    if val is None:
        return default
    val = val.strip().lower()
    if val not in choices:
        raise ValueError(f"Env var {name!r} has unknown value {val!r}; "
                         f"expected one of {choices}")
    return val


def parse_topo_spec(spec: str) -> Tuple[int, int]:
    """Parse ``HVD_TPU_TOPO_SPEC`` (``PODSxCHIPS``, e.g. ``2x4``: two
    pods, here nodes, of four ranks each, pods contiguous in rank order)
    into ``(pods, chips_per_pod)``.  Raises ``ValueError`` on anything but
    two positive integers joined by ``x``: a malformed topology must not
    silently run flat."""
    body = spec.strip().lower()
    pods_s, sep, chips_s = body.partition("x")
    if not sep or not pods_s.strip() or not chips_s.strip():
        raise ValueError(
            f"topo spec: expected PODSxCHIPS (e.g. '4x8'), got {spec!r}")
    try:
        pods, chips = int(pods_s.strip()), int(chips_s.strip())
    except ValueError as e:
        raise ValueError(
            f"topo spec: expected PODSxCHIPS with integer factors, got "
            f"{spec!r}") from e
    if pods < 1 or chips < 1:
        raise ValueError(
            f"topo spec: factors must be >= 1, got {pods}x{chips}")
    return pods, chips


def _validated_topo_spec(spec: Optional[str]) -> Optional[str]:
    """Empty or unset: None; anything else must parse (fails at init)."""
    if not spec or not spec.strip():
        return None
    parse_topo_spec(spec)
    return spec


# --- mesh-plan axis grammar (HVD_TPU_MESH_PLAN) ------------------------------
# ``axis=size,axis=size``, e.g. ``data=4,fsdp=2``: a 2-D layout over the
# ranks.  The catalog is the closed namespace of axis names: the
# planner's axes (``data``/``fsdp``/``tensor``/``pipe``/``expert``, the
# MeshPlan vocabulary of plan/) and the short names of parallel/
# (``hvd`` for the 1-D world, ``dp``/``tp``/``sp``/``pp``/``ep``).
MESH_AXES = ("data", "fsdp", "tensor", "pipe", "expert",
             "hvd", "dp", "tp", "sp", "pp", "ep")


def parse_mesh_plan(spec: str,
                    world_size: Optional[int] = None) -> "dict[str, int]":
    """Parse ``HVD_TPU_MESH_PLAN`` (``data=4,fsdp=2``) into an ordered
    ``{axis: size}`` map.  Axis names must come from :data:`MESH_AXES`;
    sizes must be positive ints; an axis may appear once.  With
    ``world_size`` the sizes must factor the rank count exactly: a plan
    that silently dropped ranks would be a wrong-answer wire."""
    out: "dict[str, int]" = {}
    for raw in spec.split(","):
        raw = raw.strip()
        if not raw:
            continue
        key, sep, val = raw.partition("=")
        key, val = key.strip(), val.strip()
        if not sep or not key or not val:
            raise ValueError(
                f"mesh plan: expected axis=size entries, got {raw!r}")
        if key not in MESH_AXES:
            raise ValueError(
                f"mesh plan: unknown axis {key!r}; expected one of "
                f"{MESH_AXES}")
        if key in out:
            raise ValueError(
                f"mesh plan: axis {key!r} appears twice — each axis "
                f"names one disjoint factor of the device set")
        try:
            size = int(val)
        except ValueError as e:
            raise ValueError(
                f"mesh plan: bad size {val!r} for axis {key!r}") from e
        if size < 1:
            raise ValueError(
                f"mesh plan: size for axis {key!r} must be >= 1, "
                f"got {size}")
        out[key] = size
    if not out:
        raise ValueError("mesh plan: empty spec (expected e.g. "
                         "'data=4,fsdp=2')")
    if world_size is not None:
        prod = 1
        for size in out.values():
            prod *= size
        if prod != world_size:
            raise ValueError(
                f"mesh plan: axis sizes {dict(out)} multiply to {prod} "
                f"but the mesh has {world_size} devices — the plan must "
                f"factor the device count exactly (e.g. "
                f"'data={world_size}' or a divisor split)")
    return out


def _validated_mesh_plan(spec: Optional[str]) -> Optional[str]:
    """Empty or unset: None; anything else must parse (fails at init).
    Whether it factors the world is checked when the plan is built."""
    if not spec or not spec.strip():
        return None
    parse_mesh_plan(spec)
    return spec


# --- fault-injection spec grammar (HVD_TPU_FAULT_SPEC) ----------------------
# ``site:key=val,key=val;site2:...``: one clause per injection site
# (faults.py threads the sites through the layers).  Parsed here so a
# typo'd spec fails at init, like every other malformed knob.

FAULT_SITES = ("collective", "fusion", "accumulate", "discovery", "rpc",
               "checkpoint", "serve", "dcn", "swap", "qos", "collect",
               "control")

_FAULT_MODES = {
    "collective": ("raise",),
    "fusion": ("raise",),
    # accumulate: fires at the microbatch-loop boundary of the
    # overlap-scheduled train step (trace time, one event per microbatch
    # boundary) — the chaos drill for the gradient-accumulation path.
    "accumulate": ("raise",),
    "discovery": ("flap", "timeout", "error"),
    "rpc": ("drop", "delay"),
    # checkpoint: corrupt/partial damage the committed step's largest
    # data file; stall sleeps delay_ms at the write (a slow filesystem
    # — stalls the writer thread on the async tier, the caller on the
    # sync tier); partial-manifest deletes a shard file the manifest
    # still references (metadata/data split); crash-before-rename cuts
    # the save between the last fsync and the atomic commit rename.
    "checkpoint": ("corrupt", "partial", "stall", "partial-manifest",
                   "crash-before-rename"),
    # serve: drop/delay fire at the serving endpoint's request handler;
    # kill fires at the continuous batcher's step dispatch (decode on
    # decode/unified replicas, the KV-migration handoff on prefill
    # replicas — replica death mid-stream, the router-failover drill);
    # evict fires at the paged KV pool's block-allocation events
    # (serve/kv/) and force-evicts every unreferenced cached block —
    # seeded page-eviction pressure, the stale-prefix drill.  The
    # migrate* modes fire at the KV-transfer boundary of the
    # disaggregated fleet (serve/fleet/migration.py): `migrate` corrupts
    # one block AFTER the sender digests it (the receiver's digest check
    # must reject the transfer and the request must finish on a correct
    # recompute path — never with wrong tokens); `migrate-drop` fails
    # the transfer on the wire; `migrate-delay` sleeps delay_ms at it.
    "serve": ("drop", "delay", "kill", "evict", "migrate",
              "migrate-drop", "migrate-delay"),
    # dcn: fires ONLY at the cross-pod exchange step of a hierarchical
    # collective schedule (topo/schedule.py) — the slow-tier link is
    # the one that actually fails in multi-pod fleets.  drop/partition
    # raise HorovodInternalError while the exchange is being emitted
    # (trace time, like `fusion`); delay sleeps delay_ms there.
    "dcn": ("drop", "delay", "partition"),
    # swap: the zero-downtime weight hot-swap path (serve/swap.py;
    # docs/hot_swap.md).  `corrupt-shard` damages a pulled shard AFTER
    # the store's manifest declared the true digests — the subscriber's
    # per-leaf verification must discard the staged pull and keep
    # serving the old weights; `stall` sleeps delay_ms at the pull (a
    # slow store — the HVD_TPU_SWAP_DEADLINE_S abandon drill);
    # `kill-mid-flip` kills the replica at the batcher's flip barrier
    # (the flip is one atomic reference swap, so the router-failover
    # drill must find the replica on exactly one version);
    # `partial-fleet` aborts a rolling fleet swap midway, leaving a
    # mixed-version fleet the router's version-matched prefix routing
    # must serve correctly.
    "swap": ("corrupt-shard", "stall", "kill-mid-flip", "partial-fleet"),
    # qos: the multi-tenant scheduling tier (serve/qos/; docs/qos.md).
    # `invert` fires at the WFQ scheduler's pop and inverts the pick
    # (the LOWEST-priority flow is dispatched — a priority-inversion
    # bug injected on purpose: the preemption and brownout layers must
    # still hold the interactive SLO); `flood` fires at the admission
    # budget charge and waives the tenant's token bucket for that
    # admission (one tenant flooding past its budget — weighted-fair
    # queueing must still protect the other tenants).
    "qos": ("invert", "flood"),
    # collect: the fleet telemetry collector's scrape boundary
    # (obs/collector.py; docs/observability.md).  `drop` fails one
    # replica's scrape on the wire (the collector must degrade to
    # stale-data-with-staleness-gauge, never stall the fleet); `delay`
    # sleeps delay_ms inside the scrape (a wedged replica — must cost
    # the round ONE shared deadline, not one per replica); `garbage`
    # substitutes an unparseable stats payload (the collector's
    # validation must reject it and mark the replica scrape-failed,
    # never feed garbage into the TSDB/detectors).
    "collect": ("drop", "delay", "garbage"),
    # control: re-introduces the two control-plane bugs the chaos sim
    # caught (docs/fleet_sim.md), so the live detectors can prove they
    # would have fired in production.  `spiral` makes the fleet
    # controller skip its shed-active guard for one poll (the scale-in
    # death spiral: draining capacity away while the brownout ladder is
    # shedding); `convoy` makes the sim's migration admission skip the
    # decode-side reservation at pick time (every prefill replica picks
    # the same decode target — the migration convoy).
    "control": ("spiral", "convoy"),
}


@dataclasses.dataclass(frozen=True)
class FaultClause:
    """One parsed clause of a fault spec: what fires at one site.

    ``step`` fires on that site-event index (each check at the site
    advances a counter; sites that know their own step — the
    checkpointer — match the domain step instead).  ``p`` fires each
    event with seeded probability.  ``times`` caps total firings
    (default: 1 for step faults, unlimited for probability faults).
    ``mode`` picks the site-specific action; ``delay_ms`` parameterizes
    ``rpc:mode=delay``.
    """

    site: str
    step: Optional[int] = None
    p: float = 0.0
    seed: int = 0
    times: Optional[int] = None
    mode: Optional[str] = None
    delay_ms: float = 0.0


def parse_fault_spec(spec: str) -> "dict[str, FaultClause]":
    """Parse ``HVD_TPU_FAULT_SPEC`` (e.g.
    ``collective:step=40;discovery:flap=0.2,seed=7``) into per-site
    clauses.  Raises ``ValueError`` on unknown sites/keys/modes — a
    fault plan that silently no-ops would invalidate a chaos run."""
    clauses: dict = {}
    for raw in spec.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        site, _, body = raw.partition(":")
        site = site.strip()
        if site not in FAULT_SITES:
            raise ValueError(
                f"fault spec: unknown site {site!r}; expected one of "
                f"{FAULT_SITES}")
        if site in clauses:
            raise ValueError(f"fault spec: duplicate clause for {site!r}")
        kw: dict = {"site": site}
        for kv in body.split(","):
            kv = kv.strip()
            if not kv:
                continue
            if "=" not in kv:
                raise ValueError(
                    f"fault spec [{site}]: expected key=value, got {kv!r}")
            key, _, val = kv.partition("=")
            key, val = key.strip(), val.strip()
            try:
                if key == "step":
                    kw["step"] = int(val)
                elif key == "p":
                    kw["p"] = float(val)
                elif key == "flap":  # discovery shorthand: p + mode=flap
                    kw["p"] = float(val)
                    kw["mode"] = "flap"
                elif key == "seed":
                    kw["seed"] = int(val)
                elif key == "times":
                    kw["times"] = int(val)
                elif key == "mode":
                    kw["mode"] = val
                elif key == "delay_ms":
                    kw["delay_ms"] = float(val)
                else:
                    raise ValueError(
                        f"fault spec [{site}]: unknown key {key!r}")
            except ValueError as e:
                if "unknown key" in str(e) or "fault spec" in str(e):
                    raise
                raise ValueError(
                    f"fault spec [{site}]: bad value {val!r} for "
                    f"{key!r}") from e
        if key_err := _fault_clause_error(kw):
            raise ValueError(f"fault spec [{site}]: {key_err}")
        clauses[site] = FaultClause(**kw)
    return clauses


def _fault_clause_error(kw: dict) -> Optional[str]:
    site = kw["site"]
    mode = kw.get("mode")
    if mode is not None and mode not in _FAULT_MODES[site]:
        return (f"unknown mode {mode!r}; expected one of "
                f"{_FAULT_MODES[site]}")
    if mode is None and site == "control":
        # The control site's modes name DIFFERENT call sites (spiral:
        # the fleet controller's poll; convoy: the sim's migration
        # admission) — no default is sensible, and a mode-less clause
        # would silently never fire.
        return (f"site 'control' needs an explicit mode= (one of "
                f"{_FAULT_MODES[site]})")
    if kw.get("step") is None and kw.get("p", 0.0) <= 0.0:
        return "clause needs a trigger: step=N or p=<prob> (flap=<prob>)"
    if not 0.0 <= kw.get("p", 0.0) <= 1.0:
        return f"probability must be in [0, 1], got {kw['p']}"
    return None


def _validated_fault_spec(spec: Optional[str]) -> Optional[str]:
    """Empty/unset → None; anything else must parse (fail at init, not
    silently no-op a chaos run)."""
    if not spec or not spec.strip():
        return None
    parse_fault_spec(spec)  # raises ValueError on a malformed plan
    return spec


# Reference knobs that change nothing here: accepted, but setting one
# warns at init, since silently ignoring a reference env var that
# changes behaviour there is a trap.
_NOOP_KNOBS = {
    "CYCLE_TIME": ("torch.distributed starts each collective when it is "
                   "called; there is no background cycle whose latency "
                   "could be tuned"),
    "CACHE_CAPACITY": ("an eager collective builds no program to cache; "
                       "there is no dispatch cache to bound"),
    "HIERARCHICAL_ALLGATHER": ("torch.distributed's all-gather runs over "
                               "the whole group; use "
                               "HOROVOD_HIERARCHICAL_ALLREDUCE for the "
                               "two-level reduce path"),
}


def warn_noop_knobs(logger) -> List[str]:
    """Warn for each no-op reference knob that is set; returns their
    names (called from ``basics.init``)."""
    hit = []
    for name, why in _NOOP_KNOBS.items():
        if _env(name) is not None:
            hit.append(name)
            logger.warning("HOROVOD_%s is set but is a no-op in "
                           "horovod_tpu_torch: %s", name, why)
    return hit


@dataclasses.dataclass(frozen=True)
class Config:
    fusion_threshold: int = 64 * 1024 * 1024  # bytes; HOROVOD_FUSION_THRESHOLD
    two_phase_allreduce: bool = False  # HVD_TPU_TWO_PHASE_ALLREDUCE
    pipeline_depth: int = 2          # HVD_TPU_PIPELINE_DEPTH (reduce-scatters in flight)
    cost_alpha_us: float = DEFAULT_COST_ALPHA_US    # HVD_TPU_COST_ALPHA_US
    cost_beta_gbps: float = DEFAULT_COST_BETA_GBPS  # HVD_TPU_COST_BETA_GBPS
    microbatches: int = 1            # HVD_TPU_MICROBATCHES (accumulated per step)
    overlap_reduce: bool = True      # HVD_TPU_OVERLAP_REDUCE (mb i-1's reduce-scatter under mb i's backward)
    error_feedback: bool = False     # HVD_TPU_ERROR_FEEDBACK
    compression: Optional[str] = None  # HVD_TPU_COMPRESSION (none|fp16|bf16|int8)
    # Two-tier topology (topo/): pods are nodes, chips the ranks of one.
    topo_spec: Optional[str] = None    # HVD_TPU_TOPO_SPEC ("PODSxCHIPS"; unset = infer from the node layout)
    topo_schedule: str = "off"         # HVD_TPU_TOPO_SCHEDULE (off|auto|flat|two_phase|hierarchical)
    topo_kernel: str = "spmd"          # HVD_TPU_TOPO_KERNEL (spmd|pallas; recorded in the schedule IR)
    topo_cost_freeze: bool = False     # HVD_TPU_TOPO_COST_FREEZE (pin the per-tier α/β)
    topo_alpha_dcn_us: float = 100.0   # HVD_TPU_TOPO_ALPHA_DCN_US (per-hop launch latency between nodes)
    topo_beta_dcn_gbps: float = 10.0   # HVD_TPU_TOPO_BETA_DCN_GBPS (per-hop bandwidth between nodes)
    hierarchical_allreduce: bool = False  # HOROVOD_HIERARCHICAL_ALLREDUCE
    hierarchical_allgather: bool = False  # HOROVOD_HIERARCHICAL_ALLGATHER (no-op: warns)
    hierarchical_inner_size: int = 0      # HVD_TPU_HIERARCHICAL_INNER (0 = ranks a node)
    mesh_plan: Optional[str] = None    # HVD_TPU_MESH_PLAN ("data=4,fsdp=2"; unset = the 1-D plan)
    # The online autotuner (optim/autotune.py, optim/parameter_manager.py).
    autotune: bool = False                # HOROVOD_AUTOTUNE
    autotune_log: Optional[str] = None    # HOROVOD_AUTOTUNE_LOG (JSON lines, rank 0)
    autotune_warmup_samples: int = 3      # HOROVOD_AUTOTUNE_WARMUP_SAMPLES
    autotune_steps_per_sample: int = 10   # HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE
    autotune_max_samples: int = 20        # HVD_TPU_AUTOTUNE_MAX_SAMPLES (scored windows, then freeze)
    # Observability (obs/): the registry and its scrape port, tracing and
    # the crash flight recorder.
    metrics: bool = True                  # HVD_TPU_METRICS (registry + instrumentation gate)
    metrics_port: int = 0                 # HVD_TPU_METRICS_PORT (0 = no local HTTP scrape port; rank r serves port + r)
    metrics_window: int = 1024            # HVD_TPU_METRICS_WINDOW (histogram ring size)
    straggler_factor: float = 2.0         # HVD_TPU_STRAGGLER_FACTOR (x world-median step time)
    trace: bool = True                    # HVD_TPU_TRACE (span recording gate)
    trace_ring: int = 2048                # HVD_TPU_TRACE_RING (per-process span ring size)
    flight: bool = True                   # HVD_TPU_FLIGHT (crash-dump gate)
    flight_dir: str = ""                  # HVD_TPU_FLIGHT_DIR ("" = <tempdir>/hvd_tpu_flight)
    flight_ring: int = 512                # HVD_TPU_FLIGHT_RING (event ring size)
    # Durable state and recovery (faults.py, ckpt/, elastic/, utils/retry.py).
    fault_spec: Optional[str] = None          # HVD_TPU_FAULT_SPEC (armed at init)
    elastic_timeout_seconds: float = 600.0    # HOROVOD_ELASTIC_TIMEOUT
    reset_limit: int = 0                      # HOROVOD_ELASTIC_RESET_LIMIT (0 = unlimited)
    reset_backoff_seconds: float = 0.5        # HVD_TPU_RESET_BACKOFF (0 = no backoff)
    reset_backoff_max_seconds: float = 30.0   # HVD_TPU_RESET_BACKOFF_MAX
    blacklist_decay_seconds: float = 300.0    # HVD_TPU_BLACKLIST_DECAY (0 = permanent)
    discovery_failure_threshold: int = 3      # HVD_TPU_DISCOVERY_FAILURES (consecutive ⇒ membership loss)
    rpc_retries: int = 3                      # HVD_TPU_RPC_RETRIES (attempts per request)
    rpc_backoff_seconds: float = 0.3          # HVD_TPU_RPC_BACKOFF (base, jittered exponential)
    agent_ping_interval_seconds: float = 15.0  # HVD_TPU_AGENT_PING_INTERVAL
    agent_max_missed_pings: int = 4           # HVD_TPU_AGENT_MAX_MISSED
    checkpoint_digest: bool = True            # HVD_TPU_CHECKPOINT_DIGEST (integrity sidecar)
    ckpt_async: bool = True                   # HVD_TPU_CKPT_ASYNC (snapshot-and-offload saves)
    ckpt_inflight: int = 2                    # HVD_TPU_CKPT_INFLIGHT (bounded writer queue)
    # The host runtime (utils/timeline.py, utils/stall.py,
    # utils/cross_stall.py, native/).
    timeline: Optional[str] = None            # HOROVOD_TIMELINE (Chrome-trace path; rank r writes <path>.rank<r>)
    timeline_mark_cycles: bool = False        # HOROVOD_TIMELINE_MARK_CYCLES
    log_level: str = "warning"                # HOROVOD_LOG_LEVEL
    stall_check_disable: bool = False         # HOROVOD_STALL_CHECK_DISABLE
    stall_check_time_seconds: float = 60.0    # HOROVOD_STALL_CHECK_TIME_SECONDS
    stall_shutdown_time_seconds: float = 0.0  # HOROVOD_STALL_SHUTDOWN_TIME_SECONDS (0 = never)
    use_native_planner: bool = True           # HVD_TPU_USE_NATIVE_PLANNER (C++ fusion and schedule planners)
    native_coordinator: bool = True           # HVD_TPU_NATIVE_COORD (cross-process stall monitor)
    cycle_time_ms: float = 1.0                # HOROVOD_CYCLE_TIME (no-op: warns)
    cache_capacity: Optional[int] = None      # HOROVOD_CACHE_CAPACITY (no-op: warns)

    @classmethod
    def from_env(cls) -> "Config":
        return cls(
            fusion_threshold=_env_int("FUSION_THRESHOLD", 64 * 1024 * 1024),
            two_phase_allreduce=_env_bool("TWO_PHASE_ALLREDUCE", False),
            pipeline_depth=_env_int("PIPELINE_DEPTH", 2),
            cost_alpha_us=_env_float("COST_ALPHA_US", DEFAULT_COST_ALPHA_US),
            cost_beta_gbps=_env_float("COST_BETA_GBPS",
                                      DEFAULT_COST_BETA_GBPS),
            microbatches=_env_pos_int("MICROBATCHES", 1),
            overlap_reduce=_env_bool("OVERLAP_REDUCE", True),
            error_feedback=_env_bool("ERROR_FEEDBACK", False),
            compression=_env_choice("COMPRESSION", None, COMPRESSIONS),
            topo_spec=_validated_topo_spec(_env("TOPO_SPEC")),
            topo_schedule=_env_choice("TOPO_SCHEDULE", "off",
                                      TOPO_SCHEDULES) or "off",
            topo_kernel=_env_choice("TOPO_KERNEL", "spmd",
                                    TOPO_KERNELS) or "spmd",
            topo_cost_freeze=_env_bool("TOPO_COST_FREEZE", False),
            topo_alpha_dcn_us=_env_float("TOPO_ALPHA_DCN_US", 100.0),
            topo_beta_dcn_gbps=_env_float("TOPO_BETA_DCN_GBPS", 10.0),
            hierarchical_allreduce=_env_bool("HIERARCHICAL_ALLREDUCE", False),
            hierarchical_allgather=_env_bool("HIERARCHICAL_ALLGATHER", False),
            hierarchical_inner_size=_env_int("HIERARCHICAL_INNER", 0),
            mesh_plan=_validated_mesh_plan(_env("MESH_PLAN")),
            autotune=_env_bool("AUTOTUNE", False),
            autotune_log=_env("AUTOTUNE_LOG") or None,
            autotune_warmup_samples=_env_int("AUTOTUNE_WARMUP_SAMPLES", 3),
            autotune_steps_per_sample=_env_int("AUTOTUNE_STEPS_PER_SAMPLE",
                                               10),
            autotune_max_samples=_env_int("AUTOTUNE_MAX_SAMPLES", 20),
            metrics=_env_bool("METRICS", True),
            metrics_port=_env_int("METRICS_PORT", 0),
            metrics_window=_env_pos_int("METRICS_WINDOW", 1024),
            straggler_factor=_env_straggler_factor(),
            trace=_env_bool("TRACE", True),
            trace_ring=_env_pos_int("TRACE_RING", 2048),
            flight=_env_bool("FLIGHT", True),
            flight_dir=_env("FLIGHT_DIR") or "",
            flight_ring=_env_pos_int("FLIGHT_RING", 512),
            fault_spec=_validated_fault_spec(_env("FAULT_SPEC")),
            elastic_timeout_seconds=_env_float("ELASTIC_TIMEOUT", 600.0),
            reset_limit=_env_int("ELASTIC_RESET_LIMIT", 0),
            reset_backoff_seconds=_env_float("RESET_BACKOFF", 0.5),
            reset_backoff_max_seconds=_env_float("RESET_BACKOFF_MAX", 30.0),
            blacklist_decay_seconds=_env_float("BLACKLIST_DECAY", 300.0),
            discovery_failure_threshold=_env_int("DISCOVERY_FAILURES", 3),
            rpc_retries=_env_int("RPC_RETRIES", 3),
            rpc_backoff_seconds=_env_float("RPC_BACKOFF", 0.3),
            agent_ping_interval_seconds=_env_float("AGENT_PING_INTERVAL",
                                                   15.0),
            agent_max_missed_pings=_env_int("AGENT_MAX_MISSED", 4),
            checkpoint_digest=_env_bool("CHECKPOINT_DIGEST", True),
            ckpt_async=_env_bool("CKPT_ASYNC", True),
            ckpt_inflight=_env_pos_int("CKPT_INFLIGHT", 2),
            timeline=_env("TIMELINE") or None,
            timeline_mark_cycles=_env_bool("TIMELINE_MARK_CYCLES", False),
            log_level=(_env("LOG_LEVEL") or "warning").lower(),
            stall_check_disable=_env_bool("STALL_CHECK_DISABLE", False),
            stall_check_time_seconds=_env_float("STALL_CHECK_TIME_SECONDS",
                                                60.0),
            stall_shutdown_time_seconds=_env_float(
                "STALL_SHUTDOWN_TIME_SECONDS", 0.0),
            use_native_planner=_env_bool("USE_NATIVE_PLANNER", True),
            native_coordinator=_env_bool("NATIVE_COORD", True),
            cycle_time_ms=_env_float("CYCLE_TIME", 1.0),
            cache_capacity=_env_opt_int("CACHE_CAPACITY"),
        )
