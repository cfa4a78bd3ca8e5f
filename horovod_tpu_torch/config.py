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


def _env_int_tuple(name: str, default: tuple) -> tuple:
    """Comma-separated positive ints → sorted, deduplicated tuple
    (``HVD_TPU_SERVE_PREFILL_BUCKETS``: a malformed list fails at
    init)."""
    val = _env(name)
    if val is None:
        return default
    try:
        items = tuple(sorted({int(v.strip()) for v in val.split(",")
                              if v.strip()}))
    except ValueError as e:
        raise ValueError(
            f"Env var {name!r} has unparseable value {val!r}; expected "
            f"comma-separated ints") from e
    if not items or any(v <= 0 for v in items):
        raise ValueError(
            f"Env var {name!r} needs at least one positive int, got {val!r}")
    return items


# --- multi-tenant QoS grammar (HVD_TPU_QOS_*) --------------------------------
# Service classes of the serving scheduler (serve/qos/): `interactive`
# is deadline-protected (never shed, may preempt), `standard` is the
# default, `batch` is throughput traffic (first preempted and shed).
# The weight/share/budget maps share one ``key=value`` comma grammar,
# parsed at init so a typo'd policy fails loudly.

QOS_CLASSES = ("interactive", "standard", "batch")


def parse_qos_map(spec: str, what: str,
                  keys: Optional[tuple] = None,
                  positive: Optional[bool] = None) -> "dict[str, float]":
    """Parse ``a=2,b=0.5`` into ``{key: float}``.  ``keys`` restricts
    the key namespace (class-weight maps must name QoS classes); tenant
    maps accept any non-empty tenant id.  ``positive`` requires values
    > 0 (default: True for keyed maps): weights and shares must be
    positive — a share of 0 would starve the tenant — while budget maps
    keep 0 = unlimited."""
    require_pos = positive if positive is not None else keys is not None
    out: dict = {}
    for raw in spec.split(","):
        raw = raw.strip()
        if not raw:
            continue
        key, sep, val = raw.partition("=")
        key, val = key.strip(), val.strip()
        if not sep or not key or not val:
            raise ValueError(
                f"{what}: expected key=value entries, got {raw!r}")
        if keys is not None and key not in keys:
            raise ValueError(
                f"{what}: unknown key {key!r}; expected one of {keys}")
        if key in out:
            raise ValueError(f"{what}: duplicate key {key!r}")
        try:
            fval = float(val)
        except ValueError as e:
            raise ValueError(
                f"{what}: bad value {val!r} for {key!r}") from e
        if fval < 0 or (require_pos and fval <= 0):
            raise ValueError(
                f"{what}: value for {key!r} must be "
                f"{'> 0' if require_pos else '>= 0'}, got {fval}")
        out[key] = fval
    return out


def _validated_qos_map(spec: Optional[str], what: str,
                       keys: Optional[tuple] = None,
                       positive: Optional[bool] = None) -> Optional[str]:
    """Empty or unset: None; anything else must parse (fails at init)."""
    if not spec or not spec.strip():
        return None
    parse_qos_map(spec, what, keys, positive=positive)
    return spec


def _validated_mesh_plan(spec: Optional[str]) -> Optional[str]:
    """Empty or unset: None; anything else must parse (fails at init).
    Whether it factors the world is checked when the plan is built."""
    if not spec or not spec.strip():
        return None
    parse_mesh_plan(spec)
    return spec


# --- SLO spec grammar (HVD_TPU_SLO_SPEC) -------------------------------------
# ``name:signal=<sig>,target=<v>[,budget=<frac>][,window=<s>][,short=<s>]
# [,burn=<x>][,severity=page|ticket];name2:...`` — one clause per SLO,
# evaluated by obs/slo.py as Google-SRE-style multi-window burn-rate
# alerts (docs/observability.md).  Parsed here so a typo'd SLO fails at
# init: a silently-misparsed SLO is an alert that never fires.

# Signals the collector can classify good/bad per collection round
# (obs/slo.py holds the classification semantics for each).
SLO_SIGNALS = ("ttft_p99_ms", "queue_depth", "scrape_ok")

SLO_SEVERITIES = ("page", "ticket")


@dataclasses.dataclass(frozen=True)
class SloClause:
    """One parsed SLO: a signal, its objective, and the burn-rate alert
    geometry.  ``budget`` is the allowed bad-round fraction over
    ``window_s``; the alert fires when the measured bad fraction burns
    the budget at >= ``burn``x the sustainable rate in BOTH the long
    window and the ``short_s`` confirmation window (the short window is
    what un-fires the alert quickly once the incident ends)."""

    name: str
    signal: str
    target: float
    budget: float = 0.01
    window_s: float = 3600.0
    short_s: float = 300.0
    burn: float = 14.4
    severity: str = "page"


def parse_slo_spec(spec: str) -> "dict[str, SloClause]":
    """Parse ``HVD_TPU_SLO_SPEC`` (e.g.
    ``ttft:signal=ttft_p99_ms,target=500,burn=6;avail:signal=scrape_ok,
    target=0.9``) into named clauses.  Raises ``ValueError`` on unknown
    signals/keys or inconsistent windows."""
    clauses: dict = {}
    for raw in spec.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        name, sep, body = raw.partition(":")
        name = name.strip()
        if not sep or not name:
            raise ValueError(
                f"slo spec: clause {raw!r} needs the form "
                f"'name:signal=...,target=...'")
        if name in clauses:
            raise ValueError(f"slo spec: duplicate clause for {name!r}")
        kw: dict = {"name": name}
        for kv in body.split(","):
            kv = kv.strip()
            if not kv:
                continue
            if "=" not in kv:
                raise ValueError(
                    f"slo spec [{name}]: expected key=value, got {kv!r}")
            key, _, val = kv.partition("=")
            key, val = key.strip(), val.strip()
            try:
                if key == "signal":
                    kw["signal"] = val
                elif key == "target":
                    kw["target"] = float(val)
                elif key == "budget":
                    kw["budget"] = float(val)
                elif key == "window":
                    kw["window_s"] = float(val)
                elif key == "short":
                    kw["short_s"] = float(val)
                elif key == "burn":
                    kw["burn"] = float(val)
                elif key == "severity":
                    kw["severity"] = val
                else:
                    raise ValueError(
                        f"slo spec [{name}]: unknown key {key!r}")
            except ValueError as e:
                if "slo spec" in str(e):
                    raise
                raise ValueError(
                    f"slo spec [{name}]: bad value {val!r} for "
                    f"{key!r}") from e
        if "short_s" not in kw and "window_s" in kw:
            # Default confirmation window: 1/12 of the long window, the
            # SRE-workbook page-alert geometry.
            kw["short_s"] = max(1.0, kw["window_s"] / 12.0)
        if err := _slo_clause_error(kw):
            raise ValueError(f"slo spec [{name}]: {err}")
        clauses[name] = SloClause(**kw)
    return clauses


def _slo_clause_error(kw: dict) -> Optional[str]:
    sig = kw.get("signal")
    if sig is None:
        return "clause needs signal=<sig>"
    if sig not in SLO_SIGNALS:
        return f"unknown signal {sig!r}; expected one of {SLO_SIGNALS}"
    if "target" not in kw:
        return "clause needs target=<value>"
    sev = kw.get("severity", "page")
    if sev not in SLO_SEVERITIES:
        return (f"unknown severity {sev!r}; expected one of "
                f"{SLO_SEVERITIES}")
    if not 0.0 < kw.get("budget", 0.01) <= 1.0:
        return f"budget must be in (0, 1], got {kw['budget']}"
    if kw.get("burn", 14.4) <= 0.0:
        return f"burn threshold must be > 0, got {kw['burn']}"
    window = kw.get("window_s", 3600.0)
    short = kw.get("short_s", 300.0)
    if window <= 0.0 or short <= 0.0:
        return "windows must be > 0 seconds"
    if short > window:
        return (f"short window ({short}s) must not exceed the long "
                f"window ({window}s)")
    return None


def _validated_slo_spec(spec: Optional[str]) -> Optional[str]:
    """Empty/unset → None (obs/slo.py applies its default catalog);
    anything else must parse — fail at init, not as an alert that never
    fires."""
    if not spec or not spec.strip():
        return None
    parse_slo_spec(spec)  # raises ValueError on a malformed spec
    return spec


# --- pre-init knob registry --------------------------------------------------
# Knobs read through raw ``os.environ`` outside this module: process
# wiring, what init itself and crash paths need before a Config exists,
# the runtime sanitizer's gate, and the probe and MFU helpers that run
# before (or without) init.  With ``Config.from_env`` this tuple is the
# knob namespace hvdlint's knob checker holds the package to
# (analysis/knobs.py).  The reference's COORDINATOR_ADDR and
# NUM_PROCESSES are left out: torchrun's variables (MASTER_ADDR,
# WORLD_SIZE, RANK) take the JAX coordinator's place.  USE_NATIVE_FFI is
# left out: there is no FFI tier whose registration it could gate.
PRE_INIT_KNOBS = (
    # process wiring (PROCESS_ID: trace.py's rank tag before init)
    "PROCESS_ID", "SECRET_KEY",
    # read during/before init() itself
    "LOG_LEVEL", "LOG_HIDE_TIME", "METRICS", "FAULT_SPEC",
    # tracing + flight recorder (lazy env gates)
    "TRACE", "FLIGHT", "FLIGHT_DIR",
    # runtime concurrency sanitizer (analysis/sanitizer.py)
    "SANITIZE", "SANITIZE_REPORT",
    # backend probe and MFU helpers (utils/backend_probe.py, utils/mfu.py)
    "PEAK_TFLOPS", "COMPILE_CACHE", "PROBE_ATTEMPTS", "PROBE_RETRIES",
    "PROBE_BACKOFF_S", "PROBE_BACKOFF", "PROBE_TIMEOUT_S",
    "BENCH_EXEC_ATTEMPT",
)

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
    "BATCH_D2D_MEMCOPIES": ("the fusion buffer is packed by one torch.cat "
                            "a bucket on the device; there are no separate "
                            "device-to-device copy launches to batch"),
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
    mesh_axis_name: str = "hvd"        # HVD_TPU_MESH_AXIS_NAME (the 1-D world's axis)
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
    # The fleet telemetry plane (obs/timeseries.py, collector.py, slo.py,
    # detect.py).
    slo_spec: Optional[str] = None        # HVD_TPU_SLO_SPEC (SLO catalog; unset = obs/slo.py defaults)
    collect_period_s: float = 1.0         # HVD_TPU_COLLECT_PERIOD_S (fleet scrape cadence)
    collect_timeout_s: float = 1.0        # HVD_TPU_COLLECT_TIMEOUT_S (ONE shared deadline per scrape round)
    collect_window: int = 512             # HVD_TPU_COLLECT_WINDOW (TSDB points kept per series)
    collect_stale_s: float = 10.0         # HVD_TPU_COLLECT_STALE_S (scrape-plane staleness alert bound)
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
    # Inference serving (serve/).
    serve_max_batch: int = 8                  # HVD_TPU_SERVE_MAX_BATCH (continuous-batching slots)
    serve_queue_depth: int = 64               # HVD_TPU_SERVE_QUEUE_DEPTH (admission queue bound; full ⇒ reject)
    serve_prefill_buckets: tuple = (64, 256, 1024)  # HVD_TPU_SERVE_PREFILL_BUCKETS (padded prompt shapes)
    serve_max_new_tokens: int = 256           # HVD_TPU_SERVE_MAX_TOKENS (per-request generation cap)
    serve_deadline_seconds: float = 30.0      # HVD_TPU_SERVE_DEADLINE_S (default per-request deadline; 0 = none)
    serve_replica_strikes: int = 2            # HVD_TPU_SERVE_REPLICA_STRIKES (failures before a replica is benched)
    serve_probation_seconds: float = 10.0     # HVD_TPU_SERVE_PROBATION_S (bench time before a half-open retry)
    serve_kv: str = "paged"                   # HVD_TPU_SERVE_KV (paged|dense cache layout)
    serve_kv_block: int = 16                  # HVD_TPU_SERVE_KV_BLOCK (tokens per KV block)
    serve_kv_blocks: int = 0                  # HVD_TPU_SERVE_KV_BLOCKS (pool budget in blocks; 0 = auto)
    serve_spec_k: int = 4                     # HVD_TPU_SERVE_SPEC_K (draft tokens per speculative verify step)
    # Tensor-parallel serving replicas (serve/tp.py)
    serve_tp: int = 1                         # HVD_TPU_SERVE_TP (tensor-parallel shard count per replica; 1 = off)
    serve_tp_step_timeout_s: float = 30.0     # HVD_TPU_SERVE_TP_STEP_TIMEOUT_S (lockstep frame deadline before the replica declares itself dead)
    fleet_role: str = "unified"               # HVD_TPU_FLEET_ROLE (prefill|decode|unified: this replica's class)
    fleet_migrate_chunk: int = 1 << 20        # HVD_TPU_FLEET_MIGRATE_CHUNK (KV-transfer bytes per wire frame)
    fleet_scale_out_queue: float = 4.0        # HVD_TPU_FLEET_SCALE_OUT_QUEUE (per-replica queue depth that saturates a role)
    fleet_scale_out_ttft_ms: float = 0.0      # HVD_TPU_FLEET_SCALE_OUT_TTFT_MS (p99 TTFT that saturates a role; 0 = off)
    fleet_scale_in_idle_s: float = 30.0       # HVD_TPU_FLEET_SCALE_IN_IDLE_S (role idle window before drain-and-retire)
    fleet_drain_deadline_s: float = 30.0      # HVD_TPU_FLEET_DRAIN_DEADLINE_S (max drain wait before forced retire)
    # Weight hot-swap from a checkpoint store (serve/swap.py).
    swap_poll_s: float = 5.0                  # HVD_TPU_SWAP_POLL_S (subscriber store-poll cadence)
    swap_deadline_s: float = 60.0             # HVD_TPU_SWAP_DEADLINE_S (pull+stage+flip budget per swap; 0 = no deadline, 7-day backstop at the barrier)
    swap_max_concurrent: int = 1              # HVD_TPU_SWAP_MAX_CONCURRENT (replicas flipping at once in a rolling fleet swap)
    swap_retries: int = 3                     # HVD_TPU_SWAP_RETRIES (pull attempts per swap before the rejection is final)
    # Multi-tenant QoS scheduling (serve/qos/).
    qos_class_weights: str = "interactive=8,standard=4,batch=1"  # HVD_TPU_QOS_CLASS_WEIGHTS (WFQ weight per class)
    qos_tenant_shares: Optional[str] = None   # HVD_TPU_QOS_TENANT_SHARES ("tenant=share,..."; unset = 1 each)
    qos_tenant_budgets: Optional[str] = None  # HVD_TPU_QOS_TENANT_BUDGETS ("tenant=tokens_per_s,..."; 0 = unlimited)
    qos_default_budget: float = 0.0           # HVD_TPU_QOS_DEFAULT_BUDGET (tokens/s for other tenants; 0 = unlimited)
    qos_burst_s: float = 2.0                  # HVD_TPU_QOS_BURST_S (bucket capacity = rate x burst window)
    qos_preempt: bool = True                  # HVD_TPU_QOS_PREEMPT (deadline-aware batch preemption)
    qos_slo_ttft_ms: float = 0.0              # HVD_TPU_QOS_SLO_TTFT_MS (interactive p99 TTFT SLO; 0 = off)
    qos_brownout_high: float = 0.75           # HVD_TPU_QOS_BROWNOUT_HIGH (queue fraction that steps the ladder up)
    qos_brownout_low: float = 0.25            # HVD_TPU_QOS_BROWNOUT_LOW (queue fraction below which it may step down)
    qos_brownout_hold_s: float = 5.0          # HVD_TPU_QOS_BROWNOUT_HOLD_S (calm hold before each step down)
    cycle_time_ms: float = 1.0                # HOROVOD_CYCLE_TIME (no-op: warns)
    batch_d2d_memcopies: bool = True          # HOROVOD_BATCH_D2D_MEMCOPIES (no-op: warns)
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
            mesh_axis_name=_env("MESH_AXIS_NAME") or "hvd",
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
            slo_spec=_validated_slo_spec(_env("SLO_SPEC")),
            collect_period_s=_env_float("COLLECT_PERIOD_S", 1.0),
            collect_timeout_s=_env_float("COLLECT_TIMEOUT_S", 1.0),
            collect_window=_env_pos_int("COLLECT_WINDOW", 512),
            collect_stale_s=_env_float("COLLECT_STALE_S", 10.0),
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
            serve_max_batch=_env_int("SERVE_MAX_BATCH", 8),
            serve_queue_depth=_env_int("SERVE_QUEUE_DEPTH", 64),
            serve_prefill_buckets=_env_int_tuple("SERVE_PREFILL_BUCKETS",
                                                 (64, 256, 1024)),
            serve_max_new_tokens=_env_int("SERVE_MAX_TOKENS", 256),
            serve_deadline_seconds=_env_float("SERVE_DEADLINE_S", 30.0),
            serve_replica_strikes=_env_int("SERVE_REPLICA_STRIKES", 2),
            serve_probation_seconds=_env_float("SERVE_PROBATION_S", 10.0),
            serve_kv=_env_choice("SERVE_KV", "paged",
                                 ("paged", "dense")) or "paged",
            serve_kv_block=_env_pos_int("SERVE_KV_BLOCK", 16),
            serve_kv_blocks=_env_int("SERVE_KV_BLOCKS", 0),
            serve_spec_k=_env_pos_int("SERVE_SPEC_K", 4),
            serve_tp=_env_pos_int("SERVE_TP", 1),
            serve_tp_step_timeout_s=_env_float("SERVE_TP_STEP_TIMEOUT_S",
                                               30.0),
            fleet_role=_env_choice("FLEET_ROLE", "unified",
                                   ("prefill", "decode", "unified"))
            or "unified",
            fleet_migrate_chunk=_env_pos_int("FLEET_MIGRATE_CHUNK",
                                             1 << 20),
            fleet_scale_out_queue=_env_float("FLEET_SCALE_OUT_QUEUE", 4.0),
            fleet_scale_out_ttft_ms=_env_float("FLEET_SCALE_OUT_TTFT_MS",
                                               0.0),
            fleet_scale_in_idle_s=_env_float("FLEET_SCALE_IN_IDLE_S", 30.0),
            fleet_drain_deadline_s=_env_float("FLEET_DRAIN_DEADLINE_S",
                                              30.0),
            swap_poll_s=_env_float("SWAP_POLL_S", 5.0),
            swap_deadline_s=_env_float("SWAP_DEADLINE_S", 60.0),
            swap_max_concurrent=_env_pos_int("SWAP_MAX_CONCURRENT", 1),
            swap_retries=_env_pos_int("SWAP_RETRIES", 3),
            qos_class_weights=_validated_qos_map(
                _env("QOS_CLASS_WEIGHTS")
                or "interactive=8,standard=4,batch=1",
                "qos class weights", QOS_CLASSES)
            or "interactive=8,standard=4,batch=1",
            qos_tenant_shares=_validated_qos_map(
                _env("QOS_TENANT_SHARES"), "qos tenant shares",
                positive=True),
            qos_tenant_budgets=_validated_qos_map(
                _env("QOS_TENANT_BUDGETS"), "qos tenant budgets"),
            qos_default_budget=_env_float("QOS_DEFAULT_BUDGET", 0.0),
            qos_burst_s=_env_float("QOS_BURST_S", 2.0),
            qos_preempt=_env_bool("QOS_PREEMPT", True),
            qos_slo_ttft_ms=_env_float("QOS_SLO_TTFT_MS", 0.0),
            qos_brownout_high=_env_float("QOS_BROWNOUT_HIGH", 0.75),
            qos_brownout_low=_env_float("QOS_BROWNOUT_LOW", 0.25),
            qos_brownout_hold_s=_env_float("QOS_BROWNOUT_HOLD_S", 5.0),
            cycle_time_ms=_env_float("CYCLE_TIME", 1.0),
            batch_d2d_memcopies=_env_bool("BATCH_D2D_MEMCOPIES", True),
            cache_capacity=_env_opt_int("CACHE_CAPACITY"),
        )
