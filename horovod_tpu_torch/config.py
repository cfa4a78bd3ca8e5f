"""Runtime knobs read from the environment at :func:`basics.init`.

Counterpart of ``horovod_tpu/config.py``, holding only the knobs this
port reads.  Each knob is looked up as ``HOROVOD_<NAME>`` first, then
``HVD_TPU_<NAME>``, as the reference resolves them.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off", "")
COMPRESSIONS = ("none", "fp16", "bf16", "int8")

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
        )
