"""The native planners (``src/planner.cc``) through ctypes.

Counterpart of ``horovod_tpu/native/planner.py``.  Each function has the
contract of its Python twin and falls back to it when the library is
not built: :func:`plan_buckets` that of ``ops.fusion.plan_buckets_py``,
:func:`plan_two_phase_flags` that of ``ops.fusion.plan_two_phase_flags``
and :func:`plan_hierarchical` that of ``topo.schedule.choose_algo``
(bit for bit, ``tests/test_torch_port_native.py``).  ``ops/fusion.py``
and ``topo/schedule.py`` ask these first under
``HVD_TPU_USE_NATIVE_PLANNER`` (on by default).
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

from . import bindings


def available() -> bool:
    return bindings.available()


def plan_buckets(sizes_bytes: Sequence[int], threshold: int) -> List[List[int]]:
    """Same contract as ``ops.fusion.plan_buckets_py``."""
    lib = bindings.load()
    if lib is None:
        from ..ops.fusion import plan_buckets_py

        return plan_buckets_py(sizes_bytes, threshold)
    n = len(sizes_bytes)
    sizes_arr = (ctypes.c_int64 * n)(*[int(s) for s in sizes_bytes])
    out = (ctypes.c_int32 * n)()
    n_buckets = lib.hvd_tpu_plan_buckets(sizes_arr, n, int(threshold), out)
    if n_buckets < 0:
        raise ValueError(
            f"Invalid planner input (n={n}, threshold={threshold})")
    buckets: List[List[int]] = [[] for _ in range(int(n_buckets))]
    for i in range(n):
        buckets[out[i]].append(i)
    return buckets


def plan_two_phase_flags(bucket_bytes: Sequence[int], world_size: int,
                         alpha_us: float, beta_gbps: float) -> List[bool]:
    """Native α–β phase decision per bucket (same contract as
    ``ops.fusion.plan_two_phase_flags``)."""
    lib = bindings.load()
    if lib is None:
        from ..ops.fusion import plan_two_phase_flags as _py

        return _py(bucket_bytes, world_size, alpha_us, beta_gbps)
    n = len(bucket_bytes)
    sizes_arr = (ctypes.c_int64 * n)(*[int(b) for b in bucket_bytes])
    flags = (ctypes.c_int8 * n)()
    rc = lib.hvd_tpu_plan_two_phase(sizes_arr, n, int(world_size),
                                    float(alpha_us), float(beta_gbps), flags)
    if rc < 0:
        raise ValueError(
            f"Invalid schedule planner input (n={n}, world={world_size}, "
            f"alpha_us={alpha_us}, beta_gbps={beta_gbps})")
    return [bool(flags[i]) for i in range(n)]


_ALGO_NAMES = ("flat", "two_phase", "hierarchical")


def plan_hierarchical(bucket_bytes: Sequence[int], pods: int, chips: int,
                      alpha_ici_us: float, beta_ici_gbps: float,
                      alpha_dcn_us: float,
                      beta_dcn_gbps: float) -> List[str]:
    """Native two-tier schedule choice per bucket (same contract as
    ``topo.schedule.choose_algo``): one of flat/two_phase/hierarchical
    per bucket."""
    lib = bindings.load()
    if lib is None:
        from ..topo.costmodel import TierParams, TopoCostParams
        from ..topo.schedule import choose_algo
        from ..topo.topology import MeshTopology

        topo = MeshTopology(pods=pods, chips_per_pod=chips)
        params = TopoCostParams(
            ici=TierParams(alpha_ici_us, beta_ici_gbps),
            dcn=TierParams(alpha_dcn_us, beta_dcn_gbps))
        return [choose_algo(int(b), topo, params) for b in bucket_bytes]
    n = len(bucket_bytes)
    sizes_arr = (ctypes.c_int64 * n)(*[int(b) for b in bucket_bytes])
    algos = (ctypes.c_int8 * n)()
    rc = lib.hvd_tpu_plan_hierarchical(
        sizes_arr, n, int(pods), int(chips), float(alpha_ici_us),
        float(beta_ici_gbps), float(alpha_dcn_us), float(beta_dcn_gbps),
        algos)
    if rc < 0:
        raise ValueError(
            f"Invalid hierarchical planner input (n={n}, "
            f"pods={pods}, chips={chips})")
    return [_ALGO_NAMES[algos[i]] for i in range(n)]
