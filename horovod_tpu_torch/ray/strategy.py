"""Worker placement for the Ray executor.

Counterpart of ``horovod_tpu/ray/strategy.py`` (reference:
``horovod/ray/strategy.py``): the placement-group bundles for N workers,
``pack`` (fill hosts densely: fewest hosts, least cross-host traffic) or
``spread`` (one worker a host: the most bandwidth), and the ranks each
bundle holds.  Pure Python, independent of Ray; the executor turns the
bundles into a placement group where Ray is installed.
"""

from __future__ import annotations

from typing import Dict, List, Optional


def pack_bundles(num_workers: int, cpus_per_worker: int = 1,
                 gpus_per_worker: int = 0,
                 workers_per_host: Optional[int] = None) -> List[Dict[str, int]]:
    """Bundle list for a PACK placement group: group ``workers_per_host``
    workers into one bundle per host (reference: ``PackStrategy``)."""
    if num_workers < 1:
        raise ValueError("num_workers must be >= 1")
    per_host = workers_per_host or num_workers
    if per_host < 1:
        raise ValueError("workers_per_host must be >= 1")
    bundles = []
    remaining = num_workers
    while remaining > 0:
        k = min(per_host, remaining)
        bundle = {"CPU": cpus_per_worker * k}
        if gpus_per_worker:
            bundle["GPU"] = gpus_per_worker * k
        bundles.append(bundle)
        remaining -= k
    return bundles


def spread_bundles(num_workers: int, cpus_per_worker: int = 1,
                   gpus_per_worker: int = 0) -> List[Dict[str, int]]:
    """One bundle per worker for a SPREAD placement group (reference:
    ``SpreadStrategy``)."""
    return pack_bundles(num_workers, cpus_per_worker, gpus_per_worker,
                        workers_per_host=1)


def ranks_per_bundle(num_workers: int,
                     bundles: List[Dict[str, int]],
                     cpus_per_worker: int = 1) -> List[List[int]]:
    """Assign global ranks to bundles in order (rank 0 on the first
    bundle — the reference keeps rank 0 with the driver-adjacent host)."""
    out: List[List[int]] = []
    rank = 0
    for b in bundles:
        k = max(1, b.get("CPU", cpus_per_worker) // max(1, cpus_per_worker))
        k = min(k, num_workers - rank)
        out.append(list(range(rank, rank + k)))
        rank += k
    if rank != num_workers:
        raise ValueError(
            f"bundles hold {rank} workers, expected {num_workers}")
    return out
