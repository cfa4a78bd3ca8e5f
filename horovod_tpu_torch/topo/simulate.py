"""The simulated two-tier mesh: pods declared over the live world.

Counterpart of ``horovod_tpu/topo/simulate.py``, whose mesh is
``shard_map`` over the CPU devices.  Here every rank of the live torch
world is a process (a gloo world of CPU processes in the tests; ranks on
one card or on four on the chip host), and a :class:`SimulatedMesh`
declares a ``pods × chips`` topology over it: the collectives run on the
same group partitions (:func:`~.topology.tier_groups`) that a real
deployment of several nodes would use, only the links under them differ.
So the simulation proves schedules right (bit for bit against the flat
wire, the same on every rank, permutations inverted), never bandwidth;
the cost side is the closed-form model of :mod:`.costmodel`.

Every function here is collective: every rank calls it with the same
arguments, and each returns every rank's result.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .costmodel import TopoCostParams, default_params
from .schedule import (ALGO_HIERARCHICAL, choose_algo,
                       compile_bucket_schedule, execute_schedule,
                       hierarchical_all_gather, hierarchical_reduce_scatter)
from .topology import MeshTopology


@dataclasses.dataclass(frozen=True)
class SimulatedMesh:
    """A two-tier topology declared over the live world."""

    topo: MeshTopology


def simulated_mesh(pods: Optional[int] = None,
                   chips: Optional[int] = None) -> SimulatedMesh:
    """The simulation topology over the live world: ``pods × chips``
    must factor the world's size (default: two pods of size/2 ranks, the
    smallest two-tier split)."""
    from .. import basics

    n = basics.size()
    if pods is None and chips is None:
        pods = 2 if n % 2 == 0 and n >= 4 else 1
    if pods is None:
        pods = n // int(chips)
    if chips is None:
        chips = n // int(pods)
    topo = MeshTopology(pods=int(pods), chips_per_pod=int(chips))
    if topo.size != n:
        raise ValueError(
            f"simulated topology {topo.describe()} does not factor the "
            f"{n}-slot mesh")
    return SimulatedMesh(topo=topo)


def _my_row(sim: SimulatedMesh, stack: np.ndarray) -> torch.Tensor:
    """This rank's row of the per-rank stack ``[size, elems]``, on the
    session's device."""
    from .. import basics

    stack = np.asarray(stack)
    if stack.shape[0] != sim.topo.size:
        raise ValueError(
            f"stack rows {stack.shape[0]} != mesh size {sim.topo.size}")
    return torch.from_numpy(np.ascontiguousarray(
        stack[basics.rank()])).to(basics.device())


def _stacked(row: torch.Tensor) -> np.ndarray:
    """Every rank's ``row``, gathered exactly: ``[size, elems]``."""
    n = dist.get_world_size()
    out = row.new_empty(n * row.numel())
    dist.all_gather_into_tensor(out, row.reshape(-1).contiguous())
    return out.reshape(n, -1).cpu().numpy()


def run_allreduce(sim: SimulatedMesh, stack: np.ndarray, *,
                  algo: str = ALGO_HIERARCHICAL, op: str = "sum",
                  compression=None,
                  params: Optional[TopoCostParams] = None) -> np.ndarray:
    """Run one compiled schedule over a per-rank stack (``[size,
    elems]``: rank *i* contributes row *i*) and return every rank's
    result, stacked ``[size, elems]``."""
    from ..ops.compression import Compression

    compression = compression or Compression.none
    x = _my_row(sim, stack)
    sched = compile_bucket_schedule(
        int(x.numel() * x.element_size()), sim.topo,
        params or default_params(), force=algo)
    red = execute_schedule(x, sched, op=op, compression=compression)
    return _stacked(red.to(x.dtype))


def run_rs_ag_roundtrip(sim: SimulatedMesh, stack: np.ndarray, *,
                        compression=None, op: str = "sum") -> np.ndarray:
    """The overlap wire's hierarchical reduce-scatter → all-gather
    (the shard permutation and its inverse): must equal the plain
    allreduce."""
    from ..ops.compression import Compression

    compression = compression or Compression.none
    x = _my_row(sim, stack)
    n = sim.topo.size
    sched = compile_bucket_schedule(int(x.numel() * x.element_size()),
                                    sim.topo, force=ALGO_HIERARCHICAL)
    pad = (-x.numel()) % n
    xp = torch.cat([x, x.new_zeros(pad)]) if pad else x
    shard = hierarchical_reduce_scatter(xp, sched, op=op,
                                        compression=compression)
    full = hierarchical_all_gather(shard, sched, compression=compression)
    return _stacked(full[:x.numel()].to(x.dtype))


def cost_oracle_rows(sizes_bytes: Sequence[int], topo: MeshTopology,
                     params: Optional[TopoCostParams] = None
                     ) -> List[Dict]:
    """Modeled cost of each algorithm at each size and the compiler's
    choice: the modeled-against-chosen agreement surface."""
    from .costmodel import flat_cost_us, hierarchical_cost_us

    params = params or default_params()
    rows: List[Dict] = []
    for b in sizes_bytes:
        rows.append({
            "bytes": int(b),
            "modeled_flat_us": flat_cost_us(b, topo, params),
            "modeled_hierarchical_us": hierarchical_cost_us(b, topo,
                                                            params),
            "chosen": choose_algo(int(b), topo, params),
        })
    return rows
