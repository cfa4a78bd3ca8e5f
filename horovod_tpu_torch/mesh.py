"""The 1-D world: every rank on one named axis.

Counterpart of ``horovod_tpu/mesh.py`` (``GlobalMesh``).  The reference
builds a ``jax.sharding.Mesh`` over every device; here one process drives
one card, so a slot is a rank and the mesh is a :class:`Mesh` of one
axis, ``hvd``, of width ``size()``.  It is
the mesh behind :meth:`horovod_tpu_torch.plan.MeshPlan.default` and
``hvd.global_mesh()``, with the reference's slot arithmetic.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over a C-order grid of ranks: the port's
    ``jax.sharding.Mesh``.  Rank ``r`` sits at ``np.unravel_index(r,
    sizes)``, so the last axis varies fastest (nearest neighbours)."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.sizes, dtype=np.int64))

    @property
    def ranks(self) -> np.ndarray:
        """The rank grid, ``np.arange(size).reshape(sizes)``."""
        return np.arange(self.size).reshape(self.sizes)

    def coords(self, rank: int) -> Dict[str, int]:
        """Rank ``rank``'s index along every axis."""
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is outside the mesh {self.shape}")
        idx = np.unravel_index(rank, self.sizes)
        return {n: int(i) for n, i in zip(self.axis_names, idx)}

    def groups(self, axes: Sequence[str]):
        """The rank groups along ``axes``: every group varies those axes
        (C-order, in the mesh's axis order) while pinning the others;
        the groups come in C-order of the pinned axes."""
        missing = [a for a in axes if a not in self.axis_names]
        if missing:
            raise ValueError(f"mesh has no axis {missing[0]!r}: "
                             f"{self.axis_names}")
        idx = [i for i, n in enumerate(self.axis_names) if n in axes]
        width = int(np.prod([self.sizes[i] for i in idx], dtype=np.int64))
        moved = np.moveaxis(self.ranks, idx, list(range(-len(idx), 0)))
        return [list(map(int, row)) for row in moved.reshape(-1, width)]


@dataclasses.dataclass(frozen=True)
class GlobalMesh:
    """A 1-D mesh over every rank plus the slot arithmetic of the
    reference (one slot a process)."""

    mesh: Mesh
    axis_name: str
    rank: int
    local_rank: int
    local_size: int

    @staticmethod
    def build(size: int, rank: int, local_rank: int, local_size: int,
              axis_name: str = "hvd") -> "GlobalMesh":
        return GlobalMesh(mesh=Mesh((axis_name,), (int(size),)),
                          axis_name=axis_name, rank=rank,
                          local_rank=local_rank, local_size=local_size)

    @property
    def size(self) -> int:
        return self.mesh.size

    @property
    def process_first_slot(self) -> int:
        """This process's first slot: its rank, one card a process."""
        return self.rank

    @property
    def slots_per_process(self):
        return [1] * self.size
