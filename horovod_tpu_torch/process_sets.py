"""Process sets: collectives over a subset of the ranks.

Counterpart of ``horovod_tpu/process_sets.py`` (reference:
``horovod/common/process_sets.py``).  Where the JAX package masks the
rows of non-members out of one program over the whole mesh, a set here
owns a ``torch.distributed`` group (``dist.new_group(ranks)``), as a set
owns a sub-communicator in Horovod.

torch requires **every rank of the world** to call ``new_group``, in the
same order, members or not.  So :func:`add_process_set` and
:func:`remove_process_set` are collective: every rank calls them with
the same ranks, in the same order, as in Horovod itself.  The table
(:class:`ProcessSetTable`) then holds the same ids on every rank.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple

import torch.distributed as dist


class ProcessSet:
    """A subset of the ranks that collectives may run over (reference:
    ``hvd.ProcessSet(ranks)``, ``.ranks``, ``.size()``, ``.rank()``,
    ``.included()``).  ``group`` is its ``torch.distributed`` group once
    registered: ``None`` for the global set (the default group), and
    ``dist.GroupMember.NON_GROUP_MEMBER`` on a rank outside the set."""

    def __init__(self, ranks: Sequence[int]):
        if len(set(ranks)) != len(ranks):
            raise ValueError(f"Duplicate ranks in process set: {ranks}")
        self.ranks: Tuple[int, ...] = tuple(sorted(int(r) for r in ranks))
        self.process_set_id: Optional[int] = None  # set on registration
        self.group = None

    def size(self) -> int:
        return len(self.ranks)

    def included(self, rank: Optional[int] = None) -> bool:
        """Whether ``rank`` (default: this process's) is a member."""
        if rank is None:
            from . import basics

            rank = basics.rank()
        return rank in self.ranks

    def rank(self, global_rank: Optional[int] = None) -> int:
        """Position of ``global_rank`` (default: this process's) in the
        set."""
        if global_rank is None:
            from . import basics

            global_rank = basics.rank()
        if global_rank not in self.ranks:
            raise ValueError(
                f"Rank {global_rank} is not in process set {self.ranks}")
        return self.ranks.index(global_rank)

    def __repr__(self) -> str:
        return f"ProcessSet(id={self.process_set_id}, ranks={list(self.ranks)})"

    def __eq__(self, other) -> bool:
        return isinstance(other, ProcessSet) and self.ranks == other.ranks

    def __hash__(self) -> int:
        return hash(self.ranks)


class ProcessSetTable:
    """The live process sets of a session (reference: ``ProcessSetTable``
    in ``process_set.cc``).  Id 0 is always the global set."""

    def __init__(self, world_size: int) -> None:
        self._lock = threading.Lock()
        self._next_id = 0                        # guarded-by: _lock
        self._table: Dict[int, ProcessSet] = {}  # guarded-by: _lock
        self._world_size = world_size
        self.global_process_set = self.register(ProcessSet(range(world_size)))

    def register(self, ps: ProcessSet) -> ProcessSet:
        """Collective: every rank registers the same set in the same
        order (the global set needs no group)."""
        with self._lock:
            for existing in self._table.values():
                if existing.ranks == ps.ranks:
                    raise ValueError(
                        f"A process set with ranks {list(ps.ranks)} already "
                        f"exists (id={existing.process_set_id})")
            for r in ps.ranks:
                if not 0 <= r < self._world_size:
                    raise ValueError(f"Process set rank {r} out of range for "
                                     f"world size {self._world_size}")
            if self._next_id:           # the global set keeps group None
                ps.group = dist.new_group(list(ps.ranks))
            ps.process_set_id = self._next_id
            self._table[self._next_id] = ps
            self._next_id += 1
            return ps

    def find(self, ranks) -> Optional[ProcessSet]:
        """The registered set of exactly ``ranks``, or None."""
        key = tuple(sorted(int(r) for r in ranks))
        with self._lock:
            for ps in self._table.values():
                if ps.ranks == key:
                    return ps
        return None

    def remove(self, ps: ProcessSet) -> None:
        """Collective, as :meth:`register`: every rank removes the set,
        and each member destroys its group."""
        with self._lock:
            if ps.process_set_id == 0:
                raise ValueError("Cannot remove the global process set")
            if self._table.get(ps.process_set_id) is not ps:
                raise ValueError(f"Process set {ps} is not registered")
            del self._table[ps.process_set_id]
            _destroy(ps)

    def clear(self) -> None:
        """Drop every set (``shutdown``), destroying the members' groups."""
        with self._lock:
            for ps in self._table.values():
                _destroy(ps)
            self._table.clear()


def destroy_group(group) -> None:
    """Destroy ``group`` on a member (a no-op for the default group and
    on a rank outside it)."""
    if (group not in (None, dist.GroupMember.NON_GROUP_MEMBER)
            and dist.is_initialized()):
        dist.destroy_process_group(group)


def _destroy(ps: ProcessSet) -> None:
    destroy_group(ps.group)
    ps.group = None
    ps.process_set_id = None


def _table() -> ProcessSetTable:
    from . import basics

    return basics._require().process_sets


def add_process_set(ranks_or_set) -> ProcessSet:
    """Register a process set (reference: ``hvd.add_process_set``).
    Collective: every rank of the world calls it with the same ranks, in
    the same order, members or not; it returns the registered set."""
    ps = (ranks_or_set if isinstance(ranks_or_set, ProcessSet)
          else ProcessSet(ranks_or_set))
    return _table().register(ps)


def remove_process_set(ps: ProcessSet) -> None:
    """Reference: ``hvd.remove_process_set``.  Collective, as
    :func:`add_process_set`."""
    _table().remove(ps)


def global_process_set() -> ProcessSet:
    """The set of every rank, id 0."""
    return _table().global_process_set
