"""Input-pipeline utilities: shard, pad, mask.

The reference handles ragged/uneven data with the runtime ``Join`` op
(ranks that exhaust data keep collectives alive with zeros — SURVEY.md
§2.1 message types).  Under XLA SPMD every slot must execute the same
program, so unevenness is resolved *before* the step: pad the final
batch to a static shape and mask the loss.  These helpers make that the
one-liner the reference's ``join()`` was.

Counterpart of ``horovod_tpu/data.py``: the same batches, masks and
negotiated step counts; :func:`masked_mean` and
:func:`global_masked_mean` take torch tensors, and the global mean sums
over a process set or a mesh axis's group of the port's ranks.
"""

from __future__ import annotations

import math
from typing import Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


def pad_batch(batch: np.ndarray, batch_size: int,
              pad_value=0) -> Tuple[np.ndarray, np.ndarray]:
    """Pad ``batch`` (leading axis) up to ``batch_size``; returns
    ``(padded, mask)`` with ``mask[i]=1`` for real rows — feed the mask
    into :func:`masked_mean` in the loss."""
    n = batch.shape[0]
    if n > batch_size:
        raise ValueError(f"batch of {n} rows exceeds batch_size {batch_size}")
    mask = np.zeros((batch_size,), np.float32)
    mask[:n] = 1.0
    if n == batch_size:
        return batch, mask
    pad_shape = (batch_size - n,) + batch.shape[1:]
    pad = np.full(pad_shape, pad_value, dtype=batch.dtype)
    return np.concatenate([batch, pad], axis=0), mask


def masked_mean(values: torch.Tensor, mask) -> torch.Tensor:
    """Mean over real (unmasked) entries; safe when a rank's shard is all
    padding (the ``join``-with-zeros situation)."""
    mask = torch.as_tensor(mask, device=values.device).to(values.dtype)
    total = torch.sum(values * mask)
    count = torch.clamp(torch.sum(mask), min=1)
    return total / count


class ShardedBatchIterator:
    """Iterate ``(batch, mask)`` pairs of a fixed global batch size over
    an array dataset, padding the tail — every rank sees the same number
    of steps regardless of dataset divisibility (the SPMD invariant the
    reference's elastic/join machinery protects at runtime).

    For per-process loading in multi-controller deployments, pass
    ``rank``/``world`` to read only this process's rows.
    """

    def __init__(self, *arrays: np.ndarray, batch_size: int,
                 rank: int = 0, world: int = 1, shuffle: bool = False,
                 seed: int = 0, drop_remainder: bool = False) -> None:
        n = arrays[0].shape[0]
        for a in arrays:
            if a.shape[0] != n:
                raise ValueError("all arrays need equal leading dims")
        self.arrays = arrays
        self.batch_size = batch_size
        self.rank = rank
        self.world = world
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.epoch = 0

    def __len__(self) -> int:
        # Every rank MUST report the same step count (the SPMD invariant):
        # derive it from the largest/smallest shard, not this rank's.
        n = self.arrays[0].shape[0]
        if self.drop_remainder:
            min_rows = n // self.world
            return min_rows // self.batch_size
        max_rows = math.ceil(n / self.world)
        return math.ceil(max_rows / self.batch_size)

    def __iter__(self) -> Iterator[Tuple[Tuple[np.ndarray, ...], np.ndarray]]:
        n = self.arrays[0].shape[0]
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        my = order[self.rank::self.world]
        steps = len(self)
        for s in range(steps):
            idx = my[s * self.batch_size:(s + 1) * self.batch_size]
            padded, mask = None, None
            outs = []
            for a in self.arrays:
                p, mask = pad_batch(a[idx], self.batch_size)
                outs.append(p)
            yield tuple(outs), mask
        self.epoch += 1


# --- join: ragged per-rank datasets ----------------------------------------
#
# Reference: the JOIN message type (``hvd.join()`` — a rank out of data
# keeps answering collectives with zero tensors until every rank has
# joined; SURVEY.md §2.1, mount empty, unverified).  Under XLA SPMD a
# rank that stops entering the compiled step stops entering its
# collectives — so the join point moves from the runtime to the input
# pipeline: negotiate the global step count up front, then exhausted
# ranks feed zero batches with zero masks (the neutral element) for the
# remaining steps.  Combined with :func:`global_masked_mean` the result
# is *exact* — masked rows contribute nothing to the loss or gradient,
# and averages are over real samples only (the reference's Average
# over joined ranks divides by the active-rank count; dividing by the
# real-sample count is the per-example-exact version of that).


def negotiate_steps(local_steps: int) -> int:
    """The JOIN negotiation: one collective exchange of per-rank step
    counts; every rank returns the global maximum.  Works in-process and
    across real controllers (``allgather_object`` rides the framework's
    byte-tensor allgather)."""
    from .functions import allgather_object

    return int(max(allgather_object(int(local_steps))))


class JoinedBatchIterator:
    """Iterate a rank's *ragged* local shard for the negotiated global
    step count — the drop-in replacement for the reference's

    .. code-block:: python

        for batch in my_uneven_dataset: train(batch)
        hvd.join()

    Every rank constructs this over its own arrays (any leading-dim
    size, including zero rows); iteration yields ``(batch_tuple, mask)``
    of identical static shapes on every rank for exactly
    ``negotiate_steps(ceil(local_rows / batch_size))`` steps.  After the
    local shard is exhausted, batches and mask are all zeros — feed the
    mask through :func:`global_masked_mean` (or :func:`masked_mean`) so
    padded rows are neutral.

    Negotiation is collective, so it only happens at symmetric points
    every rank reaches: construction and each ``__iter__`` (an epoch) —
    shards may grow or shrink between epochs (elastic restarts
    re-negotiate).  ``len()`` is a pure read of the last negotiated
    count (rank-asymmetric ``len()`` calls — a tqdm on rank 0 only —
    must never issue a collective or the world deadlocks).
    """

    def __init__(self, *arrays: np.ndarray, batch_size: int,
                 shuffle: bool = False, seed: int = 0) -> None:
        n = arrays[0].shape[0]
        for a in arrays:
            if a.shape[0] != n:
                raise ValueError("all arrays need equal leading dims")
        self.arrays = arrays
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.local_steps = math.ceil(n / batch_size) if n else 0
        self.global_steps = negotiate_steps(self.local_steps)

    def __len__(self) -> int:
        return self.global_steps

    def __iter__(self) -> Iterator[Tuple[Tuple[np.ndarray, ...], np.ndarray]]:
        self.global_steps = negotiate_steps(self.local_steps)
        n = self.arrays[0].shape[0]
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        zero_mask = np.zeros((self.batch_size,), np.float32)
        for s in range(self.global_steps):
            if s < self.local_steps:
                idx = order[s * self.batch_size:(s + 1) * self.batch_size]
                outs, mask = [], None
                for a in self.arrays:
                    p, mask = pad_batch(a[idx], self.batch_size)
                    outs.append(p)
                yield tuple(outs), mask
            else:
                # Joined: neutral elements keep the compiled step (and
                # its collectives) running on this rank.
                yield tuple(np.zeros((self.batch_size,) + a.shape[1:],
                                     a.dtype) for a in self.arrays), zero_mask
        self.epoch += 1


class _Psum(torch.autograd.Function):
    """``psum`` over a group: the sum forward, and (psum's transpose)
    the sum of the cotangents backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def global_masked_mean(values: torch.Tensor, mask, *, process_set=None,
                       mesh=None, axis_name: Optional[str] = None
                       ) -> torch.Tensor:
    """Exact mean over real entries across ALL ranks of a group:
    ``psum(sum(values*mask)) / psum(sum(mask))``, differentiable with
    psum's transpose (the cotangents summed over the group), as the
    reference's inside ``shard_map``.

    The group is ``process_set``'s, else the ``axis_name`` group of
    ``mesh`` (or of the session plan), else the session plan's reduce
    group.  Use it as the loss reduction with
    :class:`JoinedBatchIterator` and the default ``op=hvd.Average``
    gradient reduction: a run over ragged shards then computes the
    gradients of one process over the concatenated data."""
    from .optim.distributed_optimizer import _mesh_group

    group = _mesh_group(mesh, axis_name, process_set, "global_masked_mean")
    mask = torch.as_tensor(mask, device=values.device).to(values.dtype)
    total = _Psum.apply(torch.sum(values * mask), group)
    count = _Psum.apply(torch.sum(mask), group)
    return total / torch.clamp(count, min=1)
