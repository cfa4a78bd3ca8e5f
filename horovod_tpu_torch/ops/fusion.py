"""Tensor fusion: bucket many small tensors into few large collectives.

Counterpart of ``horovod_tpu/ops/fusion.py``'s flat path: leaves are
grouped by dtype, bucketed greedily in order up to ``threshold`` bytes
(:func:`plan_buckets_py`), each bucket is concatenated into one flat
tensor, reduced with one collective, and split back.

A pytree here is a flat mapping from dotted parameter names to tensors
(``block_0.attn.qkv.kernel``).  :func:`tree_flatten` orders it as
``jax.tree.flatten`` orders the reference's nested dicts, sorting the
keys at every level.  The order matters: the int8 wire quantizes blocks
that span leaf boundaries inside a bucket, so another order would
quantize other elements together.

Two-phase buckets, the topology schedule and overlap are not ported.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Sequence, Tuple

import torch

from .compression import Compression

DEFAULT_THRESHOLD = 64 * 1024 * 1024


def plan_buckets_py(sizes_bytes: Sequence[int],
                    threshold: int) -> List[List[int]]:
    """Greedy in-order bin packing of byte sizes into buckets of at most
    ``threshold`` bytes (an oversized tensor gets a bucket of its own)."""
    buckets: List[List[int]] = []
    current: List[int] = []
    current_bytes = 0
    for i, sz in enumerate(sizes_bytes):
        if current and current_bytes + sz > threshold:
            buckets.append(current)
            current, current_bytes = [], 0
        current.append(i)
        current_bytes += sz
    if current:
        buckets.append(current)
    return buckets


def tree_flatten(tree: Mapping[str, torch.Tensor],
                 ) -> Tuple[List[str], List[torch.Tensor]]:
    """(names, leaves) in the reference's flatten order: keys sorted at
    every level of the dotted path."""
    names = sorted(tree, key=lambda name: name.split("."))
    return names, [tree[n] for n in names]


def plan_fused_buckets(leaves: Sequence[torch.Tensor],
                       threshold: int) -> List[List[int]]:
    """The fusion plan of ``leaves``: per dtype (in order of first
    appearance), their indices bucketed greedily in order by bytes."""
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault(leaf.dtype, []).append(i)
    plan = []
    for dtype, idxs in by_dtype.items():
        itemsize = torch.empty((), dtype=dtype).element_size()
        sizes = [leaves[i].numel() * itemsize for i in idxs]
        plan += [[idxs[j] for j in bucket]
                 for bucket in plan_buckets_py(sizes, threshold)]
    return plan


def fused_apply(leaves: Sequence[torch.Tensor],
                collective_1d: Callable[[torch.Tensor], torch.Tensor],
                threshold: int) -> List[torch.Tensor]:
    """Apply ``collective_1d`` to ``leaves`` with fusion
    (:func:`plan_fused_buckets`): concatenate each bucket, reduce it
    once, split it back to each leaf's shape."""
    out: List[torch.Tensor] = [None] * len(leaves)  # type: ignore[list-item]
    for members in plan_fused_buckets(leaves, threshold):
        flats = [leaves[i].reshape(-1) for i in members]
        fused = torch.cat(flats) if len(flats) > 1 else flats[0]
        reduced = collective_1d(fused)
        pieces = torch.split(reduced, [f.numel() for f in flats])
        for i, piece in zip(members, pieces):
            out[i] = piece.reshape(leaves[i].shape)
    return out


def fused_allreduce_pytree(tree: Mapping[str, torch.Tensor], *,
                           op: str = "average",
                           threshold: int = DEFAULT_THRESHOLD,
                           group=None, compression=None,
                           prescale_factor: float = 1.0,
                           postscale_factor: float = 1.0,
                           ) -> Dict[str, torch.Tensor]:
    """Fused allreduce of every leaf of ``tree`` (the gradient hot
    path), in :func:`tree_flatten` order: returns a new mapping with the
    same names."""
    compression = compression or Compression.none

    def collective(flat: torch.Tensor) -> torch.Tensor:
        x = flat
        if prescale_factor != 1.0:
            x = x * prescale_factor
        x = compression.spmd_allreduce(x, op=op, group=group)
        if postscale_factor != 1.0:
            x = x * postscale_factor
        return x

    names, leaves = tree_flatten(tree)
    return dict(zip(names, fused_apply(leaves, collective, threshold)))
