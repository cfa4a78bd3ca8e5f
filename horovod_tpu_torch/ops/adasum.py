"""Adasum: scale-invariant adaptive summation of gradients.

Counterpart of ``horovod_tpu/ops/adasum.py`` (math per the Adasum paper,
arXiv:2006.02924).  Combining two contributions ``a`` and ``b``::

    adasum(a, b) = (1 - a·b / (2·a·a)) · a + (1 - a·b / (2·b·b)) · b

so parallel gradients average and orthogonal ones add.  Over a set of
``n`` ranks it runs the reference's distance-doubling tree: with ``p``
the largest power of two ≤ ``n``, the ``n - p`` extra members first
fold into members ``0 … n-p-1``; then ``log2(p)`` rounds combine each
member ``i < p`` with its partner ``i ^ 2^l``; last, the extra members
receive the result.  Each round's pairwise exchange is one
``all_to_all_single`` over the set in which every rank sends to at most
one partner.  The combine is symmetric bit for bit (its three dots are
the same sums on both partners, and ``x + y == y + x``), so every member
ends with the same bits.  Plain torch ops: the reference computes
Adasum in plain jnp, so there is no kernel here.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.distributed as dist


def combine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The symmetric pairwise rule: dots in f32, a zero operand's
    division guarded (its coefficient multiplies zero), the result in
    ``a``'s dtype."""
    af = a.to(torch.float32)
    bf = b.to(torch.float32)
    dot = (af * bf).sum()
    asq = (af * af).sum()
    bsq = (bf * bf).sum()
    zero = torch.zeros((), dtype=torch.float32, device=a.device)
    ca = 1.0 - torch.where(asq > 0, dot / (2.0 * asq), zero)
    cb = 1.0 - torch.where(bsq > 0, dot / (2.0 * bsq), zero)
    return (ca * af + cb * bf).to(a.dtype)


def _exchange(v: torch.Tensor, send_to: Optional[int],
              recv_from: Optional[int], n: int, group
              ) -> Optional[torch.Tensor]:
    """One round's exchange: every member of ``group`` calls it; this
    rank sends ``v`` to position ``send_to`` and receives a tensor of
    ``v``'s shape from ``recv_from`` (either may be None)."""
    flat = v.contiguous().reshape(-1)
    sends, recvs = [0] * n, [0] * n
    if send_to is not None:
        sends[send_to] = flat.numel()
    if recv_from is not None:
        recvs[recv_from] = flat.numel()
    out = flat.new_empty(sum(recvs))
    dist.all_to_all_single(out, flat if send_to is not None else flat[:0],
                           output_split_sizes=recvs, input_split_sizes=sends,
                           group=group)
    return out.reshape(v.shape) if recv_from is not None else None


def adasum_allreduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Adasum of ``x`` over the members of ``group`` (every member calls
    it); returns a new tensor, the same bits on every member."""
    n = dist.get_world_size(group) if dist.is_initialized() else 1
    if n <= 1:
        return x.clone()
    me = dist.get_rank(group)
    p = 1 << (n.bit_length() - 1)
    r = n - p
    v = x
    if r:   # pre-fold: extra member p + e sends to e
        got = _exchange(v, me - p if me >= p else None,
                        me + p if me < r else None, n, group)
        if got is not None:
            v = combine(v, got)
    d = 1
    while d < p:
        partner = me ^ d if me < p else None
        got = _exchange(v, partner, partner, n, group)
        if got is not None:
            v = combine(v, got)
        d *= 2
    if r:   # post-scatter: e returns the result to p + e
        got = _exchange(v, me + p if me < r else None,
                        me - p if me >= p else None, n, group)
        if got is not None:
            v = got
    return v


def adasum_pytree(tree: Mapping[str, torch.Tensor],
                  group=None) -> Dict[str, torch.Tensor]:
    """Adasum of every leaf on its own (its dots are per tensor, so leaves
    are not fused), in the mapping's order."""
    return {name: adasum_allreduce(leaf, group) for name, leaf in tree.items()}
