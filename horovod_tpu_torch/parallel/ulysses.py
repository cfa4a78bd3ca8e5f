"""Ulysses-style all-to-all sequence parallelism.

Counterpart of ``horovod_tpu/parallel/ulysses.py``.  Instead of rotating
K/V (ring), one all-to-all re-partitions q, k and v from sequence-sharded
to head-sharded, each rank runs full-sequence attention
(:func:`.ring_attention.full_attention`, plain torch, as the reference's
is plain jnp) for its share of the heads, and a second all-to-all
restores sequence sharding.  Two collectives a call, each moving
``b·T·h·d / sp`` elements a rank.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

from .comm import all_to_all
from .ring_attention import full_attention, seq_parallel_call


def _ulysses_local(q, k, v, *, axis, causal: bool, scale):
    """Local shards ``[b, t, h, d]`` (t = T / sp) → the same shape.
    All-to-all #1 scatters heads and gathers the sequence into ``[b, T,
    h / sp, d]``; full attention; all-to-all #2 is the inverse.  Needs
    ``h % sp == 0``."""
    n = axis.size
    b, t, h, d = q.shape
    if h % n != 0:
        raise ValueError(
            f"Ulysses sequence parallelism needs heads ({h}) divisible by "
            f"the sp axis size ({n}); use ring attention otherwise."
        )

    def seq2head(x):  # [b, t, h, d] -> [b, T, h/n, d], T in rank order
        x = x.reshape(b, t, n, h // n, d).permute(2, 0, 1, 3, 4)
        x = all_to_all(x, axis)                   # [n(src), b, t, h/n, d]
        return x.permute(1, 0, 2, 3, 4).reshape(b, n * t, h // n, d)

    def head2seq(x):  # [b, T, h/n, d] -> [b, t, h, d]
        x = x.reshape(b, n, t, h // n, d).permute(1, 0, 2, 3, 4)
        x = all_to_all(x, axis)                   # [n(head chunk), b, t, ...]
        return x.permute(1, 2, 0, 3, 4).reshape(b, t, h, d)

    out = full_attention(seq2head(q), seq2head(k), seq2head(v),
                         causal=causal, scale=scale)
    return head2seq(out)


def ulysses_attention(q, k, v, *, mesh=None, sp_axis: str = "sp",
                      causal: bool = False,
                      scale: Optional[float] = None, plan=None):
    """Ulysses attention on this rank's ``[b, t, h, d]`` shards, with the
    contract of :func:`.ring_attention.ring_self_attention`."""
    return seq_parallel_call(
        partial(_ulysses_local, causal=causal, scale=scale),
        q, k, v, mesh=mesh, sp_axis=sp_axis, plan=plan)
