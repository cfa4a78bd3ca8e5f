"""Ring attention: exact attention over sequences sharded across ranks.

Counterpart of ``horovod_tpu/parallel/ring_attention.py``.  Each rank of
the ``sp`` axis holds one block of ``t = T / sp`` tokens of q, k and v.
Over ``sp`` rounds the K/V blocks travel around the ring
(:func:`.comm.ring_stream`: round *s* sees the block that started ``s``
ranks behind), and the local queries attend each block in turn; the
blocks merge by streaming softmax, which is exact.

Two per-block engines, as in the reference: ``'xla'`` is the plain f32
streaming softmax (running max, numerator, denominator); ``'flash'`` runs
each block on the flash kernel (B1, ``csrc/flash_attention.cu``) through
:func:`..ops.flash_attention.flash_attention_with_lse` and merges blocks
by their logsumexp.  Under a causal mask the diagonal block is causal,
an earlier one is full, and a later one is skipped (the reference merges
it with lse −2e30, which leaves every accumulator as it was).

Where the reference splits global arrays in ``shard_map``, the port's
functions take each rank's local shards, ``[b, t, h, d]`` with the batch
split over ``dp``, the sequence over ``sp`` and the heads over ``tp``.
The masks use global positions, ``index · t + arange(t)``.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch

from .comm import ring_stream

NEG_INF = -1e30


def full_attention(q, k, v, *, causal: bool = False,
                   scale: Optional[float] = None, key_mask=None):
    """q ``[B, Tq, H, D]``, k/v ``[B, Tk, H, D]`` → ``[B, Tq, H, D]``:
    f32 scores and softmax, the product in q's dtype.  ``key_mask``
    (``[B, Tk]`` bool) drops False keys from every query's softmax."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    if causal:
        tq, tk = scores.shape[-2], scores.shape[-1]
        qpos = torch.arange(tq, device=q.device)[:, None]
        kpos = torch.arange(tk, device=q.device)[None, :]
        scores = torch.where(qpos >= kpos, scores, NEG_INF)
    if key_mask is not None:
        scores = torch.where(key_mask[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)


def _block_accumulate(q, k, v, num, den, m, qpos, kpos, scale, causal):
    """Merge one K/V block into the streaming-softmax accumulators."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    if causal:
        scores = torch.where(qpos[:, None] >= kpos[None, :], scores, NEG_INF)
    m_new = torch.maximum(m, scores.amax(dim=-1))            # [b, h, tq]
    p = torch.exp(scores - m_new[..., None])                 # [b, h, tq, tk]
    corr = torch.exp(m - m_new)
    num = num * corr[..., None] + torch.einsum(
        "bhqk,bkhd->bhqd", p, v.to(torch.float32))
    den = den * corr + p.sum(dim=-1)
    return num, den, m_new


def _accumulators(q):
    b, t, h, d = q.shape
    return (torch.zeros((b, h, t, d), dtype=torch.float32, device=q.device),
            torch.zeros((b, h, t), dtype=torch.float32, device=q.device),
            torch.full((b, h, t), NEG_INF, dtype=torch.float32,
                       device=q.device))


def _finish(q, num, den):
    out = num / torch.clamp_min(den, 1e-30)[..., None]       # [b, h, t, d]
    return out.permute(0, 2, 1, 3).to(q.dtype)               # [b, t, h, d]


def ring_attention_local(q, k, v, *, axis, causal: bool = False,
                         scale: Optional[float] = None,
                         engine: str = "xla"):
    """The per-rank ring body: ``q``/``k``/``v`` are this rank's local
    shards ``[b, t, h, d]`` and ``axis`` its ``sp``
    :class:`~..plan.AxisGroup`.  Round *s* attends the local queries to
    the K/V block of the rank ``s`` places behind.  Exact.

    ``engine='flash'`` computes each block with the flash kernel (B1)
    and merges blocks by logsumexp."""
    if engine == "flash":
        return _ring_flash_local(q, k, v, axis=axis, causal=causal,
                                 scale=scale)
    if engine != "xla":
        raise ValueError(f"unknown ring attention engine {engine!r}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    n, me = axis.size, axis.index
    t = q.shape[1]
    pos = torch.arange(t, device=q.device)
    num, den, m = _accumulators(q)
    blocks = ring_stream(torch.stack((k, v)), axis)
    for s, kv in enumerate(blocks):
        src = (me - s) % n
        num, den, m = _block_accumulate(q, kv[0], kv[1], num, den, m,
                                        me * t + pos, src * t + pos, scale,
                                        causal)
    return _finish(q, num, den)


def _ring_flash_local(q, k, v, *, axis, causal: bool,
                      scale: Optional[float]):
    """The ring body with the flash kernel (B1) as the per-block engine.
    A block is, relative to the local queries, the diagonal one (causal
    mask), an earlier one (full attention) or, under a causal mask, a
    later one (nothing attendable: skipped).  Blocks merge by streaming
    logsumexp: running max ``m``, output numerator and denominator.
    Differentiable: the lse cotangent reaches the flash backward."""
    from ..ops.flash_attention import flash_attention_with_lse

    if scale is None:
        scale = q.shape[-1] ** -0.5
    n, me = axis.size, axis.index
    num, den, m = _accumulators(q)
    blocks = ring_stream(torch.stack((k, v)), axis)
    for s, kv in enumerate(blocks):
        src = (me - s) % n
        if causal and src > me:
            continue
        o_b, lse_b = flash_attention_with_lse(
            q, kv[0], kv[1], causal=causal and src == me, scale=scale)
        o32 = o_b.permute(0, 2, 1, 3).to(torch.float32)
        m_new = torch.maximum(m, lse_b)
        corr = torch.exp(m - m_new)
        w = torch.exp(lse_b - m_new)
        num = num * corr[..., None] + o32 * w[..., None]
        den = den * corr + w
        m = m_new
    return _finish(q, num, den)


def seq_parallel_call(local_fn, q, k, v, *, mesh=None, sp_axis: str,
                      plan=None):
    """Run a sequence-parallel attention body on this rank's shards.

    The plan comes from ``plan=``, a ``mesh=`` wrapped, or the session's
    (:func:`..plan.resolve_plan`).  ``q``/``k``/``v`` are already this
    rank's ``[b, t, h, d]`` shards (the batch split over ``dp``, the
    heads over ``tp``: the reference's ``dp_axis``/``tp_axis``, which
    only place its global arrays), so only the ``sp_axis`` group takes
    part in the attention."""
    from ..plan import resolve_plan

    plan = resolve_plan(mesh, plan)
    if not plan.has_axis(sp_axis):
        raise ValueError(f"mesh has no axis {sp_axis!r}: {plan.axis_names}")
    return local_fn(q, k, v, axis=plan.group(sp_axis))


def ring_self_attention(q, k, v, *, mesh=None, sp_axis: str = "sp",
                        causal: bool = False,
                        scale: Optional[float] = None,
                        engine: str = "xla", plan=None):
    """Ring attention on this rank's shards (see
    :func:`seq_parallel_call`); the entry the models call.
    ``engine='flash'`` runs each block on the flash kernel."""
    return seq_parallel_call(
        partial(ring_attention_local, causal=causal, scale=scale,
                engine=engine),
        q, k, v, mesh=mesh, sp_axis=sp_axis, plan=plan)
