"""Int8-quantized allreduce over ``torch.distributed``: values are int8
on the wire only, with one f32 scale per block of ``block_size``
elements (default 1024), and every sum is taken in f32.

Counterpart of ``horovod_tpu/ops/quantization.py``, with the same block,
pad and ``n == 1`` rules.  The allreduce is four phases:

1. quantize blockwise → ``all_to_all_single`` of the int8 chunks and of
   the f32 scale sidecar;
2. dequantize the ``n`` contributions and sum them in f32 (average
   divides by ``n``);
3. requantize the shard → ``all_gather_into_tensor`` of int8 and scales;
4. dequantize every shard → the full result.

The arithmetic of phases 1–4 is the kernels' of
:mod:`.int8_kernels`.

The eager ``hvd.allreduce(compression=Compression.int8)`` runs another
tier, :func:`int8_stack_allreduce_async`, with the numerics of the
reference's eager API (``simulate_int8_stack_reduce``): each rank's
whole tensor is quantized **once**, in blocks counted from its element 0,
gathered, and summed in f32, at ``n == 1`` too (a bf16 or f16 tensor's
contributions are each rounded to its dtype before the sum, and the sum
divided in the dtype).  It cannot reuse the
reduce-scatter, whose blocks are counted per destination chunk.  The JAX package has two tiers here (plain XLA,
and Pallas under ``HVD_TPU_TOPO_KERNEL=pallas``); the port has this one
wire, which runs its kernels in every phase and so is the fused tier
too (:mod:`.fused_collectives` exports it under the Pallas tier's
names).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .collectives import Handle
from .int8_kernels import (dequantize_accumulate, dequantize_blocks,
                           quantize_blocks)


def _check_op(op: str) -> None:
    if op not in ("sum", "average"):
        raise ValueError(
            f"int8 transport supports op=sum/average, got {op!r} "
            "(min/max/product need exact comparisons; drop compression)")


def _world(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def int8_reducescatter_start(x: torch.Tensor, *, op: str = "sum",
                             group=None, block_size: int = 1024) -> Handle:
    """Start the reduce-scatter with int8 transport (phases 1–2): quantize
    (B2) and issue the two ``all_to_all_single`` calls, payload and
    scales, as async works; the handle's finish step sums the ``n``
    contributions (B3), cuts the pad and divides for Average.  ``x`` is a
    flat per-rank vector whose size divides the world; the result is this
    rank's reduced ``size / n`` shard in ``x``'s dtype."""
    _check_op(op)
    n = _world(group)
    flat = x.to(torch.float32).reshape(-1)
    if flat.numel() % n:
        raise ValueError(f"size {flat.numel()} not divisible by group {n}")
    if n == 1:
        return Handle([], lambda: flat.to(x.dtype))  # degenerate world
    k = flat.numel() // n
    b = max(1, min(block_size, k))
    pad = (-k) % b
    chunks = flat.reshape(n, k)
    if pad:  # pad each destination chunk's tail to whole blocks
        chunks = torch.cat([chunks, chunks.new_zeros((n, pad))], dim=1)
    m = (k + pad) // b
    q1, s1 = quantize_blocks(chunks.reshape(n * m, b))
    # Chunk j goes to rank j: I receive m blocks of MY shard from each
    # peer, peer-major.
    rows = torch.empty_like(q1)
    s_rows = torch.empty_like(s1)
    works = [dist.all_to_all_single(rows, q1, group=group, async_op=True),
             dist.all_to_all_single(s_rows, s1, group=group, async_op=True)]

    def finish():
        partial = dequantize_accumulate(rows.reshape(n, m, b),
                                        s_rows.reshape(n, m)).reshape(-1)
        if pad:
            partial = partial[:-pad]
        if op == "average":
            partial = partial / n
        return partial.to(x.dtype)

    return Handle(works, finish)


def int8_reducescatter(x: torch.Tensor, *, op: str = "sum", group=None,
                       block_size: int = 1024) -> torch.Tensor:
    """Reduce-scatter with int8 transport, synchronous
    (:func:`int8_reducescatter_start`, waited)."""
    return int8_reducescatter_start(x, op=op, group=group,
                                    block_size=block_size).wait()


def _gather_quantized_start(shard: torch.Tensor, group, block_size: int):
    """Quantize ``shard`` (B2) and start the all-gather of payload and
    scales: ``(q [n, m, b], s [n, m], k, works)``."""
    n = _world(group)
    flat = shard.to(torch.float32).reshape(-1)
    k = flat.numel()
    b = max(1, min(block_size, k))
    pad = (-k) % b
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    m = flat.numel() // b
    q, s = quantize_blocks(flat.reshape(m, b))
    q_all = q.new_empty((n * m, b))
    s_all = s.new_empty(n * m)
    works = [dist.all_gather_into_tensor(q_all, q, group=group,
                                         async_op=True),
             dist.all_gather_into_tensor(s_all, s, group=group,
                                         async_op=True)]
    return q_all.reshape(n, m, b), s_all.reshape(n, m), k, works


def gather_quantized(shard: torch.Tensor, *, group=None,
                     block_size: int = 1024):
    """Phase 3 up to the wire: quantize this rank's flat shard of ``k``
    elements in blocks of ``min(block_size, k)`` (the tail zero padded)
    and all-gather payload and scales: returns ``(q [n, m, b] int8,
    s [n, m] f32, k)``, rank-major."""
    q, s, k, works = _gather_quantized_start(shard, group, block_size)
    for w in works:
        w.wait()
    return q, s, k


def int8_allgather_start(shard: torch.Tensor, *, group=None,
                         block_size: int = 1024) -> Handle:
    """Start the all-gather with int8 transport (phases 3–4); the
    handle's finish step dequantizes every shard (B4).  Its result is
    ``[n * size]`` flat, rank-major, in the shard's dtype."""
    n = _world(group)
    if n == 1:
        return Handle([], lambda: shard.to(torch.float32).reshape(-1)
                      .to(shard.dtype))
    q, s, k, works = _gather_quantized_start(shard, group, block_size)

    def finish():
        _, m, b = q.shape
        out = dequantize_blocks(q.reshape(n * m, b),
                                s.reshape(-1)).reshape(n, -1)
        return out[:, :k].reshape(-1).to(shard.dtype)

    return Handle(works, finish)


def int8_allgather(shard: torch.Tensor, *, group=None,
                   block_size: int = 1024) -> torch.Tensor:
    """All-gather with int8 transport, synchronous
    (:func:`int8_allgather_start`, waited)."""
    return int8_allgather_start(shard, group=group,
                                block_size=block_size).wait()


def int8_allreduce(x: torch.Tensor, *, op: str = "sum", group=None,
                   block_size: int = 1024) -> torch.Tensor:
    """Allreduce with int8 transport: :func:`int8_reducescatter` then
    :func:`int8_allgather`.  ``op`` is sum or average; the result has
    ``x``'s shape and dtype.  In a world of one it returns ``x``."""
    _check_op(op)
    n = _world(group)
    if n == 1:
        return x
    flat = x.to(torch.float32).reshape(-1)
    pad = (-flat.numel()) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    shard = int8_reducescatter(flat, op=op, group=group,
                               block_size=block_size)
    out = int8_allgather(shard, group=group, block_size=block_size)
    if pad:
        out = out[:-pad]
    return out.reshape(x.shape).to(x.dtype)


def int8_stack_allreduce_async(x: torch.Tensor, *, op: str = "sum",
                               group=None, block_size: int = 1024) -> Handle:
    """Start the eager int8 allreduce over ``group`` (reference:
    ``Int8Compressor.compress_stack`` → ``simulate_int8_stack_reduce``
    → the f32 sum): quantize this rank's flat tensor (B2) in blocks of
    ``wire_block_size(numel, n)`` from element 0, the tail zero padded;
    all-gather payload and scales; in the handle's finish step sum the
    ``n`` contributions in rank order (B3) and divide by ``n`` for
    Average.  A bf16 or f16 ``x`` takes :func:`_half_stack_sum` instead,
    which rounds each contribution to the dtype first, as the reference
    does.  Every member ends with the same bits; the result has ``x``'s
    shape and dtype."""
    _check_op(op)
    n = _world(group)
    flat = x.detach().to(torch.float32).reshape(-1)
    numel = flat.numel()
    b = wire_block_size(numel, n, block_size)
    pad = (-numel) % b
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    m = flat.numel() // b
    q, s = quantize_blocks(flat.reshape(m, b))
    works = []
    if n > 1:
        q_all, s_all = q.new_empty((n * m, b)), s.new_empty(n * m)
        works = [dist.all_gather_into_tensor(q_all, q, group=group,
                                             async_op=True),
                 dist.all_gather_into_tensor(s_all, s, group=group,
                                             async_op=True)]
        q, s = q_all, s_all

    def finish():
        if x.dtype in _HALF:
            return _half_stack_sum(q, s, n, numel, op,
                                   x.dtype).reshape(x.shape)
        acc = dequantize_accumulate(q.reshape(n, m, b),
                                    s.reshape(n, m)).reshape(-1)[:numel]
        if op == "average":
            acc = acc / n
        return acc.reshape(x.shape).to(x.dtype)

    return Handle(works, finish)


_HALF = (torch.bfloat16, torch.float16)


def _half_stack_sum(q: torch.Tensor, s: torch.Tensor, n: int, numel: int,
                    op: str, dtype: torch.dtype) -> torch.Tensor:
    """The eager tier's sum for a bf16 or f16 tensor, as the reference
    computes it (``simulate_int8_stack_reduce`` returns each
    contributor's dequantized row in the input dtype, ``_reduce_stack``
    sums the rows and divides in that dtype): dequantize every
    contribution (B4), round each to the dtype, add them in f32 in rank
    order from zero, round the sum to the dtype once, divide by ``n``
    in the dtype for Average.  Flat ``[numel]`` in the dtype."""
    rows = dequantize_blocks(q.reshape(-1, q.shape[-1]), s.reshape(-1))
    rows = rows.reshape(n, -1)[:, :numel].to(dtype)
    acc = torch.zeros(numel, dtype=torch.float32, device=rows.device)
    for row in rows:
        acc = acc + row.to(torch.float32)
    acc = acc.to(dtype)
    return acc / n if op == "average" else acc


def quant_dequant(x: torch.Tensor, block_size: int = 1024) -> torch.Tensor:
    """Blockwise int8 quantize → dequantize of one tensor (flattened;
    shape and dtype kept): the local loss of the wire's phase 1, whose
    complement error feedback accumulates."""
    f32 = x.to(torch.float32).reshape(-1)
    b = max(1, min(block_size, f32.numel())) if f32.numel() else 1
    pad = (-f32.numel()) % b
    if pad:
        f32 = torch.cat([f32, f32.new_zeros(pad)])
    q, scale = quantize_blocks(f32.reshape(-1, b))
    deq = dequantize_blocks(q, scale).reshape(-1)
    if pad:
        deq = deq[:-pad]
    return deq.reshape(x.shape).to(x.dtype)


def wire_block_size(elems_per_contributor: int, n: int,
                    block_size: int = 1024) -> int:
    """The block the wire quantizes with: ``min(block_size,
    ceil(elems / n))``, since blocks never span a destination chunk."""
    k = max(1, -(-int(elems_per_contributor) // max(1, int(n))))
    return max(1, min(int(block_size), k))
