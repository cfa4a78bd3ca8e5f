"""Wire compression: ``Compression.none/fp16/bf16/int8``.

Counterpart of ``horovod_tpu/ops/compression.py``.  A compressor owns
how an allreduce or a reduce-scatter moves its bytes and what this
rank's lossy transport discards (:meth:`Compressor.local_error`, the
error-feedback residual).  It has two allreduce tiers, as the reference
has:

- the gradient wire, :meth:`Compressor.spmd_allreduce` (and its two
  phases :meth:`Compressor.spmd_reducescatter` and
  :meth:`Compressor.spmd_allgather`, each with an ``_async`` form
  returning a :class:`.collectives.Handle`), which the train steps run;
- the eager tier, :meth:`Compressor.eager_allreduce_async`, which
  ``hvd.allreduce`` and ``hvd.grouped_allreduce`` run.

The cast tiers compose compress → allreduce → decompress on both.  On
int8 the gradient wire is the quantized reduce-scatter + all-gather
(:func:`.quantization.int8_allreduce`) and the eager tier the stack
tier (:func:`.quantization.int8_stack_allreduce_async`): each rank's
tensor quantized once, gathered, and summed in f32.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from . import collectives
from .quantization import (int8_allgather_start, int8_allreduce,
                           int8_reducescatter_start,
                           int8_stack_allreduce_async, quant_dequant)


class Compressor:
    @staticmethod
    def compress(tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError

    @classmethod
    def local_error(cls, x, block_size=None):
        """``x - D(C(x))``: what this rank's lossy transport discards of
        ``x``, computed locally.  Exact tiers return zeros."""
        del block_size
        wire, ctx = cls.compress(x)
        return x - cls.decompress(wire, ctx).to(x.dtype)

    @classmethod
    def spmd_allreduce(cls, x, *, op, group=None):
        wire, ctx = cls.compress(x)
        red = collectives.reduce_raw(wire, op, group=group)
        return cls.decompress(red, ctx)

    @classmethod
    def spmd_reducescatter(cls, x, *, op, group=None):
        """Reduce-scatter over dim 0 on this tier's wire: this rank's
        ``1/n`` piece of the reduction (ZeRO's gradient wire)."""
        return cls.spmd_reducescatter_async(x, op=op, group=group).wait()

    @classmethod
    def spmd_reducescatter_async(cls, x, *, op, group=None):
        """:meth:`spmd_reducescatter` started: a :class:`Handle` whose
        result is the piece (the two-phase and overlap wires keep
        several in flight)."""
        wire, ctx = cls.compress(x)
        return collectives.reducescatter_start(
            wire, op, group, "spmd_reducescatter").then(
            lambda red: cls.decompress(red, ctx))

    @classmethod
    def spmd_allgather(cls, x, *, group=None):
        """The all-gather phase of the two-phase (reduce-scatter →
        all-gather) allreduce: compress this rank's shard, gather every
        rank's on the narrow wire along dim 0, decompress once."""
        return cls.spmd_allgather_async(x, group=group).wait()

    @classmethod
    def spmd_allgather_async(cls, x, *, group=None):
        """:meth:`spmd_allgather` started: a :class:`Handle`."""
        wire, ctx = cls.compress(x)
        wire = wire.contiguous()
        n = dist.get_world_size(group)
        full = wire.new_empty((n * wire.shape[0],) + tuple(wire.shape[1:]))
        work = dist.all_gather_into_tensor(full, wire, group=group,
                                           async_op=True)
        return collectives.Handle([work], lambda: cls.decompress(full, ctx))

    @classmethod
    def eager_allreduce_async(cls, x, *, op, group=None):
        """The eager Sum/Average (reference: ``_reduce_stack``): the sum
        on this tier's wire, then decompress, then (Average) the divide
        by ``n`` in ``x``'s dtype, in the handle's finish step."""
        n = dist.get_world_size(group)
        wire, ctx = cls.compress(x)
        out = wire.clone().contiguous()
        work = dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group,
                               async_op=True)

        def finish():
            r = cls.decompress(out, ctx)
            r = collectives.divide(r, n) if op == collectives.Average else r
            return r.to(x.dtype)

        return collectives.Handle([work], finish)


class NoneCompressor(Compressor):
    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class FP16Compressor(Compressor):
    """Cast floating tensors to float16 for the wire, back after."""

    wire_dtype = torch.float16

    @classmethod
    def compress(cls, tensor):
        if tensor.is_floating_point():
            return tensor.to(cls.wire_dtype), tensor.dtype
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor.to(ctx) if ctx is not None else tensor


class BF16Compressor(FP16Compressor):
    wire_dtype = torch.bfloat16


class Int8Compressor(Compressor):
    """Int8 transport with per-block f32 scales: about 4× fewer wire
    bytes than float32, every sum in f32.  The transport lives in
    :meth:`spmd_allreduce`, :meth:`spmd_reducescatter` and
    :meth:`eager_allreduce_async`; ``compress``/``decompress`` are the
    identity."""

    wire_itemsize = 1

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor

    @classmethod
    def local_error(cls, x, block_size=None):
        """Per-leaf EF residual: ``x - quant_dequant(x)`` at the wire's
        block (``quantization.wire_block_size`` for the world), or 1024
        when ``block_size`` is None."""
        if not x.is_floating_point():
            return torch.zeros_like(x)
        return x - quant_dequant(x, block_size=block_size or 1024)

    @classmethod
    def spmd_allreduce(cls, x, *, op, group=None):
        if not x.is_floating_point():
            return super().spmd_allreduce(x, op=op, group=group)
        return int8_allreduce(x, op=op, group=group)

    @classmethod
    def eager_allreduce_async(cls, x, *, op, group=None):
        if not x.is_floating_point():
            return super().eager_allreduce_async(x, op=op, group=group)
        return int8_stack_allreduce_async(x, op=op, group=group)

    @classmethod
    def spmd_reducescatter_async(cls, x, *, op, group=None):
        """The int8 reduce-scatter, started
        (:func:`.quantization.int8_reducescatter_start`).  Its contract
        is narrower than the base class's: ``x`` is a flat 1-D vector
        whose size the world divides, and the result is this rank's flat
        shard, not a dim-0 piece of a many-dimensional tensor.  Anything
        else raises."""
        if not x.is_floating_point():
            return super().spmd_reducescatter_async(x, op=op, group=group)
        if x.dim() != 1:
            raise ValueError(
                f"Int8Compressor.spmd_reducescatter requires a flat 1-D "
                f"input (got shape {tuple(x.shape)}); it scatters the "
                "flattened vector, not dim 0: reshape(-1) first or use "
                "Compression.fp16/bf16 for dim-0 semantics")
        return int8_reducescatter_start(x, op=op, group=group)

    @classmethod
    def spmd_allgather_async(cls, x, *, group=None):
        """The int8 all-gather, started
        (:func:`.quantization.int8_allgather_start`: B2, the gather of
        payload and scales, B4); exact for a non-floating shard."""
        if not x.is_floating_point():
            return super().spmd_allgather_async(x, group=group)
        return int8_allgather_start(x, group=group)


class Compression:
    """``hvd.Compression``: none, fp16, bf16 and int8."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    int8 = Int8Compressor
