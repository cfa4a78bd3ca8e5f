"""Gradient wire compression: ``Compression.none/fp16/bf16/int8``.

Counterpart of ``horovod_tpu/ops/compression.py``.  A compressor owns
how an allreduce or a reduce-scatter moves its bytes
(:meth:`Compressor.spmd_allreduce`, :meth:`Compressor.spmd_reducescatter`)
and what this rank's lossy transport discards
(:meth:`Compressor.local_error`, the error-feedback residual).  The
cast tiers compose compress → allreduce → decompress; the int8 tier
runs its own quantized decomposition (:mod:`.quantization`).
"""

from __future__ import annotations

import torch

from . import collectives
from .quantization import int8_allreduce, int8_reducescatter, quant_dequant


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
        wire, ctx = cls.compress(x)
        red = collectives.reducescatter_raw(wire, op, group=group)
        return cls.decompress(red, ctx)


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
    :meth:`spmd_allreduce` and :meth:`spmd_reducescatter`;
    ``compress``/``decompress`` are the identity
    (the port has no in-process stack tier to simulate)."""

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
    def spmd_reducescatter(cls, x, *, op, group=None):
        """The int8 reduce-scatter (:func:`.quantization.int8_reducescatter`).
        Its contract is narrower than the base class's: ``x`` is a flat
        1-D vector whose size the world divides, and the result is this
        rank's flat shard, not a dim-0 piece of a many-dimensional
        tensor.  Anything else raises."""
        if not x.is_floating_point():
            return super().spmd_reducescatter(x, op=op, group=group)
        if x.dim() != 1:
            raise ValueError(
                f"Int8Compressor.spmd_reducescatter requires a flat 1-D "
                f"input (got shape {tuple(x.shape)}); it scatters the "
                "flattened vector, not dim 0: reshape(-1) first or use "
                "Compression.fp16/bf16 for dim-0 semantics")
        return int8_reducescatter(x, op=op, group=group)


class Compression:
    """``hvd.Compression``: none, fp16, bf16 and int8."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    int8 = Int8Compressor
