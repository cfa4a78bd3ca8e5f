"""Gradient compression for the TF binding.

Counterpart of ``horovod_tpu/tensorflow/compression.py`` (reference:
``horovod/tensorflow/compression.py``): ``Compression.none`` and
``Compression.fp16`` cast floating tensors wider than 16 bits to a
16-bit wire and back after the collective.  ``fp16`` is bfloat16 on the
wire, as the reference's is; ``true_fp16`` is IEEE float16.
"""

from __future__ import annotations

import tensorflow as tf


class Compressor:
    """Interface: ``compress(tensor) -> (wire, ctx)``;
    ``decompress(wire, ctx) -> tensor``."""

    @staticmethod
    def compress(tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    wire_dtype: "tf.DType" = tf.bfloat16

    @classmethod
    def compress(cls, tensor):
        if tensor.dtype.is_floating and tensor.dtype.size > 2:
            return tf.cast(tensor, cls.wire_dtype), tensor.dtype
        return tensor, None

    @classmethod
    def decompress(cls, tensor, ctx):
        return tensor if ctx is None else tf.cast(tensor, ctx)


class FP16Compressor(_CastCompressor):
    """16-bit wire: bfloat16, as the reference's ``Compression.fp16``."""
    wire_dtype = tf.bfloat16


class TrueFP16Compressor(_CastCompressor):
    """IEEE float16 wire."""
    wire_dtype = tf.float16


class Compression:
    """Reference: ``hvd.Compression``."""
    none = NoneCompressor
    fp16 = FP16Compressor
    true_fp16 = TrueFP16Compressor
