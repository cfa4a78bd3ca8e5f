"""Gradient compression for the torch binding.

Counterpart of ``horovod_tpu/torch/compression.py`` (reference:
``horovod/torch/compression.py``): ``Compression.none`` and
``Compression.fp16``, each a ``compress(tensor) -> (wire, ctx)`` and
``decompress(wire, ctx)`` pair.  They are the core's compressors
(:mod:`horovod_tpu_torch.ops.compression`), whose ``compress`` and
``decompress`` return what the binding's did.  The binding applies them
itself, around the exact collective, so a prescale or postscale runs on
the wire's dtype as in the reference.  The binding has no int8.
"""

from __future__ import annotations

from ..ops.compression import (  # noqa: F401
    Compressor, FP16Compressor, NoneCompressor,
)


class Compression:
    """Namespace mirroring ``hvd.Compression``."""

    none = NoneCompressor
    fp16 = FP16Compressor
