"""``horovod_tpu_torch.keras``: the standalone-Keras alias.

Counterpart of ``horovod_tpu/keras/__init__.py`` (reference:
``horovod/keras/``): with Keras 3 the standalone package and
``horovod.tensorflow.keras`` are one optimizer and one set of callbacks,
so this package re-exports :mod:`horovod_tpu_torch.tensorflow.keras`.
"""

from ..tensorflow.keras import (  # noqa: F401
    Compression, DistributedOptimizer, broadcast_model, broadcast_variables,
    callbacks, elastic,
    init, shutdown, is_initialized,
    rank, size, local_rank, local_size, cross_rank, cross_size,
)
