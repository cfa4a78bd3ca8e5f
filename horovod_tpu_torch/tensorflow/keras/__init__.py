"""``horovod_tpu_torch.tensorflow.keras``: the Keras binding.

Counterpart of ``horovod_tpu/tensorflow/keras/__init__.py`` (reference:
``horovod/tensorflow/keras/__init__.py``): ``DistributedOptimizer``
(Keras 3's optimizers are TF's) and the callbacks.
"""

from __future__ import annotations

from ...basics import (  # noqa: F401
    init, shutdown, is_initialized,
    local_rank, local_size, cross_rank, cross_size,
)
from .. import rank, size  # noqa: F401
from ..compression import Compression  # noqa: F401
from ..functions import broadcast_model, broadcast_variables  # noqa: F401
from . import callbacks  # noqa: F401
from . import elastic  # noqa: F401


def DistributedOptimizer(optimizer, **kwargs):
    """Reference: ``hvd.keras.DistributedOptimizer``: the TF binding's."""
    from .. import DistributedOptimizer as _impl

    return _impl(optimizer, **kwargs)
