"""State broadcast helpers for TF models.

Counterpart of ``horovod_tpu/tensorflow/functions.py`` (reference:
``horovod/tensorflow/functions.py``): ``broadcast_variables`` assigns the
root's values to every rank's ``tf.Variable``s; objects ride pickled
byte broadcasts.
"""

from __future__ import annotations

from typing import Any, Iterable, List

import tensorflow as tf

from . import mpi_ops
from .. import functions as _core


def broadcast_object(obj: Any, root_rank: int = 0, name: str = "") -> Any:
    """Reference: ``hvd.broadcast_object``."""
    return _core.broadcast_object(obj, root_rank,
                                  name=name or "broadcast_object")


def allgather_object(obj: Any, name: str = "") -> List[Any]:
    """Reference: ``hvd.allgather_object``."""
    return _core.allgather_object(obj, name=name or "allgather_object")


def broadcast_variables(variables: Iterable["tf.Variable"],
                        root_rank: int = 0) -> None:
    """Reference: ``hvd.broadcast_variables(model.variables, 0)``; a
    boolean variable travels as uint8."""
    for i, v in enumerate(variables):
        name = f"broadcast.{getattr(v, 'name', i)}"
        if v.dtype == tf.bool:
            got = mpi_ops.broadcast(tf.cast(v, tf.uint8), root_rank,
                                    name=name)
            v.assign(tf.cast(got, tf.bool))
        else:
            v.assign(mpi_ops.broadcast(v, root_rank, name=name))


def broadcast_model(model, root_rank: int = 0) -> None:
    """``broadcast_variables(model.variables, root_rank)``."""
    broadcast_variables(model.variables, root_rank)
