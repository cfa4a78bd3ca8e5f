"""MXNet state broadcast: ``broadcast_parameters`` and
``broadcast_object``.

Counterpart of ``horovod_tpu/mxnet/functions.py``: every parameter array
of a gluon ``ParameterDict`` (or a plain name → NDArray mapping) is
overwritten with the root's, in name order, so every rank starts from
the same weights.
"""

from __future__ import annotations

from typing import Any

from . import mpi_ops
from ..functions import broadcast_object  # noqa: F401  (re-export)


def _param_arrays(params):
    """(name, NDArray) pairs of a gluon ParameterDict or a plain mapping
    of name → NDArray, in name order."""
    for name, p in sorted(params.items()):
        if hasattr(p, "list_data"):      # gluon.Parameter
            for arr in p.list_data():
                yield name, arr
        elif hasattr(p, "data") and callable(getattr(p, "data")):
            yield name, p.data()
        else:                            # an NDArray already
            yield name, p


def broadcast_parameters(params: Any, root_rank: int = 0,
                         prefix: str = "") -> None:
    """Reference: ``hvd.broadcast_parameters(model.collect_params(), 0)``:
    each parameter array overwritten in place with ``root_rank``'s."""
    for name, arr in _param_arrays(params):
        mpi_ops.broadcast_(arr, root_rank, name=f"{prefix}{name}")
