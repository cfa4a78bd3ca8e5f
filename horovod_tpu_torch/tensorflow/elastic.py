"""TF/Keras elastic state: ``horovod.tensorflow.elastic``'s
``TensorFlowKerasState``.

Counterpart of ``horovod_tpu/tensorflow/elastic.py``, on the port's
:class:`horovod_tpu_torch.elastic.state.ObjectState`.  ``commit`` keeps
host copies of the model's weights and of the optimizer's variables,
``restore`` puts them back, ``sync`` broadcasts rank 0's, and
``save_to``/``load_from`` go through the port's checkpointer, whose
leaves are torch tensors (a bf16 variable crosses as its int16 view).
The Keras callbacks are in :mod:`.keras.elastic`.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from ..elastic.state import ObjectState
from .functions import broadcast_object, broadcast_variables
from .mpi_ops import host_array, host_tensor


def _optimizer_variables(optimizer):
    """Keras 3 optimizers expose ``variables`` (a list); legacy tf.keras
    exposed ``variables()``.  Normalised to a list."""
    v = getattr(optimizer, "variables", None)
    if callable(v):
        v = v()
    return list(v or [])


def _named_optimizer_variables(optimizer):
    """``[(key, var)]`` with stable unique keys (Keras 3's ``path``, else
    ``name``; repeats suffixed by occurrence).  Keys, not positions, pair a
    committed snapshot with the live variables: the list grows and
    reorders as slots are created."""
    seen: dict = {}
    out = []
    for var in _optimizer_variables(optimizer):
        key = getattr(var, "path", None) or getattr(var, "name", "var")
        n = seen.get(key, 0)
        seen[key] = n + 1
        out.append((f"{key}#{n}" if n else key, var))
    return out


# Variables that are inputs, not accumulated state: absent from the
# committed snapshot they keep their live value (a learning rate created
# after the commit must not be zeroed); accumulators and counters
# created after the commit roll back to zero.
_NON_STATE_HINTS = ("learning_rate",)


class TensorFlowKerasState(ObjectState):
    """Elastic state over a Keras model, its optimizer and plain
    attributes (reference: ``hvd.elastic.TensorFlowKerasState(model,
    optimizer, batch=0, epoch=0)``)."""

    def __init__(self, model=None, optimizer=None, **kwargs: Any) -> None:
        self._model = model
        self._optimizer = optimizer
        self._weights_saved: Optional[list] = None
        self._opt_saved: Optional[dict] = None
        super().__init__(**kwargs)  # commits

    def commit(self) -> None:
        if self._model is not None:
            self._weights_saved = [np.array(w)
                                   for w in self._model.get_weights()]
        if self._optimizer is not None:
            self._opt_saved = {
                key: np.array(var.numpy())
                for key, var in _named_optimizer_variables(self._optimizer)}
        super().commit()

    def restore(self) -> None:
        import tensorflow as tf

        if self._model is not None and self._weights_saved is not None:
            self._model.set_weights(self._weights_saved)
        if self._optimizer is not None and self._opt_saved is not None:
            for key, var in _named_optimizer_variables(self._optimizer):
                if key in self._opt_saved:
                    var.assign(self._opt_saved[key])
                elif any(h in key for h in _NON_STATE_HINTS):
                    continue
                else:
                    # Created after the commit (slots from the first
                    # step, iteration counters): its zero init is the
                    # rolled-back value.
                    var.assign(tf.zeros_like(var))
        super().restore()

    def sync(self) -> None:
        if self._model is not None:
            broadcast_variables(self._model.variables, root_rank=0)
        if self._optimizer is not None:
            opt_vars = _optimizer_variables(self._optimizer)
            if opt_vars:
                broadcast_variables(opt_vars, root_rank=0)
        synced = broadcast_object(self._public_attrs(), root_rank=0)
        for k, v in synced.items():
            setattr(self, k, v)
        self.commit()

    # --- durable tier ----------------------------------------------------------

    def save_to(self, checkpointer, step: int) -> None:
        """Persist the committed snapshot: weights as a list of leaves,
        the optimizer's variables by key, the attributes under
        ``plain``."""
        if self._weights_saved is None and self._opt_saved is None:
            self.commit()
        checkpointer.save(step, {
            "weights": [host_tensor(w) for w in self._weights_saved or []],
            "opt": {k: host_tensor(v)
                    for k, v in (self._opt_saved or {}).items()},
            "plain": self._saved})

    def load_from(self, checkpointer, step=None) -> None:
        """Load a durable checkpoint into this state and restore it."""
        payload = checkpointer.restore(step)
        self._weights_saved = [host_array(w) for w in payload["weights"]]
        self._opt_saved = {k: host_array(v)
                           for k, v in payload["opt"].items()}
        self._saved = dict(payload["plain"])
        self.restore()
