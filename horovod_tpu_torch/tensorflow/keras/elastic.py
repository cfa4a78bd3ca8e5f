"""Elastic Keras callbacks (reference: ``horovod.tensorflow.keras.
elastic``).

Counterpart of ``horovod_tpu/tensorflow/keras/elastic.py``:
``CommitStateCallback`` commits the elastic state every N batches;
``UpdateBatchStateCallback`` and ``UpdateEpochStateCallback`` keep the
position in the state, so a restored rank resumes where it was.
"""

from __future__ import annotations

import tensorflow as tf


class CommitStateCallback(tf.keras.callbacks.Callback):
    """Commit ``state`` every ``batches_per_commit`` batches (default:
    every batch)."""

    def __init__(self, state, batches_per_commit: int = 1) -> None:
        super().__init__()
        self.state = state
        self.batches_per_commit = max(1, int(batches_per_commit))

    def on_batch_end(self, batch, logs=None):
        if (batch + 1) % self.batches_per_commit == 0:
            self.state.commit()


class UpdateBatchStateCallback(tf.keras.callbacks.Callback):
    """Keep the batch position in ``state.batch``; 0 again at each
    epoch's end.  Keras 3's loop ignores ``Callback.params`` changes, so
    skipping the batches already trained belongs to the data pipeline
    (``dataset.skip(state.batch)`` before the resumed ``fit``)."""

    def __init__(self, state) -> None:
        super().__init__()
        self.state = state

    def on_batch_end(self, batch, logs=None):
        self.state.batch = batch + 1

    def on_epoch_end(self, epoch, logs=None):
        self.state.batch = 0


class UpdateEpochStateCallback(tf.keras.callbacks.Callback):
    """Keep the epoch position in ``state.epoch``."""

    def __init__(self, state) -> None:
        super().__init__()
        self.state = state

    def on_epoch_end(self, epoch, logs=None):
        self.state.epoch = epoch + 1


# Reference: ``horovod.keras.elastic.KerasState`` names the same state.
from ..elastic import TensorFlowKerasState as KerasState  # noqa: E402,F401
