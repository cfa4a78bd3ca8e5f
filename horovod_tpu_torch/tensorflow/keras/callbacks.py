"""Keras callbacks.

Counterpart of ``horovod_tpu/tensorflow/keras/callbacks.py`` (reference:
``horovod/tensorflow/keras/callbacks.py``): the broadcast at the start,
the metric average across ranks, and the gradual learning-rate warmup
and schedule of "Accurate, Large Minibatch SGD", with momentum
correction.
"""

from __future__ import annotations

import math
from typing import Optional

import tensorflow as tf
from tensorflow import keras

from .. import rank, size
from ..functions import broadcast_variables
from ..mpi_ops import Average, allreduce


class BroadcastGlobalVariablesCallback(keras.callbacks.Callback):
    """Broadcast the model's and the optimizer's variables from
    ``root_rank`` after the first batch, so that every rank goes on from
    the same state.  At the batch's end because Keras creates the
    variables lazily during the first batch."""

    def __init__(self, root_rank: int = 0):
        super().__init__()
        self.root_rank = root_rank
        self.broadcast_done = False

    def on_batch_end(self, batch, logs=None):
        if self.broadcast_done:
            return
        broadcast_variables(self.model.variables, self.root_rank)
        if getattr(self.model, "optimizer", None) is not None:
            broadcast_variables(self.model.optimizer.variables,
                                self.root_rank)
        self.broadcast_done = True


class MetricAverageCallback(keras.callbacks.Callback):
    """Average the epoch's metrics over the ranks at the epoch's end.

    Every rank must dispatch the same collectives in the same order, so
    the keys are walked sorted and every numeric value is reduced, NaN
    and inf included."""

    def on_epoch_end(self, epoch, logs=None):
        if logs is None or size() == 1:
            return
        for k in sorted(logs):
            try:
                v = float(logs[k])
            except (TypeError, ValueError):
                continue
            logs[k] = float(allreduce(
                tf.constant(v, tf.float32), op=Average,
                name=f"metric.{k}"))


def _get_lr(optimizer) -> float:
    return float(tf.keras.backend.get_value(optimizer.learning_rate))


def _set_lr(optimizer, lr: float, momentum_correction: bool = False) -> None:
    old_lr = _get_lr(optimizer)
    lr_var = optimizer.learning_rate
    if isinstance(lr_var, tf.Variable):
        lr_var.assign(lr)
    else:
        optimizer.learning_rate = lr
    # SGD's momentum buffers hold lr-scaled updates: a change of the
    # rate rescales them by new / old.
    if momentum_correction and old_lr > 0 and lr != old_lr:
        scale = lr / old_lr
        for v in getattr(optimizer, "variables", []):
            name = getattr(v, "path", None) or getattr(v, "name", "")
            if "momentum" in str(name).lower():
                v.assign(v * scale)


class LearningRateWarmupCallback(keras.callbacks.Callback):
    """Ramp the rate batch by batch from ``initial_lr / size()`` to
    ``initial_lr`` over ``warmup_epochs``."""

    def __init__(self, initial_lr: float, warmup_epochs: float = 5,
                 momentum_correction: bool = True,
                 steps_per_epoch: Optional[int] = None, verbose: int = 0):
        super().__init__()
        self.initial_lr = initial_lr
        self.warmup_epochs = warmup_epochs
        self.steps_per_epoch = steps_per_epoch
        self.verbose = verbose
        self._momentum_correction = momentum_correction
        self.current_epoch = 0
        self._steps = None

    def on_train_begin(self, logs=None):
        self._steps = self.steps_per_epoch or self.params.get("steps")
        if self._steps is None:
            raise ValueError(
                "LearningRateWarmupCallback needs steps_per_epoch (could "
                "not infer it from the fit parameters)")

    def on_epoch_begin(self, epoch, logs=None):
        self.current_epoch = epoch

    def on_batch_begin(self, batch, logs=None):
        progress = (self.current_epoch * self._steps + batch + 1) / float(
            self.warmup_epochs * self._steps)
        if progress >= 1.0:
            return
        factor = (1.0 / size()) + (1.0 - 1.0 / size()) * progress
        _set_lr(self.model.optimizer, self.initial_lr * factor,
                self._momentum_correction)

    def on_epoch_end(self, epoch, logs=None):
        if epoch + 1 == int(math.ceil(self.warmup_epochs)):
            _set_lr(self.model.optimizer, self.initial_lr)
            # Every rank sets the rate; only the message is rank 0's.
            if self.verbose and rank() == 0:
                print(f"\nEpoch {epoch + 1}: finished gradual learning "
                      f"rate warmup to {self.initial_lr}.")


class LearningRateScheduleCallback(keras.callbacks.Callback):
    """Multiply ``initial_lr`` by ``multiplier`` (a constant or a function
    of the epoch) from ``start_epoch`` to ``end_epoch``; ``staircase``
    sets it once an epoch, else once a batch with fractional epochs."""

    def __init__(self, initial_lr: float, multiplier, start_epoch: int = 0,
                 end_epoch: Optional[int] = None, staircase: bool = True,
                 momentum_correction: bool = True,
                 steps_per_epoch: Optional[int] = None, verbose: int = 0):
        super().__init__()
        self.initial_lr = initial_lr
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.staircase = staircase
        self.steps_per_epoch = steps_per_epoch
        self.verbose = verbose
        self._momentum_correction = momentum_correction
        self.current_epoch = 0
        self._steps = None
        if callable(multiplier):
            self.multiplier = multiplier
        else:
            self.multiplier = lambda epoch: multiplier

    def _in_range(self, epoch) -> bool:
        if epoch < self.start_epoch:
            return False
        return self.end_epoch is None or epoch < self.end_epoch

    def on_train_begin(self, logs=None):
        self._steps = self.steps_per_epoch or self.params.get("steps")

    def on_epoch_begin(self, epoch, logs=None):
        self.current_epoch = epoch
        if self.staircase and self._in_range(epoch):
            _set_lr(self.model.optimizer,
                    self.initial_lr * self.multiplier(epoch),
                    self._momentum_correction)

    def on_batch_begin(self, batch, logs=None):
        if self.staircase or self._steps is None:
            return
        epoch = self.current_epoch + float(batch) / self._steps
        if self._in_range(self.current_epoch):
            _set_lr(self.model.optimizer,
                    self.initial_lr * self.multiplier(epoch),
                    self._momentum_correction)

    def on_epoch_end(self, epoch, logs=None):
        if logs is not None:
            logs["lr"] = _get_lr(self.model.optimizer)
