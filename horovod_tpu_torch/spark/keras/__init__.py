"""The Keras Spark estimator.

Counterpart of ``horovod_tpu/spark/keras/__init__.py`` (reference:
``horovod/spark/keras/``: ``KerasEstimator`` → Parquet in the store →
``model.fit`` over the Spark tasks → ``KerasModel``; the worker's
training function in ``remote.py``).  The data tier is pyarrow Parquet
in a store directory; the world is :func:`horovod_tpu_torch.spark.run`'s
for a pyspark DataFrame, and this process's session for local data.
The worker imports the port's Keras binding
(``horovod_tpu_torch.tensorflow.keras``) when it runs, so this module
imports without tensorflow.
"""

from __future__ import annotations

import os
import pickle
import uuid
from typing import Any, Dict, List, Optional

from ..common import datamodule as dm
from ..common.backend import PredictionTransformer, dispatch_fit
from ..common.params import EstimatorParams
from ..common.store import Store


def _serialize_keras(model, custom_objects=None) -> bytes:
    return pickle.dumps({"json": model.to_json(),
                         "weights": model.get_weights(),
                         "custom_objects": custom_objects or {}})


def _deserialize_keras(blob: bytes):
    import tensorflow as tf

    payload = pickle.loads(blob)
    model = tf.keras.models.model_from_json(
        payload["json"], custom_objects=payload.get("custom_objects") or None)
    model.set_weights(payload["weights"])
    return model


def _train_fn(model_blob: bytes, train_path: str, val_path: Optional[str],
              spec: Dict[str, Any]):
    """The worker's training body (reference: ``keras/remote.py``), in a
    ``spark.run`` task or in this process; returns ``(history, weights)``
    from every rank (rank 0's is used)."""
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.tensorflow.keras as hvd_keras
    import tensorflow as tf

    if not hvd.is_initialized():
        hvd.init()
    # The reference's world is its controller processes: here the ranks.
    rank, world = hvd.rank(), hvd.size()

    data = dm.read_shard(train_path, rank, world)
    x = dm.stack_features(data, spec["feature_cols"])
    y = dm.stack_features(data, spec["label_cols"])
    val = None
    if val_path:
        vdata = dm.read_shard(val_path, rank, world)
        val = (dm.stack_features(vdata, spec["feature_cols"]),
               dm.stack_features(vdata, spec["label_cols"]))

    model = _deserialize_keras(model_blob)
    opt = tf.keras.optimizers.get(spec["optimizer"])
    opt = hvd_keras.DistributedOptimizer(
        opt, backward_passes_per_step=spec["backward_passes_per_step"])
    model.compile(optimizer=opt, loss=spec["loss"],
                  metrics=list(spec["metrics"]))
    # The ranks start identical: their weights come from the same blob
    # (the reference's guarantee, in the place of a broadcast).
    hist = model.fit(x, y, batch_size=spec["batch_size"],
                     epochs=spec["epochs"],
                     steps_per_epoch=spec["train_steps_per_epoch"],
                     validation_data=val,
                     verbose=spec["verbose"] if rank == 0 else 0,
                     shuffle=True)
    history = {k: [float(v) for v in vs] for k, vs in hist.history.items()}
    return history, model.get_weights()


class KerasEstimator(EstimatorParams):
    """Reference API shape: ``KerasEstimator(model=..., optimizer=...,
    loss=..., store=..., num_proc=N).fit(df) -> KerasModel``."""

    def __init__(self, model=None, optimizer=None, custom_objects=None,
                 **params: Any) -> None:
        super().__init__(**params)
        self.model = model
        self.optimizer = optimizer or "sgd"
        self.custom_objects = custom_objects or {}

    def _validate(self) -> None:
        if self.model is None:
            raise ValueError("KerasEstimator requires model=")
        if self._get("loss") is None:
            raise ValueError("KerasEstimator requires loss=")
        store = self._get("store")
        if store is None:
            raise ValueError("KerasEstimator requires store=")
        if not isinstance(store, Store):
            raise TypeError("store must be a horovod_tpu_torch.spark Store")

    def fit(self, df, params: Optional[dict] = None) -> "KerasModel":
        """Materialize ``df`` to the store as Parquet, train over the
        world, return the fitted :class:`KerasModel` transformer.
        ``df`` may be a pyspark DataFrame (cluster path), or a pandas
        DataFrame / dict-of-columns / list-of-dicts (local path — no
        pyspark needed)."""
        self._validate()
        for k, v in (params or {}).items():
            self._set(k, v)
        store: Store = self._get("store")
        run_id = self._get("run_id") or f"keras-{uuid.uuid4().hex[:8]}"
        blob = _serialize_keras(self.model, self.custom_objects)
        history, weights = dispatch_fit(
            self, df, blob, _train_fn, run_id,
            extra_spec={
                "loss": self._get("loss"),
                "metrics": self._get("metrics"),
                "optimizer": self.optimizer,
                "train_steps_per_epoch": self._get("train_steps_per_epoch"),
                "verbose": self._get("verbose"),
            })

        trained = _deserialize_keras(blob)
        trained.set_weights(weights)
        store.write(os.path.join(store.get_checkpoint_path(run_id),
                                 "model.pkl"),
                    _serialize_keras(trained, self.custom_objects))
        return KerasModel(model=trained, history=[history], run_id=run_id,
                          feature_cols=self._get("feature_cols"))


class KerasModel(PredictionTransformer):
    """The fitted Spark Transformer (reference: ``KerasModel``) —
    inference through ``model.predict`` on the shared transformer."""

    def _predict(self, x):
        return self.model.predict(x, verbose=0)
