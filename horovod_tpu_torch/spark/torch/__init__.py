"""The torch Spark estimator.

Counterpart of ``horovod_tpu/spark/torch/__init__.py`` (reference:
``horovod/spark/torch/``, ``TorchEstimator`` over a torch ``model`` /
``optimizer`` / ``loss`` triple, with the worker loop in ``remote.py``):
the store → Parquet shard → distributed fit → transformer pipeline of
``spark/common/backend.py``, the worker loop on the port's torch binding
(the hook-driven ``DistributedOptimizer``) on the session's device.
"""

from __future__ import annotations

import os
import pickle
import uuid
from typing import Any, Dict, Optional

from ..common.backend import PredictionTransformer, dispatch_fit
from ..common.params import EstimatorParams
from ..common.store import Store


def _train_fn(blob: bytes, train_path: str, val_path: Optional[str],
              spec: Dict[str, Any]):
    """Per-worker body (reference: ``torch/remote.py``): the shared torch
    fit loop with the user's loss closure."""
    from ..common.backend import torch_fit_loop

    model, optimizer, loss_fn = pickle.loads(blob)
    return torch_fit_loop(
        model, optimizer,
        train_step=lambda m, batch, _i: loss_fn(m(batch[0]), batch[1]),
        val_step=lambda m, val: float(loss_fn(m(val[0]), val[1])),
        train_path=train_path, val_path=val_path, spec=spec)


class TorchEstimator(EstimatorParams):
    """Reference API shape: ``TorchEstimator(model=..., optimizer=...,
    loss=..., store=..., num_proc=N).fit(df) -> TorchModel``."""

    def __init__(self, model=None, optimizer=None, input_shapes=None,
                 **params: Any) -> None:
        super().__init__(**params)
        self.model = model
        self.optimizer = optimizer
        self.input_shapes = input_shapes

    def _validate(self) -> None:
        if self.model is None:
            raise ValueError("TorchEstimator requires model=")
        if self.optimizer is None:
            raise ValueError("TorchEstimator requires optimizer=")
        if self._get("loss") is None:
            raise ValueError("TorchEstimator requires loss=")
        store = self._get("store")
        if store is None:
            raise ValueError("TorchEstimator requires store=")
        if not isinstance(store, Store):
            raise TypeError("store must be a horovod_tpu_torch.spark Store")

    def fit(self, df, params: Optional[dict] = None) -> "TorchModel":
        """Materialize ``df`` to the store, train, return the fitted
        :class:`TorchModel`.  ``df`` may be a pyspark DataFrame (cluster
        path) or pandas/dict/list-of-dicts (local path, no pyspark)."""
        self._validate()
        for k, v in (params or {}).items():
            self._set(k, v)
        store: Store = self._get("store")
        run_id = self._get("run_id") or f"torch-{uuid.uuid4().hex[:8]}"
        # Model, optimizer and loss travel as one blob, so that the
        # optimizer's parameters stay the model's on the worker
        # (cloudpickle where installed: local modules and losses travel
        # by value, as on Spark).
        from ...runner.run_func import _serializer

        blob = _serializer().dumps(
            (self.model, self.optimizer, self._get("loss")))
        history, state_dict = dispatch_fit(self, df, blob, _train_fn, run_id)

        trained, _, _ = pickle.loads(blob)
        trained.load_state_dict(state_dict)
        store.write_serialized(
            os.path.join(store.get_checkpoint_path(run_id), "model.pt"),
            {k: v.numpy() for k, v in state_dict.items()})
        return TorchModel(model=trained, history=[history], run_id=run_id,
                          feature_cols=self._get("feature_cols"))


class TorchModel(PredictionTransformer):
    """The fitted Spark Transformer (reference: ``TorchModel``);
    forward-pass inference via the shared transformer base."""
