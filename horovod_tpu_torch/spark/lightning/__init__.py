"""The Lightning Spark estimator.

Counterpart of ``horovod_tpu/spark/lightning/__init__.py`` (reference:
``horovod/spark/lightning/``, a ``TorchEstimator`` over a
``LightningModule``): the module brings its optimizer
(``configure_optimizers``) and its step math (``training_step``,
``validation_step``); the estimator brings the data, the world and the
fit loop of ``spark/common/backend.py``.  It drives the LightningModule
protocol, duck-typed, not the pytorch-lightning package: a real
``pl.LightningModule`` works where lightning is installed, and the
pipeline runs without it.
"""

from __future__ import annotations

import os
import pickle
import uuid
from typing import Any, Dict, Optional

from ..common.backend import dispatch_fit
from ..common.params import EstimatorParams
from ..common.store import Store
from ..torch import TorchModel


def _resolve_optimizer(module):
    """``configure_optimizers`` contract forms (lightning docs): a bare
    optimizer, a list/tuple of optimizers, ([optimizers], [schedulers]),
    or {'optimizer': opt, ...}.  Single-optimizer training uses the
    first; anything unresolvable raises with the contract named."""
    cfg = module.configure_optimizers()
    if isinstance(cfg, dict):
        cfg = cfg.get("optimizer")
    if isinstance(cfg, (list, tuple)):
        if not cfg:
            raise ValueError("configure_optimizers returned no optimizer")
        first = cfg[0]
        if isinstance(first, (list, tuple)):   # ([opts], [scheds])
            if not first:
                raise ValueError("configure_optimizers returned no optimizer")
            first = first[0]
        cfg = first
    if cfg is None or not hasattr(cfg, "step"):
        raise ValueError(
            "configure_optimizers must yield a torch optimizer (got "
            f"{type(cfg).__name__}); supported forms: optimizer, "
            "[optimizers], ([optimizers], [schedulers]), "
            "{'optimizer': ...}")
    return cfg


def _train_fn(blob: bytes, train_path: str, val_path: Optional[str],
              spec: Dict[str, Any]):
    """Per-worker body (reference: ``lightning/remote.py``): the shared
    torch fit loop driven by the module's own step math."""
    from ..common.backend import torch_fit_loop

    module = pickle.loads(blob)
    optimizer = _resolve_optimizer(module)

    def train_step(m, batch, batch_idx):
        loss = m.training_step(batch, batch_idx)
        if isinstance(loss, dict):           # lightning allows {'loss': ...}
            loss = loss["loss"]
        return loss

    def val_step(m, val):
        if not callable(getattr(m, "validation_step", None)):
            return None
        vloss = m.validation_step(val, 0)
        if isinstance(vloss, dict):
            vloss = vloss.get("val_loss", vloss.get("loss"))
        # modules logging via self.log return None: skip the entry
        return None if vloss is None else float(vloss)

    return torch_fit_loop(module, optimizer, train_step=train_step,
                          val_step=val_step, train_path=train_path,
                          val_path=val_path, spec=spec)


class LightningEstimator(EstimatorParams):
    """Reference API shape: ``LightningEstimator(model=lightning_module,
    store=..., num_proc=N).fit(df) -> LightningModel``."""

    def __init__(self, model=None, input_shapes=None, **params: Any) -> None:
        super().__init__(**params)
        self.model = model
        self.input_shapes = input_shapes

    def _validate(self) -> None:
        if self.model is None:
            raise ValueError("LightningEstimator requires model=")
        for hook in ("training_step", "configure_optimizers"):
            if not callable(getattr(self.model, hook, None)):
                raise TypeError(
                    f"model must implement the LightningModule protocol "
                    f"(missing {hook})")
        store = self._get("store")
        if store is None:
            raise ValueError("LightningEstimator requires store=")
        if not isinstance(store, Store):
            raise TypeError("store must be a horovod_tpu_torch.spark Store")

    def fit(self, df, params: Optional[dict] = None) -> "LightningModel":
        """Materialize ``df`` to the store, train with the module's own
        step math, return the fitted :class:`LightningModel`."""
        self._validate()
        for k, v in (params or {}).items():
            self._set(k, v)
        store: Store = self._get("store")
        run_id = self._get("run_id") or f"lightning-{uuid.uuid4().hex[:8]}"
        from ...runner.run_func import _serializer

        blob = _serializer().dumps(self.model)   # local classes by value
        history, state_dict = dispatch_fit(self, df, blob, _train_fn, run_id)

        trained = pickle.loads(blob)
        trained.load_state_dict(state_dict)
        store.write_serialized(
            os.path.join(store.get_checkpoint_path(run_id), "model.pt"),
            {k: v.numpy() for k, v in state_dict.items()})
        return LightningModel(model=trained, history=[history],
                              run_id=run_id,
                              feature_cols=self._get("feature_cols"))


class LightningModel(TorchModel):
    """The fitted Spark Transformer: a LightningModule is an
    ``nn.Module``, so inference is the torch transformer's forward."""
