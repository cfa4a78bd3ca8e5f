"""The estimators' shared fit scaffolding.

Counterpart of ``horovod_tpu/spark/common/backend.py`` (reference:
``horovod/spark/common/backend.py``).  Every estimator's ``fit`` runs the
same sequence: the world's size, the train and validation data written
to the store as Parquet, the worker's spec, then the worker's training
function over the cluster (a pyspark DataFrame: :func:`horovod_tpu_torch.
spark.run`) or in this process (local data).  The torch-family worker
loop, :func:`torch_fit_loop`, runs on the port's torch binding.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

from . import datamodule as dm


def dispatch_fit(estimator, df, blob: bytes, train_fn: Callable,
                 run_id: str,
                 extra_spec: Optional[Dict[str, Any]] = None) -> Tuple:
    """Store, shard, distributed fit; returns rank 0's ``train_fn``
    result."""
    store = estimator._get("store")
    num_proc = estimator._get("num_proc")
    if num_proc is None:
        # The cluster's parallelism; one process on the local path.
        num_proc = (df.sparkSession.sparkContext.defaultParallelism
                    if dm._is_spark_df(df) else 1)

    train_path = store.get_train_data_path(run_id)
    dm.materialize(df, train_path, num_shards=num_proc)
    val_path = None
    if estimator._get("validation") is not None:
        val_path = store.get_val_data_path(run_id)
        dm.materialize(estimator._get("validation"), val_path,
                       num_shards=num_proc)

    spec = {
        "feature_cols": estimator._get("feature_cols"),
        "label_cols": estimator._get("label_cols"),
        "batch_size": estimator._get("batch_size"),
        "epochs": estimator._get("epochs"),
        "backward_passes_per_step": estimator._get("backward_passes_per_step"),
    }
    spec.update(extra_spec or {})

    if dm._is_spark_df(df):
        from .. import run as spark_run

        results = spark_run(train_fn, args=(blob, train_path, val_path,
                                            spec), num_proc=num_proc)
    else:
        results = [train_fn(blob, train_path, val_path, spec)]
    return results[0]


def torch_fit_loop(model, optimizer, train_step, val_step,
                   train_path: str, val_path: Optional[str],
                   spec: Dict[str, Any]):
    """The torch-family worker loop (reference: each torch estimator's
    ``remote.py``): the session (``init()`` if none: ``cuda:<local_rank>``),
    rank 0's parameters broadcast, the hook-driven ``DistributedOptimizer``
    with ``backward_passes_per_step``, this rank's shard, the same seeded
    shuffle on every rank, the loss a batch.  The model and its batches
    go to the session's device.  ``train_step(model, batch, batch_idx)``
    returns the loss tensor, ``val_step(model, (x, y))`` a float or None
    (no entry).  Returns the history and the state dict on the CPU."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.torch as hvt

    if not hvd.is_initialized():
        hvd.init()
    dev = hvd.device()
    # The reference's world is its controller processes: here the ranks.
    rank, world = hvd.rank(), hvd.size()

    model.to(dev)
    hvt.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvt.DistributedOptimizer(
        optimizer, named_parameters=model.named_parameters(),
        backward_passes_per_step=spec["backward_passes_per_step"])

    data = dm.read_shard(train_path, rank, world)
    x = torch.from_numpy(dm.stack_features(data, spec["feature_cols"])).to(dev)
    y = torch.from_numpy(dm.stack_features(data, spec["label_cols"])).to(dev)
    val = None
    if val_path:
        vdata = dm.read_shard(val_path, rank, world)
        val = tuple(torch.from_numpy(dm.stack_features(vdata, cols)).to(dev)
                    for cols in (spec["feature_cols"], spec["label_cols"]))

    bs = spec["batch_size"]
    history: Dict[str, Any] = {"loss": []}
    g = torch.Generator().manual_seed(1234)  # the same shuffle on every rank
    for _ in range(spec["epochs"]):
        model.train()
        perm = torch.randperm(len(x), generator=g)
        losses = []
        # batch_idx restarts each epoch (the lightning contract).
        for batch_idx, i in enumerate(range(0, len(x), bs)):
            idx = perm[i:i + bs].to(dev)
            opt.zero_grad()
            loss = train_step(model, (x[idx], y[idx]), batch_idx)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
        history["loss"].append(float(np.mean(losses)))
        if val is not None and val_step is not None:
            model.eval()
            with torch.no_grad():
                vloss = val_step(model, val)
            if vloss is not None:
                history.setdefault("val_loss", []).append(float(vloss))
    return history, {k: v.detach().to("cpu")
                     for k, v in model.state_dict().items()}


class PredictionTransformer:
    """The fitted model as a Transformer: a forward pass with a
    ``prediction`` column appended (reference: each estimator's Spark
    Transformer half).  Subclasses override :meth:`_predict`."""

    def __init__(self, model=None, history=None, run_id=None,
                 feature_cols=None):
        self.model = model
        self.history = history or []
        self.run_id = run_id
        self.feature_cols = feature_cols or ["features"]

    def getModel(self):
        return self.model

    def _predict(self, x):
        """numpy features -> numpy predictions (the torch forward)."""
        import torch

        self.model.eval()
        with torch.no_grad():
            return self.model(torch.from_numpy(x)).numpy()

    def transform(self, df):
        """pandas, dict and list datasets without pyspark; a Spark
        DataFrame round-trips through pandas on the driver (the
        reference's pandas UDF is not ported)."""
        import numpy as np

        pdf = df.toPandas() if dm._is_spark_df(df) else dm._to_pandas(df).copy()
        x = dm.stack_features(dm.to_columns(pdf), self.feature_cols)
        preds = self._predict(x)
        pdf["prediction"] = [np.asarray(p).tolist() for p in preds]
        return pdf
