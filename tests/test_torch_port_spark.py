"""The port's Spark tier (``horovod_tpu_torch/spark/``) against the
reference's (``horovod_tpu.spark``; ``tests/test_spark_estimators.py``).

* The datamodule: the same frames written by both packages give the same
  part files and shards, **bit for bit**, and a store written by either
  reads the same in the other.
* The estimators on the local path (no pyspark): ``TorchEstimator``,
  ``LightningEstimator`` and ``KerasEstimator`` ``fit`` and ``transform``
  on the same seeded model and data through both packages: history,
  final weights and predictions **bit for bit** (one worker: the
  reference's 8 CPU slots of one controller, the port's world of one on
  the CPU).
* ``run`` over the stand-in for pyspark (``tests/torch_port_spark_shim.
  py``: local processes for Spark's executors) with two task processes
  on gloo on the CPU: torchrun's variables, results in rank order, an
  allreduce, an exception in ``fn`` surfacing, and ``device=`` /
  ``backend=`` reaching each task's ``init``.  The task bodies are
  module-level functions of ``tests/torch_port_workers.py``, and the
  partition function survives the standard ``pickle``.
"""

import os
import pickle

import numpy as np
import pytest
import torch

# Loads the TF-XLA adapter while this module is collected, before
# anything in the process compiles with XLA (the Keras estimator's step).
import horovod_tpu_torch.tensorflow  # noqa: F401
import horovod_tpu_torch as core
import torch_port_spark_shim
import torch_port_workers as workers
from horovod_tpu.spark import FilesystemStore as RefStore
from horovod_tpu.spark.common import datamodule as ref_dm
from horovod_tpu_torch import spark
from horovod_tpu_torch.spark import FilesystemStore
from horovod_tpu_torch.spark.common import datamodule as dm


@pytest.fixture(scope="module")
def session():
    core.init(device="cpu")
    yield
    core.shutdown()


def _regression_df(n=128, f=4, seed=0):
    import pandas as pd

    rng = np.random.RandomState(seed)
    x = rng.randn(n, f).astype(np.float32)
    w = np.arange(1, f + 1, dtype=np.float32)
    y = x @ w + 0.1 * rng.randn(n).astype(np.float32)
    return pd.DataFrame({"features": [r.tolist() for r in x],
                         "label": y.astype(np.float32)})


def _same_columns(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k])


# --- the datamodule ------------------------------------------------------------

@pytest.mark.parametrize("rows,shards", [(50, 3), (10, 3), (2, 4), (6, 1)])
def test_materialize_and_read_shard_match_the_reference(tmp_path, rows,
                                                        shards):
    df = _regression_df(n=rows)
    mine, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    assert dm.materialize(df, mine, num_shards=shards) \
        == ref_dm.materialize(df, ref, num_shards=shards) == rows
    assert sorted(os.listdir(mine)) == sorted(os.listdir(ref))
    for world in (shards, shards + 1):
        for shard in range(world):
            want = ref_dm.read_shard(ref, shard, world)
            _same_columns(dm.read_shard(mine, shard, world), want)
            # A store written by either package reads the same in the other.
            _same_columns(dm.read_shard(ref, shard, world), want)
            _same_columns(ref_dm.read_shard(mine, shard, world), want)


def test_dict_and_row_inputs_and_columns_match_the_reference(tmp_path):
    cols = {"features": [[1.0, 2.0], [3.0, 4.0]], "label": [1.0, 2.0]}
    rows = [{"features": [1.0, 2.0], "label": 1.0},
            {"features": [3.0, 4.0], "label": 2.0}]
    for i, data in enumerate((cols, rows)):
        a, b = str(tmp_path / f"p{i}"), str(tmp_path / f"r{i}")
        assert dm.materialize(data, a) == ref_dm.materialize(data, b) == 2
        _same_columns(dm.read_shard(a, 0, 1), ref_dm.read_shard(b, 0, 1))
    df = _regression_df(n=6)
    _same_columns(dm.to_columns(df), ref_dm.to_columns(df))
    data = {"a": np.ones((3, 2), np.float32),
            "b": np.arange(3, dtype=np.float32)}
    np.testing.assert_array_equal(dm.stack_features(data, ["a", "b"]),
                                  ref_dm.stack_features(data, ["a", "b"]))
    with pytest.raises(TypeError, match="Unsupported dataset type"):
        dm.materialize(3, str(tmp_path / "bad"))


def test_store_layout_and_params_match_the_reference(tmp_path):
    from horovod_tpu.spark.common import EstimatorParams as RefParams
    from horovod_tpu_torch.spark.common import EstimatorParams, Store

    mine, ref = FilesystemStore(str(tmp_path)), RefStore(str(tmp_path))
    for name in ("get_train_data_path", "get_val_data_path",
                 "get_test_data_path"):
        assert getattr(mine, name)("r1") == getattr(ref, name)("r1")
    assert mine.get_checkpoint_path("r1") == ref.get_checkpoint_path("r1")
    path = os.path.join(mine.get_checkpoint_path("r1"), "obj.pkl")
    mine.write_serialized(path, {"a": [1, 2]})
    assert ref.read_serialized(path) == {"a": [1, 2]}
    with pytest.raises(ValueError, match="HDFS/S3"):
        Store.create("s3://bucket/x")
    p, r = EstimatorParams(batch_size=8), RefParams(batch_size=8)
    assert p.param_values() == r.param_values()
    assert p.setNumProc(3).getNumProc() == r.setNumProc(3).getNumProc() == 3
    with pytest.raises(TypeError, match="unknown estimator param"):
        EstimatorParams(bogus=1)


# --- the estimators on the local path --------------------------------------------

def _weights(model) -> dict:
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _torch_fit(estimator, store, tmp_path, validation: bool):
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 1)
    est = estimator(
        model=model, optimizer=torch.optim.SGD(model.parameters(), lr=0.05),
        loss=torch.nn.functional.mse_loss, store=store(str(tmp_path)),
        batch_size=16, epochs=4, run_id="t1",
        validation=_regression_df(n=32, seed=7) if validation else None)
    fitted = est.fit(_regression_df())
    return fitted, fitted.transform(_regression_df().head(8))


@pytest.mark.usefixtures("session")
@pytest.mark.parametrize("validation", [False, True])
def test_torch_estimator_matches_the_reference(tmp_path, validation):
    from horovod_tpu.spark.torch import TorchEstimator as Ref
    from horovod_tpu_torch.spark.torch import TorchEstimator, TorchModel

    got, got_out = _torch_fit(TorchEstimator, FilesystemStore,
                              tmp_path / "p", validation)
    want, want_out = _torch_fit(Ref, RefStore, tmp_path / "r", validation)
    assert isinstance(got, TorchModel)
    assert got.history == want.history
    losses = got.history[0]["loss"]
    assert losses[-1] < losses[0] * 0.5, losses
    assert len(got.history[0].get("val_loss", [])) == (4 if validation
                                                       else 0)
    _same_columns(_weights(got.getModel()), _weights(want.getModel()))
    assert list(got_out["prediction"]) == list(want_out["prediction"])
    saved = os.path.join(str(tmp_path / "p"), "runs", "t1", "checkpoint",
                         "model.pt")
    _same_columns(pickle.load(open(saved, "rb")), _weights(got.getModel()))


def _lightning_module():
    class LinearModule(torch.nn.Module):
        """A LightningModule by protocol (pytorch-lightning is not
        installed; the estimator drives the protocol)."""

        def __init__(self):
            super().__init__()
            self.net = torch.nn.Linear(4, 1)

        def forward(self, x):
            return self.net(x)

        def training_step(self, batch, batch_idx):
            x, y = batch
            return {"loss": torch.nn.functional.mse_loss(self(x), y)}

        def validation_step(self, batch, batch_idx):
            x, y = batch
            return {"val_loss": torch.nn.functional.mse_loss(self(x), y)}

        def configure_optimizers(self):
            return ([torch.optim.SGD(self.parameters(), lr=0.05)], [])

    torch.manual_seed(0)
    return LinearModule()


@pytest.mark.usefixtures("session")
def test_lightning_estimator_matches_the_reference(tmp_path):
    from horovod_tpu.spark.lightning import LightningEstimator as Ref
    from horovod_tpu_torch.spark.lightning import (LightningEstimator,
                                                   LightningModel)

    out = {}
    for name, cls, store in (("port", LightningEstimator, FilesystemStore),
                             ("ref", Ref, RefStore)):
        est = cls(model=_lightning_module(),
                  store=store(str(tmp_path / name)), batch_size=16,
                  epochs=4, run_id="l1", backward_passes_per_step=2,
                  validation=_regression_df(n=32, seed=9))
        fitted = est.fit(_regression_df())
        out[name] = (fitted, fitted.transform(_regression_df().head(6)))
    (got, got_out), (want, want_out) = out["port"], out["ref"]
    assert isinstance(got, LightningModel)
    assert got.history == want.history
    assert len(got.history[0]["val_loss"]) == 4
    _same_columns(_weights(got.getModel()), _weights(want.getModel()))
    assert list(got_out["prediction"]) == list(want_out["prediction"])


def test_lightning_protocol_and_optimizer_forms(tmp_path):
    from horovod_tpu_torch.spark.lightning import (LightningEstimator,
                                                   _resolve_optimizer)

    with pytest.raises(TypeError, match="LightningModule protocol"):
        LightningEstimator(model=object(),
                           store=FilesystemStore(str(tmp_path))).fit(None)
    with pytest.raises(ValueError, match="requires model"):
        LightningEstimator(store=FilesystemStore(str(tmp_path))).fit(None)
    opt = torch.optim.SGD(torch.nn.Linear(2, 1).parameters(), lr=0.1)
    for form in (opt, [opt], ([opt], []), {"optimizer": opt}):
        class M:
            def configure_optimizers(self, _f=form):
                return _f

        assert _resolve_optimizer(M()) is opt
    with pytest.raises(ValueError, match="configure_optimizers"):
        _resolve_optimizer(type("M", (), {
            "configure_optimizers": lambda self: []})())


@pytest.mark.usefixtures("session")
def test_keras_estimator_matches_the_reference(tmp_path):
    import tensorflow as tf

    from horovod_tpu.spark.keras import KerasEstimator as Ref
    from horovod_tpu_torch.spark.keras import KerasEstimator, KerasModel

    def model():
        tf.keras.utils.set_random_seed(0)
        inputs = tf.keras.Input(shape=(4,))
        return tf.keras.Model(inputs, tf.keras.layers.Dense(1)(inputs))

    out = {}
    for name, cls, store in (("port", KerasEstimator, FilesystemStore),
                             ("ref", Ref, RefStore)):
        est = cls(model=model(), optimizer="sgd", loss="mse",
                  store=store(str(tmp_path / name)), batch_size=16,
                  epochs=3, verbose=0, run_id="k1")
        tf.keras.utils.set_random_seed(1)   # fit's shuffle
        fitted = est.fit(_regression_df())
        out[name] = (fitted, fitted.transform(_regression_df().head(5)))
    (got, got_out), (want, want_out) = out["port"], out["ref"]
    assert isinstance(got, KerasModel)
    assert got.history == want.history
    losses = got.history[0]["loss"]
    assert losses[-1] < losses[0], losses
    for a, b in zip(got.getModel().get_weights(),
                    want.getModel().get_weights()):
        np.testing.assert_array_equal(a, b)
    assert list(got_out["prediction"]) == list(want_out["prediction"])
    assert os.path.exists(os.path.join(str(tmp_path / "port"), "runs", "k1",
                                       "checkpoint", "model.pkl"))


# --- run over the stand-in ---------------------------------------------------------

@pytest.fixture()
def pyspark():
    mod = torch_port_spark_shim.install()
    yield mod
    torch_port_spark_shim.uninstall()


def test_run_requires_pyspark():
    torch_port_spark_shim.uninstall()
    with pytest.raises(ImportError, match="pyspark"):
        spark.run(workers.rank_and_pid, num_proc=2)


def test_torchrun_env_from_the_tasks_hosts():
    hosts = ["a", "b", "a", "c", "b"]
    envs = [spark.torchrun_env(hosts, i, "a:29500") for i in range(5)]
    assert [e["LOCAL_RANK"] for e in envs] == ["0", "0", "1", "0", "1"]
    assert [e["LOCAL_WORLD_SIZE"] for e in envs] == ["2", "2", "2", "1", "2"]
    assert [e["GROUP_RANK"] for e in envs] == ["0", "1", "0", "2", "1"]
    assert {e["GROUP_WORLD_SIZE"] for e in envs} == {"3"}
    assert {(e["MASTER_ADDR"], e["MASTER_PORT"], e["WORLD_SIZE"])
            for e in envs} == {("a", "29500", "5")}
    assert [e["RANK"] for e in envs] == ["0", "1", "2", "3", "4"]


def test_task_mapper_survives_the_standard_pickle(monkeypatch):
    """The card's host has no cloudpickle: the mapper and a module-level
    ``fn`` travel by reference through the standard ``pickle``."""
    from horovod_tpu_torch.runner import run_func

    monkeypatch.setattr(run_func, "_serializer", lambda: pickle)
    mapper = spark.TaskMapper(workers.launched_rank, (np.ones(2),), {},
                              {"A": 1}, "cpu", "gloo")
    back = pickle.loads(pickle.dumps(mapper))
    fn, args, kwargs = pickle.loads(back.payload)
    assert fn is workers.launched_rank and kwargs == {}
    assert (back.env, back.device, back.backend) == ({"A": "1"}, "cpu",
                                                     "gloo")


def test_run_forms_a_two_rank_world_in_rank_order(pyspark):
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    res = spark.run(workers.launched_rank, args=(x,), num_proc=2,
                    env={"HVD_TPU_TEST_MARK": "1"}, device="cpu",
                    backend="gloo")
    assert [r["rank"] for r in res] == [0, 1]
    assert res[0]["pid"] != res[1]["pid"]
    for i, r in enumerate(res):
        env = r["env"]
        assert env["RANK"] == str(i) and env["WORLD_SIZE"] == "2"
        assert (env["LOCAL_RANK"], env["LOCAL_WORLD_SIZE"]) == (str(i), "2")
        assert (env["GROUP_RANK"], env["GROUP_WORLD_SIZE"]) == ("0", "1")
        assert env["MASTER_ADDR"] == res[0]["env"]["MASTER_ADDR"]
        assert env["MASTER_PORT"] == res[0]["env"]["MASTER_PORT"]
        assert (r["size"], r["local_rank"], r["local_size"]) == (2, i, 2)
        assert (r["device"], r["backend"]) == ("cpu", "gloo")
        np.testing.assert_array_equal(r["sum"], x * 3)


def test_run_surfaces_an_exception_in_fn(pyspark):
    with pytest.raises(RuntimeError, match="ValueError: rank 1 fails"):
        spark.run(workers.failing_rank, args=("rank 1 fails",), num_proc=2,
                  device="cpu")
