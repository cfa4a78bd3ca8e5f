"""The port's Ray tier (``horovod_tpu_torch/ray/``) against the reference's
(``horovod_tpu.ray``), and what a host without the framework packages
sees.

* ``strategy``: the pack and spread bundles, and the ranks each holds,
  equal the reference's over a grid of workers × cpus × gpus ×
  ``workers_per_host``; the executor's ``bundles()`` too.
* ``RayExecutor`` over the stand-in for Ray (``tests/torch_port_ray_shim.
  py``: local processes for actors, the standard ``pickle`` or
  cloudpickle for calls) with two actors on gloo on the CPU: ``start``,
  ``run`` (torchrun's variables, an allreduce, results in rank order),
  ``execute_single``, ``shutdown``, and no actor process left.
* In a subprocess with tensorflow, keras, mxnet, pyspark, ray, pandas,
  pyarrow, cloudpickle, jax and ``horovod_tpu`` hidden: ``import
  horovod_tpu_torch`` and ``.torch`` work, ``.spark`` and ``.ray``
  import with their stores and placement math, ``.mxnet`` raises naming
  mxnet, and ``spark.run`` / ``RayExecutor.start`` raise naming pyspark
  / ray.
"""

import itertools
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import torch_port_ray_shim
import torch_port_workers as workers
from horovod_tpu import ray as ref_ray
from horovod_tpu.ray import strategy as ref_strategy
from horovod_tpu_torch import ray as port_ray
from horovod_tpu_torch.ray import strategy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_GRID = list(itertools.product((1, 2, 3, 5, 8), (1, 2, 4), (0, 1, 2),
                               (None, 1, 2, 3, 4)))


@pytest.mark.parametrize("workers_n,cpus,gpus,per_host", _GRID)
def test_bundles_and_ranks_match_the_reference(workers_n, cpus, gpus,
                                               per_host):
    pack = strategy.pack_bundles(workers_n, cpus, gpus, per_host)
    assert pack == ref_strategy.pack_bundles(workers_n, cpus, gpus, per_host)
    spread = strategy.spread_bundles(workers_n, cpus, gpus)
    assert spread == ref_strategy.spread_bundles(workers_n, cpus, gpus)
    for bundles in (pack, spread):
        assert strategy.ranks_per_bundle(workers_n, bundles, cpus) \
            == ref_strategy.ranks_per_bundle(workers_n, bundles, cpus)
    for strat in ("pack", "spread"):
        kwargs = dict(num_workers=workers_n, cpus_per_worker=cpus,
                      gpus_per_worker=gpus, use_gpu=bool(gpus),
                      strategy=strat, workers_per_host=per_host)
        assert port_ray.RayExecutor(**kwargs).bundles() \
            == ref_ray.RayExecutor(**kwargs).bundles()


def test_placement_errors_match_the_reference():
    for fn, args in ((strategy.pack_bundles, (0,)),
                     (strategy.pack_bundles, (2, 1, 0, -1)),
                     (strategy.ranks_per_bundle, (3, [{"CPU": 1}]))):
        ref_fn = getattr(ref_strategy, fn.__name__)
        with pytest.raises(ValueError) as got:
            fn(*args)
        with pytest.raises(ValueError) as want:
            ref_fn(*args)
        assert str(got.value) == str(want.value)
    for bad in (dict(num_workers=0), dict(strategy="round-robin")):
        with pytest.raises(ValueError):
            port_ray.RayExecutor(**bad)


@pytest.fixture()
def ray():
    mod = torch_port_ray_shim.install()
    yield mod
    torch_port_ray_shim.uninstall()


def test_executor_two_actors_over_the_stand_in(ray):
    ex = port_ray.RayExecutor(num_workers=2, device="cpu", backend="gloo")
    with pytest.raises(RuntimeError, match="start"):
        ex.run(workers.rank_and_pid)
    ex.start()
    try:
        x = np.arange(6, dtype=np.float32).reshape(3, 2)
        res = ex.run(workers.launched_rank, args=[x])
        assert [r["rank"] for r in res] == [0, 1]
        for i, r in enumerate(res):
            env = r["env"]
            assert (env["RANK"], env["WORLD_SIZE"]) == (str(i), "2")
            assert env["MASTER_ADDR"] == "127.0.0.1"
            assert (env["LOCAL_RANK"], env["LOCAL_WORLD_SIZE"]) == (str(i),
                                                                    "2")
            assert (env["GROUP_RANK"], env["GROUP_WORLD_SIZE"]) == ("0", "1")
            assert (r["device"], r["backend"]) == ("cpu", "gloo")
            np.testing.assert_array_equal(r["sum"], x * 3)
        pids = [r["pid"] for r in res]
        assert sorted(pids) == sorted(torch_port_ray_shim.live_actors())
        assert ex.execute_single(workers.rank_and_pid, rank=1) \
            == (1, pids[1])
        assert ex.execute_single(workers.rank_and_pid) == (0, pids[0])
    finally:
        ex.shutdown()
    assert not torch_port_ray_shim.live_actors()
    ex.shutdown()   # a second shutdown is a no-op


def test_node_gpus_unions_each_nodes_cards_in_rank_order():
    hosts = ["a", "b", "a", "b", "a"]
    ids = [["2"], ["0", "1"], ["7"], ["3", "4"], []]
    assert port_ray.node_gpus(hosts, ids) == [
        ("2,7", 0), ("0,1,3,4", 0), ("2,7", 1), ("0,1,3,4", 2),
        (None, None)]


@pytest.mark.parametrize("gpus_per_worker", [None, 2])
def test_executor_gives_each_actor_a_card_it_can_see(gpus_per_worker,
                                                     monkeypatch):
    """Ray shows each actor only its own cards: with no ``device``, rank
    r must not take ``cuda:<local_rank>`` among them (rank 1 would ask
    for a second card where it sees one).  The stand-in hands out cards
    as Ray does and makes ``set_device`` refuse an ordinal the actor
    cannot see; every rank sees its node's cards and takes its own."""
    monkeypatch.setenv("HOROVOD_STALL_CHECK_DISABLE", "1")
    torch_port_ray_shim.install(gpus=["3", "5", "6", "9"], fake_cuda=True)
    try:
        ex = port_ray.RayExecutor(port_ray.Settings(timeout_s=60),
                                  num_workers=2, use_gpu=True,
                                  gpus_per_worker=gpus_per_worker,
                                  backend="gloo")
        ex.start()
        try:
            res = ex.run(workers.session_device)
        finally:
            ex.shutdown()
    finally:
        torch_port_ray_shim.uninstall()
    per = gpus_per_worker or 1
    visible = ",".join(["3", "5", "6", "9"][:2 * per])
    assert res == [{"rank": r, "local_rank": r, "device": f"cuda:{r * per}",
                    "visible": visible} for r in range(2)]
    assert not torch_port_ray_shim.live_actors()


def test_executor_requires_ray():
    torch_port_ray_shim.uninstall()
    with pytest.raises(ImportError, match="ray"):
        port_ray.RayExecutor(num_workers=2).start()


_ISOLATED = textwrap.dedent("""
    import importlib, sys
    hidden = ("tensorflow", "keras", "ml_dtypes", "mxnet", "pyspark", "ray",
              "pandas", "pyarrow", "cloudpickle", "jax", "horovod_tpu")
    for name in hidden:
        sys.modules[name] = None
    import horovod_tpu_torch
    import horovod_tpu_torch.torch as hvd
    assert hvd.DistributedOptimizer and hvd.SyncBatchNorm
    from horovod_tpu_torch import spark
    from horovod_tpu_torch.ray import RayExecutor, strategy
    import horovod_tpu_torch.spark.torch, horovod_tpu_torch.spark.keras
    import horovod_tpu_torch.spark.lightning
    store = spark.FilesystemStore(sys.argv[1])
    store.write_serialized(store.get_checkpoint_path("r") + "/x", [1])
    assert store.read_serialized(store.get_checkpoint_path("r") + "/x") == [1]
    assert strategy.pack_bundles(3, 2, 1, 2) == [{"CPU": 4, "GPU": 2},
                                                 {"CPU": 2, "GPU": 1}]
    for call, word in ((lambda: importlib.import_module(
                            "horovod_tpu_torch.mxnet"), "mxnet"),
                       (lambda: spark.run(print, num_proc=2), "pyspark"),
                       (lambda: RayExecutor(num_workers=2).start(), "ray")):
        try:
            call()
        except ImportError as e:
            assert word in str(e), e
        else:
            raise AssertionError(word + " was not required")
    leaked = [m for m in hidden if sys.modules.get(m) is not None]
    assert not leaked, leaked
    print("isolated ok")
""")


def test_core_imports_without_the_framework_packages(tmp_path):
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    out = subprocess.run([sys.executable, "-c", _ISOLATED,
                          str(tmp_path / "store")], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "isolated ok" in out.stdout
