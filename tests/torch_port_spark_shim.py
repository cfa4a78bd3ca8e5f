"""A stand-in for pyspark's barrier stage, for ``horovod_tpu_torch.spark.run``
on hosts without Spark: local processes take the place of Spark's
executors, and no cluster is involved.

It implements the surface ``run`` touches: ``SparkSession.builder.
getOrCreate()``, ``sparkContext.parallelize(...).barrier().mapPartitions(
fn).collect()`` and ``BarrierTaskContext.get()`` with ``allGather`` over a
filesystem rendezvous.  The partition function goes to each task process
by ``pickle`` (cloudpickle where installed), as Spark ships it.  Only
the standard library: no jax, no ``horovod_tpu``, so it serves a host
with torch alone.  Usage::

    import torch_port_spark_shim
    torch_port_spark_shim.install()     # registers ``pyspark``
    results = horovod_tpu_torch.spark.run(fn, num_proc=2, device="cpu")

When a task fails, the others are killed and ``collect()`` raises a
``RuntimeError`` carrying the failed task's traceback.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile
import time
import traceback
import types
from typing import Callable, List

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
TASK_TIMEOUT_S = 600.0


def _serializer():
    try:
        import cloudpickle

        return cloudpickle
    except ImportError:
        return pickle


class BarrierTaskContext:
    """The task's barrier context (one a task process)."""

    _current: "BarrierTaskContext" = None

    def __init__(self, index: int, size: int, sync_dir: str) -> None:
        self._index = index
        self._size = size
        self._sync_dir = sync_dir
        self._round = 0

    @classmethod
    def get(cls) -> "BarrierTaskContext":
        if cls._current is None:
            raise RuntimeError("not inside a barrier task")
        return cls._current

    def partitionId(self) -> int:
        return self._index

    def allGather(self, message: str = "") -> List[str]:
        """Every task's message, in partition order (a directory a round,
        each task's file renamed into place)."""
        self._round += 1
        d = os.path.join(self._sync_dir, f"round{self._round}")
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, f".msg_{self._index}.tmp")
        with open(tmp, "w") as f:
            f.write(message)
        os.replace(tmp, os.path.join(d, f"msg_{self._index}"))
        deadline = time.monotonic() + 120.0
        paths = [os.path.join(d, f"msg_{i}") for i in range(self._size)]
        while not all(os.path.exists(p) for p in paths):
            if time.monotonic() > deadline:
                raise TimeoutError(f"allGather round {self._round}: peers "
                                   f"missing in {d}")
            time.sleep(0.05)
        out = []
        for p in paths:
            with open(p) as f:
                out.append(f.read())
        return out

    def barrier(self) -> None:
        self.allGather("")


class _BarrierRDD:
    def __init__(self, n_parts: int) -> None:
        self._n = n_parts
        self._fn: Callable = None

    def mapPartitions(self, fn: Callable) -> "_BarrierRDD":
        self._fn = fn
        return self

    def collect(self) -> list:
        with tempfile.TemporaryDirectory(prefix="torch_port_spark_") as work:
            with open(os.path.join(work, "fn.pkl"), "wb") as f:
                _serializer().dump(self._fn, f)
            env = dict(os.environ)
            env["PYTHONPATH"] = os.pathsep.join(
                p for p in (ROOT, TESTS, env.get("PYTHONPATH", "")) if p)
            procs = [subprocess.Popen(
                [sys.executable, "-c",
                 "import torch_port_spark_shim as s; s._task_main()",
                 work, str(i), str(self._n)], env=env)
                for i in range(self._n)]
            deadline = time.monotonic() + TASK_TIMEOUT_S
            try:
                while (any(p.poll() is None for p in procs)
                       and not any(p.returncode for p in procs)
                       and time.monotonic() < deadline):
                    time.sleep(0.1)
            finally:
                for p in procs:     # never leave a task process behind
                    if p.poll() is None:
                        p.kill()
                    p.wait()
            rcs = [p.returncode for p in procs]
            if any(rcs):
                errors = []
                for i in range(self._n):
                    path = os.path.join(work, f"error_{i}.txt")
                    if os.path.exists(path):
                        with open(path) as f:
                            errors.append(f"task {i}:\n{f.read()}")
                raise RuntimeError(f"barrier stage failed: rcs={rcs}\n"
                                   + "\n".join(errors))
            out = []
            for i in range(self._n):
                with open(os.path.join(work, f"out_{i}.pkl"), "rb") as f:
                    out.extend(pickle.load(f))
            return out


class _RDD(_BarrierRDD):
    def barrier(self) -> "_BarrierRDD":
        return self


class _SparkContext:
    defaultParallelism = 2

    def parallelize(self, seq, n_parts: int) -> _RDD:
        return _RDD(int(n_parts))


class _Session:
    def __init__(self) -> None:
        self.sparkContext = _SparkContext()


class _Builder:
    def getOrCreate(self) -> _Session:
        return _Session()


def _task_main() -> None:
    """A task process: become barrier task ``index`` and run the shipped
    partition function on it."""
    work, index, size = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    install()   # ``from pyspark import BarrierTaskContext`` resolves here
    BarrierTaskContext._current = BarrierTaskContext(
        index, size, os.path.join(work, "sync"))
    try:
        with open(os.path.join(work, "fn.pkl"), "rb") as f:
            fn = _serializer().load(f)
        results = list(fn(iter([index])))
    except BaseException:
        with open(os.path.join(work, f"error_{index}.txt"), "w") as f:
            f.write(traceback.format_exc())
        sys.exit(1)
    tmp = os.path.join(work, f".out_{index}.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(results, f)
    os.replace(tmp, os.path.join(work, f"out_{index}.pkl"))


def install() -> types.ModuleType:
    """Register the stand-in as ``pyspark`` (and ``pyspark.sql``)."""
    mod = types.ModuleType("pyspark")
    mod.BarrierTaskContext = BarrierTaskContext
    sql = types.ModuleType("pyspark.sql")

    class SparkSession:
        builder = _Builder()

    sql.SparkSession = SparkSession
    mod.sql = sql
    sys.modules["pyspark"] = mod
    sys.modules["pyspark.sql"] = sql
    return mod


def uninstall() -> None:
    for m in ("pyspark", "pyspark.sql"):
        sys.modules.pop(m, None)
