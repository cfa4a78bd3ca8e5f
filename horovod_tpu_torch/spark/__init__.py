"""``horovod_tpu_torch.spark``: training inside Spark executors.

Counterpart of ``horovod_tpu/spark/__init__.py`` (reference:
``horovod.spark.run``): a barrier stage of ``num_proc`` tasks becomes one
world of the port, ``fn`` runs on every rank, and the results come back
in rank order.

Each task publishes its host through the barrier's ``allGather`` (rank 0
also an address with a free port), then sets torchrun's variables, the
port's launch contract: ``RANK`` and ``WORLD_SIZE``; ``MASTER_ADDR`` and
``MASTER_PORT`` from rank 0's task; ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``GROUP_RANK`` and ``GROUP_WORLD_SIZE`` from every task's host.  Then it
calls ``init(device=, backend=)`` (defaults: ``cuda:<local_rank>`` and
NCCL), runs ``fn`` and always calls ``shutdown()``.

The partition function is :class:`TaskMapper`, a module-level class
that the standard ``pickle`` takes; ``fn`` with its arguments travels
inside it as :func:`horovod_tpu_torch.run` ships a payload (cloudpickle
where installed, else by reference).  pyspark is imported by :func:`run`
alone: without it the package imports and ``run`` raises an
``ImportError`` naming it.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Iterable, Iterator, Optional, Sequence

from .common.store import FilesystemStore, LocalStore, Store  # noqa: F401


def _require_pyspark():
    try:
        import pyspark

        return pyspark
    except ImportError as e:
        raise ImportError(
            "horovod_tpu_torch.spark.run requires pyspark (`pip install "
            "pyspark`), which is not installed") from e


def torchrun_env(hosts: Sequence[str], index: int, master: str) -> Dict[str,
                                                                      str]:
    """torchrun's variables for task ``index`` of a world whose tasks run
    on ``hosts`` (in rank order), rank 0 listening at ``master``
    (``host:port``): the local rank and size among the tasks of its host,
    and the host's place among the distinct hosts in order of first
    appearance."""
    host = hosts[index]
    groups = list(dict.fromkeys(hosts))
    addr, port = master.rsplit(":", 1)
    return {
        "RANK": str(index),
        "WORLD_SIZE": str(len(hosts)),
        "MASTER_ADDR": addr,
        "MASTER_PORT": port,
        "LOCAL_RANK": str(hosts[:index].count(host)),
        "LOCAL_WORLD_SIZE": str(hosts.count(host)),
        "GROUP_RANK": str(groups.index(host)),
        "GROUP_WORLD_SIZE": str(len(groups)),
    }


class TaskMapper:
    """The barrier stage's partition function: task ``index`` joins the
    world, runs ``fn`` and yields ``(index, result)``."""

    def __init__(self, fn: Callable, args: Sequence, kwargs: Dict,
                 env: Dict, device, backend: Optional[str]) -> None:
        from ..runner.run_func import _serializer

        self.payload = _serializer().dumps((fn, tuple(args), dict(kwargs)))
        self.env = {k: str(v) for k, v in env.items()}
        self.device = None if device is None else str(device)
        self.backend = backend

    def __call__(self, index_iter: Iterable[int]) -> Iterator:
        from pyspark import BarrierTaskContext

        import horovod_tpu_torch as hvd
        from ..runner.run_func import _serializer

        ctx = BarrierTaskContext.get()
        fn, args, kwargs = _serializer().loads(self.payload)
        for index in index_iter:
            os.environ.update(self.env)
            host = _local_host()
            # The rendezvous store listens inside rank 0's task, on its
            # executor's host: rank 0 names it, allGather publishes it.
            mine = {"host": host,
                    "master": f"{host}:{_free_port()}" if index == 0 else ""}
            infos = [json.loads(m) for m in ctx.allGather(json.dumps(mine))]
            master = next(i["master"] for i in infos if i["master"])
            os.environ.update(torchrun_env([i["host"] for i in infos],
                                           index, master))
            hvd.init(device=self.device, backend=self.backend)
            try:
                yield index, fn(*args, **kwargs)
            finally:
                hvd.shutdown()


def run(fn: Callable, args: Sequence = (), kwargs: Optional[Dict] = None,
        num_proc: Optional[int] = None, *, env: Optional[Dict] = None,
        start_timeout: float = 600.0, verbose: int = 1,
        use_gloo: bool = False, use_mpi: bool = False,
        device=None, backend: Optional[str] = None) -> list:
    """Reference: ``horovod.spark.run(fn, args=..., num_proc=N)``: ``fn``
    on ``num_proc`` Spark tasks as one world; the results in rank order.

    ``device`` and ``backend`` are passed to each task's ``init`` (None:
    ``cuda:<local_rank>`` and NCCL; ``device="cuda:0", backend="gloo"``
    puts several tasks on one card).  ``start_timeout``, ``verbose``,
    ``use_gloo`` and ``use_mpi`` are taken for the reference's signature
    and ignored: the backend is ``backend``'s, and the barrier stage
    starts every task at once or fails."""
    pyspark = _require_pyspark()
    spark = pyspark.sql.SparkSession.builder.getOrCreate()
    sc = spark.sparkContext
    if num_proc is None:
        num_proc = int(sc.defaultParallelism)
    mapper = TaskMapper(fn, args, kwargs or {}, env or {}, device, backend)
    # Barrier mode: all tasks at once or none, since a world cannot start
    # in part (the reference's reason too).
    rdd = sc.parallelize(range(num_proc), num_proc)
    results = rdd.barrier().mapPartitions(mapper).collect()
    return [r for _, r in sorted(results, key=lambda pair: pair[0])]


def _local_host() -> str:
    """This machine's resolvable name (an executor's, inside a task)."""
    from ..runner.common.network import resolvable_hostname

    return resolvable_hostname()


def _free_port() -> int:
    from ..runner.common.network import free_port

    return free_port()
