"""``horovod_tpu_torch.ray``: training on a Ray cluster.

Counterpart of ``horovod_tpu/ray/__init__.py`` (reference:
``horovod/ray/runner.py``, ``RayExecutor``): worker actors placed by a
placement group (:mod:`.strategy`), joined into one world of the port,
``fn`` run on every rank with the results in rank order.

The actors run :class:`Worker`, a module-level class, in the
reference's sequence: ``coordinator_address`` on rank 0's actor, then
``setup`` on every actor, ``execute`` for each call, ``shutdown``.
``setup`` sets torchrun's variables (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` / ``MASTER_PORT`` from rank 0's actor, and the local
and group ranks from every actor's node address) and calls
``init(device=, backend=)``.  ray is imported by the executor's methods
alone: without it the package imports, the placement math works and
``start()`` raises an ``ImportError`` naming it.

With GPUs, Ray hides from each actor every card but its own (its
``CUDA_VISIBLE_DEVICES``), while ``init()`` with no device takes
``cuda:<local_rank>``.  So ``start`` gives every actor on a node the
union of the cards Ray gave that node's actors, in rank order, as
upstream ``horovod.ray`` does, and, where no ``device`` was asked for,
``cuda:<i>`` with ``i`` its own first card's place in that union.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .strategy import pack_bundles, ranks_per_bundle, spread_bundles  # noqa: F401


def _require_ray():
    try:
        import ray

        return ray
    except ImportError as e:
        raise ImportError(
            "horovod_tpu_torch.ray requires ray (`pip install "
            "'ray[default]'`), which is not installed") from e


class Settings:
    """Reference: ``RayExecutor.create_settings``'s product: the launch
    knobs."""

    def __init__(self, *, timeout_s: float = 300.0,
                 placement_group_timeout_s: float = 100.0,
                 verbose: int = 1):
        self.timeout_s = timeout_s
        self.placement_group_timeout_s = placement_group_timeout_s
        self.verbose = verbose


class Worker:
    """One rank, inside a Ray actor."""

    def node_address(self) -> str:
        import ray

        return ray.util.get_node_ip_address()

    def coordinator_address(self) -> str:
        """``host:port`` of this actor's node, the port free there: the
        rendezvous store listens inside rank 0's actor, not on the
        driver's host."""
        from ..runner.common.network import free_port

        return f"{self.node_address()}:{free_port()}"

    def gpu_ids(self) -> List[str]:
        """The cards Ray gave this actor."""
        import ray

        return [str(i) for i in ray.get_gpu_ids()]

    def setup(self, env: Dict[str, str], device, backend) -> None:
        import os

        import horovod_tpu_torch as hvd

        os.environ.update(env)
        hvd.init(device=device, backend=backend)

    def execute(self, fn, args, kwargs):
        return fn(*args, **kwargs)

    def shutdown(self) -> None:
        import horovod_tpu_torch as hvd

        hvd.shutdown()


def node_gpus(hosts: Sequence[str], gpu_ids: Sequence[Sequence[str]]
              ) -> List[Tuple[Optional[str], Optional[int]]]:
    """For each rank, given every rank's node and the cards Ray gave it:
    ``CUDA_VISIBLE_DEVICES`` (the union over the ranks of its node, in
    rank order) and its own first card's place there; ``(None, None)``
    for a rank that was given no card."""
    union: Dict[str, List[str]] = {}
    for host, ids in zip(hosts, gpu_ids):
        seen = union.setdefault(host, [])
        seen.extend(i for i in ids if i not in seen)
    return [(",".join(union[host]), union[host].index(ids[0])) if ids
            else (None, None) for host, ids in zip(hosts, gpu_ids)]


class RayExecutor:
    """Reference API::

        executor = RayExecutor(settings, num_workers=4, use_gpu=True)
        executor.start()
        results = executor.run(train_fn, args=[...])
        executor.shutdown()

    ``use_gpu=True`` asks one card a worker unless ``gpus_per_worker``
    says otherwise (upstream ``horovod.ray``'s default).  ``device`` and
    ``backend`` go to each rank's ``init`` (None: the rank's own card
    among its node's, see :func:`node_gpus`, and NCCL;
    ``device="cuda:0", backend="gloo"`` puts several actors on one
    card)."""

    def __init__(self, settings: Optional[Settings] = None, *,
                 num_workers: int = 1, cpus_per_worker: int = 1,
                 gpus_per_worker: Optional[int] = None,
                 use_gpu: bool = False,
                 strategy: str = "pack",
                 workers_per_host: Optional[int] = None,
                 device=None, backend: Optional[str] = None):
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        if strategy not in ("pack", "spread"):
            raise ValueError("strategy must be 'pack' or 'spread'")
        self.settings = settings or Settings()
        self.num_workers = num_workers
        self.cpus_per_worker = cpus_per_worker
        if not use_gpu:
            self.gpus_per_worker = 0
        else:
            self.gpus_per_worker = 1 if gpus_per_worker is None \
                else gpus_per_worker
        self.strategy = strategy
        self.workers_per_host = workers_per_host
        self.device = None if device is None else str(device)
        self.backend = backend
        self._workers: List[Any] = []
        self._pg = None

    def bundles(self) -> List[Dict[str, int]]:
        """The placement group's bundles this executor asks for (pure
        math: capacity planning without ray)."""
        if self.strategy == "spread":
            return spread_bundles(self.num_workers, self.cpus_per_worker,
                                  self.gpus_per_worker)
        return pack_bundles(self.num_workers, self.cpus_per_worker,
                            self.gpus_per_worker, self.workers_per_host)

    def start(self) -> None:
        """The placement group, one actor a rank, and the world."""
        ray = _require_ray()
        from ray.util.placement_group import placement_group

        from ..spark import torchrun_env

        self._pg = placement_group(self.bundles(),
                                   strategy=self.strategy.upper())
        ray.get(self._pg.ready(),
                timeout=self.settings.placement_group_timeout_s)
        remote = ray.remote(num_cpus=self.cpus_per_worker,
                            num_gpus=self.gpus_per_worker or None)(Worker)
        ranks = ranks_per_bundle(self.num_workers, self.bundles(),
                                 self.cpus_per_worker)
        self._workers = [
            remote.options(placement_group=self._pg,
                           placement_group_bundle_index=i).remote()
            for i, bundle_ranks in enumerate(ranks) for _ in bundle_ranks]
        timeout = self.settings.timeout_s
        master = ray.get(self._workers[0].coordinator_address.remote(),
                         timeout=timeout)
        hosts = ray.get([w.node_address.remote() for w in self._workers],
                        timeout=timeout)
        envs = [torchrun_env(hosts, i, master)
                for i in range(len(self._workers))]
        devices = [self.device] * len(self._workers)
        if self.gpus_per_worker:
            gpu_ids = ray.get([w.gpu_ids.remote() for w in self._workers],
                              timeout=timeout)
            for i, (visible, own) in enumerate(node_gpus(hosts, gpu_ids)):
                if visible is not None:
                    envs[i]["CUDA_VISIBLE_DEVICES"] = visible
                    if devices[i] is None:
                        devices[i] = f"cuda:{own}"
        ray.get([w.setup.remote(env, device, self.backend)
                 for w, env, device in zip(self._workers, envs, devices)],
                timeout=timeout)

    def run(self, fn: Callable, args: Optional[List] = None,
            kwargs: Optional[Dict] = None) -> List[Any]:
        """``fn`` on every rank; the results in rank order."""
        ray = _require_ray()
        if not self._workers:
            raise RuntimeError("call start() before run()")
        return ray.get([w.execute.remote(fn, args or [], kwargs or {})
                        for w in self._workers],
                       timeout=self.settings.timeout_s)

    def execute_single(self, fn: Callable, rank: int = 0) -> Any:
        """``fn`` on one rank alone."""
        ray = _require_ray()
        return ray.get(self._workers[rank].execute.remote(fn, [], {}),
                       timeout=self.settings.timeout_s)

    def shutdown(self) -> None:
        """Every rank's ``shutdown()``, then the actors and the placement
        group."""
        if not self._workers:
            return
        ray = _require_ray()
        try:
            ray.get([w.shutdown.remote() for w in self._workers], timeout=60)
        finally:
            for w in self._workers:
                ray.kill(w)
            self._workers = []
            if self._pg is not None:
                from ray.util.placement_group import remove_placement_group

                remove_placement_group(self._pg)
                self._pg = None
