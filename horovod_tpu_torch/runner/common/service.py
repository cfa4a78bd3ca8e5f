"""Driver and task services of the multi-host launch.

Counterpart of ``horovod_tpu/runner/common/service.py`` (Horovod's
``runner/common/service/driver_service.py`` and ``task_service.py``).
Before any worker calls ``init()``, the launcher runs a driver service
on its host and a task service (:mod:`..task_agent`) on every target
host.  The tasks register with the driver; the driver has every task
probe every other (the routes their peers can reach); then each task is
told to start its ranks.

Each rank gets torchrun's variables, as the local launcher gives them:
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` (its position among the task's
ranks), ``LOCAL_WORLD_SIZE``, ``GROUP_RANK`` (the task's index),
``GROUP_WORLD_SIZE`` (the tasks that hold any rank), and
``MASTER_ADDR``/``MASTER_PORT``: rank 0's host at the route its peers
proved, and the port that host's task reserved, released just before
its ranks start so that rank 0's ``TCPStore`` binds it.  The task also
stamps the launch's HMAC key (``HVD_TPU_SECRET_KEY``) from the key it
read on stdin (a request is signed, not encrypted, so the key never
travels in one) and, with ``--network-interfaces``, names the same
interfaces in ``GLOO_SOCKET_IFNAME`` and ``NCCL_SOCKET_IFNAME``.
"""

from __future__ import annotations

import os
import socket
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .network import AckResponse, BasicClient, BasicService
from .safe_shell_exec import GRACEFUL_TERMINATION_TIME_S, execute
from .secret import SECRET_ENV


class RegisterTaskRequest:
    def __init__(self, index: int, addresses: List[Tuple[str, int]],
                 hostname: str,
                 coordinator_port: Optional[int] = None):
        self.index = index
        self.addresses = addresses
        self.hostname = hostname
        # A free port the task reserved on its host: if it holds rank 0,
        # the rendezvous store binds here.
        self.coordinator_port = coordinator_port


class AllTaskAddressesRequest:
    def __init__(self, index: int):
        self.index = index


class AllTaskAddressesResponse:
    def __init__(self, all_addresses: Dict[int, List[Tuple[str, int]]]):
        self.all_addresses = all_addresses


class ProbePeerRequest:
    def __init__(self, peer_index: int,
                 peer_addresses: List[Tuple[str, int]]):
        self.peer_index = peer_index
        self.peer_addresses = peer_addresses


class ProbePeerResponse:
    def __init__(self, reachable_address: Optional[Tuple[str, int]]):
        self.reachable_address = reachable_address


class RunCommandRequest:
    def __init__(self, command: List[str], env: Dict[str, str]):
        self.command = command
        self.env = env


class CommandExitCodeRequest:
    pass


class CommandExitCodeResponse:
    def __init__(self, done: bool, exit_code: Optional[int]):
        self.done = done
        self.exit_code = exit_code


class RunDistributedCommandRequest:
    """Start the worker command once for each of ``ranks``, each wired
    into one world of ``world_size`` over the rendezvous at
    ``coordinator`` (``host:port``); ``group_world_size`` is the number
    of tasks that hold any rank (with ``-np`` capping the slots, trailing
    hosts may hold none)."""

    def __init__(self, command: List[str], env: Dict[str, str],
                 ranks: List[int], world_size: int, coordinator: str,
                 group_world_size: int = 1):
        self.command = command
        self.env = env
        self.ranks = ranks
        self.world_size = world_size
        self.coordinator = coordinator
        self.group_world_size = group_world_size


class DistributedExitCodesRequest:
    pass


class DistributedExitCodesResponse:
    def __init__(self, codes: Dict[int, Optional[int]]):
        self.codes = codes  # rank -> exit code (None while running)


class AbortCommandRequest:
    pass


class AgentShutdownRequest:
    pass


class DriverService(BasicService):
    """Collects the tasks' registrations and answers the address table
    (reference: ``HorovodRunDriverService``)."""

    def __init__(self, num_tasks: int, key: bytes, name: str = "driver",
                 nics=None):
        super().__init__(name, key, nics=nics)
        self._num_tasks = num_tasks
        self._tasks: Dict[int, RegisterTaskRequest] = {}
        self._cv = threading.Condition()

    def _handle(self, req: Any, client_address) -> Any:
        if isinstance(req, RegisterTaskRequest):
            with self._cv:
                self._tasks[req.index] = req
                self._cv.notify_all()
            return AckResponse()
        if isinstance(req, AllTaskAddressesRequest):
            with self._cv:
                return AllTaskAddressesResponse(
                    {i: t.addresses for i, t in self._tasks.items()})
        return super()._handle(req, client_address)

    def wait_for_initial_registration(self, timeout_s: float = 120.0) -> None:
        with self._cv:
            ok = self._cv.wait_for(
                lambda: len(self._tasks) >= self._num_tasks,
                timeout=timeout_s)
        if not ok:
            missing = sorted(set(range(self._num_tasks)) - set(self._tasks))
            raise TimeoutError(
                f"tasks {missing} did not register within {timeout_s}s")

    def task_addresses(self) -> Dict[int, List[Tuple[str, int]]]:
        with self._cv:
            return {i: t.addresses for i, t in self._tasks.items()}

    def task_hostnames(self) -> Dict[int, str]:
        with self._cv:
            return {i: t.hostname for i, t in self._tasks.items()}

    def task_coordinator_ports(self) -> Dict[int, Optional[int]]:
        with self._cv:
            return {i: t.coordinator_port for i, t in self._tasks.items()}


def rank_env(rank: int, ranks: List[int], req: RunDistributedCommandRequest,
             index: int) -> Dict[str, str]:
    """torchrun's variables for ``rank``, one of this task's ``ranks``."""
    host, _, port = req.coordinator.rpartition(":")
    return {"RANK": str(rank), "WORLD_SIZE": str(req.world_size),
            "LOCAL_RANK": str(ranks.index(rank)),
            "LOCAL_WORLD_SIZE": str(len(ranks)),
            "GROUP_RANK": str(index),
            "GROUP_WORLD_SIZE": str(req.group_world_size),
            "MASTER_ADDR": host, "MASTER_PORT": port}


class TaskService(BasicService):
    """A host's agent: answers pings, probes peers on request, and runs
    the worker command (reference: ``HorovodRunTaskService``)."""

    def __init__(self, index: int, key: bytes, name: Optional[str] = None,
                 nics=None):
        super().__init__(name or f"task-{index}", key, nics=nics)
        self.index = index
        self._key_bytes = key
        self._cmd_thread: Optional[threading.Thread] = None
        self._exit_code: Optional[int] = None
        self._abort = threading.Event()
        self._rank_threads: Dict[int, threading.Thread] = {}
        self._rank_codes: Dict[int, Optional[int]] = {}
        self.shutdown_requested = threading.Event()
        self._coord_sock: Optional[socket.socket] = None

    @property
    def command_started(self) -> bool:
        """True once any (single or distributed) command was started."""
        return self._cmd_thread is not None or bool(self._rank_threads)

    def reserve_coordinator_port(self) -> int:
        """Bind and hold a listening socket for the rendezvous store;
        :meth:`_launch_distributed` releases it just before the ranks
        start, so the port can be stolen only in the moment between the
        release and rank 0's bind."""
        s = socket.socket()
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("0.0.0.0", 0))
        s.listen(1)
        self._coord_sock = s
        return s.getsockname()[1]

    def _handle(self, req: Any, client_address) -> Any:
        if isinstance(req, ProbePeerRequest):
            try:
                client = BasicClient(f"task-{req.peer_index}",
                                     req.peer_addresses, self._key_bytes,
                                     probe_timeout=3.0)
                return ProbePeerResponse(client.address)
            except ConnectionError:
                return ProbePeerResponse(None)
        if isinstance(req, RunCommandRequest):
            self._launch(req.command, req.env)
            return AckResponse()
        if isinstance(req, CommandExitCodeRequest):
            done = (self._cmd_thread is not None
                    and not self._cmd_thread.is_alive())
            return CommandExitCodeResponse(done,
                                           self._exit_code if done else None)
        if isinstance(req, RunDistributedCommandRequest):
            self._launch_distributed(req)
            return AckResponse()
        if isinstance(req, DistributedExitCodesRequest):
            codes = {rank: (self._rank_codes[rank]
                            if not t.is_alive() else None)
                     for rank, t in self._rank_threads.items()}
            return DistributedExitCodesResponse(codes)
        if isinstance(req, AbortCommandRequest):
            self._abort.set()
            return AckResponse()
        if isinstance(req, AgentShutdownRequest):
            self.shutdown_requested.set()
            return AckResponse()
        return super()._handle(req, client_address)

    def _launch_distributed(self, req: RunDistributedCommandRequest) -> None:
        if any(t.is_alive() for t in self._rank_threads.values()):
            raise RuntimeError("a distributed command is already running")
        if self._coord_sock is not None:
            # Release the held port now: rank 0 (perhaps one of this
            # task's) binds it in init.
            self._coord_sock.close()
            self._coord_sock = None
        ranks = list(req.ranks)
        for rank in ranks:
            # As the local launcher's workers: this host's environment,
            # the driver's variables over it, then the rank's own.
            env = dict(os.environ)
            env.update(req.env)
            env.update(rank_env(rank, ranks, req, self.index))
            env[SECRET_ENV] = self._key_bytes.decode()
            if self._nics:
                env["GLOO_SOCKET_IFNAME"] = env["NCCL_SOCKET_IFNAME"] = \
                    ",".join(self._nics)
            self._rank_codes[rank] = None

            def target(rank=rank, env=env):
                try:
                    self._rank_codes[rank] = execute(
                        req.command, env=env, events=[self._abort])
                except Exception as e:
                    # A spawn failure (a missing executable) must still
                    # report an exit code, or the driver polls forever.
                    print(f"rank {rank} failed to spawn: {e}",
                          file=sys.stderr)
                    self._rank_codes[rank] = 127

            t = threading.Thread(target=target, daemon=True)
            self._rank_threads[rank] = t
            t.start()

    def _launch(self, command: List[str], env: Dict[str, str]) -> None:
        if self._cmd_thread is not None and self._cmd_thread.is_alive():
            raise RuntimeError("a command is already running")

        def target():
            self._exit_code = execute(command, env=env,
                                      events=[self._abort])

        self._cmd_thread = threading.Thread(target=target, daemon=True)
        self._cmd_thread.start()

    def wait_for_command(self, timeout_s: Optional[float] = None) -> int:
        if self._cmd_thread is None:
            raise RuntimeError("no command was launched")
        self._cmd_thread.join(timeout=timeout_s)
        if self._cmd_thread.is_alive():
            raise TimeoutError("command still running")
        return self._exit_code

    def abort_command(self) -> None:
        self._abort.set()

    def shutdown(self) -> None:
        """Abort whatever still runs and wait for its process groups to
        be gone (TERM, then KILL after the grace period), so no worker
        outlives its task."""
        self._abort.set()
        deadline = time.monotonic() + GRACEFUL_TERMINATION_TIME_S + 5.0
        for t in [self._cmd_thread, *self._rank_threads.values()]:
            if t is not None:
                t.join(timeout=max(0.0, deadline - time.monotonic()))
        if self._coord_sock is not None:
            self._coord_sock.close()
            self._coord_sock = None
        super().shutdown()


def probe_full_mesh(driver: DriverService, key: bytes,
                    timeout_s: float = 60.0) -> Dict[Tuple[int, int],
                                                     Tuple[str, int]]:
    """Have every task reach every other: for each ordered pair (i, j),
    ask i to reach j; returns ``{(i, j): the address that answered}``.
    Raises if any pair cannot reach."""
    addresses = driver.task_addresses()
    clients = {i: BasicClient(f"task-{i}", addrs, key)
               for i, addrs in addresses.items()}
    routes: Dict[Tuple[int, int], Tuple[str, int]] = {}
    deadline = time.monotonic() + timeout_s
    for i, client in clients.items():
        for j, peer_addrs in addresses.items():
            if i == j:
                continue
            if time.monotonic() > deadline:
                raise TimeoutError("mesh probe timed out")
            # Each exchange may wait what is left of the budget.
            resp = client.request(
                ProbePeerRequest(j, peer_addrs),
                timeout=max(1.0, deadline - time.monotonic()))
            if resp.reachable_address is None:
                raise ConnectionError(f"task {i} cannot reach task {j}")
            routes[(i, j)] = resp.reachable_address
    return routes
