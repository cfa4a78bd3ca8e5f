"""The multi-host launch over the driver/task RPC mesh.

Counterpart of ``horovod_tpu/runner/remote.py`` (Horovod's
``runner/gloo_run.py`` with its driver service): the launcher starts a
driver service, starts a task agent (:mod:`.task_agent`) on every host
over ssh, waits for their registrations, has every pair probe each other,
then starts the worker command once a slot and watches the exit codes;
the first failure aborts the job.

The mesh's product is one rendezvous address, ``MASTER_ADDR:
MASTER_PORT``: rank 0's host at the route its peers proved and the port
its agent reserved.  Each rank gets torchrun's variables from its agent
(:mod:`.common.service`).  The RPC mesh is set-up only; the data plane
is ``torch.distributed`` once the world forms.  The remote exec is ssh
in BatchMode by default and can be replaced (``exec_fn``, e.g.
:func:`local_exec`), so tests run the whole protocol on one machine.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

from .common.network import BasicClient
from .common.secret import make_secret_key
from .common.service import (
    AbortCommandRequest, AgentShutdownRequest, DistributedExitCodesRequest,
    DriverService, RunDistributedCommandRequest, probe_full_mesh,
)


def is_local_host(host: str) -> bool:
    """This machine, for every launch path (the CLI and ``hvd.run``)."""
    return host in ("localhost", "127.0.0.1", socket.gethostname())


def parse_hosts(spec: str) -> List[Tuple[str, int]]:
    """``"a:2,b:4"`` -> ``[("a", 2), ("b", 4)]`` (the reference's -H
    syntax; a bare host means one slot)."""
    out: List[Tuple[str, int]] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        host, _, slots = part.partition(":")
        if not host:
            raise ValueError(f"bad -H entry: {part!r}")
        out.append((host, int(slots) if slots else 1))
    return out


def _agent_argv(index: int, driver_addrs: List[Tuple[str, int]],
                timeout_s: float,
                nics: Optional[List[str]] = None) -> List[str]:
    spec = ",".join(f"{h}:{p}" for h, p in driver_addrs)
    argv = [sys.executable, "-m", "horovod_tpu_torch.runner.task_agent",
            "--driver", spec, "--index", str(index),
            "--timeout", str(timeout_s)]
    if nics:
        argv += ["--nics", ",".join(nics)]
    return argv


def ssh_exec(host: str, argv: List[str], secret_hex: str, *,
             ssh_port: Optional[int] = None,
             ssh_identity_file: Optional[str] = None) -> subprocess.Popen:
    """The default remote exec: ssh in BatchMode (no password prompt),
    the secret over stdin; ``ssh_port`` and ``ssh_identity_file`` are the
    launcher's ``--ssh-port`` and ``--ssh-identity-file``."""
    ssh = ["ssh", "-o", "BatchMode=yes", "-o", "StrictHostKeyChecking=no"]
    if ssh_port:
        ssh += ["-p", str(ssh_port)]
    if ssh_identity_file:
        ssh += ["-i", ssh_identity_file]
    proc = subprocess.Popen(ssh + ["--", host] + argv,
                            stdin=subprocess.PIPE, text=True)
    proc.stdin.write(secret_hex + "\n")
    proc.stdin.flush()
    proc.stdin.close()
    return proc


def local_exec(host: str, argv: List[str],
               secret_hex: str, **_ssh_opts) -> subprocess.Popen:
    """Start an agent as a local child: loopback hosts standing in for
    remote ones, the whole RPC protocol still running.  Takes and ignores
    the ssh options, so it can replace :func:`ssh_exec` as it is."""
    proc = subprocess.Popen(argv, stdin=subprocess.PIPE, text=True,
                            env=dict(os.environ))
    proc.stdin.write(secret_hex + "\n")
    proc.stdin.flush()
    proc.stdin.close()
    return proc


def remote_run(hosts: List[Tuple[str, int]], command: List[str], *,
               np_: Optional[int] = None,
               env: Optional[Dict[str, str]] = None,
               exec_fn: Optional[Callable[
                   [str, List[str], str], subprocess.Popen]] = None,
               nics: Optional[List[str]] = None,
               ssh_port: Optional[int] = None,
               ssh_identity_file: Optional[str] = None,
               start_timeout: float = 120.0,
               poll_interval_s: float = 0.5,
               verbose: bool = False) -> int:
    """Run ``command`` across ``hosts`` (``[(host, slots), ...]``)
    through the driver/task mesh; returns the first nonzero worker exit
    code (0 when every rank succeeds).

    Host i holds a block of consecutive ranks, in host order; ``np_``
    caps the world at the first N slots (``-np`` against a larger ``-H``).
    """
    if not command:
        raise ValueError("No command given")
    if not hosts:
        raise ValueError("No hosts given")

    total_slots = sum(s for _, s in hosts)
    if np_ is not None and np_ > total_slots:
        raise ValueError(
            f"-np {np_} exceeds total slots {total_slots} in -H")
    world_size = np_ or total_slots
    rank_blocks: List[List[int]] = []
    next_rank = 0
    for _, slots in hosts:
        take = max(0, min(slots, world_size - next_rank))
        rank_blocks.append(list(range(next_rank, next_rank + take)))
        next_rank += take
    groups = sum(1 for ranks in rank_blocks if ranks)

    if exec_fn is None:
        def exec_fn(host, argv, secret_hex):
            return ssh_exec(host, argv, secret_hex, ssh_port=ssh_port,
                            ssh_identity_file=ssh_identity_file)
    key = make_secret_key()
    driver = DriverService(len(hosts), key, nics=nics)
    agents: List[subprocess.Popen] = []
    clients: Dict[int, BasicClient] = {}
    exit_code = 0
    try:
        driver_addrs = driver.addresses()
        for i, (host, _) in enumerate(hosts):
            if verbose:
                print(f"[horovodtpurun-torch] starting agent {i} on {host}",
                      file=sys.stderr)
            # The agent's idle bound (registration to first command); a
            # running job is watched by the agent's driver pings.
            agents.append(exec_fn(
                host, _agent_argv(i, driver_addrs,
                                  timeout_s=start_timeout + 300.0,
                                  nics=nics),
                key.hex()))
        driver.wait_for_initial_registration(timeout_s=start_timeout)
        routes = probe_full_mesh(driver, key)
        if verbose:
            print(f"[horovodtpurun-torch] mesh verified: {len(routes)} "
                  f"routes", file=sys.stderr)

        addresses = driver.task_addresses()
        clients = {i: BasicClient(f"task-{i}", addrs, key)
                   for i, addrs in addresses.items()}

        # Rank 0's host at the address its peers proved they reach (the
        # driver's own route may differ on a host with several NICs); a
        # world of one host uses the driver's route.
        coord_port = driver.task_coordinator_ports()[0]
        if len(hosts) > 1:
            coord_host = routes[(1, 0)][0]
        else:
            coord_host = clients[0].address[0]
        coordinator = f"{coord_host}:{coord_port}"
        if verbose:
            print(f"[horovodtpurun-torch] coordinator {coordinator}, world "
                  f"{world_size}", file=sys.stderr)

        for i, ranks in enumerate(rank_blocks):
            if not ranks:
                continue
            # Not idempotent: a retried start whose first ACK was lost
            # would start the ranks twice.
            clients[i].request(RunDistributedCommandRequest(
                command, env or {}, ranks, world_size, coordinator,
                group_world_size=groups),
                idempotent=False, timeout=30.0)

        # The first nonzero exit ends the job; all zero on every agent
        # is success.
        pending = {i for i, ranks in enumerate(rank_blocks) if ranks}
        aborted = False

        def _abort_all() -> None:
            # One fan-out a job, to every agent still pending: one wedged
            # agent must not stop it reaching the others.
            nonlocal aborted
            if aborted:
                return
            aborted = True
            for j in sorted(pending):
                try:
                    clients[j].request(AbortCommandRequest(), timeout=30.0)
                except OSError:
                    pass

        while pending:
            for i in sorted(pending):
                try:
                    codes = clients[i].request(
                        DistributedExitCodesRequest(), timeout=30.0).codes
                except OSError as e:
                    # A dead agent's ranks can never report: fail the
                    # job and abort the others' ranks, which would block
                    # in collectives with the dead ones.
                    print(f"[horovodtpurun-torch] agent {i} unreachable "
                          f"({e}); treating its ranks as failed",
                          file=sys.stderr)
                    if exit_code == 0:
                        exit_code = 1
                    pending.discard(i)
                    _abort_all()
                    continue
                finished = {r: c for r, c in codes.items() if c is not None}
                bad = {r: c for r, c in finished.items() if c != 0}
                if bad:
                    if exit_code == 0:
                        rank, exit_code = sorted(bad.items())[0]
                        print(f"[horovodtpurun-torch] rank {rank} exited "
                              f"{exit_code}; terminating job",
                              file=sys.stderr)
                    _abort_all()
                if len(finished) == len(codes):
                    pending.discard(i)
            if pending:
                time.sleep(poll_interval_s)
    except (TimeoutError, ConnectionError) as e:
        print(f"[horovodtpurun-torch] {e}", file=sys.stderr)
        exit_code = 1
    finally:
        for client in clients.values():
            try:
                client.request(AgentShutdownRequest(), timeout=15.0)
            except OSError:
                pass
        for proc in agents:
            try:
                proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        driver.shutdown()
    return exit_code
