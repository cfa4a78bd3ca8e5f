"""A host's task agent for the multi-host launch.

Counterpart of ``horovod_tpu/runner/task_agent.py`` (Horovod's
``runner/task_fn.py``): the module the launcher starts on every target
host over ssh.  It serves a :class:`TaskService`, registers with the
driver (with the rendezvous port it reserved on this host), answers the
driver's probes, starts the worker command on request and reports exit
codes.

The launch's HMAC key arrives on **stdin** (one hex line), never on
argv: command lines are world-readable through ``/proc``.

While no command has arrived the agent waits at most ``--timeout``
seconds.  Once one runs, the agent pings the driver every
``HVD_TPU_AGENT_PING_INTERVAL`` seconds (jittered by a quarter, from a
generator seeded with ``--index``); after ``HVD_TPU_AGENT_MAX_MISSED``
missed pings in a row the launcher is gone, and the agent aborts its
workers.

Usage (what the launcher runs on each host)::

    python -m horovod_tpu_torch.runner.task_agent \\
        --driver ip:port[,ip:port...] --index N [--nics eth0] [--timeout S]
"""

from __future__ import annotations

import argparse
import random
import sys
import time
from typing import List, Optional, Tuple

from ..config import Config
from ..utils.retry import jittered
from .common.network import BasicClient, resolvable_hostname
from .common.service import RegisterTaskRequest, TaskService


def parse_addresses(spec: str) -> List[Tuple[str, int]]:
    out = []
    for part in spec.split(","):
        host, _, port = part.rpartition(":")
        out.append((host, int(port)))
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="horovod_tpu_torch.runner.task_agent")
    ap.add_argument("--driver", required=True,
                    help="driver service address(es), ip:port[,ip:port...]")
    ap.add_argument("--index", type=int, required=True)
    ap.add_argument("--nics", default=None,
                    help="comma-separated interfaces to advertise (the "
                         "launcher's --network-interfaces)")
    ap.add_argument("--timeout", type=float, default=3600.0,
                    help="exit with an error if no command arrives within "
                         "this many seconds (a running job is watched by "
                         "the driver pings, not by a clock)")
    args = ap.parse_args(argv)

    key = bytes.fromhex(sys.stdin.readline().strip())
    nics = ([n.strip() for n in args.nics.split(",") if n.strip()]
            if args.nics else None)
    service = TaskService(args.index, key, nics=nics)
    try:
        driver = BasicClient("driver", parse_addresses(args.driver), key)
        driver.request(RegisterTaskRequest(
            args.index, service.addresses(), resolvable_hostname(),
            coordinator_port=service.reserve_coordinator_port()),
            timeout=60.0)
        # Serve (probes, run-command, exit-code polls run on the service's
        # threads) until the driver says the job is done.  Two ways out
        # keep a dead driver from leaking agents or workers: the idle
        # bound before any command, and the liveness pings once one runs.
        from .. import basics

        cfg = (basics.config() if basics.is_initialized()
               else Config.from_env())
        ping_interval = cfg.agent_ping_interval_seconds
        max_missed = cfg.agent_max_missed_pings
        rng = random.Random(args.index)  # each agent's own spread
        idle_deadline = time.monotonic() + args.timeout
        missed_pings = 0
        wait_s = jittered(ping_interval, 0.25, rng)
        while not service.shutdown_requested.wait(timeout=wait_s):
            wait_s = jittered(ping_interval, 0.25, rng)
            if not service.command_started:
                if time.monotonic() > idle_deadline:
                    print(f"task-{args.index}: no command within "
                          f"{args.timeout:.0f}s", file=sys.stderr)
                    return 1
                continue
            try:
                driver.ping()
                missed_pings = 0
            except OSError:
                missed_pings += 1
                if missed_pings >= max_missed:
                    print(f"task-{args.index}: driver unreachable "
                          f"({missed_pings} missed pings; interval "
                          f"{ping_interval:.0f}s); aborting workers",
                          file=sys.stderr)
                    service.abort_command()
                    return 1
                # Ask again sooner (jittered) while the doubt lasts.
                wait_s = jittered(
                    min(ping_interval, 1.0 * 2 ** (missed_pings - 1)),
                    0.5, rng)
        return 0
    finally:
        service.shutdown()


if __name__ == "__main__":
    sys.exit(main())
