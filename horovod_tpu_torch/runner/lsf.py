"""The LSF launch through ``jsrun``.

Counterpart of ``horovod_tpu/runner/lsf.py`` (Horovod's
``runner/util/lsf.py`` and ``runner/js_run.py``).  Inside an LSF
allocation (``LSB_JOBID``) the launcher reads the compute hosts and
their slots from ``LSB_DJOB_HOSTFILE`` or ``LSB_MCPU_HOSTS`` and starts
one task a slot through ``jsrun`` instead of ssh.

jsrun places the tasks; the rendezvous is torchrun's: rank 0's host (the
allocation's first compute host) serves the store on a fixed port
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` go out through jsrun's
``-E``), and each task takes its rank from the scheduler's own variable
(``PMIX_RANK``, ``OMPI_COMM_WORLD_RANK`` or ``SLURM_PROCID``, read by
``basics.init``).  One card a resource set (``--gpu_per_rs 1``), so a
task's card is ``cuda:0``.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from collections import OrderedDict
from typing import Dict, List, Optional

DEFAULT_PORT = 29500


def in_lsf() -> bool:
    """True inside an LSF allocation (reference: ``lsf.check_lsf``)."""
    return "LSB_JOBID" in os.environ


def lsf_hosts() -> "OrderedDict[str, int]":
    """Ordered ``{host: slots}`` of the allocation's compute hosts.

    ``LSB_DJOB_HOSTFILE`` lists one line a slot, the batch (launch) host
    first, which is left out as the reference leaves it out;
    ``LSB_MCPU_HOSTS`` is the ``host1 n1 host2 n2 ...`` fallback.
    """
    hostfile = os.environ.get("LSB_DJOB_HOSTFILE")
    if hostfile and os.path.exists(hostfile):
        counts: "OrderedDict[str, int]" = OrderedDict()
        with open(hostfile) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        for host in lines[1:] or lines:   # the first line: the batch host
            counts[host] = counts.get(host, 0) + 1
        if counts:
            return counts
    parts = os.environ.get("LSB_MCPU_HOSTS", "").split()
    if parts and len(parts) % 2 == 0:
        counts = OrderedDict()
        # The first pair is the batch host, left out unless it is alone.
        pairs = list(zip(parts[::2], parts[1::2]))
        for host, n in pairs[1:] or pairs:
            counts[host] = counts.get(host, 0) + int(n)
        return counts
    raise RuntimeError(
        "not inside a recognizable LSF allocation (no LSB_DJOB_HOSTFILE "
        "or LSB_MCPU_HOSTS)")


def world_size() -> int:
    return sum(lsf_hosts().values())


def jsrun_command(command: List[str], np_: int,
                  coordinator: str) -> List[str]:
    """The jsrun invocation: one task a resource set of one CPU and one
    card, the rendezvous variables exported to every task."""
    jsrun = shutil.which("jsrun") or "jsrun"
    host, _, port = coordinator.rpartition(":")
    return [
        jsrun,
        "--np", str(np_),
        "--tasks_per_rs", "1", "--cpu_per_rs", "1", "--gpu_per_rs", "1",
        "-E", f"MASTER_ADDR={host}",
        "-E", f"MASTER_PORT={port}",
        "-E", f"WORLD_SIZE={np_}",
    ] + list(command)


def run_lsf(command: List[str], np_: Optional[int] = None, *,
            port: int = DEFAULT_PORT,
            env: Optional[Dict[str, str]] = None,
            verbose: bool = False) -> int:
    """Run ``command`` across the LSF allocation through jsrun; returns
    jsrun's exit code (2 when jsrun is not on ``PATH``)."""
    hosts = lsf_hosts()
    if np_ is None or np_ <= 0:
        np_ = sum(hosts.values())
    first_host = next(iter(hosts))
    cmd = jsrun_command(command, np_, f"{first_host}:{port}")
    if verbose:
        print(f"[horovodtpurun-torch] LSF allocation {dict(hosts)}; "
              f"exec: {' '.join(cmd)}", file=sys.stderr)
    if shutil.which("jsrun") is None:
        print("error: LSF allocation detected but `jsrun` is not on PATH; "
              "load the job-step manager module or launch with "
              "`python -m horovod_tpu_torch.runner -np N` on each host",
              file=sys.stderr)
        return 2
    run_env = dict(os.environ)
    if env:
        run_env.update(env)
    return subprocess.call(cmd, env=run_env)
