"""Starting a run's ranks and waiting for them.

A one-chip cell runs in this process.  A cell on several chips starts one
process a chip (``python -m portbench.core.rank``), each with torchrun's
variables and a free loopback port, builds the kernels once before them,
and waits for all; if one fails, the others are ended.  Traces go to a
scratch directory under ``TMPDIR``; rank 0 prints the result.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

RANK_TIMEOUT_S = 330


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def build_kernels(root: Path) -> None:
    """The port's CUDA libraries, built once before the ranks start
    (``horovod_tpu_torch/ops/_build.py``, loaded alone: it needs only the
    standard library)."""
    path = root / "horovod_tpu_torch" / "ops" / "_build.py"
    spec = importlib.util.spec_from_file_location("portbench_port_build", path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.build()


def run(spec: dict, chips: int) -> int:
    """Run ``spec`` (what every rank gets, see ``rank.py``) on ``chips``
    ranks; returns the exit code."""
    from . import rank as rank_mod

    scratch = tempfile.mkdtemp(prefix="portbench-")
    spec = dict(spec, scratch=scratch, world=chips)
    try:
        if chips == 1:
            return rank_mod.rank_main(dict(spec, rank=0))
        if spec["device"] == "cuda":
            build_kernels(Path(spec["root"]))
        return _spawn(spec, chips)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


def _spawn(spec: dict, world: int) -> int:
    port = free_port()
    root = spec["root"]
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=os.pathsep.join(
                       [root] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p]))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "portbench.core.rank",
             json.dumps(dict(spec, rank=r))], env=env, cwd=root))
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        while (any(p.poll() is None for p in procs)
               and not any(p.returncode for p in procs)
               and time.monotonic() < deadline):
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        print(f"portbench: rank exit codes {codes}", file=sys.stderr)
        return 1
    return 0
