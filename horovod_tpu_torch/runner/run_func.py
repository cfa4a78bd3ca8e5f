"""``hvd.run(func, ...)``: a Python function across a fresh world.

Counterpart of ``horovod_tpu/runner/run_func.py`` (Horovod's
``horovod.run``): ``func`` is pickled (``cloudpickle`` where it is
installed, so closures travel by value; else the standard ``pickle``,
which takes module-level functions only) into a work directory, each
rank of a new world loads and calls it, and the results come back in
rank order.

The world is the one the CLI builds: local workers
(:func:`horovod_tpu_torch.runner.run`), or the ssh-started agent mesh
(:func:`.remote.remote_run`) when ``hosts`` names another host.  The
payload and the results go through the work directory, so remote hosts
need ``workdir=`` on a shared filesystem.
"""

from __future__ import annotations

import os
import pickle
import shutil
import sys
import tempfile
from typing import Any, Dict, List, Optional, Tuple


def _serializer():
    try:
        import cloudpickle

        return cloudpickle
    except ImportError:  # the standard pickle: module-level functions only
        return pickle


def launch(func, args: Tuple = (), kwargs: Optional[Dict] = None, *,
           np: int = 1, hosts: Optional[str] = None,
           env: Optional[Dict[str, str]] = None,
           workdir: Optional[str] = None,
           start_timeout: float = 120.0,
           verbose: bool = False) -> List[Any]:
    """Run ``func(*args, **kwargs)`` on every rank of a fresh ``np``-
    process world; returns the ranks' results in rank order.  ``func``
    calls ``hvd.init()`` itself (so it can pick its device and backend).
    ``hosts`` takes the ``-H`` syntax; remote hosts start through the
    agent mesh and need a ``workdir`` every host sees (the default
    temporary directory is this host's).  A directory this call created
    is removed on return; an explicit ``workdir`` is left in place."""
    from . import run as run_cmd
    from .remote import is_local_host, parse_hosts, remote_run

    own_workdir = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="hvd_tpu_torch_run_")
    try:
        payload = os.path.join(workdir, "payload.pkl")
        with open(payload, "wb") as f:
            _serializer().dump((func, tuple(args), dict(kwargs or {})), f)

        command = [sys.executable, "-m", "horovod_tpu_torch.runner.run_func",
                   payload, workdir]
        base_env = dict(env or {})
        # The workers resolve this package (and the caller's modules) as
        # the launching process does.
        base_env.setdefault(
            "PYTHONPATH",
            os.pathsep.join(p for p in ([os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__))))]
                + sys.path[:1] + [os.environ.get("PYTHONPATH", "")]) if p))

        host_list = parse_hosts(hosts) if hosts else None
        if host_list and any(not is_local_host(h) for h, _ in host_list):
            if own_workdir:
                from ..utils.logging import get_logger

                get_logger(__name__).warning(
                    "hvd.run with remote hosts but no workdir=: the "
                    "default temporary directory is this host's; remote "
                    "workers need one on a shared filesystem")
            rc = remote_run(host_list, command, np_=np, env=base_env,
                            start_timeout=start_timeout, verbose=verbose)
        else:
            if host_list:
                total = sum(s for _, s in host_list)
                if np > total:
                    raise ValueError(
                        f"np={np} exceeds the {total} declared slot(s)")
            rc = run_cmd(np, command, env=base_env,
                         start_timeout=start_timeout, verbose=verbose)
        if rc != 0:
            raise RuntimeError(f"worker world exited with rc={rc}")

        results: List[Any] = []
        for rank in range(np):
            path = os.path.join(workdir, f"result_{rank}.pkl")
            if not os.path.exists(path):
                raise RuntimeError(
                    f"rank {rank} produced no result file (remote hosts "
                    "need a workdir= on a shared filesystem)")
            with open(path, "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        if own_workdir:
            shutil.rmtree(workdir, ignore_errors=True)


def _worker_main(payload_path: str, workdir: str) -> int:
    """One rank: load the payload, call it, write the result.

    ``func`` initialises the session itself, so the rank for the result
    file comes from the launcher's ``RANK``, set before any init.  After
    the result is written, an initialised session waits for every rank
    (``barrier``) and shuts down, so that no rank leaves while its peers
    are still inside a collective."""
    with open(payload_path, "rb") as f:
        func, args, kwargs = _serializer().load(f)

    rank = int(os.environ.get("RANK", "0"))
    result = func(*args, **kwargs)
    tmp = os.path.join(workdir, f".result_{rank}.tmp")
    with open(tmp, "wb") as f:
        _serializer().dump(result, f)
    os.replace(tmp, os.path.join(workdir, f"result_{rank}.pkl"))

    import horovod_tpu_torch as hvd

    if hvd.is_initialized():
        hvd.barrier()
        hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(_worker_main(sys.argv[1], sys.argv[2]))
