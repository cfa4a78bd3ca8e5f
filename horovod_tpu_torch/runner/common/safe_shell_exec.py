"""Safe subprocess execution for commands the launcher runs.

Counterpart of ``horovod_tpu/runner/common/safe_shell_exec.py``
(Horovod's ``runner/common/util/safe_shell_exec.py``): the command runs
in its own process group with its output streamed through the parent,
and the whole group dies (TERM, then KILL after a grace period) when the
command is cancelled, times out or the parent is interrupted, so no
worker outlives its job.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

GRACEFUL_TERMINATION_TIME_S = 5.0


def _forward(stream, sink, prefix: str = "") -> threading.Thread:
    def pump():
        for line in iter(stream.readline, b""):
            text = line.decode(errors="replace")
            sink.write(prefix + text if prefix else text)
            sink.flush()
        stream.close()

    t = threading.Thread(target=pump, daemon=True)
    t.start()
    return t


def terminate_process_group(proc: subprocess.Popen,
                            grace_s: float = GRACEFUL_TERMINATION_TIME_S) -> None:
    """TERM the whole group; KILL whatever survives the grace period."""
    try:
        pgid = os.getpgid(proc.pid)
    except ProcessLookupError:
        return
    try:
        os.killpg(pgid, signal.SIGTERM)
    except ProcessLookupError:
        return
    deadline = time.monotonic() + grace_s
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            break
        time.sleep(0.1)
    if proc.poll() is None:
        try:
            os.killpg(pgid, signal.SIGKILL)
        except ProcessLookupError:
            pass


def execute(command: List[str], *, env: Optional[Dict[str, str]] = None,
            stdout=None, stderr=None, prefix: str = "",
            timeout_s: Optional[float] = None,
            events: Optional[List[threading.Event]] = None) -> int:
    """Run ``command`` in a fresh process group, forwarding output.

    ``events``: optional cancellation events; when any is set the group
    is terminated (reference: the launch's shutdown event fanning out to
    every task's running command).  Returns the exit code (negative on
    signal death, matching subprocess semantics).
    """
    proc = subprocess.Popen(
        command, env=env, start_new_session=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    pumps = [
        _forward(proc.stdout, stdout or sys.stdout, prefix),
        _forward(proc.stderr, stderr or sys.stderr, prefix),
    ]
    deadline = (time.monotonic() + timeout_s) if timeout_s else None
    try:
        while proc.poll() is None:
            if events and any(e.is_set() for e in events):
                terminate_process_group(proc)
                break
            if deadline and time.monotonic() > deadline:
                terminate_process_group(proc)
                raise TimeoutError(
                    f"command timed out after {timeout_s}s: {command}")
            time.sleep(0.1)
    except KeyboardInterrupt:
        terminate_process_group(proc)
        raise
    finally:
        for p in pumps:
            p.join(timeout=2)
    return proc.wait()
