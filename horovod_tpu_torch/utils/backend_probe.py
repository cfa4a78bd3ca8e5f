"""Acquiring the card for a benchmark entry point, with outages bounded.

Counterpart of ``horovod_tpu/utils/backend_probe.py``.  Two failure
modes need two defences, on CUDA as on the reference's backend:

* **Hang**: CUDA's initialisation can block (a wedged driver, a card
  held by a dead process).  No retry inside the process helps, so the
  probe runs in a *subprocess* with a hard timeout.
* **Fail, then recover**: a failed lazy initialisation of CUDA stays
  failed for the life of the process, so even a clean error cannot be
  retried in place.  Recovery re-executes the script (``os.execv``) with
  an attempt counter once the probe says the card is back.

Both are bounded: after ``attempts`` failed probes the caller gets a
:class:`BackendUnavailableError` with the whole attempt log, which a
benchmark prints as ONE structured JSON line, so its output says why it
has no number instead of ending in a traceback.

The probe asks ``torch.cuda``: platform ``"gpu"`` (or ``"cpu"`` without
a card), ``torch.cuda.get_device_name(0)`` as ``device_kind`` and
``torch.cuda.device_count()``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import List, Optional

from .logging import get_logger

logger = get_logger(__name__)

_PROBE_SRC = (
    "import json, torch; ok = torch.cuda.is_available(); "
    "print(json.dumps({'platform': 'gpu' if ok else 'cpu', "
    "'device_kind': torch.cuda.get_device_name(0) if ok else 'cpu', "
    "'n_devices': torch.cuda.device_count() if ok else 1}))"
)

# The variable carrying the re-exec attempt count (see retry_via_exec).
_EXEC_ATTEMPT_ENV = "HVD_TPU_BENCH_EXEC_ATTEMPT"

# What CUDA and NCCL say when the card cannot be had (as opposed to a
# fault of the program): no card, a driver older than the runtime, a
# busy or unavailable device, NCCL's system error.
_UNAVAILABLE_MARKS = (
    "no cuda gpus are available",
    "found no nvidia driver",
    "cuda driver version is insufficient",
    "busy or unavailable",
    "cuda error: initialization error",
    "unhandled system error",
)


class BackendUnavailableError(RuntimeError):
    """The card never came up within the probe budget; ``attempts``
    holds one dict a probe (rc, elapsed, the output's tail)."""

    def __init__(self, attempts: List[dict]) -> None:
        super().__init__(
            f"backend unavailable after {len(attempts)} probe attempt(s)")
        self.attempts = attempts


def probe_once(timeout_s: float = 120.0) -> dict:
    """Ask ``torch.cuda`` in a subprocess with a hard timeout.

    Returns ``{"ok": True, "platform": ..., "device_kind": ...,
    "n_devices": N, "elapsed_s": t}`` on success, else ``{"ok": False,
    "rc": ..., "elapsed_s": t, "tail": the last 400 characters}`` (rc is
    None on a timeout).  The subprocess inherits the environment
    (``CUDA_VISIBLE_DEVICES`` applies to the probe too).
    """
    t0 = time.monotonic()
    try:
        proc = subprocess.run(
            [sys.executable, "-c", _PROBE_SRC],
            capture_output=True, text=True, timeout=timeout_s)
        elapsed = time.monotonic() - t0
        if proc.returncode == 0:
            try:
                info = json.loads(proc.stdout.strip().splitlines()[-1])
                info.update(ok=True, elapsed_s=round(elapsed, 1))
                return info
            except (ValueError, IndexError):
                pass
        return {"ok": False, "rc": proc.returncode,
                "elapsed_s": round(elapsed, 1),
                "tail": (proc.stderr or proc.stdout)[-400:]}
    except subprocess.TimeoutExpired:
        return {"ok": False, "rc": None,
                "elapsed_s": round(time.monotonic() - t0, 1),
                "tail": f"probe timed out after {timeout_s:.0f}s "
                        "(backend init hung)"}


def wait_for_backend(attempts: int = 5, backoff_s: float = 60.0,
                     probe_timeout_s: float = 120.0) -> dict:
    """Probe until the card answers, with a bounded linear backoff.

    Returns the successful probe's dict (platform, device_kind,
    n_devices) with the failed attempts under ``"probe_attempts"``.
    Raises :class:`BackendUnavailableError` after ``attempts`` failures.
    """
    log: List[dict] = []
    for i in range(attempts):
        info = probe_once(timeout_s=probe_timeout_s)
        if info.get("ok"):
            info["probe_attempts"] = log
            if log:
                logger.info("backend healthy after %d failed probe(s)",
                            len(log))
            return info
        info["attempt"] = i + 1
        log.append(info)
        logger.warning("backend probe %d/%d failed (%s); %s",
                       i + 1, attempts, info.get("tail", "")[-120:],
                       f"retrying in {backoff_s:.0f}s"
                       if i + 1 < attempts else "giving up")
        if i + 1 < attempts:
            time.sleep(backoff_s)
    raise BackendUnavailableError(log)


def exec_attempt() -> int:
    """How many times the running script has re-executed itself (0 on
    the first run)."""
    try:
        return int(os.environ.get(_EXEC_ATTEMPT_ENV, "0"))
    except ValueError:
        return 0


def retry_via_exec(max_execs: int = 2, backoff_s: float = 60.0) -> None:
    """Re-execute the running script to retry CUDA's initialisation.

    A failed lazy init stays failed in this process, so when
    ``hvd.init()`` fails after a healthy probe the only retry is a fresh
    process.  Bounded by ``max_execs``; returns (to the caller's except
    block) once they are spent.
    """
    n = exec_attempt()
    if n >= max_execs:
        return
    os.environ[_EXEC_ATTEMPT_ENV] = str(n + 1)
    logger.warning("in-process backend init failed after healthy probe; "
                   "re-exec attempt %d/%d in %.0fs", n + 1, max_execs,
                   backoff_s)
    time.sleep(backoff_s)
    sys.stdout.flush()
    sys.stderr.flush()
    # A script started as ``python -m pkg.mod`` has sys.argv[0] set to the
    # module's file; re-executing that loses the package (its relative
    # imports break), so re-execute with -m where __main__ records it.
    spec = getattr(sys.modules.get("__main__"), "__spec__", None)
    if spec is not None and spec.name:
        argv = [sys.executable, "-m", spec.name] + sys.argv[1:]
    else:
        argv = [sys.executable] + sys.argv
    os.execv(sys.executable, argv)


def is_backend_unavailable_error(exc: BaseException) -> bool:
    """True when ``exc`` reads as CUDA's or NCCL's failure to give a card
    (as opposed to a fault of the benchmark itself)."""
    text = f"{type(exc).__name__}: {exc}".lower()
    return any(mark in text for mark in _UNAVAILABLE_MARKS)


def emit_failure_line(metric: str, unit: str,
                      attempts: Optional[List[dict]] = None,
                      error: str = "gpu_backend_unavailable",
                      vs_baseline: Optional[float] = None) -> None:
    """Print the ONE structured JSON line of a benchmark whose card never
    came up: value 0.0, the error and the attempt log attached.
    ``vs_baseline`` is present only when the metric defines one, as on
    the success path."""
    line = {
        "metric": metric, "value": 0.0, "unit": unit,
        "error": error, "probe_attempts": attempts or [],
    }
    if vs_baseline is not None:
        line["vs_baseline"] = vs_baseline
    print(json.dumps(line))
    sys.stdout.flush()


def enable_compilation_cache(default_dir: Optional[str] = None) -> Optional[str]:
    """Point the kernels' build directory at a durable place.

    The reference points JAX's persistent compilation cache there; the
    port's counterpart is where nvcc and g++ put the libraries they
    build from the checkout's sources (``ops/_build.py``'s and
    ``native/build.py``'s ``BUILD_DIR``), so a process that runs again
    (a re-exec after :func:`retry_via_exec`) loads them instead of
    building them again.  Only the output moves: nothing is ever built
    from sources outside the checkout.

    Resolution order: ``HOROVOD_COMPILE_CACHE`` / ``HVD_TPU_COMPILE_CACHE``
    (a path; a false-y value or ``none`` leaves the default ``_build/``
    and returns None) > ``default_dir`` > the package's ``_build/``, else
    a user cache directory when that is not writable.  Must run before
    the first build; safe to call more than once.  Returns the directory,
    or None when disabled or none could be created (never fatal)."""
    from pathlib import Path

    from ..config import _FALSE, _env
    from ..native import build as native_build
    from ..ops import _build as kernel_build

    raw = _env("COMPILE_CACHE")
    raw = raw.strip() if raw is not None else None
    if raw is not None and raw.lower() in set(_FALSE) | {"none"}:
        return None
    if raw or default_dir:
        candidates = [raw or default_dir]
    else:
        candidates = [
            str(kernel_build.PACKAGE_DIR / "_build"),
            os.path.join(os.path.expanduser("~"), ".cache",
                         "horovod_tpu_torch", "build"),
        ]
    path = None
    for cand in candidates:
        try:
            os.makedirs(cand, exist_ok=True)
        except OSError:
            continue
        path = cand
        break
    if path is None:
        logger.warning("kernel build directory unavailable (no writable "
                       "dir among %s)", candidates)
        return None
    kernel_build.BUILD_DIR = native_build.BUILD_DIR = Path(path)
    logger.info("kernel build directory at %s", path)
    return path


def guarded_init(metric: str, unit: str, skip: bool = False,
                 attempts: int = 5, backoff_s: float = 60.0,
                 probe_timeout_s: float = 120.0,
                 init_timeout_s: float = 300.0,
                 vs_baseline_on_failure: Optional[float] = None) -> None:
    """The whole outage defence around ``hvd.init()``, for every
    benchmark entry point:

    1. bounded subprocess probes with backoff (a hang ends at the
       timeout);
    2. ``hvd.init()`` under a watchdog: a card lost between a healthy
       probe and init would otherwise hang the process with no output;
       the watchdog prints the failure line and exits hard;
    3. an unavailable card at init (a failed CUDA init stays failed in
       the process) re-executes the script, bounded;
    4. exhaustion always ends in ONE structured JSON failure line and
       **exit code 0**: the output says it measured an outage, and the
       exit code tells that apart from a benchmark crash.

    The probe budget can be set from the environment
    (``HVD_TPU_PROBE_ATTEMPTS`` / ``HVD_TPU_PROBE_RETRIES``,
    ``HVD_TPU_PROBE_BACKOFF_S`` / ``HVD_TPU_PROBE_BACKOFF``,
    ``HVD_TPU_PROBE_TIMEOUT_S``).

    ``skip=True`` (CPU smoke presets) runs a bare ``hvd.init()``; so does
    a process whose ``CUDA_VISIBLE_DEVICES`` hides every card, which can
    never acquire one (the reference's ``JAX_PLATFORMS=cpu`` pin).
    """
    import horovod_tpu_torch as hvd

    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None and visible.strip() in ("", "-1") and not skip:
        logger.info("CUDA_VISIBLE_DEVICES=%r hides every card: skipping "
                    "the probe budget", visible)
        skip = True
    if skip:
        hvd.init()
        return
    enable_compilation_cache()

    def _env(name, default, cast):
        # A malformed or empty value must not crash before the failure
        # line exists (the point of this module).
        try:
            return cast(os.environ[name])
        except (KeyError, ValueError):
            return default

    # _RETRIES/_BACKOFF are aliases of _ATTEMPTS/_BACKOFF_S (the
    # documented spellings win when both are set).
    attempts = _env("HVD_TPU_PROBE_ATTEMPTS",
                    _env("HVD_TPU_PROBE_RETRIES", attempts, int), int)
    backoff_s = _env("HVD_TPU_PROBE_BACKOFF_S",
                     _env("HVD_TPU_PROBE_BACKOFF", backoff_s, float), float)
    probe_timeout_s = _env("HVD_TPU_PROBE_TIMEOUT_S", probe_timeout_s, float)
    try:
        wait_for_backend(attempts=attempts, backoff_s=backoff_s,
                         probe_timeout_s=probe_timeout_s)
    except BackendUnavailableError as e:
        emit_failure_line(metric, unit, attempts=e.attempts,
                          vs_baseline=vs_baseline_on_failure)
        sys.exit(0)

    import threading

    def _watchdog() -> None:
        emit_failure_line(
            metric, unit,
            error=f"init_hang: hvd.init() exceeded {init_timeout_s:.0f}s "
                  "after a healthy probe",
            vs_baseline=vs_baseline_on_failure)
        os._exit(0)

    timer = threading.Timer(init_timeout_s, _watchdog)
    timer.daemon = True
    timer.start()
    try:
        hvd.init()
    except Exception as e:
        timer.cancel()
        if is_backend_unavailable_error(e):
            retry_via_exec(max_execs=2, backoff_s=backoff_s)  # no return
            emit_failure_line(metric, unit, error=f"init_failed: {e}",
                              vs_baseline=vs_baseline_on_failure)
            sys.exit(0)
        raise
    timer.cancel()
