"""Build the CUDA sources under ``csrc/`` with nvcc and load them.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, ``_build/lib<name>-<hash>.so``, loaded through ``ctypes``.
The hash covers the source, the shared headers (``csrc/*.cuh``) and the
flags, so a changed source or header rebuilds and an unchanged one is
loaded as it is.  :func:`build` starts one nvcc
for each missing library, all at once, and waits for them all.

A build that fails raises with nvcc's own error output: there is no
fallback to the kernels' plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("int8_kernels", "flash_attention", "flash_attention_bwd",
           "fused_apply", "matmul")

# No --use_fast_math: the int8 and apply kernels must round as the
# reference does.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else
    nvcc on ``PATH``; raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME); the port's kernels are built "
        "from horovod_tpu_torch/csrc at first use")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu``'s library lives.  The hash covers the
    source, every ``csrc/*.cuh`` header it could include and the flags, so
    a changed header rebuilds every library."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> Dict[str, Path]:
    """Build every library of ``names`` that is not built yet, one nvcc
    each, all started together; returns ``{name: library path}``."""
    paths = {name: library_path(name) for name in names}
    missing = [n for n, p in paths.items() if not p.exists()]
    if not missing:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs: List = []
    for name in missing:
        tmp = paths[name].parent / f"{paths[name].name}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failures = []
    for name, tmp, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed on csrc/{name}.cu "
                            f"(exit {proc.returncode}):\n{out}{err}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[name])
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed, with
    ``argtypes`` set from ``signatures`` (``{function: argtypes}``) and
    every listed function returning a C ``int``."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build((name,))[name]))
            for fn_name, argtypes in signatures.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _loaded[name] = lib
        return lib
