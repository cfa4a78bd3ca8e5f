"""Build the native control-plane library with g++.

Counterpart of ``horovod_tpu/native/build.py``.  The library has a plain
C ABI and no third-party dependency, so the build is one ``g++ -O2
-std=c++14 -shared -fPIC ... -lpthread`` over ``src/*.cc``, run at first
use into ``horovod_tpu_torch/_build/libhvdtpu_native-<hash>.so``.

The hash covers every source, every header and the flags (as
``ops/_build.py`` keys the CUDA libraries), not the files' mtimes: a
checkout that touches nothing rebuilds nothing, and an edited header
always rebuilds.  g++ writes a temporary name that ``os.replace`` puts
in place under a file lock, so several processes that build at once
(test workers, the ranks of a job) never load a half-written library.

``python -m horovod_tpu_torch.native.build`` builds it and prints the
path.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional

from ..utils.logging import get_logger

logger = get_logger(__name__)

SRC_DIR = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O2", "-std=c++14", "-shared", "-fPIC")

# The last failed build's compiler output (``--check-build`` prints it).
last_error: Optional[str] = None


# The TF-XLA adapter builds against TensorFlow's headers, by its own
# build (``tensorflow/xla_ops.py``), and is no part of this library.
ADAPTER_SOURCES = ("tf_xla_ops.cc",)


def sources() -> List[Path]:
    return sorted(p for p in SRC_DIR.glob("*.cc")
                  if p.name not in ADAPTER_SOURCES)


def library_path() -> Path:
    """Where the library for the sources as they stand lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for path in sources() + sorted(SRC_DIR.glob("*.h")):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"libhvdtpu_native-{h.hexdigest()[:16]}.so"


def build() -> Optional[Path]:
    """The library's path, compiled first if it is not there; None when
    g++ is missing or fails (logged as a warning with the compiler's
    error)."""
    global last_error
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libhvdtpu_native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():   # another process built it while we waited
            return path
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = ["g++", *CXX_FLAGS, *map(str, sources()), "-o", str(tmp),
               "-lpthread"]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True,
                           timeout=300)
        except (subprocess.SubprocessError, OSError) as e:
            tmp.unlink(missing_ok=True)
            last_error = f"{e}\n{getattr(e, 'stderr', '') or ''}".strip()
            logger.warning("native runtime build failed (%s); the Python "
                           "fallbacks are active", last_error[:2000])
            return None
        os.replace(tmp, path)
    return path


if __name__ == "__main__":
    built = build()
    print(built or f"BUILD FAILED\n{last_error}")
    raise SystemExit(0 if built else 1)
