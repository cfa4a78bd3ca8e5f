"""The TF-XLA adapter: Horovod collectives inside
``tf.function(jit_compile=True)``.

Counterpart of ``horovod_tpu/tensorflow/xla_ops.py`` (Horovod's
``horovod/tensorflow/xla_mpi_ops.cc``).  One custom TF op,
``HvdTpuTorchAllreduce`` (``native/src/tf_xla_ops.cc``), has a plain CPU
kernel and an XLA kernel that lowers to a host CustomCall registered in
TF's own XLA runtime.  Both kernels call back into Python and run the
closure :func:`allreduce` keyed into a trace-time table: the binding's
tf → torch bridge onto the port's collectives, on the session's device,
back through a host copy.  The opaque payload carries only ``(key,
dtype, dims)``.  Scope, as the reference's: dense allreduce.

The library builds as the port's ``native/build.py`` builds the control
plane: g++ against ``tf.sysconfig``'s flags and headers, into
``horovod_tpu_torch/_build/libhvdtpu_torch_tf_xla-<hash>.so``, keyed by
a hash of the source and the flags (not by mtime), under a file lock
with an atomic rename, so processes that import at once never load a
half-written library.  A failed build leaves ``available()`` False and
the compiler's error in ``load_error()``; the bindings' collectives then
take the ``tf.py_function`` route, which XLA cannot compile.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import itertools
import os
import subprocess
import sysconfig
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..utils.logging import get_logger

logger = get_logger(__name__)

SRC = Path(__file__).resolve().parents[1] / "native" / "src" / "tf_xla_ops.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O2", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None          # guarded-by: _lock (tf.load_op_library module)
_load_error: Optional[str] = None   # guarded-by: _lock

# Trace-time closure table: key -> fn(np_in) -> np_out.  A key is taken
# per op emission and lives as long as the process (graphs that re-trace
# take fresh keys).
_table: Dict[int, Callable[[np.ndarray], np.ndarray]] = {}
_keys = itertools.count()

# TF DataType enum value -> numpy dtype (the stable proto values;
# bfloat16 through ml_dtypes).
_DT_TO_NP: Dict[int, np.dtype] = {}


def _dt_map() -> Dict[int, np.dtype]:
    if _DT_TO_NP:
        return _DT_TO_NP
    import ml_dtypes

    _DT_TO_NP.update({
        1: np.dtype(np.float32),
        2: np.dtype(np.float64),
        3: np.dtype(np.int32),
        9: np.dtype(np.int64),
        14: np.dtype(ml_dtypes.bfloat16),
        19: np.dtype(np.float16),
    })
    return _DT_TO_NP


def _trampoline(key: int, dtype_enum: int, dims: Tuple[int, ...],
                in_ptr: int, out_ptr: int) -> None:
    """Called from the C++ kernels with the GIL held: run the table's
    closure on a copy of the input buffer and write its result into the
    output buffer."""
    fn = _table[key]
    dt = _dt_map()[dtype_enum]
    n = int(np.prod(dims)) if dims else 1
    nbytes = n * dt.itemsize
    in_buf = (ctypes.c_char * nbytes).from_address(in_ptr)
    x = np.frombuffer(in_buf, dtype=dt, count=n).reshape(dims).copy()
    out = np.ascontiguousarray(np.asarray(fn(x), dtype=dt)).reshape(dims)
    out_buf = (ctypes.c_char * nbytes).from_address(out_ptr)
    out_buf[:] = out.tobytes()


def _command(tf, out: Path) -> List[str]:
    tf_inc = tf.sysconfig.get_include()
    return (["g++", *CXX_FLAGS, str(SRC), "-o", str(out),
             f"-I{sysconfig.get_paths()['include']}",
             # Bazel-vendored third-party headers that TF's public headers
             # include resolve under include/external/*.
             f"-I{os.path.join(tf_inc, 'external', 'highwayhash')}",
             f"-I{os.path.join(tf_inc, 'external', 'com_google_highway')}",
             f"-I{os.path.join(tf_inc, 'external', 'farmhash_archive', 'src')}"]
            + tf.sysconfig.get_compile_flags()
            + tf.sysconfig.get_link_flags()
            + ["-l:libtensorflow_cc.so.2"])


def library_path(tf) -> Path:
    """Where the library for the source and flags as they stand lives."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update("\0".join(_command(tf, Path("out"))).encode())
    return BUILD_DIR / f"libhvdtpu_torch_tf_xla-{h.hexdigest()[:16]}.so"


def _build(tf) -> Path:
    path = library_path(tf)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libhvdtpu_torch_tf_xla.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():   # another process built it while we waited
            return path
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        try:
            proc = subprocess.run(_command(tf, tmp), capture_output=True,
                                  text=True, timeout=600)
        except BaseException:
            tmp.unlink(missing_ok=True)
            raise
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"tf_xla_ops build failed: {proc.stderr[-800:]}")
        os.replace(tmp, path)
    return path


def _ensure_loaded() -> None:
    global _lib, _load_error
    with _lock:
        if _lib is not None or _load_error is not None:
            return
        try:
            import tensorflow as tf

            so = _build(tf)
            _lib = tf.load_op_library(str(so))
            cdll = ctypes.CDLL(str(so))
            cdll.HvdTpuTorchTfXlaSetCallback.argtypes = [ctypes.py_object]
            cdll.HvdTpuTorchTfXlaSetCallback.restype = None
            cdll.HvdTpuTorchTfXlaSetCallback(_trampoline)
            logger.info("TF-XLA adapter loaded (%s)", so.name)
        except Exception as e:  # the py_function route stays
            _lib = None
            _load_error = f"{type(e).__name__}: {e}"
            logger.info("TF-XLA adapter unavailable: %s", _load_error)


def preload() -> None:
    """Load the adapter now.  Called when ``horovod_tpu_torch.tensorflow``
    is imported: TF freezes its XLA kernel registry at the first XLA
    compile of the process, and an op registered after that is never
    visible to ``jit_compile=True``."""
    _ensure_loaded()


def available() -> bool:
    _ensure_loaded()
    return _lib is not None


def load_error() -> Optional[str]:
    _ensure_loaded()
    return _load_error


def supported_dtype(tf_dtype) -> bool:
    import tensorflow as tf

    return tf_dtype in (tf.float32, tf.float64, tf.int32, tf.int64,
                        tf.bfloat16, tf.float16)


def allreduce(tensor, fn: Callable[[np.ndarray], np.ndarray], name: str):
    """Emit the adapter's op running ``fn(np_in) -> np_out`` on the host
    value of ``tensor`` (the op, process set, scales and wire baked in).
    Works eagerly, in graphs and under ``jit_compile=True``."""
    _ensure_loaded()
    if _lib is None:
        raise RuntimeError(f"TF-XLA adapter unavailable: {_load_error}")
    key = next(_keys)
    _table[key] = fn
    return _lib.hvd_tpu_torch_allreduce(tensor=tensor, table_key=key)
