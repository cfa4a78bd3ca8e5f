"""Python wrappers over the native control-plane runtime.

Counterpart of ``horovod_tpu/native/runtime.py``, class for class:

* :class:`Controller` — rank-0 consensus, fusion, response cache and
  group table (Horovod's ``controller.cc``, ``response_cache.cc``,
  ``group_table.cc``).
* :class:`Coordinator` — the TCP negotiation service that carries the
  controller protocol between processes.
* :class:`NativeTensorQueue` — the framework-thread to cycle-thread
  handoff (``tensor_queue.cc``).
* :class:`NativeStallInspector` — per-tensor some-but-not-all-ranks
  stall tracking (``stall_inspector.cc``).
* :class:`NativeTimeline` — the background-thread Chrome-trace writer
  (``timeline.cc``).
* the wire codec — the Request/Response wire format in Python, byte for
  byte the C++ codec's and the reference's (``WIRE_VERSION`` 1; the
  ``hvd_wire_*_roundtrip`` hooks prove the C++ side).

Requests carry dtype names; :data:`DTYPE_CODES` maps torch's names
(``str(torch.bfloat16)`` without ``torch.``) to the reference's
integers.  Every wrapper raises :class:`NativeUnavailableError`
when the library failed to build; callers gate on :func:`available`.
"""

from __future__ import annotations

import ctypes
import json
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from . import bindings

# --- enums (must match src/common.h) ----------------------------------------

# torch's dtype names (``str(torch.float32)`` without ``torch.``), mapped
# to the reference's integers.
DTYPE_CODES: Dict[str, int] = {
    "uint8": 0, "int8": 1, "uint16": 2, "int16": 3, "int32": 4,
    "int64": 5, "float16": 6, "float32": 7, "float64": 8, "bool": 9,
    "bfloat16": 10,
}

OP_CODES: Dict[str, int] = {
    "allreduce": 0, "allgather": 1, "broadcast": 2, "alltoall": 3,
    "reducescatter": 4, "adasum": 5, "barrier": 6, "join": 7,
}
_OP_NAMES = {v: k for k, v in OP_CODES.items()}
_DTYPE_NAMES = {v: k for k, v in DTYPE_CODES.items()}

WIRE_VERSION = 1


class NativeUnavailableError(RuntimeError):
    def __init__(self) -> None:
        super().__init__(
            "the native runtime library is unavailable (build failed or "
            "g++ missing); use the Python paths"
        )


def available() -> bool:
    return bindings.available()


def _lib():
    lib = bindings.load()
    if lib is None:
        raise NativeUnavailableError()
    return lib


# --- message types + wire codec ---------------------------------------------

@dataclass(frozen=True)
class Request:
    """One rank's declaration that one tensor is ready (reference:
    ``Request`` in ``horovod/common/message.h``)."""
    rank: int
    name: str
    op: str = "allreduce"
    dtype: str = "float32"
    size_bytes: int = 0
    root_rank: int = -1
    group_id: int = -1


@dataclass(frozen=True)
class Response:
    """A fused-collective decision (reference: ``Response``)."""
    op: str
    dtype: str
    total_bytes: int
    root_rank: int
    names: Tuple[str, ...] = field(default_factory=tuple)


def encode_requests(reqs: Sequence[Request]) -> bytes:
    out = [struct.pack("<BI", WIRE_VERSION, len(reqs))]
    for r in reqs:
        name = r.name.encode()[:0xFFFF]
        out.append(struct.pack(
            "<ibbqiiH", r.rank, OP_CODES[r.op], DTYPE_CODES[r.dtype],
            r.size_bytes, r.root_rank, r.group_id, len(name)))
        out.append(name)
    return b"".join(out)


def decode_requests(data: bytes) -> List[Request]:
    version, count = struct.unpack_from("<BI", data, 0)
    if version != WIRE_VERSION:
        raise ValueError(f"bad wire version {version}")
    pos = 5
    reqs = []
    for _ in range(count):
        rank, op, dtype, size, root, group, nlen = struct.unpack_from(
            "<ibbqiiH", data, pos)
        pos += struct.calcsize("<ibbqiiH")
        name = data[pos:pos + nlen].decode()
        pos += nlen
        reqs.append(Request(rank=rank, name=name, op=_OP_NAMES[op],
                            dtype=_DTYPE_NAMES[dtype], size_bytes=size,
                            root_rank=root, group_id=group))
    if pos != len(data):
        raise ValueError("trailing bytes in request list")
    return reqs


def encode_responses(resps: Sequence[Response]) -> bytes:
    out = [struct.pack("<BI", WIRE_VERSION, len(resps))]
    for r in resps:
        out.append(struct.pack("<bbqiI", OP_CODES[r.op],
                               DTYPE_CODES[r.dtype], r.total_bytes,
                               r.root_rank, len(r.names)))
        for n in r.names:
            nb = n.encode()[:0xFFFF]
            out.append(struct.pack("<H", len(nb)))
            out.append(nb)
    return b"".join(out)


def decode_responses(data: bytes) -> List[Response]:
    version, count = struct.unpack_from("<BI", data, 0)
    if version != WIRE_VERSION:
        raise ValueError(f"bad wire version {version}")
    pos = 5
    resps = []
    for _ in range(count):
        op, dtype, total, root, n_names = struct.unpack_from(
            "<bbqiI", data, pos)
        pos += struct.calcsize("<bbqiI")
        names = []
        for _ in range(n_names):
            (nlen,) = struct.unpack_from("<H", data, pos)
            pos += 2
            names.append(data[pos:pos + nlen].decode())
            pos += nlen
        resps.append(Response(op=_OP_NAMES[op], dtype=_DTYPE_NAMES[dtype],
                              total_bytes=total, root_rank=root,
                              names=tuple(names)))
    if pos != len(data):
        raise ValueError("trailing bytes in response list")
    return resps


# --- buffer helper ----------------------------------------------------------

def _call_filling(fn, *args, initial_cap: int = 1 << 16) -> bytes:
    """Calls a fill-style C function (returns bytes written or -needed),
    growing the buffer on demand."""
    cap = initial_cap
    for _ in range(4):
        buf = (ctypes.c_uint8 * cap)()
        n = fn(*args, buf, cap)
        if n >= 0:
            return bytes(buf[:n])
        cap = -n
    raise RuntimeError("native buffer negotiation failed")


def _call_filling_str(fn, *args, initial_cap: int = 1 << 14) -> str:
    cap = initial_cap
    for _ in range(4):
        buf = ctypes.create_string_buffer(cap)
        n = fn(*args, buf, cap)
        if n >= 0:
            return buf.value.decode()
        cap = -n
    raise RuntimeError("native buffer negotiation failed")


# --- controller -------------------------------------------------------------

class Controller:
    """In-process consensus/fusion engine (rank 0 of a coordinator owns
    one; also usable stand-alone for tests and single-process planning)."""

    def __init__(self, world_size: int, fusion_threshold: int,
                 cache_capacity: int = 1024) -> None:
        self._lib = _lib()
        self._h = self._lib.hvd_ctrl_create(world_size, fusion_threshold,
                                            cache_capacity)
        if not self._h:
            raise ValueError("invalid controller parameters")
        self.world_size = world_size

    def submit(self, req: Request) -> None:
        ok = self._lib.hvd_ctrl_submit(
            self._h, req.rank, req.name.encode(), OP_CODES[req.op],
            DTYPE_CODES[req.dtype], req.size_bytes, req.root_rank,
            req.group_id)
        if not ok:
            raise ValueError(self.last_error() or "submit failed")

    def compute_response_list(self) -> List[Response]:
        data = _call_filling(self._lib.hvd_ctrl_compute, self._h)
        return decode_responses(data)

    def register_group(self, names: Sequence[str]) -> int:
        arr = (ctypes.c_char_p * len(names))(*[n.encode() for n in names])
        return self._lib.hvd_ctrl_register_group(self._h, arr, len(names))

    def cache_stats(self) -> Tuple[int, int]:
        return (self._lib.hvd_ctrl_cache_hits(self._h),
                self._lib.hvd_ctrl_cache_misses(self._h))

    def pending_partial(self) -> List[Tuple[str, List[int]]]:
        text = _call_filling_str(self._lib.hvd_ctrl_pending_partial, self._h)
        return [(name, missing) for name, missing in json.loads(text)]

    def last_error(self) -> str:
        return _call_filling_str(self._lib.hvd_ctrl_last_error, self._h)

    def close(self) -> None:
        if self._h:
            self._lib.hvd_ctrl_destroy(self._h)
            self._h = None

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass


class NativeTensorQueue:
    """Thread-safe pending-request queue (reference:
    ``horovod/common/tensor_queue.cc`` — the framework-thread →
    background-thread handoff).  Producers :meth:`push` from the eager
    API threads; the monitor/coordinator cycle :meth:`drain`\\ s."""

    def __init__(self) -> None:
        self._lib = _lib()
        self._h = self._lib.hvd_queue_create()
        if not self._h:
            raise RuntimeError("tensor queue allocation failed")

    def push(self, req: Request) -> None:
        ok = self._lib.hvd_queue_push(
            self._h, req.rank, req.name.encode(), OP_CODES[req.op],
            DTYPE_CODES[req.dtype], req.size_bytes, req.root_rank,
            req.group_id)
        if not ok:
            raise ValueError("queue push failed")

    def size(self) -> int:
        return self._lib.hvd_queue_size(self._h)

    def drain(self) -> List[Request]:
        data = _call_filling(self._lib.hvd_queue_drain, self._h)
        return decode_requests(data)

    def close(self) -> None:
        if self._h:
            self._lib.hvd_queue_destroy(self._h)
            self._h = None

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass


# --- coordinator ------------------------------------------------------------

class Coordinator:
    """TCP negotiation service client/server (rank 0 = server).

    Collective contract: every member calls :meth:`negotiate` once per
    cycle (an empty request list is fine); all members receive the same
    response list.  See ``src/coordinator.h`` for the frame protocol.
    """

    def __init__(self, rank: int, world_size: int, host: str = "127.0.0.1",
                 port: int = 0, fusion_threshold: int = 64 << 20,
                 timeout_s: float = 60.0) -> None:
        self._lib = _lib()
        self._h = self._lib.hvd_coord_create(
            rank, world_size, host.encode(), port, fusion_threshold,
            timeout_s)
        if not self._h:
            raise ConnectionError(
                f"coordinator bootstrap failed (rank {rank}/{world_size} "
                f"via {host}:{port})")
        self.rank = rank
        self.world_size = world_size

    @property
    def bound_port(self) -> int:
        return self._lib.hvd_coord_bound_port(self._h)

    def negotiate(self, requests: Sequence[Request]) -> List[Response]:
        enc = encode_requests(list(requests))
        arr = (ctypes.c_uint8 * max(len(enc), 1)).from_buffer_copy(
            enc + b"\0" if not enc else enc)
        cap = 1 << 16
        for _ in range(4):
            out = (ctypes.c_uint8 * cap)()
            n = self._lib.hvd_coord_negotiate(self._h, arr, len(enc), out,
                                              cap)
            if n >= 0:
                return decode_responses(bytes(out[:n]))
            if n == -1:
                raise RuntimeError(
                    f"negotiate failed: {self.last_error()}")
            cap = -n
        raise RuntimeError("native buffer negotiation failed")

    def barrier(self) -> None:
        if not self._lib.hvd_coord_barrier(self._h):
            raise RuntimeError(f"barrier failed: {self.last_error()}")

    @property
    def cycles(self) -> int:
        return self._lib.hvd_coord_cycles(self._h)

    def cache_hits(self) -> int:
        """Rank 0 only (-1 elsewhere)."""
        return self._lib.hvd_coord_cache_hits(self._h)

    def last_error(self) -> str:
        return _call_filling_str(self._lib.hvd_coord_last_error, self._h)

    def shutdown(self) -> None:
        if self._h:
            self._lib.hvd_coord_shutdown(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.hvd_coord_destroy(self._h)
            self._h = None

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass


# --- stall inspector --------------------------------------------------------

class NativeStallInspector:
    """Reference-semantic stall table: tensors submitted on some ranks
    but not all for too long, with the missing ranks."""

    def __init__(self, world_size: int, warn_after_s: float,
                 shutdown_after_s: float = 0.0) -> None:
        self._lib = _lib()
        self._h = self._lib.hvd_stall_create(world_size, warn_after_s,
                                             shutdown_after_s)
        if not self._h:
            raise ValueError("invalid stall inspector parameters")

    def submit(self, name: str, rank: int,
               now_s: Optional[float] = None) -> None:
        self._lib.hvd_stall_submit(self._h, name.encode(), rank,
                                   time.monotonic() if now_s is None
                                   else now_s)

    def complete(self, name: str) -> None:
        self._lib.hvd_stall_complete(self._h, name.encode())

    def report(self, now_s: Optional[float] = None
               ) -> List[Tuple[str, float, List[int]]]:
        text = _call_filling_str(
            self._lib.hvd_stall_report, self._h,
            time.monotonic() if now_s is None else now_s)
        return [(name, age, missing)
                for name, age, missing in json.loads(text)]

    def should_shutdown(self, now_s: Optional[float] = None) -> bool:
        return bool(self._lib.hvd_stall_should_shutdown(
            self._h, time.monotonic() if now_s is None else now_s))

    def close(self) -> None:
        if self._h:
            self._lib.hvd_stall_destroy(self._h)
            self._h = None

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass


# --- timeline ---------------------------------------------------------------

class NativeTimeline:
    """Background-thread Chrome-trace writer (drop-in backend for
    ``utils.timeline.Timeline``)."""

    def __init__(self, path: str, mark_cycles: bool = False) -> None:
        self._lib = _lib()
        self._h = self._lib.hvd_tl_open(path.encode(), int(mark_cycles))  # guarded-by: _hlock
        if not self._h:
            raise OSError(f"cannot open timeline file {path!r}")
        # Guards handle lifetime: close() frees the native writer, so a
        # record() racing close() must not reach a freed pointer.  The
        # actual IO is on the native writer thread, so the critical
        # section here is just an enqueue.
        self._hlock = threading.Lock()

    def record(self, tensor: str, phase: str, ts_us: float, dur_us: float,
               args_json: str = "") -> None:
        with self._hlock:
            if not self._h:
                return
            self._lib.hvd_tl_record(
                self._h, tensor.encode(), phase.encode(), ts_us, dur_us,
                args_json.encode() if args_json else None)

    def mark_cycle(self, ts_us: float) -> None:
        with self._hlock:
            if self._h:
                self._lib.hvd_tl_mark_cycle(self._h, ts_us)

    def counter(self, name: str, ts_us: float,
                series_json: str = "") -> None:
        """Counter ("C") event; ``series_json`` is an object body
        without braces (see TimelineWriter::Counter)."""
        with self._hlock:
            if self._h and series_json:
                self._lib.hvd_tl_counter(self._h, name.encode(), ts_us,
                                         series_json.encode())

    def flow(self, name: str, phase: str, flow_id: str,
             ts_us: float) -> None:
        """Flow ("s"/"f") event bound by ``flow_id`` (see
        TimelineWriter::Flow)."""
        with self._hlock:
            if self._h:
                self._lib.hvd_tl_flow(self._h, name.encode(),
                                      phase.encode(), flow_id.encode(),
                                      ts_us)

    def events_written(self) -> int:
        with self._hlock:
            if not self._h:
                return -1
            return self._lib.hvd_tl_events_written(self._h)

    def close(self) -> None:
        with self._hlock:
            if self._h:
                self._lib.hvd_tl_close_destroy(self._h)
                self._h = None

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass


# --- wire compat test hooks --------------------------------------------------

def wire_requests_roundtrip_native(data: bytes) -> bytes:
    """Feeds Python-encoded bytes through the C++ decoder+encoder —
    byte-identical output proves codec compatibility."""
    lib = _lib()
    arr = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    return _call_filling(lib.hvd_wire_requests_roundtrip, arr, len(data))


def wire_responses_roundtrip_native(data: bytes) -> bytes:
    lib = _lib()
    arr = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    return _call_filling(lib.hvd_wire_responses_roundtrip, arr, len(data))
