"""Socket RPC and network-interface detection for the runner.

Counterpart of ``horovod_tpu/runner/common/network.py`` (Horovod's
``runner/common/util/network.py`` and ``common/service``): a small
threaded TCP service speaking HMAC-signed pickled request/response
frames, and the helpers that list this host's addresses.

Every :class:`BasicService` answers :class:`PingRequest` (its span
clock, for ``obs.trace.estimate_clock_offset``), :class:`MetricsRequest`
(the port's ``obs`` registry: ``export.json_snapshot``, and
``render_prometheus`` on request) and :class:`TraceRequest` (the span
ring, ``obs.trace.snapshot``, for ``obs.trace.merge_traces``); anything
else gets :class:`AckResponse`.  :class:`BasicClient` retries under the
port's ``utils/retry.py`` policy (``HVD_TPU_RPC_RETRIES``,
``HVD_TPU_RPC_BACKOFF``) and passes every exchange through the ``rpc``
fault site (``faults.on_rpc``).  The serving replicas' messages
(:class:`DrainRequest`, :class:`DropConnection`) and the fleet's KV
migration frames (:class:`KvMigrateRequest` / :class:`KvMigrateResponse`,
:class:`CollectRequest`) live here too.

Security: a frame is authenticated *before* it is unpickled; a frame
whose HMAC does not match the launcher-minted secret is dropped.
"""

from __future__ import annotations

import contextlib
import fcntl
import hashlib
import hmac
import os
import pickle
import socket
import socketserver
import struct
import threading
from typing import Any, Dict, List, Optional, Tuple

from ... import faults as faults_mod
from ...obs import trace as trace_mod
from ...utils.retry import RetryPolicy, retry_call
from .secret import DIGEST_LEN

_LEN = struct.Struct(">Q")
_SIOCGIFADDR = 0x8915   # Linux: an interface's IPv4 address


class PingRequest:
    pass


class PingResponse:
    """``clock_us`` is the peer's span clock (``obs.trace.now_us``) when
    it answered: Cristian's algorithm over these samples
    (``obs.trace.estimate_clock_offset``) puts every rank's spans on one
    time axis."""

    def __init__(self, service_name: str, source_address: str,
                 clock_us: Optional[float] = None):
        self.service_name = service_name
        self.source_address = source_address
        self.clock_us = clock_us


class AckResponse:
    pass


class MetricsRequest:
    """Scrape this process's telemetry registry (``obs``) over the HMAC
    control plane: ``fmt="json"`` (the snapshot) or ``"prometheus"``
    (the snapshot and the text exposition)."""

    def __init__(self, fmt: str = "json"):
        self.fmt = fmt


class MetricsResponse:
    def __init__(self, snapshot: dict, prometheus: Optional[str] = None):
        self.snapshot = snapshot
        self.prometheus = prometheus


class TraceRequest:
    """Fetch this process's span ring (``obs.trace``); ``clear`` drains
    it (a collector that owns what it fetched)."""

    def __init__(self, clear: bool = False):
        self.clear = clear


class TraceResponse:
    """``spans`` is the ring (oldest first); ``now_us`` the peer's span
    clock when it answered (a second offset anchor beside
    ``PingResponse.clock_us``); ``rank``/``pid`` say where they came
    from."""

    def __init__(self, spans: list, now_us: float,
                 rank: Optional[int] = None, pid: Optional[int] = None):
        self.spans = spans
        self.now_us = now_us
        self.rank = rank
        self.pid = pid


class KvMigrateRequest:
    """One chunk of a live KV migration (disaggregated serving,
    ``serve/fleet/migration.py``): a prefill replica streams a
    request's paged KV blocks to a decode replica over this HMAC
    control plane — the block table is the transfer manifest, so only
    live, non-trash blocks move.  ``manifest`` rides the first frame
    (``seq == 0``) and carries per-block sha256 digests the receiver
    verifies before binding anything into its own pool; ``k_blocks`` /
    ``v_blocks`` are ``[n_layer, frame_blocks, block, H, D]`` CPU
    tensors (a bf16 cache stays bf16: numpy has no bf16), chunked so each frame stays under
    ``HVD_TPU_FLEET_MIGRATE_CHUNK`` bytes.

    Tensor-parallel senders (docs/tp_serving.md) split the transfer
    head-wise into ``n_shards`` independent streams — frame arrays then
    carry only that shard's ``H/tp`` heads, ``seq``/``total`` count
    within the shard, and the manifest's ``shard_digests`` verify each
    stream before the receiver concatenates heads back together."""

    def __init__(self, request_id: str, seq: int, total: int,
                 k_blocks, v_blocks, manifest: Optional[dict] = None,
                 shard: int = 0, n_shards: int = 1):
        self.request_id = request_id
        self.seq = seq
        self.total = total
        self.k_blocks = k_blocks
        self.v_blocks = v_blocks
        self.manifest = manifest
        self.shard = shard
        self.n_shards = n_shards


class KvMigrateResponse:
    """Per-frame ack; the FINAL frame's response reports the whole
    transfer: ``error`` is None once the digests verified and the
    request was adopted into the decode replica's batcher, else
    ``digest_mismatch`` / ``busy`` / ``draining`` / ``replica_dead`` —
    the sender falls back to decoding locally (never wrong tokens)."""

    def __init__(self, request_id: str, error: Optional[str] = None):
        self.request_id = request_id
        self.error = error


class CollectRequest:
    """Fetch the finished generation a migrated request produced on
    this (decode) replica; blocks until the adopted request completes
    and answers with a ``GenerateResponse``."""

    def __init__(self, request_id: str):
        self.request_id = request_id


class DrainRequest:
    """Stop admitting new work on a serving replica (drain-and-retire):
    queued and in-flight requests finish, new submissions answer
    ``draining`` so the router shifts load elsewhere.  ``cancel=True``
    reverses an in-progress drain.  Answered with ``AckResponse``."""

    def __init__(self, reason: str = "", cancel: bool = False):
        self.reason = reason
        self.cancel = cancel


class DropConnection(Exception):
    """Raised from a ``BasicService._handle`` override to close the
    connection without writing a response — the wire signature of a
    crashed peer (the serving endpoint's ``serve:mode=drop`` fault
    site; clients see a mid-frame ConnectionError and retry)."""


def local_addresses() -> Dict[str, List[str]]:
    """``{interface: [ipv4, ...]}`` for every interface with an IPv4
    address, loopback included (one host's runs rely on it); read with
    the Linux ``SIOCGIFADDR`` ioctl, so it needs no third-party
    package."""
    out: Dict[str, List[str]] = {}
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        for _, nic in socket.if_nameindex():
            try:
                packed = fcntl.ioctl(s.fileno(), _SIOCGIFADDR,
                                     struct.pack("256s", nic.encode()[:15]))
            except OSError:
                continue   # down, or no IPv4 address
            out[nic] = [socket.inet_ntoa(packed[20:24])]
    return out


def routable_addresses(include_loopback: bool = True) -> List[str]:
    addrs = [ip for ips in local_addresses().values() for ip in ips]
    if not include_loopback:
        addrs = [a for a in addrs if not a.startswith("127.")]
    return addrs


def resolvable_hostname() -> str:
    """This host's name when it resolves, else ``127.0.0.1``: the
    hostname a task agent registers with the driver."""
    host = socket.gethostname()
    try:
        socket.gethostbyname(host)
        return host
    except OSError:
        return "127.0.0.1"


def free_port(host: str = "0.0.0.0") -> int:
    """A TCP port free on this machine now (the bind-port-0 race
    applies: claim it promptly)."""
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def _sign(key: bytes, payload: bytes) -> bytes:
    return hmac.new(key, payload, hashlib.sha256).digest()


def write_message(sock: socket.socket, obj: Any, key: bytes) -> None:
    payload = pickle.dumps(obj)
    frame = _sign(key, payload) + payload
    sock.sendall(_LEN.pack(len(frame)) + frame)


def read_message(sock: socket.socket, key: bytes) -> Any:
    header = _read_exact(sock, _LEN.size)
    (length,) = _LEN.unpack(header)
    if length > 64 * 1024 * 1024:
        raise ValueError(f"RPC frame too large: {length}")
    frame = _read_exact(sock, length)
    digest, payload = frame[:DIGEST_LEN], frame[DIGEST_LEN:]
    if not hmac.compare_digest(digest, _sign(key, payload)):
        raise PermissionError("RPC frame failed HMAC authentication")
    return pickle.loads(payload)


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        buf += chunk
    return buf


class BasicService:
    """Threaded TCP request/response service (reference:
    ``network.BasicService``).  Subclasses override ``_handle``."""

    def __init__(self, name: str, key: bytes, host: str = "0.0.0.0",
                 nics: Optional[List[str]] = None):
        self.name = name
        self._key = key
        self._nics = list(nics) if nics else None
        outer = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    req = read_message(self.request, outer._key)
                except (PermissionError, ConnectionError, ValueError):
                    return  # unauthenticated or broken peer: drop it
                # A request carrying a propagated trace context gets a
                # server span parented to the caller's client span.
                ctx = trace_mod.extract(req)
                span = (trace_mod.span("hvd_tpu_rpc_server", parent=ctx,
                                       kind="server",
                                       args={"req": type(req).__name__,
                                             "service": outer.name})
                        if ctx is not None and trace_mod.enabled()
                        else contextlib.nullcontext())
                try:
                    with span:
                        resp = outer._handle(req, self.client_address)
                except DropConnection:
                    return  # the handler chose to die on the wire
                try:
                    write_message(self.request, resp, outer._key)
                except OSError:
                    return  # the peer left before the reply

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _Server((host, 0), _Handler)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True,
                                        name=f"{name}-service")
        self._thread.start()

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def addresses(self) -> List[Tuple[str, int]]:
        """Every (ip, port) a client could try.  With ``nics`` (the
        launcher's ``--network-interfaces``) only those interfaces and
        loopback; an interface name that matches nothing raises at once
        (a typo'd NIC must fail loudly, not as a timeout later)."""
        if self._nics:
            per_nic = local_addresses()
            unknown = [n for n in self._nics if n not in per_nic]
            if unknown:
                raise ValueError(
                    f"--network-interfaces names unknown interface(s) "
                    f"{unknown}; available: {sorted(per_nic)}")
            ips = [ip for nic in self._nics for ip in per_nic[nic]]
            ips += [ip for addrs in per_nic.values() for ip in addrs
                    if ip.startswith("127.") and ip not in ips]
            return [(ip, self.port) for ip in ips]
        return [(ip, self.port) for ip in routable_addresses()]

    def _handle(self, req: Any, client_address) -> Any:
        if isinstance(req, PingRequest):
            return PingResponse(self.name, client_address[0],
                                clock_us=trace_mod.now_us())
        if isinstance(req, MetricsRequest):
            from ...obs import export as _obs_export

            return MetricsResponse(
                snapshot=_obs_export.json_snapshot(),
                prometheus=(_obs_export.render_prometheus()
                            if getattr(req, "fmt", "json") == "prometheus"
                            else None))
        if isinstance(req, TraceRequest):
            return TraceResponse(
                spans=trace_mod.snapshot(clear=getattr(req, "clear", False)),
                now_us=trace_mod.now_us(), rank=trace_mod.process_rank(),
                pid=os.getpid())
        return AckResponse()

    def shutdown(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)


def _default_rpc_policy() -> RetryPolicy:
    """``HVD_TPU_RPC_RETRIES`` attempts with ``HVD_TPU_RPC_BACKOFF``
    jittered exponential backoff: the session's config after ``init``,
    else the environment parsed afresh (a launcher never inits)."""
    from ... import basics
    from ...config import Config

    cfg = basics.config() if basics.is_initialized() else Config.from_env()
    return RetryPolicy(attempts=max(1, cfg.rpc_retries),
                       base_delay_s=cfg.rpc_backoff_seconds,
                       max_delay_s=5.0)


class BasicClient:
    """Client side: tries each candidate address until one answers the
    ping as ``name``.  Requests after the probe retry under the shared
    policy; the probe and :meth:`ping` are single-shot.

    ``name=None`` accepts whichever service answers and takes its
    advertised name (a scrape of whatever owns a port).  ``probe=False``
    skips the probe and uses the first address: the request itself is
    then the probe."""

    def __init__(self, name: Optional[str],
                 addresses: List[Tuple[str, int]],
                 key: bytes, probe_timeout: float = 5.0,
                 retry_policy: Optional[RetryPolicy] = None,
                 probe: bool = True):
        self.name = name
        self._key = key
        self._timeout = probe_timeout
        self._retry_policy = retry_policy or _default_rpc_policy()
        if probe:
            self._address = self._probe(addresses)
        else:
            if not addresses:
                raise ValueError("probe=False needs at least one address")
            self._address = tuple(addresses[0])

    @property
    def address(self) -> Tuple[str, int]:
        return self._address

    def _probe(self, addresses) -> Tuple[str, int]:
        errs = []
        for addr in addresses:
            try:
                resp = self._call(PingRequest(), addr)
                if isinstance(resp, PingResponse) \
                        and self.name in (None, resp.service_name):
                    if self.name is None:
                        self.name = resp.service_name
                    return tuple(addr)
            except OSError as e:
                errs.append((addr, e))
        raise ConnectionError(
            f"no address of service {self.name or '<any>'!r} "
            f"answered: {errs}")

    def _call(self, req: Any, addr: Optional[Tuple[str, int]] = None,
              timeout: Optional[float] = None) -> Any:
        # Every exchange is a client span with its context on the
        # request, so the peer's server span parents under it.
        if not trace_mod.enabled():
            return self._call_inner(req, addr, timeout)
        with trace_mod.span("hvd_tpu_rpc_client", kind="client",
                            args={"req": type(req).__name__,
                                  "service": self.name}) as ctx:
            trace_mod.inject(req, ctx)
            return self._call_inner(req, addr, timeout)

    def _call_inner(self, req: Any, addr: Optional[Tuple[str, int]] = None,
                    timeout: Optional[float] = None) -> Any:
        # Fault site "rpc": drop (ConnectionError before the write, for
        # the retry policy to absorb) or delay (a slow peer).
        if faults_mod._active is not None:
            faults_mod.on_rpc(type(req).__name__)
        addr = addr or self._address
        with socket.create_connection(addr, timeout=self._timeout) as sock:
            if timeout is not None:
                # Connect under the probe timeout; wait for the response
                # as long as the request legitimately takes.
                sock.settimeout(timeout)
            write_message(sock, req, self._key)
            return read_message(sock, self._key)

    def request(self, req: Any, *, idempotent: bool = True,
                timeout: Optional[float] = None) -> Any:
        """One exchange, retried under the policy (``OSError``: refused,
        reset or timed-out sockets).

        ``idempotent=False`` makes one attempt: re-sending a request
        whose response was lost would repeat its side effect (a
        run-command landing twice).  ``timeout`` sets the response's
        socket timeout; the connect keeps the probe timeout."""
        if not idempotent:
            return self._call(req, timeout=timeout)
        return retry_call(
            lambda: self._call(req, timeout=timeout),
            policy=self._retry_policy,
            retry_on=(OSError,),
            describe=f"rpc {type(req).__name__} -> {self.name}",
        )

    def ping(self) -> PingResponse:
        return self._call(PingRequest())
