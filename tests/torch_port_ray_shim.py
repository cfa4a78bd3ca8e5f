"""A stand-in for Ray's actors, for ``horovod_tpu_torch.ray.RayExecutor`` on
hosts without Ray: each actor is a local process, and no cluster is
involved.

It implements the surface the executor touches: ``ray.remote`` on a
class with ``.options(...).remote()``, a method's ``.remote()`` future,
``ray.get`` (one or a list, with a timeout), ``ray.kill``,
``ray.util.get_node_ip_address`` and ``ray.util.placement_group``.  The
actor's class and each call travel over a socketpair of their own as
length-prefixed ``pickle`` frames (cloudpickle where installed), so the
standard library serves: no jax, no ``horovod_tpu``.  Usage::

    import torch_port_ray_shim
    torch_port_ray_shim.install()        # registers ``ray``
    ex = horovod_tpu_torch.ray.RayExecutor(num_workers=2, device="cpu")

``live_actors()`` lists the actor processes not yet gone.

``install(gpus=[...])`` models Ray's cards on one node: an actor class
asking ``num_gpus=k`` takes the next ``k`` ids of the list, its process
starts with ``CUDA_VISIBLE_DEVICES`` set to them, as Ray starts it, and
``ray.get_gpu_ids()`` there returns them.  With ``fake_cuda=True`` an
actor's ``torch.cuda`` reports as many devices as its
``CUDA_VISIBLE_DEVICES`` lists and ``set_device`` refuses an ordinal
past them as CUDA does, so a CPU test can watch which device ``init``
picks (a CUDA tensor still cannot be made).  ``install()`` alone
gives no actor a card.
"""

from __future__ import annotations

import os
import pickle
import socket
import struct
import subprocess
import sys
import traceback
import types
from typing import Any, List, Optional

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)

_actors: List["_ActorHandle"] = []
_GPUS_ENV = "TORCH_PORT_RAY_SHIM_GPUS"
_FAKE_CUDA_ENV = "TORCH_PORT_RAY_SHIM_FAKE_CUDA"
_pool: dict = {"free": [], "fake_cuda": False}


def _serializer():
    try:
        import cloudpickle

        return cloudpickle
    except ImportError:
        return pickle


def _write_frame(sock: socket.socket, obj) -> None:
    data = _serializer().dumps(obj)
    sock.sendall(struct.pack("<Q", len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            raise EOFError("actor process died")
        buf += chunk
    return bytes(buf)


def _read_frame(sock: socket.socket):
    (n,) = struct.unpack("<Q", _recv_exact(sock, 8))
    return pickle.loads(_recv_exact(sock, n))


class _Future:
    """One call in flight; its result is the actor's next response frame
    (an actor answers its calls in order)."""

    def __init__(self, actor: "_ActorHandle") -> None:
        self._actor = actor

    def _result(self, timeout=None):
        self._actor._sock.settimeout(timeout)
        try:
            kind, payload = _read_frame(self._actor._sock)
        finally:
            self._actor._sock.settimeout(None)
        if kind == "err":
            raise RuntimeError(f"actor raised: {payload}")
        return payload


class _MethodProxy:
    def __init__(self, actor: "_ActorHandle", name: str) -> None:
        self._actor = actor
        self._name = name

    def remote(self, *args, **kwargs) -> _Future:
        _write_frame(self._actor._sock, ("call", self._name, args, kwargs))
        return _Future(self._actor)


class _ActorHandle:
    def __init__(self, cls, num_gpus: int = 0) -> None:
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (ROOT, TESTS, env.get("PYTHONPATH", "")) if p)
        if num_gpus and _pool["free"]:
            if len(_pool["free"]) < num_gpus:
                raise RuntimeError("the stand-in's node has too few GPUs")
            ids = [_pool["free"].pop(0) for _ in range(num_gpus)]
            env["CUDA_VISIBLE_DEVICES"] = env[_GPUS_ENV] = ",".join(ids)
        if _pool["fake_cuda"]:
            env[_FAKE_CUDA_ENV] = "1"
        parent_sock, child_sock = socket.socketpair()
        self._proc = subprocess.Popen(
            [sys.executable, "-c",
             "import torch_port_ray_shim as s; s._actor_main()",
             str(child_sock.fileno())],
            env=env, pass_fds=(child_sock.fileno(),))
        child_sock.close()
        self._sock = parent_sock
        _write_frame(self._sock, ("init", cls))
        _actors.append(self)

    def __getattr__(self, name: str) -> _MethodProxy:
        if name.startswith("_"):
            raise AttributeError(name)
        return _MethodProxy(self, name)

    def _kill(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
        if self._proc.poll() is None:
            self._proc.kill()
        self._proc.wait()


class _RemoteClass:
    def __init__(self, cls, num_gpus=None) -> None:
        self._cls = cls
        self._num_gpus = int(num_gpus or 0)

    def options(self, **_ignored) -> "_RemoteClass":
        return self

    def remote(self, *args, **kwargs) -> _ActorHandle:
        assert not args and not kwargs, "stand-in actors take no arguments"
        return _ActorHandle(self._cls, self._num_gpus)


def _fake_cuda() -> None:
    """``torch.cuda`` as a process that sees its ``CUDA_VISIBLE_DEVICES``
    would: that many devices, ``set_device`` past them refused.  The
    variable is read at each call, as CUDA reads it at its first."""
    import torch

    def count() -> int:
        return len([d for d in os.environ.get("CUDA_VISIBLE_DEVICES",
                                              "").split(",") if d])

    def set_device(device) -> None:
        index = torch.device(device).index
        if index is None or index >= count():
            raise RuntimeError(f"CUDA error: invalid device ordinal "
                               f"{index} ({count()} visible)")

    torch.cuda.is_available = lambda: count() > 0
    torch.cuda.device_count = count
    torch.cuda.set_device = set_device


def _actor_main() -> None:
    """An actor process: build the shipped class, answer its calls."""
    install()   # the actor's methods import ray themselves
    if os.environ.get(_FAKE_CUDA_ENV):
        _fake_cuda()
    sock = socket.socket(fileno=int(sys.argv[1]))
    kind, cls = _read_frame(sock)
    assert kind == "init"
    instance = cls()
    while True:
        try:
            kind, name, args, kwargs = _read_frame(sock)
        except EOFError:
            return
        try:
            result = getattr(instance, name)(*args, **kwargs)
            _write_frame(sock, ("ok", result))
        except Exception:  # ship the error, keep serving
            _write_frame(sock, ("err", traceback.format_exc()))


# --- the module-level API -------------------------------------------------------

def remote(*args, **kwargs):
    if args and isinstance(args[0], type):   # a bare @ray.remote
        return _RemoteClass(args[0])

    def deco(cls):
        return _RemoteClass(cls, kwargs.get("num_gpus"))

    return deco


def get_gpu_ids() -> List[str]:
    """The ids this actor was given (none in the driver)."""
    return [i for i in os.environ.get(_GPUS_ENV, "").split(",") if i]


def get(x, timeout: float = None) -> Any:
    if isinstance(x, list):
        return [get(f, timeout) for f in x]
    if isinstance(x, _Future):
        return x._result(timeout)
    return x   # the placement group's ready() token


def kill(actor: _ActorHandle) -> None:
    actor._kill()


def live_actors() -> List[int]:
    """The pids of the actor processes still running."""
    return [a._proc.pid for a in _actors if a._proc.poll() is None]


class _PlacementGroup:
    def __init__(self, bundles: List[dict], strategy: str) -> None:
        self.bundles = bundles
        self.strategy = strategy

    def ready(self):
        return "ready"


def _placement_group(bundles, strategy="PACK") -> _PlacementGroup:
    return _PlacementGroup(list(bundles), strategy)


def _remove_placement_group(pg) -> None:
    pass


def install(gpus: Optional[List[str]] = None,
            fake_cuda: bool = False) -> types.ModuleType:
    """Register the stand-in as ``ray`` (and ``ray.util``,
    ``ray.util.placement_group``); ``gpus``: the node's card ids."""
    _pool.update(free=[str(g) for g in gpus or []], fake_cuda=fake_cuda)
    mod = types.ModuleType("ray")
    mod.remote = remote
    mod.get = get
    mod.kill = kill
    mod.get_gpu_ids = get_gpu_ids
    util = types.ModuleType("ray.util")
    util.get_node_ip_address = lambda: "127.0.0.1"
    pg_mod = types.ModuleType("ray.util.placement_group")
    pg_mod.placement_group = _placement_group
    pg_mod.remove_placement_group = _remove_placement_group
    util.placement_group = pg_mod
    mod.util = util
    sys.modules["ray"] = mod
    sys.modules["ray.util"] = util
    sys.modules["ray.util.placement_group"] = pg_mod
    return mod


def uninstall() -> None:
    _pool.update(free=[], fake_cuda=False)
    for m in ("ray", "ray.util", "ray.util.placement_group"):
        sys.modules.pop(m, None)
