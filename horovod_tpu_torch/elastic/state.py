"""Elastic state: in-memory commit/rollback + the ``run`` decorator.

Counterpart of ``horovod_tpu/elastic/state.py`` (reference:
``horovod/common/elastic.py`` and ``horovod/torch/elastic/state.py``):
``State`` with ``commit``/``restore``/``sync`` and reset callbacks,
``ObjectState`` for plain attributes, and :class:`TorchState` for a
module and an optimizer, the counterpart of the reference's ``TpuState``
with the API of its torch binding (``horovod_tpu/torch/elastic.py``).

``run`` catches ``HorovodInternalError`` (and, through the exception
translators, torch.distributed's failures), rolls back to the last
commit, re-initialises the session on its own device and backend over a
new rendezvous generation (``basics.rendezvous_generation``), syncs
from rank 0 and retries.
"""

from __future__ import annotations

import copy
import json
import logging
import time
from typing import Any, Callable, Dict, List, Optional

import torch

logger = logging.getLogger(__name__)


class HorovodInternalError(RuntimeError):
    """A collective failed mid-step (raised by a fault site, a wrapper
    around a failed collective, or a translator)."""


class HostsUpdatedInterrupt(RuntimeError):
    """Membership changed without a failure (graceful re-rendezvous)."""


class State:
    """Base elastic state (reference API: ``register_reset_callbacks``,
    ``on_reset``, ``commit``, ``restore``, ``sync``)."""

    def __init__(self) -> None:
        self._reset_callbacks: List[Callable[[], None]] = []

    def register_reset_callbacks(self, callbacks) -> None:
        self._reset_callbacks.extend(callbacks)

    def on_reset(self) -> None:
        self.reset()
        for cb in self._reset_callbacks:
            cb()

    def reset(self) -> None:  # re-establish process membership
        pass

    def commit(self) -> None:
        raise NotImplementedError

    def restore(self) -> None:
        raise NotImplementedError

    def sync(self) -> None:
        raise NotImplementedError


class ObjectState(State):
    """Arbitrary-attribute state: plain Python values committed and
    restored by value."""

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._saved: Dict[str, Any] = {}
        for name, value in kwargs.items():
            setattr(self, name, value)
        self.commit()

    def _public_attrs(self) -> Dict[str, Any]:
        return {
            k: v for k, v in self.__dict__.items()
            if not k.startswith("_") and not callable(v)
        }

    def commit(self) -> None:
        self._saved = copy.deepcopy(self._public_attrs())

    def restore(self) -> None:
        for k, v in copy.deepcopy(self._saved).items():
            setattr(self, k, v)

    def sync(self) -> None:
        from ..functions import broadcast_object

        synced = broadcast_object(self._public_attrs(), root_rank=0)
        for k, v in synced.items():
            setattr(self, k, v)
        self.commit()


# --- an optimizer's state dict as tensors + one JSON leaf ---------------------

def _pack(obj: Any, tensors: Dict[str, torch.Tensor], path: str = "") -> Any:
    """``obj`` as JSON with every tensor replaced by ``{"__tensor__":
    key}`` and put in ``tensors`` under that key (its path); dicts keep
    their key types (optimizer state is keyed by int) and tuples stay
    tuples."""
    if torch.is_tensor(obj):
        tensors[path] = obj
        return {"__tensor__": path}
    if isinstance(obj, dict):
        return {"__dict__": [[k, _pack(v, tensors, f"{path}/{k}")]
                             for k, v in obj.items()]}
    if isinstance(obj, (list, tuple)):
        items = [_pack(v, tensors, f"{path}/{i}") for i, v in enumerate(obj)]
        return {"__tuple__": items} if isinstance(obj, tuple) else items
    return obj


def _unpack(obj: Any, tensors: Dict[str, Any]) -> Any:
    if isinstance(obj, dict):
        if "__tensor__" in obj:
            return tensors[obj["__tensor__"]]
        if "__tuple__" in obj:
            return tuple(_unpack(v, tensors) for v in obj["__tuple__"])
        return {k: _unpack(v, tensors) for k, v in obj["__dict__"]}
    if isinstance(obj, list):
        return [_unpack(v, tensors) for v in obj]
    return obj


def split_state_dict(state_dict: Dict[str, Any]):
    """``(tensors, text)``: an optimizer's ``state_dict`` as a flat
    ``{path: tensor}`` tree (each a leaf of its own, so a manifest splits
    them across owners) and one JSON text for everything else."""
    tensors: Dict[str, torch.Tensor] = {}
    text = json.dumps(_pack(state_dict, tensors))
    return tensors, text


def join_state_dict(tensors: Dict[str, Any], text: str) -> Dict[str, Any]:
    """Inverse of :func:`split_state_dict`."""
    return _unpack(json.loads(text), tensors)


class TorchState(ObjectState):
    """Elastic state over a torch module, an optimizer and plain
    attributes (reference: ``TpuState``, with the torch binding's
    ``TorchState(model=, optimizer=, **attrs)`` API).

    ``commit`` copies the module's and the optimizer's tensors into host
    buffers (:func:`~..ckpt.snapshot.take_snapshot`: pinned, pooled,
    one synchronisation) and deep-copies the rest; ``restore`` loads
    them back (``load_state_dict``: a :class:`DistributedOptimizer`
    restores its error-feedback residual too); ``sync`` broadcasts rank
    0's tensors, optimizer state and attributes.  :meth:`attach_durable`
    makes commits durable through an
    :class:`~..ckpt.AsyncCheckpointer`: the tensors go in as leaves
    (``trees``), the optimizer's other entries as one JSON leaf, and a
    stateful attribute (the elastic sampler) as its ``state_dict`` in
    one ``__state_json__`` leaf, the reference's convention."""

    def __init__(self, model=None, optimizer=None, **kwargs: Any) -> None:
        from ..ckpt.snapshot import BufferPool

        self._model = model
        self._optimizer = optimizer
        self._pool = BufferPool(2)
        self._snap = None
        self._opt_text: Optional[str] = None
        super().__init__(**kwargs)  # calls commit()

    @property
    def model(self):
        return self._model

    @property
    def optimizer(self):
        return self._optimizer

    def _live_trees(self) -> Dict[str, Dict[str, torch.Tensor]]:
        trees: Dict[str, Dict[str, torch.Tensor]] = {}
        if self._model is not None:
            trees["model"] = dict(self._model.state_dict())
        if self._optimizer is not None:
            trees["optimizer"], self._opt_text = split_state_dict(
                self._optimizer.state_dict())
        return trees

    def _saved_trees(self) -> Dict[str, Any]:
        """The committed tensors as host numpy arrays."""
        return self._snap.tree() if self._snap is not None else {}

    def commit(self) -> None:
        from ..ckpt.snapshot import take_snapshot

        snap = take_snapshot(self._live_trees(), pool=self._pool)
        if self._snap is not None:
            self._snap.release()
        self._snap = snap
        self._saved = copy.deepcopy(self._public_attrs())
        self._durable_save()

    def _load_trees(self, trees: Dict[str, Any]) -> None:
        from ..ckpt.snapshot import to_tensor

        if self._model is not None and "model" in trees:
            live = self._model.state_dict()
            self._model.load_state_dict(
                {k: to_tensor(v, live[k].dtype) for k, v in
                 trees["model"].items()})
        if self._optimizer is not None and self._opt_text is not None:
            tensors = {k: to_tensor(v) for k, v in
                       trees.get("optimizer", {}).items()}
            self._optimizer.load_state_dict(
                join_state_dict(tensors, self._opt_text))

    def restore(self) -> None:
        self._load_trees(self._saved_trees())
        for k, v in copy.deepcopy(self._saved).items():
            setattr(self, k, v)
        # Queued async saves hold pre-rollback state, and a writer error
        # from the incident must not resurface mid-recovery.
        ck = getattr(self, "_durable", None)
        if ck is not None and hasattr(ck, "discard_pending"):
            ck.discard_pending()

    def sync(self) -> None:
        from ..functions import (broadcast_object, broadcast_optimizer_state,
                                 broadcast_parameters)

        if self._model is not None:
            broadcast_parameters(self._model.state_dict(), root_rank=0)
        if self._optimizer is not None:
            broadcast_optimizer_state(self._optimizer, root_rank=0)
        synced = broadcast_object(self._public_attrs(), root_rank=0)
        for k, v in synced.items():
            setattr(self, k, v)
        self.commit()

    # --- the durable tier -----------------------------------------------------

    def attach_durable(self, checkpointer, *, step_attr: str = "step",
                       every: int = 1) -> None:
        """Make every ``every``-th ``commit`` durable through
        ``checkpointer`` (an :class:`~..ckpt.AsyncCheckpointer` or the
        whole-tree ``Checkpointer``), at step ``getattr(self,
        step_attr)`` (else the commit count).  On rollback the
        checkpointer's queued, unwritten saves are discarded."""
        self._durable = checkpointer
        self._durable_step_attr = step_attr
        self._durable_every = max(1, int(every))
        self._durable_commits = 0

    def _payload(self) -> Dict[str, Any]:
        plain = {}
        for k, v in self._saved.items():
            state_dict = getattr(v, "state_dict", None)
            if callable(state_dict):
                plain[k] = {"__state_json__": json.dumps(
                    state_dict(), default=str)}
            else:
                plain[k] = v
        payload = {"trees": self._saved_trees(), "plain": plain}
        if self._opt_text is not None:
            payload["optimizer"] = {"__state_json__": self._opt_text}
        return payload

    def _durable_save(self) -> None:
        ck = getattr(self, "_durable", None)
        if ck is None:
            return
        self._durable_commits += 1
        if self._durable_commits % self._durable_every:
            return
        step = getattr(self, self._durable_step_attr, None)
        step = int(step) if step is not None else self._durable_commits
        ck.save(step, self._payload())

    def journal_step(self, step: Optional[int] = None, **meta) -> None:
        """Journal one step's replay metadata through the attached
        checkpointer (no-op without one); the state's ``rng`` and
        ``sampler`` attributes ride along."""
        ck = getattr(self, "_durable", None)
        if ck is None or not hasattr(ck, "journal_step"):
            return
        if step is None:
            step = int(getattr(self, self._durable_step_attr, 0))
        meta.setdefault("rng", getattr(self, "rng", None))
        meta.setdefault("sampler", getattr(self, "sampler", None))
        ck.journal_step(int(step), **meta)

    def save_to(self, checkpointer, step: int, *, force: bool = False):
        """Persist the committed state durably (``force`` overwrites a
        stored step); returns the checkpointer's answer."""
        return checkpointer.save(step, self._payload(), force=force)

    def load_from(self, checkpointer, step=None) -> None:
        """Load a durable checkpoint into this state and restore it."""
        self.load_payload(checkpointer.restore(step))

    def load_payload(self, payload: Dict[str, Any]) -> None:
        """Install a restored payload (``restore()``'s tree, or
        ``resume().tree``) as the committed state, then restore it.  A
        value saved as a ``state_dict`` is re-applied onto the live
        attribute through its ``load_state_dict``."""
        import numpy as np

        from ..ckpt.snapshot import take_snapshot

        opt = payload.get("optimizer")
        if opt is not None:
            self._opt_text = str(np.asarray(opt["__state_json__"]).item())
        snap = take_snapshot(payload["trees"], pool=self._pool)
        if self._snap is not None:
            self._snap.release()
        self._snap = snap
        merged = {}
        for k, v in dict(payload["plain"]).items():
            live = getattr(self, k, None)
            if isinstance(v, dict) and "__state_json__" in v:
                if not hasattr(live, "load_state_dict"):
                    raise ValueError(
                        f"checkpoint attribute {k!r} was saved as a "
                        f"state_dict, but the live attribute "
                        f"({type(live).__name__}) cannot re-apply it "
                        f"— construct the state with its stateful "
                        f"helper (e.g. the sampler) before load_from")
                blob = np.asarray(v["__state_json__"]).item()
                live.load_state_dict(json.loads(blob))
                merged[k] = live
            else:
                merged[k] = v
        self._saved = merged
        self.restore()


def _reinitialize() -> None:
    """Tear the session down and build it again on the same device and
    backend, over a new rendezvous generation."""
    from .. import basics

    dev, backend = None, None
    if basics.is_initialized():
        dev, backend = basics.device(), basics.backend()
    basics.shutdown()
    basics.init(device=dev, backend=backend)


# --- exception translation ---------------------------------------------------
# Translators map an exception to a HorovodInternalError /
# HostsUpdatedInterrupt (recover) or None (not ours: propagate).
# User-registered translators run before the default, newest first.

_translators: List[Callable[[BaseException], Optional[BaseException]]] = []

# Substrings of NCCL, gloo and c10d store failures that mean "the
# collective or the world broke", not "the training code is wrong".
_TORCH_FAILURE_MARKERS = (
    "nccl error", "ncclremoteerror", "ncclsystemerror",
    "ncclinternalerror", "nccl communicator", "watchdog",
    "connection closed by peer", "connection reset by peer",
    "connection refused", "broken pipe", "socket", "timed out",
    "timeout", "heartbeat", "peer down", "gloo/transport",
)
_TORCH_FAILURE_TYPES = ("DistBackendError", "DistNetworkError",
                        "DistStoreError", "DistError", "RuntimeError")


def default_exception_translator(e: BaseException) -> Optional[BaseException]:
    """Map torch.distributed's failures (``DistBackendError``,
    ``DistNetworkError``, ``DistStoreError``, or a ``RuntimeError``) whose
    message carries an NCCL or gloo transport marker to
    ``HorovodInternalError``: a known type AND a marker, the reference's
    rule.  Anything else is not ours."""
    if isinstance(e, (HorovodInternalError, HostsUpdatedInterrupt)):
        return e
    name = type(e).__name__
    if name not in _TORCH_FAILURE_TYPES:
        return None
    msg = str(e).lower()
    if any(marker in msg for marker in _TORCH_FAILURE_MARKERS):
        return HorovodInternalError(f"translated from {name}: {e}")
    return None


def register_exception_translator(
        fn: Callable[[BaseException], Optional[BaseException]]) -> None:
    """Register a translator consulted by ``elastic.run`` before the
    default one."""
    _translators.insert(0, fn)


def translate_exception(e: BaseException) -> Optional[BaseException]:
    for fn in (*_translators, default_exception_translator):
        try:
            out = fn(e)
        except Exception:  # a broken translator must not mask the error
            continue
        if out is not None:
            return out
    return None


# Failures further apart than this are separate incidents, not a streak.
_FAILURE_STREAK_WINDOW_S = 120.0


def _reset_backoff_s(consecutive_failures: int) -> float:
    """Jittered exponential backoff between failure-driven resets
    (``HVD_TPU_RESET_BACKOFF``, capped at ``HVD_TPU_RESET_BACKOFF_MAX``)."""
    from .. import basics
    from ..config import Config
    from ..utils.retry import RetryPolicy

    cfg = basics.config() if basics.is_initialized() else Config.from_env()
    base, cap = cfg.reset_backoff_seconds, cfg.reset_backoff_max_seconds
    if base <= 0:
        return 0.0
    return RetryPolicy(attempts=0, base_delay_s=base,
                       max_delay_s=cap).delay_s(consecutive_failures)


def run(func: Callable) -> Callable:
    """Decorator making a training function elastic
    (``@hvd.elastic.run``)::

        @hvd.elastic.run
        def train(state):
            for batch in data:
                step(...)
                state.commit()

    On ``HorovodInternalError``: rollback to the last commit, backoff,
    re-init, sync from rank 0, retry.  On ``HostsUpdatedInterrupt``:
    re-init and continue without rollback.  Other exceptions are offered
    to the translators.  Retries are bounded by
    ``HOROVOD_ELASTIC_RESET_LIMIT`` (0 = unlimited)."""

    def wrapper(state: State, *args: Any, **kwargs: Any):
        from .. import basics

        reset_limit = (basics.config().reset_limit
                       if basics.is_initialized() else 0)
        resets = 0
        consecutive_failures = 0
        last_failure_t = 0.0
        while True:
            try:
                return func(state, *args, **kwargs)
            except Exception as exc:
                err = translate_exception(exc)
                if err is None:
                    raise
                resets += 1
                if reset_limit and resets > reset_limit:
                    raise RuntimeError(
                        f"Elastic reset limit ({reset_limit}) exceeded"
                    ) from exc
                from ..obs import flight as _flight
                from ..obs import instrument as _obs

                if isinstance(err, HorovodInternalError):
                    now = time.monotonic()
                    if now - last_failure_t > _FAILURE_STREAK_WINDOW_S:
                        consecutive_failures = 0
                    last_failure_t = now
                    consecutive_failures += 1
                    delay = _reset_backoff_s(consecutive_failures)
                    _obs.on_elastic_reset("rollback")
                    _flight.record("elastic_rollback", error=str(err)[:300],
                                   resets=resets,
                                   consecutive=consecutive_failures)
                    _flight.dump("horovod_internal_error")
                    logger.warning(
                        "Collective failure (%s); rolling back to last "
                        "commit and re-initializing (reset %d%s, backoff "
                        "%.2fs)", err, resets,
                        f"/{reset_limit}" if reset_limit else "", delay)
                    if delay > 0:
                        time.sleep(delay)
                    _reinitialize()
                    state.restore()
                    state.on_reset()
                    state.sync()
                else:  # HostsUpdatedInterrupt: graceful, no rollback
                    consecutive_failures = 0
                    _obs.on_elastic_reset("resize")
                    _flight.record("elastic_resize", resets=resets)
                    logger.info("Membership changed; re-initializing "
                                "without rollback")
                    _reinitialize()
                    state.on_reset()
                    state.sync()

    wrapper.__name__ = getattr(func, "__name__", "elastic_run")
    return wrapper
