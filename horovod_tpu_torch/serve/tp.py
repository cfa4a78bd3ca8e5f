"""Tensor-parallel replica control plane: the leader leads, the follower
shards follow in lockstep.

Counterpart of ``horovod_tpu/serve/tp.py``, frame for frame.  A
tensor-parallel serving replica is ONE endpoint: its leader owns
admission, the wire, QoS and swap (its
:class:`~.server.InferenceServer` and batcher are the only ones the
router ever talks to), and the follower shards run a lockstep decode
loop driven over the same HMAC ``BasicService`` frames the rest of the
control plane uses.  The batcher's dispatch points — prefill start,
decode step, slot release — each send one :class:`ShardStepRequest` to
every follower *before* the leader runs the same operation locally, so
every shard holds the same host-side state (block table, prefix index,
refcounts) at every step boundary.

Failure semantics are the point of the shared frame discipline: a
follower that dies mid-decode (wire error, not-ok answer, or the
``HVD_TPU_SERVE_TP_STEP_TIMEOUT_S`` deadline) kills the WHOLE replica —
:class:`ShardFollower` raises, the batcher dies with reason
``shard_rank_lost``, and the router counts one ``replica_killed``
strike for the replica, exactly as if a tp=1 replica crashed.  A
replica never serves tokens computed by a partial shard group.

Two tiers share this protocol:

* **device tier** — ``engine.InferenceEngine(tp=N, devices=...)``
  shards attention heads and MLP columns over N devices inside one
  process; lockstep frames carry only control decisions (which slot
  starts, steps, releases), never activations;
* **wire tier** — each follower drives a whole engine in lockstep behind
  a :class:`ShardServer`, proving the control-plane properties the
  device tier relies on: the same host state on every shard, per-step
  token digests, and the single-strike failure path, over real sockets.

Lockstep covers the unified serving loop (start / step / release).
Migrated-KV import and preemption resume stay the leader's — run TP
replicas with ``role="unified"`` and QoS preemption off.
"""

from __future__ import annotations

import hashlib
import itertools
import threading
from typing import Any, List, Optional, Tuple

from .. import faults as faults_mod
from ..runner.common.network import (BasicClient, BasicService,
                                     DropConnection)
from ..utils.logging import get_logger
from ..utils.retry import RetryPolicy
from .engine import SamplingParams, resolved_config

logger = get_logger(__name__)


class ShardLockstepError(RuntimeError):
    """A follower shard fell out of lockstep (wire death, not-ok answer,
    digest divergence, or step deadline).  The leader's batcher turns
    this into replica death (``shard_rank_lost``) — the router's
    single-strike failover path."""


class ShardStepRequest:
    """One lockstep dispatch from a TP replica's leader to a follower
    shard.  ``seq`` is the replica-wide dispatch counter (strictly
    increasing), ``op`` is ``start`` / ``step`` / ``release``, and
    ``payload`` carries the op's arguments (``start``: slot, prompt,
    sampling; ``release``: slot; ``step``: empty — the follower decodes
    every active slot, mirroring the leader's ``engine.step()``)."""

    def __init__(self, seq: int, op: str, payload: Optional[dict] = None):
        self.seq = seq
        self.op = op
        self.payload = payload or {}


class ShardStepResponse:
    """A follower's answer to one :class:`ShardStepRequest`.
    ``ok=False`` (with a diagnostic ``detail``) means the shard refused
    or failed the op — the leader treats it exactly like a wire death.
    A successful ``step`` answers ``detail={"digest": ...}``, the sha256
    of the tokens the follower emitted that round, which the leader may
    check against its own (:func:`step_digest`) to catch silent
    divergence, not just crashes."""

    def __init__(self, seq: int, ok: bool, detail: Any = None):
        self.seq = seq
        self.ok = ok
        self.detail = detail


def step_digest(tokens: dict) -> str:
    """Order-independent sha256 of one decode round's ``{slot:
    [tokens]}`` — the cross-shard divergence check.  Identical engines
    in lockstep give identical digests."""
    items = sorted((int(s), [int(t) for t in ts])
                   for s, ts in tokens.items())
    return hashlib.sha256(repr(items).encode()).hexdigest()


class ShardServer(BasicService):
    """A follower shard: one engine behind the HMAC wire, executing the
    leader's lockstep dispatches.  Host-side KV state (block table,
    prefix index, refcounts, trash discipline) stays the same on every
    shard because every shard applies the same ops in the same order.

    The ``serve`` kill fault's step coordinate fires at the ``step``
    dispatch, mirroring the batcher's decode dispatch: killing a
    follower mid-decode closes the connection with no reply
    (:class:`DropConnection`) — to the leader indistinguishable from the
    shard process crashing, which is the drill."""

    def __init__(self, engine, key: bytes, name: str = "serve-shard",
                 host: str = "0.0.0.0", nics: Optional[List[str]] = None):
        super().__init__(name, key, host=host, nics=nics)
        self._engine = engine
        self._lock = threading.Lock()
        self._dead: Optional[str] = None

    def _handle(self, req: Any, client_address) -> Any:
        if isinstance(req, ShardStepRequest):
            return self._dispatch(req)
        return super()._handle(req, client_address)

    def _dispatch(self, req: ShardStepRequest) -> ShardStepResponse:
        with self._lock:
            if self._dead is not None:
                return ShardStepResponse(req.seq, False,
                                         detail=f"shard_dead: {self._dead}")
            try:
                return self._execute(req)
            except DropConnection:
                raise
            except Exception as e:   # defensive: engine bug ≠ hung leader
                return ShardStepResponse(
                    req.seq, False, detail=f"{type(e).__name__}: {e}")

    def _execute(self, req: ShardStepRequest) -> ShardStepResponse:
        if req.op == "start":
            p = req.payload
            sampling = p.get("sampling") or SamplingParams()
            token = self._engine.start(int(p["slot"]),
                                       list(p["prompt"]), sampling)
            return ShardStepResponse(req.seq, True,
                                     detail={"token": int(token)})
        if req.op == "step":
            # The kill fault's event coordinate on a follower — the
            # counter the leader's decode dispatch uses, so
            # ``serve:step=N,mode=kill`` kills a shard mid-decode.
            if faults_mod._active is not None \
                    and faults_mod.on_serve_decode():
                self._dead = "injected shard kill mid-decode"
                logger.warning("shard dying on the wire: %s", self._dead)
                raise DropConnection()
            tokens = self._engine.step()
            return ShardStepResponse(req.seq, True,
                                     detail={"digest": step_digest(tokens)})
        if req.op == "release":
            self._engine.release(int(req.payload["slot"]))
            return ShardStepResponse(req.seq, True)
        return ShardStepResponse(req.seq, False,
                                 detail=f"unknown_op: {req.op}")


class ShardFollower:
    """The leader's handle on the follower shards: the lockstep callable
    the server installs on the batcher
    (``batcher.set_lockstep(ShardFollower(peers, key))``).

    Each dispatch sends one :class:`ShardStepRequest` to EVERY peer,
    single-shot (``RetryPolicy(attempts=1)``, ``idempotent=False``):
    retrying a lockstep op would re-run its side effect on a shard whose
    ack was merely lost, silently desynchronising the replica — any wire
    ambiguity surfaces as :class:`ShardLockstepError` and replica death
    instead.  The per-op deadline is ``HVD_TPU_SERVE_TP_STEP_TIMEOUT_S``:
    a hung shard and a dead shard are the same event to the router."""

    def __init__(self, peers: List[Tuple[str, List[Tuple[str, int]]]],
                 key: bytes, *, timeout: Optional[float] = None,
                 probe_timeout: float = 5.0):
        self._timeout = float(timeout if timeout is not None
                              else resolved_config().serve_tp_step_timeout_s)
        self._seq = itertools.count()
        self._clients = [
            BasicClient(name, addresses, key,
                        probe_timeout=probe_timeout,
                        retry_policy=RetryPolicy(attempts=1))
            for name, addresses in peers
        ]

    @property
    def n_shards(self) -> int:
        """Follower count (the replica's TP degree minus the leader)."""
        return len(self._clients)

    def __call__(self, op: str, payload: Optional[dict] = None) -> list:
        """Dispatch one lockstep op to every follower; returns their
        ``detail`` payloads in peer order.  Raises
        :class:`ShardLockstepError` on ANY wire death, refusal, or
        deadline — partial shard groups never decode."""
        seq = next(self._seq)
        req = ShardStepRequest(seq, op, payload)
        details = []
        for client in self._clients:
            try:
                resp = client.request(req, idempotent=False,
                                      timeout=self._timeout)
            except OSError as e:
                raise ShardLockstepError(
                    f"shard rank {client.name!r} lost at seq {seq} "
                    f"({op}): {e}") from e
            if not isinstance(resp, ShardStepResponse) or not resp.ok:
                detail = getattr(resp, "detail", type(resp).__name__)
                raise ShardLockstepError(
                    f"shard rank {client.name!r} refused seq {seq} "
                    f"({op}): {detail}")
            details.append(resp.detail)
        return details
