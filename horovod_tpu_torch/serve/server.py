"""Replica-local serving endpoint on the runner's RPC stack.

Counterpart of ``horovod_tpu/serve/server.py``.  One :class:`InferenceServer` fronts one continuous-batching replica: it
reuses ``runner/common/network.py``'s :class:`BasicService` (threaded
TCP, HMAC-authenticated frames — the same launcher-minted secret the
driver/task control plane uses, so a serving fleet needs no second
credential system).  Each connection handler blocks on its request's
completion event while the batcher thread schedules; the threaded
server gives per-request concurrency for free.

Error taxonomy on the wire (``GenerateResponse.error``):

* ``busy`` — admission queue full (backpressure; router retries
  elsewhere after backoff)
* ``deadline_exceeded`` — the request's own deadline expired (terminal:
  retrying a dead deadline elsewhere would waste a second replica)
* ``replica_killed`` / ``replica_dead`` — this replica died mid-flight
  / is refusing work (router strikes it and re-runs on a survivor)
* ``prompt_too_long: ...`` / ``invalid_request: ...`` — caller error
  (terminal)
* ``budget_exhausted: retry_after_s=...`` — the tenant's token budget
  (terminal for the router, retriable by the client)

The ``serve`` fault site's ``drop``/``delay`` modes fire here, before
admission: a dropped request closes the connection with no response
(:class:`DropConnection`) — on the router side indistinguishable from
a replica crashing at the worst moment.

A prefill replica streams each request's KV to the decode target the
router named (``migrate_chunk_bytes=``; :mod:`.fleet.migration`), and
every replica adopts migrated requests (:class:`KvMigrateRequest`
frames, then :class:`CollectRequest`).  With ``swap_store=`` the replica
subscribes to a checkpoint store and answers :class:`SwapRequest` /
:class:`RollbackRequest` (:mod:`.swap`).  Tensor-parallel replicas
(``tp_peers=``) wait for their slice of the port (ROADMAP.md, queue A
item 4): the keyword raises ``NotImplementedError``.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, List, Optional, Tuple

from .. import faults as faults_mod
from ..models.transformer import TP_SERVING_ITEM
from ..runner.common.network import (AckResponse, BasicService,
                                     CollectRequest, DrainRequest,
                                     DropConnection, KvMigrateRequest,
                                     KvMigrateResponse)
from ..utils.logging import get_logger
from .batcher import (ContinuousBatcher, QueueFullError,
                      ReplicaDrainingError, ReplicaKilledError)
from .engine import PromptTooLongError, SamplingParams, resolved_config
from .fleet.migration import MigrationBuffer, MigrationError, migrate_slot
from .qos import BudgetExhaustedError
from .swap import (SwapAbandonedError, SwapFailedError, SwapRejectedError,
                   WeightSubscriber)

logger = get_logger(__name__)


class GenerateRequest:
    def __init__(self, request_id: str, prompt: List[int],
                 max_new_tokens: int = 16, temperature: float = 0.0,
                 top_k: int = 0, stop_token: Optional[int] = None,
                 deadline_s: Optional[float] = None, spec: bool = False,
                 migrate_to: Optional[tuple] = None,
                 tenant: Optional[str] = None,
                 qos_class: Optional[str] = None):
        self.request_id = request_id
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.top_k = top_k
        self.stop_token = stop_token
        self.deadline_s = deadline_s
        # Per-request speculative-decoding opt-in (greedy only; ignored
        # by replicas whose engine has no drafter).
        self.spec = spec
        # Disaggregated fleet: the router asks a prefill replica to
        # hand this request's KV to ``(name, [(ip, port), ...])`` after
        # the first token; None (or a non-prefill replica) runs the
        # full generation locally.
        self.migrate_to = migrate_to
        # Multi-tenant QoS (serve/qos/; docs/qos.md): the weighted-fair
        # flow this request rides; old peers simply never set them
        # (pickled frames, getattr defaults on the receiving side).
        self.tenant = tenant
        self.qos_class = qos_class


class GenerateResponse:
    def __init__(self, request_id: str, tokens: Optional[List[int]],
                 error: Optional[str] = None,
                 ttft_ms: Optional[float] = None,
                 migrated_to: Optional[str] = None,
                 migrate_ms: Optional[float] = None,
                 evicted_prefixes: Optional[list] = None,
                 weights_version: Optional[int] = None):
        self.request_id = request_id
        self.tokens = tokens
        self.error = error
        self.ttft_ms = ttft_ms
        # Weight hot-swap (serve/swap.py): the checkpoint step this
        # response's tokens were generated under.  The router tracks it
        # per replica — a prefix-directory entry recorded under one
        # version must not route a request to the same replica after it
        # flipped (stale KV against new weights would be silently
        # wrong), so a version change invalidates the entries.
        self.weights_version = weights_version
        # KV migration outcome: the decode replica now carrying the
        # generation (the router collects the final tokens there) and
        # the transfer's wall time (the bench's migration-overhead
        # signal).
        self.migrated_to = migrated_to
        self.migrate_ms = migrate_ms
        # Eviction notifications piggybacked for the router's global
        # prefix directory: leading-block keys this replica no longer
        # holds (serve/kv/pool.py::drain_evicted_keys).
        self.evicted_prefixes = evicted_prefixes


class CancelRequest:
    """Abandon ``request_id`` on this replica (router failover: the
    request was re-run elsewhere; answered with ``AckResponse``)."""

    def __init__(self, request_id: str):
        self.request_id = request_id


class StatsRequest:
    pass


class StatsResponse:
    def __init__(self, stats: dict):
        self.stats = stats


class SwapRequest:
    """Hot-swap this replica's weights to checkpoint ``step`` from its
    subscribed store (serve/swap.py; docs/hot_swap.md): diff-pull the
    changed shards, digest-verify, stage, flip at the batcher's swap
    barrier.  The fleet controller's rolling swap sends these bounded
    by ``HVD_TPU_SWAP_MAX_CONCURRENT``.  Answered with
    :class:`SwapResponse`; every failure leaves the old weights
    serving."""

    def __init__(self, step: int):
        self.step = int(step)


class RollbackRequest:
    """Instant rollback: re-point this replica at any journaled step
    still intact in the store, through the SAME staged-flip path a
    forward swap uses (the only difference: the newer-step check is
    waived).  Answered with :class:`SwapResponse`."""

    def __init__(self, step: int):
        self.step = int(step)


class SwapResponse:
    """Outcome of a :class:`SwapRequest`/:class:`RollbackRequest`:
    ``error`` is None once the flip committed; ``weights_version`` is
    the version now serving either way (a failed swap reports the OLD
    version — the replica is always on exactly one).  ``pulled_bytes``
    and ``swap_ms`` size the manifest-diff pull."""

    def __init__(self, step: int, error: Optional[str] = None,
                 weights_version: Optional[int] = None,
                 pulled_bytes: int = 0,
                 swap_ms: Optional[float] = None):
        self.step = step
        self.error = error
        self.weights_version = weights_version
        self.pulled_bytes = pulled_bytes
        self.swap_ms = swap_ms


class InferenceServer(BasicService):
    """One serving replica: a batcher behind an authenticated socket.

    ``replica_ranks`` records which mesh slots this replica's model
    spans (its data-parallel process-set group; see
    ``serve/router.py::replica_slot_groups``) — advertised in stats so
    fleet tooling can map replicas back onto the mesh.
    """

    def __init__(self, batcher: ContinuousBatcher, key: bytes,
                 name: str = "serve", host: str = "0.0.0.0",
                 nics: Optional[List[str]] = None,
                 replica_ranks: Optional[List[int]] = None,
                 start_batcher: bool = True,
                 migrate_chunk_bytes: Optional[int] = None,
                 swap_store: Optional[str] = None,
                 subscribe: bool = True,
                 tp_peers: Optional[List[Tuple[str, List[Tuple[str,
                                                               int]]]]] = None):
        if tp_peers:
            raise NotImplementedError(TP_SERVING_ITEM)
        super().__init__(name, key, host=host, nics=nics)
        self._batcher = batcher
        self.replica_ranks = list(replica_ranks) if replica_ranks else None
        # Zero-downtime weight hot-swap (serve/swap.py): with a
        # ``swap_store`` directory this replica subscribes to the
        # checkpoint store — polling for newer intact steps when
        # ``subscribe`` is on, and always answering ``SwapRequest`` /
        # ``RollbackRequest`` (the fleet controller's rolling path).
        self.subscriber: Optional[WeightSubscriber] = None
        if swap_store is not None:
            self.subscriber = WeightSubscriber(batcher, swap_store)
            if subscribe:
                self.subscriber.start()
        # Disaggregated fleet: receiver-side migration assembly (any
        # role may adopt) and the sender-side handoff on prefill
        # replicas (serve/fleet/migration.py over this server's key).
        self._migrations = MigrationBuffer()
        self._adopt_lock = threading.Lock()
        self._adopted: "OrderedDict[str, Any]" = OrderedDict()  # guarded-by: _adopt_lock
        if batcher.role == "prefill":
            chunk = int(migrate_chunk_bytes
                        or resolved_config().fleet_migrate_chunk)

            def _migrator(engine, slot, sreq):
                return migrate_slot(engine, slot, sreq, sreq.migrate_to,
                                    self._key, chunk_bytes=chunk)

            batcher.set_migrator(_migrator)
        if start_batcher:
            batcher.start()

    @property
    def dead(self) -> bool:
        return self._batcher.dead

    @property
    def role(self) -> str:
        return self._batcher.role

    def _handle(self, req: Any, client_address) -> Any:
        if isinstance(req, GenerateRequest):
            return self._generate(req)
        if isinstance(req, CancelRequest):
            self._migrations.discard(req.request_id)
            self._batcher.cancel(req.request_id)
            return AckResponse()
        if isinstance(req, KvMigrateRequest):
            return self._kv_migrate(req)
        if isinstance(req, CollectRequest):
            return self._collect(req)
        if isinstance(req, DrainRequest):
            if getattr(req, "cancel", False):
                self._batcher.undrain()
            else:
                self._batcher.drain()
            return AckResponse()
        if isinstance(req, StatsRequest):
            snap = self._batcher.snapshot()
            if self.replica_ranks is not None:
                snap["replica_ranks"] = self.replica_ranks
            return StatsResponse(snap)
        if isinstance(req, SwapRequest):
            return self._swap(req, rollback=False)
        if isinstance(req, RollbackRequest):
            return self._swap(req, rollback=True)
        return super()._handle(req, client_address)

    def _swap(self, req, rollback: bool) -> SwapResponse:
        """Drive one hot-swap (or rollback) through the subscriber.
        Every failure is a terminal per-request answer carrying the
        version STILL serving — a failed swap is an economics event,
        never a health strike."""
        sub = self.subscriber
        engine = self._batcher.engine
        if sub is None:
            return SwapResponse(req.step, error="no_swap_store",
                                weights_version=engine.weights_version)
        try:
            info = sub.swap_to_info(req.step, rollback=rollback)
        except SwapRejectedError as e:
            return SwapResponse(req.step, error=f"rejected: {e}",
                                weights_version=engine.weights_version)
        except SwapAbandonedError as e:
            return SwapResponse(req.step, error=f"abandoned: {e}",
                                weights_version=engine.weights_version)
        except (SwapFailedError, ReplicaKilledError) as e:
            return SwapResponse(req.step, error=f"failed: {e}",
                                weights_version=engine.weights_version)
        # ``ms`` was measured INSIDE the swap lock — re-timing here
        # would bill a concurrent poller swap's wait to this one.
        return SwapResponse(
            req.step, weights_version=int(info["version"]),
            pulled_bytes=int(info.get("pulled_bytes", 0)),
            swap_ms=info.get("ms", 0.0))

    def _kv_migrate(self, req: KvMigrateRequest) -> KvMigrateResponse:
        """One migration frame: buffer; on the final frame verify the
        digests and adopt the request into the batcher.  Every error is
        a terminal per-transfer answer — the sender falls back to
        decoding locally, so nothing here may strike this replica."""
        try:
            done = self._migrations.add(req)
        except MigrationError as e:
            return KvMigrateResponse(req.request_id, error=str(e))
        if done is None:
            return KvMigrateResponse(req.request_id)   # frame buffered
        manifest, k, v = done
        try:
            sr = self._batcher.adopt(manifest, k, v)
        except QueueFullError:
            return KvMigrateResponse(req.request_id, error="busy")
        except ReplicaDrainingError:
            return KvMigrateResponse(req.request_id, error="draining")
        except ReplicaKilledError:
            return KvMigrateResponse(req.request_id, error="replica_dead")
        except (PromptTooLongError, ValueError) as e:
            return KvMigrateResponse(req.request_id,
                                     error=f"invalid_migration: {e}")
        with self._adopt_lock:
            self._adopted[sr.request_id] = sr
            while len(self._adopted) > 1024:
                self._adopted.popitem(last=False)
        return KvMigrateResponse(req.request_id)

    def _collect(self, creq: CollectRequest) -> GenerateResponse:
        """Block until the adopted (migrated-in) request finishes and
        answer with its full token stream — the router's decode half of
        the admit→prefill→migrate→decode pipeline."""
        with self._adopt_lock:
            sr = self._adopted.get(creq.request_id)
        if sr is None:
            # Adoption lost (restart, cancel, LRU overflow): the router
            # re-routes to a recompute path.
            return GenerateResponse(creq.request_id, None,
                                    error="unknown_request")
        while not sr.done.wait(timeout=30.0):
            if self._batcher.dead:
                sr.finish(error="replica_dead")   # idempotent
        with self._adopt_lock:
            self._adopted.pop(creq.request_id, None)
        if sr.error is not None:
            return GenerateResponse(creq.request_id, None, error=sr.error)
        ttft_ms = None
        if sr.first_token_at is not None:
            ttft_ms = round((sr.first_token_at - sr.submitted_at) * 1e3, 3)
        return GenerateResponse(
            creq.request_id, sr.tokens, ttft_ms=ttft_ms,
            evicted_prefixes=self._drain_evictions(),
            weights_version=(sr.weights_version
                             if sr.weights_version is not None
                             else self._batcher.engine.weights_version))

    def _drain_evictions(self) -> Optional[list]:
        keys = self._batcher.engine.drain_evicted_prefixes()
        return [list(k) for k in keys] or None

    def _generate(self, req: GenerateRequest) -> GenerateResponse:
        # Fault site "serve" (drop/delay) — before admission, so a
        # dropped request costs the replica nothing.
        if faults_mod._active is not None:
            if faults_mod.on_serve_request(type(req).__name__) == "drop":
                raise DropConnection()
        sampling = SamplingParams(
            max_new_tokens=req.max_new_tokens,
            temperature=req.temperature, top_k=req.top_k,
            stop_token=req.stop_token,
            spec=bool(getattr(req, "spec", False)))
        try:
            sr = self._batcher.submit(
                req.prompt, sampling, request_id=req.request_id,
                deadline_s=req.deadline_s,
                migrate_to=getattr(req, "migrate_to", None),
                tenant=getattr(req, "tenant", None),
                qos_class=getattr(req, "qos_class", None))
        except BudgetExhaustedError as e:
            # Typed retriable rejection (docs/qos.md): the CLIENT backs
            # off retry_after_s — the router must neither strike this
            # replica nor re-run the request elsewhere (the budget is
            # policy, not health).
            return GenerateResponse(
                req.request_id, None,
                error=f"budget_exhausted: retry_after_s="
                      f"{e.retry_after_s:.2f}")
        except QueueFullError:
            return GenerateResponse(req.request_id, None, error="busy")
        except ReplicaDrainingError:
            return GenerateResponse(req.request_id, None,
                                    error="draining")
        except ReplicaKilledError:
            return GenerateResponse(req.request_id, None,
                                    error="replica_dead")
        except PromptTooLongError as e:
            return GenerateResponse(req.request_id, None,
                                    error=f"prompt_too_long: {e}")
        except ValueError as e:
            # Caller error (empty prompt etc.) — answered terminally; an
            # escaped exception here would close the socket mid-frame
            # and make the router misread a poison request as a replica
            # crash (and bench the healthy fleet retrying it).
            return GenerateResponse(req.request_id, None,
                                    error=f"invalid_request: {e}")
        # The batcher guarantees `done` fires: completion (bounded by
        # the max-tokens cap), deadline expiry, cancellation, or
        # replica death (_die).  Wait in a loop rather than under one
        # arbitrary cap — a deadline-less long generation returning a
        # TRUNCATED token list as a success would be silent data loss.
        # The only unguaranteed case is a batcher thread wedged inside
        # the engine; detect it via `dead` and fail the request loudly.
        while not sr.done.wait(timeout=30.0):
            if self._batcher.dead:
                sr.finish(error="replica_dead")   # idempotent
        if sr.error is not None:
            return GenerateResponse(req.request_id, None, error=sr.error)
        ttft_ms = None
        if sr.first_token_at is not None:
            ttft_ms = round((sr.first_token_at - sr.submitted_at) * 1e3, 3)
        return GenerateResponse(
            req.request_id, sr.tokens, ttft_ms=ttft_ms,
            migrated_to=(sr.migrate_to[0]
                         if sr.migrated and sr.migrate_to else None),
            migrate_ms=sr.migrate_ms,
            evicted_prefixes=self._drain_evictions(),
            weights_version=(sr.weights_version
                             if sr.weights_version is not None
                             else self._batcher.engine.weights_version))

    def shutdown(self) -> None:
        if self.subscriber is not None:
            self.subscriber.stop()
        self._batcher.stop()
        super().shutdown()


def serve_addresses(server: InferenceServer) -> List[Tuple[str, int]]:
    """The replica's advertised (ip, port) candidates — what a deployer
    writes into the router's :class:`~.router.ReplicaSpec`."""
    return server.addresses()
