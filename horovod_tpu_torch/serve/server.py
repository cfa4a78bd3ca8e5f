"""Replica-local serving endpoint on the runner's RPC stack.

Counterpart of ``horovod_tpu/serve/server.py``.  One
:class:`InferenceServer` fronts one continuous-batching replica: it
reuses ``runner/common/network.py``'s :class:`BasicService` (threaded
TCP, HMAC-authenticated frames — the launcher's secret, so a serving
fleet needs no second credential system).  Each connection handler
blocks on its request's completion event while the batcher thread
schedules.

Error taxonomy on the wire (``GenerateResponse.error``):

* ``busy`` — admission queue full (backpressure; the router retries
  elsewhere after backoff)
* ``deadline_exceeded`` — the request's own deadline expired (terminal)
* ``replica_killed`` / ``replica_dead`` — this replica died mid-flight
  / is refusing work (the router strikes it and re-runs on a survivor)
* ``prompt_too_long: ...`` / ``invalid_request: ...`` — caller error
  (terminal)
* ``budget_exhausted: retry_after_s=...`` — the tenant's token budget
  (terminal for the router, retriable by the client)
* ``unsupported: ...`` — a request of a tier this port does not hold
  yet (terminal)

The ``serve`` fault site's ``drop``/``delay`` modes fire here, before
admission: a dropped request closes the connection with no response
(:class:`DropConnection`).

Waiting for their slices of the port (ROADMAP.md, queue A item 4): the
weight hot-swap from a checkpoint store (``swap_store=``,
:class:`SwapRequest` / :class:`RollbackRequest`), the fleet's KV
migration (``migrate_chunk_bytes=``, a ``GenerateRequest`` carrying
``migrate_to``) and tensor-parallel replicas (``tp_peers=``).  Such a
keyword raises ``NotImplementedError``; such a request is answered with
an ``unsupported`` error.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

from .. import faults as faults_mod
from ..models.transformer import TP_SERVING_ITEM
from ..runner.common.network import (AckResponse, BasicService,
                                     DrainRequest, DropConnection)
from .batcher import (FLEET_ITEM, ContinuousBatcher, QueueFullError,
                      ReplicaDrainingError, ReplicaKilledError)
from .engine import PromptTooLongError, SamplingParams
from .qos import BudgetExhaustedError

SWAP_ITEM = ("weight hot-swap from a checkpoint store (serve/swap.py) "
             "waits for the next serving slice of the port: ROADMAP.md, "
             "queue A item 4")


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
        # The fleet's decode target for a prefill replica's handoff;
        # this port answers a request carrying one ``unsupported``.
        self.migrate_to = migrate_to
        # The weighted-fair flow this request rides (serve/qos/).
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
        # The weights version this response's tokens were generated
        # under: the router drops a replica's prefix-directory entries
        # when it changes (stale KV against new weights would be wrong).
        self.weights_version = weights_version
        # The fleet's migration outcome (always None in this port).
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
    """Hot-swap this replica's weights to checkpoint ``step`` (the swap
    slice); answered ``unsupported`` with :class:`SwapResponse`."""

    def __init__(self, step: int):
        self.step = int(step)


class RollbackRequest:
    """Roll this replica back to journaled step ``step`` (the swap
    slice); answered ``unsupported`` with :class:`SwapResponse`."""

    def __init__(self, step: int):
        self.step = int(step)


class SwapResponse:
    """Outcome of a :class:`SwapRequest`/:class:`RollbackRequest`:
    ``error`` is None once the flip committed; ``weights_version`` is
    the version serving either way."""

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

    ``replica_ranks`` records which ranks this replica's model spans
    (its process-set group; see ``serve/router.py::
    replica_slot_groups``) — advertised in stats."""

    def __init__(self, batcher: ContinuousBatcher, key: bytes,
                 name: str = "serve", host: str = "0.0.0.0",
                 nics: Optional[List[str]] = None,
                 replica_ranks: Optional[List[int]] = None,
                 start_batcher: bool = True,
                 migrate_chunk_bytes: Optional[int] = None,
                 swap_store: Optional[str] = None,
                 tp_peers: Optional[List[Tuple[str, List[Tuple[str,
                                                               int]]]]] = None):
        if swap_store is not None:
            raise NotImplementedError(SWAP_ITEM)
        if migrate_chunk_bytes is not None:
            raise NotImplementedError(FLEET_ITEM)
        if tp_peers:
            raise NotImplementedError(TP_SERVING_ITEM)
        super().__init__(name, key, host=host, nics=nics)
        self._batcher = batcher
        self.replica_ranks = list(replica_ranks) if replica_ranks else None
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
            self._batcher.cancel(req.request_id)
            return AckResponse()
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
        if isinstance(req, (SwapRequest, RollbackRequest)):
            return SwapResponse(
                req.step, error=f"unsupported: {SWAP_ITEM}",
                weights_version=self._batcher.engine.weights_version)
        return super()._handle(req, client_address)

    def _drain_evictions(self) -> Optional[list]:
        keys = self._batcher.engine.drain_evicted_prefixes()
        return [list(k) for k in keys] or None

    def _generate(self, req: GenerateRequest) -> GenerateResponse:
        # Fault site "serve" (drop/delay) — before admission, so a
        # dropped request costs the replica nothing.
        if faults_mod._active is not None:
            if faults_mod.on_serve_request(type(req).__name__) == "drop":
                raise DropConnection()
        if getattr(req, "migrate_to", None) is not None:
            return GenerateResponse(req.request_id, None,
                                    error=f"unsupported: {FLEET_ITEM}")
        sampling = SamplingParams(
            max_new_tokens=req.max_new_tokens,
            temperature=req.temperature, top_k=req.top_k,
            stop_token=req.stop_token,
            spec=bool(getattr(req, "spec", False)))
        try:
            sr = self._batcher.submit(
                req.prompt, sampling, request_id=req.request_id,
                deadline_s=req.deadline_s,
                tenant=getattr(req, "tenant", None),
                qos_class=getattr(req, "qos_class", None))
        except BudgetExhaustedError as e:
            # Typed retriable rejection: the CLIENT backs off
            # retry_after_s — the router must neither strike this
            # replica nor re-run the request elsewhere.
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
            # escaped exception would close the socket mid-frame and
            # make the router misread a poison request as a crash.
            return GenerateResponse(req.request_id, None,
                                    error=f"invalid_request: {e}")
        # The batcher guarantees `done` fires: completion, deadline
        # expiry, cancellation, or replica death.  A batcher thread
        # wedged inside the engine is caught via `dead`.
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
            evicted_prefixes=self._drain_evictions(),
            weights_version=(sr.weights_version
                             if sr.weights_version is not None
                             else self._batcher.engine.weights_version))

    def shutdown(self) -> None:
        self._batcher.stop()
        super().shutdown()


def serve_addresses(server: InferenceServer) -> List[Tuple[str, int]]:
    """The replica's advertised (ip, port) candidates — what a deployer
    writes into the router's :class:`~.router.ReplicaSpec`."""
    return server.addresses()
