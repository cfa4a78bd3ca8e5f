"""Continuous-batching scheduler: admission, deadlines, backpressure.

Counterpart of ``horovod_tpu/serve/batcher.py``.  The disaggregated
fleet's handoff (``set_migrator`` on a prefill replica, ``adopt`` on the
receiving one) runs as the reference's; tensor-parallel lockstep
(``set_lockstep``) waits for its slice of the port (ROADMAP.md, queue A
item 4) and raises ``NotImplementedError``.  A ``prefill``-role replica
with no migrator serves its requests itself, as the reference's does.

The scheduling loop interleaves prefill and decode over the engine's
slot batch: each :meth:`ContinuousBatcher.step` admits up to
``max_prefill_per_step`` queued requests into free slots (one prefill
each), then runs ONE decode for every active slot.  A long-running
generation therefore never blocks admission, and a fresh request's
TTFT is bounded by one decode's worth of head-of-line blocking — the
continuous-batching property.

Overload policy is **explicit backpressure**: the admission queue is
bounded and a full queue rejects (:class:`QueueFullError`) instead of
queueing unboundedly — at "millions of users" scale an unbounded queue
converts overload into latency collapse and OOM; a reject converts it
into a router-visible signal that shifts load to another replica.

The admission queue is the **weighted-fair QoS scheduler**
(serve/qos/; docs/qos.md): every ``(tenant, class)`` pair is one
stride-scheduled flow, per-tenant token buckets bound sustained
consumption (typed ``BudgetExhaustedError`` rejections), queued
deadline expiry rides a min-heap instead of a queue walk, and an
interactive request about to miss its deadline/TTFT-SLO preempts the
youngest batch generation — its KV parks in the paged prefix cache and
the resumption replays only the non-resident tail, token-identical to
the uninterrupted run.  A single unconfigured flow is exact FIFO, so
default behavior is unchanged.

Fault site ``serve:mode=kill`` fires at the decode dispatch (each
event = one real decode step): the batcher dies mid-decode exactly the
way a preempted replica does, failing queued + in-flight requests so
the router can re-run them on a survivor.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Dict, List, Optional, Sequence

from .. import faults as faults_mod
from ..obs import flight as flight_mod
from ..obs import instrument as _obs
from ..obs import trace as trace_mod
from ..utils.logging import get_logger
from ..models.transformer import TP_SERVING_ITEM
from .engine import InferenceEngine, SamplingParams, resolved_config
from .metrics import ServingStats
from .qos import QosPolicy, QosQueue, validate_class
from .qos import preempt as preempt_mod

logger = get_logger(__name__)

_ids = itertools.count()

class QueueFullError(RuntimeError):
    """Admission queue at capacity — reject-when-full backpressure."""


class ReplicaKilledError(RuntimeError):
    """The ``serve:mode=kill`` fault fired mid-decode (or the batcher
    was stopped with requests in flight)."""


class ReplicaDrainingError(RuntimeError):
    """This replica is draining (drain-and-retire lifecycle): in-flight
    work finishes, new admissions answer ``draining`` on the wire so
    the router shifts load elsewhere without striking it."""


@dataclasses.dataclass
class ServeRequest:
    """One in-flight generation; ``done`` fires exactly once, with
    either ``tokens`` complete or ``error`` set."""

    request_id: str
    prompt: List[int]
    sampling: SamplingParams
    deadline: Optional[float] = None       # absolute time.monotonic()
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    error: Optional[str] = None
    # Resident-prefix tokens (admission-time probe, refined to the
    # actual binding at prefill) — the cache-hit/miss signal the bench
    # and the router's affinity layer read.
    prefix_hit_tokens: int = 0
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    # Trace context captured at submit (the server handler's span): the
    # batcher thread reconstructs queued/prefill/decode phase spans
    # against it, so the request's trace crosses the thread handoff.
    trace_ctx: Optional[tuple] = None
    # Disaggregated fleet (serve/fleet/): the decode target the router
    # asked this (prefill) replica to migrate to, the wire-received KV
    # payload on the adopting (decode) side, and the migration outcome
    # the response frame reports.
    migrate_to: Optional[tuple] = None      # (name, [(ip, port), ...])
    kv_import: Optional[tuple] = None       # (manifest, k_blocks, v_blocks)
    migrated: bool = False
    migrate_ms: Optional[float] = None
    # Weight hot-swap (serve/swap.py): the version this request's
    # generation ran under, captured at slot binding — the response
    # must report THIS, not the engine's version at response-build
    # time (a flip can land between the last token and the reply).
    weights_version: Optional[int] = None
    # Multi-tenant QoS (serve/qos/; docs/qos.md): the flow this request
    # rides in the weighted-fair queue, its admission budget charge
    # (refunded pro-rata at completion), and the preemption carry —
    # ``resume_state`` is ``(emitted tokens, engine RNG snapshot)`` set
    # when a batch generation is evicted-and-requeued so resumption
    # replays only the tail, token-identical to the uninterrupted run.
    tenant: str = "default"
    qos_class: str = "standard"
    budget_charged: float = 0.0
    preemptions: int = 0
    resume_state: Optional[tuple] = None

    def finish(self, error: Optional[str] = None) -> None:
        if self.done.is_set():
            return
        self.error = error
        self.finished_at = time.monotonic()
        self.done.set()


class ContinuousBatcher:
    """Slot scheduler over one :class:`InferenceEngine`.

    Drive it synchronously (:meth:`step`, deterministic — what the
    tests and the bench do) or as a daemon thread (:meth:`start` /
    :meth:`stop` — what the server does).
    """

    def __init__(self, engine: InferenceEngine, *,
                 max_queue: Optional[int] = None,
                 max_prefill_per_step: int = 1,
                 default_deadline_s: Optional[float] = None,
                 role: Optional[str] = None,
                 qos_policy: Optional[QosPolicy] = None,
                 qos_preempt: Optional[bool] = None,
                 qos_slo_ttft_ms: Optional[float] = None):
        cfg = resolved_config()
        self.engine = engine
        self.max_queue = int(max_queue if max_queue is not None
                             else cfg.serve_queue_depth)
        self.max_prefill_per_step = max(1, max_prefill_per_step)
        self.default_deadline_s = (
            default_deadline_s if default_deadline_s is not None
            else cfg.serve_deadline_seconds)
        self.max_new_tokens_cap = cfg.serve_max_new_tokens
        # Fleet role (serve/fleet/): a prefill replica hands each
        # request's KV to its decode target after the first token; the
        # role is a scheduling policy, not a capability — every replica
        # can run a full generation (the recompute fallback path).
        self.role = (role or cfg.fleet_role).lower()
        if self.role not in ("prefill", "decode", "unified"):
            raise ValueError(f"unknown fleet role {self.role!r}; "
                             f"expected prefill|decode|unified")
        self._migrator = None    # set by the server on prefill replicas
        self.stats = ServingStats(weights_version=engine.weights_version)
        # Multi-tenant QoS (serve/qos/): flow weights + tenant budgets
        # from the HVD_TPU_QOS_* knobs; the admission queue is the
        # weighted-fair scheduler (a single unconfigured flow is exact
        # FIFO, so default behavior is unchanged), and deadline-aware
        # preemption is gated on the paged cache — eviction is only
        # cheap when the KV survives in the prefix index.
        self._policy = (qos_policy if qos_policy is not None
                        else QosPolicy.from_config(cfg))
        self._preempt_enabled = (
            bool(qos_preempt if qos_preempt is not None
                 else cfg.qos_preempt)
            and engine.kv_mode == "paged")
        # Interactive TTFT SLO (HVD_TPU_QOS_SLO_TTFT_MS): with it set,
        # preemption fires aggressively enough to land interactive
        # first tokens inside the budget; 0 = deadline feasibility only.
        self._slo_ttft_s = float(
            qos_slo_ttft_ms if qos_slo_ttft_ms is not None
            else cfg.qos_slo_ttft_ms) / 1e3
        self._lock = threading.Lock()
        self._queue: QosQueue = QosQueue(self._policy)  # guarded-by: _lock
        self._slots: Dict[int, ServeRequest] = {}    # guarded-by: _lock
        self._killed: Optional[str] = None           # guarded-by: _lock
        self._draining = False                       # guarded-by: _lock
        # Weight hot-swap barrier (serve/swap.py): a pending flip holds
        # admission, lets in-flight generations run dry, then runs at
        # the step boundary — no request ever sees mixed weights.
        self._pending_flip: Optional[tuple] = None   # guarded-by: _lock
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._wake = threading.Event()

    # --- admission ----------------------------------------------------------

    @property
    def dead(self) -> bool:
        # Locked read: consulted from RPC handler + router threads
        # while _die() may be flipping it.
        with self._lock:
            return self._killed is not None

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining

    def drain(self) -> None:
        """Enter the drain-and-retire lifecycle: stop admitting, let
        queued + in-flight work finish (the fleet controller retires
        the replica once it runs dry)."""
        with self._lock:
            if self._draining or self._killed is not None:
                return
            self._draining = True
        logger.info("serving replica draining (no new admissions)")

    def undrain(self) -> None:
        """Cancel a drain and admit again — the abandon path when a
        retire turns out impossible (e.g. the fleet's last replica): a
        replica left draining with no peers would starve the fleet
        forever."""
        with self._lock:
            if not self._draining:
                return
            self._draining = False
        logger.info("serving replica drain cancelled (admitting again)")

    # --- weight hot-swap barrier (serve/swap.py; docs/hot_swap.md) ----------

    def flip_at_barrier(self, fn, timeout: float = 60.0):
        """Run ``fn`` (the engine's ``commit_staged``) at the next step
        boundary with NO generation in flight, and block until it ran.

        While the flip is pending the scheduler admits nothing (queued
        requests wait — backpressure, never loss) and keeps decoding,
        so in-flight generations finish on the version they started on;
        the moment the slots run dry the flip executes between decode
        bursts and admission resumes.  Returns ``fn``'s result; raises
        ``TimeoutError`` when the slots never drained inside
        ``timeout`` (the flip is withdrawn — old weights keep serving)
        and ``ReplicaKilledError`` when the replica died instead of
        flipping."""
        with self._lock:
            if self._killed is not None:
                raise ReplicaKilledError(self._killed)
            if self._pending_flip is not None:
                raise RuntimeError("a weight flip is already pending on "
                                   "this replica")
            flip = (fn, threading.Event(), {})
            self._pending_flip = flip
        self._wake.set()
        _, event, holder = flip
        if not event.wait(timeout=timeout):
            with self._lock:
                withdrawn = self._pending_flip is flip
                if withdrawn:
                    self._pending_flip = None
            if withdrawn:
                raise TimeoutError(
                    f"swap barrier not reached within {timeout}s "
                    f"(in-flight generations never drained)")
            # The flip was CLAIMED between our wait timing out and the
            # withdraw — it will run (or die); a completed flip must
            # not read as a timeout, and an empty holder must never
            # read as success (int(None) downstream).
            if not event.wait(timeout=60.0):
                raise TimeoutError(
                    "flip claimed at the barrier but still executing "
                    "after 60s")
        if "error" in holder:
            if holder["error"].startswith("flip_failed"):
                raise RuntimeError(holder["error"])
            raise ReplicaKilledError(holder["error"])
        return holder.get("result")

    def _run_flip(self, flip) -> None:
        """Execute a CLAIMED flip (batcher thread, slots empty, already
        removed from ``_pending_flip`` — a timed-out waiter can no
        longer withdraw it).  The ``swap:mode=kill-mid-flip`` fault
        fires here — the last instant before the atomic reference swap,
        so a killed replica is still on exactly one version and fails
        over like any other death."""
        fn, event, holder = flip
        if faults_mod._active is not None and faults_mod.on_swap_flip():
            reason = "injected replica kill mid-flip"
            # The flip is already claimed, so _die cannot see it — the
            # waiter learns here, before the death unwinds.
            holder.setdefault("error", f"replica_killed: {reason}")
            event.set()
            self._die(reason)
            raise ReplicaKilledError(reason)
        try:
            holder["result"] = fn()
            if isinstance(holder["result"], int):
                self.stats.set_weights_version(holder["result"])
        except Exception as e:   # defensive: a failed flip keeps old weights
            holder["error"] = f"flip_failed: {e}"
            logger.exception("weight flip failed; serving continues on "
                             "the old version")
        finally:
            event.set()

    def set_migrator(self, migrator) -> None:
        """Install the prefill→decode handoff callable
        (``migrator(engine, slot, req) -> bool``; the server wires
        ``serve/fleet/migration.migrate_slot`` here on prefill
        replicas)."""
        self._migrator = migrator

    def set_lockstep(self, lockstep) -> None:
        """Tensor-parallel follower dispatch: not ported yet."""
        raise NotImplementedError(TP_SERVING_ITEM)

    def submit(self, prompt: Sequence[int],
               sampling: Optional[SamplingParams] = None,
               request_id: Optional[str] = None,
               deadline_s: Optional[float] = None,
               migrate_to: Optional[tuple] = None,
               tenant: Optional[str] = None,
               qos_class: Optional[str] = None) -> ServeRequest:
        """Enqueue one generation.  Raises :class:`QueueFullError` at
        capacity, :class:`ReplicaKilledError` on a dead replica,
        :class:`ReplicaDrainingError` on a draining one and
        :class:`~horovod_tpu.serve.qos.BudgetExhaustedError` when the
        tenant's token bucket cannot cover the request; oversized
        prompts raise :class:`PromptTooLongError` up front (admitting
        them would waste a slot to fail later).  ``migrate_to`` is the
        decode target a prefill-role replica hands this request's KV to
        after the first token; ``tenant``/``qos_class`` place the
        request in the weighted-fair scheduler (docs/qos.md)."""
        sampling = sampling or SamplingParams()
        qos_class = validate_class(qos_class)
        if sampling.max_new_tokens > self.max_new_tokens_cap:
            sampling = dataclasses.replace(
                sampling, max_new_tokens=self.max_new_tokens_cap)
        # PromptTooLongError / out-of-vocab ValueError early — a poison
        # prompt must never reach the shared KV pool (engine docstring).
        self.engine.check_prompt_tokens(prompt)
        # Admission-time prefix lookup: how much of this prompt's K/V
        # is already resident (serve/kv/).  Recorded before queueing so
        # backpressure decisions and the bench see the signal even for
        # requests that later expire; the binding at prefill refines it.
        hit = self.engine.prefix_probe(prompt)
        limit = (deadline_s if deadline_s is not None
                 else self.default_deadline_s)
        req = ServeRequest(
            request_id=request_id or f"req-{next(_ids)}",
            prompt=list(prompt), sampling=sampling,
            deadline=(time.monotonic() + limit) if limit and limit > 0
            else None,
            submitted_at=time.monotonic(),
            prefix_hit_tokens=hit,
            trace_ctx=trace_mod.current(),
            migrate_to=migrate_to,
            tenant=(tenant or "default"), qos_class=qos_class)
        self._admit(req)
        return req

    def adopt(self, manifest: dict, k_blocks, v_blocks) -> ServeRequest:
        """Adopt a migrated request (serve/fleet/migration.py): the
        digest-verified KV payload is queued like a submission, and the
        batcher thread binds it into the pool in place of a prefill —
        generation continues token-identically from the sender's
        state.  Same admission contract as :meth:`submit` (queue bound,
        killed/draining refusal, poison-prompt rejection)."""
        s = manifest["sampling"]
        sampling = SamplingParams(
            max_new_tokens=int(s["max_new_tokens"]),
            temperature=float(s["temperature"]), top_k=int(s["top_k"]),
            stop_token=s["stop_token"], spec=bool(s["spec"]))
        prompt = [int(t) for t in manifest["prompt"]]
        if self.engine.kv_mode != "paged":
            raise ValueError("KV adoption requires the paged cache "
                             "(HVD_TPU_SERVE_KV=paged)")
        # Poison defense on the receiving side too: the sender already
        # validated, but a pool-poisoning prompt must die at EVERY
        # admission boundary, not only the first.
        self.engine.check_prompt_tokens(prompt)
        # Mixed-version guard (serve/swap.py): imported KV was computed
        # under the sender's weights; continuing it under different
        # ones would be silently wrong.  The refusal sends the request
        # back to the sender's pristine KV + matching weights.
        sender_v = manifest.get("weights_version")
        if sender_v is not None and int(sender_v) != \
                self.engine.weights_version:
            raise ValueError(
                f"version_mismatch: migrated KV from weights version "
                f"{sender_v}, this replica serves "
                f"{self.engine.weights_version}")
        if not manifest.get("tokens"):
            raise ValueError("migration manifest carries no emitted "
                             "tokens — nothing to continue from")
        limit = manifest.get("deadline_s")
        now = time.monotonic()
        req = ServeRequest(
            request_id=manifest["request_id"], prompt=prompt,
            sampling=sampling,
            deadline=(now + limit) if limit and limit > 0 else None,
            submitted_at=now,
            trace_ctx=trace_mod.current(),
            kv_import=(manifest, k_blocks, v_blocks),
            tenant=manifest.get("tenant", "default"),
            qos_class=validate_class(manifest.get("qos_class")))
        self._admit(req)
        return req

    def _admit(self, req: ServeRequest) -> None:
        # Tenant budget BEFORE the queue bound: an over-budget request
        # must see its typed rejection (retry_after), not be misread as
        # replica backpressure.  The charge is the reservation — prompt
        # plus the generation cap — with the unused part refunded at
        # completion; the `qos:mode=flood` fault waives it (one tenant
        # flooding past its budget, the WFQ-fairness drill).
        need = len(req.prompt) + req.sampling.max_new_tokens
        if faults_mod._active is not None and faults_mod.on_qos_admit():
            need = 0
        if need > 0:
            try:
                req.budget_charged = self._policy.charge(req.tenant, need)
            except Exception:
                self.stats.record_budget_rejected(req.tenant)
                _obs.on_qos_budget_reject(req.tenant)
                raise
        try:
            with self._lock:
                if self._killed is not None:
                    raise ReplicaKilledError(self._killed)
                if self._draining:
                    raise ReplicaDrainingError(
                        "replica draining (no new admissions)")
                if len(self._queue) >= self.max_queue:
                    self.stats.record_rejected()
                    raise QueueFullError(
                        f"admission queue full ({self.max_queue} "
                        f"waiting)")
                self._queue.push(req)
        except Exception:
            # A refused admission must hand the reservation back — the
            # tokens were never going to be served.
            self._policy.refund(req.tenant, req.budget_charged)
            req.budget_charged = 0.0
            raise
        self._wake.set()

    def cancel(self, request_id: str) -> bool:
        """Abandon a queued or in-flight request (router failover: the
        caller re-ran it elsewhere, so finishing it here would only
        burn a slot producing an answer nobody reads).  Returns True
        when something was cancelled."""
        target_slot = None
        with self._lock:
            req = self._queue.remove(request_id)
            if req is None:
                for slot, r in self._slots.items():
                    if r.request_id == request_id:
                        target_slot, req = slot, r
                        break
                if target_slot is not None:
                    del self._slots[target_slot]
        if req is None:
            return False
        if target_slot is not None:
            self.engine.release(target_slot)
        self._settle_budget(req)
        req.finish(error="cancelled")
        return True

    # --- scheduling ---------------------------------------------------------

    def _expire(self, now: float) -> None:
        # Queued expiry is the deadline min-heap (O(expired · log n) —
        # one peek when nothing expired, never a queue walk); in-flight
        # expiry stays a scan, bounded by max_slots.
        with self._lock:
            queued = self._queue.pop_expired(now)
            running = [(s, r) for s, r in self._slots.items()
                       if r.deadline is not None and now > r.deadline]
            for s, r in running:
                del self._slots[s]
                self.engine.release(s)
        for r in queued + [r for _, r in running]:
            self._settle_budget(r)
            self.stats.record_expired(r.qos_class)
            r.finish(error="deadline_exceeded")

    def _settle_budget(self, req: ServeRequest) -> None:
        """Refund the unused part of the admission reservation exactly
        once (any terminal path: completion, expiry, cancel, death)."""
        charged, req.budget_charged = req.budget_charged, 0.0
        if charged > 0:
            used = len(req.prompt) + len(req.tokens)
            self._policy.refund(req.tenant, charged - used)

    def _record_phase(self, req: ServeRequest, name: str,
                      start_mono: float, end_mono: float, **args) -> None:
        """One reconstructed phase span on the request's trace (the
        batcher thread has no ambient context — phases are parented to
        the context captured at submit, with monotonic timestamps
        re-anchored onto the span clock)."""
        if req.trace_ctx is None or not trace_mod.enabled():
            return
        now_us, now_mono = trace_mod.now_us(), time.monotonic()
        start_us = now_us - (now_mono - start_mono) * 1e6
        trace_mod.record_span(name, parent=req.trace_ctx,
                              start_us=start_us,
                              dur_us=(end_mono - start_mono) * 1e6,
                              args=args or None)

    def _finish_slot(self, slot: int, req: ServeRequest) -> None:
        with self._lock:
            self._slots.pop(slot, None)
        self.engine.release(slot)
        # Stats and trace record BEFORE `done` fires: the instant
        # finish() unblocks the waiting RPC handler, a client can get
        # its response and scrape stats — a request its own caller sees
        # completed must already be counted (the drain test's
        # requests_completed race).
        end = time.monotonic()
        if req.first_token_at is not None:
            # The decode phase of this request's trace: first token to
            # completion (what dominates long generations' latency —
            # the critical-path report should name it).
            self._record_phase(req, "hvd_tpu_serve_decode",
                               req.first_token_at, end,
                               tokens=len(req.tokens))
        self._settle_budget(req)
        self.stats.record_request(
            ttft_s=(req.first_token_at or end) - req.submitted_at,
            n_tokens=len(req.tokens),
            total_s=end - req.submitted_at,
            qos_class=req.qos_class, tenant=req.tenant)
        req.finish()

    def _emit(self, slot: int, req: ServeRequest, token: int,
              now: float, check_full: bool = True) -> None:
        if req.done.is_set():
            return   # cancelled/expired concurrently: drop the token
        if req.first_token_at is None:
            req.first_token_at = now
        req.tokens.append(token)
        stop = req.sampling.stop_token
        # ``check_full`` is False for all but the last token of a
        # speculative burst: the engine advanced the slot position past
        # the whole burst, but every emitted token except the last had
        # cache room by construction (acceptance is capped there).
        if (len(req.tokens) >= req.sampling.max_new_tokens
                or (stop is not None and token == stop)
                or (check_full and self.engine.slot_full(slot))):
            self._finish_slot(slot, req)

    def _prefill_into(self, slot: int, req: ServeRequest) -> int:
        """Bring ``req`` into ``slot`` — local prefill, migrated-KV
        import, or preemption resume — and emit its first token(s);
        returns the tokens emitted.  The caller already placed ``req``
        in ``self._slots[slot]``."""
        emitted = 0
        prefill_t0 = time.monotonic()
        imported = req.kv_import is not None
        resumed = req.resume_state is not None
        if resumed and req.weights_version is not None and \
                req.weights_version != self.engine.weights_version:
            # Mixed-version guard (docs/hot_swap.md): the tokens
            # emitted before the preemption came from the weights the
            # replica served THEN; a hot-swap flip landed while the
            # request sat requeued, and resuming under the new weights
            # would splice two models' outputs into one response.
            # Restart from scratch on the current version — the client
            # sees only the final, single-version stream (the flip
            # already flushed the parked KV, so nothing stale is
            # reused either way).
            req.resume_state = None
            req.tokens.clear()
            resumed = False
        try:
            if imported:
                # Migrated-in request: bind the wire-received KV in
                # place of a prefill; the sender's emitted tokens
                # replay below so the token stream is seamless.
                manifest, kb, vb = req.kv_import
                req.kv_import = None    # payload freed after binding
                # Re-check the version at BIND time: a weight flip
                # between adoption and this pop would bind KV from
                # the old weights under the new ones — the
                # import_failed answer routes the request to a
                # recompute instead (never wrong tokens).
                sender_v = manifest.get("weights_version")
                if sender_v is not None and int(sender_v) != \
                        self.engine.weights_version:
                    raise ValueError(
                        f"version_mismatch at bind: KV from "
                        f"weights version {sender_v}, replica now "
                        f"serves {self.engine.weights_version}")
                tokens = [int(t) for t in manifest["tokens"]]
                self.engine.import_slot_kv(
                    slot, req.prompt, kb, vb, tokens[-1],
                    req.sampling, rng=manifest.get("rng"))
            elif resumed:
                # Preempted generation coming back (serve/qos/): the
                # prefix cache covers what survived, the engine
                # recomputes the tail, and nothing already emitted is
                # re-sampled — decode continues where it stopped.
                prev, rng = req.resume_state
                req.resume_state = None
                req.prefix_hit_tokens = self.engine.resume_slot(
                    slot, req.prompt, prev, req.sampling, rng=rng)
                tokens = []
            else:
                tokens = [self.engine.start(slot, req.prompt,
                                            req.sampling)]
        except Exception as e:   # defensive: engine bug ≠ wedged slot
            with self._lock:
                self._slots.pop(slot, None)
            self.engine.release(slot)
            self._settle_budget(req)
            self.stats.record_failed(req.qos_class)
            req.finish(error=(f"import_failed: {e}" if imported
                              else f"prefill_failed: {e}"))
            return 0
        req.weights_version = self.engine.weights_version
        if not imported and not resumed:
            req.prefix_hit_tokens = self.engine.prefix_hit_tokens(slot)
            self.stats.record_prefix(req.prefix_hit_tokens > 0)
        self._record_phase(req, "hvd_tpu_serve_queued",
                           req.submitted_at, prefill_t0)
        self._record_phase(req, "hvd_tpu_serve_prefill", prefill_t0,
                           time.monotonic(),
                           prompt_len=len(req.prompt), slot=slot,
                           prefix_hit=req.prefix_hit_tokens,
                           imported=imported, resumed=resumed)
        if req.done.is_set():
            # Cancelled/expired between admission and prefill
            # completion: cancel() found no active slot to release
            # (engine.start had not activated it yet), so release
            # here or the slot leaks as a ghost forever.
            with self._lock:
                self._slots.pop(slot, None)
            self.engine.release(slot)
            return emitted
        now2 = time.monotonic()
        for j, token in enumerate(tokens):
            emitted += 1
            self._emit(slot, req, token, now2,
                       check_full=(j == len(tokens) - 1))
            if req.done.is_set():
                break
        if (not imported and not resumed and self.role == "prefill"
                and self._migrator is not None
                and req.migrate_to is not None
                and not req.done.is_set()):
            self._handoff(slot, req)
        return emitted

    def _maybe_preempt(self, now: float) -> int:
        """Deadline-aware preemption (serve/qos/preempt.py): when a
        queued interactive request would miss its deadline waiting for
        a natural slot release, evict the youngest batch generation —
        its KV drops to the prefix cache, not the floor — requeue it
        with resume state, and prefill the interactive request into
        the freed slot NOW.  Returns tokens emitted (the interactive
        prefill's first token)."""
        if not self._preempt_enabled:
            return 0
        with self._lock:
            if self.engine.free_slots():
                return 0    # a slot is free: ordinary admission wins
            urgent = self._queue.urgent("interactive")
            if urgent is None:
                return 0
            active = dict(self._slots)
        _, ireq = urgent
        est = preempt_mod.estimate_slot_wait_s(
            active, self.stats.tpot_estimate_s())
        if not preempt_mod.should_preempt(ireq, now, est,
                                          self._slo_ttft_s):
            return 0
        eligible = {s: r for s, r in active.items()
                    if self.engine.can_resume(len(r.prompt),
                                              len(r.tokens))}
        victim = preempt_mod.pick_victim(eligible)
        if victim is None:
            return 0    # nothing preemptible: the deadline may expire
        slot, vreq = victim
        with self._lock:
            # Re-validate both ends under the lock: the victim may have
            # finished and the interactive request may have been
            # cancelled/dispatched since the snapshot.
            if self._slots.get(slot) is not vreq:
                return 0
            if self._queue.remove(ireq.request_id) is None:
                return 0
            self._slots[slot] = ireq
        rng = self.engine.preempt_slot(slot, vreq.prompt, vreq.tokens)
        vreq.resume_state = (list(vreq.tokens), rng)
        vreq.preemptions += 1
        self.stats.record_preempted()
        _obs.on_qos_preempt()
        flight_mod.record("qos_preempted", request=vreq.request_id,
                          emitted=len(vreq.tokens),
                          for_request=ireq.request_id)
        logger.info("preempted batch request %s (%d tokens in) for "
                    "interactive %s", vreq.request_id, len(vreq.tokens),
                    ireq.request_id)
        # Requeue bypasses the admission bound and the budget charge:
        # the victim's tokens are already paid for, and dropping
        # preempted work would turn a scheduling decision into loss.
        with self._lock:
            self._queue.push(vreq)
        return self._prefill_into(slot, ireq)

    def step(self) -> int:
        """One scheduling iteration; returns the number of tokens
        emitted (0 = idle)."""
        with self._lock:
            if self._killed is not None:
                raise ReplicaKilledError(self._killed)
            flip = self._pending_flip
        now = time.monotonic()
        self._expire(now)
        emitted = 0
        if flip is not None:
            # Swap barrier: admission holds (queued requests WAIT — a
            # swap never drops work), in-flight generations keep
            # decoding below; the moment the slots ran dry the flip
            # runs between decode bursts and admission resumes in this
            # same step.  The flip is CLAIMED under the lock: a waiter
            # whose timeout withdrew it concurrently must never see it
            # commit afterwards (it already reported the swap abandoned
            # and discarded the staged params).
            claimed = None
            with self._lock:
                if not self._slots and self._pending_flip is flip:
                    claimed = flip
                    self._pending_flip = None
            if claimed is not None:
                self._run_flip(claimed)
                flip = None
        # Deadline-aware preemption (serve/qos/): before ordinary
        # admission, an interactive request that would miss its
        # deadline waiting for a natural slot release evicts the
        # youngest batch generation and takes its slot this same step.
        if flip is None:
            emitted += self._maybe_preempt(now)
        # Admit: bounded prefills per step keep decode cadence for the
        # already-running requests (prefill is the expensive phase).
        # Pops come out in weighted-fair order (serve/qos/sched.py).
        for _ in range(self.max_prefill_per_step if flip is None else 0):
            with self._lock:
                free = self.engine.free_slots()
                if not free or not len(self._queue):
                    break
                req = self._queue.pop()
                if req is None:
                    break
                slot = free[0]
                self._slots[slot] = req
            emitted += self._prefill_into(slot, req)
        # Decode: one token for every active request.  The kill fault's
        # event coordinate is this dispatch — guarded so an unarmed
        # plan costs one attribute read.
        with self._lock:
            active = dict(self._slots)
        if active:
            if faults_mod._active is not None and faults_mod.on_serve_decode():
                reason = "injected replica kill mid-decode"
                self._die(reason)
                raise ReplicaKilledError(reason)
            tokens = self.engine.step()
            now = time.monotonic()
            for slot, toks in tokens.items():
                req = active.get(slot)
                if req is None:
                    continue
                # A speculative burst emits several tokens; a finish
                # condition (stop token, max_new_tokens) mid-burst
                # drops the remainder — exactly what plain greedy
                # decode would never have produced.
                for j, token in enumerate(toks):
                    emitted += 1
                    self._emit(slot, req, token, now,
                               check_full=(j == len(toks) - 1))
                    if req.done.is_set():
                        break
        with self._lock:
            self.stats.record_step(active=len(self._slots),
                                   slots=self.engine.max_slots,
                                   queued=len(self._queue))
        return emitted

    def _die(self, reason: str) -> None:
        """Fail every queued + in-flight request exactly once and
        refuse new work — replica death as the router observes it."""
        with self._lock:
            self._killed = reason
            pending = self._queue.drain()
            running = list(self._slots.values())
            self._slots.clear()
            flip, self._pending_flip = self._pending_flip, None
        if flip is not None:
            # A subscriber blocked on the barrier must not hang until
            # its timeout on a replica that already died.
            flip[2].setdefault("error", f"replica_killed: {reason}")
            flip[1].set()
        for req in pending + running:
            self._settle_budget(req)
            self.stats.record_failed(req.qos_class)
            req.finish(error="replica_killed")
        n = len(pending) + len(running)
        flight_mod.record("replica_died", reason=reason, failed=n)
        if n:
            logger.warning("serving replica died: %s (%d request(s) "
                           "failed back to the router)", reason, n)
        else:
            logger.info("serving replica retired: %s", reason)

    # --- thread driver ------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    busy = self.step()
                except ReplicaKilledError:
                    return
                except Exception:
                    logger.exception("batcher step failed; replica down")
                    self._die("batcher step raised")
                    return
                if not busy:
                    self._wake.wait(timeout=0.005)
                    self._wake.clear()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="serve-batcher")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        with self._lock:
            killed = self._killed
        if killed is None:
            self._die("replica stopped")

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def snapshot(self) -> Dict:
        # ``weights_version`` rides the stats snapshot: seeded from the
        # engine at construction, advanced only at the flip — one
        # consistent source, no shadow overwrite here.
        snap = self.stats.snapshot()
        snap.update(self.engine.kv_stats())
        with self._lock:
            snap.update(queue_depth=len(self._queue),
                        queued_by_class=self._queue.depths(),
                        active_slots=len(self._slots),
                        max_slots=self.engine.max_slots,
                        dead=self._killed is not None,
                        role=self.role,
                        draining=self._draining,
                        swap_pending=self._pending_flip is not None)
        return snap

    def _handoff(self, slot: int, req: ServeRequest) -> None:
        """Prefill→decode handoff: stream ``slot``'s KV to the
        request's decode target, then free the slot and answer the
        router with the migration outcome.  A failed transfer (wire
        death, digest rejection, busy/draining receiver) falls back to
        decoding HERE — the local KV is pristine (a corrupt fault only
        damaged the wire copy), so the request finishes with exactly
        the right tokens and only the disaggregation economics are
        lost.

        The ``serve:mode=kill`` fault's step-dispatch coordinate fires
        at this dispatch too: prefill replicas never dispatch decode,
        so the handoff is their step event — ``serve:step=N,mode=kill``
        kills a prefill replica mid-migration (the fleet failover
        drill)."""
        if faults_mod._active is not None and faults_mod.on_serve_decode():
            reason = "injected replica kill mid-migration"
            self._die(reason)
            raise ReplicaKilledError(reason)
        try:
            ok = self._migrator(self.engine, slot, req)
        except Exception as e:
            logger.warning("KV handoff of %s failed (%s); decoding "
                           "locally", req.request_id, e)
            ok = False
        if not ok:
            return   # local fallback: the slot keeps decoding here
        req.migrated = True
        self._finish_slot(slot, req)
