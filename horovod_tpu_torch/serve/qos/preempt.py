"""Deadline-aware slot preemption: evict-and-requeue batch work.

Counterpart of ``horovod_tpu/serve/qos/preempt.py``,
line for line: host-side bookkeeping with no model in it, so the
port keeps its own copy.

The decision layer (pure functions — the batcher owns execution, the
engine owns the KV mechanics; docs/qos.md has the state machine):

An **interactive** request queued behind a full slot batch would miss
its deadline whenever the earliest natural slot release lands after
it.  When that happens (and ``HVD_TPU_QOS_PREEMPT`` is on), the
scheduler evicts the *youngest batch-class generation* — the one with
the fewest emitted tokens, i.e. the least recompute at stake — and
requeues it:

1. the victim's KV chain is indexed into the prefix cache and its
   slot released (``InferenceEngine.preempt_slot``): the blocks drop
   to the LRU but stay reachable through ``serve/kv/prefix.py``, so
   nothing is recomputed while memory pressure allows;
2. the victim re-enters the weighted-fair queue carrying its emitted
   tokens and the engine's RNG snapshot (``ServeRequest
   .resume_state``) — requeue bypasses the admission bound and the
   budget charge (its tokens are already paid for; dropping preempted
   work would convert a scheduling decision into data loss);
3. on re-admission ``InferenceEngine.resume_slot`` re-binds with a
   prefix hit and recomputes only the non-resident tail, then
   continues decoding — the **token-identity oracle**: the preempted
   +resumed output equals the uninterrupted run's exactly (greedy
   always; temperature whenever the RNG snapshot is restorable, the
   same sole-active-slot contract KV migration uses).

The wait estimate is deliberately simple — decode cadence (TPOT) times
the smallest remaining generation budget across active slots, i.e. the
soonest *guaranteed* natural release.  Stop tokens can only free slots
earlier, which makes the estimate conservative in the safe direction:
it may preempt when waiting would have just barely worked, it never
waits when the numbers say the deadline dies.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

# Decode cadence fallback before the stats window has samples (one
# decode's host+device cost on the CPU tier is a few ms; 50ms is
# pessimistic on purpose — early requests err toward protection).
FALLBACK_TPOT_S = 0.05

# SLO-trigger headroom: with a TTFT SLO configured, preempt when a
# natural slot release is not expected to land the first token inside
# HALF the SLO budget.  The wait estimate's error bars are wide (stop
# tokens, cadence drift), and a TTFT SLO missed by estimation error is
# exactly the failure this subsystem exists to prevent — so the
# trigger spends batch efficiency to buy SLO certainty, by design.
SLO_HEADROOM = 0.5


def estimate_slot_wait_s(active: Dict[int, object],
                         tpot_s: Optional[float]) -> float:
    """Seconds until the soonest *certain* natural slot release: the
    smallest remaining token budget across active slots, at the
    observed decode cadence."""
    if not active:
        return 0.0
    tpot = tpot_s if tpot_s and tpot_s > 0 else FALLBACK_TPOT_S
    remaining = min(
        max(1, r.sampling.max_new_tokens - len(r.tokens))
        for r in active.values())
    return remaining * tpot


def would_miss(deadline: Optional[float], now: float,
               est_wait_s: float) -> bool:
    """True when waiting ``est_wait_s`` for a natural release would
    blow ``deadline``."""
    return deadline is not None and now + est_wait_s > deadline


def should_preempt(req, now: float, est_wait_s: float,
                   slo_ttft_s: float = 0.0) -> bool:
    """The full trigger: waiting ``est_wait_s`` would miss the
    request's deadline, OR (with a TTFT SLO configured,
    ``HVD_TPU_QOS_SLO_TTFT_MS``) would land the first token past
    ``submitted_at + SLO_HEADROOM × slo`` — the aggressive-protection
    mode the acceptance bound (interactive p99 within 1.5× unloaded
    under a 4× batch flood) requires: with a tight SLO the trigger is
    effectively preempt-on-arrival, with a loose one it degenerates to
    pure deadline feasibility and batch runs undisturbed."""
    if would_miss(req.deadline, now, est_wait_s):
        return True
    if slo_ttft_s > 0:
        target = (getattr(req, "submitted_at", now)
                  + SLO_HEADROOM * slo_ttft_s)
        return now + est_wait_s > target
    return False


def pick_victim(active: Dict[int, object]) -> Optional[Tuple[int, object]]:
    """The youngest batch-class generation ``(slot, request)`` — fewest
    emitted tokens, most recently submitted on ties (least work lost,
    and the most recently admitted request is the fairest to send back
    to the queue it just left).  None when no batch work is running —
    interactive/standard generations are never preempted."""
    victims = [(slot, req) for slot, req in active.items()
               if getattr(req, "qos_class", None) == "batch"
               and not req.done.is_set()]
    if not victims:
        return None
    return min(victims,
               key=lambda sr: (len(sr[1].tokens), -sr[1].submitted_at))
