"""Shared retry/backoff policy for every recovery-relevant layer.

At production scale transient failure is the steady state ("Collective
Communication for 100k+ GPUs", PAPERS.md): discovery scripts flake, RPC
peers drop connections, checkpoint storage hiccups.  The reference
hand-rolls ad-hoc loops per call site; here one policy object —
jittered exponential backoff bounded by attempts AND a wall-clock
deadline — is adopted by ``ScriptDiscovery``, ``BasicClient``, orbax
restore and the elastic reset loop, so retry behavior is uniform and
separately testable.

Counterpart of ``horovod_tpu/utils/retry.py``: the same policy, the same
jitter draws, the ``on_retry`` hook and the ``retry`` flight event.

Jitter is mandatory at fleet scale: synchronized retries from thousands
of hosts re-create the thundering herd that caused the outage being
retried around.  The jitter RNG is injectable (and seedable) so the
fault-injection harness (:mod:`horovod_tpu.faults`) can reproduce an
identical retry timeline across runs.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Optional, Tuple, Type

import logging

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Jittered exponential backoff with an attempt cap and a deadline.

    ``attempts`` counts total tries (1 = no retry; 0 = unlimited, bounded
    only by ``deadline_s``).  Delay before retry *i* (1-based) is
    ``min(max_delay_s, base_delay_s * multiplier**(i-1))`` spread by
    ``±jitter`` (a fraction of the delay).  ``deadline_s`` bounds the
    whole operation in wall-clock seconds; a retry that would start
    after the deadline raises the last error instead.
    """

    attempts: int = 3
    base_delay_s: float = 0.5
    max_delay_s: float = 30.0
    multiplier: float = 2.0
    jitter: float = 0.5
    deadline_s: Optional[float] = None

    def delay_s(self, retry_index: int,
                rng: Optional[random.Random] = None) -> float:
        """Backoff before 1-based retry ``retry_index``, jittered."""
        if retry_index < 1:
            return 0.0
        delay = min(self.max_delay_s,
                    self.base_delay_s * self.multiplier ** (retry_index - 1))
        return jittered(delay, self.jitter, rng)

def jittered(delay_s: float, jitter: float = 0.5,
             rng: Optional[random.Random] = None) -> float:
    """``delay_s`` spread uniformly over ``[delay*(1-j), delay*(1+j)]``
    (never negative).  ``rng=None`` uses the process-global RNG."""
    if delay_s <= 0.0 or jitter <= 0.0:
        return max(0.0, delay_s)
    r = rng.random() if rng is not None else random.random()
    return max(0.0, delay_s * (1.0 + jitter * (2.0 * r - 1.0)))


def retry_call(
    fn: Callable,
    *,
    policy: RetryPolicy = RetryPolicy(),
    retry_on: Tuple[Type[BaseException], ...] = (Exception,),
    give_up_on: Tuple[Type[BaseException], ...] = (),
    describe: str = "",
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
    rng: Optional[random.Random] = None,
):
    """Call ``fn()`` under ``policy``, retrying on ``retry_on``.

    ``give_up_on`` carves deterministic failures out of a broad
    ``retry_on`` (e.g. retry ``OSError`` but not ``FileNotFoundError``
    — a missing file is never transient).  ``on_retry(attempt_index,
    error)`` fires before each backoff sleep (attempt_index is the
    1-based index of the attempt that failed).  Exceptions outside
    ``retry_on`` propagate immediately; the last retryable error
    propagates once attempts or the deadline run out.
    """
    start = time.monotonic()
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn()
        except retry_on as e:
            if give_up_on and isinstance(e, give_up_on):
                raise
            out_of_attempts = policy.attempts > 0 and attempt >= policy.attempts
            delay = policy.delay_s(attempt, rng)
            out_of_time = (
                policy.deadline_s is not None
                and time.monotonic() + delay - start > policy.deadline_s
            )
            if out_of_attempts or out_of_time:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            from ..obs import flight as _flight
            from ..obs import instrument as _obs

            _obs.on_retry(describe or getattr(fn, "__name__", "call"))
            _flight.record("retry",
                           what=describe or getattr(fn, "__name__", "call"),
                           attempt=attempt, error=str(e)[:200])
            logger.debug("%s failed (attempt %d/%s): %s; retrying in %.2fs",
                         describe or getattr(fn, "__name__", "call"),
                         attempt,
                         policy.attempts if policy.attempts > 0 else "inf",
                         e, delay)
            sleep(delay)
