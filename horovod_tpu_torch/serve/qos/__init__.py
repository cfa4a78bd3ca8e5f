"""SLO-aware multi-tenant QoS scheduling (docs/qos.md).

Counterpart of ``horovod_tpu/serve/qos/__init__.py``,
line for line: host-side bookkeeping with no model in it, so the
port keeps its own copy.

The capacity-policy tier over the serving engine — same engine, an
order of magnitude more workload shapes:

* :mod:`~.policy` — service classes
  (``interactive`` / ``standard`` / ``batch``), per-tenant token-bucket
  budgets (prompt + generated tokens), and the typed rejection taxonomy
  (:class:`BudgetExhaustedError` / :class:`RequestShedError` — both
  retriable, both carrying ``retry_after_s``)
* :mod:`~.sched` — :class:`QosQueue`, the
  stride/virtual-time weighted-fair admission queue replacing the
  batcher's FIFO, with a deadline min-heap so expiry no longer scales
  with queue depth
* :mod:`~.preempt` — deadline-aware preemption
  decisions: an interactive request about to miss its deadline evicts
  the youngest batch generation to the paged-KV prefix cache and
  requeues it (resumption replays only the non-resident tail,
  token-identical to the uninterrupted run)
* :mod:`~.brownout` —
  :class:`BrownoutController` / :class:`QosGate`: router-level
  per-tenant rate limits and the hysteresis shed ladder (batch first,
  then standard, never interactive)

Chaos: the ``qos`` fault site (``invert`` at the WFQ pop, ``flood`` at
the budget charge) drills priority inversion and budget floods.
"""

from .brownout import (  # noqa: F401
    BrownoutController, MAX_LEVEL, QosGate, SHED_ORDER,
)
from .policy import (  # noqa: F401
    BudgetExhaustedError, QosError, QosPolicy, RequestShedError,
    TokenBucket, validate_class,
)
from .preempt import (  # noqa: F401
    estimate_slot_wait_s, pick_victim, should_preempt, would_miss,
)
from .sched import QosQueue  # noqa: F401
