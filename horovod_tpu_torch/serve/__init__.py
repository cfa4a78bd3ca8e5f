"""Inference serving: continuous batching and replica routing.

Counterpart of ``horovod_tpu/serve``, under the reference's names:

* :mod:`~.engine` — length-bucketed prefill and slot-batched decode
  over the port's ``GPT`` (dense or paged KV cache written in place,
  greedy / temperature / top-k sampling from a ``torch.Generator``,
  speculative decoding with a drafter; timeline phases
  ``SERVE_PREFILL`` / ``SERVE_DECODE``)
* :mod:`~.kv` — the paged block pool: refcounted token blocks,
  copy-on-write prefix sharing over a radix trie, LRU eviction
* :mod:`~.batcher` — the continuous-batching scheduler (bounded
  admission, deadlines, cancellation, preemption and resume, the weight
  flip at a step boundary)
* :mod:`~.qos` — weighted-fair admission, tenant token budgets,
  deadline-aware preemption, the brownout ladder
* :mod:`~.server` — a replica endpoint on the runner's HMAC RPC stack
* :mod:`~.router` — spreads requests over replicas (process sets),
  strike/probation health, failover, prefix affinity through
  :mod:`~.fleet.directory`
* :mod:`~.metrics` — TTFT/TPOT/occupancy snapshots

The engine and the servers run on the card unless the model was built
with ``device="cpu"``.  The fleet tier (KV migration, controller,
simulator), the weight hot-swap from a checkpoint store and
tensor-parallel replicas are the next serving slice (ROADMAP.md, queue
A item 4).

Chaos: the ``serve`` fault site drops or delays requests at the
endpoint, kills a replica mid-decode and force-evicts the prefix cache;
the ``qos`` site drills priority inversion and budget floods.
"""

from .batcher import (  # noqa: F401
    ContinuousBatcher, QueueFullError, ReplicaDrainingError,
    ReplicaKilledError, ServeRequest,
)
from .engine import (  # noqa: F401
    InferenceEngine, PromptTooLongError, SamplingParams,
)
from .fleet import PrefixDirectory  # noqa: F401
from .kv import (  # noqa: F401
    BlockPool, KVPoolExhaustedError, PrefixIndex,
)
from .metrics import ServingStats, percentile  # noqa: F401
from .qos import (  # noqa: F401
    BrownoutController, BudgetExhaustedError, QosGate, QosPolicy,
    QosQueue, RequestShedError,
)
from .router import (  # noqa: F401
    NoHealthyReplicasError, ReplicaSpec, ReplicaUnavailableError, Router,
    register_replica_process_sets, replica_slot_groups,
)
from .server import (  # noqa: F401
    CancelRequest, GenerateRequest, GenerateResponse, InferenceServer,
    RollbackRequest, StatsRequest, StatsResponse, SwapRequest,
    SwapResponse,
)
