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
* :mod:`~.fleet` — the disaggregated prefill/decode tier: live KV
  migration over the HMAC wire (per-block digests, token-identical
  continuation), the global prefix directory, and a
  :class:`FleetController` driving per-role scale-out /
  drain-and-retire and rolling weight swaps
* :mod:`~.swap` — zero-downtime weight hot-swap from a checkpoint store
  (``ckpt/``): a :class:`WeightSubscriber` per replica diff-pulls only
  the changed leaves (digest-verified), stages them beside the live
  parameters and flips at the batcher's swap barrier; rollbacks ride
  the same path (``SwapRequest`` / ``RollbackRequest``)

* :mod:`~.tp` — tensor-parallel replicas: the leader dispatches every
  start / step / release to its follower shards in lockstep over the
  HMAC wire (:class:`ShardFollower` → :class:`ShardServer`), and a lost
  shard kills the whole replica (``shard_rank_lost``); the engine's
  ``tp=`` / ``devices=`` shards heads and MLP columns over explicit
  devices inside one process
* :mod:`~.fleet.sim` — the fleet simulator: the real router, fleet
  controller, QoS gate and queues driven on a virtual clock over
  simulated replicas

The engine and the servers run on the card unless the model was built
with ``device="cpu"``.

Chaos: the ``serve`` fault site drops or delays requests at the
endpoint, kills a replica mid-decode or mid-migration, damages KV
transfers and force-evicts the prefix cache; the ``swap`` site corrupts
or stalls a pull, kills a replica at the flip and aborts a roll; the
``qos`` site drills priority inversion and budget floods.
"""

from .batcher import (  # noqa: F401
    ContinuousBatcher, QueueFullError, ReplicaDrainingError,
    ReplicaKilledError, ServeRequest,
)
from .engine import (  # noqa: F401
    InferenceEngine, PromptTooLongError, SamplingParams,
)
from .fleet import (  # noqa: F401
    FleetController, MigrationError, PrefixDirectory, ReplicaLauncher,
)
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
from .swap import (  # noqa: F401
    SwapAbandonedError, SwapFailedError, SwapRejectedError,
    WeightSubscriber,
)
from .tp import (  # noqa: F401
    ShardFollower, ShardLockstepError, ShardServer, ShardStepRequest,
    ShardStepResponse,
)
