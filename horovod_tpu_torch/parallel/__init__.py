"""Parallelism beyond data parallel.

Counterpart of ``horovod_tpu/parallel/``:

* :mod:`.sharding`: named meshes and the Megatron rule table (``dp`` /
  ``tp`` / ``sp`` axes); ``shard_params`` keeps a rank's ``tp`` slices;
* :mod:`.ring_attention`: ring attention over ``sp`` (blockwise,
  merged by logsumexp; K/V rotating around the ring; the ``'flash'``
  engine's blocks on B1);
* :mod:`.ulysses`: all-to-all sequence parallelism (heads scattered,
  the sequence gathered);
* :mod:`.train`: ``make_spmd_train_step``, ``shard_batch``,
  ``init_opt_state``;
* :mod:`.comm`: the differentiable collectives under them.

GPipe (``pipeline_apply``, ``shard_stage_params``) and MoE (``MoEMlp``,
``moe_aux_loss``) are not ported yet.
"""

from .sharding import (  # noqa: F401
    gather_params, make_mesh, param_shardings, shard_params,
    transformer_param_rules,
)
from .ring_attention import (  # noqa: F401
    full_attention, ring_attention_local, ring_self_attention,
)
from .ulysses import ulysses_attention  # noqa: F401
from .train import init_opt_state, make_spmd_train_step, shard_batch  # noqa: F401
