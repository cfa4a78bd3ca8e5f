"""Parallelism beyond data parallel.

Counterpart of ``horovod_tpu/parallel/``:

* :mod:`.sharding`: named meshes and the Megatron rule table (``dp`` /
  ``tp`` / ``sp`` axes); ``shard_params`` keeps a rank's ``tp`` slices;
* :mod:`.ring_attention`: ring attention over ``sp`` (blockwise,
  merged by logsumexp; K/V rotating around the ring; the ``'flash'``
  engine's blocks on B1);
* :mod:`.ulysses`: all-to-all sequence parallelism (heads scattered,
  the sequence gathered);
* :mod:`.pipeline`: the GPipe schedule over ``pipe``/``pp``
  (``pipeline_apply``, ``shard_stage_params``, ``stack_stage_params``,
  ``stage_param_shardings``; the model is
  ``models.pipeline_gpt.PipelinedGPT``);
* :mod:`.moe`: GShard mixture of experts over ``expert``/``ep``
  (``MoEMlp``, ``moe_aux_loss``; GPT's ``moe_*`` fields);
* :mod:`.train`: ``make_spmd_train_step``, ``shard_batch``,
  ``init_opt_state``, which train all of them;
* :mod:`.comm`: the differentiable collectives under them.
"""

from .sharding import (  # noqa: F401
    gather_params, make_mesh, param_shardings, shard_params,
    transformer_param_rules,
)
from .ring_attention import (  # noqa: F401
    full_attention, ring_attention_local, ring_self_attention,
)
from .ulysses import ulysses_attention  # noqa: F401
from .pipeline import (  # noqa: F401
    pipeline_apply, shard_stage_params, stack_stage_params,
    stage_param_shardings,
)
from .moe import MoEMlp, moe_aux_loss  # noqa: F401
from .train import init_opt_state, make_spmd_train_step, shard_batch  # noqa: F401
