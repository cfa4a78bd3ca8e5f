"""Torch elastic state: ``horovod.torch.elastic``'s names.

Counterpart of ``horovod_tpu/torch/elastic.py``.  The port's core
already holds the torch binding's contract
(:class:`horovod_tpu_torch.elastic.state.TorchState`: ``commit`` copies
the module's and optimizer's tensors to host memory, ``restore`` loads
them back, ``sync`` broadcasts rank 0's, ``save_to``/``load_from`` go
through a checkpointer), so this module re-exports it with ``run`` and
the sampler::

    state = hvd.elastic.TorchState(model=model, optimizer=opt, batch=0)

    @hvd.elastic.run
    def train(state):
        ...
"""

from __future__ import annotations

from ..elastic.sampler import ElasticSampler  # noqa: F401
from ..elastic.state import ObjectState, TorchState, run  # noqa: F401
