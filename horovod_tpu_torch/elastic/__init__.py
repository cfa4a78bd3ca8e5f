"""Elastic training: survive rank and host membership changes.

Counterpart of ``horovod_tpu/elastic/`` (reference:
``horovod/common/elastic.py``, ``horovod/torch/elastic/``, the driver
stack under ``horovod/runner/elastic/``): ``State``/``ObjectState``/
``TorchState`` with commit, rollback and sync, ``hvd.elastic.run``, the
exception translators, the ``ElasticSampler`` and the discovery driver.
Recovery is rollback to the last commit plus a re-init of the session
over a new rendezvous generation.
"""

from .state import (  # noqa: F401
    State, ObjectState, TorchState, HorovodInternalError,
    HostsUpdatedInterrupt, run,
    register_exception_translator, translate_exception,
    default_exception_translator,
)
from .sampler import ElasticSampler  # noqa: F401
from .driver import (  # noqa: F401
    ElasticDriver, FixedDiscovery, HostDiscovery, ScriptDiscovery,
    hosts_updated_interrupt_callback,
)
