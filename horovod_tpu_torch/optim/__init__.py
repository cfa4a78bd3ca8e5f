from .autotune import AutotunedTrainStep  # noqa: F401
from .distributed_optimizer import (  # noqa: F401
    DistributedOptimizer, make_train_step,
)
from .fsdp import (  # noqa: F401
    FsdpTrainStep, fsdp_spec, make_fsdp_train_step, unshard_matmul,
)
from .parameter_manager import (  # noqa: F401
    GaussianProcess, ParameterManager, expected_improvement,
)
from .zero import (  # noqa: F401
    ZeroStateWithResidual, ZeroTrainStep, make_zero_train_step,
)
