from .distributed_optimizer import (  # noqa: F401
    DistributedOptimizer, make_train_step,
)
from .fsdp import unshard_matmul  # noqa: F401
from .zero import (  # noqa: F401
    ZeroStateWithResidual, ZeroTrainStep, make_zero_train_step,
)
