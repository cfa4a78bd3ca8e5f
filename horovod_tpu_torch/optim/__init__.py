from .distributed_optimizer import (  # noqa: F401
    DistributedOptimizer, make_train_step,
)
