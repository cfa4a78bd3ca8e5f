"""Collectives, compression, fusion and the hand-written CUDA kernels."""

from .collectives import (  # noqa: F401
    Average, Sum, Min, Max, Product,
    allreduce, allgather, alltoall, broadcast,
)
from .compression import Compression  # noqa: F401
from .fused_collectives import (  # noqa: F401
    fused_allgather_adam_apply, fused_allgather_sgd_apply, fused_allreduce,
    fused_matmul_allgather, fused_quantize_allgather,
    fused_quantize_reducescatter,
)
from .kernel_common import launch_counts, reset_launch_counts  # noqa: F401
from ._build import build as build_kernels  # noqa: F401
