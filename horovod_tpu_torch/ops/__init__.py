"""Collectives, compression, fusion and the hand-written CUDA kernels."""

from .collectives import (  # noqa: F401
    Average, Sum, Adasum, Min, Max, Product, Handle, synchronize, poll,
    allreduce, allreduce_async, allreduce_, allreduce_async_,
    grouped_allreduce, grouped_allreduce_async, grouped_allreduce_,
    grouped_allreduce_async_, sparse_allreduce_async,
    allgather, allgather_async, grouped_allgather, grouped_allgather_async,
    broadcast, broadcast_async, broadcast_, broadcast_async_,
    alltoall, alltoall_async, reducescatter, reducescatter_async,
    grouped_reducescatter, grouped_reducescatter_async, barrier, join,
)
from .compression import Compression  # noqa: F401
from .fused_collectives import (  # noqa: F401
    fused_allgather_adam_apply, fused_allgather_sgd_apply, fused_allreduce,
    fused_matmul_allgather, fused_quantize_allgather,
    fused_quantize_reducescatter,
)
from .kernel_common import launch_counts, reset_launch_counts  # noqa: F401
from ._build import build as build_kernels  # noqa: F401
