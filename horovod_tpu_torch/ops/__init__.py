"""Collectives, compression, fusion and the hand-written CUDA kernels."""

from .collectives import (  # noqa: F401
    Average, Sum, Min, Max, Product,
    allreduce, allgather, alltoall, broadcast,
)
from .compression import Compression  # noqa: F401
from .kernel_common import launch_counts, reset_launch_counts  # noqa: F401
from ._build import build as build_kernels  # noqa: F401
