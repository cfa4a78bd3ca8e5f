"""FSDP's unshard epilogue.

Counterpart of ``horovod_tpu/optim/fsdp.py``'s :func:`unshard_matmul`
only.  The reference's ``make_fsdp_train_step`` and ``fsdp_spec`` (the
GSPMD-partitioned FSDP step) are not ported yet.
"""

from __future__ import annotations

import torch

from ..ops.fused_collectives import fused_matmul_allgather


def unshard_matmul(x: torch.Tensor, w_shard: torch.Tensor, *,
                   group=None) -> torch.Tensor:
    """``x [M, K] @ w_shard [K, N/n]`` in kernel B5, then an all-gather
    of the activation: numerically ``x @`` the column-gathered weight
    (``[M, N]``, the ranks' columns in rank order), but the gathered
    weight (``K × N`` per layer, the unshard path's largest
    materialization) never exists; the wire carries the ``M × N``
    activation.  It pays wherever ``M < K``, the long thin layers FSDP
    lives in.  No gradient flows through it."""
    return fused_matmul_allgather(x, w_shard, group=group)
