"""Cross-rank synchronised BatchNorm for torch models.

Counterpart of ``horovod_tpu/torch/sync_batch_norm.py`` (reference:
``horovod/torch/sync_batch_norm.py``): a ``_BatchNorm`` whose train-mode
forward normalises with the statistics of the global batch, through an
autograd Function that allreduces

- forward: ``[Σx, Σx², count]`` per channel, in f64 (one Sum); the
  biased variance ``E[x²] − E[x]²``, clamped at 0, normalises, and the
  running variance takes it unbiased by ``n / (n − 1)``;
- backward: ``[Σg, Σg·x̂]`` per channel, in f64 (one Sum), for the
  input's gradient.  The weight and bias gradients stay local: the
  optimizer averages them like any other gradient.

Eval with running statistics is a plain ``F.batch_norm``; with
``track_running_stats=False`` batch statistics (still synchronised) are
used in both modes, as ``nn.BatchNorm`` does.

This is not ``models/resnet.py::BatchNorm``, which follows flax's
numerics; the two stay separate.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.nn.modules.batchnorm import _BatchNorm

from . import mpi_ops


class _SyncBatchNormFn(torch.autograd.Function):
    """Batch-statistics normalisation with the statistics reduced over
    the ranks."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var,
                eps, momentum, update_running_stats, process_set):
        c = x.shape[1]
        reduce_dims = [0] + list(range(2, x.dim()))
        sum_x = x.sum(dim=reduce_dims)
        sum_x2 = (x * x).sum(dim=reduce_dims)
        count_local = torch.tensor([float(x.numel() // c)],
                                   dtype=torch.float64, device=x.device)
        stats = torch.cat([sum_x.double(), sum_x2.double(), count_local])
        stats = mpi_ops.allreduce(stats, op=mpi_ops.Sum,
                                  process_set=process_set,
                                  name="sync_batch_norm.fwd")
        count = stats[-1]
        mean = (stats[:c] / count).to(x.dtype)
        var = (stats[c: 2 * c] / count).to(x.dtype) - mean * mean
        var = var.clamp_(min=0.0)
        n = float(count.item())

        if update_running_stats and running_mean is not None:
            unbiased = var * (n / max(n - 1.0, 1.0))
            with torch.no_grad():
                running_mean.mul_(1 - momentum).add_(mean, alpha=momentum)
                running_var.mul_(1 - momentum).add_(unbiased, alpha=momentum)

        shape = [1, c] + [1] * (x.dim() - 2)
        invstd = torch.rsqrt(var + eps)
        xhat = (x - mean.view(shape)) * invstd.view(shape)
        y = xhat
        if weight is not None:
            y = y * weight.view(shape)
        if bias is not None:
            y = y + bias.view(shape)

        ctx.process_set = process_set
        ctx.count = n
        ctx.has_weight = weight is not None
        ctx.has_bias = bias is not None
        ctx.save_for_backward(xhat, invstd,
                              weight if weight is not None
                              else torch.tensor([], device=x.device))
        return y

    @staticmethod
    def backward(ctx, dy):
        xhat, invstd, weight = ctx.saved_tensors
        c = xhat.shape[1]
        reduce_dims = [0] + list(range(2, xhat.dim()))
        shape = [1, c] + [1] * (xhat.dim() - 2)

        db = dy.sum(dim=reduce_dims) if ctx.has_bias else None
        dw = (dy * xhat).sum(dim=reduce_dims) if ctx.has_weight else None

        g = dy * weight.view(shape) if ctx.has_weight else dy
        stats = torch.cat([g.sum(dim=reduce_dims),
                           (g * xhat).sum(dim=reduce_dims)])
        stats = mpi_ops.allreduce(stats.double(), op=mpi_ops.Sum,
                                  process_set=ctx.process_set,
                                  name="sync_batch_norm.bwd").to(dy.dtype)
        sum_g = stats[:c].view(shape)
        sum_g_xhat = stats[c:].view(shape)
        n = ctx.count
        dx = invstd.view(shape) * (g - sum_g / n - xhat * sum_g_xhat / n)
        return (dx, dw, db, None, None, None, None, None, None)


class SyncBatchNorm(_BatchNorm):
    """Reference: ``hvd.SyncBatchNorm``: a drop-in for ``nn.BatchNorm*d``
    whose statistics are the global batch's."""

    def __init__(self, num_features, eps: float = 1e-5, momentum: float = 0.1,
                 affine: bool = True, track_running_stats: bool = True,
                 process_set=None):
        super().__init__(num_features, eps, momentum, affine,
                         track_running_stats)
        self.process_set = process_set

    def _check_input_dim(self, x):
        if x.dim() < 2:
            raise ValueError(f"expected at least 2D input (got {x.dim()}D)")

    def forward(self, x: "torch.Tensor") -> "torch.Tensor":
        self._check_input_dim(x)
        if not (self.training or not self.track_running_stats):
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        if self.training and self.track_running_stats \
                and self.num_batches_tracked is not None:
            self.num_batches_tracked.add_(1)
        momentum = self.momentum if self.momentum is not None else 0.1
        return _SyncBatchNormFn.apply(
            x, self.weight, self.bias, self.running_mean, self.running_var,
            self.eps, momentum, self.training and self.track_running_stats,
            self.process_set)
