"""ResNet v1.5 family, with BatchNorm synchronised over a process set.

Counterpart of ``horovod_tpu/models/resnet.py``: the headline benchmark
model (``bench.py`` trains ResNet-50 on synthetic images).  Inputs are
NHWC, as in the reference.  A convolution keeps flax's kernel
``[kh, kw, in, out]`` and its names, so a flax variable tree loads one
to one (``load_jax_params(model, params, batch_stats)``); inside
``forward`` the kernel becomes an OIHW tensor in ``channels_last``
memory and the NHWC activation is viewed as NCHW, which is the same
memory in ``channels_last`` (no copy), the layout cuDNN prefers.

The helpers follow flax, not torch:

* ``padding="SAME"`` pads as ``lax.padtype_to_pads``: the total
  ``max((ceil(n / s) - 1) * s + k - n, 0)`` split low ``total // 2``,
  high the rest, so a stride-2 3×3 conv on an even input pads
  ``(0, 1)`` where torch's ``padding=1`` pads ``(1, 1)``;
* :class:`BatchNorm` is flax's ``nn.BatchNorm``: statistics in f32
  (E[x] and E[x²], the variance clipped at 0), normalisation in f32,
  the output cast to ``dtype``; running statistics with momentum 0.9
  (the old value's weight) and the biased batch variance.  With a
  ``process_set`` the per-rank ``[E[x], E[x²]]`` are averaged over the
  set in one all-reduce, each rank weighted equally (flax's ``pmean``),
  and the backward averages the cotangents over the set the same way.

BatchNorm is plain torch ops, as the reference's is plain flax; the
convolutions are cuDNN's, as the reference's are XLA's.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import collectives as C
from .layers import Dense, Init

Pads = Tuple[Tuple[int, int], Tuple[int, int]]
Padding = Union[str, Sequence[Tuple[int, int]]]


def same_pads(size: int, window: int, stride: int) -> Tuple[int, int]:
    """flax's (``lax.padtype_to_pads``) SAME padding of one spatial
    axis: ``(low, high)``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def resolve_pads(padding: Padding, hw: Sequence[int],
                 window: Sequence[int], strides: Sequence[int]) -> Pads:
    """``((top, bottom), (left, right))`` for ``"SAME"``, ``"VALID"`` or
    explicit pairs, as flax reads them."""
    if isinstance(padding, str):
        if padding == "VALID":
            return (0, 0), (0, 0)
        if padding == "SAME":
            return tuple(same_pads(n, k, s)
                         for n, k, s in zip(hw, window, strides))
        raise ValueError(f"unknown padding {padding!r}")
    (t, b), (l, r) = padding
    return (int(t), int(b)), (int(l), int(r))


def _nchw(x):
    """An NHWC tensor viewed as NCHW (``channels_last`` memory)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _padded(x, pads: Pads, value: float):
    """(x padded where the pads are uneven, the symmetric pads left for
    the torch call)."""
    (t, b), (l, r) = pads
    if t == b and l == r:
        return x, (t, l)
    return F.pad(x, (0, 0, l, r, t, b), value=value), (0, 0)


def conv_nhwc(x, kernel, bias, strides: Sequence[int], pads: Pads,
              dtype: torch.dtype):
    """flax ``nn.Conv`` on NHWC ``x`` with a ``[kh, kw, in, out]``
    kernel: input, kernel and bias cast to ``dtype``, explicit pads."""
    x, padding = _padded(x.to(dtype), pads, 0.0)
    w = kernel.permute(3, 2, 0, 1).to(dtype=dtype,
                                      memory_format=torch.channels_last)
    y = F.conv2d(_nchw(x), w, None if bias is None else bias.to(dtype),
                 tuple(strides), padding)
    return _nhwc(y)


def max_pool(x, window: Sequence[int], strides: Sequence[int],
             padding: Padding = "VALID"):
    """flax ``nn.max_pool`` on NHWC ``x``: padding counts as -inf."""
    pads = resolve_pads(padding, x.shape[1:3], window, strides)
    x, sym = _padded(x, pads, float("-inf"))
    return _nhwc(F.max_pool2d(_nchw(x), tuple(window), tuple(strides), sym))


def avg_pool(x, window: Sequence[int], strides: Sequence[int],
             padding: Padding = "VALID"):
    """flax ``nn.avg_pool`` on NHWC ``x``: the padding's zeros count in
    every window's mean (flax's ``count_include_pad=True``)."""
    pads = resolve_pads(padding, x.shape[1:3], window, strides)
    x, sym = _padded(x, pads, 0.0)
    return _nhwc(F.avg_pool2d(_nchw(x), tuple(window), tuple(strides), sym,
                              count_include_pad=True))


class Conv(nn.Module):
    """flax ``nn.Conv`` on NHWC inputs: ``kernel [kh, kw, in, out]``
    (lecun normal), an optional zero-initialised ``bias``."""

    def __init__(self, d_in: int, d_out: int, window: Sequence[int],
                 strides: Sequence[int] = (1, 1), padding: Padding = "SAME",
                 *, use_bias: bool = True, dtype: torch.dtype, init: Init,
                 ) -> None:
        super().__init__()
        self.window, self.strides = tuple(window), tuple(strides)
        self.padding, self.dtype = padding, dtype
        self.kernel = init.lecun_normal(*self.window, d_in, d_out)
        if use_bias:
            self.bias = init.constant(0.0, d_out)
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        pads = resolve_pads(self.padding, x.shape[1:3], self.window,
                            self.strides)
        return conv_nhwc(x, self.kernel, self.bias, self.strides, pads,
                         self.dtype)


class _SetMean(torch.autograd.Function):
    """flax's ``pmean`` over a torch group: the mean of every rank's
    ``x``, each weighted equally.  Its backward is the same mean of the
    cotangents, the transpose JAX gives a ``pmean`` under shard_map."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return C.reduce_raw(x, C.Average, group=group)

    @staticmethod
    def backward(ctx, g):
        return C.reduce_raw(g.contiguous(), C.Average, group=ctx.group), None


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over every axis but the last (features).

    ``scale`` and ``bias`` are parameters, ``mean`` and ``var`` buffers
    (flax's ``batch_stats``).  In training, or when
    ``use_running_average=False`` is passed, it normalises with the
    batch's statistics and updates the buffers; otherwise with the
    buffers.  ``process_set`` synchronises the statistics over that
    set (None: plain BatchNorm)."""

    def __init__(self, features: int, init: Init, *, dtype: torch.dtype,
                 momentum: float = 0.9, epsilon: float = 1e-5,
                 process_set=None, scale_init: float = 1.0) -> None:
        super().__init__()
        self.dtype, self.momentum, self.epsilon = dtype, momentum, epsilon
        self.process_set = process_set
        self.scale = init.constant(scale_init, features)
        self.bias = init.constant(0.0, features)
        self.register_buffer("mean", torch.zeros(
            features, dtype=torch.float32, device=init.device))
        self.register_buffer("var", torch.ones(
            features, dtype=torch.float32, device=init.device))

    def batch_stats(self, xf):
        """(E[x], Var[x]) of f32 ``xf`` over every axis but the last,
        averaged over the process set if there is one."""
        axes = tuple(range(xf.dim() - 1))
        mean, mean2 = xf.mean(axes), (xf * xf).mean(axes)
        if self.process_set is not None:
            group = C.set_group(self.process_set, "BatchNorm")
            mean, mean2 = _SetMean.apply(torch.stack([mean, mean2]), group)
        return mean, torch.clamp_min(mean2 - mean * mean, 0.0)

    def forward(self, x, use_running_average: Optional[bool] = None):
        if use_running_average is None:
            use_running_average = not self.training
        xf = x.to(torch.float32)
        if use_running_average:
            mean, var = self.mean, self.var
        else:
            mean, var = self.batch_stats(xf)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return ((xf - mean) * mul + self.bias).to(self.dtype)


class SyncBatchNorm(nn.Module):
    """Cross-rank BatchNorm (reference: ``hvd.SyncBatchNorm``): a
    :class:`BatchNorm` named ``bn`` whose statistics are averaged over
    ``process_set`` (None: plain BatchNorm)."""

    def __init__(self, features: int, *, momentum: float = 0.9,
                 epsilon: float = 1e-5, dtype: torch.dtype = torch.float32,
                 process_set=None, device=None, seed: int = 0) -> None:
        super().__init__()
        self.bn = BatchNorm(features, Init(torch.float32, device, seed),
                            dtype=dtype, momentum=momentum, epsilon=epsilon,
                            process_set=process_set)

    def forward(self, x):
        return self.bn(x)


class BottleneckBlock(nn.Module):
    expansion = 4               # output channels per filter

    def __init__(self, d_in: int, filters: int, strides=(1, 1), *, norm,
                 dtype: torch.dtype, init: Init) -> None:
        super().__init__()
        conv = functools.partial(Conv, use_bias=False, dtype=dtype, init=init)
        out = filters * 4
        self.conv1 = conv(d_in, filters, (1, 1))
        self.bn1 = norm(filters)
        self.conv2 = conv(filters, filters, (3, 3), strides)
        self.bn2 = norm(filters)
        self.conv3 = conv(filters, out, (1, 1))
        self.bn3 = norm(out, scale_init=0.0)
        if tuple(strides) != (1, 1) or d_in != out:
            self.proj = conv(d_in, out, (1, 1), strides)
            self.bn_proj = norm(out)
        else:
            self.proj = None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.proj is None else self.bn_proj(self.proj(x))
        return F.relu(residual + y)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, d_in: int, filters: int, strides=(1, 1), *, norm,
                 dtype: torch.dtype, init: Init) -> None:
        super().__init__()
        conv = functools.partial(Conv, use_bias=False, dtype=dtype, init=init)
        self.conv1 = conv(d_in, filters, (3, 3), strides)
        self.bn1 = norm(filters)
        self.conv2 = conv(filters, filters, (3, 3))
        self.bn2 = norm(filters, scale_init=0.0)
        if tuple(strides) != (1, 1) or d_in != filters:
            self.proj = conv(d_in, filters, (1, 1), strides)
            self.bn_proj = norm(filters)
        else:
            self.proj = None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.proj is None else self.bn_proj(self.proj(x))
        return F.relu(residual + y)


class ResNet(nn.Module):
    """``model(images [B, H, W, 3])`` → f32 logits ``[B, num_classes]``.

    ``dtype`` is every layer's compute type but the f32 ``head``;
    parameters are f32, made on ``device`` from ``seed`` (``device``
    defaults to this rank's device after :func:`init`, else the current
    CUDA device; the CPU only when ``device="cpu"``).
    ``bn_process_set`` synchronises every BatchNorm's statistics over
    that set (the reference's ``bn_axis_name``); ``train=False`` starts
    the model in eval mode (running statistics)."""

    def __init__(self, stage_sizes: Sequence[int], block,
                 num_classes: int = 1000, width: int = 64,
                 dtype: torch.dtype = torch.float32, bn_process_set=None,
                 train: bool = True, *, device=None, seed: int = 0) -> None:
        super().__init__()
        init = Init(torch.float32, device, seed)

        def norm(features, scale_init=1.0):
            return BatchNorm(features, init, dtype=dtype, momentum=0.9,
                             epsilon=1e-5, process_set=bn_process_set,
                             scale_init=scale_init)

        self.conv_init = Conv(3, width, (7, 7), (2, 2), [(3, 3), (3, 3)],
                              use_bias=False, dtype=dtype, init=init)
        self.bn_init = norm(width)
        self.blocks = []
        d = width
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                name = f"stage{i}_block{j}"
                self.add_module(name, block(d, width * 2 ** i, strides,
                                            norm=norm, dtype=dtype,
                                            init=init))
                self.blocks.append(name)
                d = width * 2 ** i * block.expansion
        self.head = Dense(d, num_classes, torch.float32, init, bias=True)
        self.train(train)

    def forward(self, x):
        x = F.relu(self.bn_init(self.conv_init(x)))
        x = max_pool(x, (3, 3), (2, 2), ((1, 1), (1, 1)))
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.head(x.mean(dim=(1, 2)))


ResNet18 = functools.partial(ResNet, stage_sizes=(2, 2, 2, 2),
                             block=BasicBlock)
ResNet50 = functools.partial(ResNet, stage_sizes=(3, 4, 6, 3),
                             block=BottleneckBlock)
ResNet101 = functools.partial(ResNet, stage_sizes=(3, 4, 23, 3),
                              block=BottleneckBlock)
