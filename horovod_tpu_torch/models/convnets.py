"""VGG-16 and Inception-V3, the reference's scaling-benchmark models.

Counterpart of ``horovod_tpu/models/convnets.py`` (``bench.py --model
vgg16 | inception3``): NHWC inputs, bf16 activations and f32 parameters
by default, the names of the reference's flax modules, and its layers
through :mod:`.resnet`'s flax-exact helpers (SAME and VALID padding,
max and average pooling, :class:`~.resnet.BatchNorm`).  VGG has no
BatchNorm; its ``fc6``/``fc7`` head holds most of its ~138 M
parameters.  Inception's cells are conv + BatchNorm (ε 1e-3) + ReLU,
with ``train`` a call argument as in the reference.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, Init
from .resnet import BatchNorm, Conv, avg_pool, max_pool

_VGG16 = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
          512, 512, 512, "M", 512, 512, 512, "M")


class VGG16(nn.Module):
    """VGG-16 (configuration D).  torch needs the input's side up front
    (``image_size``, for ``fc6``'s width), where flax infers it."""

    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16, *,
                 image_size: int = 224, device=None, seed: int = 0) -> None:
        super().__init__()
        init = Init(torch.float32, device, seed)
        self.layers = []
        d, side = 3, image_size
        for i, c in enumerate(_VGG16):
            if c == "M":
                self.layers.append(None)
                side //= 2
            else:
                self.add_module(f"conv_{i}", Conv(d, c, (3, 3), padding="SAME",
                                                  dtype=dtype, init=init))
                self.layers.append(f"conv_{i}")
                d = c
        self.fc6 = Dense(d * side * side, 4096, dtype, init, bias=True)
        self.fc7 = Dense(4096, 4096, dtype, init, bias=True)
        self.fc8 = Dense(4096, num_classes, torch.float32, init, bias=True)

    def forward(self, x, train: bool = True):
        del train  # no BatchNorm or dropout in the benchmark configuration
        for name in self.layers:
            if name is None:
                x = max_pool(x, (2, 2), (2, 2))
            else:
                x = F.relu(getattr(self, name)(x))
        x = x.reshape(x.shape[0], -1)
        x = F.relu(self.fc6(x))
        x = F.relu(self.fc7(x))
        return self.fc8(x)


class _ConvBN(nn.Module):
    """Inception's conv + BatchNorm + ReLU cell."""

    def __init__(self, d_in: int, features: int, kernel: Sequence[int],
                 strides=(1, 1), padding="SAME", *, dtype: torch.dtype,
                 init: Init) -> None:
        super().__init__()
        self.conv = Conv(d_in, features, kernel, strides, padding,
                         use_bias=False, dtype=dtype, init=init)
        self.bn = BatchNorm(features, init, dtype=dtype, momentum=0.9,
                            epsilon=1e-3)

    def forward(self, x, train: bool = True):
        return F.relu(self.bn(self.conv(x), use_running_average=not train))


class InceptionV3(nn.Module):
    """Inception-V3: 3× InceptionA, a reduction, 4× InceptionB
    (factorised 7×1/1×7), a reduction, 2× InceptionC, no aux head;
    299×299×3 inputs upstream, any side ≥ 75 works."""

    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16, *, device=None,
                 seed: int = 0) -> None:
        super().__init__()
        init = Init(torch.float32, device, seed)

        def c(name, d_in, f, k, s=(1, 1), p="SAME") -> None:
            self.add_module(name, _ConvBN(d_in, f, k, s, p, dtype=dtype,
                                          init=init))

        c("stem1", 3, 32, (3, 3), (2, 2), "VALID")
        c("stem2", 32, 32, (3, 3), (1, 1), "VALID")
        c("stem3", 32, 64, (3, 3))
        c("stem4", 64, 80, (1, 1), (1, 1), "VALID")
        c("stem5", 80, 192, (3, 3), (1, 1), "VALID")
        d = 192
        for name, pool_f in (("mixed5a", 32), ("mixed5b", 64),
                             ("mixed5c", 64)):
            c(f"{name}_b1", d, 64, (1, 1))
            c(f"{name}_b2a", d, 48, (1, 1))
            c(f"{name}_b2b", 48, 64, (5, 5))
            c(f"{name}_b3a", d, 64, (1, 1))
            c(f"{name}_b3b", 64, 96, (3, 3))
            c(f"{name}_b3c", 96, 96, (3, 3))
            c(f"{name}_b4", d, pool_f, (1, 1))
            d = 64 + 64 + 96 + pool_f
        c("red_a_b1", d, 384, (3, 3), (2, 2), "VALID")
        c("red_a_b2a", d, 64, (1, 1))
        c("red_a_b2b", 64, 96, (3, 3))
        c("red_a_b2c", 96, 96, (3, 3), (2, 2), "VALID")
        d = 384 + 96 + d
        for name, f7 in (("mixed6b", 128), ("mixed6c", 160),
                         ("mixed6d", 160), ("mixed6e", 192)):
            c(f"{name}_b1", d, 192, (1, 1))
            c(f"{name}_b2a", d, f7, (1, 1))
            c(f"{name}_b2b", f7, f7, (1, 7))
            c(f"{name}_b2c", f7, 192, (7, 1))
            c(f"{name}_b3a", d, f7, (1, 1))
            c(f"{name}_b3b", f7, f7, (7, 1))
            c(f"{name}_b3c", f7, f7, (1, 7))
            c(f"{name}_b3d", f7, f7, (7, 1))
            c(f"{name}_b3e", f7, 192, (1, 7))
            c(f"{name}_b4", d, 192, (1, 1))
            d = 4 * 192
        c("red_b_b1a", d, 192, (1, 1))
        c("red_b_b1b", 192, 320, (3, 3), (2, 2), "VALID")
        c("red_b_b2a", d, 192, (1, 1))
        c("red_b_b2b", 192, 192, (1, 7))
        c("red_b_b2c", 192, 192, (7, 1))
        c("red_b_b2d", 192, 192, (3, 3), (2, 2), "VALID")
        d = 320 + 192 + d
        for name in ("mixed7a", "mixed7b"):
            c(f"{name}_b1", d, 320, (1, 1))
            c(f"{name}_b2a", d, 384, (1, 1))
            c(f"{name}_b2b", 384, 384, (1, 3))
            c(f"{name}_b2c", 384, 384, (3, 1))
            c(f"{name}_b3a", d, 448, (1, 1))
            c(f"{name}_b3b", 448, 384, (3, 3))
            c(f"{name}_b3c", 384, 384, (1, 3))
            c(f"{name}_b3d", 384, 384, (3, 1))
            c(f"{name}_b4", d, 192, (1, 1))
            d = 320 + 2 * 384 + 2 * 384 + 192
        self.logits = Dense(d, num_classes, torch.float32, init, bias=True)

    def forward(self, x, train: bool = True):
        def c(name, y):
            return getattr(self, name)(y, train)

        x = c("stem3", c("stem2", c("stem1", x)))
        x = max_pool(x, (3, 3), (2, 2))
        x = c("stem5", c("stem4", x))
        x = max_pool(x, (3, 3), (2, 2))

        for name in ("mixed5a", "mixed5b", "mixed5c"):
            b1 = c(f"{name}_b1", x)
            b2 = c(f"{name}_b2b", c(f"{name}_b2a", x))
            b3 = c(f"{name}_b3c", c(f"{name}_b3b", c(f"{name}_b3a", x)))
            b4 = c(f"{name}_b4", avg_pool(x, (3, 3), (1, 1), "SAME"))
            x = torch.cat([b1, b2, b3, b4], dim=-1)

        b1 = c("red_a_b1", x)
        b2 = c("red_a_b2c", c("red_a_b2b", c("red_a_b2a", x)))
        b3 = max_pool(x, (3, 3), (2, 2), "VALID")
        x = torch.cat([b1, b2, b3], dim=-1)

        for name in ("mixed6b", "mixed6c", "mixed6d", "mixed6e"):
            b1 = c(f"{name}_b1", x)
            b2 = c(f"{name}_b2c", c(f"{name}_b2b", c(f"{name}_b2a", x)))
            b3 = c(f"{name}_b3a", x)
            for part in ("b3b", "b3c", "b3d", "b3e"):
                b3 = c(f"{name}_{part}", b3)
            b4 = c(f"{name}_b4", avg_pool(x, (3, 3), (1, 1), "SAME"))
            x = torch.cat([b1, b2, b3, b4], dim=-1)

        b1 = c("red_b_b1b", c("red_b_b1a", x))
        b2 = c("red_b_b2a", x)
        for part in ("b2b", "b2c", "b2d"):
            b2 = c(f"red_b_{part}", b2)
        b3 = max_pool(x, (3, 3), (2, 2), "VALID")
        x = torch.cat([b1, b2, b3], dim=-1)

        for name in ("mixed7a", "mixed7b"):
            b1 = c(f"{name}_b1", x)
            b2 = c(f"{name}_b2a", x)
            b2 = torch.cat([c(f"{name}_b2b", b2), c(f"{name}_b2c", b2)],
                           dim=-1)
            b3 = c(f"{name}_b3b", c(f"{name}_b3a", x))
            b3 = torch.cat([c(f"{name}_b3c", b3), c(f"{name}_b3d", b3)],
                           dim=-1)
            b4 = c(f"{name}_b4", avg_pool(x, (3, 3), (1, 1), "SAME"))
            x = torch.cat([b1, b2, b3, b4], dim=-1)

        return self.logits(x.mean(dim=(1, 2)))
