"""MNIST-scale MLP.

Counterpart of ``horovod_tpu/models/mlp.py``: the inputs flattened,
``dense_i`` (with bias) and ReLU for each width of ``features``, then
the ``head``; f32 throughout, as the reference's default.  torch needs
the input width up front (``in_features``, 28 × 28 by default), where
flax infers it at init.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, Init


class MLP(nn.Module):
    def __init__(self, features: Sequence[int] = (128, 64),
                 num_classes: int = 10, *, in_features: int = 28 * 28,
                 device=None, seed: int = 0) -> None:
        super().__init__()
        init = Init(torch.float32, device, seed)
        self.n_dense = len(features)
        d = in_features
        for i, f in enumerate(features):
            self.add_module(f"dense_{i}",
                            Dense(d, f, torch.float32, init, bias=True))
            d = f
        self.head = Dense(d, num_classes, torch.float32, init, bias=True)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        for i in range(self.n_dense):
            x = F.relu(getattr(self, f"dense_{i}")(x))
        return self.head(x)
