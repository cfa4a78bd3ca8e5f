"""Building blocks shared by the port's models, with flax's numerics.

Parameters keep the reference's layout and names, so a flax variable
tree loads into a model one to one (:func:`load_jax_params`): a Dense
kernel is ``[in, out]`` and is applied as ``x @ kernel``; names are the
flax paths joined by dots (``block_0.attn.qkv.kernel``).

Numerics follow flax: a layer computes in its ``dtype`` (inputs,
kernel and bias cast to it) from parameters kept in ``param_dtype``;
LayerNorm takes f32 statistics (mean of x and of x², flax's fast
variance) with ε = 1e-6 by default.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import basics

# Flax's lecun_normal: a normal truncated at two standard deviations,
# rescaled by this constant so the variance is 1/fan_in.
_TRUNC_STD = 0.87962566103423978


def default_device() -> torch.device:
    """This rank's device after :func:`init`, else the current CUDA
    device; never the CPU unless the caller asks for it."""
    if basics.is_initialized():
        return basics.device()
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device and init() has not run; pass device='cpu' to "
            "build the model on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


class Init:
    """Parameter factory: one generator, one device, one dtype."""

    def __init__(self, param_dtype: torch.dtype, device, seed: int) -> None:
        if device is None:
            device = default_device()
        self.device = torch.device(device)
        self.dtype = param_dtype
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def empty(self, *shape) -> nn.Parameter:
        return nn.Parameter(torch.empty(shape, dtype=self.dtype,
                                        device=self.device))

    def constant(self, value: float, *shape) -> nn.Parameter:
        p = self.empty(*shape)
        with torch.no_grad():
            p.fill_(value)
        return p

    def lecun_normal(self, *shape) -> nn.Parameter:
        """flax's ``lecun_normal``, fan-in every axis but the last (a
        Dense ``[in, out]`` or a conv ``[kh, kw, in, out]`` kernel)."""
        p = self.empty(*shape)
        std = math.sqrt(1.0 / math.prod(shape[:-1])) / _TRUNC_STD
        with torch.no_grad():
            nn.init.trunc_normal_(p, std=std, a=-2 * std, b=2 * std,
                                  generator=self.gen)
        return p

    def normal(self, std: float, *shape) -> nn.Parameter:
        p = self.empty(*shape)
        with torch.no_grad():
            p.normal_(0.0, std, generator=self.gen)
        return p


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel (+ bias)`` in ``dtype``; no bias
    unless ``bias`` (GPT's layers have none, the zoo's have one)."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype,
                 init: Init, bias: bool = False) -> None:
        super().__init__()
        self.dtype = dtype
        self.kernel = init.lecun_normal(d_in, d_out)
        if bias:
            self.bias = init.constant(0.0, d_out)
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        y = torch.matmul(x.to(self.dtype), self.kernel.to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: f32 statistics, ε = 1e-6, output in
    ``dtype``."""

    def __init__(self, d: int, dtype: torch.dtype, init: Init,
                 eps: float = 1e-6) -> None:
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.scale = init.constant(1.0, d)
        self.bias = init.constant(0.0, d)

    def forward(self, x):
        xf = x.to(torch.float32)
        mean = xf.mean(dim=-1, keepdim=True)
        mean2 = (xf * xf).mean(dim=-1, keepdim=True)
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((xf - mean) * mul + self.bias).to(self.dtype)


class Embed(nn.Module):
    """flax ``nn.Embed``: rows of ``embedding`` in ``dtype``."""

    def __init__(self, vocab: int, d: int, dtype: torch.dtype,
                 init: Init) -> None:
        super().__init__()
        self.dtype = dtype
        self.embedding = init.normal(d ** -0.5, vocab, d)

    def forward(self, tokens):
        return F.embedding(tokens, self.embedding).to(self.dtype)

    def attend(self, query):
        """flax ``Embed.attend``: ``query @ embedding.T`` in ``dtype``
        (the tied decoder)."""
        return torch.matmul(query.to(self.dtype),
                            self.embedding.to(self.dtype).t())


def _flatten(tree: Mapping, prefix: str = "") -> dict:
    flat = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            flat.update(_flatten(val, name + "."))
        else:
            flat[name] = val
    return flat


def _copy_tree(what: str, tree: Mapping, own: Mapping) -> None:
    flat = _flatten(tree)
    if set(flat) != set(own):
        raise ValueError(
            f"{what} trees differ: missing {sorted(set(own) - set(flat))}, "
            f"extra {sorted(set(flat) - set(own))}")
    with torch.no_grad():
        for name, t in own.items():
            src = torch.from_numpy(np.array(flat[name], dtype=np.float32))
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                                 f"{tuple(t.shape)}")
            t.copy_(src)


def load_jax_params(model: nn.Module, params: Mapping,
                    batch_stats: Optional[Mapping] = None) -> None:
    """Copy a flax param tree (nested dicts of numpy arrays, as
    ``jax.tree.map(np.asarray, params)`` gives) into ``model``'s
    parameters, name for name, and a ``batch_stats`` tree into its
    BatchNorm ``mean`` and ``var`` buffers.  Raises on a missing, extra
    or mis-shaped leaf.  A model that holds part of the reference's tree
    (a pipeline stage) says which part through ``jax_params_view``."""
    if hasattr(model, "jax_params_view"):
        params = model.jax_params_view(params)
    _copy_tree("param", params, dict(model.named_parameters()))
    if batch_stats is not None:
        _copy_tree("batch_stats", batch_stats, dict(model.named_buffers()))
