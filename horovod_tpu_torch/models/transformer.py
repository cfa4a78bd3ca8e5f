"""Decoder-only transformer (GPT) for the data-parallel training path.

Counterpart of ``horovod_tpu/models/transformer.py`` (training paths,
``attention='full' | 'flash'``).  The parameters keep the reference's
layout and names, so a flax param tree loads into this model one to one
(:func:`load_jax_params`): each Dense kernel is ``[in, out]`` and is
applied as ``x @ kernel``; names are the flax paths joined by dots
(``block_0.attn.qkv.kernel``, ``embed.embedding``, ``pos_embed``).

Numerics follow flax: activations in ``cfg.dtype`` (bfloat16 by
default) with f32 parameters; LayerNorm with ε = 1e-6 and f32
statistics (mean of x and of x², as flax's fast variance); the tanh
GELU; positions added after a cast to ``cfg.dtype``; ``lm_head`` in f32.

The KV-cache paths, ring/Ulysses attention, MoE and tensor-parallel
serving are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import basics
from ..ops import flash_attention as _flash
from ..parallel.ring_attention import full_attention

# Flax's lecun_normal: a normal truncated at two standard deviations,
# rescaled by this constant so the variance is 1/fan_in.
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 32000
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    d_ff: int = 3072
    max_seq_len: int = 2048
    causal: bool = True
    attention: str = "full"            # 'full' | 'flash'
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32


def _default_device() -> torch.device:
    """This rank's device after :func:`init`, else the current CUDA
    device; never the CPU unless the caller asks for it."""
    if basics.is_initialized():
        return basics.device()
    if not torch.cuda.is_available():
        raise RuntimeError(
            "GPT: no CUDA device and init() has not run; pass "
            "device='cpu' to build the model on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


class _Init:
    """Parameter factory: one generator, one device, one dtype."""

    def __init__(self, cfg: GPTConfig, device, seed: int) -> None:
        if device is None:
            device = _default_device()
        self.device = torch.device(device)
        self.dtype = cfg.param_dtype
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def empty(self, *shape) -> nn.Parameter:
        return nn.Parameter(torch.empty(shape, dtype=self.dtype,
                                        device=self.device))

    def lecun_normal(self, d_in: int, d_out: int) -> nn.Parameter:
        p = self.empty(d_in, d_out)
        std = math.sqrt(1.0 / d_in) / _TRUNC_STD
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
    """flax ``nn.Dense(use_bias=False)``: ``x @ kernel`` in ``dtype``."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype,
                 init: _Init) -> None:
        super().__init__()
        self.dtype = dtype
        self.kernel = init.lecun_normal(d_in, d_out)

    def forward(self, x):
        return torch.matmul(x.to(self.dtype), self.kernel.to(self.dtype))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: f32 statistics, ε = 1e-6, output in
    ``dtype``."""

    def __init__(self, d: int, dtype: torch.dtype, init: _Init,
                 eps: float = 1e-6) -> None:
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.scale = init.empty(d)
        self.bias = init.empty(d)
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

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
                 init: _Init) -> None:
        super().__init__()
        self.dtype = dtype
        self.embedding = init.normal(d ** -0.5, vocab, d)

    def forward(self, tokens):
        return F.embedding(tokens, self.embedding).to(self.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: GPTConfig, init: _Init) -> None:
        super().__init__()
        self.cfg = cfg
        c = cfg.d_model
        self.qkv = Dense(c, 3 * c, cfg.dtype, init)
        self.out = Dense(c, c, cfg.dtype, init)

    def forward(self, x):
        cfg = self.cfg
        b, t, c = x.shape
        h = cfg.n_head
        q, k, v = self.qkv(x).split(c, dim=-1)
        q, k, v = (y.reshape(b, t, h, c // h) for y in (q, k, v))
        if cfg.attention == "flash":
            if cfg.causal:
                out = _flash.flash_attention_padded(q, k, v)
            else:
                out = _flash.flash_attention(q, k, v, causal=False)
        elif cfg.attention == "full":
            out = full_attention(q, k, v, causal=cfg.causal)
        else:
            raise ValueError(f"Unknown attention {cfg.attention!r} "
                             "(the port has 'full' and 'flash')")
        return self.out(out.reshape(b, t, c))


class MlpBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, init: _Init) -> None:
        super().__init__()
        self.up = Dense(cfg.d_model, cfg.d_ff, cfg.dtype, init)
        self.down = Dense(cfg.d_ff, cfg.d_model, cfg.dtype, init)

    def forward(self, x):
        return self.down(F.gelu(self.up(x), approximate="tanh"))


class Block(nn.Module):
    def __init__(self, cfg: GPTConfig, init: _Init) -> None:
        super().__init__()
        self.ln1 = LayerNorm(cfg.d_model, cfg.dtype, init)
        self.attn = Attention(cfg, init)
        self.ln2 = LayerNorm(cfg.d_model, cfg.dtype, init)
        self.mlp = MlpBlock(cfg, init)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class GPT(nn.Module):
    """Decoder-only LM: ``model(tokens [B, T])`` → f32 logits
    ``[B, T, V]``.  Parameters are made on ``device`` from ``seed``;
    ``device`` defaults to this rank's device once :func:`init` has run,
    and to the current CUDA device before.  With no card and no
    ``init()`` it raises: the CPU is used only when ``device="cpu"``
    asks for it."""

    def __init__(self, config: GPTConfig, *, device=None,
                 seed: int = 0) -> None:
        super().__init__()
        self.config = cfg = config
        init = _Init(cfg, device, seed)
        self.embed = Embed(cfg.vocab_size, cfg.d_model, cfg.dtype, init)
        self.pos_embed = init.normal(0.02, cfg.max_seq_len, cfg.d_model)
        for i in range(cfg.n_layer):
            self.add_module(f"block_{i}", Block(cfg, init))
        self.ln_f = LayerNorm(cfg.d_model, cfg.dtype, init)
        self.lm_head = Dense(cfg.d_model, cfg.vocab_size, torch.float32, init)

    def forward(self, tokens, return_hidden: bool = False):
        """Logits, or with ``return_hidden`` the pre-head activations
        ``[B, T, d_model]`` (after ``ln_f``), for the chunked loss
        (:mod:`..ops.xent`), which runs the head product itself."""
        cfg = self.config
        t = tokens.shape[1]
        x = self.embed(tokens) + self.pos_embed[None, :t].to(cfg.dtype)
        for i in range(cfg.n_layer):
            x = getattr(self, f"block_{i}")(x)
        x = self.ln_f(x)
        if return_hidden:
            return x
        return self.lm_head(x)


def lm_loss_fn(model: GPT, *, vocab_chunk_size: int = 0) -> Callable:
    """Next-token cross-entropy: ``loss_fn(model, (inputs, targets))``
    with both ``[B, T]`` (targets pre-shifted), the mean over tokens of
    ``-log_softmax(logits)[target]``.  The step passes the model it
    trains, as the reference's step passes its params.

    ``vocab_chunk_size > 0`` takes the chunked head
    (:func:`..ops.xent.chunked_lm_xent`): the ``[B, T, V]`` logits are
    never materialized; equal to the dense loss at f32 tolerance."""
    del model  # the module in training is the step's argument
    if vocab_chunk_size:
        from ..ops.xent import chunked_lm_xent

        def chunked_loss_fn(module: nn.Module, batch) -> torch.Tensor:
            inputs, targets = batch
            hidden = module(inputs, return_hidden=True)
            return chunked_lm_xent(hidden, module.lm_head.kernel, targets,
                                   chunk_size=vocab_chunk_size)

        return chunked_loss_fn

    def loss_fn(module: nn.Module, batch) -> torch.Tensor:
        inputs, targets = batch
        logp = torch.log_softmax(module(inputs), dim=-1)
        ll = torch.gather(logp, -1, targets[..., None])[..., 0]
        return -ll.mean()

    return loss_fn


def _flatten(tree: Mapping, prefix: str = "") -> dict:
    flat = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            flat.update(_flatten(val, name + "."))
        else:
            flat[name] = val
    return flat


def load_jax_params(model: nn.Module, params: Mapping) -> None:
    """Copy a flax param tree (nested dicts of numpy arrays, as
    ``jax.tree.map(np.asarray, params)`` gives) into ``model``'s
    parameters, name for name.  Raises on a missing, extra or
    mis-shaped leaf."""
    flat = _flatten(params)
    own = dict(model.named_parameters())
    if set(flat) != set(own):
        raise ValueError(
            f"param trees differ: missing {sorted(set(own) - set(flat))}, "
            f"extra {sorted(set(flat) - set(own))}")
    with torch.no_grad():
        for name, p in own.items():
            src = torch.from_numpy(np.array(flat[name], dtype=np.float32))
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                                 f"{tuple(p.shape)}")
            p.copy_(src)
