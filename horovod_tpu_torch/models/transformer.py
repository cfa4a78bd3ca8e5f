"""Decoder-only transformer (GPT) with pluggable parallel attention.

Counterpart of ``horovod_tpu/models/transformer.py`` (training paths).
The parameters keep the reference's layout and names, so a flax param
tree loads into this model one to one (:func:`load_jax_params`): each
Dense kernel is ``[in, out]`` and is applied as ``x @ kernel``; names
are the flax paths joined by dots (``block_0.attn.qkv.kernel``,
``embed.embedding``, ``pos_embed``).

The layers (``Dense``, ``LayerNorm``, ``Embed``) and
:func:`load_jax_params` live in :mod:`.layers`, shared with the zoo.
Numerics follow flax: activations in ``cfg.dtype`` (bfloat16 by
default) with f32 parameters; LayerNorm with ε = 1e-6 and f32
statistics (mean of x and of x², as flax's fast variance); the tanh
GELU; positions added after a cast to ``cfg.dtype``; ``lm_head`` in f32.

On a mesh (``GPT(cfg, mesh=make_mesh({'dp': .., 'sp': .., 'tp': ..}))``)
a rank holds its shard of the batch (``dp``) and of the sequence
(``sp``, with ``attention='ring' | 'ulysses'``; its positions are its
block's) and, after :func:`..parallel.sharding.shard_params`, its heads
and its FFN columns (``tp``): ``qkv`` and ``up`` column-parallel,
``out`` and ``down`` row-parallel.  The loss of :func:`lm_loss_fn` is
then the global mean, summed over the batch axes.

With ``moe_experts > 0`` every ``moe_every``-th block's FFN is a
mixture of experts (:class:`..parallel.moe.MoEMlp`), its experts cut
over the mesh's ``ep`` axis; a caller adds
:func:`..parallel.moe.moe_aux_loss` to its loss when it wants the
load-balancing term.

The KV-cache paths and tensor-parallel serving (``tp_mesh``) are not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import flash_attention as _flash
from ..parallel.comm import copy_to, reduce_from
from ..parallel.moe import MoEMlp
from ..parallel.sharding import split_group
from ..parallel.ring_attention import full_attention, ring_self_attention
from ..parallel.ulysses import ulysses_attention
from ..plan import resolve_plan
from .layers import Dense, Embed, Init, LayerNorm, load_jax_params  # noqa: F401

SEQ_ATTENTIONS = ("ring", "ulysses")


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 32000
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    d_ff: int = 3072
    max_seq_len: int = 2048
    causal: bool = True
    attention: str = "full"            # 'full' | 'flash' | 'ring' | 'ulysses'
    attention_engine: str = "xla"      # ring per-block engine: 'xla' | 'flash'
    moe_experts: int = 0               # 0 = dense FFN; >0 = MoE with ep axis
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_every: int = 2                 # every Nth block is MoE (rest dense)
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32


class Attention(nn.Module):
    def __init__(self, cfg: GPTConfig, init: Init, plan=None) -> None:
        super().__init__()
        self.cfg = cfg
        self.plan = plan
        c = cfg.d_model
        self.qkv = Dense(c, 3 * c, cfg.dtype, init)
        self.out = Dense(c, c, cfg.dtype, init)

    def forward(self, x):
        cfg = self.cfg
        b, t, c = x.shape
        d = c // cfg.n_head
        # Under tp, shard_params left this rank h of the heads.
        h = self.qkv.kernel.shape[1] // (3 * d)
        tp = split_group(self.plan, "tp", h, cfg.n_head, "attention heads")
        if tp is not None:
            x = copy_to(x, tp)
        q, k, v = self.qkv(x).split(h * d, dim=-1)
        q, k, v = (y.reshape(b, t, h, d) for y in (q, k, v))
        if cfg.attention in SEQ_ATTENTIONS:
            if self.plan is None:
                raise ValueError(
                    f"attention={cfg.attention!r} requires a mesh")
            if cfg.attention == "ring":
                out = ring_self_attention(q, k, v, plan=self.plan,
                                          causal=cfg.causal,
                                          engine=cfg.attention_engine)
            else:
                out = ulysses_attention(q, k, v, plan=self.plan,
                                        causal=cfg.causal)
        elif cfg.attention == "flash":
            if cfg.causal:
                out = _flash.flash_attention_padded(q, k, v)
            else:
                out = _flash.flash_attention(q, k, v, causal=False)
        elif cfg.attention == "full":
            out = full_attention(q, k, v, causal=cfg.causal)
        else:
            raise ValueError(f"Unknown attention {cfg.attention!r}")
        y = self.out(out.reshape(b, t, h * d))
        return y if tp is None else reduce_from(y, tp)


class MlpBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, init: Init, plan=None) -> None:
        super().__init__()
        self.cfg = cfg
        self.plan = plan
        self.up = Dense(cfg.d_model, cfg.d_ff, cfg.dtype, init)
        self.down = Dense(cfg.d_ff, cfg.d_model, cfg.dtype, init)

    def forward(self, x):
        tp = split_group(self.plan, "tp", self.up.kernel.shape[1],
                         self.cfg.d_ff, "the FFN")
        if tp is not None:
            x = copy_to(x, tp)
        y = self.down(F.gelu(self.up(x), approximate="tanh"))
        return y if tp is None else reduce_from(y, tp)


class Block(nn.Module):
    """A pre-LN block; ``use_moe`` puts :class:`..parallel.moe.MoEMlp`
    (``moe``) where the dense FFN (``mlp``) would be."""

    def __init__(self, cfg: GPTConfig, init: Init, plan=None,
                 use_moe: bool = False) -> None:
        super().__init__()
        self.ln1 = LayerNorm(cfg.d_model, cfg.dtype, init)
        self.attn = Attention(cfg, init, plan)
        self.ln2 = LayerNorm(cfg.d_model, cfg.dtype, init)
        self.use_moe = use_moe
        if use_moe:
            self.moe = MoEMlp(cfg.d_model, cfg.d_ff, cfg.moe_experts,
                              init=init, top_k=cfg.moe_top_k,
                              capacity_factor=cfg.moe_capacity_factor,
                              dtype=cfg.dtype, plan=plan)
        else:
            self.mlp = MlpBlock(cfg, init, plan)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        ffn = self.moe if self.use_moe else self.mlp
        return x + ffn(self.ln2(x))


class GPT(nn.Module):
    """Decoder-only LM: ``model(tokens [B, T])`` → f32 logits
    ``[B, T, V]``.  Parameters are made on ``device`` from ``seed``;
    ``device`` defaults to this rank's device once :func:`init` has run,
    and to the current CUDA device before.  With no card and no
    ``init()`` it raises: the CPU is used only when ``device="cpu"``
    asks for it.

    ``mesh=`` (or ``plan=``, a :class:`..plan.MeshPlan`) puts the model
    on a ``dp``/``sp``/``tp`` layout: ``tokens`` are then this rank's
    ``[B / dp, T / sp]`` block, and the logits its block's.  The
    parameters are built whole on every rank (the same seed gives the
    same weights); :func:`..parallel.sharding.shard_params` then keeps
    the rank's ``tp`` slices."""

    def __init__(self, config: GPTConfig, *, mesh=None, plan=None,
                 device=None, seed: int = 0) -> None:
        super().__init__()
        self.config = cfg = config
        self.plan = (resolve_plan(mesh, plan)
                     if mesh is not None or plan is not None else None)
        if (self.plan is not None and self.plan.has_axis("sp")
                and self.plan.axis_size("sp") > 1
                and cfg.attention not in SEQ_ATTENTIONS):
            raise ValueError(
                f"a mesh with sp={self.plan.axis_size('sp')} shards the "
                f"sequence: attention={cfg.attention!r} would attend only "
                f"the rank's block; use 'ring' or 'ulysses'")
        init = Init(cfg.param_dtype, device, seed)
        self.embed = Embed(cfg.vocab_size, cfg.d_model, cfg.dtype, init)
        self.pos_embed = init.normal(0.02, cfg.max_seq_len, cfg.d_model)
        for i in range(cfg.n_layer):
            use_moe = (cfg.moe_experts > 0
                       and (i + 1) % max(1, cfg.moe_every) == 0)
            self.add_module(f"block_{i}", Block(cfg, init, self.plan,
                                                use_moe=use_moe))
        self.ln_f = LayerNorm(cfg.d_model, cfg.dtype, init)
        self.lm_head = Dense(cfg.d_model, cfg.vocab_size, torch.float32, init)

    def mesh_plan(self):
        """The model's :class:`..plan.MeshPlan`, or None off a mesh."""
        return self.plan

    def forward(self, tokens, return_hidden: bool = False):
        """Logits, or with ``return_hidden`` the pre-head activations
        ``[B, T, d_model]`` (after ``ln_f``), for the chunked loss
        (:mod:`..ops.xent`), which runs the head product itself."""
        cfg = self.config
        t = tokens.shape[1]
        start = 0
        if self.plan is not None and self.plan.has_axis("sp"):
            # A sequence shard: rank s of sp holds positions [s·t, (s+1)·t).
            start = self.plan.coords()["sp"] * t
        pos = self.pos_embed[None, start:start + t]
        x = self.embed(tokens) + pos.to(cfg.dtype)
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
    trains, as the reference's step passes its params.  On a model with
    a mesh it is the mean over the global batch (:func:`_global_mean`),
    for :func:`..parallel.train.make_spmd_train_step`.

    ``vocab_chunk_size > 0`` takes the chunked head
    (:func:`..ops.xent.chunked_lm_xent`): the ``[B, T, V]`` logits are
    never materialized; equal to the dense loss at f32 tolerance."""
    del model  # the module in training is the step's argument
    if vocab_chunk_size:
        from ..ops.xent import chunked_lm_xent

        def chunked_loss_fn(module: nn.Module, batch) -> torch.Tensor:
            inputs, targets = batch
            hidden = module(inputs, return_hidden=True)
            return _global_mean(module, chunked_lm_xent(
                hidden, module.lm_head.kernel, targets,
                chunk_size=vocab_chunk_size))

        return chunked_loss_fn

    def loss_fn(module: nn.Module, batch) -> torch.Tensor:
        inputs, targets = batch
        logp = torch.log_softmax(module(inputs), dim=-1)
        ll = torch.gather(logp, -1, targets[..., None])[..., 0]
        return _global_mean(module, -ll.mean())

    return loss_fn


def _global_mean(module: nn.Module, local_mean: torch.Tensor):
    """The reference's ``jnp.mean`` over the global batch: on a model
    whose mesh splits the batch (``dp``, ``sp``), the local mean over the
    group's width (the local sum over the global token count; every
    rank holds as many tokens) summed over the group, with the identity
    backward, so each rank's autograd sees its own share; unchanged off
    a mesh."""
    plan = module.mesh_plan() if hasattr(module, "mesh_plan") else None
    if plan is None:
        return local_mean
    group = plan.group(plan.batch_axes())
    if group.size == 1:
        return local_mean
    return reduce_from(local_mean / group.size, group)
