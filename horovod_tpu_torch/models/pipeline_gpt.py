"""Pipeline-parallel GPT: the trunk over the ``pipe``/``pp`` axis.

Counterpart of ``horovod_tpu/models/pipeline_gpt.py``.  The ``n_layer``
blocks become ``pp`` stages of ``n_layer // pp`` blocks; rank ``s`` of
the ``pp`` group holds stage ``s``'s blocks (``stages.block_i``, its
``i``-th), plus the embedding and the head, which run outside the
pipeline.  Microbatches flow through
:func:`..parallel.pipeline.pipeline_apply`.

The reference's parameters are ``{embed, stages, head}`` with a leading
``[pp]`` dim on every ``stages`` leaf; :func:`.layers.load_jax_params`
loads rank ``s`` with row ``s`` of it (:meth:`PipelinedGPT.jax_params_view`).
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch import nn

from ..parallel.pipeline import pipeline_apply, pipeline_axes
from ..plan import resolve_plan
from .layers import Dense, Embed, Init, LayerNorm
from .transformer import Block, GPTConfig, lm_loss_fn


class _Embed(nn.Module):
    def __init__(self, cfg: GPTConfig, init: Init) -> None:
        super().__init__()
        self.dtype = cfg.dtype
        self.embed = Embed(cfg.vocab_size, cfg.d_model, cfg.dtype, init)
        self.pos_embed = init.normal(0.02, cfg.max_seq_len, cfg.d_model)

    def forward(self, tokens):
        t = tokens.shape[1]
        return self.embed(tokens) + self.pos_embed[None, :t].to(self.dtype)


class _Stage(nn.Module):
    """``n_layer // pp`` consecutive blocks: one pipeline stage."""

    def forward(self, x):
        for block in self.children():
            x = block(x)
        return x


class _Head(nn.Module):
    def __init__(self, cfg: GPTConfig, init: Init) -> None:
        super().__init__()
        self.ln_f = LayerNorm(cfg.d_model, cfg.dtype, init)
        self.lm_head = Dense(cfg.d_model, cfg.vocab_size, torch.float32, init)

    def forward(self, x):
        return self.lm_head(self.ln_f(x))


class PipelinedGPT(nn.Module):
    """GPT with its trunk pipelined over the plan's ``pp`` axis:
    ``model(tokens [b, T])`` → f32 logits ``[b, T, V]``, ``tokens`` this
    rank's rows (the batch splits over the other axes).

    Its blocks are dense, as the reference's stages are.  The weights
    equal ``GPT(config, seed=seed)``'s: stage ``s`` keeps
    blocks ``[s·k, (s + 1)·k)`` (``k = n_layer // pp``), and the other
    blocks are drawn and dropped, so that the generator moves as GPT's
    does.  ``n_micro`` microbatches must divide the rank's rows;
    ``dp_axis`` names the batch axis (:func:`..parallel.pipeline_axes`);
    ``remat`` recomputes each stage in the backward."""

    def __init__(self, config: GPTConfig, mesh=None, *, plan=None,
                 n_micro: int = 2, pp_axis: Optional[str] = None,
                 dp_axis: Optional[str] = "dp", remat: bool = False,
                 device=None, seed: int = 0) -> None:
        super().__init__()
        if config.attention not in ("full", "flash"):
            raise ValueError(
                "PipelinedGPT stages run attention per microbatch; use "
                "attention='full' or 'flash' (sp composes through the "
                "non-pipelined GPT)")
        self.config = cfg = config
        self.plan = resolve_plan(mesh, plan)
        self.pp_axis, self.dp_axis = pipeline_axes(self.plan, pp_axis,
                                                   dp_axis)
        self.n_stages = self.plan.axis_size(self.pp_axis)
        self.n_micro = n_micro
        self.remat = remat
        if cfg.n_layer % self.n_stages:
            raise ValueError(
                f"n_layer ({cfg.n_layer}) must divide into the pp axis "
                f"size ({self.n_stages})")
        self.blocks_per_stage = k = cfg.n_layer // self.n_stages
        self.stage_index = s = self.plan.coords()[self.pp_axis]
        init = Init(cfg.param_dtype, device, seed)
        self.embed = _Embed(cfg, init)
        self.stages = _Stage()
        for i in range(cfg.n_layer):
            block = Block(cfg, init, self.plan)
            if s * k <= i < (s + 1) * k:
                self.stages.add_module(f"block_{i - s * k}", block)
        self.head = _Head(cfg, init)

    def mesh_plan(self):
        return self.plan

    def jax_params_view(self, params: Mapping) -> Mapping:
        """The reference's tree with each ``stages`` leaf cut to this
        rank's stage, for :func:`.layers.load_jax_params`."""
        def row(tree):
            if isinstance(tree, Mapping):
                return {key: row(val) for key, val in tree.items()}
            return tree[self.stage_index]

        return {**params, "stages": row(params["stages"])}

    def forward(self, tokens):
        x = self.embed(tokens)
        x = pipeline_apply(lambda stage, h: stage(h), self.stages, x,
                           plan=self.plan, n_micro=self.n_micro,
                           pp_axis=self.pp_axis, dp_axis=self.dp_axis,
                           remat=self.remat)
        return self.head(x)


def pipelined_lm_loss_fn(model: PipelinedGPT):
    """Next-token cross-entropy of the pipelined model: the contract of
    :func:`.transformer.lm_loss_fn` (the mean over the global batch,
    summed over the batch axes; every pp rank computes it whole)."""
    return lm_loss_fn(model)
