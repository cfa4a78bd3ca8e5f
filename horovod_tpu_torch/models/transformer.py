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

Serving (``serve/engine.py``) runs the KV-cache paths:
``model(tokens, kv_caches=caches, positions=pos)`` returns ``(logits,
new_caches)`` over a dense ``{"k", "v"}`` cache per block
(:func:`init_kv_cache`) or a paged ``{"k_pool", "v_pool", "table"}``
one.  The caches are written in place.

A tensor-parallel serving replica (:func:`tensor_parallel_replica`, the
counterpart of the reference's ``GPTConfig.tp_mesh``) is one module
over an explicit list of shard devices (``ColumnShards.devices``): shard
``s`` holds its columns of every ``qkv`` and ``up`` kernel
(:class:`ColumnShards`; of ``qkv`` the ``s``-th heads of q, of k and of
v) on ``devices[s]`` and computes its heads' attention there, over
its own KV cache (a block's cache is a list, one cache a shard); everything else is replicated and lives once, on the
first shard's device.  The reference's gather points become copies in
shard order: the head outputs (cache path and full path) and the
``gelu(up)`` activations are concatenated there before the ``out`` and
``down`` contractions, which run once, on the first shard's device.
Every output element is the same full contraction as in the unsharded
model, so the logits are the unsharded model's wherever a column slice
of a product rounds as the whole product does.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Sequence

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
from .layers import (Dense, Embed, Init, LayerNorm, default_device,  # noqa: F401
                     load_jax_params)

SEQ_ATTENTIONS = ("ring", "ulysses")
_NEG_INF = -1e30  # additive mask value (matches parallel/ring_attention)


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


def init_kv_cache(config: GPTConfig, batch_size: int, max_len: int,
                  device=None):
    """Preallocated per-layer KV cache for autoregressive decode
    (``serve/engine.py``): one ``{"k", "v"}`` pair of ``[B, max_len, H,
    D]`` zeros in ``config.dtype`` per block, on ``device`` (this rank's
    card by default).  The engine allocates it once and writes it in
    place, so decode never reallocates.

    The paged alternative (``serve/kv/``) holds one ``[num_blocks,
    block, H, D]`` pool per layer and a per-slot block table;
    :class:`Attention` takes either layout (``{"k", "v"}`` or
    ``{"k_pool", "v_pool", "table"}``)."""
    head_dim = config.d_model // config.n_head
    if device is None:
        device = default_device()
    shape = (batch_size, max_len, config.n_head, head_dim)
    return [{"k": torch.zeros(shape, dtype=config.dtype, device=device),
             "v": torch.zeros(shape, dtype=config.dtype, device=device)}
            for _ in range(config.n_layer)]


def cached_attention(q, k, v, cache, positions):
    """The KV-cache path's attention (serving prefill chunks and decode
    steps), plain torch as the reference computes it outside any kernel.

    ``positions`` (``[B, T]``) are the chunk's absolute positions, one
    offset per row.  The chunk's K/V are written at them, then exact
    masked attention runs over the whole cache row: keys past a row's
    position are stale or padding, and the ``<= position`` mask hides
    them; a write past the cache is dropped.  Dense ``{"k", "v"}``: the
    rows are written in place and returned.  Paged ``{"k_pool",
    "v_pool", "table"}``: the view is gathered through the block table
    (view row ``i`` is position ``i`` of that row's chain), the chunk
    is written into the view for the chunk's own causality, and the raw
    chunk K/V are returned for the engine to scatter into the pools.
    Returns ``(out [B, T, H, D], new_cache)``."""
    b, _, h, d = q.shape
    paged = "k_pool" in cache
    if paged:
        table = cache["table"]
        k_all = cache["k_pool"][table].reshape(b, -1, h, d)
        v_all = cache["v_pool"][table].reshape(b, -1, h, d)
    else:
        k_all, v_all = cache["k"], cache["v"]
    s = k_all.shape[1]
    # A position past the cache (the drafter's last draft rows near the
    # cache end) drops its write, as JAX drops an out-of-range scatter:
    # its index is clamped and the row there rewritten with itself.
    row = torch.arange(b, device=q.device)[:, None]
    idx = positions.clamp(max=s - 1)
    inb = (positions < s)[..., None, None]
    k_all[row, idx] = torch.where(inb, k.to(k_all.dtype), k_all[row, idx])
    v_all[row, idx] = torch.where(inb, v.to(v_all.dtype), v_all[row, idx])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k_all)
    scores = scores.to(torch.float32) * (d ** -0.5)
    visible = (torch.arange(s, device=q.device)[None, None, :]
               <= positions[:, :, None])
    scores = torch.where(visible[:, None], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v_all)
    if paged:
        return out, {"k": k, "v": v}
    return out, {"k": k_all, "v": v_all}


def column_shard(kernel: torch.Tensor, tp: int, s: int,
                 fused_qkv: bool) -> torch.Tensor:
    """Shard ``s`` of ``tp`` of a column-parallel ``[in, out]`` kernel:
    the ``s``-th contiguous block of columns, or of a fused ``qkv``
    kernel ``[C, 3C]`` the ``s``-th heads of q, of k and of v (as
    :func:`..parallel.sharding.shard_params` cuts it for training)."""
    if fused_qkv:
        third = kernel.shape[1] // 3
        span = third // tp
        return torch.cat([kernel.narrow(1, j * third + s * span, span)
                          for j in range(3)], dim=1)
    span = kernel.shape[1] // tp
    return kernel.narrow(1, s * span, span)


class ColumnShards(nn.Module):
    """A column-parallel Dense of a tensor-parallel serving replica
    (``qkv`` or ``up``): shard ``s`` holds :func:`column_shard` ``s`` of
    the whole kernel on ``devices[s]``.  ``forward`` takes one input a
    shard (on its device) and returns one output a shard; the reference
    places the same slices with ``plan.tp_param_spec``."""

    def __init__(self, kernel: torch.Tensor, devices: Sequence,
                 dtype: torch.dtype, fused_qkv: bool) -> None:
        super().__init__()
        self.dtype = dtype
        self.devices = tuple(torch.device(d) for d in devices)
        self.fused_qkv = fused_qkv
        self.shards = nn.ParameterList(
            nn.Parameter(piece, requires_grad=False)
            for piece in self.place(kernel))

    def place(self, kernel: torch.Tensor) -> list:
        """The whole ``kernel`` cut into this layer's shards, each a
        compact copy on its shard's device."""
        tp = len(self.devices)
        return [column_shard(kernel, tp, s, self.fused_qkv).to(
                    device=d, dtype=kernel.dtype, copy=True).contiguous()
                for s, d in enumerate(self.devices)]

    def load(self, pieces: Sequence[torch.Tensor]) -> None:
        """Re-point every shard at ``pieces`` (from :meth:`place`)."""
        for p, piece in zip(self.shards, pieces):
            p.data = piece

    def whole(self) -> torch.Tensor:
        """The whole kernel, reassembled on the first shard's device."""
        pieces = [p.detach().to(self.devices[0]) for p in self.shards]
        if not self.fused_qkv:
            return torch.cat(pieces, dim=1)
        thirds = [piece.chunk(3, dim=1) for piece in pieces]
        return torch.cat([torch.cat([t[j] for t in thirds], dim=1)
                          for j in range(3)], dim=1)

    def forward(self, xs: Sequence[torch.Tensor]) -> list:
        return [torch.matmul(x.to(self.dtype), k.to(self.dtype))
                for x, k in zip(xs, self.shards)]


class Attention(nn.Module):
    def __init__(self, cfg: GPTConfig, init: Init, plan=None) -> None:
        super().__init__()
        self.cfg = cfg
        self.plan = plan
        c = cfg.d_model
        self.qkv = Dense(c, 3 * c, cfg.dtype, init)
        self.out = Dense(c, c, cfg.dtype, init)

    def forward(self, x, cache=None, positions=None):
        """``cache`` (one block's KV cache) and ``positions`` (``[B,
        T]``) take the KV-cache path and return ``(y, new_cache)``."""
        if isinstance(self.qkv, ColumnShards):
            return self._tp_forward(x, cache, positions)
        cfg = self.cfg
        b, t, c = x.shape
        d = c // cfg.n_head
        # Under tp, shard_params left this rank h of the heads.
        h = self.qkv.kernel.shape[1] // (3 * d)
        tp = split_group(self.plan, "tp", h, cfg.n_head, "attention heads")
        if cache is not None and tp is not None:
            raise ValueError(
                "a training tensor-parallel mesh has no KV-cache path; "
                "serve through tensor_parallel_replica (the engine's tp=)")
        if tp is not None:
            x = copy_to(x, tp)
        q, k, v = self.qkv(x).split(h * d, dim=-1)
        q, k, v = (y.reshape(b, t, h, d) for y in (q, k, v))
        if cache is not None:
            out, new_cache = cached_attention(q, k, v, cache, positions)
            return self.out(out.reshape(b, t, h * d)), new_cache
        y = self.out(self._attend(q, k, v).reshape(b, t, h * d))
        return y if tp is None else reduce_from(y, tp)

    def _tp_forward(self, x, cache, positions):
        """A tensor-parallel serving replica's attention: each shard
        computes its heads' q, k, v and attention on its device (over
        its own cache under ``cache``, one cache a shard), then the
        head outputs are concatenated in shard order on ``x``'s device
        (the reference's gather points) before the replicated ``out``."""
        cfg = self.cfg
        b, t, c = x.shape
        d = c // cfg.n_head
        devices = self.qkv.devices
        h = cfg.n_head // len(devices)
        outs, new_caches = [], []
        for s, (dev, y) in enumerate(zip(devices, self.qkv(
                [x.to(dev) for dev in devices]))):
            q, k, v = (z.reshape(b, t, h, d) for z in y.split(h * d, dim=-1))
            if cache is not None:
                out, new_cache = cached_attention(q, k, v, cache[s],
                                                  positions.to(dev))
                new_caches.append(new_cache)
            else:
                out = self._attend(q, k, v)
            outs.append(out.to(x.device))
        y = self.out(torch.cat(outs, dim=2).reshape(b, t, c))
        return (y, new_caches) if cache is not None else y

    def _attend(self, q, k, v):
        """The full-sequence attention of ``cfg.attention`` over
        ``[B, T, H, D]`` q, k, v."""
        cfg = self.cfg
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
        return out


class MlpBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, init: Init, plan=None) -> None:
        super().__init__()
        self.cfg = cfg
        self.plan = plan
        self.up = Dense(cfg.d_model, cfg.d_ff, cfg.dtype, init)
        self.down = Dense(cfg.d_ff, cfg.d_model, cfg.dtype, init)

    def forward(self, x):
        if isinstance(self.up, ColumnShards):
            # Tensor-parallel serving: each shard's gelu(up) columns,
            # concatenated in shard order before the replicated down.
            acts = [F.gelu(u, approximate="tanh").to(x.device)
                    for u in self.up([x.to(d) for d in self.up.devices])]
            return self.down(torch.cat(acts, dim=-1))
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

    def forward(self, x, cache=None, positions=None):
        """With ``cache`` (and ``positions``) returns ``(x,
        new_cache)``."""
        new_cache = None
        if cache is not None:
            a, new_cache = self.attn(self.ln1(x), cache=cache,
                                     positions=positions)
        else:
            a = self.attn(self.ln1(x))
        x = x + a
        ffn = self.moe if self.use_moe else self.mlp
        x = x + ffn(self.ln2(x))
        if cache is not None:
            return x, new_cache
        return x


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

    def forward(self, tokens, return_hidden: bool = False,
                kv_caches=None, positions=None):
        """Logits, or with ``return_hidden`` the pre-head activations
        ``[B, T, d_model]`` (after ``ln_f``), for the chunked loss
        (:mod:`..ops.xent`), which runs the head product itself.

        Serving: ``kv_caches`` (one cache per block, from
        :func:`init_kv_cache` or the engine's paged pools) and
        ``positions`` (``[B, T]`` absolute positions of the chunk)
        return ``(logits, new_caches)``.  A position past the
        positional table (the engine's trash rows) reads its last row,
        as the reference's clamped gather does."""
        cfg = self.config
        t = tokens.shape[1]
        if kv_caches is not None:
            if cfg.attention in SEQ_ATTENTIONS:
                # Sequence-sharded training layouts have no KV-cache
                # analogue; decode is a per-replica workload.
                raise ValueError(
                    f"KV-cache decode requires attention='full' or "
                    f"'flash', not {cfg.attention!r}")
            if positions is None:
                raise ValueError("kv_caches requires positions ([B, T] "
                                 "absolute token positions)")
            pos = self.pos_embed[positions.clamp(max=cfg.max_seq_len - 1)]
            x = self.embed(tokens) + pos.to(cfg.dtype)
            new_caches = []
            for i in range(cfg.n_layer):
                x, c = getattr(self, f"block_{i}")(
                    x, cache=kv_caches[i], positions=positions)
                new_caches.append(c)
            x = self.ln_f(x)
            if return_hidden:
                return x
            return self.lm_head(x), new_caches
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


def tensor_parallel_replica(model: GPT, devices: Sequence) -> GPT:
    """A tensor-parallel serving replica of ``model`` over ``devices``
    (shard order; repeats allowed), for ``serve/engine.py``'s ``tp``.

    The replica is a copy of the module: its replicated parameters are
    ``model``'s, on ``devices[0]`` (the same storage when ``model``
    lives there), held by parameter objects of its own, so a weight
    flip on the replica leaves ``model`` as it was; each ``qkv`` and
    ``up`` is a :class:`ColumnShards` over ``devices``.  ``model`` is
    not changed."""
    cfg = model.config
    devices = tuple(torch.device(d) for d in devices)
    tp = len(devices)
    if model.plan is not None:
        raise ValueError("a tensor-parallel serving replica starts from "
                         "an unsharded model (no training mesh)")
    if cfg.moe_experts:
        raise ValueError("tensor-parallel serving covers the dense FFN, "
                         "not MoE blocks")
    if cfg.attention in SEQ_ATTENTIONS:
        raise ValueError(f"attention={cfg.attention!r} has no serving "
                         f"path")
    if cfg.n_head % tp or cfg.d_ff % tp:
        raise ValueError(f"tp={tp} must divide the head count "
                         f"({cfg.n_head}) and d_ff ({cfg.d_ff})")
    sharded = {id(getattr(model, f"block_{i}").attn.qkv.kernel)
               for i in range(cfg.n_layer)}
    sharded |= {id(getattr(model, f"block_{i}").mlp.up.kernel)
                for i in range(cfg.n_layer)}
    # Replicated leaves: new parameter objects over the same (or moved)
    # storage; the whole qkv/up kernels are replaced below.
    memo = {id(p): (p if id(p) in sharded else nn.Parameter(
                p.detach().to(devices[0]), requires_grad=False))
            for p in model.parameters()}
    replica = copy.deepcopy(model, memo)
    for i in range(cfg.n_layer):
        src, blk = getattr(model, f"block_{i}"), getattr(replica, f"block_{i}")
        blk.attn.qkv = ColumnShards(src.attn.qkv.kernel.detach(), devices,
                                    cfg.dtype, fused_qkv=True)
        blk.mlp.up = ColumnShards(src.mlp.up.kernel.detach(), devices,
                                  cfg.dtype, fused_qkv=False)
    return replica


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
