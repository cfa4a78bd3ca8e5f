"""BERT encoder family: the fine-tune and pre-training heads.

Counterpart of ``horovod_tpu/models/bert.py`` (the "BERT-Large
fine-tune with tensor fusion + fp16 Compression" configuration of
``benchmarks/bert_finetune_bench.py``).  Post-LN blocks, learned
position and segment embeddings, the tanh GELU, LayerNorm ε 1e-6, bf16
activations with f32 parameters, f32 heads; parameter names and layouts
are flax's (blocks ``bert.block_0`` …, Dense kernels ``[in, out]``), so
``load_jax_params`` copies a flax tree one to one.

Attention follows the reference's routing: with no padding mask and
``attention="flash"``, a length with ``T % min(128, T) == 0`` runs the
port's flash attention, non-causal (B1, ``ops/flash_attention.py``), any
other length and every masked batch the plain ``full_attention``.  The
masked-LM decoder is tied to the token embedding (``Embed.attend``, in
``dtype``, then f32) plus ``mlm_bias``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import flash_attention as _flash
from ..parallel.ring_attention import full_attention
from .layers import Dense, Embed, Init, LayerNorm


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522            # WordPiece, uncased
    n_layer: int = 24                  # BERT-Large defaults
    n_head: int = 16
    d_model: int = 1024
    d_ff: int = 4096
    max_seq_len: int = 512
    type_vocab_size: int = 2
    attention: str = "full"            # 'full' | 'flash' (no padding mask)
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @staticmethod
    def large(**kw) -> "BertConfig":
        return BertConfig(**kw)

    @staticmethod
    def base(**kw) -> "BertConfig":
        kw.setdefault("n_layer", 12)
        kw.setdefault("n_head", 12)
        kw.setdefault("d_model", 768)
        kw.setdefault("d_ff", 3072)
        return BertConfig(**kw)


def _gelu(x):
    return F.gelu(x, approximate="tanh")      # flax's nn.gelu default


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, init: Init) -> None:
        super().__init__()
        self.cfg = cfg
        c = cfg.d_model
        self.qkv = Dense(c, 3 * c, cfg.dtype, init, bias=True)
        self.out = Dense(c, c, cfg.dtype, init, bias=True)

    def forward(self, x, key_mask=None):
        cfg = self.cfg
        b, t, c = x.shape
        q, k, v = self.qkv(x).split(c, dim=-1)
        q, k, v = (y.reshape(b, t, cfg.n_head, c // cfg.n_head)
                   for y in (q, k, v))
        if cfg.attention == "flash" and key_mask is None:
            # The reference's rule: T < 128 runs as one clamped block,
            # a longer T must divide the 128 block.
            out = (_flash.flash_attention(q, k, v, causal=False)
                   if t % min(128, t) == 0
                   else full_attention(q, k, v, causal=False))
        else:
            out = full_attention(q, k, v, causal=False, key_mask=key_mask)
        return self.out(out.reshape(b, t, c))


class BertBlock(nn.Module):
    """Post-LN encoder block (original BERT residual order)."""

    def __init__(self, cfg: BertConfig, init: Init) -> None:
        super().__init__()
        self.attn = BertSelfAttention(cfg, init)
        self.ln1 = LayerNorm(cfg.d_model, cfg.dtype, init)
        self.ffn_up = Dense(cfg.d_model, cfg.d_ff, cfg.dtype, init, bias=True)
        self.ffn_down = Dense(cfg.d_ff, cfg.d_model, cfg.dtype, init,
                              bias=True)
        self.ln2 = LayerNorm(cfg.d_model, cfg.dtype, init)

    def forward(self, x, key_mask=None):
        x = self.ln1(x + self.attn(x, key_mask))
        return self.ln2(x + self.ffn_down(_gelu(self.ffn_up(x))))


class BertEncoder(nn.Module):
    """Embeddings + N post-LN blocks: ``(sequence, pooled)``.
    ``attention_mask`` is ``[B, T]``, 1 for real tokens (HuggingFace's
    convention); None means all real."""

    def __init__(self, cfg: BertConfig, init: Init) -> None:
        super().__init__()
        self.cfg = cfg
        self.tok_embed = Embed(cfg.vocab_size, cfg.d_model, cfg.dtype, init)
        self.seg_embed = Embed(cfg.type_vocab_size, cfg.d_model, cfg.dtype,
                               init)
        self.pos_embed = init.normal(0.02, cfg.max_seq_len, cfg.d_model)
        self.ln_embed = LayerNorm(cfg.d_model, cfg.dtype, init)
        for i in range(cfg.n_layer):
            self.add_module(f"block_{i}", BertBlock(cfg, init))
        self.pooler = Dense(cfg.d_model, cfg.d_model, cfg.dtype, init,
                            bias=True)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        cfg = self.cfg
        t = input_ids.shape[1]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (self.tok_embed(input_ids)
             + self.pos_embed[None, :t].to(cfg.dtype)
             + self.seg_embed(token_type_ids))
        x = self.ln_embed(x)
        key_mask = None if attention_mask is None else attention_mask > 0
        for i in range(cfg.n_layer):
            x = getattr(self, f"block_{i}")(x, key_mask)
        return x, torch.tanh(self.pooler(x[:, 0]))


class BertForSequenceClassification(nn.Module):
    """The fine-tune head (GLUE-style): f32 logits ``[B, num_classes]``.
    Parameters are made on ``device`` from ``seed``; ``device`` defaults
    to this rank's device after :func:`init`, else the current CUDA
    device (the CPU only when ``device="cpu"``)."""

    def __init__(self, config: BertConfig, num_classes: int = 2, *,
                 device=None, seed: int = 0) -> None:
        super().__init__()
        self.config = config
        init = Init(config.param_dtype, device, seed)
        self.bert = BertEncoder(config, init)
        self.classifier = Dense(config.d_model, num_classes, torch.float32,
                                init, bias=True)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self.classifier(pooled)


class BertForMaskedLM(nn.Module):
    """Pre-training head, the decoder tied to the token embedding: f32
    logits ``[B, T, vocab]``, or with ``return_hidden`` the decoder's
    input ``[B, T, d_model]`` for the chunked loss."""

    def __init__(self, config: BertConfig, *, device=None,
                 seed: int = 0) -> None:
        super().__init__()
        self.config = cfg = config
        init = Init(cfg.param_dtype, device, seed)
        self.bert = BertEncoder(cfg, init)
        self.mlm_transform = Dense(cfg.d_model, cfg.d_model, cfg.dtype, init,
                                   bias=True)
        self.mlm_ln = LayerNorm(cfg.d_model, cfg.dtype, init)
        self.mlm_bias = nn.Parameter(torch.zeros(
            cfg.vocab_size, dtype=torch.float32, device=init.device))

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                return_hidden: bool = False):
        seq, _ = self.bert(input_ids, token_type_ids, attention_mask)
        h = self.mlm_ln(_gelu(self.mlm_transform(seq)))
        if return_hidden:
            return h
        return self.bert.tok_embed.attend(h).to(torch.float32) + self.mlm_bias


def _mlm_batch(batch):
    """``(input_ids, attention_mask, labels, label_mask)`` from a 3- or
    4-tuple batch (the 3-tuple has no attention mask)."""
    if len(batch) == 4:
        return tuple(batch)
    input_ids, labels, label_mask = batch
    return input_ids, None, labels, label_mask


def masked_lm_loss_fn(model: BertForMaskedLM, *,
                      vocab_chunk_size: int = 0) -> Callable:
    """The MLM loss, ``loss_fn(model, batch)``: cross-entropy over the
    positions with ``label_mask`` 1, averaged over them.  ``batch`` is
    ``(input_ids, labels, label_mask)`` or ``(input_ids, attention_mask,
    labels, label_mask)``.  ``vocab_chunk_size > 0`` takes the chunked
    head (:func:`..ops.xent.chunked_lm_xent`, the tied decoder's product
    in f32 a chunk at a time), so the ``[B, T, V]`` logits are never
    materialized."""
    del model  # the module in training is the step's argument
    if vocab_chunk_size:
        from ..ops.xent import chunked_lm_xent

        def chunked_loss(module: nn.Module, batch) -> torch.Tensor:
            input_ids, attention_mask, labels, label_mask = _mlm_batch(batch)
            h = module(input_ids, None, attention_mask, return_hidden=True)
            return chunked_lm_xent(h, module.bert.tok_embed.embedding.t(),
                                   labels, chunk_size=vocab_chunk_size,
                                   bias=module.mlm_bias, mask=label_mask)

        return chunked_loss

    def dense_loss(module: nn.Module, batch) -> torch.Tensor:
        input_ids, attention_mask, labels, label_mask = _mlm_batch(batch)
        logp = torch.log_softmax(module(input_ids, None, attention_mask),
                                 dim=-1)
        ll = torch.gather(logp, -1, labels[..., None])[..., 0]
        m = label_mask.to(torch.float32)
        return -(ll * m).sum() / torch.clamp_min(m.sum(), 1.0)

    return dense_loss


def classification_loss_fn(model: BertForSequenceClassification) -> Callable:
    """Softmax cross-entropy, ``loss_fn(model, batch)``; ``batch`` is
    ``(input_ids, labels)`` or ``(input_ids, attention_mask, labels)``."""
    del model  # the module in training is the step's argument

    def loss_fn(module: nn.Module, batch) -> torch.Tensor:
        if len(batch) == 3:
            input_ids, attention_mask, labels = batch
        else:
            (input_ids, labels), attention_mask = batch, None
        logp = torch.log_softmax(module(input_ids, None, attention_mask),
                                 dim=-1)
        return -torch.gather(logp, -1, labels[:, None]).mean()

    return loss_fn
