"""BERT's masked-LM pre-training loss as the benchmark runs it, in
float32 plain PyTorch.

Post-LN blocks: ``ln1(x + attn(x))``, then ``ln2(x + down(gelu_tanh(up(x))))``,
every Dense with a bias; token, position and segment (type 0) embeddings
then ``ln_embed``; non-causal attention with no padding mask.  The head:
``mlm_ln(gelu_tanh(mlm_transform(x)))``, the decoder tied to the token
embedding plus ``mlm_bias``, cross-entropy averaged over the masked
positions.  Only the masked rows reach the decoder: the others add
nothing to the loss or to a gradient.  The pooler is not part of the
loss.  LayerNorm's eps is the one run, from the configuration's
``assumed``.  Every product goes through ``mm``; ``attend`` is the
attention (``witness.py``'s in its place)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.gpt2 import attention


def _ln(x, w, prefix, eps):
    return F.layer_norm(x, x.shape[-1:], w[f"{prefix}.scale"],
                        w[f"{prefix}.bias"], eps)


def _dense(x, w, prefix, mm):
    return mm(x, w[f"{prefix}.kernel"]) + w[f"{prefix}.bias"]


def loss(config: dict, w: dict, batch, mm=torch.matmul,
         attend=attention) -> torch.Tensor:
    input_ids, labels, label_mask = batch
    b, t = input_ids.shape
    h = int(config["num_attention_heads"])
    eps = float(config["assumed"]["layer_norm_eps"])
    x = (w["bert.tok_embed.embedding"][input_ids] + w["bert.pos_embed"][:t]
         + w["bert.seg_embed.embedding"][0])
    x = _ln(x, w, "bert.ln_embed", eps)
    d = x.shape[-1]
    for i in range(int(config["num_hidden_layers"])):
        p = f"bert.block_{i}"
        q, k, v = (y.reshape(b, t, h, d // h).transpose(1, 2)
                   for y in _dense(x, w, f"{p}.attn.qkv", mm).split(d, dim=-1))
        o = attend(q, k, v, mm, causal=False).transpose(1, 2).reshape(b, t, d)
        x = _ln(x + _dense(o, w, f"{p}.attn.out", mm), w, f"{p}.ln1", eps)
        up = F.gelu(_dense(x, w, f"{p}.ffn_up", mm), approximate="tanh")
        x = _ln(x + _dense(up, w, f"{p}.ffn_down", mm), w, f"{p}.ln2", eps)
    picked = label_mask.reshape(-1).nonzero().squeeze(-1)
    hid = x.reshape(b * t, d).index_select(0, picked)
    hid = _ln(F.gelu(_dense(hid, w, "mlm_transform", mm), approximate="tanh"),
              w, "mlm_ln", eps)
    logits = mm(hid, w["bert.tok_embed.embedding"].t()) + w["mlm_bias"]
    return F.cross_entropy(logits, labels.reshape(-1).index_select(0, picked))
