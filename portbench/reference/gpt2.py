"""GPT-2 as the benchmark runs it, in float32 plain PyTorch.

Pre-LN blocks: ``x + attn(ln1(x))``, then ``x + down(gelu_tanh(up(ln2(x))))``;
learned positions; causal softmax attention over ``n_head`` heads;
``ln_f`` then an untied ``lm_head``; the mean next-token cross-entropy.
Departures from GPT-2 (no Dense biases, LayerNorm eps 1e-6, the untied
head, no dropout) are the configuration's ``assumed``: the values run
are read from there.  Every product goes through ``mm`` so the control
can lower its precision; ``attend`` is the attention (``witness.py``'s
in its place)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _ln(x, w, prefix, eps):
    return F.layer_norm(x, x.shape[-1:], w[f"{prefix}.scale"],
                        w[f"{prefix}.bias"], eps)


def attention(q, k, v, mm, causal: bool):
    """``[B, H, T, D]`` softmax attention in float32."""
    t = q.shape[-2]
    s = mm(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    if causal:
        keep = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return mm(torch.softmax(s, dim=-1), v)


def loss(config: dict, w: dict, batch, mm=torch.matmul,
         attend=attention) -> torch.Tensor:
    inputs, targets = batch
    b, t = inputs.shape
    h = int(config["n_head"])
    eps = float(config["assumed"]["layer_norm_epsilon"])
    x = w["embed.embedding"][inputs] + w["pos_embed"][:t]
    d = x.shape[-1]
    for i in range(int(config["n_layer"])):
        p = f"block_{i}"
        qkv = mm(_ln(x, w, f"{p}.ln1", eps), w[f"{p}.attn.qkv.kernel"])
        q, k, v = (y.reshape(b, t, h, d // h).transpose(1, 2)
                   for y in qkv.split(d, dim=-1))
        o = attend(q, k, v, mm, causal=True).transpose(1, 2).reshape(b, t, d)
        x = x + mm(o, w[f"{p}.attn.out.kernel"])
        up = mm(_ln(x, w, f"{p}.ln2", eps), w[f"{p}.mlp.up.kernel"])
        x = x + mm(F.gelu(up, approximate="tanh"), w[f"{p}.mlp.down.kernel"])
    logits = mm(_ln(x, w, "ln_f", eps), w["lm_head.kernel"])
    return F.cross_entropy(logits.reshape(b * t, -1), targets.reshape(-1))
