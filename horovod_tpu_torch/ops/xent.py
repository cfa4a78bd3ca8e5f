"""Memory-efficient LM cross-entropy, chunked over tokens.

Counterpart of ``horovod_tpu/ops/xent.py``.  With a 32k vocabulary the
``[B, T, V]`` f32 logits are the largest activation of a GPT step
(8 × 1024 × 32000 × 4 B = 1 GiB), and the dense loss keeps three such
tensors (the logits, the log-softmax and its gradient).  Here the head
product and the loss run one chunk of tokens at a time, each chunk under
``torch.utils.checkpoint``, so only ``[chunk, V]`` logits are alive at
once and the backward recomputes each chunk's logits: one more head
product for a ``T / chunk`` cut of the head's activation memory.

The head product is a plain matrix product (no Pallas kernel in the
reference), so it stays ``torch.matmul``; the chunk loop is a Python
loop (the reference's ``lax.scan``), adding each chunk's sum in chunk
order in f32.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint


def _chunk_loss(hc: torch.Tensor, tc: torch.Tensor, mc: torch.Tensor,
                kernel: torch.Tensor, bias: Optional[torch.Tensor],
                compute_dtype: torch.dtype) -> torch.Tensor:
    """Sum over one chunk of ``mask * (logsumexp(logits) - logits[t])``,
    the logits in f32 from a head product in ``compute_dtype``."""
    logits = torch.matmul(hc.to(compute_dtype),
                          kernel.to(compute_dtype)).to(torch.float32)
    if bias is not None:
        logits = logits + bias.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, tc[:, None])[:, 0]
    return ((lse - tgt) * mc).sum()


def chunked_lm_xent(hidden: torch.Tensor, kernel: torch.Tensor,
                    targets: torch.Tensor, *, chunk_size: int = 512,
                    bias: Optional[torch.Tensor] = None,
                    mask: Optional[torch.Tensor] = None,
                    compute_dtype: torch.dtype = torch.float32,
                    ) -> torch.Tensor:
    """Mean next-token cross-entropy without materializing the logits.

    ``hidden [B, T, D]`` (any float dtype) are the pre-head activations,
    ``kernel [D, V]`` the head, ``targets [B, T]`` the labels;
    ``chunk_size`` tokens a chunk (the live logits are ``chunk_size × V
    × 4`` bytes); ``bias [V]`` an optional head bias; ``mask [B, T]``
    (1 = real token) takes the mean over the real tokens only.
    ``compute_dtype`` is the head product's dtype: the f32 default is the
    dense f32 ``lm_head``'s product, bf16 trades ~1e-2 relative gradient
    error for the tensor cores.  The log-sum-exp is in f32.

    Equals ``-mean(log_softmax(hidden @ kernel + bias)[targets])`` to
    f32 tolerance."""
    b, t, d = hidden.shape
    n = b * t
    h = hidden.reshape(n, d)
    tg = targets.reshape(n)
    m = (torch.ones(n, dtype=torch.float32, device=hidden.device)
         if mask is None else mask.reshape(n).to(torch.float32))
    c = max(1, min(int(chunk_size), n))
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for start in range(0, n, c):
        stop = min(start + c, n)
        total = total + checkpoint(
            _chunk_loss, h[start:stop], tg[start:stop], m[start:stop],
            kernel, bias, compute_dtype, use_reentrant=False)
    return total / torch.clamp_min(m.sum(), 1.0)
