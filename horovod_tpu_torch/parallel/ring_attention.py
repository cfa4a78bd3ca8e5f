"""Plain softmax attention, for models with no sequence axis.

Counterpart of ``horovod_tpu/parallel/ring_attention.py::full_attention``
(ring attention itself is not ported yet).
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def full_attention(q, k, v, *, causal: bool = False,
                   scale: Optional[float] = None, key_mask=None):
    """q ``[B, Tq, H, D]``, k/v ``[B, Tk, H, D]`` → ``[B, Tq, H, D]``:
    f32 scores and softmax, the product in q's dtype.  ``key_mask``
    (``[B, Tk]`` bool) drops False keys from every query's softmax."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    if causal:
        tq, tk = scores.shape[-2], scores.shape[-1]
        qpos = torch.arange(tq, device=q.device)[:, None]
        kpos = torch.arange(tk, device=q.device)[None, :]
        scores = torch.where(qpos >= kpos, scores, NEG_INF)
    if key_mask is not None:
        scores = torch.where(key_mask[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)
