"""A witness for the worst leaves of BERT's change (``PERF.md``): float32
softmax attention whose backward takes Δ = rowsum(dO·O) from O rounded
to bfloat16, as the port's flash backward takes it from the bfloat16 O
its forward saved; every other product and sum stays float32.  With
``round_o=False`` Δ comes from the float32 O, and the gradient is plain
attention's to float32 rounding.

Put in the reference's place (``attend=``), it shows whether that one
rounding gives the gaps that the program's deep query and key leaves
read against the float32 reference."""

from __future__ import annotations

import torch


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, round_o):
        scale = q.shape[-1] ** -0.5
        s = torch.matmul(q, k.transpose(-1, -2)) * scale
        if causal:
            t = q.shape[-2]
            keep = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
            s = s.masked_fill(~keep, float("-inf"))
        p = torch.softmax(s, dim=-1)
        o = torch.matmul(p, v)
        ctx.save_for_backward(q, k, v, p, o)
        ctx.scale, ctx.round_o = scale, round_o
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, p, o = ctx.saved_tensors
        if ctx.round_o:
            o = o.to(torch.bfloat16).to(torch.float32)
        delta = (do * o).sum(dim=-1, keepdim=True)
        dp = torch.matmul(do, v.transpose(-1, -2))
        ds = p * (dp - delta) * ctx.scale
        return (torch.matmul(ds, k), torch.matmul(ds.transpose(-1, -2), q),
                torch.matmul(p.transpose(-1, -2), do), None, None)


def attention(round_o: bool):
    """An ``attend`` for the reference's losses; the product ``mm`` is
    float32's own."""
    def attend(q, k, v, mm, causal: bool):
        return _Attention.apply(q, k, v, causal, round_o)
    return attend
