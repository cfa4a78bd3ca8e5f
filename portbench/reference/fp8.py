"""The control's product: both operands rounded to float8 e4m3 with one
scale a tensor (amax to 448), the incoming gradient to e5m2 (amax to
57344), products and sums in float32.  This is the step below the
configurations' bfloat16 that a later change could be tempted to take
(fp8 training's usual recipe); the control has to fail ``correct``."""

from __future__ import annotations

import torch

_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def round_fp8(x: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """``x`` through ``dtype`` and back, scaled so its amax is the
    format's largest value."""
    scale = _MAX[dtype] / x.detach().abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Fp8MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = round_fp8(a), round_fp8(b)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = round_fp8(g, torch.float8_e5m2)
        ga = torch.matmul(qg, qb.transpose(-1, -2))
        if qb.dim() == 2:      # a [..., k] @ b [k, n]: sum over a's rows
            gb = (qa.reshape(-1, qa.shape[-1]).t()
                  @ qg.reshape(-1, qg.shape[-1]))
        else:
            gb = torch.matmul(qa.transpose(-1, -2), qg)
        return ga, gb


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _Fp8MatMul.apply(a, b)
