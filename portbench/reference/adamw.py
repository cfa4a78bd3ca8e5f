"""AdamW with decoupled weight decay and bias correction, written out
(Loshchilov and Hutter 2019; the update ``torch.optim.AdamW`` documents)."""

from __future__ import annotations

import math
from typing import Dict

import torch


class AdamW:
    def __init__(self, lr: float, weight_decay: float, betas=(0.9, 0.999),
                 eps: float = 1e-8) -> None:
        self.lr, self.wd, self.eps = float(lr), float(weight_decay), float(eps)
        self.b1, self.b2 = (float(b) for b in betas)
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.t = 0

    @torch.no_grad()
    def step(self, w: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for name, p in w.items():
            g = grads[name]
            m = self.m.setdefault(name, torch.zeros_like(p))
            v = self.v.setdefault(name, torch.zeros_like(p))
            p.mul_(1.0 - self.lr * self.wd)
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = v.sqrt().div_(math.sqrt(c2)).add_(self.eps)
            p.addcdiv_(m, denom, value=-self.lr / c1)
