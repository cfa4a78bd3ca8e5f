"""The reference's first steps of training, and the numbers compared.

From the same weights and the same batches as the program's, every rank's
batch of a step is run through the family's float32 loss, the gradients
averaged over the ranks exactly, and AdamW stepped.  It records each
step's loss (the mean over ranks), the norm of each leaf's first
gradient, and the norm of each leaf's change after the last step.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

from portbench.core.judge import part_norms
from portbench.reference.adamw import AdamW


def run(loss_fn: Callable, config: dict, weights: Dict[str, torch.Tensor],
        steps: Sequence[Sequence[tuple]], parts: Dict[str, int],
        mm=torch.matmul) -> dict:
    """``steps[s]`` holds every rank's batch of step ``s``.  ``weights``
    are not changed.  Returns ``{"losses", "grad_norms",
    "change_norms"}``, the norms by leaf as ``judge.part_norms`` cuts
    them."""
    opt = config["optimizer"]
    adamw = AdamW(opt["lr"], opt["weight_decay"], opt["betas"], opt["eps"])
    w = {n: t.detach().clone().requires_grad_(True) for n, t in weights.items()}
    names = list(w)
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    for s, batches in enumerate(steps):
        total = {n: torch.zeros_like(w[n]) for n in names}
        step_loss = 0.0
        for batch in batches:
            loss = loss_fn(config, w, batch, mm)
            grads = torch.autograd.grad(loss, [w[n] for n in names],
                                        allow_unused=True)
            for n, g in zip(names, grads):
                if g is not None:
                    total[n].add_(g)
            step_loss += float(loss.detach())
            del loss, grads
        mean = {n: g.div_(len(batches)) for n, g in total.items()}
        losses.append(step_loss / len(batches))
        if s == 0:
            grad_norms = part_norms(mean, parts)
        adamw.step(w, mean)
        del total, mean
    change = part_norms({n: w[n].detach() - weights[n] for n in names}, parts)
    return dict(losses=losses, grad_norms=grad_norms, change_norms=change)
