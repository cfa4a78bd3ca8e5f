"""State broadcast helpers for torch models.

Counterpart of ``horovod_tpu/torch/functions.py`` (reference:
``horovod/torch/functions.py``), over the core's
:mod:`horovod_tpu_torch.functions`: ``broadcast_parameters(model.
state_dict(), 0)`` and ``broadcast_optimizer_state(optimizer, 0)`` make
every rank start from the root's state; objects ride pickled byte
broadcasts.
"""

from __future__ import annotations

from typing import Any, List

import torch

from .. import functions as _core


def broadcast_object(obj: Any, root_rank: int = 0, name: str = "") -> Any:
    """Reference: ``hvd.broadcast_object`` (pickle, broadcast the bytes,
    unpickle)."""
    return _core.broadcast_object(obj, root_rank,
                                  name=name or "broadcast_object")


def allgather_object(obj: Any, name: str = "") -> List[Any]:
    """Reference: ``hvd.allgather_object``."""
    return _core.allgather_object(obj, name=name or "allgather_object")


def broadcast_parameters(params, root_rank: int = 0) -> None:
    """Reference: ``hvd.broadcast_parameters(model.state_dict(), 0)``:
    every tensor of a ``state_dict`` or of a sequence of ``(name,
    tensor)`` pairs is overwritten with the root's, in place.  A bare
    sequence of tensors raises ``ValueError``, as the reference does.
    Boolean tensors travel as uint8."""
    if isinstance(params, dict):
        items = list(params.items())
    else:
        items = list(params)
        if items and not isinstance(items[0], tuple):
            raise ValueError(
                "broadcast_parameters expects a state_dict or a sequence "
                "of (name, tensor) tuples (e.g. model.named_parameters())")
    tensors, flags = {}, []
    for name, t in items:
        if not isinstance(t, torch.Tensor):
            continue
        if t.dtype == torch.bool:
            wire = t.to(torch.uint8)
            flags.append((t, wire))
            tensors[name] = wire
        else:
            tensors[name] = t
    _core.broadcast_parameters(tensors, root_rank)
    with torch.no_grad():
        for t, wire in flags:
            t.copy_(wire.to(torch.bool))


def broadcast_optimizer_state(optimizer: "torch.optim.Optimizer",
                              root_rank: int = 0) -> None:
    """Reference: ``hvd.broadcast_optimizer_state(optimizer, 0)``: the
    root's moments, step counts and hyperparameters on every rank.

    A lazy optimizer (no state before its first ``step()``) first takes
    the reference's zero-learning-rate step on zero gradients, so every
    rank holds the same entries; on a :func:`.DistributedOptimizer` that
    step synchronizes like any other (every rank takes it).  Then the
    core's broadcast moves the layout, the tensors and the groups."""
    if isinstance(optimizer, torch.optim.LBFGS):
        raise ValueError("cannot broadcast torch.optim.LBFGS state")
    if not optimizer.state_dict().get("state"):
        for group in optimizer.param_groups:
            for p in group["params"]:
                if p.requires_grad and p.grad is None:
                    p.grad = torch.zeros_like(p)
        saved = [g.get("lr") for g in optimizer.param_groups]
        for g in optimizer.param_groups:
            g["lr"] = 0.0
        optimizer.step()
        for g, lr in zip(optimizer.param_groups, saved):
            g["lr"] = lr
    _core.broadcast_optimizer_state(optimizer, root_rank)
