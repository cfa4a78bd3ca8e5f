"""Start every rank from the root's parameters and optimizer state.

Counterpart of ``horovod_tpu/functions.py`` (reference:
``horovod/torch/functions.py``): tensors are broadcast in place, one by
one, from ``root_rank``.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Tuple, Union

import torch
import torch.distributed as dist

from . import basics


def broadcast_parameters(
        params: Union[Mapping[str, torch.Tensor],
                      Iterable[Tuple[str, torch.Tensor]]],
        root_rank: int = 0) -> None:
    """Overwrite every tensor of ``params`` (``model.state_dict()`` or
    ``model.named_parameters()``) with ``root_rank``'s, in place."""
    device = basics.device()
    items = params.items() if isinstance(params, Mapping) else params
    with torch.no_grad():
        for _, t in sorted(items, key=lambda kv: kv[0]):
            if t.device == device:
                dist.broadcast(t.data, src=root_rank)
            else:  # e.g. AdamW's step count, kept on the CPU
                tmp = t.detach().to(device)
                dist.broadcast(tmp, src=root_rank)
                t.data.copy_(tmp)


def broadcast_optimizer_state(optimizer, root_rank: int = 0) -> None:
    """Overwrite ``optimizer``'s tensor state (moments, step counts) and
    hyperparameters with ``root_rank``'s.  State the root has not
    created yet (before the first step) is left as it is."""
    basics._require()
    state = optimizer.state_dict()
    tensors = {}
    for pid, pstate in state["state"].items():
        for key, val in pstate.items():
            if torch.is_tensor(val):
                tensors[f"{pid}.{key}"] = val
    broadcast_parameters(tensors, root_rank)
    groups = [{k: v for k, v in g.items() if k != "params"}
              for g in state["param_groups"]]
    box = [groups]
    dist.broadcast_object_list(box, src=root_rank)
    for group, root_group in zip(optimizer.param_groups, box[0]):
        group.update(root_group)
