"""Start every rank from the root's parameters and optimizer state, and
move Python objects between ranks.

Counterpart of ``horovod_tpu/functions.py`` (reference:
``horovod/torch/functions.py``): tensors are broadcast in place, one by
one, from ``root_rank``; an object is pickled into a uint8 tensor on the
rank's device and rides :func:`~.ops.collectives.broadcast` (its length
first) or the ragged :func:`~.ops.collectives.allgather`.
"""

from __future__ import annotations

import pickle
from typing import Any, Iterable, List, Mapping, Tuple, Union

import torch
import torch.distributed as dist

from . import basics
from .ops import collectives as C


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


def _to_bytes(obj: Any) -> torch.Tensor:
    return torch.frombuffer(bytearray(pickle.dumps(obj)),
                            dtype=torch.uint8).to(basics.device())


def _from_bytes(t: torch.Tensor) -> Any:
    return pickle.loads(t.cpu().numpy().tobytes())


def broadcast_object(obj: Any, root_rank: int = 0, *, process_set=None,
                     name: str = "broadcast_object") -> Any:
    """Reference: ``hvd.broadcast_object``: every member gets (an
    unpickled copy of) ``root_rank``'s ``obj``."""
    payload = _to_bytes(obj) if basics.rank() == root_rank else None
    length = torch.tensor([0 if payload is None else payload.numel()],
                          dtype=torch.int64, device=basics.device())
    length = C.broadcast(length, root_rank, process_set=process_set,
                         name=f"{name}.length")
    if payload is None:
        payload = torch.empty(int(length.item()), dtype=torch.uint8,
                              device=basics.device())
    return _from_bytes(C.broadcast(payload, root_rank,
                                   process_set=process_set, name=name))


def allgather_object(obj: Any, *, process_set=None,
                     name: str = "allgather_object") -> List[Any]:
    """Reference: ``hvd.allgather_object``: the list of every member's
    ``obj``, in member order (the pickles may differ in length)."""
    handle, lengths = C.allgather_start(
        _to_bytes(obj), C.set_group(process_set, name), name)
    return [_from_bytes(part)
            for part in torch.split(handle.wait(), lengths)]
