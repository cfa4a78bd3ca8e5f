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
    ``model.named_parameters()``) with ``root_rank``'s, in place.  Each
    tensor heartbeats the stall inspectors and writes a timeline
    ``EXECUTE`` event named ``broadcast.<name>`` with ``{"root"}``, as
    the reference's torch binding names them; it counts no dispatch."""
    device = basics.device()
    items = params.items() if isinstance(params, Mapping) else params
    with torch.no_grad():
        for name, t in sorted(items, key=lambda kv: kv[0]):
            C._heartbeat(f"broadcast.{name}")
            with C._activity(f"broadcast.{name}", "EXECUTE",
                             {"root": root_rank}):
                if t.device == device:
                    dist.broadcast(t.data, src=root_rank)
                else:  # e.g. AdamW's step count, kept on the CPU
                    tmp = t.detach().to(device)
                    dist.broadcast(tmp, src=root_rank)
                    t.data.copy_(tmp)


def broadcast_optimizer_state(optimizer, root_rank: int = 0) -> None:
    """Overwrite ``optimizer``'s state (moments, step counts) and
    hyperparameters with ``root_rank``'s.

    The root's layout goes first (``broadcast_object``): for every
    parameter with state, each entry's key and, for a tensor, its shape,
    dtype and whether it lives on the parameter's device.  A rank that
    lacks an entry (it has not stepped yet, while the root resumed)
    creates it, so every rank then broadcasts the same tensors in the
    same order, sorted by parameter index and key.  Entries the root has
    not created yet are left as they are.  A
    :class:`~.optim.DistributedOptimizer` also takes the root's
    error-feedback residual, accumulator and call count."""
    basics._require()
    params = [p for g in optimizer.param_groups for p in g["params"]]
    layout = {}
    if basics.rank() == root_rank:
        for i, p in enumerate(params):
            for key, val in optimizer.state.get(p, {}).items():
                layout.setdefault(i, {})[key] = (
                    (tuple(val.shape), val.dtype, val.device == p.device)
                    if torch.is_tensor(val) else ("value", val))
    groups = [{k: v for k, v in g.items() if k != "params"}
              for g in optimizer.param_groups]
    layout, groups = broadcast_object((layout, groups), root_rank)
    tensors = {}
    for i in sorted(layout):
        p = params[i]
        state = optimizer.state[p]
        for key in sorted(layout[i]):
            spec = layout[i][key]
            if spec[0] == "value":
                state[key] = spec[1]
                continue
            shape, dtype, on_param = spec
            val = state.get(key)
            if not (torch.is_tensor(val) and tuple(val.shape) == shape
                    and val.dtype == dtype):
                val = state[key] = torch.zeros(
                    shape, dtype=dtype,
                    device=p.device if on_param else "cpu")
            tensors[f"{i:09d}.{key}"] = val
    broadcast_parameters(tensors, root_rank)
    for group, root_group in zip(optimizer.param_groups, groups):
        group.update(root_group)
    if hasattr(optimizer, "residual") and hasattr(optimizer, "accumulator"):
        _broadcast_wrapper_state(optimizer, root_rank)


def _broadcast_wrapper_state(optimizer, root_rank: int) -> None:
    """A :class:`~.optim.DistributedOptimizer`'s own state from
    ``root_rank``: the error-feedback residual, the accumulator and the
    call count, as the reference's ``TpuState.sync`` broadcasts its whole
    ``opt_state``.  After it every rank holds the root's residual (and
    none where the root has none)."""
    named = {name: p for p, name in (optimizer._names or {}).items()}
    layout = None
    if basics.rank() == root_rank:
        layout = ({kind: {name: (tuple(t.shape), t.dtype)
                          for name, t in getattr(optimizer, kind).items()}
                   for kind in ("residual", "accumulator")},
                  optimizer.calls)
    layout, calls = broadcast_object(layout, root_rank)
    tensors = {}
    for kind in ("residual", "accumulator"):
        live = getattr(optimizer, kind)
        mine = {}
        for name, (shape, dtype) in layout[kind].items():
            t = live.get(name)
            if not (torch.is_tensor(t) and tuple(t.shape) == shape
                    and t.dtype == dtype):
                where = named[name].device if name in named else basics.device()
                t = torch.zeros(shape, dtype=dtype, device=where)
            mine[name] = tensors[f"{kind}.{name}"] = t
        setattr(optimizer, kind, mine)
    broadcast_parameters(tensors, root_rank)
    optimizer.calls = calls


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
