"""The Horovod collective API over ``torch.distributed``.

Counterpart of ``horovod_tpu/ops/collectives.py``, with the process-level
contract of ``horovod_tpu/hostops.py`` and the torch-facing names of
``horovod_tpu/torch/mpi_ops.py``: ``allreduce`` (Sum, Average, Adasum,
Min, Max, Product, with prescale and postscale, on any compression
tier), ``grouped_allreduce``, ``allgather`` (ragged dim 0),
``grouped_allgather``, ``broadcast``, ``alltoall`` (ragged splits),
``reducescatter``, ``grouped_reducescatter``, ``barrier`` and ``join``,
each over a process set (``process_set=``, the global set by default)
and each with an ``_async`` form returning a :class:`Handle`; the
in-place forms (``allreduce_``, ``broadcast_`` …) write the result into
their argument.  Every rank of the set must call them in the same order.

A rank outside ``process_set`` raises ``ValueError`` **before** any call:
torch never lets a non-member enter a group's collective.  The JAX
reference dispatches first and raises afterwards, because under SPMD
every controller dispatches every program.

Average divides the sum by the set's size in the tensor's dtype; an
integer tensor floor-divides and keeps its dtype, as the reference does.
On ``Compression.int8`` the eager allreduce runs the stack tier
(:func:`.quantization.int8_stack_allreduce_async`), the numerics of the
reference's eager ``hvd.allreduce``; the gradient path keeps its own
wire (:meth:`.compression.Compressor.spmd_allreduce`).

``HOROVOD_HIERARCHICAL_ALLREDUCE=1`` runs a Sum or Average over the
global set on the exact wire in two levels (reference: Horovod's NCCL
reduce-scatter inside the node, allreduce across nodes, all-gather
inside the node): see :func:`hierarchical_allreduce`.

Each dispatch of the seven entry points (``allreduce``,
``grouped_allreduce``, ``allgather``, ``broadcast``, ``alltoall``,
``reducescatter``, ``grouped_reducescatter``; the other forms go through
them) counts once in ``hvd_tpu_collective_dispatch_total{op}``, its
payload bytes in ``hvd_tpu_wire_bytes_total{tier="slots"}``, and
heartbeats both stall inspectors.  Each writes the reference's timeline
events (``ENQUEUE`` and ``EXECUTE`` with the reference's names and
arguments) when a timeline is open: ``allreduce`` both, ``{"op": op}``;
the others ``EXECUTE`` (``grouped_*`` with ``{"op", "ntensors"}``,
``broadcast`` with ``{"root"}``, ``reducescatter`` with ``{"op"}``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Sequence

import torch
import torch.distributed as dist

from .. import basics
from .. import faults as _faults
from ..obs import instrument as _obs

Average = "average"
Sum = "sum"
Adasum = "adasum"
Min = "min"
Max = "max"
Product = "product"

_REDUCE_OPS = (Average, Sum, Adasum, Min, Max, Product)
_TORCH_OPS = {Sum: dist.ReduceOp.SUM, Average: dist.ReduceOp.SUM,
              Min: dist.ReduceOp.MIN, Max: dist.ReduceOp.MAX,
              Product: dist.ReduceOp.PRODUCT}


# --- handles ------------------------------------------------------------------

class Handle:
    """An operation in flight (reference: the handle of ``*_async``,
    ``hostops.HostHandle``'s contract): the ``torch.distributed`` works it
    waits for and a finish step that runs once, in :meth:`wait`, on the
    caller's current stream after the works (the divide of Average,
    cutting padding, the int8 tier's accumulate)."""

    def __init__(self, works: Sequence, finish: Callable, name: str = ""):
        self.works = [w for w in works if w is not None]
        self._finish = finish
        self._result = None
        self._done = False
        self.name = name

    def wait(self):
        if not self._done:
            for w in self.works:
                w.wait()
            self._result = self._finish()
            self._done = True
            self._finish = None
        return self._result

    result = wait

    def done(self) -> bool:
        """True once every work has completed (non-blocking)."""
        return self._done or all(w.is_completed() for w in self.works)

    def then(self, fn: Callable) -> "Handle":
        """A handle on the same works whose result is ``fn(result)``."""
        return Handle(self.works, lambda: fn(self.wait()), self.name)


def synchronize(handle: Handle):
    """Reference: ``hvd.synchronize(handle)``: block, return the result."""
    return handle.wait()


def poll(handle: Handle) -> bool:
    """Reference: ``hvd.poll(handle)``: has it completed?"""
    return handle.done()


def _done(value, name: str = "") -> Handle:
    return Handle([], lambda: value, name)


def _write(tensor: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """``tensor`` overwritten with ``value`` (the in-place forms)."""
    if value is not tensor:
        with torch.no_grad():
            tensor.copy_(value)
    return tensor


# --- shared rules ---------------------------------------------------------------

def divide(r: torch.Tensor, n: int) -> torch.Tensor:
    """``r / n`` in ``r``'s dtype: floating tensors divide, integer ones
    floor-divide (reference: ``hostops._average_finish``)."""
    if r.is_floating_point() or r.is_complex():
        return r / n
    return torch.div(r, n, rounding_mode="floor")


def _heartbeat(name: str) -> None:
    """Feed both stall inspectors: this rank's watchdog and, at two ranks
    or more, the cross-process monitor (``name`` must be the same on
    every rank, as for every collective)."""
    s = basics._session
    if s is None:
        return
    if s.stall_inspector is not None:
        s.stall_inspector.record_activity(name)
    if s.cross_monitor is not None:
        s.cross_monitor.record_dispatch(name)


def _dispatch(kind: str, tensors: Sequence[torch.Tensor], name: str) -> None:
    """One dispatch of the entry point ``kind`` (reference:
    ``collectives._heartbeat``): the ``collective`` fault site ticks (and
    raises ``HorovodInternalError`` when the armed plan fires, whether
    the metrics are on or not), the stall inspectors hear ``name``, then
    telemetry records the dispatch under ``kind`` (a closed set of seven,
    never the caller's free-form ``name``) with this rank's payload
    bytes."""
    if _faults._active is not None:
        _faults.on_collective(name)
    _heartbeat(name)
    if _obs.enabled():
        _obs.on_collective_dispatch(
            kind, sum(t.numel() * t.element_size() for t in tensors))


def _activity(name: str, phase: str, args=None):
    """The timeline's ``activity(name, phase, args)`` (the reference's
    ``ENQUEUE``/``EXECUTE`` events), or nothing without a session."""
    tl = basics.peek("timeline")
    if tl is None:
        return contextlib.nullcontext()
    return tl.activity(name, phase, args)


def set_group(process_set, name: str):
    """The ``torch.distributed`` group of ``process_set`` (None for the
    global set).  Raises ``ValueError`` on a rank outside the set, before
    any collective is entered."""
    basics._require()
    if process_set is None or process_set.process_set_id == 0:
        return None
    if process_set.process_set_id is None:
        raise ValueError(f"{name}: process set {process_set} is not "
                         "registered; call add_process_set()")
    me = basics.rank()
    if me not in process_set.ranks:
        raise ValueError(f"{name}: this rank ({me}) is not a member of the "
                         f"process set {list(process_set.ranks)}")
    return process_set.group


def _wire(op: str, compression):
    """The compressor an allreduce of ``op`` runs on (``Compression.none``
    for None).  Compression composes with Sum and Average only
    (reference: ``collectives._check_compression_op``)."""
    from .compression import Compression

    if op not in _REDUCE_OPS:
        raise ValueError(f"Unknown op {op!r}; expected one of {_REDUCE_OPS}")
    if compression in (None, Compression.none) or op in (Sum, Average):
        return compression or Compression.none
    if op == Adasum:
        raise ValueError(
            "compression is not supported with op=Adasum (the pairwise "
            "projections need full-precision dot products); drop the "
            "compression argument")
    raise ValueError(
        f"compression is not supported with op={op!r} (min/max/product "
        "need exact comparisons; drop the compression argument)")


def reduce_raw(x: torch.Tensor, op: str, group=None) -> torch.Tensor:
    """The exact wire, synchronous: a new tensor holding the reduction of
    ``x`` over the group (Average: the sum divided by ``n``)."""
    if op not in _TORCH_OPS:
        raise ValueError(f"Unknown reduction op: {op!r}")
    out = x.clone()
    dist.all_reduce(out, op=_TORCH_OPS[op], group=group)
    return divide(out, dist.get_world_size(group)) if op == Average else out


# --- hierarchical (two-level) allreduce --------------------------------------
# The world factors as outer (nodes) × inner (ranks a node): stage 1
# reduce-scatters inside each inner group, stage 2 allreduces each shard
# across the outer group of its index, stage 3 all-gathers inside the
# inner group.

def _resolve_hier_inner() -> int:
    """Inner-group width of the hierarchical allreduce:
    ``HVD_TPU_HIERARCHICAL_INNER``, else the ranks a node when there are
    several nodes; 0 (run flat) when it does not tile the world into
    more than one group of more than one rank."""
    cfg, size = basics.config(), basics.size()
    inner = cfg.hierarchical_inner_size
    if inner <= 0:
        ls = basics.local_size()
        inner = ls if 1 < ls < size else 0
    if inner <= 1 or inner >= size or size % inner != 0:
        return 0
    return inner


def _hier_groups(size: int, inner: int):
    """``(inner_groups, outer_groups)``: the world cut into contiguous
    inner groups, and one outer group per position in them."""
    outer = size // inner
    inner_groups = [list(range(o * inner, (o + 1) * inner))
                    for o in range(outer)]
    outer_groups = [[o * inner + i for o in range(outer)]
                    for i in range(inner)]
    return inner_groups, outer_groups


def hierarchical_allreduce(x: torch.Tensor, op: str,
                           inner: int) -> torch.Tensor:
    """Sum or Average of ``x`` over the world in three stages on the
    exact wire: reduce-scatter inside this rank's inner group (padded to
    ``inner``), allreduce of the shard across its outer group,
    all-gather inside the inner group.  Average divides the sum once by
    the world's size at the end (floor division for an integer
    tensor), so on exact data the result equals the flat one bit for
    bit.  The groups are the two tiers of a ``(size / inner) × inner``
    topology (:func:`..topo.topology.tier_groups`)."""
    from ..topo.topology import MeshTopology, tier_groups

    size = basics.size()
    intra, cross = tier_groups(MeshTopology(size // inner, inner))
    flat = x.detach().reshape(-1)
    pad = (-flat.numel()) % inner
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    shard = flat.new_empty(flat.numel() // inner)
    dist.reduce_scatter_tensor(shard, flat.contiguous(),
                               op=dist.ReduceOp.SUM, group=intra)
    dist.all_reduce(shard, op=dist.ReduceOp.SUM, group=cross)
    full = flat.new_empty(flat.numel())
    dist.all_gather_into_tensor(full, shard, group=intra)
    r = full[:x.numel()].reshape(x.shape)
    return divide(r, size) if op == Average else r


# --- allreduce ------------------------------------------------------------------

def _reduce_start(x: torch.Tensor, op: str, group, compression) -> Handle:
    """Start the reduction of one tensor over ``group``."""
    if op == Adasum:
        from .adasum import adasum_allreduce

        return _done(adasum_allreduce(x, group))
    if op in (Sum, Average):
        return compression.eager_allreduce_async(x, op=op, group=group)
    out = x.detach().clone().contiguous()
    work = dist.all_reduce(out, op=_TORCH_OPS[op], group=group, async_op=True)
    return Handle([work], lambda: out)


def _scaled(x: torch.Tensor, factor: float) -> torch.Tensor:
    return x * factor if factor != 1.0 else x


def allreduce_async(tensor: torch.Tensor, *, op: str = Average,
                    process_set=None, prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0, compression=None,
                    name: str = "allreduce") -> Handle:
    """Reference: ``hvd.allreduce_async``.  ``compression`` picks the
    wire (``Compression.none`` by default); ``prescale_factor``
    multiplies before the wire and ``postscale_factor`` after it."""
    from .compression import Compression

    comp = _wire(op, compression)
    group = set_group(process_set, name)
    _dispatch("allreduce", (tensor,), name)
    with _activity(name, "ENQUEUE", {"op": op}):
        x = _scaled(tensor.detach(), prescale_factor)
        inner = 0
        if (basics.config().hierarchical_allreduce and op in (Sum, Average)
                and group is None and comp is Compression.none):
            inner = _resolve_hier_inner()
    with _activity(name, "EXECUTE", {"op": op}):
        if inner:
            h = _done(hierarchical_allreduce(x, op, inner), name)
        else:
            h = _reduce_start(x, op, group, comp)
    return h.then(lambda r: _scaled(r, postscale_factor))


def allreduce(tensor: torch.Tensor, **kwargs) -> torch.Tensor:
    """Reference: ``hvd.allreduce`` (Average by default), a new tensor."""
    return allreduce_async(tensor, **kwargs).wait()


def allreduce_async_(tensor: torch.Tensor, **kwargs) -> Handle:
    """In place: the handle's result is ``tensor``, overwritten."""
    return allreduce_async(tensor, **kwargs).then(
        lambda r: _write(tensor, r))


def allreduce_(tensor: torch.Tensor, **kwargs) -> torch.Tensor:
    return allreduce_async_(tensor, **kwargs).wait()


def grouped_allreduce_async(tensors: Sequence[torch.Tensor], *,
                            op: str = Average, process_set=None,
                            prescale_factor: float = 1.0,
                            postscale_factor: float = 1.0, compression=None,
                            name: str = "grouped_allreduce") -> Handle:
    """Reference: ``hvd.grouped_allreduce_async``.  The tensors are fused
    as the reference fuses them: per dtype, greedily in list order up to
    the fusion threshold, one reduction a bucket (so on the int8 tier a
    block may span two tensors).  Adasum reduces tensor by tensor."""
    from .fusion import plan_fused_buckets

    comp = _wire(op, compression)
    group = set_group(process_set, name)
    _dispatch("grouped_allreduce", tensors, name)
    if op == Adasum:
        # Tensor by tensor, as the reference's members (each an allreduce
        # of its own, named ``name[i]``).
        from .adasum import adasum_allreduce

        out = []
        for i, t in enumerate(tensors):
            with _activity(f"{name}[{i}]", "ENQUEUE", {"op": op}):
                x = _scaled(t.detach(), prescale_factor)
            with _activity(f"{name}[{i}]", "EXECUTE", {"op": op}):
                out.append(_scaled(adasum_allreduce(x, group),
                                   postscale_factor))
        return _done(out, name)
    leaves = [_scaled(t.detach(), prescale_factor) for t in tensors]
    with _activity(name, "EXECUTE", {"op": op, "ntensors": len(leaves)}):
        buckets = plan_fused_buckets(leaves,
                                     basics.config().fusion_threshold)
        started = [
            (members, _reduce_start(torch.cat([leaves[i].reshape(-1)
                                               for i in members]),
                                    op, group, comp))
            for members in buckets]

    def finish():
        out: List[torch.Tensor] = [None] * len(leaves)  # type: ignore
        for members, h in started:
            flat = _scaled(h.wait(), postscale_factor)
            pieces = torch.split(flat, [leaves[i].numel() for i in members])
            for i, piece in zip(members, pieces):
                out[i] = piece.reshape(leaves[i].shape)
        return out

    return Handle([w for _, h in started for w in h.works], finish, name)


def grouped_allreduce(tensors, **kwargs) -> List[torch.Tensor]:
    return grouped_allreduce_async(tensors, **kwargs).wait()


def grouped_allreduce_async_(tensors: Sequence[torch.Tensor],
                             **kwargs) -> Handle:
    """In place: each tensor is overwritten with its reduction."""
    return grouped_allreduce_async(tensors, **kwargs).then(
        lambda results: [_write(t, r) for t, r in zip(tensors, results)])


def grouped_allreduce_(tensors, **kwargs) -> List[torch.Tensor]:
    return grouped_allreduce_async_(tensors, **kwargs).wait()


def sparse_allreduce_async(tensor: torch.Tensor, *, op: str = Average,
                           process_set=None, postscale_factor: float = 1.0,
                           name: str = "sparse_allreduce") -> Handle:
    """Allreduce of a sparse COO tensor (reference: the torch binding's
    ``sparse_allreduce_async``): indices and values ride the ragged
    allgather, duplicates sum when the result is coalesced, Average
    divides the values by the set's size."""
    if op not in (Sum, Average):
        raise ValueError(f"sparse allreduce supports Sum/Average, got {op!r}")
    t = tensor.coalesce()
    idx = allgather_async(t._indices().t().contiguous(),
                          process_set=process_set, name=f"{name}.indices")
    val = allgather_async(t._values(), process_set=process_set,
                          name=f"{name}.values")
    n = dist.get_world_size(set_group(process_set, name))

    def finish():
        values = val.wait()
        if op == Average:
            values = divide(values, n)
        values = _scaled(values, postscale_factor)
        return torch.sparse_coo_tensor(idx.wait().t(), values,
                                       t.shape).coalesce()

    return Handle(idx.works + val.works, finish, name)


# --- allgather ------------------------------------------------------------------

def allgather_start(tensor: torch.Tensor, group, name: str = "allgather"):
    """Start the ragged allgather of ``tensor`` over ``group`` (reference:
    ``hostops.allgather_async``): the dim-0 lengths first (synchronously),
    then the payload padded to the longest.  Returns ``(handle,
    lengths)``; the handle's result is the concatenation."""
    x = tensor.detach().contiguous()
    if x.dim() == 0:
        x = x[None]
    n = dist.get_world_size(group)
    k = x.shape[0]
    lens = torch.empty(n, dtype=torch.int64, device=x.device)
    dist.all_gather_into_tensor(
        lens, torch.tensor([k], dtype=torch.int64, device=x.device),
        group=group)
    lengths = lens.tolist()
    k_max = max(lengths)
    if k < k_max:
        x = torch.cat([x, x.new_zeros((k_max - k,) + tuple(x.shape[1:]))])
    out = x.new_empty((n * k_max,) + tuple(x.shape[1:]))
    work = dist.all_gather_into_tensor(out, x, group=group, async_op=True)

    def finish():
        if min(lengths) == k_max:
            return out
        parts = out.reshape((n, k_max) + tuple(x.shape[1:]))
        return torch.cat([parts[i, :lengths[i]] for i in range(n)])

    return Handle([work], finish, name), lengths


def allgather_async(tensor: torch.Tensor, *, process_set=None,
                    name: str = "allgather") -> Handle:
    """Reference: ``hvd.allgather_async``: concatenate every member's
    tensor along dim 0; the lengths of dim 0 may differ."""
    group = set_group(process_set, name)
    _dispatch("allgather", (tensor,), name)
    with _activity(name, "EXECUTE"):
        return allgather_start(tensor, group, name)[0]


def allgather(tensor: torch.Tensor, **kwargs) -> torch.Tensor:
    return allgather_async(tensor, **kwargs).wait()


def grouped_allgather_async(tensors: Sequence[torch.Tensor], *,
                            process_set=None,
                            name: str = "grouped_allgather") -> Handle:
    """Reference: ``hvd.grouped_allgather_async``: one handle for the
    group, its members started back to back in list order."""
    hs = [allgather_async(t, process_set=process_set, name=f"{name}[{i}]")
          for i, t in enumerate(tensors)]
    return Handle([w for h in hs for w in h.works],
                  lambda: [h.wait() for h in hs], name)


def grouped_allgather(tensors, **kwargs) -> List[torch.Tensor]:
    return grouped_allgather_async(tensors, **kwargs).wait()


# --- broadcast ------------------------------------------------------------------

def broadcast_async(tensor: torch.Tensor, root_rank: int = 0, *,
                    process_set=None, name: str = "broadcast") -> Handle:
    """Reference: ``hvd.broadcast_async``: every member gets ``root_rank``'s
    tensor (a global rank, which must be in the set), as a new tensor."""
    if process_set is not None and root_rank not in process_set.ranks:
        raise ValueError(f"{name}: root rank {root_rank} not in process set")
    group = set_group(process_set, name)
    _dispatch("broadcast", (tensor,), name)
    with _activity(name, "EXECUTE", {"root": root_rank}):
        out = tensor.detach().clone().contiguous()
        work = dist.broadcast(out, src=root_rank, group=group, async_op=True)
    return Handle([work], lambda: out, name)


def broadcast(tensor: torch.Tensor, root_rank: int = 0,
              **kwargs) -> torch.Tensor:
    return broadcast_async(tensor, root_rank, **kwargs).wait()


def broadcast_async_(tensor: torch.Tensor, root_rank: int = 0,
                     **kwargs) -> Handle:
    """In place: ``tensor`` is overwritten with the root's."""
    return broadcast_async(tensor, root_rank, **kwargs).then(
        lambda r: _write(tensor, r))


def broadcast_(tensor: torch.Tensor, root_rank: int = 0,
               **kwargs) -> torch.Tensor:
    return broadcast_async_(tensor, root_rank, **kwargs).wait()


# --- alltoall -------------------------------------------------------------------

def alltoall_async(tensor: torch.Tensor, splits=None, *, process_set=None,
                   name: str = "alltoall") -> Handle:
    """Reference: ``hvd.alltoall``: send ``splits[j]`` rows of dim 0 to the
    set's ``j``-th member (equal splits by default) and receive the rows
    sent here, in member order.  With ``splits`` the result is
    ``(gathered, received_splits)``, the second an int64 tensor."""
    group = set_group(process_set, name)
    _dispatch("alltoall", (tensor,), name)
    with _activity(name, "EXECUTE"):
        return _alltoall_start(tensor, splits, group, name)


def _alltoall_start(tensor: torch.Tensor, splits, group, name: str) -> Handle:
    x = tensor.detach().contiguous()
    n = dist.get_world_size(group)
    if splits is None:
        if x.shape[0] % n:
            raise ValueError(f"{name}: dim 0 ({x.shape[0]}) is not divisible "
                             f"by the set's size ({n}); pass splits")
        out = torch.empty_like(x)
        work = dist.all_to_all_single(out, x, group=group, async_op=True)
        return Handle([work], lambda: out, name)
    send = [int(s) for s in (splits.tolist() if torch.is_tensor(splits)
                             else splits)]
    if len(send) != n or sum(send) != x.shape[0] or min(send) < 0:
        raise ValueError(f"{name}: splits {send} must have {n} entries "
                         f"summing to dim 0 ({x.shape[0]})")
    sent = torch.tensor(send, dtype=torch.int64, device=x.device)
    received = torch.empty_like(sent)
    dist.all_to_all_single(received, sent, group=group)
    recv = received.tolist()
    out = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
    work = dist.all_to_all_single(out, x, output_split_sizes=recv,
                                  input_split_sizes=send, group=group,
                                  async_op=True)
    return Handle([work], lambda: (out, received), name)


def alltoall(tensor: torch.Tensor, splits=None, **kwargs):
    return alltoall_async(tensor, splits, **kwargs).wait()


# --- reducescatter --------------------------------------------------------------

def reducescatter_start(x: torch.Tensor, op: str, group,
                        name: str) -> Handle:
    """Start the exact reduce-scatter of ``x`` over dim 0 and ``group``
    (reference: ``spmd.reducescatter``): rank ``i`` gets the ``i``-th of
    ``n`` equal dim-0 pieces of the sum, divided by ``n`` for Average."""
    if op not in (Sum, Average):
        raise ValueError(f"{name} supports Sum/Average, got {op!r}")
    n = dist.get_world_size(group)
    if x.dim() == 0 or x.shape[0] % n:
        raise ValueError(f"{name}: dim 0 of {tuple(x.shape)} is not "
                         f"divisible by the set's size ({n})")
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    work = dist.reduce_scatter_tensor(out, x.detach().contiguous(),
                                      op=dist.ReduceOp.SUM, group=group,
                                      async_op=True)
    return Handle([work], lambda: divide(out, n) if op == Average else out,
                  name)


def reducescatter_async(tensor: torch.Tensor, *, op: str = Sum,
                        process_set=None,
                        name: str = "reducescatter") -> Handle:
    """Reference: ``hvd.reducescatter``: reduce, then this member keeps
    its dim-0 piece (dim 0 must divide by the set's size)."""
    group = set_group(process_set, name)
    _dispatch("reducescatter", (tensor,), name)
    with _activity(name, "EXECUTE", {"op": op}):
        return reducescatter_start(tensor, op, group, name)


def reducescatter(tensor: torch.Tensor, **kwargs) -> torch.Tensor:
    return reducescatter_async(tensor, **kwargs).wait()


def grouped_reducescatter_async(tensors: Sequence[torch.Tensor], *,
                                op: str = Sum, process_set=None,
                                name: str = "grouped_reducescatter"
                                ) -> Handle:
    """Reference: ``hvd.grouped_reducescatter``: one reduce-scatter a
    fusion bucket.  Each tensor is laid out ``[n, cols]`` and a bucket
    concatenates the columns, so every member's piece of every tensor
    lands on it."""
    from .fusion import plan_fused_buckets

    group = set_group(process_set, name)
    _dispatch("grouped_reducescatter", tensors, name)
    n = dist.get_world_size(group)
    xs = [t.detach() for t in tensors]
    for i, x in enumerate(xs):
        if x.dim() == 0 or x.shape[0] % n:
            raise ValueError(f"{name}[{i}]: dim 0 of {tuple(x.shape)} is "
                             f"not divisible by the set's size ({n})")
    started = []
    with _activity(name, "EXECUTE", {"op": op, "ntensors": len(xs)}):
        for members in plan_fused_buckets(xs,
                                          basics.config().fusion_threshold):
            fused = torch.cat([xs[i].reshape(n, -1) for i in members],
                              dim=1)
            started.append((members, reducescatter_start(
                fused.reshape(-1), op, group, name)))

    def finish():
        out: List[torch.Tensor] = [None] * len(xs)  # type: ignore
        for members, h in started:
            cols = [xs[i].numel() // n for i in members]
            for i, piece in zip(members, torch.split(h.wait(), cols)):
                out[i] = piece.reshape((xs[i].shape[0] // n,)
                                       + tuple(xs[i].shape[1:]))
        return out

    return Handle([w for _, h in started for w in h.works], finish, name)


def grouped_reducescatter(tensors, **kwargs) -> List[torch.Tensor]:
    return grouped_reducescatter_async(tensors, **kwargs).wait()


# --- barrier / join -------------------------------------------------------------

def barrier(process_set=None, name: str = "barrier") -> None:
    """Reference: ``hvd.barrier``: return once every member has entered
    it (a one-element allreduce, read back on the host).  It heartbeats
    the stall inspectors and writes the reference's events (its barrier
    is a Sum allreduce) but counts no dispatch."""
    group = set_group(process_set, name)
    _heartbeat(name)
    with _activity(name, "ENQUEUE", {"op": Sum}):
        t = torch.ones(1, device=basics.device())
    with _activity(name, "EXECUTE", {"op": Sum}):
        dist.all_reduce(t, group=group)
        t.item()


def join() -> int:
    """Reference: ``hvd.join()``: a barrier of every rank; returns the
    last rank, ``size() - 1`` (as the reference, whose ranks all arrive
    at the same step)."""
    barrier(name="join")
    return basics.size() - 1
