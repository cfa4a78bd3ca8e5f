"""FSDP / ZeRO-3: parameters, gradients and optimizer state sharded.

Counterpart of ``horovod_tpu/optim/fsdp.py``.  The reference lets the
GSPMD partitioner place each parameter sharded on its largest divisible
dim (:func:`fsdp_spec`) and insert the FSDP collectives: each layer's
parameters all-gathered just before use and dropped after.  Here they
are explicit, one parameter at a time:

* :meth:`FsdpTrainStep.shard` keeps this rank's slice of every
  parameter (its largest dim that divides by the shard axis's width,
  split there; a parameter where nothing divides stays whole) and builds
  the optimizer over the slices, so its state is sharded too;
* a step holds whole parameters one **unit** at a time, reduce-scatters
  each gradient back to its owner (averaged over the batch; zeros where
  the backward left none), optionally clips by the global norm over
  every shard, and steps the optimizer on the slices.

**Units** (:meth:`FsdpTrainStep.units`).  Starting at the root, the
children of a module that share a class, hold parameters and have
submodules of their own are units (GPT's and BERT's ``block_{i}``);
every other child is searched the same way.  A parameter of no unit, or
of more than one (a tied weight), is in the **root unit**: the
embeddings, ``ln_f``, ``lm_head`` (the chunked head reads its kernel
without running it).  A model with no repeated block is all root.  A
unit's parameters are read inside its forward only.

**A step.**  The root is all-gathered first (in the reference's flatten
order) and stays whole through the step.  A unit's forward pre-hook
all-gathers its slices into whole leaves and swaps them in (into every
owner of a shared one); its forward hook swaps the slices back and frees
the whole storage.  What autograd saves inside the unit's forward passes
through ``torch.autograd.graph.saved_tensors_hooks``: a whole leaf, a
view of one, or a cast of one (``Dense`` saves ``kernel.to(bf16)``,
whose ``ToCopyBackward0`` leads to the leaf's ``AccumulateGrad``) is
kept as a reference, and the first unpack of the unit in the backward
gathers it again (and casts again).  When every leaf of the unit has its
gradient (``register_post_accumulate_grad_hook``), the unit's gradients
are reduce-scattered in the unit's order, the whole gradients dropped
and the whole storage freed.  The root's gradients, and those of a unit
whose leaves did not all receive one, are reduce-scattered after the
backward.  Every collective follows the forward's order or the autograd
graph's, the same on every rank; on a CUDA tensor the backward's run on
autograd's device thread.

So between steps a rank holds ``1/n`` of the parameters, gradients and
optimizer state, and inside a step the root whole plus one block's
parameters and gradients (two blocks' where one's backward starts before
the next one's gradients are done).  :attr:`FsdpTrainStep.
peak_gathered_bytes` is the most bytes of whole parameters (the root, a
unit's gather and its backward re-gather) alive at once in the last
step, counted where the step allocates and frees them.

HSDP: with ``dp_axis`` the slices are cut over the shard axis only and
are the same on every ``dp_axis`` rank; the gradient is reduce-scattered
over the shard axis and then averaged over ``dp_axis``.

FSDP2 (``torch.distributed.fsdp.fully_shard``) is not used: over gloo on
CUDA tensors, as ``chip_smoke.py``'s ranks sharing one card run, it
died with a segmentation fault (``scripts/torch_port_gloo_probe.py``).

:func:`unshard_matmul` is the fused epilogue for hand-built unshard
paths (kernel B5).
"""

from __future__ import annotations

import collections
import logging
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from .. import basics
from ..ops import collectives as C
from ..ops.fused_collectives import fused_matmul_allgather
from ..ops.fusion import tree_flatten
from ..plan import MeshPlan, P, fsdp_param_spec, resolve_plan
from .distributed_optimizer import _loss_and_aux

logger = logging.getLogger(__name__)


def fsdp_spec(leaf, n: int, axis: str) -> P:
    """The spec sharding ``leaf``'s largest ``n``-divisible dim over
    ``axis``; replicated when nothing divides (the reference's shim over
    :func:`..plan.fsdp_param_spec`)."""
    return fsdp_param_spec(leaf, n, axis)


def unshard_matmul(x: torch.Tensor, w_shard: torch.Tensor, *,
                   group=None) -> torch.Tensor:
    """``x [M, K] @ w_shard [K, N/n]`` in kernel B5, then an all-gather
    of the activation: numerically ``x @`` the column-gathered weight
    (``[M, N]``, the ranks' columns in rank order), but the gathered
    weight (``K × N`` per layer, the unshard path's largest
    materialization) never exists; the wire carries the ``M × N``
    activation.  It pays wherever ``M < K``, the long thin layers FSDP
    lives in.  No gradient flows through it."""
    return fused_matmul_allgather(x, w_shard, group=group)


def _split_dim(spec: P) -> Optional[int]:
    for dim, entry in enumerate(spec):
        if entry is not None:
            return dim
    return None


def _reduce_scatter(full: torch.Tensor, dim: int, group) -> torch.Tensor:
    moved = full.movedim(dim, 0).contiguous()
    piece = C.reducescatter_start(moved, C.Average, group.group,
                                  "make_fsdp_train_step").wait()
    return piece.movedim(0, dim).contiguous()


def _blocks(module: torch.nn.Module, prefix: str = "") -> List[str]:
    """The names of the repeated blocks under ``module`` (the module
    docstring's rule), in registration order."""
    kids = [(name, m) for name, m in module.named_children()
            if next(m.parameters(), None) is not None]
    classes = collections.Counter(type(m) for _, m in kids)
    out = []
    for name, m in kids:
        if classes[type(m)] > 1 and next(m.children(), None) is not None:
            out.append(prefix + name)
        else:
            out.extend(_blocks(m, f"{prefix}{name}."))
    return out


class _Whole:
    """The whole parameter of the slice ``p`` (collective over the shard
    group), as ``leaf``; in a step a leaf over a storage that
    :meth:`fill` all-gathers into again and :meth:`free` empties (the
    leaf, which autograd's ``AccumulateGrad`` holds, stays)."""

    def __init__(self, p: torch.Tensor, dim: Optional[int], group) -> None:
        self.p, self.dim, self.group = p, dim, group
        shape = list(p.shape)
        if dim is not None:
            shape.insert(0, shape.pop(dim) * group.size)
        self.buf = p.new_empty(shape)          # the gather's layout
        self.nbytes = self.buf.numel() * self.buf.element_size()
        self._gather_into(self.buf)
        self.leaf = self.buf if dim is None else self.buf.movedim(0, dim)

    def _gather_into(self, out: torch.Tensor) -> None:
        src = self.p.detach()
        if self.dim is None:
            out.copy_(src)
        else:
            dist.all_gather_into_tensor(
                out, src.movedim(self.dim, 0).contiguous(),
                group=self.group.group)

    def fill(self) -> None:
        storage = self.buf.untyped_storage()
        storage.resize_(self.nbytes)
        # A tensor of its own over the storage: the leaf's version
        # counter does not move.
        self._gather_into(self.buf.new_empty(0).set_(storage, 0,
                                                     self.buf.shape))

    def free(self) -> None:
        self.buf.untyped_storage().resize_(0)


class _Ref:
    """What autograd keeps, inside a unit's forward, of a whole leaf or
    of a view or a cast of it: enough to make it again after the
    unit's storage was freed."""

    __slots__ = ("unit", "whole", "cast", "size", "stride", "offset")

    def __init__(self, unit, whole: _Whole, cast, t: torch.Tensor) -> None:
        self.unit, self.whole, self.cast = unit, whole, cast
        self.size, self.stride = t.size(), t.stride()
        self.offset = t.storage_offset()

    def load(self) -> torch.Tensor:
        self.unit.gather()
        leaf = self.whole.leaf.detach()
        if self.cast is None:
            return leaf.as_strided(self.size, self.stride, self.offset)
        dtype, device = self.cast
        return torch.empty_strided(self.size, self.stride, dtype=dtype,
                                   device=device).copy_(leaf)


class _Unit:
    """One block unit of a step (module docstring): its whole leaves,
    gathered around its forward and again for its backward."""

    def __init__(self, sweep: "_Sweep", module: torch.nn.Module,
                 names: List[str]) -> None:
        self.sweep, self.module, self.names = sweep, module, names
        self.wholes: Dict[str, _Whole] = {}
        self.gathered = self.settled = False
        self.pending = len(names)        # leaves still without a gradient
        self.swaps: list = []
        self.by_ptr: Dict[int, _Whole] = {}

    def gather(self) -> None:
        if self.gathered:
            return
        if not self.wholes:
            for name in self.names:
                w = self.wholes[name] = self.sweep.whole(name)
                self.sweep.handles.append(
                    w.leaf.register_post_accumulate_grad_hook(self._arrived))
        else:
            for w in self.wholes.values():
                w.fill()
                self.sweep.count(w.nbytes)
        self.by_ptr = {w.buf.untyped_storage().data_ptr(): w
                       for w in self.wholes.values() if w.nbytes}
        self.gathered = True

    def free(self) -> None:
        if self.gathered:
            for w in self.wholes.values():
                w.free()
                self.sweep.count(-w.nbytes)
            self.gathered = False

    def enter(self, module, args) -> None:
        """Forward pre-hook: gather, swap in, save by reference."""
        self.gather()
        for name in self.names:
            self.swaps += self.sweep.swap_in(name, self.wholes[name].leaf)
        hooks = torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                         self._unpack)
        hooks.__enter__()
        self.sweep.active.append(hooks)

    def leave(self, module, args, out) -> None:
        """Forward hook: stop saving by reference, swap back, free."""
        self.sweep.active.pop().__exit__(None, None, None)
        self.restore()
        self.free()

    def restore(self) -> None:
        for module, attr, p in reversed(self.swaps):
            module._parameters[attr] = p
        self.swaps = []

    def _pack(self, t: torch.Tensor):
        if t.layout != torch.strided:
            return t
        w = self.by_ptr.get(t.untyped_storage().data_ptr())
        if w is not None:
            return _Ref(self, w, None, t)
        fn = t.grad_fn
        if fn is not None and fn.name() == "ToCopyBackward0":
            var = getattr(fn.next_functions[0][0], "variable", None)
            w = (None if var is None
                 else self.by_ptr.get(var.untyped_storage().data_ptr()))
            if w is not None and t.shape == w.leaf.shape:
                return _Ref(self, w, (t.dtype, t.device), t)
        return t

    @staticmethod
    def _unpack(packed):
        return packed.load() if isinstance(packed, _Ref) else packed

    def _arrived(self, leaf: torch.Tensor) -> None:
        self.pending -= 1
        if self.pending == 0:
            self.settle()

    def settle(self) -> None:
        """Reduce-scatter the unit's gradients (zeros where a leaf has
        none), drop the whole ones, free the whole storage."""
        if self.settled:
            return
        for name in self.names:
            w = self.wholes.get(name)
            self.sweep.settle(name, None if w is None else w.leaf.grad)
            if w is not None:
                w.leaf.grad = None
        self.settled = True
        self.free()


class _Sweep:
    """One step's whole parameters (module docstring): the root's for the
    step, each unit's around its forward and its backward; the hooks on
    the units' modules while the step runs."""

    def __init__(self, step: "FsdpTrainStep", model: torch.nn.Module,
                 params: Dict[str, torch.Tensor]) -> None:
        self.step, self.params = step, params
        self.shard, self.rep = step._groups()
        self.owners: Dict[int, List[Tuple[torch.nn.Module, str]]] = {}
        for alias, p in model.named_parameters(remove_duplicate=False):
            owner, _, attr = alias.rpartition(".")
            self.owners.setdefault(id(p), []).append(
                (model.get_submodule(owner), attr))
        self.root, blocks = step.units(model)
        self.units = [_Unit(self, model.get_submodule(block), names)
                      for block, names in blocks]
        self.root_wholes: Dict[str, _Whole] = {}
        self.live = self.peak = 0
        self.active: list = []           # the units' saved-tensor hooks
        self.swaps: list = []
        self.handles: list = []

    def count(self, nbytes: int) -> None:
        self.live += nbytes
        self.peak = max(self.peak, self.live)

    def whole(self, name: str) -> _Whole:
        w = _Whole(self.params[name], self.step.split[name], self.shard)
        w.leaf.requires_grad_()
        self.count(w.nbytes)
        return w

    def swap_in(self, name: str, leaf: torch.Tensor) -> list:
        """``leaf`` in place of ``name``'s parameter in every owner; the
        ``(module, attr, parameter)`` to put back."""
        saved = []
        for module, attr in self.owners[id(self.params[name])]:
            saved.append((module, attr, module._parameters[attr]))
            module._parameters[attr] = leaf
        return saved

    def settle(self, name: str, g: Optional[torch.Tensor]) -> None:
        """``name``'s whole gradient ``g`` (zeros when None) reduced onto
        its slice's ``.grad``: reduce-scattered (all-reduced when the
        parameter is whole) over the shard group, then averaged over
        ``dp_axis``."""
        p, dim = self.params[name], self.step.split[name]
        if g is None:
            shape = list(p.shape)
            if dim is not None:
                shape[dim] *= self.shard.size
            g = p.new_zeros(shape)
        if dim is None:
            g = C.reduce_raw(g, C.Average, group=self.shard.group)
        else:
            g = _reduce_scatter(g, dim, self.shard)
        if self.rep is not None:
            g = C.reduce_raw(g, C.Average, group=self.rep.group)
        p.grad = g

    def __enter__(self) -> "_Sweep":
        try:
            for name in self.root:
                w = self.root_wholes[name] = self.whole(name)
                self.swaps += self.swap_in(name, w.leaf)
            for unit in self.units:
                self.handles.append(
                    unit.module.register_forward_pre_hook(unit.enter))
                self.handles.append(
                    unit.module.register_forward_hook(unit.leave))
        except BaseException:
            self.close()
            raise
        return self

    def finish(self) -> None:
        """After the backward: the units not yet settled, then the
        root's gradients, in order."""
        for unit in self.units:
            unit.settle()
        for name in self.root:
            w = self.root_wholes[name]
            self.settle(name, w.leaf.grad)
            w.leaf.grad = None

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        while self.active:
            self.active.pop().__exit__(None, None, None)
        for handle in self.handles:
            handle.remove()
        for unit in self.units:
            unit.restore()
            unit.free()
        for module, attr, p in reversed(self.swaps):
            module._parameters[attr] = p
        for w in self.root_wholes.values():
            w.free()
            self.count(-w.nbytes)
        # No cycle (a leaf's hook, a unit and this sweep) may keep the
        # model alive after the step until the collector runs.
        self.handles, self.units, self.root_wholes = [], [], {}


def _clip_by_global_norm(grads, split, group, max_norm: float) -> None:
    """optax's ``clip_by_global_norm`` on the sharded gradients: the
    squares of the slices summed over the shard group, the whole
    (replicated) ones counted once; every gradient scaled by ``max_norm
    / norm`` when the norm is larger."""
    dev = grads[0].device
    sliced = torch.zeros((), dtype=torch.float32, device=dev)
    whole = torch.zeros((), dtype=torch.float32, device=dev)
    for g, dim in zip(grads, split):
        sq = g.to(torch.float32).square().sum()
        if dim is None:
            whole = whole + sq
        else:
            sliced = sliced + sq
    if group.size > 1:
        dist.all_reduce(sliced, group=group.group)
    norm = torch.sqrt(sliced + whole)
    if float(norm) >= max_norm:
        for g in grads:
            g.copy_((g / norm.to(g.dtype)) * max_norm)


class FsdpTrainStep:
    """``step(model, optimizer, batch) -> loss`` (``(loss, aux)`` with
    ``has_aux``) over a model :meth:`shard` has cut (module docstring).
    Each rank passes its own rows of the batch; the loss returned is the
    mean over the batch group (``dp_axis × axis``), the aux this rank's,
    detached.  After a step, :attr:`peak_gathered_bytes` holds its peak
    of whole-parameter bytes."""

    def __init__(self, loss_fn: Callable, optimizer: Callable, *, plan,
                 axis: str, dp_axis: Optional[str], has_aux: bool,
                 max_grad_norm: Optional[float]) -> None:
        self.loss_fn = loss_fn
        self.make_optimizer = optimizer
        self.plan = plan
        self.axis = axis
        self.dp_axis = dp_axis
        self.has_aux = has_aux
        self.max_grad_norm = max_grad_norm
        self.n = plan.axis_size(axis)
        self.split: Dict[str, Optional[int]] = {}
        self.peak_gathered_bytes = 0

    def _groups(self):
        shard = self.plan.group(self.axis)
        rep = self.plan.group(self.dp_axis) if self.dp_axis else None
        return shard, rep

    def _named(self, model):
        return tree_flatten({name: p for name, p in model.named_parameters()
                             if p.requires_grad})

    def units(self, model: torch.nn.Module
              ) -> Tuple[List[str], List[Tuple[str, List[str]]]]:
        """``(root, blocks)``: the root unit's parameter names and each
        block unit's ``(module name, parameter names)`` (the module
        docstring's rule), names in the reference's flatten order."""
        blocks = _blocks(model)
        homes: Dict[int, set] = {}
        for alias, p in model.named_parameters(remove_duplicate=False):
            homes.setdefault(id(p), set()).add(next(
                (i for i, b in enumerate(blocks)
                 if alias.startswith(b + ".")), None))
        members: List[List[str]] = [[] for _ in blocks]
        root = []
        for name, p in zip(*self._named(model)):
            (home, *more) = homes[id(p)]
            if home is None or more:
                root.append(name)
            else:
                members[home].append(name)
        return root, [(b, m) for b, m in zip(blocks, members) if m]

    def shard(self, model: torch.nn.Module):
        """Keep this rank's slice of every parameter, in place (every
        rank must start from the same weights), and build the optimizer
        over the slices: ``(model, optimizer)``."""
        shard, _ = self._groups()
        with torch.no_grad():
            for name, p in zip(*self._named(model)):
                dim = _split_dim(fsdp_spec(p, self.n, self.axis))
                self.split[name] = dim
                if dim is not None:
                    span = p.shape[dim] // self.n
                    p.data = p.data.narrow(dim, shard.index * span,
                                           span).clone()
        optimizer = self.make_optimizer(list(model.parameters()))
        if not isinstance(optimizer, torch.optim.Optimizer):
            raise TypeError("make_fsdp_train_step: `optimizer` must build a "
                            "torch.optim.Optimizer from the parameters")
        return model, optimizer

    def gather(self, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
        """Every parameter whole (collective over the shard group)."""
        shard, _ = self._groups()
        names, params = self._named(model)
        return {name: _Whole(p, self.split[name], shard).leaf
                for name, p in zip(names, params)}

    def __call__(self, model: torch.nn.Module, optimizer, batch):
        names, params = self._named(model)
        if set(names) != set(self.split):
            raise ValueError("make_fsdp_train_step: the model's parameters "
                             "are not those shard() cut")
        with _Sweep(self, model, dict(zip(names, params))) as sweep:
            loss, aux = _loss_and_aux(self.loss_fn, model, batch,
                                      self.has_aux)
            loss.backward()
            sweep.finish()
        self.peak_gathered_bytes = sweep.peak
        if self.max_grad_norm is not None:
            _clip_by_global_norm([p.grad for p in params],
                                 [self.split[name] for name in names],
                                 sweep.shard, self.max_grad_norm)
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        group = self.plan.group(tuple(a for a in (self.dp_axis, self.axis)
                                      if a)).group
        loss = C.reduce_raw(loss.detach(), C.Average, group=group)
        return (loss, aux) if self.has_aux else loss


def make_fsdp_train_step(loss_fn: Callable, optimizer: Callable, *,
                         mesh=None, axis_name: Optional[str] = None,
                         dp_axis: Optional[str] = None,
                         has_aux: bool = False,
                         max_grad_norm: Optional[float] = None,
                         two_phase: Optional[bool] = None,
                         pipeline_depth: Optional[int] = None,
                         error_feedback: Optional[bool] = None):
    """Build ``(shard, step)`` for FSDP training (reference:
    ``make_fsdp_train_step``).

    ``loss_fn(model, batch) -> loss``; ``optimizer(parameters) ->
    torch.optim.Optimizer`` is called by ``shard`` with the slices.
    ``model, opt = shard(model)``, then ``loss = step(model, opt,
    batch)``.  ``max_grad_norm`` clips the gradients by their global
    norm before the update (optax's ``clip_by_global_norm`` chained
    before the optimizer), over every shard.

    The wiring: an explicit ``mesh`` (a :class:`..mesh.Mesh`) with
    ``axis_name`` (default: its first axis); else the session plan's
    shard axis (``fsdp`` when declared, else its sole reduce axis), and
    a declared ``data`` axis beside ``fsdp`` selects HSDP.  ``dp_axis``
    selects HSDP explicitly: slices cut over ``axis_name`` and the same
    on every ``dp_axis`` rank.

    ``two_phase``/``pipeline_depth``/``error_feedback`` exist for the
    other entry points' sake: the FSDP wire is already reduce-scatter +
    all-gather and exact, so ``two_phase=False`` and
    ``error_feedback=True`` warn and change nothing."""
    if two_phase is False:
        logger.warning(
            "make_fsdp_train_step(two_phase=False): the FSDP wire is a "
            "reduce-scatter + all-gather by construction; the flag only "
            "affects the fused entry points (make_train_step / "
            "make_zero_train_step)")
    if error_feedback:
        logger.warning(
            "make_fsdp_train_step(error_feedback=True): the FSDP wire is "
            "exact, there is no lossy transport to correct; the residual "
            "lives in the fused entry points (DistributedOptimizer / "
            "make_zero_train_step)")
    del pipeline_depth  # accepted for the other entry points' sake

    if mesh is None and axis_name is None:
        plan = basics._require().mesh_plan or MeshPlan.default()
        axis = plan.shard_axis() or plan.axis_names[0]
        if dp_axis is None and axis == "fsdp" and plan.has_axis("data"):
            dp_axis = "data"
    else:
        plan = resolve_plan(mesh)
        axis = axis_name or plan.axis_names[0]
        if not plan.has_axis(axis):
            raise ValueError(f"axis_name {axis!r} is not an axis of the mesh "
                             f"{plan.axis_names}")
    if dp_axis is not None:
        if not plan.has_axis(dp_axis):
            raise ValueError(
                f"dp_axis {dp_axis!r} is not an axis of the mesh "
                f"{plan.axis_names}")
        if dp_axis == axis:
            raise ValueError(
                f"dp_axis must differ from the FSDP shard axis ({axis!r}): "
                "hybrid sharding replicates across dp_axis and shards over "
                "axis_name")
    if max_grad_norm is not None and not math.isfinite(max_grad_norm):
        raise ValueError(f"max_grad_norm must be finite, got {max_grad_norm}")
    step = FsdpTrainStep(loss_fn, optimizer, plan=plan, axis=axis,
                         dp_axis=dp_axis, has_aux=has_aux,
                         max_grad_norm=max_grad_norm)
    return step.shard, step
