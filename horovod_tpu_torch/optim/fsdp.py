"""FSDP / ZeRO-3: parameters, gradients and optimizer state sharded.

Counterpart of ``horovod_tpu/optim/fsdp.py``.  The reference lets the
GSPMD partitioner place each parameter sharded on its largest divisible
dim (:func:`fsdp_spec`) and insert the FSDP collectives.  Here they are
explicit, one parameter at a time, in the reference's flatten order:

* :meth:`FsdpTrainStep.shard` keeps this rank's slice of every
  parameter (its largest dim that divides by the shard axis's width,
  split there; a parameter where nothing divides stays whole) and builds
  the optimizer over the slices, so its state is sharded too;
* a step all-gathers each slice into the whole parameter, runs the
  forward and backward on the whole parameters, reduce-scatters each
  gradient back to its owner (averaged over the batch; zeros where the
  backward left none), optionally clips by the global norm over every
  shard, and steps the optimizer on the slices.

Between steps a rank holds ``1/n`` of the parameters, gradients and
optimizer state.  Inside a step the whole parameters and their
gradients live from the gather to the reduce-scatter (FSDP2's
``reshard_after_forward=False``): the saving is the optimizer state's
and the resting parameters', not the step's peak.

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

import contextlib
import logging
import math
from typing import Callable, Dict, Optional

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


def _all_gather(local: torch.Tensor, dim: int, group) -> torch.Tensor:
    moved = local.movedim(dim, 0).contiguous()
    full = moved.new_empty((group.size * moved.shape[0],)
                           + tuple(moved.shape[1:]))
    dist.all_gather_into_tensor(full, moved, group=group.group)
    return full.movedim(0, dim)


def _whole(p: torch.Tensor, dim: Optional[int], group) -> torch.Tensor:
    """A new tensor holding the whole parameter of the slice ``p``."""
    if dim is None:
        return p.detach().clone()
    return _all_gather(p.detach(), dim, group)


def _reduce_scatter(full: torch.Tensor, dim: int, group) -> torch.Tensor:
    moved = full.movedim(dim, 0).contiguous()
    piece = C.reducescatter_start(moved, C.Average, group.group,
                                  "make_fsdp_train_step").wait()
    return piece.movedim(0, dim).contiguous()


@contextlib.contextmanager
def _swapped(model: torch.nn.Module, tensors: Dict[str, torch.Tensor]):
    """Run with ``model``'s parameters replaced by ``tensors`` (by
    name), the parameter objects put back after.  A parameter that
    several modules share (a tied embedding and head) is replaced in
    every owner: ``named_parameters`` names it once."""
    owners: Dict[int, list] = {}
    named = {}
    for name, p in model.named_parameters(remove_duplicate=False):
        owners.setdefault(id(p), []).append(name)
        named[name] = p
    saved = []
    try:
        for name, t in tensors.items():
            for alias in owners[id(named[name])]:
                owner, _, attr = alias.rpartition(".")
                module = model.get_submodule(owner)
                saved.append((module, attr, module._parameters[attr]))
                module._parameters[attr] = t
        yield
    finally:
        for module, attr, p in reversed(saved):
            module._parameters[attr] = p


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
    detached."""

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

    def _groups(self):
        shard = self.plan.group(self.axis)
        rep = self.plan.group(self.dp_axis) if self.dp_axis else None
        return shard, rep

    def _named(self, model):
        return tree_flatten({name: p for name, p in model.named_parameters()
                             if p.requires_grad})

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
        return {name: _whole(p, self.split[name], shard)
                for name, p in zip(names, params)}

    def __call__(self, model: torch.nn.Module, optimizer, batch):
        shard, rep = self._groups()
        names, params = self._named(model)
        if set(names) != set(self.split):
            raise ValueError("make_fsdp_train_step: the model's parameters "
                             "are not those shard() cut")
        whole = {name: _whole(p, self.split[name], shard).requires_grad_()
                 for name, p in zip(names, params)}
        with _swapped(model, whole):
            loss, aux = _loss_and_aux(self.loss_fn, model, batch,
                                      self.has_aux)
            loss.backward()
        split = [self.split[name] for name in names]
        for name, p, dim in zip(names, params, split):
            w = whole.pop(name)
            g = w.grad if w.grad is not None else torch.zeros_like(w)
            del w
            if dim is None:
                g = C.reduce_raw(g, C.Average, group=shard.group)
            else:
                g = _reduce_scatter(g, dim, shard)
            if rep is not None:
                g = C.reduce_raw(g, C.Average, group=rep.group)
            p.grad = g
        if self.max_grad_norm is not None:
            _clip_by_global_norm([p.grad for p in params], split, shard,
                                 self.max_grad_norm)
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
