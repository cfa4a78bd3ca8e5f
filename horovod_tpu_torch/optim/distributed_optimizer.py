"""DistributedOptimizer and make_train_step.

Counterpart of ``horovod_tpu/optim/distributed_optimizer.py``.  The
reference wraps an optax transformation whose ``update`` allreduces the
gradients; here :class:`DistributedOptimizer` wraps a
``torch.optim.Optimizer`` whose :meth:`~DistributedOptimizer.step`
allreduces the parameters' ``.grad`` (fused, on the chosen compression
tier) and then steps the wrapped optimizer.

Error feedback follows the reference's order exactly, per leaf: add the
residual to the gradient, record the new residual as this rank's
quantization error of the corrected gradient (at the wire's block,
``wire_block_size(numel, n)`` for the set's ``n``), then run the fused
allreduce of the corrected gradients.  As in the reference, the residual
is recorded even in a world of one, where the int8 wire is the identity
and loses nothing.

``op=Adasum`` reduces each gradient on its own (:mod:`..ops.adasum`) on
the exact wire; ``process_set`` reduces over that set's group;
``backward_passes_per_step=k`` adds ``k`` calls' gradients up and
reduces and steps on every ``k``-th.  The microbatch scan, the overlap
wire and autotuning are not ported yet.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist

from .. import basics
from ..ops import collectives as C
from ..ops.adasum import adasum_pytree
from ..ops.compression import Compression
from ..ops.fusion import fused_allreduce_pytree, tree_flatten
from ..ops.quantization import wire_block_size

logger = logging.getLogger(__name__)
_adasum_comp_warned = False


def _check_reduce_args(op: str, compression=None) -> None:
    if op not in (C.Average, C.Sum, C.Adasum):
        raise ValueError(
            f"Gradient reduction supports Average/Sum/Adasum, got {op!r}")
    if op == C.Adasum and compression not in (None, Compression.none):
        raise ValueError(
            "compression is not supported with op=Adasum (the pairwise "
            "projections need full-precision dot products); drop the "
            "compression argument or use op=Average/Sum")


def _resolve_compression(compression):
    """An explicit argument wins; else ``HVD_TPU_COMPRESSION``; else
    exact."""
    if compression is not None:
        return compression
    if basics.is_initialized() and basics.config().compression:
        return getattr(Compression, basics.config().compression)
    return Compression.none


def _threshold(fusion_threshold: Optional[int]) -> int:
    if fusion_threshold is not None:
        return fusion_threshold
    return basics.config().fusion_threshold


def _reduce_grads(grads: Dict[str, torch.Tensor], *, op: str, group, comp,
                  threshold: int) -> Dict[str, torch.Tensor]:
    """The gradient reduction over ``group``: Adasum leaf by leaf on the
    exact wire (a tier from ``HVD_TPU_COMPRESSION`` is ignored, with one
    warning), else the fused allreduce on ``comp``."""
    if op == C.Adasum:
        global _adasum_comp_warned
        if comp is not Compression.none and not _adasum_comp_warned:
            _adasum_comp_warned = True
            logger.warning(
                "HVD_TPU_COMPRESSION is ignored for op=Adasum (the pairwise "
                "projections need full-precision dot products); this "
                "optimizer runs the exact wire")
        names, leaves = tree_flatten(grads)
        return adasum_pytree(dict(zip(names, leaves)), group)
    return fused_allreduce_pytree(grads, op=op, threshold=threshold,
                                  group=group, compression=comp)


def _write_back(grads: Dict[str, torch.Tensor],
                reduced: Dict[str, torch.Tensor]) -> None:
    for name, g in grads.items():
        if reduced[name] is not g:
            g.copy_(reduced[name])


class DistributedOptimizer:
    """Wrap ``optimizer`` with distributed gradient aggregation
    (reference: ``hvd.DistributedOptimizer``).

    The fused gradients go in the reference's flatten order of their
    parameters' names, so every parameter needs one: pass
    ``named_parameters`` (as in Horovod), or step through
    :func:`make_train_step`, which names them after the model.
    ``compression=None`` and
    ``error_feedback=None`` defer to ``HVD_TPU_COMPRESSION`` and
    ``HVD_TPU_ERROR_FEEDBACK``.  The residual of error feedback lives
    here, one tensor per parameter name, and is a no-op on exact
    wires and under ``op=Adasum``.

    ``process_set`` reduces over that set (a rank outside it raises).
    ``backward_passes_per_step=k``: each :meth:`step` adds the
    ``.grad``s into an accumulator; every ``k``-th divides it by ``k``
    (``average_aggregated_gradients``), reduces it and steps the wrapped
    optimizer, and the other calls leave the wrapped optimizer (its
    state and the parameters) untouched, as the reference's zero
    updates do.
    """

    def __init__(self, optimizer: torch.optim.Optimizer, *,
                 named_parameters: Optional[Iterable[Tuple[str, torch.Tensor]]] = None,
                 op: str = C.Average, compression=None,
                 backward_passes_per_step: int = 1,
                 average_aggregated_gradients: bool = True,
                 process_set=None,
                 fusion_threshold: Optional[int] = None,
                 error_feedback: Optional[bool] = None) -> None:
        _check_reduce_args(op, compression)
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        self.optimizer = optimizer
        self.op = op
        self.compression = compression
        self.backward_passes_per_step = int(backward_passes_per_step)
        self.average_aggregated_gradients = average_aggregated_gradients
        self.process_set = process_set
        self.fusion_threshold = fusion_threshold
        self.error_feedback = error_feedback
        self._names: Optional[Dict[torch.Tensor, str]] = None
        self.residual: Dict[str, torch.Tensor] = {}
        self.accumulator: Dict[str, torch.Tensor] = {}
        self.calls = 0
        if named_parameters is not None:
            self.name_parameters(named_parameters)

    # -- the wrapped optimizer's surface --
    @property
    def param_groups(self):
        return self.optimizer.param_groups

    @property
    def state(self):
        return self.optimizer.state

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.optimizer.zero_grad(set_to_none=set_to_none)

    def state_dict(self):
        return self.optimizer.state_dict()

    def load_state_dict(self, state_dict) -> None:
        self.optimizer.load_state_dict(state_dict)

    # -- distribution --
    @property
    def named(self) -> bool:
        return self._names is not None

    def name_parameters(self, named_parameters) -> None:
        """Name the optimizer's parameters (every one must be named)."""
        by_id = {id(p): name for name, p in named_parameters}
        params = self._params()
        missing = [i for i, p in enumerate(params) if id(p) not in by_id]
        if missing:
            raise ValueError(f"{len(missing)} optimizer parameters have no "
                             "name in named_parameters")
        self._names = {p: by_id[id(p)] for p in params}

    def _params(self) -> List[torch.Tensor]:
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def _error_feedback_on(self) -> bool:
        if self.error_feedback is not None:
            return bool(self.error_feedback)
        return basics.config().error_feedback

    def _grads(self) -> Dict[str, torch.Tensor]:
        if self._names is None:
            raise ValueError(
                "DistributedOptimizer needs the parameters' names: pass "
                "named_parameters=, or step it through make_train_step")
        return {name: p.grad for p, name in self._names.items()
                if p.grad is not None}

    def synchronize(self) -> None:
        """Reduce every parameter's ``.grad`` in place over the set."""
        grads = self._grads()
        group = C.set_group(self.process_set, "DistributedOptimizer")
        comp = _resolve_compression(self.compression)
        if (self._error_feedback_on() and comp is not Compression.none
                and self.op != C.Adasum):
            n = dist.get_world_size(group)
            for name, g in grads.items():
                r = self.residual.get(name)
                if r is not None:
                    g.add_(r)
                self.residual[name] = comp.local_error(
                    g, block_size=wire_block_size(g.numel(), n))
        _write_back(grads, _reduce_grads(
            grads, op=self.op, group=group, comp=comp,
            threshold=_threshold(self.fusion_threshold)))

    def step(self, closure=None):
        """Reduce and step; with ``backward_passes_per_step=k``, only on
        every ``k``-th call (the others add the gradients up and return
        None)."""
        k = self.backward_passes_per_step
        if k > 1:
            C.set_group(self.process_set, "DistributedOptimizer")
            self.calls += 1
            for name, g in self._grads().items():
                acc = self.accumulator.get(name)
                self.accumulator[name] = g.clone() if acc is None else acc + g
            if self.calls % k:
                return None
            for p, name in self._names.items():
                acc = self.accumulator.pop(name, None)
                if acc is not None:
                    p.grad = (acc / k if self.average_aggregated_gradients
                              else acc)
        self.synchronize()
        return self.optimizer.step(closure)


def make_train_step(loss_fn: Callable, optimizer, *, op: str = C.Average,
                    compression=None, process_set=None,
                    fusion_threshold: Optional[int] = None,
                    microbatches: Optional[int] = None) -> Callable:
    """Build the training step (reference: ``make_train_step``).

    ``loss_fn(model, batch) -> loss``.  The returned
    ``step(model, batch)`` computes this rank's gradients, reduces them
    over ``process_set`` with ``op``, ``compression`` and
    ``fusion_threshold`` (unless ``optimizer`` is a
    :class:`DistributedOptimizer`, which does it itself), steps the
    optimizer, updates ``model`` in place and returns the loss averaged
    over ``process_set``'s ranks (every rank by default).  Each rank
    passes its own shard of the batch.  ``microbatches > 1`` is not
    ported yet."""
    _check_reduce_args(op, compression)
    if microbatches is not None and microbatches > 1:
        raise NotImplementedError(
            "microbatches > 1 is not ported yet: its scan runs the overlap "
            "wire, which needs the bucket planner of ROADMAP queue A item 3")
    is_dist = isinstance(optimizer, DistributedOptimizer)

    def step(model: torch.nn.Module, batch) -> torch.Tensor:
        group = C.set_group(process_set, "make_train_step")
        if is_dist and not optimizer.named:
            optimizer.name_parameters(model.named_parameters())
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)
        loss.backward()
        if not is_dist:
            grads = {name: p.grad for name, p in model.named_parameters()
                     if p.grad is not None}
            _write_back(grads, _reduce_grads(
                grads, op=op, group=group,
                comp=_resolve_compression(compression),
                threshold=_threshold(fusion_threshold)))
        optimizer.step()
        return C.reduce_raw(loss.detach(), C.Average, group=group)

    return step
