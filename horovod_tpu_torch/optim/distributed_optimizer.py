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
``wire_block_size(numel, n)``), then run the fused allreduce of the
corrected gradients.  As in the reference, the residual is recorded
even in a world of one, where the int8 wire is the identity and loses
nothing.

Only ``backward_passes_per_step=1``: microbatches, overlap, Adasum and
autotuning are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from .. import basics
from ..ops import collectives as C
from ..ops.compression import Compression
from ..ops.fusion import fused_allreduce_pytree
from ..ops.quantization import wire_block_size


def _check_reduce_args(op: str) -> None:
    if op not in (C.Average, C.Sum):
        raise ValueError(
            f"Gradient reduction supports Average/Sum, got {op!r} "
            "(Adasum is not ported yet)")


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
    wires.
    """

    def __init__(self, optimizer: torch.optim.Optimizer, *,
                 named_parameters: Optional[Iterable[Tuple[str, torch.Tensor]]] = None,
                 op: str = C.Average, compression=None,
                 backward_passes_per_step: int = 1,
                 fusion_threshold: Optional[int] = None,
                 error_feedback: Optional[bool] = None) -> None:
        _check_reduce_args(op)
        if backward_passes_per_step != 1:
            raise NotImplementedError(
                "backward_passes_per_step > 1 is not ported yet")
        self.optimizer = optimizer
        self.op = op
        self.compression = compression
        self.fusion_threshold = fusion_threshold
        self.error_feedback = error_feedback
        self._names: Optional[Dict[torch.Tensor, str]] = None
        self.residual: Dict[str, torch.Tensor] = {}
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

    def synchronize(self) -> None:
        """Allreduce every parameter's ``.grad`` in place."""
        if self._names is None:
            raise ValueError(
                "DistributedOptimizer needs the parameters' names: pass "
                "named_parameters=, or step it through make_train_step")
        grads = {name: p.grad for p, name in self._names.items()
                 if p.grad is not None}
        comp = _resolve_compression(self.compression)
        if self._error_feedback_on() and comp is not Compression.none:
            n = basics.size()
            for name, g in grads.items():
                r = self.residual.get(name)
                if r is not None:
                    g.add_(r)
                self.residual[name] = comp.local_error(
                    g, block_size=wire_block_size(g.numel(), n))
        reduced = fused_allreduce_pytree(
            grads, op=self.op, threshold=_threshold(self.fusion_threshold),
            compression=comp)
        for name, g in grads.items():
            if reduced[name] is not g:
                g.copy_(reduced[name])

    def step(self, closure=None):
        self.synchronize()
        return self.optimizer.step(closure)


def make_train_step(loss_fn: Callable, optimizer, *, op: str = C.Average,
                    compression=None,
                    fusion_threshold: Optional[int] = None) -> Callable:
    """Build the training step (reference: ``make_train_step``).

    ``loss_fn(model, batch) -> loss``.  The returned
    ``step(model, batch)`` computes this rank's gradients, allreduces
    them with ``op``, ``compression`` and ``fusion_threshold`` (unless
    ``optimizer`` is a :class:`DistributedOptimizer`, which does it
    itself), steps the optimizer, updates ``model`` in place and returns
    the loss averaged over ranks.  Each rank passes its own shard of the
    batch."""
    _check_reduce_args(op)
    is_dist = isinstance(optimizer, DistributedOptimizer)

    def step(model: torch.nn.Module, batch) -> torch.Tensor:
        if is_dist and not optimizer.named:
            optimizer.name_parameters(model.named_parameters())
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)
        loss.backward()
        if not is_dist:
            grads = {name: p.grad for name, p in model.named_parameters()
                     if p.grad is not None}
            reduced = fused_allreduce_pytree(
                grads, op=op, threshold=_threshold(fusion_threshold),
                compression=_resolve_compression(compression))
            for name, g in grads.items():
                if reduced[name] is not g:
                    g.copy_(reduced[name])
        optimizer.step()
        return C.reduce_raw(loss.detach(), C.Average)

    return step
