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
reduces and steps on every ``k``-th; ``two_phase`` and
``pipeline_depth`` put the fused buckets on the pipelined reduce-scatter
+ all-gather wire (:func:`..ops.fusion.fused_two_phase_apply`).

Every named parameter that requires a gradient is reduced, a zero
gradient standing in where this rank's backward left ``.grad`` None, so
every rank has the same fusion plan (the reference's ``jax.grad`` gives
zeros for an unused leaf); the reduced gradient is written back.

``make_train_step(microbatches=k)`` accumulates ``k`` microbatches'
gradients in a Python loop (the reference's scan).  With the overlap
wire, each microbatch's bucketed reduce-scatter is started before the
next microbatch's forward and backward, the shards accumulate, and one
all-gather runs at the update.  Autotuning is not ported.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist

from .. import basics
from ..config import DEFAULT_COST_ALPHA_US, DEFAULT_COST_BETA_GBPS
from ..ops import collectives as C
from ..ops import fusion
from ..ops.adasum import adasum_pytree
from ..ops.compression import Compression
from ..ops.fusion import fused_allreduce_pytree, tree_flatten
from ..ops.quantization import wire_block_size

logger = logging.getLogger(__name__)
_adasum_comp_warned = False
_snap_warned: set = set()


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
                  threshold: int, two_phase: Optional[bool] = None,
                  pipeline_depth: Optional[int] = None,
                  ) -> Dict[str, torch.Tensor]:
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
                                  group=group, compression=comp,
                                  two_phase=two_phase,
                                  pipeline_depth=pipeline_depth)


def _write_back(grads: Dict[str, torch.Tensor],
                reduced: Dict[str, torch.Tensor]) -> None:
    for name, g in grads.items():
        if reduced[name] is not g:
            g.copy_(reduced[name])


def _filled_grads(named: Iterable[Tuple[str, torch.Tensor]],
                  ) -> Dict[str, torch.Tensor]:
    """``{name: p.grad}`` for every parameter that requires a gradient,
    a zero ``.grad`` set where the backward left none, so every rank
    reduces the same leaves."""
    grads = {}
    for name, p in named:
        if not p.requires_grad:
            continue
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads[name] = p.grad
    return grads


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
    ``two_phase`` and ``pipeline_depth`` (None: the live config) select
    the pipelined two-phase wire of the fused buckets.
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
                 two_phase: Optional[bool] = None,
                 pipeline_depth: Optional[int] = None,
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
        self.two_phase = two_phase
        self.pipeline_depth = pipeline_depth
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
        return _filled_grads((name, p) for p, name in self._names.items())

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
            threshold=_threshold(self.fusion_threshold),
            two_phase=self.two_phase, pipeline_depth=self.pipeline_depth))

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


def snap_microbatches(requested: int, rows: int) -> int:
    """Largest divisor of ``rows`` that is <= ``requested``: the
    snapping rule for a config-driven microbatch count."""
    mb = min(max(1, int(requested)), max(1, int(rows)))
    while rows % mb:
        mb -= 1
    return mb


def _batch_leaves(batch) -> List[torch.Tensor]:
    if torch.is_tensor(batch):
        return [batch]
    if isinstance(batch, dict):
        return [t for k in sorted(batch) for t in _batch_leaves(batch[k])]
    if isinstance(batch, (tuple, list)):
        return [t for item in batch for t in _batch_leaves(item)]
    return []


def _microbatch(batch, i: int, mb: int):
    """Microbatch ``i`` of ``mb``: rows ``[i * b / mb, (i + 1) * b / mb)``
    of every tensor of ``batch`` (a tensor, or tuples, lists and dicts of
    them)."""
    if torch.is_tensor(batch):
        rows = batch.shape[0] // mb
        return batch[i * rows:(i + 1) * rows]
    if isinstance(batch, dict):
        return {k: _microbatch(v, i, mb) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_microbatch(v, i, mb) for v in batch)
    return batch


def _resolve_microbatches(requested: Optional[int], batch) -> int:
    """The microbatch count of this step: the explicit argument, else
    ``HVD_TPU_MICROBATCHES``.  It must divide the per-rank batch rows:
    an explicit non-divisor raises, while a config-driven count snaps
    down to the largest divisor, with one warning per shape."""
    leaves = _batch_leaves(batch)
    if not leaves:
        return 1
    shape = leaves[0].shape
    b = int(shape[0]) if len(shape) else 1
    mb = requested
    if mb is None:
        mb = basics.config().microbatches if basics.is_initialized() else 1
    mb = int(mb)
    if mb <= 1:
        return 1
    if requested is not None and (mb > b or b % mb):
        raise ValueError(
            f"microbatches={mb} does not divide the per-rank batch of "
            f"{b} rows; pick a divisor (or pad the batch)")
    if b <= 1:
        return 1
    snapped = snap_microbatches(mb, b)
    if snapped != mb:
        key = (mb, snapped, b)
        if key not in _snap_warned:
            _snap_warned.add(key)
            logger.warning(
                "HVD_TPU_MICROBATCHES=%d does not divide the per-rank "
                "batch of %d rows; snapping to %d", mb, b, snapped)
    return snapped


def _loss_and_aux(loss_fn, model, batch, has_aux: bool):
    """``loss_fn(model, batch)`` as ``(loss, aux)``: with ``has_aux`` the
    function returns both (aux detached here), else aux is None."""
    out = loss_fn(model, batch)
    if not has_aux:
        return out, None
    loss, aux = out
    return loss, _map_tensors(lambda t: t.detach(), aux)


def _map_tensors(fn, tree):
    """``fn`` on every leaf of a tree of tuples, lists and dicts; a
    non-tensor leaf becomes a tensor first."""
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return fn(torch.as_tensor(tree))


def _stack_aux(auxes: list):
    """Per-microbatch aux trees stacked leaf by leaf: ``[mb, ...]``."""
    first = auxes[0]
    if isinstance(first, dict):
        return {k: _stack_aux([a[k] for a in auxes]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack_aux([a[i] for a in auxes])
                           for i in range(len(first)))
    return torch.stack(auxes)


def _microbatch_grads(model, loss_fn, batch, mb: int,
                      params: List[torch.Tensor], *, has_aux: bool = False,
                      overlap: bool = False,
                      op: str = C.Average, group=None, compression=None,
                      threshold: int = fusion.DEFAULT_THRESHOLD,
                      alpha_us: float = DEFAULT_COST_ALPHA_US,
                      beta_gbps: float = DEFAULT_COST_BETA_GBPS):
    """Gradients of ``params`` accumulated over ``mb`` microbatches of
    ``batch``, in microbatch order: ``(loss, grads, aux, reduced)``, the
    loss and gradients averaged over the microbatches, ``aux`` (with
    ``has_aux``) stacked ``[mb, ...]``, and ``reduced`` True when the
    overlap wire already reduced the gradients over ``group``.

    With ``overlap`` and more than one rank, after microbatch *i*'s
    backward its gradients (zero where ``.grad`` is None) start their
    bucketed reduce-scatter (:func:`..ops.fusion.overlap_reduce_scatter`),
    microbatch *i+1*'s forward and backward run, and then the shards are
    waited and added into accumulators that start from zeros; after the
    last microbatch's reduce-scatter, one all-gather rebuilds the
    gradients, divided by ``mb``.  Without it, ``((g0 + g1) + ...) /
    mb``."""
    def grads_of(i):
        for p in params:
            p.grad = None
        loss, aux = _loss_and_aux(loss_fn, model, _microbatch(batch, i, mb),
                                  has_aux)
        loss.backward()
        auxes.append(aux)
        # The list keeps this microbatch's gradients alive while their
        # reduce-scatter is in flight and the next backward runs.
        return loss.detach(), [p.grad if p.grad is not None
                               else torch.zeros_like(p) for p in params]

    auxes = []
    n = fusion._uniform_group_width(group)
    use_overlap = bool(overlap) and n > 1
    loss_sum, g0 = grads_of(0)
    if use_overlap:
        plan = fusion.plan_overlap_buckets(
            g0, threshold, world_size=n, alpha_us=alpha_us,
            beta_gbps=beta_gbps)
        acc = fusion.zero_overlap_shards(plan, device=params[0].device)
        pending = g0
        for i in range(1, mb):
            started = fusion.overlap_reduce_scatter(
                pending, plan, op=op, group=group, compression=compression)
            loss_i, pending = grads_of(i)
            acc = tuple(a + s for a, s in zip(acc, started.wait()))
            loss_sum = loss_sum + loss_i
        last = fusion.overlap_reduce_scatter(
            pending, plan, op=op, group=group, compression=compression)
        acc = tuple(a + s for a, s in zip(acc, last.wait()))
        full = fusion.overlap_all_gather(acc, plan, g0, group=group,
                                         compression=compression)
        grads = [g / mb for g in full]
    else:
        acc = g0
        for i in range(1, mb):
            loss_i, g_i = grads_of(i)
            acc = [a + g for a, g in zip(acc, g_i)]
            loss_sum = loss_sum + loss_i
        grads = [a / mb for a in acc]
    aux = _stack_aux(auxes) if has_aux else None
    return loss_sum / mb, grads, aux, use_overlap


def make_train_step(loss_fn: Callable, optimizer, *, op: str = C.Average,
                    compression=None, process_set=None,
                    fusion_threshold: Optional[int] = None,
                    two_phase: Optional[bool] = None,
                    pipeline_depth: Optional[int] = None,
                    microbatches: Optional[int] = None,
                    overlap: Optional[bool] = None,
                    has_aux: bool = False) -> Callable:
    """Build the training step (reference: ``make_train_step``).

    ``loss_fn(model, batch) -> loss``.  The returned
    ``step(model, batch)`` computes this rank's gradients, reduces them
    over ``process_set`` with ``op``, ``compression``,
    ``fusion_threshold``, ``two_phase`` and ``pipeline_depth`` (unless
    ``optimizer`` is a :class:`DistributedOptimizer`, which does it
    itself), steps the optimizer, updates ``model`` in place and returns
    the loss averaged over ``process_set``'s ranks (every rank by
    default).  Each rank passes its own shard of the batch.

    ``has_aux``: ``loss_fn`` returns ``(loss, aux)`` (a tensor, or tuples,
    lists and dicts of them) and the step returns ``(loss, aux)``, aux
    this rank's, detached, and stacked ``[microbatches, ...]`` when the
    step accumulates microbatches (the reference's contract, whose aux
    comes back stacked over the slots).

    ``microbatches`` (None: ``HVD_TPU_MICROBATCHES``) accumulates that
    many microbatches of the batch (:func:`_microbatch_grads`).  With
    ``overlap`` (None: ``HVD_TPU_OVERLAP_REDUCE``, on by default), which
    applies when this step reduces (``optimizer`` is not a
    :class:`DistributedOptimizer`), ``op`` is not Adasum and the set has
    more than one rank, each microbatch's reduce-scatter is started
    before the next microbatch's forward and backward and the
    all-gather runs once at the update.  With a
    :class:`DistributedOptimizer` the microbatches accumulate locally
    and the optimizer reduces once, error feedback included."""
    _check_reduce_args(op, compression)
    is_dist = isinstance(optimizer, DistributedOptimizer)

    def overlap_on() -> bool:
        if overlap is not None:
            return bool(overlap)
        return basics.config().overlap_reduce

    def step(model: torch.nn.Module, batch) -> torch.Tensor:
        group = C.set_group(process_set, "make_train_step")
        if is_dist and not optimizer.named:
            optimizer.name_parameters(model.named_parameters())
        comp = _resolve_compression(compression)
        threshold = _threshold(fusion_threshold)
        names, params = tree_flatten({name: p for name, p
                                      in model.named_parameters()
                                      if p.requires_grad})
        mb = _resolve_microbatches(microbatches, batch)
        reduced = False
        if mb > 1:
            cfg = basics.config()
            loss, grads, aux, reduced = _microbatch_grads(
                model, loss_fn, batch, mb, params, has_aux=has_aux,
                overlap=overlap_on() and not is_dist and op != C.Adasum,
                op=op, group=group, compression=comp, threshold=threshold,
                alpha_us=cfg.cost_alpha_us, beta_gbps=cfg.cost_beta_gbps)
            for p, g in zip(params, grads):
                p.grad = g
        else:
            optimizer.zero_grad(set_to_none=True)
            loss, aux = _loss_and_aux(loss_fn, model, batch, has_aux)
            loss.backward()
        if not is_dist and not reduced:
            grads = _filled_grads(zip(names, params))
            _write_back(grads, _reduce_grads(
                grads, op=op, group=group, comp=comp, threshold=threshold,
                two_phase=two_phase, pipeline_depth=pipeline_depth))
        optimizer.step()
        loss = C.reduce_raw(loss.detach(), C.Average, group=group)
        return (loss, aux) if has_aux else loss

    return step
