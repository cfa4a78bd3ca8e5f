"""The hook-driven gradient-averaging optimizer of the torch binding.

Counterpart of ``horovod_tpu/torch/optimizer.py`` (reference:
``horovod/torch/optimizer.py``).  ``DistributedOptimizer(opt)`` returns
an instance of a class made on the fly that inherits from the user's
optimizer class, so ``isinstance(opt, torch.optim.AdamW)`` holds and LR
schedulers keep working.  It registers one
``register_post_accumulate_grad_hook`` a parameter that requires a
gradient; every ``backward_passes_per_step``-th accumulation starts
``allreduce_async_(p.grad)`` while backward is still running, and
``step()`` first waits on every handle (``synchronize``).

This is not the core's :class:`horovod_tpu_torch.optim.
DistributedOptimizer`, which reduces fused buckets in ``step()`` after
backward. The two routes compute the same average: each sums the ranks'
gradients and divides by the set's size.

Hooks run on autograd's threads: on a CUDA parameter the post-accumulate
hook runs on the engine's thread for that device, with the stream of the
op that produced the gradient current, so the collective the hook starts
is ordered after that op. The engine runs one device's nodes in one
deterministic order, so every rank dispatches the same collectives in
the same order.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from . import mpi_ops
from .compression import Compression


class _DistributedOptimizer(torch.optim.Optimizer):
    def __init__(self, params, named_parameters=None,
                 compression=Compression.none,
                 backward_passes_per_step: int = 1,
                 op: str = mpi_ops.Average,
                 gradient_predivide_factor: float = 1.0,
                 process_set=None,
                 sparse_as_dense: bool = False,
                 num_groups: int = 0):
        super(self.__class__, self).__init__(params)

        if gradient_predivide_factor != 1.0 and op != mpi_ops.Average:
            raise ValueError(
                "gradient_predivide_factor is only supported with op=Average")
        if num_groups < 0:
            raise ValueError("num_groups must be >= 0")

        if named_parameters is not None:
            named_parameters = list(named_parameters)
            if named_parameters and not isinstance(named_parameters[0], tuple):
                raise ValueError(
                    "named_parameters should be a sequence of (name, param) "
                    "tuples (e.g. model.named_parameters())")
            self._param_names = {p: n for n, p in named_parameters}
        else:
            self._param_names = {}

        self._compression = compression
        self._op = op
        self._sparse_as_dense = bool(sparse_as_dense)
        self._process_set = process_set
        self._predivide = float(gradient_predivide_factor)
        # num_groups > 0: the dense gradients ride that many grouped
        # allreduces, ``grouped[g::n]`` in stable parameter order; a
        # group is dispatched as soon as all its members are ready, and
        # members whose hook never fired are swept into a partial group
        # at synchronize().
        self._num_groups = int(num_groups)
        self._param_group: Dict[torch.Tensor, int] = {}
        if self._num_groups > 0:
            grouped = [p for p in self._all_params() if p.requires_grad]
            n = min(self._num_groups, len(grouped))
            for g in range(n):
                for p in grouped[g::n]:
                    self._param_group[p] = g
        self._group_size = {
            g: sum(1 for v in self._param_group.values() if v == g)
            for g in set(self._param_group.values())
        }
        self._group_ready: Dict[int, List[torch.Tensor]] = {}
        self.backward_passes_per_step = int(backward_passes_per_step)

        self._handles: Dict[torch.Tensor, Tuple] = {}
        self._grad_passes: Dict[torch.Tensor, int] = {}
        self._should_synchronize = True
        self._hook_handles = []
        self._register_hooks()

    # -- hook plumbing -------------------------------------------------------

    def _all_params(self):
        for group in self.param_groups:
            for p in group["params"]:
                yield p

    def _register_hooks(self) -> None:
        # One hook a parameter object: a tied weight (GPT's wte and
        # lm_head) is one parameter, so it gets one hook and one
        # reduction of its accumulated gradient.
        for p in self._all_params():
            if p.requires_grad:
                self._hook_handles.append(
                    p.register_post_accumulate_grad_hook(self._make_hook()))

    def _make_hook(self):
        def hook(p: torch.Tensor) -> None:
            if p.grad is None:
                return
            self._grad_passes[p] = self._grad_passes.get(p, 0) + 1
            if self._grad_passes[p] % self.backward_passes_per_step != 0:
                return
            self._enqueue_allreduce(p)
        return hook

    def _allreduce_kwargs(self) -> dict:
        prescale, postscale = 1.0, 1.0
        if self._predivide != 1.0:
            # Divide by the factor before the sum, multiply by it after:
            # Average's result with a controllable intermediate scale.
            prescale = 1.0 / self._predivide
            postscale = self._predivide
        if self.backward_passes_per_step > 1:
            prescale = prescale / self.backward_passes_per_step
        return dict(op=self._op, compression=self._compression,
                    process_set=self._process_set,
                    prescale_factor=prescale, postscale_factor=postscale)

    def _name(self, p: torch.Tensor) -> str:
        return self._param_names.get(p, f"param.{id(p)}")

    def _enqueue_allreduce(self, p: torch.Tensor) -> None:
        name = self._name(p)
        if p.grad.is_sparse:
            if self._sparse_as_dense:
                # A densified gradient joins its group like a dense one.
                p.grad = p.grad.to_dense()
            else:
                if self._op == mpi_ops.Adasum:
                    raise NotImplementedError(
                        "op=Adasum does not support sparse gradients; "
                        "pass sparse_as_dense=True")
                handle = mpi_ops.sparse_allreduce_async(
                    p.grad, op=self._op, process_set=self._process_set,
                    postscale_factor=1.0 / self.backward_passes_per_step,
                    name=f"sparse_allreduce.{name}")
                self._handles[p] = ("sparse", handle)
                return
        g = self._param_group.get(p)
        if g is not None:
            existing = self._handles.get(p)
            if isinstance(existing, tuple) \
                    and existing[0] in ("pending_group", "group"):
                # A second backward before step(): enqueueing the
                # parameter again would count it twice in the fused wire.
                raise AssertionError(
                    f"Gradient for {name} was computed twice in the "
                    "grouped path before optimizer.step(); this usually "
                    "means multiple backward passes without a step — "
                    "use backward_passes_per_step > 1 (or call "
                    "optimizer.synchronize() between passes)")
            ready = self._group_ready.setdefault(g, [])
            ready.append(p)
            self._handles[p] = ("pending_group", g)
            if len(ready) == self._group_size[g]:
                self._dispatch_group(g)
            return
        self._handles[p] = mpi_ops.allreduce_async_(
            p.grad, name=f"allreduce.{name}", **self._allreduce_kwargs())

    def _dispatch_group(self, g: int) -> None:
        """One grouped allreduce over the group's ready members, in
        stable parameter order so every rank's fused layout is equal."""
        ready = self._group_ready.pop(g, [])
        if not ready:
            return
        order = {p: i for i, p in enumerate(self._all_params())}
        ready.sort(key=lambda p: order[p])
        handle = mpi_ops.grouped_allreduce_async_(
            [p.grad for p in ready], name=f"grouped_allreduce.g{g}",
            **self._allreduce_kwargs())
        for p in ready:
            self._handles[p] = ("group", handle)

    # -- reference API -------------------------------------------------------

    def set_backward_passes_per_step(self, passes: int) -> None:
        """Reference: ``optimizer.set_backward_passes_per_step``."""
        self.backward_passes_per_step = int(passes)

    def synchronize(self) -> None:
        """Reference: ``optimizer.synchronize()``: reduce the parameters
        whose hook never fired (a gradient set by hand, an unused
        parameter's left-over gradient), dispatch partial groups, then
        wait on every handle."""
        for p in self._all_params():
            if p.requires_grad and p.grad is not None \
                    and p not in self._handles:
                self._enqueue_allreduce(p)
        for g in list(self._group_ready):
            self._dispatch_group(g)
        waited = set()
        for p, handle in self._handles.items():
            if isinstance(handle, tuple) and handle[0] == "sparse":
                p.grad = handle[1].wait()
            elif isinstance(handle, tuple) and handle[0] == "group":
                if id(handle[1]) not in waited:
                    waited.add(id(handle[1]))
                    mpi_ops.synchronize(handle[1])
            else:
                mpi_ops.synchronize(handle)
        self._handles.clear()
        self._grad_passes.clear()

    @contextlib.contextmanager
    def skip_synchronize(self):
        """Reference: ``with optimizer.skip_synchronize(): optimizer.step()``
        after a manual ``synchronize()`` (e.g. to clip gradients)."""
        self._should_synchronize = False
        try:
            yield
        finally:
            self._should_synchronize = True

    def step(self, closure=None):
        if self._should_synchronize:
            self.synchronize()
        return super(self.__class__, self).step(closure)

    def zero_grad(self, *args, **kwargs):
        if self._handles:
            raise AssertionError(
                "optimizer.zero_grad() was called after loss.backward() but "
                "before optimizer.step() or optimizer.synchronize(); this is "
                "prohibited as it can cause a race condition")
        return super(self.__class__, self).zero_grad(*args, **kwargs)


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters: Optional[Iterable] = None,
                         compression=Compression.none,
                         backward_passes_per_step: int = 1,
                         op: str = mpi_ops.Average,
                         gradient_predivide_factor: float = 1.0,
                         process_set=None,
                         sparse_as_dense: bool = False,
                         num_groups: int = 0) -> torch.optim.Optimizer:
    """Reference: ``hvd.DistributedOptimizer``: wraps any torch optimizer
    so that ``step()`` applies the gradients averaged over the ranks.
    The result is an instance of a subclass of the user's optimizer
    class made from its ``param_groups`` (hyperparameters kept, state
    fresh)."""
    cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
               dict(_DistributedOptimizer.__dict__))
    return cls(optimizer.param_groups, named_parameters, compression,
               backward_passes_per_step, op, gradient_predivide_factor,
               process_set, sparse_as_dense, num_groups)
