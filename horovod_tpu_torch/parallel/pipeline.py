"""Pipeline parallelism (the ``pipe``/``pp`` axis): the GPipe schedule.

Counterpart of ``horovod_tpu/parallel/pipeline.py``.  The model's trunk
is a stack of identical stages; rank ``s`` of the ``pp`` group holds
stage ``s``'s parameters, microbatches flow from stage to stage, and the
schedule runs ``n_micro + pp - 1`` ticks (the GPipe bubble).  Every
tick, stage 0 takes microbatch ``t`` and each other stage the activation
its predecessor sent at the last tick; after the stage runs, its output
moves one place along the group (``parallel/comm.py``'s one-sided
``all_to_all_single``: gloo refuses send/recv on CUDA tensors).  The
last stage banks its outputs, and a masked sum over ``pp`` replicates
them.

Where the reference's ``jnp.where`` and masked ``psum`` keep every
tick's ``ppermute`` in every rank's program, the masks here are tensors
too: every rank runs the same graph, so autograd runs every shift's
backward on every rank, in the same order (a Python ``if rank == 0``
would drop a shift's backward from one rank and leave the others
waiting).  The input enters through ``comm.copy_to`` (its gradient, real
at stage 0 only, summed over ``pp``) and the output leaves through
``comm.reduce_from`` (the sum forward, the identity backward): each pp
rank then holds its parameters' true gradient, and a leaf outside the
pipeline (the embedding, the head) the same full gradient on every pp
rank, so the train step sums every gradient over the batch axes only.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..mesh import Mesh
from ..plan import MeshPlan, P, resolve_plan
from .comm import copy_to, reduce_from, shift
from .train import _map


def pipeline_axes(plan: MeshPlan, pp_axis: Optional[str] = None,
                  dp_axis: Optional[str] = "dp"):
    """``(pp_axis, dp)`` as the reference resolves them: ``pp_axis``
    defaults to ``pipe`` when the plan declares it, else ``pp``; ``dp``
    is ``dp_axis`` when the plan has it, else the plan's reduce axes
    without ``pp_axis`` (a name, a tuple of names, or None)."""
    axes = set(plan.axis_names)
    if pp_axis is None:
        pp_axis = "pipe" if "pipe" in axes else "pp"
    if pp_axis not in axes:
        raise ValueError(f"mesh has no axis {pp_axis!r}: {plan.axis_names}")
    dp = dp_axis if (dp_axis and dp_axis in axes) else None
    if dp is None:
        reduce = tuple(a for a in plan.reduce_axes() if a != pp_axis)
        if reduce:
            dp = reduce[0] if len(reduce) == 1 else reduce
    return pp_axis, dp


def pipeline_apply(stage_fn: Callable, stage_params: Any,
                   x: torch.Tensor, *, mesh: Optional[Mesh] = None,
                   n_micro: int, pp_axis: Optional[str] = None,
                   dp_axis: Optional[str] = "dp", remat: bool = False,
                   plan: Optional[MeshPlan] = None) -> torch.Tensor:
    """Run ``x`` through the ``pp`` stages (module docstring).

    ``stage_fn(stage_params, activation) -> activation`` is one stage's
    compute (same shape in and out); ``stage_params`` is this rank's
    stage (:func:`shard_stage_params` cuts it from the stacked tree).
    ``x`` is this rank's rows ``[b, ...]``, the same on every member of
    its ``pp`` group (the batch is split over the other axes by
    :func:`.train.shard_batch`); ``b`` must divide into ``n_micro``
    microbatches.  Returns the pipelined result for those rows, the same
    on every pp rank.

    The plan comes from ``plan=``, a ``mesh=``, or the session;
    ``pp_axis`` and ``dp_axis`` resolve as :func:`pipeline_axes` says
    (the rows are already this rank's, so the dp axis only names the
    layout, as in the reference).  ``remat=True``
    runs each stage under ``torch.utils.checkpoint``: the backward
    recomputes a stage's activations instead of keeping every tick's."""
    plan = resolve_plan(mesh, plan)
    pp_axis, _ = pipeline_axes(plan, pp_axis, dp_axis)
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(
            f"local batch {b} not divisible by n_micro {n_micro}")
    group = plan.group(pp_axis)
    n, me = group.size, group.index
    if remat:
        def run(h):
            return checkpoint(stage_fn, stage_params, h, use_reentrant=False)
    else:
        def run(h):
            return stage_fn(stage_params, h)

    x = copy_to(x, group)
    micro = x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))
    first = torch.tensor(me == 0, device=x.device)
    last = torch.tensor(me == n - 1, device=x.device)
    state = torch.zeros_like(micro[0])
    outputs = []
    for t in range(n_micro + n - 1):
        # Stage 0 takes microbatch t (a repeat once they run out); the
        # others take what their predecessor sent at tick t - 1.
        x_in = torch.where(first, micro[min(t, n_micro - 1)], state)
        y = run(x_in)
        if t >= n - 1:
            # Microbatch t - (n - 1) leaves the last stage now.
            outputs.append(torch.where(last, y, torch.zeros_like(y)))
        if t < n_micro + n - 2:
            # The last tick's shift would feed nothing on any rank.
            state = shift(y, group)
    out = reduce_from(torch.stack(outputs), group)
    return out.reshape(x.shape)


def stage_param_shardings(mesh: Mesh, pp_axis: str = "pp"):
    """The placement of stacked stage parameters: a function mapping a
    tree of ``[n_stages, ...]`` leaves to one spec a leaf, ``P(pp_axis)``
    (the stage dim over ``pp``, the rest whole; compose ``tp`` by
    hand)."""
    del mesh  # one spec for every leaf, as the reference's
    return lambda tree: _map(lambda _: P(pp_axis), tree)


def shard_stage_params(stage_params: Any, mesh: Mesh,
                       pp_axis: str = "pp") -> Any:
    """This rank's stage of a stacked tree (:func:`stack_stage_params`):
    each leaf's row at the rank's ``pp`` index, the stage dim dropped."""
    from .. import basics

    index = mesh.coords(basics.rank())[pp_axis]
    return _map(lambda p: p[index].clone(), stage_params)


def stack_stage_params(per_stage_params: list) -> Any:
    """Stack per-stage trees into one tree with a leading stage dim."""
    first = per_stage_params[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([s[k] for s in per_stage_params])
                for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(stack_stage_params([s[i] for s in
                                               per_stage_params])
                           for i in range(len(first)))
    return torch.stack(list(per_stage_params))
