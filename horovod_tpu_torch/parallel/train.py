"""Multi-axis training: the dp × sp × tp counterpart of
``optim.make_train_step``.

Counterpart of ``horovod_tpu/parallel/train.py``.  The reference places
global arrays and lets GSPMD insert the reductions; here each rank holds
its shards and the reductions are written out:

* :func:`..parallel.sharding.shard_params` keeps the rank's ``tp`` slice
  of each parameter, :func:`shard_batch` its ``dp``/``sp`` slice of the
  batch;
* the loss is a sum over the batch axes' group (``dp × sp``) of each
  rank's contribution (``lm_loss_fn``: the local sum over the global
  token count), so every rank reports the global mean;
* the gradients are summed over the same group: the replicated
  parameters' and, for a ``tp``-sharded one, its slice's over the ranks
  that hold the same slice (the group pins the ``tp`` index), as a
  pipeline stage's leaf pins its ``pp`` index and an expert's its
  ``ep`` index.  A leaf outside the pipeline or the experts (the
  embedding, the head, the router) has the same whole gradient on every
  ``pp`` and ``ep`` rank, since those regions take their input through
  ``comm.copy_to`` and give their output through ``comm.reduce_from``:
  the batch group alone sums it.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from .. import basics
from ..mesh import Mesh
from ..plan import MeshPlan, P
from .sharding import drop_missing_axes


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(batch: Any, mesh: Mesh, spec: P, *,
                local: bool = False) -> Any:
    """This rank's slice of every leaf of ``batch`` under ``spec`` (e.g.
    ``P('dp', 'sp')`` for ``[B, T]`` tokens), as tensors on this rank's
    device.  Axes absent from the mesh are dropped.

    By default each leaf is the GLOBAL batch, the same on every rank
    (seeded data), and each dim is cut by its axes.  ``local=True``
    takes each rank's own rows, as a per-rank input pipeline gives them:
    dim 0 is already this rank's share and only the other dims are
    cut."""
    from .sharding import _dim_shards

    spec = drop_missing_axes(spec, mesh)
    coords = mesh.coords(basics.rank())
    device = basics.device()

    def cut(x):
        t = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
        for dim, parts, index, _ in _dim_shards(spec, mesh, coords):
            if local and dim == 0:
                continue
            if t.shape[dim] % parts:
                raise ValueError(f"dim {dim} of {tuple(t.shape)} does not "
                                 f"split {parts} ways")
            span = t.shape[dim] // parts
            t = t.narrow(dim, index * span, span)
        return t.contiguous().to(device)

    return _map(cut, batch)


def init_opt_state(tx: Callable, model: torch.nn.Module):
    """The optimizer over the model's parameters as they are now, after
    :func:`.sharding.shard_params`: ``tx(parameters)`` (e.g. ``lambda ps:
    torch.optim.AdamW(ps, lr=3e-4)``), so its state is made from, and
    shards like, each rank's slices."""
    return tx(list(model.parameters()))


def _model_plan(model) -> MeshPlan:
    plan = model.mesh_plan() if hasattr(model, "mesh_plan") else None
    if plan is None:
        raise ValueError(
            "make_spmd_train_step needs a model built on a mesh, e.g. "
            "GPT(cfg, mesh=make_mesh({'dp': 2, 'sp': 2})): its mesh names "
            "the batch axes the loss and the gradients sum over")
    return plan


def make_spmd_train_step(loss_fn: Callable, optimizer, *,
                         has_aux: bool = False,
                         microbatches: Optional[int] = None) -> Callable:
    """Build ``step(model, batch) -> loss`` (``(loss, aux)`` with
    ``has_aux``) for a sharded model and batch (module docstring).

    ``loss_fn(model, batch)`` returns the GLOBAL loss on every rank,
    each rank's autograd seeing its own contribution (as
    :func:`..models.transformer.lm_loss_fn` does on a model with a
    mesh); the step sums the gradients over the model's batch axes
    (``model.mesh_plan().batch_axes()``) and steps ``optimizer``, a
    torch optimizer over the model's local parameters.

    ``microbatches`` (None: ``HVD_TPU_MICROBATCHES``) accumulates that
    many microbatches of the local batch before the one update, through
    ``optim``'s microbatch loop; ``aux`` then comes back stacked
    ``[microbatches, ...]``.

    The step is instrumented (``obs.instrument.build_step``, kind
    ``spmd``).  Where the reference leaves the gradient sums to GSPMD,
    the port's ride the fused wire, so its step also records an ``spmd``
    fusion plan."""
    from ..ops import collectives as C
    from ..ops.compression import Compression
    from ..ops.fusion import tree_flatten
    from ..optim.distributed_optimizer import (_filled_grads, _loss_and_aux,
                                               _microbatch_grads,
                                               _reduce_grads,
                                               _resolve_microbatches,
                                               _threshold, _write_back)

    def step(model: torch.nn.Module, batch):
        plan = _model_plan(model)
        group = plan.group(plan.batch_axes())
        names, params = tree_flatten({name: p for name, p
                                      in model.named_parameters()
                                      if p.requires_grad})
        mb = _resolve_microbatches(microbatches, batch)
        if mb > 1:
            loss, grads, aux, _ = _microbatch_grads(
                model, loss_fn, batch, mb, params, has_aux=has_aux)
            for p, g in zip(params, grads):
                p.grad = g
        else:
            optimizer.zero_grad(set_to_none=True)
            loss, aux = _loss_and_aux(loss_fn, model, batch, has_aux)
            loss.backward()
        if group.size > 1:
            grads = _filled_grads(zip(names, params))
            _write_back(grads, _reduce_grads(
                grads, op=C.Sum, group=group.group, comp=Compression.none,
                threshold=_threshold(None)))
        optimizer.step()
        loss = loss.detach()
        return (loss, aux) if has_aux else loss

    from ..obs import instrument

    return instrument.build_step(step, kind="spmd")
