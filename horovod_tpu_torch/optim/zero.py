"""ZeRO-1 sharded optimizer: optimizer state partitioned over the ranks.

Counterpart of ``horovod_tpu/optim/zero.py``.  The ranks are the session
plan's reduce group (``resolve_mesh_axis`` in the reference): the whole
world, or for a plan with model axes (``data=2,tensor=2``) this rank's
group along the reduce axes, each such group sharding its own state.
A step:

* reduce-scatters the gradients over the ranks on the chosen wire
  (:meth:`Compressor.spmd_reducescatter`), so each rank receives one
  fully reduced ``1/n`` flat shard of every leaf;
* steps a ``torch.optim.Optimizer`` that holds only this rank's flat
  shards, so each rank keeps ``1/n`` of the optimizer state;
* all-gathers the updated shards back into the model's parameters,
  always exactly (``all_gather_into_tensor``): the gathered parameters
  are the master weights, and a lossy wire there would round away every
  update smaller than its resolution.

Leaves are partitioned on their flattened elements (zero padded to a
multiple of ``n``), so the optimizer must be elementwise in its
statistics (SGD/momentum, Adam/AdamW, RMSProp); one that needs a
whole-tensor view, such as global-norm clipping inside the optimizer,
sees only shards.

The wire layout follows the reference exactly, because the int8 wire
quantizes whatever lands in a block: leaves are bucketed per dtype (no
promotion) in the reference's flatten order by the fusion planner at the
fusion threshold, zero-size leaves join no bucket and pass through, and
a bucket is the leaves' ``[n, L_i / n]`` pieces laid side by side, so
rank ``r``'s slice of the reduce-scatter holds piece ``r`` of every
leaf.  With error feedback, each leaf's residual is added to its
gradient and the new residual recorded (at the wire's block,
``wire_block_size(numel, n)``) before the reduce-scatter, on a lossy
wire only.

Usage::

    step = hvd.make_zero_train_step(
        hvd.models.lm_loss_fn(model),
        lambda shards: torch.optim.AdamW(shards, lr=3e-4, weight_decay=1e-4),
        compression=hvd.Compression.int8, error_feedback=True)
    loss = step(model, batch)        # this rank's shard of the batch
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional

import torch
import torch.distributed as dist

from .. import basics
from ..ops import collectives as C
from ..ops.compression import Compression
from ..ops.fusion import plan_buckets_py, tree_flatten
from ..ops.quantization import wire_block_size
from .distributed_optimizer import (_loss_and_aux, _mesh_group,
                                    _resolve_compression)


class ZeroStateWithResidual(NamedTuple):
    """ZeRO state with error feedback on: the optimizer over this rank's
    shards, and each leaf's residual (the local quantization error of the
    lossy reduce-scatter wire, re-injected next step).  The structure
    itself says that error feedback is on."""

    inner: torch.optim.Optimizer
    residual: Dict[str, torch.Tensor]


def _flat_pad(t: torch.Tensor, n: int) -> torch.Tensor:
    flat = t.reshape(-1)
    pad = (-flat.numel()) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat


class ZeroTrainStep:
    """``step(model, batch) -> loss``, ``(loss, aux)`` with ``has_aux``
    (see :func:`make_zero_train_step`).

    The first call builds the state from the model's parameters:
    :attr:`shards` (``{name: this rank's flat shard}``, the optimizer's
    parameters), :attr:`buckets` (the bucket plan, leaf indices in
    flatten order) and :attr:`state`, the optimizer, or a
    :class:`ZeroStateWithResidual` when error feedback is on.  Later
    calls must pass a model with the same parameter names.

    From then on the shards are the master weights: each step writes the
    model's parameters from them, so a write to the parameters made
    outside the step (a checkpoint load) is overwritten by the next
    step; build a new step after one."""

    def __init__(self, loss_fn: Callable, make_optimizer: Callable, *,
                 op: str, compression,
                 error_feedback: Optional[bool], has_aux: bool = False,
                 mesh=None, axis_name: Optional[str] = None) -> None:
        self.loss_fn = loss_fn
        self.has_aux = has_aux
        self.mesh = mesh
        self.axis_name = axis_name
        self.make_optimizer = make_optimizer
        self.op = op
        self.compression = compression
        self.error_feedback = error_feedback
        self.shards: Dict[str, torch.nn.Parameter] = {}
        self.state = None
        self._names: List[str] = []
        self.buckets: List[List[int]] = []
        self._pending: Optional[dict] = None   # a state dict loaded early

    @property
    def optimizer(self) -> torch.optim.Optimizer:
        if isinstance(self.state, ZeroStateWithResidual):
            return self.state.inner
        return self.state

    def state_dict(self) -> dict:
        """``{"optimizer": the shard optimizer's state dict}``, plus
        ``"residual"`` (``{name: tensor}``) when error feedback is on.
        The shards themselves are the model's parameters' pieces, which
        the first step after a load rebuilds from the model."""
        if self.state is None:
            if self._pending is not None:
                return self._pending
            raise ValueError("make_zero_train_step: the step holds no state "
                             "before its first call")
        sd = {"optimizer": self.optimizer.state_dict()}
        if isinstance(self.state, ZeroStateWithResidual):
            sd["residual"] = dict(self.state.residual)
        return sd

    def load_state_dict(self, state_dict: dict) -> None:
        """Load :meth:`state_dict`'s form.  On a step not built yet the
        state waits for the first call, which builds the shards from the
        model and then loads it."""
        if self.state is None:
            self._pending = dict(state_dict)
            return
        self.optimizer.load_state_dict(state_dict["optimizer"])
        if isinstance(self.state, ZeroStateWithResidual):
            if "residual" not in state_dict:
                raise ValueError("make_zero_train_step: error feedback is "
                                 "on, but the state dict has no residual")
            live = self.state.residual
            for name, t in state_dict["residual"].items():
                live[name] = t.to(live[name].device, copy=True)

    def _build(self, names: List[str], params: List[torch.Tensor],
               group) -> None:
        n = dist.get_world_size(group)
        rank = dist.get_rank(group)
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for i, p in enumerate(params):
            if p.numel():
                by_dtype.setdefault(p.dtype, []).append(i)
        threshold = basics.config().fusion_threshold
        self.buckets = []
        for dtype, idxs in by_dtype.items():
            itemsize = torch.empty((), dtype=dtype).element_size()
            sizes = [_flat_pad(params[i], n).numel() * itemsize for i in idxs]
            for bucket in plan_buckets_py(sizes, threshold):
                self.buckets.append([idxs[j] for j in bucket])
        self._names = names
        with torch.no_grad():
            self.shards = {}
            for name, p in zip(names, params):
                if p.numel():
                    w = _flat_pad(p, n).numel() // n
                    piece = _flat_pad(p.detach(), n)[rank * w:(rank + 1) * w]
                    self.shards[name] = torch.nn.Parameter(piece.clone())
        optimizer = self.make_optimizer(list(self.shards.values()))
        if not isinstance(optimizer, torch.optim.Optimizer):
            raise TypeError("make_zero_train_step: `optimizer` must build a "
                            "torch.optim.Optimizer from the shard tensors")
        ef = (self.error_feedback if self.error_feedback is not None
              else basics.config().error_feedback)
        if ef:
            self.state = ZeroStateWithResidual(
                inner=optimizer,
                residual={name: torch.zeros_like(p)
                          for name, p in zip(names, params)})
        else:
            self.state = optimizer
        if self._pending is not None:
            pending, self._pending = self._pending, None
            self.load_state_dict(pending)

    def __call__(self, model: torch.nn.Module, batch):
        names, params = tree_flatten({name: p for name, p
                                      in model.named_parameters()
                                      if p.requires_grad})
        group = _mesh_group(self.mesh, self.axis_name, None,
                            "make_zero_train_step")
        if self.state is None:
            self._build(names, params, group)
        elif names != self._names:
            raise ValueError("make_zero_train_step: the model's parameters "
                             "are not those the step was built for")
        n = dist.get_world_size(group)
        for p in params:
            p.grad = None
        loss, aux = _loss_and_aux(self.loss_fn, model, batch, self.has_aux)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]

        comp = _resolve_compression(self.compression)
        if (isinstance(self.state, ZeroStateWithResidual)
                and comp is not Compression.none):
            residual = self.state.residual
            for name, g in zip(names, grads):
                g.add_(residual[name])
                residual[name] = comp.local_error(
                    g, block_size=wire_block_size(g.numel(), n))

        for bucket in self.buckets:
            flat = torch.cat([_flat_pad(grads[i], n).reshape(n, -1)
                              for i in bucket], dim=1).reshape(-1)
            red = comp.spmd_reducescatter(flat, op=self.op, group=group)
            widths = [self.shards[names[i]].numel() for i in bucket]
            for i, piece in zip(bucket, torch.split(red, widths)):
                self.shards[names[i]].grad = piece.to(grads[i].dtype)
        self.optimizer.step()
        # Nothing reads the shard gradients after the update; held until
        # the next backward they would sit on top of its peak.
        self.optimizer.zero_grad(set_to_none=True)

        with torch.no_grad():
            for bucket in self.buckets:
                local = torch.cat([self.shards[names[i]] for i in bucket])
                full = local.new_empty(n * local.numel())
                dist.all_gather_into_tensor(full, local, group=group)
                full = full.reshape(n, -1)
                off = 0
                for i in bucket:
                    p, w = params[i], self.shards[names[i]].numel()
                    p.copy_(full[:, off:off + w].reshape(-1)[:p.numel()]
                            .reshape(p.shape))
                    off += w
        loss = C.reduce_raw(loss.detach(), C.Average, group=group)
        return (loss, aux) if self.has_aux else loss


def make_zero_train_step(loss_fn: Callable, optimizer: Callable, *,
                         mesh=None, axis_name: Optional[str] = None,
                         op: str = C.Average, compression=None,
                         has_aux: bool = False,
                         error_feedback: Optional[bool] = None,
                         ) -> ZeroTrainStep:
    """Build the ZeRO-1 training step (reference:
    ``make_zero_train_step``).

    ``loss_fn(model, batch) -> loss``.  ``optimizer`` is a factory,
    ``optimizer(shards) -> torch.optim.Optimizer``, called once with this
    rank's flat shard tensors, so only ``1/n`` of the optimizer state
    lives on each rank.  The returned ``step(model, batch)`` computes
    this rank's gradients, reduce-scatters them with ``op`` (Average or
    Sum) on the ``compression`` wire (None defers to
    ``HVD_TPU_COMPRESSION``; int8 runs the quantized reduce-scatter),
    steps the optimizer on the shards, all-gathers the parameters
    exactly, updates ``model`` in place and returns the loss averaged
    over ranks.  ``error_feedback`` (None defers to
    ``HVD_TPU_ERROR_FEEDBACK``) carries each leaf's quantization error
    of the lossy wire into the next step; it is a no-op on the exact
    wire.  A bucket holds at most ``HOROVOD_FUSION_THRESHOLD`` bytes.

    ``has_aux``: ``loss_fn`` returns ``(loss, aux)`` and the step returns
    ``(loss, aux)``, aux this rank's, detached (the port's contract; the
    reference stacks it over the slots).  ``mesh`` (a
    :class:`..mesh.Mesh`) and ``axis_name`` shard over this rank's group
    along ``axis_name`` (default: the mesh's first axis) instead of the
    session plan's reduce group."""
    if op not in (C.Average, C.Sum):
        raise ValueError(f"ZeRO gradient reduction supports Average/Sum, "
                         f"got {op!r}")
    return ZeroTrainStep(loss_fn, optimizer, op=op, compression=compression,
                         error_feedback=error_feedback, has_aux=has_aux,
                         mesh=mesh, axis_name=axis_name)
