"""Mixture-of-Experts FFN with expert parallelism (the ``expert``/``ep``
axis).

Counterpart of ``horovod_tpu/parallel/moe.py`` (GShard routing): a
top-k router in float32, a fixed capacity an expert, route weights
normalised before the drops, and the experts' weights cut over ``ep``
(the expert dim) and ``tp`` (the FFN dim) by
:func:`.sharding.shard_params`.

The reference traces the layer with the global batch, so its routing is
global: ``S`` counts every token of every batch shard, the capacity is
``ceil(K·S/E·cf)``, a token's slot is a cumsum over the global token
order, and the load-balancing loss averages over the global tokens.
Here a rank holds its batch shard's tokens, so each round of the top-k
assignment all-gathers the ``[E]`` per-expert counts over the batch
group (a rank's positions start after the lower ranks' tokens) and sums
the kept counts; the loss's two means are sums over the batch group.
The keep/drop decisions are the reference's.

Dispatch is by index (a gather and ``index_add``) where the reference
multiplies one-hot ``[S, E, cap]`` tensors: an expert's slot holds
exactly one token's row, so the result is the same, without the
``S·E·cap`` memory.

The expert sum is explicit: the rank's tokens enter the experts through
``comm.copy_to`` over its ``ep × tp`` group and the combined output
leaves through ``comm.reduce_from`` (in f32), as do the route weights,
so the router's gradient gathers every expert's share.  The router
itself runs outside that region, on every rank alike.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .comm import copy_to, reduce_from
from .sharding import split_group


def _expert_axes(plan):
    """(expert, tensor) axis names in ``plan``'s vocabulary (the
    reference reads the session plan's; here the model's plan, the
    session's when the model was built on it): the planner's
    ``expert``/``tensor`` when declared, else the short ``ep``/``tp``."""
    if plan is None:
        return "ep", "tp"
    return ("expert" if plan.has_axis("expert") else "ep",
            "tensor" if plan.has_axis("tensor") else "tp")


def _gather_counts(counts: torch.Tensor, group) -> torch.Tensor:
    """``[n, E]``: every batch-group member's ``counts``, in group
    order (f32 on the wire; counts are exact integers far below 2^24)."""
    if group.size == 1:
        return counts[None]
    out = counts.new_empty(group.size * counts.numel())
    dist.all_gather_into_tensor(out, counts.contiguous(), group=group.group)
    return out.view(group.size, -1)


def _group_sum(x: torch.Tensor, group) -> torch.Tensor:
    if group.size == 1:
        return x
    y = x.clone()
    dist.all_reduce(y, group=group.group)
    return y


class MoEMlp(nn.Module):
    """Drop-in for the transformer's dense FFN: ``[b, T, C] -> [b, T,
    C]`` over this rank's tokens (module docstring).

    Parameters, in the reference's layout: ``router.kernel [C, E]``
    (f32), ``w_up [E, C, d_ff]`` and ``w_down [E, d_ff, C]``, cut by
    ``shard_params`` to this rank's experts and FFN columns.  Each
    forward leaves its load-balancing term in :attr:`aux_loss` (flax's
    ``sow``), which :func:`moe_aux_loss` sums."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int, *,
                 init, top_k: int = 2, capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.bfloat16, plan=None) -> None:
        super().__init__()
        from ..models.layers import Dense

        self.d_ff = d_ff
        self.n_experts = n_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.plan = plan
        self.router = Dense(d_model, n_experts, torch.float32, init)
        self.w_up = init.lecun_normal(n_experts, d_model, d_ff)
        self.w_down = init.lecun_normal(n_experts, d_ff, d_model)
        self.aux_loss: Optional[torch.Tensor] = None

    def _batch_group(self):
        from ..plan import AxisGroup

        plan = self.plan
        if plan is None:
            return AxisGroup((0,), 0, None)
        if plan.has_axis("sp") and plan.axis_size("sp") > 1:
            raise ValueError("MoEMlp routes over the global token order; a "
                             "sequence-sharded (sp) mesh is not supported")
        return plan.group(plan.batch_axes())

    def forward(self, x):
        b, t, c = x.shape
        E = self.n_experts
        K = min(self.top_k, E)
        S = b * t
        batch = self._batch_group()
        S_global = S * batch.size
        cap = max(1, math.ceil(K * S_global / E * self.capacity_factor))
        xf = x.reshape(S, c)

        # --- router (float32) ---
        gates = torch.softmax(self.router(xf.to(torch.float32)), dim=-1)

        # --- top-k assignment with capacity (GShard), global order ---
        fill = gates.new_zeros(E)
        remaining = gates
        routes, top1 = [], None
        for _ in range(K):
            idx = torch.argmax(remaining, dim=-1)
            mask = F.one_hot(idx, E).to(torch.float32)
            if top1 is None:
                top1 = mask
            gate_k = (gates * mask).sum(dim=-1)
            every = _gather_counts(mask.sum(dim=0).detach(), batch)
            offset = every[:batch.index].sum(dim=0)
            pos = torch.cumsum(mask, dim=0) - 1.0 + offset + fill
            pos = (pos * mask).sum(dim=-1).detach()
            keep = (pos < cap) & (gate_k > 0)
            fill = fill + _group_sum(
                (mask * keep[:, None]).sum(dim=0).detach(), batch)
            remaining = remaining * (1.0 - mask)
            routes.append((idx, pos.to(torch.int64), keep, gate_k))

        # Route weights: the top-k gates normalised BEFORE the drops, so
        # a dropped route's share is lost, not handed to the others.
        denom = torch.clamp_min(sum(r[3] for r in routes), 1e-9)
        weights = torch.stack([r[3] / denom for r in routes])     # [K, S]

        # --- load-balancing loss over the global tokens ---
        me = reduce_from(gates.sum(dim=0), batch) / S_global
        ce = _group_sum(top1.sum(dim=0), batch) / S_global
        self.aux_loss = (me * ce).sum() * E * E

        return self._experts(xf, routes, weights, cap).reshape(b, t, c)

    def _experts(self, xf, routes, weights, cap):
        """The kept routes through this rank's experts, combined and
        summed over the ``ep × tp`` group."""
        S, c = xf.shape
        ep_ax, tp_ax = _expert_axes(self.plan)
        e_local, f_local = self.w_up.shape[0], self.w_up.shape[2]
        ep = split_group(self.plan, ep_ax, e_local, self.n_experts,
                         "the experts")
        tp = split_group(self.plan, tp_ax, f_local, self.d_ff,
                         "the expert FFN")
        axes = tuple(g for g, grp in ((ep_ax, ep), (tp_ax, tp)) if grp)
        group = self.plan.group(axes) if axes else None
        first = ep.index * e_local if ep is not None else 0
        if group is not None:
            xf = copy_to(xf, group)
            weights = copy_to(weights, group)

        slots, tokens, route_w = [], [], []
        for (idx, pos, keep, _), w in zip(routes, weights):
            mine = keep & (idx >= first) & (idx < first + e_local)
            s = torch.nonzero(mine).reshape(-1)
            slots.append((idx[s] - first) * cap + pos[s])
            tokens.append(s)
            route_w.append(w[s])
        slots, tokens, route_w = (torch.cat(v) for v in
                                  (slots, tokens, route_w))

        dt = self.dtype
        expert_in = xf.new_zeros((e_local * cap, c), dtype=dt).index_add(
            0, slots, xf.to(dt)[tokens])
        h = torch.bmm(expert_in.reshape(e_local, cap, c), self.w_up.to(dt))
        h = F.gelu(h, approximate="tanh")
        out_e = torch.bmm(h, self.w_down.to(dt)).reshape(e_local * cap, c)
        contrib = (route_w.to(dt).to(torch.float32)[:, None]
                   * out_e[slots].to(torch.float32))
        out = xf.new_zeros((S, c), dtype=torch.float32).index_add(
            0, tokens, contrib)
        if group is not None:
            out = reduce_from(out, group)
        return out.to(dt)


def moe_aux_loss(model: nn.Module, weight: float = 1e-2) -> torch.Tensor:
    """``weight`` × the mean of the load-balancing terms the model's MoE
    layers left at their last forward (the reference sums its sown
    ``moe_aux_loss`` leaves over their count); 0 without any."""
    terms = [m.aux_loss for m in model.modules()
             if isinstance(m, MoEMlp) and m.aux_loss is not None]
    if not terms:
        return torch.zeros((), dtype=torch.float32)
    total = sum(term.to(torch.float32) for term in terms)
    return weight * total / len(terms)
