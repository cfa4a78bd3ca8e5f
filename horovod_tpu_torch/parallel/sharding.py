"""Multi-axis meshes and the parameter rule table.

Counterpart of ``horovod_tpu/parallel/sharding.py``.  The mesh's axes:

* ``dp``: data parallel (the batch's rows are split);
* ``tp``: tensor parallel (Megatron: column-parallel ``qkv`` and ``up``,
  row-parallel ``out`` and ``down``);
* ``sp``: sequence parallel (the tokens are split; ring or Ulysses
  attention).

The rule table and the specs it gives are the reference's, entry for
entry.  Where GSPMD turns a spec into a layout and keeps the math
global, a rank here holds only its slice (:func:`shard_params`) and the
model runs the tensor-parallel collectives itself
(:mod:`.comm`: the identity forward and a sum backward at a
column-parallel input, a sum forward at a row-parallel output).
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..mesh import Mesh
from ..plan import MeshPlan, P


def make_mesh(axis_sizes: Dict[str, int], *,
              world: Optional[int] = None) -> Mesh:
    """A named mesh over the ranks, e.g. ``make_mesh({'dp': 2, 'sp': 2,
    'tp': 2})``: :func:`..plan.build_device_mesh`.  Later axes are
    nearer neighbours, so put ``tp`` last."""
    from ..plan import build_device_mesh

    return build_device_mesh(axis_sizes, world=world)


# Megatron-style placement for a decoder-only transformer:
#   - column-parallel (output dim sharded over tp): qkv projection, mlp up
#   - row-parallel    (input dim sharded over tp): attn out, mlp down
#   - everything else replicated over tp (and always over dp/sp)
_TRANSFORMER_RULES: Sequence[Tuple[str, P]] = (
    (r".*attn.*(query|key|value|qkv).*kernel", P(None, "tp")),
    (r".*attn.*(out|proj_out|output).*kernel", P("tp", None)),
    (r".*mlp.*(up|fc1|gate|intermediate).*kernel", P(None, "tp")),
    (r".*mlp.*(down|fc2|output).*kernel", P("tp", None)),
    # MoE experts: expert dim over ep, FFN dims over tp; router replicated.
    (r".*moe.*router.*kernel", P()),
    (r".*moe.*w_up", P("ep", None, "tp")),
    (r".*moe.*w_down", P("ep", "tp", None)),
    (r".*embed.*embedding", P(None, None)),
    (r".*", P()),
)


def transformer_param_rules() -> Sequence[Tuple[str, P]]:
    """The default rule table for :class:`..models.transformer.GPT`."""
    return _TRANSFORMER_RULES


def drop_missing_axes(spec: P, mesh: Mesh) -> P:
    """Replace axis names absent from ``mesh`` with None, so one rule
    table serves meshes of any axis subset."""
    axes = set(mesh.axis_names)
    return P(*(
        (a if a in axes else None) if not isinstance(a, tuple)
        else (tuple(x for x in a if x in axes) or None)
        for a in spec))


def spec_for_path(path: str, rules: Sequence[Tuple[str, P]],
                  mesh: Optional[Mesh] = None) -> P:
    """The first matching rule's spec (a path is a parameter's name, in
    the port's dotted form or the reference's slashed one); axes absent
    from ``mesh`` are dropped."""
    for pattern, spec in rules:
        if re.fullmatch(pattern, path, flags=re.IGNORECASE):
            return spec if mesh is None else drop_missing_axes(spec, mesh)
    return P()


def _named(model_or_named) -> Dict[str, torch.Tensor]:
    if isinstance(model_or_named, torch.nn.Module):
        return dict(model_or_named.named_parameters())
    return dict(model_or_named)


def param_shardings(model_or_named, mesh: Mesh,
                    rules: Optional[Sequence[Tuple[str, P]]] = None
                    ) -> Dict[str, P]:
    """``{name: spec}`` for a model's parameters (or a ``{name:
    tensor}`` map): the reference's ``param_shardings``, spec for spec."""
    rules = rules or _TRANSFORMER_RULES
    return {name: spec_for_path(name, rules, mesh)
            for name in _named(model_or_named)}


def split_group(plan, axis: str, local: int, full: int, what: str):
    """The group along ``axis`` when :func:`shard_params` left a layer
    ``local`` of the ``full`` entries of ``what`` (heads, FFN columns,
    experts), else None (nothing is split)."""
    if local == full:
        return None
    if plan is None or not plan.has_axis(axis):
        raise ValueError(f"{what} is split {full} -> {local} but the model "
                         f"has no mesh with a {axis!r} axis")
    group = plan.group(axis)
    if local * group.size != full:
        raise ValueError(f"{what}: {local} of {full} does not match "
                         f"{axis}={group.size}")
    return group


def _is_fused_qkv(name: str) -> bool:
    return bool(re.search(r"(^|[./])qkv[./]kernel$", name))


def _dim_shards(spec: P, mesh: Mesh, coords: Dict[str, int]):
    """``(dim, parts, index, axes)`` for each dim ``spec`` splits."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        parts, index = 1, 0
        for a in axes:
            parts *= mesh.shape[a]
            index = index * mesh.shape[a] + coords[a]
        if parts > 1:
            yield dim, parts, index, axes


def _local_slice(name: str, full: torch.Tensor, spec: P, mesh: Mesh,
                 coords: Dict[str, int]) -> torch.Tensor:
    x = full
    for dim, parts, index, _ in _dim_shards(spec, mesh, coords):
        size = x.shape[dim]
        if _is_fused_qkv(name) and dim == 1:
            # [C, 3C]: this rank's heads of q, of k and of v.
            third = size // 3
            if third % parts:
                raise ValueError(f"{name}: {third} columns a projection "
                                 f"do not split {parts} ways")
            span = third // parts
            x = torch.cat([x.narrow(1, j * third + index * span, span)
                           for j in range(3)], dim=1)
            continue
        if size % parts:
            raise ValueError(f"{name}: dim {dim} of {tuple(full.shape)} "
                             f"does not split {parts} ways")
        span = size // parts
        x = x.narrow(dim, index * span, span)
    return x


def shard_params(model: torch.nn.Module, mesh: Mesh,
                 rules: Optional[Sequence[Tuple[str, P]]] = None
                 ) -> torch.nn.Module:
    """Keep this rank's slice of every parameter the rule table splits,
    in place (each parameter object stays, its data shrinks), and return
    the model.  Every rank must start from the same full weights.

    A spec's split of a dim is contiguous, as under GSPMD, except for
    the fused ``qkv`` kernel ``[C, 3C]``: its ``P(None, 'tp')`` gives
    each ``tp`` rank the same heads of q, of k and of v (columns ``[r·C
    / tp, (r + 1)·C / tp)`` of each third), so attention stays local to
    the rank's heads.  :func:`gather_params` undoes it."""
    from .. import basics

    coords = mesh.coords(basics.rank())
    specs = param_shardings(model, mesh, rules)
    with torch.no_grad():
        for name, p in model.named_parameters():
            local = _local_slice(name, p.data, specs[name], mesh, coords)
            if local.shape != p.shape:
                p.data = local.clone()
    return model


def gather_params(model: torch.nn.Module, mesh: Mesh,
                  rules: Optional[Sequence[Tuple[str, P]]] = None, *,
                  to=None) -> Dict[str, torch.Tensor]:
    """A copy of every parameter whole, in the reference's layout,
    gathered from the ranks' slices (collective over each split's group,
    in parameter order: every rank calls it).  ``to`` (e.g. ``"cpu"``)
    moves each whole parameter there as soon as it is gathered, so that
    the device holds one at a time."""
    plan = MeshPlan.from_mesh(mesh)
    from .. import basics

    coords = mesh.coords(basics.rank())
    specs = param_shardings(model, mesh, rules)
    out = {}
    for name, p in model.named_parameters():
        x = p.detach().clone()
        for dim, parts, _, axes in reversed(list(
                _dim_shards(specs[name], mesh, coords))):
            group = plan.group(axes)
            pieces = [torch.empty_like(x) for _ in range(parts)]
            dist.all_gather(pieces, x.contiguous(), group=group.group)
            if _is_fused_qkv(name) and dim == 1:
                thirds = [piece.chunk(3, dim=1) for piece in pieces]
                x = torch.cat([torch.cat([t[j] for t in thirds], dim=1)
                               for j in range(3)], dim=1)
            else:
                x = torch.cat(pieces, dim=dim)
        out[name] = x if to is None else x.to(to)
    return out
