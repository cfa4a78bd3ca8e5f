"""The MeshPlan core: declared axes, and the wiring derived from them.

Counterpart of ``horovod_tpu/plan/mesh_plan.py``.  A plan is a frozen
value: the named axes with their sizes over a C-order grid of ranks
(:class:`~horovod_tpu_torch.mesh.Mesh`, ``np.arange(world).reshape(
sizes)``, the reference's ``axis_groups`` order).  Everything else is
derived from it: the gradient-reduction axes, the batch and parameter
specs, the rank groups along each axis, the topology tiers and the
modeled wire.  ``MeshPlan.default()`` wraps the 1-D world of
``hvd.global_mesh()``.

Where the reference hands ``axis_index_groups`` to a collective inside
one program, a rank here talks to the other ranks of its group through a
``torch.distributed`` group.  Creating those is collective, so
:meth:`MeshPlan.group` creates every group along the asked axes on every
rank, in one fixed order, the first time any rank asks, and keeps them
for the session (as ``topo/topology.py::tier_groups`` does).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..config import MESH_AXES, parse_mesh_plan
from ..mesh import Mesh

# Axes whose width carries the gradient reduction of make_train_step: the
# batch shards over these, and the optimizer's allreduce rides their
# combined width.  ``sp`` shards the sequence, which splits the batch
# tokens too, but its collectives are the attention's; it is not a
# reduce axis of the gradient wire (make_spmd_train_step sums over it).
REDUCE_AXES = ("data", "fsdp", "hvd", "dp")
# Axes that shard the model, never the batch.
MODEL_AXES = ("tensor", "tp", "pipe", "pp", "expert", "ep")


class PartitionSpec(tuple):
    """One entry a dimension: an axis name, a tuple of names, or None
    (replicated); the port's ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class AxisGroup(NamedTuple):
    """This rank's group along some axes of a plan: the member ranks in
    axis order (ascending, as ``torch.distributed`` numbers them), this
    rank's position among them, and the torch group (``None`` when the
    group is the whole world, whose group is the default one)."""

    ranks: Tuple[int, ...]
    index: int
    group: object

    @property
    def size(self) -> int:
        return len(self.ranks)


def build_device_mesh(axis_sizes: Dict[str, int], *,
                      world: Optional[int] = None) -> Mesh:
    """The one place a named mesh is built.  Axis order fixes locality:
    later axes are nearer neighbours, so put the most bandwidth-hungry
    axis (usually ``tensor``/``tp``) last.  ``world`` (default: the
    session's size) must hold the mesh."""
    names = tuple(axis_sizes)
    shape = tuple(int(axis_sizes[n]) for n in names)
    n_needed = 1
    for s in shape:
        n_needed *= s
    if world is None:
        from .. import basics

        world = basics.size()
    if n_needed > world:
        raise ValueError(
            f"Mesh {axis_sizes} needs {n_needed} devices; only "
            f"{world} available")
    return Mesh(names, shape)


def fsdp_param_spec(leaf, n: int, axis: str) -> P:
    """The spec sharding ``leaf``'s largest ``n``-divisible dim over
    ``axis``; replicated when nothing divides."""
    shape = tuple(getattr(leaf, "shape", ()))
    candidates = [(s, i) for i, s in enumerate(shape)
                  if s % n == 0 and s >= n]
    if not candidates:
        return P()
    _, dim = max(candidates)
    spec = [None] * len(shape)
    spec[dim] = axis
    return P(*spec)


def tp_param_spec(path: str, leaf, tp: int, axis: str = "tensor") -> P:
    """Placement of one parameter of a tensor-parallel serving shard:
    only the column-parallel ``qkv`` and ``up`` projections shard (their
    output dim over ``axis``), everything else is replicated.  ``path``
    is a slashed flax path or a dotted parameter name."""
    shape = tuple(getattr(leaf, "shape", ()))
    if tp <= 1:
        return P()
    # The reference's slashed paths and the port's dotted names alike.
    segs = re.split(r"[./]", path)
    if "qkv" in segs or "up" in segs:
        if len(shape) == 2 and shape[1] % tp == 0:
            return P(None, axis)
        if len(shape) == 1 and shape[0] % tp == 0:
            return P(axis)
    return P()


def tp_owned_slice(path: str, shape: Sequence[int], tp: int,
                   rank: int) -> Optional[Tuple[int, int, int]]:
    """Wire ownership of one parameter under tensor parallelism: ``(dim,
    start, stop)`` of the contiguous slice shard ``rank`` owns (largest
    ``tp``-divisible dim), or None when nothing divides."""
    del path  # ownership is shape-determined; path kept for call symmetry
    if tp <= 1:
        return None
    candidates = [(s, i) for i, s in enumerate(shape)
                  if s % tp == 0 and s >= tp]
    if not candidates:
        return None
    size, dim = max(candidates)
    span = size // tp
    return (dim, rank * span, (rank + 1) * span)


def tp_plan(tp: int, *, devices=None):
    """Without ``devices``: a 1-D ``tensor`` plan over the first ``tp``
    ranks (training's rank plan).

    With ``devices``: the device list of one tensor-parallel serving
    replica: ``tp`` torch devices in shard order, the port's
    counterpart of the reference's ``tensor`` mesh over local devices.
    One process drives every shard of a replica, so the list is a
    replica's, never the world's.  ``devices="cuda"`` asks for the first
    ``tp`` CUDA devices and raises when there are fewer: the shards are
    never stacked on one card or moved to the CPU unasked.  An explicit
    list is used as given; repeats are allowed (two shards on one
    card)."""
    tp = int(tp)
    if devices is None:
        return MeshPlan.from_axes({"tensor": tp}, world=tp)
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if isinstance(devices, str) and devices == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < tp:
            raise RuntimeError(
                f"tp={tp} needs {tp} CUDA devices, {have} visible; pass "
                f"the shard devices explicitly (devices=) to place "
                f"several shards on one card or on the CPU")
        return tuple(torch.device("cuda", i) for i in range(tp))
    out = tuple(torch.device(d) for d in devices)
    if len(out) != tp:
        raise ValueError(f"tp={tp} needs {tp} shard devices, got "
                         f"{len(out)}: {[str(d) for d in out]}")
    return out


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Declared axes over a grid of ranks: the single source of the
    derived wiring (see the module docstring)."""

    mesh: Mesh
    axes: Tuple[Tuple[str, int], ...]

    # --- constructors -------------------------------------------------------

    @staticmethod
    def default() -> "MeshPlan":
        """The 1-D plan over the session's world: its one axis is
        ``hvd``, on the global mesh itself."""
        from .. import basics

        gm = basics.global_mesh()
        return MeshPlan(mesh=gm.mesh, axes=((gm.axis_name, gm.size),))

    @staticmethod
    def from_spec(spec: str, *, world: Optional[int] = None) -> "MeshPlan":
        """From an ``HVD_TPU_MESH_PLAN`` spec (``data=4,fsdp=2``), whose
        sizes must factor ``world`` (default: the session's size)."""
        if world is None:
            from .. import basics

            world = basics.size()
        sizes = parse_mesh_plan(spec, world_size=world)
        return MeshPlan.from_axes(sizes, world=world)

    @staticmethod
    def from_axes(axis_sizes: Dict[str, int], *,
                  world: Optional[int] = None) -> "MeshPlan":
        for name in axis_sizes:
            if name not in MESH_AXES:
                raise ValueError(
                    f"mesh plan: unknown axis {name!r}; expected one of "
                    f"{MESH_AXES}")
        mesh = build_device_mesh(axis_sizes, world=world)
        return MeshPlan(mesh=mesh, axes=tuple(mesh.shape.items()))

    @staticmethod
    def from_mesh(mesh: Mesh) -> "MeshPlan":
        """Wrap a mesh built by hand (``parallel.make_mesh``)."""
        return MeshPlan(mesh=mesh, axes=tuple(mesh.shape.items()))

    # --- declaration accessors ---------------------------------------------

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.axes)

    @property
    def world_size(self) -> int:
        return self.mesh.size

    def axis_size(self, name: str) -> int:
        for n, s in self.axes:
            if n == name:
                return s
        raise KeyError(
            f"mesh plan has no axis {name!r} (axes: {self.axis_names})")

    def has_axis(self, name: str) -> bool:
        return any(n == name for n, _ in self.axes)

    # --- derivation: the gradient-reduction wire ----------------------------

    def reduce_axes(self) -> Tuple[str, ...]:
        """Axes (declaration order) whose combined width carries
        make_train_step's gradient reduction."""
        return tuple(n for n, _ in self.axes if n in REDUCE_AXES)

    def reduce_axis(self):
        """The reduce axis: the bare name for a 1-D reduce plan, a tuple
        of names for several."""
        axes = self.reduce_axes()
        if not axes:
            raise ValueError(
                f"mesh plan {self.describe()} has no data/fsdp axis to "
                f"reduce gradients over; declare at least one of "
                f"{REDUCE_AXES}")
        return axes[0] if len(axes) == 1 else axes

    def reduce_width(self) -> int:
        n = 1
        for name in self.reduce_axes():
            n *= self.axis_size(name)
        return n

    def batch_axes(self) -> Tuple[str, ...]:
        """Axes that can shard the batch (every axis but the model's):
        ``dp`` and ``sp`` of a ``dp × sp × tp`` mesh.  The loss is a sum
        over their group, and so are the gradients of
        make_spmd_train_step."""
        return tuple(n for n, _ in self.axes if n not in MODEL_AXES)

    # --- derivation: specs --------------------------------------------------

    def batch_spec(self) -> P:
        """Leading-axis batch placement: over every reduce axis (one
        entry holding the tuple of them)."""
        axes = self.reduce_axes()
        if not axes:
            return P()
        return P(axes[0] if len(axes) == 1 else axes)

    def shard_axis(self) -> Optional[str]:
        """The parameter-sharding axis of the fully sharded tier:
        ``fsdp`` when declared, else the sole reduce axis of a 1-D
        plan."""
        if self.has_axis("fsdp"):
            return "fsdp"
        axes = self.reduce_axes()
        return axes[0] if len(axes) == 1 else None

    def param_spec(self, leaf) -> P:
        """The fully sharded tier's placement: largest divisible dim
        over the shard axis, replicated across the others."""
        axis = self.shard_axis()
        if axis is None:
            return P()
        return fsdp_param_spec(leaf, self.axis_size(axis), axis)

    # --- derivation: rank groups --------------------------------------------

    def axis_groups(self, name: str) -> List[List[int]]:
        """Rank groups along one axis: each varies ``name`` with the
        other axes pinned; flat C-order ranks of the grid."""
        return self.mesh.groups((name,))

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """``rank``'s (default: this rank's) index along every axis."""
        if rank is None:
            from .. import basics

            rank = basics.rank()
        return self.mesh.coords(rank)

    def group(self, axes) -> AxisGroup:
        """This rank's :class:`AxisGroup` along ``axes`` (a name or a
        sequence of names; their product width).

        Collective on first use: every rank creates every group along
        ``axes``, in the order of :meth:`Mesh.groups`, so every rank
        must reach the first call for the same axes at the same point of
        the program.  The groups are kept for the session
        (``basics.shutdown`` destroys them)."""
        from .. import basics

        names = (axes,) if isinstance(axes, str) else tuple(axes)
        session = basics._require()
        if self.world_size != session.size:
            raise ValueError(
                f"mesh plan {self.describe()} has {self.world_size} ranks "
                f"but the world has {session.size}")
        members = self.mesh.groups(names)
        key = (self.mesh.axis_names, self.mesh.sizes,
               tuple(n for n in self.axis_names if n in names))
        cache = session.mesh_groups
        if key not in cache:
            width = len(members[0])
            cache[key] = ([None] if width == session.size
                          else [dist.new_group(m) for m in members])
        me = session.rank
        for ranks, torch_group in zip(members, cache[key]):
            if me in ranks:
                return AxisGroup(tuple(ranks), ranks.index(me), torch_group)
        raise AssertionError(f"rank {me} is in no group along {names}")

    def collective_groups(self, process_set=None):
        """The torch group a collective over this plan's reduce wire
        uses: the process set's when one is given, else this rank's
        group along the reduce axes (None when that spans the world, as
        it does for every plan without model axes)."""
        if process_set is not None:
            return process_set.group
        self.reduce_axis()          # raises for a plan with no reduce axis
        return self.group(self.reduce_axes()).group

    def register_process_sets(self, table=None) -> Dict[str, list]:
        """Register one process set per axis group (axes of width 1 or of
        the whole world are skipped: the global set exists).  Idempotent:
        a registered identical set is reused.  Collective, as
        ``add_process_set``."""
        from .. import process_sets as _ps

        if table is None:
            table = _ps._table()
        out: Dict[str, list] = {}
        world = self.world_size
        for name, size in self.axes:
            if size <= 1 or size >= world:
                continue
            sets = []
            for ranks in self.axis_groups(name):
                ps = table.find(ranks)
                if ps is None:
                    ps = table.register(_ps.ProcessSet(ranks))
                sets.append(ps)
            out[name] = sets
        return out

    # --- derivation: topology tiers -----------------------------------------

    def topo_tiers(self):
        """The two-tier topology a 2-D reduce plan declares: the outer
        reduce axis is the pod tier, the inner the chip tier; None for
        any other plan."""
        axes = self.reduce_axes()
        if len(axes) != 2:
            return None
        from ..topo.topology import MeshTopology

        return MeshTopology(pods=self.axis_size(axes[0]),
                            chips_per_pod=self.axis_size(axes[1]))

    # --- derivation: the modeled wire ---------------------------------------

    def modeled_wire_bytes(self, nbytes: int) -> Dict[str, int]:
        """Ring-allreduce wire bytes a participant, a reduce axis, for an
        ``nbytes`` gradient: ``2 (n - 1) / n · nbytes``; 0 on the model
        axes, which carry activations."""
        out: Dict[str, int] = {}
        for name, size in self.axes:
            if name in REDUCE_AXES and size > 1:
                out[name] = int(2 * (size - 1) / size * nbytes)
            else:
                out[name] = 0
        return out

    def describe(self) -> str:
        return ",".join(f"{n}={s}" for n, s in self.axes)


def resolve_plan(mesh: Optional[Mesh] = None,
                 plan: Optional[MeshPlan] = None) -> MeshPlan:
    """The plan an entry point consumes: an explicit ``plan`` wins, an
    explicit ``mesh`` is wrapped, else the session's plan."""
    from .. import basics

    if plan is not None:
        return plan
    if mesh is not None:
        return MeshPlan.from_mesh(mesh)
    return basics.mesh_plan()


def collective_groups(process_set=None):
    """Module-level :meth:`MeshPlan.collective_groups`: the live plan's
    answer when the session has a plan, else the process set's group
    (None for the whole world)."""
    from .. import basics

    plan = basics._require().mesh_plan
    if plan is not None:
        return plan.collective_groups(process_set)
    return None if process_set is None else process_set.group


def compile_plan(spec: Optional[str]) -> MeshPlan:
    """The session plan (``hvd.init``, ``hvd.apply_mesh_plan``): the 1-D
    default for ``spec=None``, else the declared layout.  The build runs
    under the root span ``hvd_tpu_plan_compile`` and publishes the
    ``hvd_tpu_plan_axes`` gauge."""
    from ..obs import instrument

    with instrument.plan_compile_span(spec or "default"):
        plan = MeshPlan.default() if spec is None else MeshPlan.from_spec(spec)
        instrument.set_plan_axes(dict(plan.axes))
    return plan


def layout_lattice(world_size: int) -> List[str]:
    """The layouts the autotuner searches: ``data=N`` first, then ever
    more of the world on ``fsdp``; each factors ``world_size``."""
    layouts = [f"data={world_size}"]
    inner = 2
    while inner <= world_size // 2:
        if world_size % inner == 0:
            layouts.append(f"data={world_size // inner},fsdp={inner}")
        inner *= 2
    return layouts
