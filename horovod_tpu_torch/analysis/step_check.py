"""The step's collective-sequence check (``step-rank-divergence``).

Counterpart of ``horovod_tpu/analysis/jaxpr_check.py``.  The reference
traces its steps to a jaxpr and reads the collective primitives out of
it; an eager torch step has no program to read, so this module records
what a step really issues: it wraps ``torch.distributed``'s collective
entry points for the span of one step and keeps, in call order, each
call's op, dtype, element count (over every tensor the call takes) and
group width.  Every module of the port calls them as ``dist.<op>(...)``,
so one wrapper sees the eager API, the fused and overlap wires, the
topology schedules and the plan's groups alike.  It then asserts

* the sequence is **identical on every rank** — a rank-dependent branch
  anywhere under the step shows up as a diverging sequence, the
  deadlock in embryo;
* the overlap wire **matches the planner**: microbatches × buckets
  reduce-scatters and one all-gather per bucket of
  ``ops/fusion.py``'s :func:`plan_overlap_buckets` (the int8 wire moves
  payload and scales as two calls a phase, ``ops/quantization.py``);
* the planner itself (:func:`plan_bucket_schedule`) and the topology
  compiler (:func:`compile_bucket_schedule`) give every rank the same
  schedule.

The ranks are real or simulated.  Inside a live world of two or more
ranks (``torch.distributed`` initialised), every rank records its own
step and the sequences are exchanged with ``all_gather_object`` after
the recording.  Otherwise one process stands for each rank of a world
in turn, through torch's in-process fake process group
(``torch.testing._internal.distributed.fake_pg``): its collectives
return at once and move no data, which is all a sequence needs.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, Sequence, Tuple

from .core import Finding

# torch.distributed's entry points the recorder wraps (the names the
# rank-divergence checker holds, where torch has them).
RECORDED_OPS = (
    "all_reduce", "reduce_scatter_tensor", "reduce_scatter_single",
    "reduce_scatter", "all_gather_into_tensor", "all_gather_single",
    "all_gather", "all_to_all_single", "all_to_all", "broadcast",
    "broadcast_object_list", "all_gather_object", "gather", "scatter",
    "reduce", "barrier", "monitored_barrier", "new_group",
)

# The overlap wire's calls a bucket phase, by compression: (op family,
# calls).  A family matches every recorded op whose name contains it.
_WIRE = {
    "int8": {"rs": ("all_to_all", 2), "ag": ("all_gather", 2)},
}
_WIRE_DEFAULT = {"rs": ("reduce_scatter", 1), "ag": ("all_gather", 1)}

_FACTORY_PATH = "horovod_tpu_torch/optim/distributed_optimizer.py"
_SPMD_PATH = "horovod_tpu_torch/parallel/train.py"
_FUSION_PATH = "horovod_tpu_torch/ops/fusion.py"
_TOPO_PATH = "horovod_tpu_torch/topo/schedule.py"
_PLAN_PATH = "horovod_tpu_torch/plan/mesh_plan.py"

# One recorded call: (op, dtype, element count, group width).
Entry = Tuple[str, str, int, int]


def _entry(op: str, args: tuple, kwargs: dict) -> Entry:
    import torch
    import torch.distributed as dist

    tensors: List[torch.Tensor] = []

    def scan(x: Any) -> None:
        if isinstance(x, torch.Tensor):
            tensors.append(x)
        elif isinstance(x, (list, tuple)):
            for y in x:
                scan(y)

    for a in list(args) + [v for k, v in kwargs.items() if k != "group"]:
        scan(a)
    group = kwargs.get("group")
    if group is None:
        group = next((a for a in args if isinstance(a, dist.ProcessGroup)),
                     None)
    width = dist.get_world_size(group) if op != "new_group" \
        else dist.get_world_size()
    if op == "new_group":
        ranks = kwargs.get("ranks", args[0] if args else None)
        return (op, "", len(ranks) if ranks is not None else width, width)
    dtype = str(tensors[0].dtype).replace("torch.", "") if tensors else ""
    return (op, dtype, int(sum(t.numel() for t in tensors)), int(width))


@contextlib.contextmanager
def record_collectives():
    """Wrap ``torch.distributed``'s collective entry points for the
    block; yields the list the calls are appended to, as
    ``(op, dtype, element count, group width)``.  The wrappers are
    removed on exit, however the block ends."""
    import torch.distributed as dist

    seq: List[Entry] = []
    saved: Dict[str, Callable] = {}
    for name in RECORDED_OPS:
        fn = getattr(dist, name, None)
        if fn is None:
            continue
        saved[name] = fn

        def spy(*args, _fn=fn, _name=name, **kwargs):
            seq.append(_entry(_name, args, kwargs))
            return _fn(*args, **kwargs)

        setattr(dist, name, spy)
    try:
        yield seq
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def wire_counts(seq: Sequence[Entry], compression: str = "none"
                ) -> Tuple[int, int]:
    """(reduce-scatter phases, all-gather phases) of the overlap wire in
    ``seq``: the calls of each phase's op family over the calls a phase
    takes on ``compression``'s wire."""
    wire = _WIRE.get(compression, _WIRE_DEFAULT)
    out = []
    for phase in ("rs", "ag"):
        family, per = wire[phase]
        n = sum(1 for e in seq if family in e[0])
        out.append(n // per if n % per == 0 else -1)
    return out[0], out[1]


def compare_sequences(seqs: Sequence[Sequence[Entry]], *, path: str,
                      what: str) -> List[Finding]:
    """One ``step-rank-divergence`` finding for each rank whose sequence
    differs from rank 0's."""
    base = [tuple(e) for e in seqs[0]]
    findings = []
    for r, seq in enumerate(seqs[1:], start=1):
        seq = [tuple(e) for e in seq]
        if seq == base:
            continue
        i = next((k for k, (a, b) in enumerate(zip(base, seq)) if a != b),
                 min(len(base), len(seq)))
        at0 = base[i] if i < len(base) else "nothing"
        atr = seq[i] if i < len(seq) else "nothing"
        ops0 = dict(collections.Counter(e[0] for e in base))
        opsr = dict(collections.Counter(e[0] for e in seq))
        findings.append(Finding(
            "step-rank-divergence", path, 1,
            f"{what}: recorded collective sequence diverges across ranks "
            f"at call {i} — rank 0 issues {at0}, rank {r} issues {atr} "
            f"(rank 0: {len(base)} calls {ops0}; rank {r}: {len(seq)} "
            f"calls {opsr}); ranks would deadlock at the first mismatched "
            f"rendezvous"))
    return findings


def planner_findings(seq: Sequence[Entry], *, microbatches: int,
                     n_buckets: int, compression: str = "none",
                     what: str = "overlap wire") -> List[Finding]:
    """The overlap wire against the planner: ``microbatches ×
    n_buckets`` reduce-scatters and ``n_buckets`` all-gathers."""
    n_rs, n_ag = wire_counts(seq, compression)
    if n_rs == microbatches * n_buckets and n_ag == n_buckets:
        return []
    return [Finding(
        "step-rank-divergence", _FUSION_PATH, 1,
        f"{what} disagrees with the planner: plan has {n_buckets} "
        f"bucket(s) × {microbatches} microbatches => expected "
        f"{microbatches * n_buckets} reduce-scatter + {n_buckets} "
        f"all-gather, recorded {n_rs} + {n_ag} "
        f"({[e[0] for e in seq]})")]


# --- the ranks ------------------------------------------------------------------

@contextlib.contextmanager
def simulated_rank(rank: int, world: int):
    """This process as rank ``rank`` of a ``world`` over torch's fake
    process group, with a session of its own on the CPU (no
    cross-process monitor: there is no peer to reach).  Refuses to run
    inside a live world or session."""
    import torch.distributed as dist

    from .. import basics
    from ..config import Config

    if dist.is_initialized() or basics.is_initialized():
        raise RuntimeError(
            "simulated_rank needs a process with no process group and no "
            "session; inside a live world the ranks are real")
    # Registers the "fake" backend with torch.distributed.
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        basics.init(dataclasses.replace(Config.from_env(),
                                        native_coordinator=False),
                    device="cpu")
        try:
            yield
        finally:
            basics.shutdown()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def per_rank(fn: Callable[[], Any], world: int = 2) -> List[Any]:
    """``fn()`` on every rank, in rank order: each rank of a live world
    runs it and the results are gathered (a collective: every rank calls
    this); with no live world, each of ``world`` simulated ranks runs it
    in turn."""
    import torch.distributed as dist

    if dist.is_initialized():
        mine = fn()
        out: List[Any] = [None] * dist.get_world_size()
        dist.all_gather_object(out, mine)
        return out
    results = []
    for r in range(world):
        with simulated_rank(r, world):
            results.append(fn())
    return results


# --- the shipped factories ------------------------------------------------------

def _toy_problem():
    """The reference's toy: a 64→32 affine map, SGD(0.1), a batch of
    16 ones (jaxpr_check._toy_problem), built from a fixed seed."""
    import torch

    torch.manual_seed(0)
    model = torch.nn.Linear(64, 32)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    batch = (torch.ones(16, 64), torch.ones(16, 32))
    return model, opt, batch


def _mse(model, batch):
    x, y = batch
    return ((model(x) - y) ** 2).mean()


def record_step(build: Callable[[], Tuple[Callable, Any, Any]]
                ) -> List[Entry]:
    """Build ``(step, model, batch)`` and record one ``step(model,
    batch)``; the build's own collectives are not recorded."""
    step, model, batch = build()
    with record_collectives() as seq:
        step(model, batch)
    return list(seq)


def check_step_rank_consistency(build: Callable[[], Tuple[Callable, Any,
                                                          Any]], *,
                                world: int = 2, path: str = _FACTORY_PATH,
                                what: str = "train step") -> List[Finding]:
    """The reusable oracle: ``build()`` on every rank (real or
    simulated) and one recorded step; identical sequences, else one
    finding a diverging rank."""
    seqs = per_rank(lambda: record_step(build), world)
    return compare_sequences(seqs, path=path, what=what)


@contextlib.contextmanager
def _restored_session(**fields):
    """An analysis-only change of the live session: its config with
    ``fields`` swapped in for the block, and the session as it was put
    back on exit, whatever else the block changed in it (a plan)."""
    from .. import basics

    old = basics._session
    basics._session = dataclasses.replace(
        old, config=dataclasses.replace(old.config, **fields))
    try:
        yield
    finally:
        basics._session = old


def _plain_step():
    from .. import make_train_step

    model, opt, batch = _toy_problem()
    return make_train_step(_mse, opt), model, batch


def _record_cases(microbatches: int) -> Dict[str, Any]:
    """This rank's recordings of every shipped factory, and the
    planners' outputs, keyed by case."""
    import torch

    from .. import apply_mesh_plan, basics, make_train_step
    from ..ops import fusion
    from ..parallel import make_mesh, make_spmd_train_step
    from ..plan import MeshPlan

    world = basics.size()
    out: Dict[str, Any] = {}

    out["make_train_step"] = record_step(_plain_step)

    def overlap():
        model, opt, batch = _toy_problem()
        return (make_train_step(_mse, opt, microbatches=microbatches,
                                overlap=True), model, batch)

    what = f"make_train_step(microbatches={microbatches}, overlap)"
    out[what] = record_step(overlap)
    # The step's leaf order: its gradients flattened by name.
    _, leaves = fusion.tree_flatten(dict(_toy_problem()[0]
                                         .named_parameters()))
    out["overlap buckets"] = len(fusion.plan_overlap_buckets(
        leaves, basics.config().fusion_threshold,
        world_size=world).members)

    class _MeshToy(torch.nn.Linear):
        def mesh_plan(self):
            return self.plan

    def spmd():
        model, _, batch = _toy_problem()
        toy = _MeshToy(64, 32)
        toy.load_state_dict(model.state_dict())
        toy.plan = MeshPlan.from_mesh(make_mesh({"dp": world}))
        opt = torch.optim.SGD(toy.parameters(), lr=0.1)
        return make_spmd_train_step(_mse, opt), toy, batch

    out["make_spmd_train_step"] = record_step(spmd)

    sizes = [int(p.numel() * p.element_size()) for p in leaves]
    out["plan_bucket_schedule"] = repr(fusion.plan_bucket_schedule(
        sizes, threshold=4096, world_size=max(2, world)))

    if world > 1 and world % 2 == 0:
        from ..topo.schedule import compile_bucket_schedule
        from ..topo.topology import MeshTopology

        with _restored_session(topo_schedule="hierarchical",
                               topo_spec=f"2x{world // 2}"):
            out["make_train_step(topo_schedule=hierarchical)"] = \
                record_step(_plain_step)
        out["compile_bucket_schedule"] = repr(compile_bucket_schedule(
            1 << 22, MeshTopology(pods=2, chips_per_pod=world // 2)))

        spec = f"data={world // 2},fsdp=2"
        with _restored_session():
            apply_mesh_plan(spec)
            out[f"make_train_step(mesh_plan={spec})"] = \
                record_step(_plain_step)
    return out


_CASE_PATHS = {
    "make_spmd_train_step": _SPMD_PATH,
    "make_train_step(topo_schedule=hierarchical)": _TOPO_PATH,
}


def judge(per_rank_cases: Sequence[Dict[str, Any]], microbatches: int
          ) -> List[Finding]:
    """Findings over every rank's :func:`_record_cases`."""
    findings: List[Finding] = []
    base = per_rank_cases[0]
    for what, value in base.items():
        values = [cases.get(what) for cases in per_rank_cases]
        if what == "overlap buckets":
            continue
        if isinstance(value, str):     # a planner's output
            path = _TOPO_PATH if what.startswith("compile") \
                else _FUSION_PATH
            for r, v in enumerate(values[1:], start=1):
                if v != value:
                    findings.append(Finding(
                        "step-rank-divergence", path, 1,
                        f"{what} is rank-dependent: rank 0 plans {value}, "
                        f"rank {r} plans {v} — the schedule must be "
                        f"identical on every rank"))
            continue
        path = _CASE_PATHS.get(what, _PLAN_PATH if "mesh_plan" in what
                               else _FACTORY_PATH)
        findings += compare_sequences(values, path=path, what=what)
    if len(per_rank_cases) > 1:
        what = f"make_train_step(microbatches={microbatches}, overlap)"
        for cases in per_rank_cases:
            findings += planner_findings(
                cases[what], microbatches=microbatches,
                n_buckets=cases["overlap buckets"])
    return findings


def run_step_checks(microbatches: int = 2, world: int = 2) -> List[Finding]:
    """Every recorded-step check over the shipped factories: on the
    live world's ranks when ``torch.distributed`` is initialised (every
    rank calls this), else on ``world`` simulated ranks in turn.
    Returns findings (empty = pass)."""
    return judge(per_rank(lambda: _record_cases(microbatches), world),
                 microbatches)
