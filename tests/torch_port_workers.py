"""A gloo world of worker processes for the PyTorch port's tests.

The workers run functions of this module by name, on the CPU, through
``horovod_tpu_torch`` after ``init(device="cpu")``.  This module's top
level imports only the standard library, numpy and torch: the JAX
reference is computed in the parent test process and passed in as numpy
arrays.  One world is spawned per test module (``World``) and reused by
its tests.
"""

from __future__ import annotations

import contextlib
import dataclasses
import multiprocessing as mp
import os
import queue
import sys
import traceback
from datetime import timedelta

import numpy as np
import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _serve(rank: int, world: int, store: str, tasks, results) -> None:
    if REPO_ROOT not in sys.path:
        sys.path.insert(0, REPO_ROOT)
    import torch.distributed as dist
    import horovod_tpu_torch as hvd

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    hvd.init(device="cpu")
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            name, kwargs = task
            try:
                results.put((rank, True, globals()[name](**kwargs)))
            except Exception:  # report, keep serving the next task
                results.put((rank, False, traceback.format_exc()))
    finally:
        hvd.shutdown()
        dist.destroy_process_group()


class World:
    """``n`` gloo ranks rendezvousing through a FileStore at ``store``."""

    def __init__(self, n: int, store: str) -> None:
        ctx = mp.get_context("spawn")
        self.n = n
        self.tasks = [ctx.Queue() for _ in range(n)]
        self.results = ctx.Queue()
        self._backlog = [[] for _ in range(n)]
        self.procs = [ctx.Process(target=_serve,
                                  args=(r, n, store, self.tasks[r],
                                        self.results), daemon=True)
                      for r in range(n)]
        for p in self.procs:
            p.start()

    def run(self, name: str, per_rank=None, timeout: float = 300.0, **kwargs):
        """Run ``name(**kwargs, **per_rank[r])`` on every rank; returns
        the results in rank order, raising with a rank's traceback if it
        failed."""
        self.submit(name, per_rank, **kwargs)
        return self.collect(name, timeout)

    def submit(self, name: str, per_rank=None, **kwargs) -> None:
        """Queue ``name`` on every rank without waiting; :meth:`collect`
        takes its results (tasks run and answer in submission order)."""
        for r in range(self.n):
            extra = per_rank[r] if per_rank is not None else {}
            self.tasks[r].put((name, {**kwargs, **extra}))

    def collect(self, name: str, timeout: float = 300.0):
        """The results of the oldest submitted task, in rank order (a
        rank's answers to later tasks wait in its backlog)."""
        while not all(self._backlog):
            try:
                rank, ok, value = self.results.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(f"{name}: no answer within {timeout} s")
            self._backlog[rank].append((ok, value))
        out = [None] * self.n
        errors = []
        for rank in range(self.n):
            ok, value = self._backlog[rank].pop(0)
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
        if errors:
            raise RuntimeError(f"{name} failed\n" + "\n".join(errors))
        return out

    def close(self) -> None:
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)


# --- functions the workers run ------------------------------------------------

def int8_allreduce(x: np.ndarray, op: str) -> np.ndarray:
    from horovod_tpu_torch.ops.quantization import int8_allreduce as wire

    return wire(torch.from_numpy(x), op=op).numpy()


def collectives(x: np.ndarray, splits) -> dict:
    import horovod_tpu_torch as hvd

    t = torch.from_numpy(x)
    return {
        "rank": hvd.rank(), "size": hvd.size(),
        "sum": hvd.allreduce(t, op=hvd.Sum).numpy(),
        "average": hvd.allreduce(t, op=hvd.Average).numpy(),
        "scaled": hvd.allreduce(t, op=hvd.Sum, prescale_factor=0.5,
                                postscale_factor=3.0).numpy(),
        "bf16": hvd.allreduce(t, compression=hvd.Compression.bf16).numpy(),
        "max": hvd.allreduce(t, op=hvd.Max).numpy(),
        "allgather": hvd.allgather(t).numpy(),
        "alltoall": hvd.alltoall(t, splits=splits)[0].numpy(),
        "broadcast": hvd.broadcast(t, root_rank=1).numpy(),
    }


def broadcast_state(seed: int) -> dict:
    """Each rank starts from different weights and optimizer state; after
    the broadcasts every rank holds rank 0's."""
    import horovod_tpu_torch as hvd

    torch.manual_seed(seed + hvd.rank())
    model = torch.nn.Linear(4, 3)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3 * (1 + hvd.rank()))
    model(torch.randn(2, 4)).sum().backward()
    opt.step()
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    state = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    for i, p in enumerate(model.parameters()):
        for key, val in opt.state[p].items():
            state[f"opt.{i}.{key}"] = val.numpy().copy()
    state["lr"] = opt.param_groups[0]["lr"]
    return state


def _adamw(params):
    return torch.optim.AdamW(params, lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def _my_rows(array: np.ndarray):
    """This rank's rows of a global batch: ``[rank * b, (rank + 1) * b)``."""
    import horovod_tpu_torch as hvd

    b = array.shape[0] // hvd.size()
    return torch.from_numpy(array[hvd.rank() * b:(hvd.rank() + 1) * b])


@contextlib.contextmanager
def _knobs(env: dict):
    """Run with the environment knobs ``env`` set: the port reads them at
    ``init``, so this re-initialises around the block (the gloo group,
    created before ``init``, stays)."""
    import horovod_tpu_torch as hvd

    if not env:
        yield
        return
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
        hvd.shutdown()
        hvd.init(device="cpu")


def train_gpt(config: dict, params: dict, tokens: np.ndarray,
              compression: str, error_feedback: bool, steps: int,
              wrap: bool = True, zero: bool = False,
              env: dict = None, op: str = "average", sets=None,
              backward_passes_per_step: int = 1,
              microbatches: int = None, vocab_chunk_size: int = 0) -> dict:
    """``steps`` data-parallel AdamW steps of the port's GPT from the
    given flax-layout params; this rank trains on its rows of the global
    batch.  ``wrap=False`` hands the step a plain torch optimizer, so the
    step itself allreduces; ``zero=True`` takes ZeRO-1 steps
    (``make_zero_train_step``) and also returns the shapes of this
    rank's optimizer state.  ``env`` sets knobs (``HOROVOD_*``) for these
    steps only.  ``op``, ``sets`` (this rank reduces over its set of
    them) and ``backward_passes_per_step`` go to the DistributedOptimizer
    and the step, ``microbatches`` to the step, ``vocab_chunk_size`` to
    the loss; ``moved`` says after each step whether any parameter
    changed."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import GPT, GPTConfig, load_jax_params

    cfg = GPTConfig(**{**config, "dtype": getattr(torch, config["dtype"])})
    model = GPT(cfg)
    load_jax_params(model, params)
    comp = getattr(hvd.Compression, compression)
    loss_fn = hvd.models.lm_loss_fn(model, vocab_chunk_size=vocab_chunk_size)
    ps = _mine(sets) if sets else None
    if zero:
        step = hvd.make_zero_train_step(
            loss_fn, _adamw, compression=comp, error_feedback=error_feedback)
    elif wrap:
        step = hvd.make_train_step(loss_fn, hvd.DistributedOptimizer(
            _adamw(model.parameters()), compression=comp,
            error_feedback=error_feedback, op=op, process_set=ps,
            backward_passes_per_step=backward_passes_per_step),
            process_set=ps, microbatches=microbatches)
    else:
        step = hvd.make_train_step(loss_fn, _adamw(model.parameters()),
                                   compression=comp,
                                   microbatches=microbatches)
    mine = _my_rows(tokens)
    batch = (mine[:, :-1], mine[:, 1:])
    losses, moved = [], []
    with _knobs(env or {}):
        for _ in range(steps):
            before = [p.detach().clone() for p in model.parameters()]
            losses.append(float(step(model, batch)))
            moved.append(any(not torch.equal(a, p) for a, p in
                             zip(before, model.parameters())))
    out = {"losses": losses, "moved": moved,
           "params": {n: p.detach().numpy().copy()
                      for n, p in model.named_parameters()}}
    if zero:
        out["state_shapes"] = {
            name: {key: tuple(v.shape)
                   for key, v in step.optimizer.state[shard].items()
                   if v.dim()}
            for name, shard in step.shards.items()}
        out["buckets"] = len(step.buckets)
    return out


class _Toy(torch.nn.Module):
    """A module holding the given named leaves as parameters."""

    def __init__(self, leaves: dict) -> None:
        super().__init__()
        for name, value in leaves.items():
            self.register_parameter(name, torch.nn.Parameter(
                torch.from_numpy(value[0]).to(getattr(torch, value[1]))))


def zero_toy(problem: str, leaves: dict, data: dict, lr: float, steps: int,
             compression: str) -> dict:
    """ZeRO SGD steps on the toy problems of ``tests/test_zero.py``:
    ``mixed`` (bf16, f32 and zero-size leaves) and ``tanh`` (a two-layer
    regression).  Each rank takes its rows of ``data``."""
    import horovod_tpu_torch as hvd

    model = _Toy(leaves)
    x, y = (_my_rows(data[k]) for k in ("x", "y"))

    def loss_fn(module, batch):
        bx, by = batch
        if problem == "mixed":
            pred = bx @ (module.w16.float() + module.w32)
            return ((pred - by) ** 2).mean() + module.empty.sum()
        return ((torch.tanh(bx @ module.w) @ module.v - by) ** 2).mean()

    step = hvd.make_zero_train_step(
        loss_fn, lambda ps: torch.optim.SGD(ps, lr=lr),
        compression=getattr(hvd.Compression, compression),
        error_feedback=False)
    losses = [float(step(model, (x, y))) for _ in range(steps)]
    return {"losses": losses,
            "params": {n: (p.detach().float().numpy().copy(), str(p.dtype))
                       for n, p in model.named_parameters()}}


def fused_apply(param: np.ndarray, mu: np.ndarray, nu: np.ndarray,
                shard: np.ndarray, lr: float, step: int,
                block_size: int) -> dict:
    """The fused all-gather + SGD and + Adam applies of this rank's
    gradient shard."""
    from horovod_tpu_torch.ops import fused_collectives as fc

    p, m, v, g = (torch.from_numpy(a) for a in (param, mu, nu, shard))
    adam = fc.fused_allgather_adam_apply(p, m, v, g, lr=lr, step=step,
                                         block_size=block_size)
    sgd = fc.fused_allgather_sgd_apply(p, g, lr=lr, block_size=block_size)
    return {"sgd": sgd.numpy(), "adam": [a.numpy() for a in adam]}


def fused_matmul(x: np.ndarray, w_shard: np.ndarray) -> np.ndarray:
    import horovod_tpu_torch as hvd

    return hvd.optim.unshard_matmul(torch.from_numpy(x),
                                    torch.from_numpy(w_shard)).numpy()


def fused_wire(x: np.ndarray, shard: np.ndarray, op: str) -> dict:
    """The int8 wire under the Pallas tier's names."""
    from horovod_tpu_torch.ops import fused_collectives as fc

    return {"rs": fc.fused_quantize_reducescatter(torch.from_numpy(x),
                                                   op=op).numpy(),
            "ag": fc.fused_quantize_allgather(torch.from_numpy(shard)).numpy(),
            "ar": fc.fused_allreduce(torch.from_numpy(x), op=op).numpy()}


# --- process sets and the eager API -------------------------------------------

_SETS = {}


def _set(ranks):
    """The registered process set of ``ranks`` (the global set for every
    rank).  Registering is collective, so every rank calls this for the
    same ranks in the same order."""
    import horovod_tpu_torch as hvd

    ranks = tuple(sorted(ranks))
    if len(ranks) == hvd.size():
        return hvd.global_process_set()
    ps = _SETS.get(ranks)
    if ps is None or ps.process_set_id is None:
        ps = _SETS[ranks] = hvd.add_process_set(list(ranks))
    return ps


def _mine(sets):
    """Register every set of ``sets`` (in order) and return the one that
    holds this rank, or None."""
    import horovod_tpu_torch as hvd

    registered = [_set(s) for s in sets]
    return next((ps for ps in registered if ps.included()), None)


def eager_int8(x: np.ndarray, leaves: list, op: str, sets,
               dtype: str = "float32") -> dict:
    """The eager int8 allreduce and grouped allreduce over this rank's
    set of ``sets``, the inputs cast to ``dtype`` (the results come back
    as float32 arrays, exactly)."""
    import horovod_tpu_torch as hvd

    ps = _mine(sets)
    int8 = hvd.Compression.int8
    dt = getattr(torch, dtype)

    def f32(t):
        return t.to(torch.float32).numpy()

    return {
        "allreduce": f32(hvd.allreduce(torch.from_numpy(x).to(dt), op=op,
                                       compression=int8, process_set=ps)),
        "grouped": [f32(r) for r in hvd.grouped_allreduce(
            [torch.from_numpy(v).to(dt) for v in leaves], op=op,
            compression=int8, process_set=ps)]}


def eager_ops(x: np.ndarray, y: np.ndarray, ints: np.ndarray,
              ragged: np.ndarray, splits: list, sets) -> dict:
    """Every eager op over this rank's set of ``sets``, its async,
    grouped and in-place forms, and the errors a rank meets outside its
    set."""
    import horovod_tpu_torch as hvd

    ps = _mine(sets)
    others = [_set(s) for s in sets if hvd.rank() not in s]
    t, u = torch.from_numpy(x), torch.from_numpy(y)
    root = ps.ranks[-1]
    out = {"members": list(ps.ranks)}
    for op in ("sum", "average", "min", "max", "product"):
        out[op] = hvd.allreduce(t, op=op, process_set=ps).numpy()
    out["scaled"] = hvd.allreduce(t, op=hvd.Sum, prescale_factor=0.5,
                                  postscale_factor=3.0, process_set=ps).numpy()
    for comp in ("fp16", "bf16"):
        out[comp] = hvd.allreduce(
            t, compression=getattr(hvd.Compression, comp),
            process_set=ps).numpy()
    out["int_average"] = hvd.allreduce(torch.from_numpy(ints),
                                       process_set=ps).numpy()
    out["grouped"] = [r.numpy() for r in hvd.grouped_allreduce(
        [t, torch.from_numpy(ints), u], op=hvd.Sum, process_set=ps)]
    out["allgather"] = hvd.allgather(t, process_set=ps).numpy()
    out["broadcast"] = hvd.broadcast(t, root, process_set=ps).numpy()
    out["alltoall"] = hvd.alltoall(t, process_set=ps).numpy()
    out["reducescatter"] = hvd.reducescatter(t, process_set=ps).numpy()
    out["reducescatter_avg"] = hvd.reducescatter(t, op=hvd.Average,
                                                 process_set=ps).numpy()
    out["grouped_reducescatter"] = [r.numpy() for r in
                                    hvd.grouped_reducescatter(
                                        [t, u], process_set=ps)]
    # ragged: dim 0 differs by rank
    out["ragged_allgather"] = hvd.allgather(torch.from_numpy(ragged),
                                            process_set=ps).numpy()
    gathered, received = hvd.alltoall(torch.from_numpy(ragged), splits,
                                      process_set=ps)
    out["ragged_alltoall"] = (gathered.numpy(), received.tolist())
    # async and in-place forms
    h = hvd.allreduce_async(t, op=hvd.Sum, process_set=ps)
    out["poll_before"] = hvd.poll(h)
    out["async_sum"] = hvd.synchronize(h).numpy()
    out["poll_after"] = hvd.poll(h)
    inplace = t.clone()
    same = hvd.allreduce_(inplace, op=hvd.Sum, process_set=ps)
    out["allreduce_"] = (same is inplace, inplace.numpy())
    inplace = t.clone()
    h = hvd.broadcast_async_(inplace, root, process_set=ps)
    out["broadcast_async_"] = (hvd.synchronize(h) is inplace, inplace.numpy())
    pair = [t.clone(), u.clone()]
    h = hvd.grouped_allreduce_async_(pair, op=hvd.Sum, process_set=ps)
    out["grouped_allreduce_async_"] = [r.numpy() for r in hvd.synchronize(h)]
    out["grouped_inplace_is_input"] = all(
        a is b for a, b in zip(hvd.synchronize(h), pair))
    h = hvd.grouped_allgather_async([t, torch.from_numpy(ragged)],
                                    process_set=ps)
    out["grouped_allgather"] = [r.numpy() for r in hvd.synchronize(h)]
    h = hvd.grouped_reducescatter_async([t, u], op=hvd.Average,
                                        process_set=ps)
    out["grouped_reducescatter_avg"] = [r.numpy() for r in
                                        hvd.synchronize(h)]
    h = hvd.alltoall_async(torch.from_numpy(ragged), splits, process_set=ps)
    out["alltoall_async"] = hvd.synchronize(h)[0].numpy()
    sparse = torch.sparse_coo_tensor(
        torch.tensor([[hvd.rank(), 4]]), torch.tensor([1.0, 2.0]), (6,))
    out["sparse"] = hvd.synchronize(hvd.sparse_allreduce_async(
        sparse, op=hvd.Sum, process_set=ps)).to_dense().numpy()
    # objects, barrier, join
    out["broadcast_object"] = hvd.broadcast_object(
        {"from": hvd.rank()}, root_rank=root, process_set=ps)
    out["allgather_object"] = hvd.allgather_object(
        ["rank", hvd.rank()] * (hvd.rank() + 1), process_set=ps)
    hvd.barrier(process_set=ps)
    out["join"] = hvd.join()
    # what a rank outside a set meets: ValueError, before any call
    errors = []
    for other in others:
        for fn in (lambda: hvd.allreduce(t, process_set=other),
                   lambda: hvd.allgather(t, process_set=other),
                   lambda: hvd.barrier(process_set=other)):
            try:
                fn()
                errors.append("no error")
            except ValueError as exc:
                errors.append(str(exc))
    if others:
        w = torch.nn.Parameter(torch.ones(3))
        w.grad = torch.ones(3)
        opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.1),
                                       named_parameters=[("w", w)],
                                       process_set=others[0])
        try:
            opt.step()
            errors.append("no error")
        except ValueError as exc:
            errors.append(str(exc))
        try:
            hvd.broadcast(t, others[0].ranks[0], process_set=ps)
            errors.append("no error")
        except ValueError as exc:
            errors.append(str(exc))
    out["errors"] = errors
    out["ids"] = [p.process_set_id for p in [ps] + others]
    return out


def adasum(xs: list, sets) -> list:
    """``op=Adasum`` over this rank's set of ``sets`` (None outside
    every set): the allreduce of each of ``xs``, then their grouped
    allreduce."""
    import horovod_tpu_torch as hvd

    ps = _mine(sets)
    if ps is None:
        return None
    ts = [torch.from_numpy(x) for x in xs]
    single = [hvd.allreduce(t, op=hvd.Adasum, process_set=ps).numpy()
              for t in ts]
    grouped = [r.numpy() for r in hvd.grouped_allreduce(
        ts, op=hvd.Adasum, process_set=ps)]
    return [single, grouped]


# --- two-phase fusion, the overlap wire, microbatches -------------------------

def _group(sets):
    """This rank's torch group among ``sets`` (None for the global set)."""
    from horovod_tpu_torch.ops import collectives as C

    return C.set_group(_mine(sets), "test")


def two_phase(leaves: list, op: str, compression: str, depths: list,
              threshold: int, sets, alpha_us: float = 1e-6,
              beta_gbps: float = 1.0) -> dict:
    """``fused_two_phase_apply`` of ``leaves`` over this rank's set at
    each pipeline depth of ``depths``, and the single-phase fused
    allreduce of the same leaves."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import fusion

    group = _group(sets)
    comp = getattr(hvd.Compression, compression)
    ts = [torch.from_numpy(np.asarray(v)) for v in leaves]
    out = {}
    for depth in depths:
        out[depth] = [r.numpy() for r in fusion.fused_two_phase_apply(
            ts, op=op, group=group, compression=comp, threshold=threshold,
            pipeline_depth=depth, alpha_us=alpha_us, beta_gbps=beta_gbps)]
    one = fusion.fused_allreduce_pytree(
        {f"{i:02d}": t for i, t in enumerate(ts)}, op=op, group=group,
        compression=comp, threshold=threshold, two_phase=False)
    out["one"] = [one[f"{i:02d}"].numpy() for i in range(len(ts))]
    return out


def overlap_wire(microbatches: list, op: str, compression: str,
                 threshold: int, sets) -> dict:
    """The overlap wire over this rank's set: one reduce-scatter pass a
    microbatch of gradient leaves, the shards added from zeros, one
    all-gather."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import fusion

    group = _group(sets)
    comp = getattr(hvd.Compression, compression)
    mbs = [[torch.from_numpy(np.asarray(v)) for v in leaves]
           for leaves in microbatches]
    n = fusion._uniform_group_width(group)
    plan = fusion.plan_overlap_buckets(mbs[0], threshold, world_size=n)
    acc = fusion.zero_overlap_shards(plan)
    for leaves in mbs:
        shards = fusion.overlap_reduce_scatter(
            leaves, plan, op=op, group=group, compression=comp).wait()
        acc = tuple(a + s for a, s in zip(acc, shards))
    full = fusion.overlap_all_gather(acc, plan, mbs[0], group=group,
                                     compression=comp)
    return {"full": [f.numpy() for f in full],
            "shards": [a.numpy() for a in acc], "order": list(plan.order)}


class _Linear(torch.nn.Module):
    """``x @ w + b``, the toy regression of ``tests/test_microbatch.py``."""

    def __init__(self, d: int) -> None:
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(d))
        self.b = torch.nn.Parameter(torch.zeros(()))


def _mse(module, batch):
    x, y = batch
    return ((x @ module.w + module.b - y) ** 2).mean()


def toy_steps(x: np.ndarray, y: np.ndarray, optimizer: str, lr: float,
              steps: int, microbatches=None, overlap=None,
              compression: str = "none", wrap: bool = False,
              env: dict = None) -> dict:
    """``steps`` steps of the toy regression on this rank's rows, with a
    plain torch optimizer (the step reduces) or, with ``wrap``, a
    DistributedOptimizer; returns the losses, the parameters and the
    optimizer's state tensors."""
    import horovod_tpu_torch as hvd

    model = _Linear(x.shape[1])
    opt = (torch.optim.Adam(model.parameters(), lr=lr) if optimizer == "adam"
           else torch.optim.SGD(model.parameters(), lr=lr))
    comp = getattr(hvd.Compression, compression)
    if wrap:
        opt = hvd.DistributedOptimizer(opt, compression=comp)
    batch = (_my_rows(x), _my_rows(y))
    with _knobs(env or {}):
        step = hvd.make_train_step(_mse, opt, compression=comp,
                                   microbatches=microbatches,
                                   overlap=overlap)
        losses = [float(step(model, batch)) for _ in range(steps)]
    state = {f"{name}.{key}": v.numpy().copy()
             for name, p in model.named_parameters()
             for key, v in opt.state[p].items() if v.dim()}
    return {"losses": losses, "state": state,
            "params": {n: p.detach().numpy().copy()
                       for n, p in model.named_parameters()}}


def unused_parameter(wrap: bool, steps: int) -> dict:
    """Two ``Linear(4, 4)``; rank 1's forward never uses the second.  The
    steps must finish and leave the ranks' parameters equal; the first
    step's reduced gradients are returned."""
    import horovod_tpu_torch as hvd

    torch.manual_seed(0)
    model = torch.nn.ModuleDict({"a": torch.nn.Linear(4, 4),
                                 "b": torch.nn.Linear(4, 4)})

    def loss_fn(module, x):
        y = module["a"](x)
        if hvd.rank() == 0:
            y = module["b"](y)
        return (y ** 2).mean()

    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    if wrap:
        opt = hvd.DistributedOptimizer(
            opt, named_parameters=model.named_parameters())
    step = hvd.make_train_step(loss_fn, opt)
    x = torch.randn(8, 4, generator=torch.Generator().manual_seed(
        1 + hvd.rank()))
    grads = None
    for _ in range(steps):
        step(model, x)
        if grads is None:
            grads = {n: p.grad.numpy().copy()
                     for n, p in model.named_parameters()}
    return {"grads": grads,
            "params": {n: p.detach().numpy().copy()
                       for n, p in model.named_parameters()}}


def root_only_state() -> dict:
    """Only rank 0 has stepped its AdamW (a root that resumed, the others
    fresh); after ``broadcast_optimizer_state`` every rank's state must
    be the root's."""
    import horovod_tpu_torch as hvd

    torch.manual_seed(0)
    model = torch.nn.Linear(4, 3)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3 * (1 + hvd.rank()))
    if hvd.rank() == 0:
        for _ in range(2):
            model(torch.randn(2, 4)).sum().backward()
            opt.step()
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    state = {f"{i}.{key}": (v.numpy().copy() if torch.is_tensor(v) else v)
             for i, p in enumerate(model.parameters())
             for key, v in opt.state[p].items()}
    state["lr"] = opt.param_groups[0]["lr"]
    return state


# --- the model zoo: SyncBatchNorm, ResNet and BERT data parallelism -----------

def _rows(array: np.ndarray, dtype=None) -> torch.Tensor:
    t = _my_rows(array)
    return t if dtype is None else t.to(dtype)


def _tensors_by_name(pairs) -> dict:
    return {n: t.detach().numpy().copy() for n, t in pairs}


def sync_batch_norm(config: dict, params: dict, batch_stats: dict,
                    x: np.ndarray, labels: np.ndarray) -> dict:
    """A narrow ResNet with every BatchNorm synchronised over the global
    set, from the given flax variables, one train-mode forward and
    backward of this rank's rows: its logits, running statistics and
    the gradients of its parameters and of its input."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import load_jax_params
    from horovod_tpu_torch.models import resnet

    model = resnet.ResNet(**config, block=resnet.BasicBlock,
                          bn_process_set=hvd.global_process_set(),
                          device="cpu")
    load_jax_params(model, params, batch_stats)
    xs = _rows(x).requires_grad_(True)
    logits = model(xs)
    loss = -torch.log_softmax(logits, -1).gather(
        -1, _rows(labels).long()[:, None]).mean()
    loss.backward()
    return {"logits": logits.detach().numpy(), "x_grad": xs.grad.numpy(),
            "grads": _tensors_by_name((n, p.grad)
                                      for n, p in model.named_parameters()),
            "stats": _tensors_by_name(model.named_buffers())}


def _capture_wire(opt, store: dict) -> None:
    """Keep the first step's local and reduced gradients of ``opt`` (a
    DistributedOptimizer) in ``store``, by name."""
    synchronize = opt.synchronize

    def capturing():
        first = "local" not in store
        if first:
            store["local"] = {name: p.grad.detach().clone()
                              for p, name in opt._names.items()}
        synchronize()
        if first:
            store["reduced"] = {name: p.grad.detach().clone()
                                for p, name in opt._names.items()}

    opt.synchronize = capturing


def train_resnet(config: dict, params: dict, batch_stats: dict,
                 x: np.ndarray, labels: np.ndarray, compression: str,
                 error_feedback: bool, steps: int,
                 fusion_threshold: int) -> dict:
    """``steps`` data-parallel SGD-momentum steps (``bench.py``'s
    ``optax.sgd(0.1, momentum=0.9)``) of a narrow ResNet in train mode
    (plain BatchNorm, this rank's statistics) on this rank's rows: the
    losses, parameters and running statistics, and step 1's gradients
    before and after the wire."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import load_jax_params
    from horovod_tpu_torch.models import resnet

    model = resnet.ResNet(**config, block=resnet.BasicBlock, device="cpu")
    load_jax_params(model, params, batch_stats)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        compression=getattr(hvd.Compression, compression),
        error_feedback=error_feedback, fusion_threshold=fusion_threshold,
        named_parameters=model.named_parameters())
    wire = {}
    _capture_wire(opt, wire)

    def loss_fn(module, batch):
        images, labs = batch
        logp = torch.log_softmax(module(images), -1)
        return -logp.gather(-1, labs[:, None]).mean()

    step = hvd.make_train_step(loss_fn, opt)
    batch = (_rows(x), _rows(labels).long())
    losses, stats = [], []
    for _ in range(steps):
        losses.append(float(step(model, batch)))
        stats.append(_tensors_by_name(model.named_buffers()))
    return {"losses": losses, "stats": stats,
            "params": _tensors_by_name(model.named_parameters()),
            "local": {n: g.numpy() for n, g in wire["local"].items()},
            "reduced": {n: g.numpy() for n, g in wire["reduced"].items()}}


def train_bert(config: dict, params: dict, ids: np.ndarray,
               labels: np.ndarray, steps: int, lr: float,
               fusion_threshold: int) -> dict:
    """``benchmarks/bert_finetune_bench.py``'s step on a small BERT:
    the classifier with AdamW (weight decay 1e-4, optax's default) in a
    DistributedOptimizer on the fp16 wire with tensor fusion, this rank's
    rows, ``steps`` steps: the losses and parameters."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import (BertConfig,
                                          BertForSequenceClassification,
                                          classification_loss_fn,
                                          load_jax_params)

    cfg = BertConfig(**{**config, "dtype": getattr(torch, config["dtype"])})
    model = BertForSequenceClassification(cfg, num_classes=2, device="cpu")
    load_jax_params(model, params)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=lr, weight_decay=1e-4),
        compression=hvd.Compression.fp16, fusion_threshold=fusion_threshold)
    step = hvd.make_train_step(classification_loss_fn(model), opt)
    batch = (_rows(ids).long(), _rows(labels).long())
    losses = [float(step(model, batch)) for _ in range(steps)]
    return {"losses": losses,
            "params": _tensors_by_name(model.named_parameters())}


def aux_steps(x: np.ndarray, y: np.ndarray, lr: float, steps: int,
              microbatches: int) -> dict:
    """``make_train_step(has_aux=True)`` on the toy regression: the loss
    function also returns this microbatch's mean prediction and squared
    residuals; the step gives back (loss, aux) a step."""
    import horovod_tpu_torch as hvd

    model = _Linear(x.shape[1])

    def loss_fn(module, batch):
        bx, by = batch
        pred = bx @ module.w + module.b
        return ((pred - by) ** 2).mean(), {"pred_mean": pred.mean(),
                                           "residual": (pred - by) ** 2}

    step = hvd.make_train_step(loss_fn, torch.optim.SGD(model.parameters(),
                                                        lr=lr),
                               microbatches=microbatches, has_aux=True)
    batch = (_my_rows(x), _my_rows(y))
    out = [step(model, batch) for _ in range(steps)]
    return {"losses": [float(loss) for loss, _ in out],
            "aux": [{k: v.numpy() for k, v in aux.items()} for _, aux in out],
            "params": _tensors_by_name(model.named_parameters())}


# --- the topology compiler (topo/) and hierarchical allreduce ------------------

def _params(p):
    """A ``TopoCostParams`` from ``((α_ici, β_ici), (α_dcn, β_dcn))``."""
    from horovod_tpu_torch.topo.costmodel import TierParams, TopoCostParams

    return None if p is None else TopoCostParams(ici=TierParams(*p[0]),
                                                 dcn=TierParams(*p[1]))


def topo_runs(cases: list) -> list:
    """Each case of ``cases`` (a dict: ``kind`` "allreduce" or
    "roundtrip", ``stack`` ``[size, elems]``, ``algo``, ``op``,
    ``compression``, ``pods``, ``chips``) through
    ``topo/simulate.py`` over this world: every rank's result, stacked.
    A "roundtrip" case also returns the shards of the hierarchical
    reduce-scatter, stacked."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.topo import schedule, simulate

    out = []
    for case in cases:
        sim = simulate.simulated_mesh(case.get("pods"), case.get("chips"))
        comp = getattr(hvd.Compression, case.get("compression", "none"))
        stack = np.asarray(case["stack"])
        if case["kind"] == "allreduce":
            out.append(simulate.run_allreduce(
                sim, stack, algo=case["algo"], op=case.get("op", "sum"),
                compression=comp, params=_params(case.get("params"))))
            continue
        full = simulate.run_rs_ag_roundtrip(sim, stack, compression=comp,
                                            op=case.get("op", "sum"))
        x = torch.from_numpy(stack[hvd.rank()])
        sched = schedule.compile_bucket_schedule(
            x.numel() * 4, sim.topo, force="hierarchical")
        pad = (-x.numel()) % sim.topo.size
        shard = schedule.hierarchical_reduce_scatter(
            torch.cat([x, x.new_zeros(pad)]), sched,
            op=case.get("op", "sum"), compression=comp)
        out.append({"full": full, "shard": simulate._stacked(shard)})
    return out


def topo_schedule_ir(nbytes: list, pods: int, chips: int) -> list:
    """The compiled IR of each payload on this rank, as plain tuples."""
    from horovod_tpu_torch.topo import schedule
    from horovod_tpu_torch.topo.topology import MeshTopology

    topo = MeshTopology(pods, chips)
    return [dataclasses.astuple(schedule.compile_bucket_schedule(b, topo))
            for b in nbytes]


def topo_world(env: dict) -> dict:
    """The session's view of the topology under the knobs ``env``: the
    inferred and config topologies, the tiers' process sets (registered
    twice: found, not duplicated), this rank's tier group sizes, and the
    estimator's effective parameters in a world of several processes."""
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.topo import costmodel, simulate, topology

    with _knobs(env):
        inferred = topology.infer_topology()
        configured = topology.config_topology(hvd.size())
        intra, cross = topology.register_tier_process_sets(inferred)
        again = topology.register_tier_process_sets(inferred)
        found = all(a is b for a, b in zip(intra + cross,
                                           again[0] + again[1]))
        sets = ([list(ps.ranks) for ps in intra],
                [list(ps.ranks) for ps in cross])
        for ps in dict.fromkeys(intra + cross):
            if ps.process_set_id:               # the global set stays
                hvd.remove_process_set(ps)
        gi, gc = topology.tier_groups(configured)
        group_sizes = (dist.get_world_size(gi), dist.get_world_size(gc))
        est = costmodel.OnlineEstimator(decay=0.5)
        est.freeze(False)
        est.observe("ici", 5e7, 1e3)
        est.observe("dcn", 5e6, 1e3)
        prior_kept = est.effective_params() is est.prior
    return {"inferred": dataclasses.astuple(inferred),
            "simulated": dataclasses.astuple(simulate.simulated_mesh().topo),
            "simulated_chips_1": dataclasses.astuple(
                simulate.simulated_mesh(chips=1).topo),
            "configured": dataclasses.astuple(configured), "sets": sets,
            "found": found, "group_sizes": group_sizes,
            "prior_kept": prior_kept}


def topo_fused(leaves: list, op: str, compression: str, threshold: int,
               params, force, pods: int, chips: int, sets=None) -> dict:
    """``fused_two_phase_apply(schedule=)`` of ``leaves`` with a compiler
    for ``pods × chips`` over this rank's set (the world by default), the
    algorithms it chose a bucket, and the same leaves through the flat
    fused allreduce."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import fusion
    from horovod_tpu_torch.topo.schedule import ScheduleCompiler
    from horovod_tpu_torch.topo.topology import MeshTopology

    group = _group(sets or [list(range(hvd.size()))])
    comp = getattr(hvd.Compression, compression)
    ts = [torch.from_numpy(np.asarray(v)) for v in leaves]
    compiler = ScheduleCompiler(MeshTopology(pods, chips), _params(params),
                                force=force)
    got = fusion.fused_two_phase_apply(
        ts, op=op, group=group, compression=comp, threshold=threshold,
        pipeline_depth=2, schedule=compiler)
    algos = [compiler.compile(fusion._nbytes(ts, m)).algo
             for m in fusion.plan_fused_buckets(ts, threshold)]
    flat = fusion.fused_two_phase_apply(
        ts, op=op, group=group, compression=comp, threshold=threshold,
        pipeline_depth=2, alpha_us=10.0, beta_gbps=100.0)
    return {"got": [g.numpy() for g in got], "algos": algos,
            "flat": [f.numpy() for f in flat]}


def topo_overlap(microbatches: list, op: str, compression: str,
                 threshold: int, params, force) -> dict:
    """The overlap wire with ``topo=`` a 2×2 compiler: a reduce-scatter
    pass a microbatch, shards added from zeros, one all-gather; and the
    flat overlap wire on the same leaves."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import fusion
    from horovod_tpu_torch.topo.schedule import ScheduleCompiler
    from horovod_tpu_torch.topo.topology import MeshTopology

    comp = getattr(hvd.Compression, compression)
    mbs = [[torch.from_numpy(np.asarray(v)) for v in leaves]
           for leaves in microbatches]
    plan = fusion.plan_overlap_buckets(mbs[0], threshold,
                                       world_size=hvd.size())
    compiler = ScheduleCompiler(MeshTopology(2, 2), _params(params),
                                force=force)
    out = {"hierarchical": [
        fusion._overlap_bucket_schedule(plan, bi, compiler) is not None
        for bi in range(len(plan.members))]}
    for key, topo in (("topo", compiler), ("flat", None)):
        acc = fusion.zero_overlap_shards(plan)
        for leaves in mbs:
            shards = fusion.overlap_reduce_scatter(
                leaves, plan, op=op, compression=comp, topo=topo).wait()
            acc = tuple(a + s for a, s in zip(acc, shards))
        full = fusion.overlap_all_gather(acc, plan, mbs[0], compression=comp,
                                         topo=topo)
        out[key] = {"full": [f.numpy() for f in full],
                    "shards": [a.numpy() for a in acc]}
    return out


def topo_toy_steps(env: dict, **kwargs) -> dict:
    """:func:`toy_steps` under the knobs ``env``, from a fresh estimator;
    ``noted`` is how many tiers the last compiled plan noted (2 for a
    hierarchical plan, 0 when no compiler ran): the samples one more
    refinement adds (the instrumented steps have fed it already)."""
    from horovod_tpu_torch.topo import costmodel

    costmodel.reset_estimator()
    out = toy_steps(env=env, **kwargs)
    est = costmodel.estimator()
    est.freeze(False)
    before = est.samples
    est.refine_from_step(1e-3)
    out["noted"] = est.samples - before
    costmodel.reset_estimator()
    return out


def dcn_fault_site(stack: np.ndarray) -> dict:
    """The ``dcn`` fault site on a 2 x 2 simulated mesh of this world:
    the hierarchical allreduce's cross-pod stage and the overlap wire's
    ``xpod_rs`` trip it, the flat and two-phase wires never do, a seeded
    plan fires at the same runs twice, and the disarmed wire runs
    clean."""
    from horovod_tpu_torch import faults
    from horovod_tpu_torch.elastic.state import HorovodInternalError
    from horovod_tpu_torch.topo import simulate

    sim = simulate.simulated_mesh(2, 2)
    out = {}
    with faults.inject("dcn:step=0,mode=partition"):
        try:
            simulate.run_allreduce(sim, stack, algo="hierarchical")
            out["hierarchical"] = None
        except HorovodInternalError as e:
            out["hierarchical"] = str(e)
    with faults.inject("dcn:step=0"):
        for algo in ("flat", "two_phase"):
            simulate.run_allreduce(sim, stack, algo=algo)
        out["flat_history"] = faults.history()
    with faults.inject("dcn:step=0"):
        try:
            simulate.run_rs_ag_roundtrip(sim, stack)
            out["roundtrip"] = None
        except HorovodInternalError as e:
            out["roundtrip"] = str(e)

    def firing_sequence():
        fired = []
        with faults.inject("dcn:p=0.5,seed=42,times=3"):
            for i in range(8):
                try:
                    simulate.run_allreduce(sim, stack, algo="hierarchical")
                except HorovodInternalError:
                    fired.append(i)
        return fired

    out["sequences"] = (firing_sequence(), firing_sequence())
    out["clean"] = simulate.run_allreduce(sim, stack, algo="hierarchical")
    return out


def _spy_collectives(calls: list):
    """Wrap ``torch.distributed``'s reduce-scatter, allreduce and
    all-gather so each call appends ``(name, group width)`` to
    ``calls``; returns the restore function."""
    import torch.distributed as dist

    saved = {}
    for name in ("reduce_scatter_tensor", "all_reduce",
                 "all_gather_into_tensor"):
        fn = saved[name] = getattr(dist, name)

        def spy(*args, _fn=fn, _name=name, **kwargs):
            calls.append((_name, dist.get_world_size(kwargs.get("group"))))
            return _fn(*args, **kwargs)

        setattr(dist, name, spy)

    def restore():
        for name, fn in saved.items():
            setattr(dist, name, fn)

    return restore


def hier_allreduce(cases: list, env: dict, sets=None) -> list:
    """Eager ``hvd.allreduce`` of each case (``x`` this rank's tensor,
    ``op``, ``prescale``, ``postscale``, ``compression``; ``set`` True to
    run over this rank's set of ``sets``) under the knobs ``env``: the result and the
    collectives it issued, as ``(name, group width)``."""
    import horovod_tpu_torch as hvd

    out = []
    with _knobs(env):
        mine = None
        if sets:
            added = [hvd.add_process_set(s) for s in sets]
            mine = next(ps for ps in added if hvd.rank() in ps.ranks)
        try:
            for case in cases:
                calls: list = []
                restore = _spy_collectives(calls)
                try:
                    r = hvd.allreduce(
                        torch.from_numpy(np.asarray(case["x"])),
                        op=case["op"],
                        prescale_factor=case.get("prescale", 1.0),
                        postscale_factor=case.get("postscale", 1.0),
                        compression=getattr(hvd.Compression,
                                            case.get("compression", "none")),
                        process_set=mine if case.get("set") else None)
                finally:
                    restore()
                out.append({"r": r.numpy(), "calls": calls})
        finally:
            if sets:
                for ps in added:
                    hvd.remove_process_set(ps)
    return out


def hier_inner(env: dict) -> int:
    """``_resolve_hier_inner()`` under the knobs ``env``."""
    from horovod_tpu_torch.ops import collectives as C

    with _knobs(env):
        return C._resolve_hier_inner()


# --- MeshPlan, sequence and tensor parallelism --------------------------------

@contextlib.contextmanager
def _session_plan(spec):
    """Run with the session plan of ``spec`` (None: the 1-D default;
    "off": no plan, the path before plans), restoring the 1-D default
    after."""
    import dataclasses as dc
    from horovod_tpu_torch import basics

    if spec == "off":
        basics._session = dc.replace(basics._session, mesh_plan=None)
    else:
        basics.apply_mesh_plan(spec)
    try:
        yield basics._session.mesh_plan
    finally:
        basics.apply_mesh_plan(None)


def plan_view(spec) -> dict:
    """The session's view of the plan of ``spec``: the default plan's
    mesh, this rank's coordinates and groups, the registered process
    sets (registered twice: found, not duplicated) and the reduce group
    of ``make_train_step``."""
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import plan as plan_mod
    from horovod_tpu_torch.topo.topology import config_topology

    with _session_plan(spec) as plan:
        sets = plan.register_process_sets()
        again = plan.register_process_sets()
        group = plan_mod.collective_groups()
        out = {
            "axes": list(plan.axes), "describe": plan.describe(),
            "is_global_mesh": plan.mesh is hvd.global_mesh().mesh,
            "resolved_is_session": plan_mod.resolve_plan() is plan,
            "coords": plan.coords(),
            "sets": {k: [list(ps.ranks) for ps in v]
                     for k, v in sets.items()},
            "sets_found": all(a is b for k in sets
                              for a, b in zip(sets[k], again[k])),
            "groups": {n: list(plan.group(n).ranks)
                       for n in plan.axis_names},
            "reduce_width": (dist.get_world_size(group) if group is not None
                             else hvd.size()),
            "topology": list(dataclasses.astuple(
                config_topology(hvd.size()))),
            "config_plan": hvd.config().mesh_plan,
        }
    out["restored"] = hvd.mesh_plan().describe()
    return out


class _Affine(torch.nn.Module):
    """``x @ w + b``: the toy problem of ``tests/test_mesh_plan.py``."""

    def __init__(self, w: np.ndarray, b: np.ndarray) -> None:
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w.copy()))
        self.b = torch.nn.Parameter(torch.from_numpy(b.copy()))


def _affine_mse(module, batch):
    x, y = batch
    return (((x @ module.w + module.b) - y) ** 2).mean()


def plan_toy_steps(spec, kind: str, w: np.ndarray, b: np.ndarray,
                   x: np.ndarray, y: np.ndarray, steps: int,
                   pair: bool = False) -> dict:
    """``steps`` steps of the toy problem on this rank's rows under the
    session plan of ``spec``: ``kind`` "dp" (``make_train_step`` with a
    ``DistributedOptimizer(SGD(0.1))``) or "zero" (``make_zero_train_step``
    with SGD(0.1, momentum 0.9)).  ``pair``: reduce over the process set
    {r, r + 2} instead of the plan's group.  Also returns the
    collectives issued, as ``(name, group width)``."""
    import horovod_tpu_torch as hvd

    model = _Affine(w, b)
    batch = (_my_rows(x), _my_rows(y))
    calls: list = []
    with _session_plan(spec):
        ps, added = None, []
        if pair:
            from horovod_tpu_torch.process_sets import _table

            for ranks in ([0, 2], [1, 3]):
                found = _table().find(ranks)
                if found is None:
                    found = hvd.add_process_set(ranks)
                    added.append(found)
                if hvd.rank() in found.ranks:
                    ps = found
        if kind == "zero":
            step = hvd.make_zero_train_step(
                _affine_mse, lambda s: torch.optim.SGD(s, lr=0.1,
                                                       momentum=0.9))
        else:
            step = hvd.make_train_step(_affine_mse, hvd.DistributedOptimizer(
                torch.optim.SGD(model.parameters(), lr=0.1),
                process_set=ps), process_set=ps)
        restore = _spy_collectives(calls)
        try:
            losses = [float(step(model, batch)) for _ in range(steps)]
        finally:
            restore()
        for s in added:
            hvd.remove_process_set(s)
    return {"losses": losses, "calls": calls,
            "params": {n: p.detach().numpy().copy()
                       for n, p in model.named_parameters()}}


def _local_qkv(arrays, layout: dict, rank_spec=("dp", "sp", "tp")):
    """This rank's ``[b, t, h, d]`` shards of global ``[B, T, H, D]``
    arrays: batch over dp, sequence over sp, heads over tp."""
    from horovod_tpu_torch.parallel import make_mesh, shard_batch
    from horovod_tpu_torch.plan import P

    mesh = make_mesh(layout)
    t = [torch.from_numpy(a).requires_grad_(False) for a in arrays]
    return mesh, shard_batch(t, mesh, P(*rank_spec))


def seq_attention(kind: str, layout: dict, q: np.ndarray, k: np.ndarray,
                  v: np.ndarray, causal: bool, engine: str = "xla",
                  grads: bool = False) -> dict:
    """``kind`` "ring" or "ulysses" on this rank's shards of ``q``, ``k``,
    ``v`` under ``layout``: the local output and, with ``grads``, the
    local gradients of ``sum(o * o)`` (every rank's share of the global
    sum) with respect to the local q, k and v.  A ValueError comes back
    as its message."""
    from horovod_tpu_torch.parallel import (ring_self_attention,
                                            ulysses_attention)

    mesh, (lq, lk, lv) = _local_qkv((q, k, v), layout)
    for t in (lq, lk, lv):
        t.requires_grad_(grads)
    try:
        if kind == "ring":
            o = ring_self_attention(lq, lk, lv, mesh=mesh, causal=causal,
                                    engine=engine)
        else:
            o = ulysses_attention(lq, lk, lv, mesh=mesh, causal=causal)
    except ValueError as e:
        return {"error": str(e)}
    out = {"o": o.detach().numpy()}
    if grads:
        (o * o).sum().backward()
        out.update({f"d{n}": t.grad.numpy()
                    for n, t in zip("qkv", (lq, lk, lv))})
    return out


def spmd_gpt(config: dict, layout: dict, params: dict, tokens: np.ndarray,
             steps: int, local: bool = False, microbatches=None) -> dict:
    """``steps`` AdamW steps of the port's GPT through
    ``make_spmd_train_step`` on ``layout``: the flax weights loaded whole,
    ``shard_params``, the global batch through ``shard_batch`` (with
    ``local``, this rank's dp rows through ``local=True``).  Returns the
    losses, the gathered parameters (the reference's layout) and this
    rank's local slices.  With ``microbatches`` the step accumulates
    that many and its loss function has an aux output (the microbatch's
    local token count), whose stacked shapes come back as ``aux``."""
    from horovod_tpu_torch.models import GPT, GPTConfig, load_jax_params
    from horovod_tpu_torch.models.transformer import lm_loss_fn
    from horovod_tpu_torch.parallel import (gather_params, init_opt_state,
                                            make_mesh, make_spmd_train_step,
                                            shard_batch, shard_params)
    from horovod_tpu_torch.plan import P

    cfg = GPTConfig(**{**config, "dtype": getattr(torch, config["dtype"])})
    mesh = make_mesh(layout)
    model = GPT(cfg, mesh=mesh, device="cpu")
    load_jax_params(model, params)
    shard_params(model, mesh)
    opt = init_opt_state(_adamw, model)
    loss_fn = lm_loss_fn(model)
    if microbatches:
        def with_aux(module, batch):
            return loss_fn(module, batch), torch.tensor(
                float(batch[0].numel()))

        step = make_spmd_train_step(with_aux, opt, has_aux=True,
                                    microbatches=microbatches)
    else:
        step = make_spmd_train_step(loss_fn, opt)
    data = (tokens[:, :-1], tokens[:, 1:])
    if local:
        rows = tokens.shape[0] // mesh.shape.get("dp", 1)
        dp = mesh.coords(torch.distributed.get_rank()).get("dp", 0)
        data = tuple(d[dp * rows:(dp + 1) * rows] for d in data)
    batch = shard_batch(data, mesh, P("dp", "sp"), local=local)
    losses, aux = [], []
    for _ in range(steps):
        out = step(model, batch)
        if microbatches:
            out, extra = out
            aux.append(extra.tolist())
        losses.append(float(out))
    return {"losses": losses, "aux": aux,
            "full": {n: t.numpy().copy()
                     for n, t in gather_params(model, mesh).items()},
            "local": {n: p.detach().numpy().copy()
                      for n, p in model.named_parameters()}}


def plan_from_env(spec: str) -> dict:
    """``init`` under ``HVD_TPU_MESH_PLAN=spec``: the session plan and
    the process sets it registered, or the error ``init`` raised."""
    import horovod_tpu_torch as hvd

    os.environ["HVD_TPU_MESH_PLAN"] = spec
    hvd.shutdown()
    try:
        hvd.init(device="cpu")
        from horovod_tpu_torch.process_sets import _table

        return {"plan": hvd.mesh_plan().describe(),
                "sets": sorted(list(ps.ranks)
                               for ps in _table()._table.values())}
    except ValueError as e:
        return {"error": str(e), "initialized": hvd.is_initialized()}
    finally:
        del os.environ["HVD_TPU_MESH_PLAN"]
        hvd.shutdown()
        hvd.init(device="cpu")


# --- GPipe, mixture of experts, FSDP, ZeRO on a plan, the autotuner ------------

def _tree_tensors(tree):
    if isinstance(tree, dict):
        return {k: _tree_tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def _toy_stage(params, x):
    """``tests/test_pipeline.py``'s stage: ``tanh(x @ w1 + b1) @ w2 + x``."""
    h = torch.tanh(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + x


def _tanh_stage(params, x):
    return torch.tanh(x @ params)


def _dp_rows(array: np.ndarray, mesh) -> torch.Tensor:
    """This rank's rows of a global batch: its ``dp`` coordinate's."""
    dp = mesh.shape.get("dp", 1)
    index = mesh.coords(torch.distributed.get_rank()).get("dp", 0)
    rows = array.shape[0] // dp
    return torch.from_numpy(array[index * rows:(index + 1) * rows].copy())


def pipeline_toy(stacked: dict, x: np.ndarray, layout: dict, n_micro: int,
                 grads: bool = False, remat: bool = False) -> dict:
    """``pipeline_apply`` of the toy stage on ``layout``, this rank's
    stage cut from the stacked params and its dp rows of ``x``: the
    output rows and, with ``grads``, the gradients of ``sum(out²)`` (the
    rank's share of the global sum) for its stage and its rows."""
    from horovod_tpu_torch.parallel import (make_mesh, pipeline_apply,
                                            shard_stage_params)

    mesh = make_mesh(layout)
    mine = shard_stage_params(_tree_tensors(stacked), mesh)
    for p in mine.values():
        p.requires_grad_(grads)
    rows = _dp_rows(x, mesh).requires_grad_(grads)
    out = pipeline_apply(_toy_stage, mine, rows, mesh=mesh, n_micro=n_micro,
                         remat=remat)
    res = {"out": out.detach().numpy()}
    if grads:
        (out * out).sum().backward()
        res["grads"] = {k: p.grad.numpy() for k, p in mine.items()}
        res["dx"] = rows.grad.numpy()
    return res


def pipeline_planner(w: np.ndarray, x: np.ndarray, n_micro: int) -> dict:
    """``tests/test_mesh_plan.py::test_pipeline_planner_axes_match_legacy``:
    the legacy ``{dp, pp}`` mesh with no session plan, against the
    session plan ``data=…,pipe=4`` with no mesh."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import (make_mesh, pipeline_apply,
                                            shard_stage_params)

    stages = 4
    dp = hvd.size() // stages
    wt = torch.from_numpy(w)
    legacy_mesh = make_mesh({"dp": dp, "pp": stages})
    with _session_plan("off"):
        legacy = pipeline_apply(
            _tanh_stage, shard_stage_params(wt, legacy_mesh),
            _dp_rows(x, legacy_mesh), mesh=legacy_mesh, n_micro=n_micro,
            pp_axis="pp")
    with _session_plan(f"data={dp},pipe={stages}") as plan:
        rows = x.shape[0] // dp
        index = plan.coords()["data"]
        planned = pipeline_apply(
            _tanh_stage, shard_stage_params(wt, plan.mesh, "pipe"),
            torch.from_numpy(x[index * rows:(index + 1) * rows].copy()),
            n_micro=n_micro)
    return {"legacy": legacy.numpy(), "planned": planned.numpy()}


def _gpt_config(config: dict):
    from horovod_tpu_torch.models import GPTConfig

    return GPTConfig(**{**config, "dtype": getattr(torch, config["dtype"])})


def _loss_grads(model, loss_fn, batch) -> tuple:
    model.zero_grad(set_to_none=True)
    loss = loss_fn(model, batch)
    loss.backward()
    return float(loss), {n: p.grad.numpy().copy()
                         for n, p in model.named_parameters()}


def pipelined_gpt(config: dict, layout: dict, params: dict,
                  tokens: np.ndarray, steps: int, n_micro: int = 2) -> dict:
    """``PipelinedGPT`` on ``layout`` from the reference's pipelined tree
    (this rank's stage loaded): the logits of its dp rows, the loss and
    gradients with and without remat, then ``steps`` AdamW steps of
    ``make_spmd_train_step``.  Returns this rank's parameters after."""
    from horovod_tpu_torch.models import (PipelinedGPT, load_jax_params,
                                          pipelined_lm_loss_fn)
    from horovod_tpu_torch.parallel import (init_opt_state, make_mesh,
                                            make_spmd_train_step,
                                            shard_batch)
    from horovod_tpu_torch.plan import P

    mesh = make_mesh(layout)
    models = [PipelinedGPT(_gpt_config(config), mesh, n_micro=n_micro,
                           remat=remat, device="cpu")
              for remat in (False, True)]
    for m in models:
        load_jax_params(m, params)
    model = models[0]
    batch = shard_batch((tokens[:, :-1], tokens[:, 1:]), mesh, P("dp", None))
    with torch.no_grad():
        logits = model(batch[0]).numpy()
    checks = [_loss_grads(m, pipelined_lm_loss_fn(m), batch) for m in models]
    opt = init_opt_state(_adamw, model)
    step = make_spmd_train_step(pipelined_lm_loss_fn(model), opt)
    losses = [float(step(model, batch)) for _ in range(steps)]
    return {"stage": model.stage_index, "logits": logits,
            "remat": checks, "losses": losses,
            "params": {n: p.detach().numpy().copy()
                       for n, p in model.named_parameters()}}


def pipelined_gpt_errors(config: dict, layout: dict, n_layer: int,
                         batch_rows: int, n_micro: int) -> dict:
    """The errors ``PipelinedGPT`` and its step raise: the layer/stage
    mismatch, and a batch that ``n_micro`` does not divide."""
    from horovod_tpu_torch.models import PipelinedGPT
    from horovod_tpu_torch.parallel import make_mesh

    mesh = make_mesh(layout)
    out = {}
    try:
        PipelinedGPT(_gpt_config({**config, "n_layer": n_layer}), mesh,
                     device="cpu")
    except ValueError as e:
        out["layers"] = str(e)
    model = PipelinedGPT(_gpt_config(config), mesh, n_micro=n_micro,
                         device="cpu")
    try:
        model(torch.zeros((batch_rows, 4), dtype=torch.int64))
    except ValueError as e:
        out["micro"] = str(e)
    return out


def moe_gpt(config: dict, layout: dict, params: dict, tokens: np.ndarray,
            steps: int, aux_weight: float = 0.0) -> dict:
    """The MoE GPT on ``layout`` from the reference's flax tree:
    ``shard_params`` (experts over ``ep``, their FFN over ``tp``), this
    rank's ``[b, t]`` block (rows over dp, the sequence over sp): the
    first forward's logits and aux loss, then
    ``steps`` AdamW steps of ``make_spmd_train_step`` on ``lm_loss_fn``
    (plus ``aux_weight`` × the load-balancing loss when it is not 0).
    Returns the gathered parameters and the local slices."""
    from horovod_tpu_torch.models import GPT, load_jax_params
    from horovod_tpu_torch.models.transformer import lm_loss_fn
    from horovod_tpu_torch.parallel import (gather_params, init_opt_state,
                                            make_mesh, make_spmd_train_step,
                                            moe_aux_loss, shard_batch,
                                            shard_params)
    from horovod_tpu_torch.plan import P

    mesh = make_mesh(layout)
    model = GPT(_gpt_config(config), mesh=mesh, device="cpu")
    load_jax_params(model, params)
    shard_params(model, mesh)
    batch = shard_batch((tokens[:, :-1], tokens[:, 1:]), mesh, P("dp", "sp"))
    with torch.no_grad():
        logits = model(batch[0]).numpy()
        aux = float(moe_aux_loss(model, weight=1.0))
    opt = init_opt_state(_adamw, model)
    loss_fn = lm_loss_fn(model)
    if aux_weight:
        def with_aux(module, b):
            lm = loss_fn(module, b)
            return lm + moe_aux_loss(module, weight=aux_weight)
        step = make_spmd_train_step(with_aux, opt)
    else:
        step = make_spmd_train_step(loss_fn, opt)
    losses = [float(step(model, batch)) for _ in range(steps)]
    return {"logits": logits, "aux": aux, "losses": losses,
            "full": {n: t.numpy().copy()
                     for n, t in gather_params(model, mesh).items()},
            "local": {n: p.detach().numpy().copy()
                      for n, p in model.named_parameters()}}


def moe_planner(config: dict, params: dict, x: np.ndarray) -> dict:
    """``tests/test_mesh_plan.py::test_moe_planner_axes_match_legacy``:
    ``MoEMlp`` on the legacy ``{'ep': n}`` mesh (experts cut over it) and
    under the session plan ``expert=n`` (the rule table names ``ep``, so
    its experts stay whole): the same output bits."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.layers import Init
    from horovod_tpu_torch.parallel import MoEMlp, make_mesh, shard_params

    n = hvd.size()

    def run(plan_spec, mesh):
        with _session_plan(plan_spec) as plan:
            layer = MoEMlp(**config, init=Init(torch.float32, "cpu", 0),
                           dtype=torch.float32,
                           plan=plan if mesh is None else None)
            if mesh is not None:
                from horovod_tpu_torch.plan import resolve_plan

                layer.plan = resolve_plan(mesh)
            with torch.no_grad():
                layer.router.kernel.copy_(torch.from_numpy(
                    params["router"]["kernel"]))
                layer.w_up.copy_(torch.from_numpy(params["w_up"]))
                layer.w_down.copy_(torch.from_numpy(params["w_down"]))
            holder = torch.nn.Module()     # the rule table's "moe" path
            holder.moe = layer
            shard_params(holder, mesh or plan.mesh)
            with torch.no_grad():
                out = layer(torch.from_numpy(x))
            return out.numpy(), tuple(layer.w_up.shape)

    legacy, legacy_shape = run("off", make_mesh({"ep": n}))
    planned, planned_shape = run(f"expert={n}", None)
    return {"legacy": legacy, "planned": planned,
            "shapes": [legacy_shape, planned_shape]}


class _DenseToy(torch.nn.Module):
    """``tests/test_fsdp.py``'s problem: ``tanh(x @ dense.kernel +
    dense.bias) @ out``."""

    def __init__(self, params: dict) -> None:
        super().__init__()
        self.dense = torch.nn.Module()
        self.dense.kernel = torch.nn.Parameter(
            torch.from_numpy(params["dense"]["kernel"].copy()))
        self.dense.bias = torch.nn.Parameter(
            torch.from_numpy(params["dense"]["bias"].copy()))
        self.out = torch.nn.Parameter(torch.from_numpy(params["out"].copy()))


def _toy_loss(module, batch):
    xb, yb = batch
    h = torch.tanh(xb @ module.dense.kernel + module.dense.bias)
    return ((h @ module.out - yb) ** 2).mean()


def fsdp_toy(kind: str, params: dict, x: np.ndarray, y: np.ndarray,
             steps: int, lr: float = 1e-2, optimizer: str = "adamw",
             max_grad_norm=None) -> dict:
    """``steps`` steps of the toy on this rank's rows of the batch (the
    rows of its place in the batch group): ``kind`` "dp"
    (``make_train_step``), "fsdp" (the session plan's 1-D axis), "off"
    (FSDP with no session plan), "hsdp" (a ``{dcn: 2, ici: 2}`` mesh,
    ``dp_axis='dcn'``), "plan_hsdp" (the session plan
    ``data=2,fsdp=2``), "aux" (FSDP with ``has_aux``).  Returns the
    losses, the whole parameters, the local slices' and the optimizer
    state's shapes."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.optim import make_fsdp_train_step
    from horovod_tpu_torch.parallel import make_mesh

    def make_opt(ps):
        if optimizer == "sgd":
            return torch.optim.SGD(ps, lr=lr)
        if optimizer == "adam":
            return torch.optim.Adam(ps, lr=lr)
        return torch.optim.AdamW(ps, lr=lr, weight_decay=1e-4)

    model = _DenseToy(params)
    rows = x.shape[0] // hvd.size()
    me = hvd.rank()
    batch = (torch.from_numpy(x[me * rows:(me + 1) * rows].copy()),
             torch.from_numpy(y[me * rows:(me + 1) * rows].copy()))
    spec = {"off": "off", "plan_hsdp": "data=2,fsdp=2"}.get(kind)
    out = {}
    with _session_plan(spec):
        if kind == "dp":
            step = hvd.make_train_step(_toy_loss, make_opt(
                list(model.parameters())))
            out["losses"] = [float(step(model, batch)) for _ in range(steps)]
            out["params"] = {n: p.detach().numpy().copy()
                             for n, p in model.named_parameters()}
            return out
        kwargs = {}
        if kind == "hsdp":
            kwargs = dict(mesh=make_mesh({"dcn": 2, "ici": 2}),
                          axis_name="ici", dp_axis="dcn")
        loss_fn = _toy_loss
        if kind == "aux":
            def loss_fn(m, b):
                loss = _toy_loss(m, b)
                return loss, {"loss_copy": loss}
            kwargs["has_aux"] = True
        shard, step = make_fsdp_train_step(loss_fn, make_opt,
                                           max_grad_norm=max_grad_norm,
                                           **kwargs)
        model, opt = shard(model)
        out["local_shapes"] = {n: list(p.shape)
                               for n, p in model.named_parameters()}
        losses, auxes = [], []
        for _ in range(steps):
            res = step(model, opt, batch)
            if kind == "aux":
                res, aux = res
                auxes.append(float(aux["loss_copy"]))
            losses.append(float(res))
        out.update(losses=losses, aux=auxes, dp_axis=step.dp_axis,
                   axis=step.axis,
                   state_shapes={f"{n}.{k}": list(v.shape)
                                 for n, p in model.named_parameters()
                                 for k, v in opt.state[p].items()
                                 if v.dim()},
                   params={n: t.numpy().copy()
                           for n, t in step.gather(model).items()})
    return out


def _fsdp_steps(step, model, opt, batch, steps: int) -> dict:
    """``steps`` steps of an FSDP ``step``, the first recorded
    (``analysis.step_check``): the losses, each step's
    ``peak_gathered_bytes``, the recorded sequence, the whole parameters,
    each one's split dim and the units."""
    from horovod_tpu_torch.analysis.step_check import record_collectives

    with record_collectives() as first:
        losses = [float(step(model, opt, batch))]
    peaks = [step.peak_gathered_bytes]
    for _ in range(steps - 1):
        losses.append(float(step(model, opt, batch)))
        peaks.append(step.peak_gathered_bytes)
    root, blocks = step.units(model)
    return dict(losses=losses, peaks=peaks, seq=[list(e) for e in first],
                params={n: t.numpy().copy()
                        for n, t in step.gather(model).items()},
                split=dict(step.split), root=root,
                blocks=[[b, names] for b, names in blocks])


def fsdp_gpt(config: dict, params: dict, tokens: np.ndarray, steps: int,
             kind: str = "fsdp", chunk: int = 0, max_grad_norm=None,
             sgd: bool = False) -> dict:
    """``steps`` AdamW(1e-2, weight decay 1e-4) steps (with ``sgd``,
    SGD(0.1)) of the port's GPT from the reference's flax tree through
    ``make_fsdp_train_step`` on ``lm_loss_fn(vocab_chunk_size=chunk)``,
    each rank on its rows of ``tokens``: ``kind`` "fsdp" (the session's
    1-D axis) or "hsdp" (a ``{dcn: 2, ici: 2}`` mesh,
    ``dp_axis='dcn'``).  Returns :func:`_fsdp_steps`'s readings and
    ``model_freed``: whether, with the collector off, the model went with
    its last reference (no cycle holds it)."""
    import gc
    import weakref

    from horovod_tpu_torch.models import GPT, load_jax_params
    from horovod_tpu_torch.models.transformer import lm_loss_fn
    from horovod_tpu_torch.optim import make_fsdp_train_step
    from horovod_tpu_torch.parallel import make_mesh

    gc.disable()             # a reference cycle then keeps the model alive
    try:
        model = GPT(_gpt_config(config), device="cpu")
        load_jax_params(model, params)
        kwargs = {}
        if kind == "hsdp":
            kwargs = dict(mesh=make_mesh({"dcn": 2, "ici": 2}),
                          axis_name="ici", dp_axis="dcn")
        shard, step = make_fsdp_train_step(
            lm_loss_fn(model, vocab_chunk_size=chunk),
            lambda ps: (torch.optim.SGD(ps, lr=0.1) if sgd else
                        torch.optim.AdamW(ps, lr=1e-2, weight_decay=1e-4)),
            max_grad_norm=max_grad_norm, **kwargs)
        model, opt = shard(model)
        mine = _my_rows(tokens).long()
        out = _fsdp_steps(step, model, opt, (mine[:, :-1], mine[:, 1:]),
                          steps)
        held = weakref.ref(model)
        del model, opt, shard, step
        out["model_freed"] = held() is None
    finally:
        gc.enable()
    return out


class _Blk(torch.nn.Module):
    """``h + tanh(lin(h)) * scale``: the tied toy's repeated block."""

    def __init__(self, w: np.ndarray, b, scale: np.ndarray) -> None:
        super().__init__()
        self.lin = torch.nn.Linear(*w.shape[::-1])
        with torch.no_grad():
            self.lin.weight.copy_(torch.from_numpy(w))
        if isinstance(b, torch.nn.Parameter):
            self.lin.bias = b
        else:
            with torch.no_grad():
                self.lin.bias.copy_(torch.from_numpy(b))
        self.scale = torch.nn.Parameter(torch.from_numpy(scale.copy()))

    def forward(self, h):
        return h + torch.tanh(self.lin(h)) * self.scale


class _TiedBlocks(torch.nn.Module):
    """An embedding tied to the head (``head.weight is emb.weight``) and
    two blocks sharing one bias: both shared leaves are the root's."""

    def __init__(self, leaves: dict) -> None:
        super().__init__()
        self.emb = torch.nn.Embedding(*leaves["emb.weight"].shape)
        with torch.no_grad():
            self.emb.weight.copy_(torch.from_numpy(leaves["emb.weight"]))
        self.block_0 = _Blk(leaves["block_0.lin.weight"],
                            leaves["block_0.lin.bias"],
                            leaves["block_0.scale"])
        self.block_1 = _Blk(leaves["block_1.lin.weight"],
                            self.block_0.lin.bias, leaves["block_1.scale"])
        self.head = torch.nn.Linear(self.emb.weight.shape[1],
                                    self.emb.weight.shape[0], bias=False)
        self.head.weight = self.emb.weight


def _tied_blocks_loss(module, batch):
    tokens, targets = batch
    h = module.block_1(module.block_0(module.emb(tokens)))
    logits = module.head(h)
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), targets.reshape(-1))


def fsdp_tied_blocks(leaves: dict, tokens: np.ndarray, targets: np.ndarray,
                     steps: int) -> dict:
    """``steps`` Adam(1e-2) steps of ``_TiedBlocks`` through
    ``make_fsdp_train_step``, each rank on its rows; returns
    :func:`_fsdp_steps`'s readings."""
    from horovod_tpu_torch.optim import make_fsdp_train_step

    shard, step = make_fsdp_train_step(
        _tied_blocks_loss, lambda ps: torch.optim.Adam(ps, lr=1e-2))
    model, opt = shard(_TiedBlocks(leaves))
    batch = (_my_rows(tokens).long(), _my_rows(targets).long())
    return _fsdp_steps(step, model, opt, batch, steps)


def zero_plan(spec: str, w: np.ndarray, b: np.ndarray, x: np.ndarray,
              y: np.ndarray, steps: int) -> dict:
    """``make_zero_train_step`` (SGD(0.1, momentum 0.9)) under the session
    plan ``spec`` (with model axes: the reduce group is this rank's data
    group), each rank on its data coordinate's rows.  Returns the
    losses, the parameters, the optimizer shards' widths and the
    collectives' group widths."""
    import horovod_tpu_torch as hvd

    model = _Affine(w, b)
    calls: list = []
    with _session_plan(spec) as plan:
        data = plan.reduce_axes()
        group = plan.group(data)
        rows = x.shape[0] // group.size
        sl = slice(group.index * rows, (group.index + 1) * rows)
        batch = (torch.from_numpy(x[sl].copy()), torch.from_numpy(y[sl].copy()))
        step = hvd.make_zero_train_step(
            _affine_mse, lambda s: torch.optim.SGD(s, lr=0.1, momentum=0.9))
        restore = _spy_collectives(calls)
        try:
            losses = [float(step(model, batch)) for _ in range(steps)]
        finally:
            restore()
    return {"losses": losses, "calls": sorted(set(calls)),
            "shards": {n: s.numel() for n, s in step.shards.items()},
            "params": {n: p.detach().numpy().copy()
                       for n, p in model.named_parameters()}}


def autotune_steps(env: dict, steps: int, w: np.ndarray, b: np.ndarray,
                   x: np.ndarray, y: np.ndarray, second: bool = False,
                   lr: float = 0.05) -> dict:
    """``steps`` calls of ``make_train_step`` (a DistributedOptimizer over
    SGD(lr)) on the toy affine problem with the knobs ``env`` set at
    ``init`` (``HOROVOD_AUTOTUNE=1`` and the rest), this rank on its
    rows.  Returns whether the step was the autotuner's, the knobs
    searched, every applied point, the live config's knobs after, the
    plan's layout, the losses, and, with ``second``, whether a second
    step built in the session was autotuned."""
    import dataclasses as dc
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.optim import AutotunedTrainStep

    model = _Affine(w, b)
    batch = (_my_rows(x), _my_rows(y))
    with _knobs(env):
        pm = hvd.parameter_manager()
        start = dc.asdict(hvd.config())
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=lr))
        step = hvd.make_train_step(_affine_mse, opt)
        out = {"tuned": isinstance(step, AutotunedTrainStep),
               "knobs": list(pm.knob_names), "start": start,
               "pm_start": pm.current_values()}
        if second:
            other = hvd.make_train_step(_affine_mse, opt)
            out["second_tuned"] = isinstance(other, AutotunedTrainStep)
        out["losses"] = [float(step(model, batch)) for _ in range(steps)]
        out.update(frozen=pm.frozen, applied=step.applied,
                   applied_knobs=step.applied_knobs,
                   pm_final=pm.current_values(),
                   config=dc.asdict(hvd.config()),
                   plan=hvd.mesh_plan().describe())
    return out


# --- the sharded entry points' reference keywords and tied weights ----------

class _LinToy(torch.nn.Module):
    """``tests/test_zero.py``'s toy: ``(x @ w + b) * scale``."""

    def __init__(self, w: np.ndarray) -> None:
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w.copy()))
        self.b = torch.nn.Parameter(torch.zeros(w.shape[1]))
        self.scale = torch.nn.Parameter(torch.ones(()))


def _lin_loss(module, batch):
    x, y = batch
    pred = (x @ module.w + module.b) * module.scale
    return ((pred - y) ** 2).mean()


def keyword_steps(w: np.ndarray, x: np.ndarray, y: np.ndarray,
                  steps: int) -> dict:
    """The reference keywords of the entry points, each rank on its rows:
    ``make_train_step(distributed=True, mesh=, axis_name=)`` with a plain
    SGD(0.1, momentum 0.9), ``make_train_step(distributed=False)`` with
    that SGD in a ``DistributedOptimizer`` (the optimizer reduces), and
    one ``make_zero_train_step(op=Sum, has_aux=True, mesh=, axis_name=)``
    step with SGD(0.01)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import make_mesh

    batch = (_my_rows(x), _my_rows(y))
    mesh = make_mesh({"hvd": hvd.size()})

    def sgd(ps, lr=0.1):
        return torch.optim.SGD(ps, lr=lr, momentum=0.9 if lr == 0.1 else 0)

    def params(model):
        return {n: p.detach().numpy().copy()
                for n, p in model.named_parameters()}

    out = {}
    model = _LinToy(w)
    step = hvd.make_train_step(_lin_loss, sgd(list(model.parameters())),
                               distributed=True, mesh=mesh, axis_name="hvd")
    out["dp"] = dict(losses=[float(step(model, batch)) for _ in range(steps)],
                     params=params(model))
    model = _LinToy(w)
    opt = hvd.DistributedOptimizer(sgd(list(model.parameters())),
                                   named_parameters=model.named_parameters())
    step = hvd.make_train_step(_lin_loss, opt, distributed=False)
    out["dist_opt"] = dict(
        losses=[float(step(model, batch)) for _ in range(steps)],
        params=params(model))

    def loss_aux(m, b):
        loss = _lin_loss(m, b)
        return loss, {"loss_copy": loss}

    model = _LinToy(w)
    step = hvd.make_zero_train_step(loss_aux, lambda ps: sgd(ps, lr=0.01),
                                    op=hvd.Sum, has_aux=True, mesh=mesh,
                                    axis_name="hvd")
    loss, aux = step(model, batch)
    out["zero"] = dict(loss=float(loss), aux=float(aux["loss_copy"]),
                       params=params(model))
    return out


class _Tied(torch.nn.Module):
    """An ``Embedding(8, 4)`` whose weight is also the head
    ``Linear(4, 8)``'s: torch's weight tying, one ``Parameter`` in two
    modules."""

    def __init__(self, emb: np.ndarray) -> None:
        super().__init__()
        self.emb = torch.nn.Embedding(*emb.shape)
        self.head = torch.nn.Linear(emb.shape[1], emb.shape[0], bias=False)
        with torch.no_grad():
            self.emb.weight.copy_(torch.from_numpy(emb))
        self.head.weight = self.emb.weight


def _tied_loss(module, batch):
    tokens, targets = batch
    logits = module.head(module.emb(tokens))
    return torch.nn.functional.cross_entropy(logits.reshape(-1, 8),
                                             targets.reshape(-1))


def tied_fsdp(emb: np.ndarray, tokens: np.ndarray, targets: np.ndarray,
              steps: int) -> dict:
    """``steps`` Adam(1e-2) steps of the tied toy, each rank on its rows,
    through ``make_fsdp_train_step`` and through the data-parallel
    ``make_train_step``: losses and the whole tied weight."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.optim import make_fsdp_train_step

    batch = (_my_rows(tokens).long(), _my_rows(targets).long())
    out = {}
    model = _Tied(emb)
    step = hvd.make_train_step(_tied_loss,
                               torch.optim.Adam(model.parameters(), lr=1e-2))
    out["dp"] = dict(losses=[float(step(model, batch)) for _ in range(steps)],
                     weight=model.emb.weight.detach().numpy().copy())
    model = _Tied(emb)
    shard, step = make_fsdp_train_step(
        _tied_loss, lambda ps: torch.optim.Adam(ps, lr=1e-2))
    model, opt = shard(model)
    losses = [float(step(model, opt, batch)) for _ in range(steps)]
    out["fsdp"] = dict(losses=losses,
                       weight=step.gather(model)["emb.weight"].numpy())
    return out


# --- observability ------------------------------------------------------------

def obs_cross_rank(step_times: list, gauges: list, factor: float) -> dict:
    """This rank's step times into a fresh registry's step-time histogram,
    then the collective ``cross_rank_summary`` with the gauge ``my_gauge``
    (``gauges[rank]``); returns the summary and the straggler gauges."""
    from horovod_tpu_torch.obs import aggregate, metrics

    import horovod_tpu_torch as hvd

    reg = metrics.registry()
    reg.reset()
    hist = reg.histogram("hvd_tpu_step_time_seconds").labels(kind="train")
    for t in step_times[hvd.rank()]:
        hist.observe(t)
    out = aggregate.cross_rank_summary({"my_gauge": gauges[hvd.rank()]},
                                       factor=factor)
    snap = reg.snapshot()
    return {"summary": out,
            "suspect": snap["hvd_tpu_straggler_suspect"][0]["value"],
            "skew": snap["hvd_tpu_step_time_skew"][0]["value"]}


def obs_plan_records(x: np.ndarray, y: np.ndarray, steps: int,
                     microbatches: int) -> dict:
    """``steps`` SGD(0.1) steps of the toy regression with ``microbatches``
    on the overlap wire, from a fresh registry, then one step of a second
    build: the registry's snapshot after the first build's steps and
    after the rebuild."""
    from horovod_tpu_torch.obs import metrics

    import horovod_tpu_torch as hvd

    metrics.registry().reset()
    model = _Linear(x.shape[1])
    batch = (_my_rows(x), _my_rows(y))

    def build():
        return hvd.make_train_step(
            _mse, torch.optim.SGD(model.parameters(), lr=0.1),
            microbatches=microbatches, overlap=True)

    step = build()
    for _ in range(steps):
        step(model, batch)
    first = metrics.registry().snapshot()
    build()(model, batch)
    return {"first": first, "rebuilt": metrics.registry().snapshot()}


def _span_tree(spans: list) -> list:
    """``(name, args, parent's index or None)`` of each span, in ring
    order (ids are random: the structure is what compares)."""
    index = {sp["span_id"]: i for i, sp in enumerate(spans)}
    return [(sp["name"], sp["args"], index.get(sp["parent_id"]))
            for sp in spans]


def topo_obs(x: np.ndarray, y: np.ndarray, steps: int, numel: int,
             compression: str, kernel: str) -> dict:
    """The topology layer's telemetry on this rank, from a fresh registry
    and span ring: ``steps`` SGD steps of the toy regression under a 2x2
    hierarchical schedule (each step root's children and the children
    of its ``hvd_tpu_wire``, the ``topo`` metrics, the estimator's
    gauges), then one hierarchical ``execute_schedule`` of ``numel``
    elements and the overlap wire's two halves on ``compression`` with
    the IR's ``kernel``, each under a root span of its own."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.obs import metrics, trace
    from horovod_tpu_torch.topo import costmodel, schedule
    from horovod_tpu_torch.topo.topology import MeshTopology

    metrics.registry().reset()
    trace.clear()
    costmodel.reset_estimator()
    env = {"HVD_TPU_TOPO_SPEC": "2x2", "HVD_TPU_TOPO_SCHEDULE":
           "hierarchical"}
    with _knobs(env):
        trace.clear()
        model = _Linear(x.shape[1])
        step = hvd.make_train_step(_mse, torch.optim.SGD(
            model.parameters(), lr=0.1))
        for _ in range(steps):
            step(model, (_my_rows(x), _my_rows(y)))
        spans = trace.snapshot()
    roots = [i for i, sp in enumerate(spans) if sp["name"] == "hvd_tpu_step"]
    tree = _span_tree(spans)
    per_step = [[(name, args) for name, args, parent in tree
                 if parent == r] for r in roots]
    wires = [i for i, (name, _, parent) in enumerate(tree)
             if name == "hvd_tpu_wire" and parent in roots]
    per_wire = [[(name, args) for name, args, parent in tree
                 if parent == w] for w in wires]
    snap = metrics.registry().snapshot()

    trace.clear()
    comp = getattr(hvd.Compression, compression)
    sched = schedule.compile_bucket_schedule(
        numel * 4, MeshTopology(2, 2), force="hierarchical", kernel=kernel)
    xr = torch.arange(numel, dtype=torch.float32) * (1 + hvd.rank())
    with trace.span("hvd_tpu_step", root=True):
        schedule.execute_schedule(xr, sched, op="average", compression=comp)
    with trace.span("hvd_tpu_step", root=True):
        shard = schedule.hierarchical_reduce_scatter(xr, sched, op="sum",
                                                     compression=comp)
        schedule.hierarchical_all_gather(shard, sched, compression=comp)
    costmodel.reset_estimator()
    return {"per_step": per_step, "per_wire": per_wire, "snapshot": snap,
            "schedule": _span_tree(trace.snapshot())}


# --- durable state and recovery (elastic/, faults.py) -------------------------

@contextlib.contextmanager
def _owned_group(store: str):
    """Run with the session owning its group, made from torchrun's
    environment on a loopback port rank 0 picks just before (an elastic
    re-init then moves to a new rendezvous generation); afterwards the
    worker rejoins a group of its own through the FileStore ``store``,
    as ``_serve`` made it."""
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.basics import _free_port

    rank, world = hvd.rank(), hvd.size()
    port = [_free_port() if rank == 0 else None]
    dist.broadcast_object_list(port, src=0)
    port = port[0]
    hvd.shutdown()
    dist.destroy_process_group()
    env = {"RANK": str(rank), "WORLD_SIZE": str(world),
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        hvd.init(device="cpu")
        yield
    finally:
        hvd.shutdown()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world,
                                timeout=timedelta(seconds=120))
        hvd.init(device="cpu")


def elastic_chaos(store: str, fault_step: int, total: int,
                  seed: int = 0) -> dict:
    """The counterpart of ``TestChaosRecoverySingleController`` on this
    world: an ``@elastic.run`` loop whose steps allreduce, fold the sum
    into ``accum``, add one to a linear layer's weight and commit;
    ``collective:step=fault_step`` fires once, and the loop rolls back,
    backs off (the sleep is recorded, not slept), re-inits on its own
    device over a new rendezvous and finishes."""
    import json as _json

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import basics, faults
    from horovod_tpu_torch.elastic import TorchState, run
    from horovod_tpu_torch.elastic import state as state_mod
    from horovod_tpu_torch.obs import flight, metrics

    def resets():
        fam = metrics.registry().snapshot().get(
            "hvd_tpu_elastic_resets_total", [])
        return sum(s["value"] for s in fam
                   if dict(s["labels"]).get("kind") == "rollback")

    sleeps = []
    saved_sleep = state_mod.time.sleep
    state_mod.time.sleep = sleeps.append
    try:
        with _owned_group(store):
            gen0, before = basics.rendezvous_generation(), resets()
            model = torch.nn.Linear(2, 1, bias=False)
            with torch.no_grad():
                model.weight.zero_()
            state = TorchState(model=model, step=0, accum=0.0)
            meta = {"tries": 0, "at_retry": None}

            @run
            def train(state):
                meta["tries"] += 1
                if meta["tries"] == 2:
                    meta["at_retry"] = (int(state.step), float(state.accum))
                while int(state.step) < total:
                    s = int(state.step)
                    out = hvd.allreduce(torch.full((2,), float(s)),
                                        op=hvd.Sum)
                    state.accum = float(state.accum) + float(out[0])
                    with torch.no_grad():
                        state.model.weight.add_(1.0)
                    state.step = s + 1
                    state.commit()
                return state

            with faults.inject(f"collective:step={fault_step},seed={seed}"):
                train(state)
                fired = faults.history()
            dump = flight.last_dumps()[-1]
            with open(dump) as f:
                doc = _json.load(f)
            return {"fired": fired, "tries": meta["tries"],
                    "at_retry": meta["at_retry"],
                    "accum": float(state.accum),
                    "weight": state.model.weight.detach().numpy().copy(),
                    "generations": (gen0, basics.rendezvous_generation()),
                    "device": str(hvd.device()),
                    "backend": hvd.basics.backend(),
                    "resets": resets() - before, "sleeps": sleeps,
                    "dump": {"reason": doc["reason"],
                             "fault_spec": doc["fault_spec"],
                             "fault_history": doc["fault_history"]}}
    finally:
        state_mod.time.sleep = saved_sleep


def elastic_sync_residual(seed: int) -> dict:
    """``TorchState.sync`` over a DistributedOptimizer on the int8+EF
    wire, each rank from its own weights and its own residual: after the
    sync every rank holds rank 0's parameters, AdamW state and residual
    (the reference broadcasts its whole ``opt_state``)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.elastic import TorchState

    torch.manual_seed(seed + hvd.rank())
    model = torch.nn.Linear(4, 3)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-2),
        named_parameters=model.named_parameters(),
        compression=hvd.Compression.int8, error_feedback=True)
    opt.zero_grad()
    model(torch.randn(8, 4)).pow(2).mean().backward()
    opt.synchronize()        # this rank's own residual, reduced grads
    opt.optimizer.step()
    own = {k: v.numpy().copy() for k, v in opt.residual.items()}
    state = TorchState(model=model, optimizer=opt, step=hvd.rank())
    state.sync()
    return {"own": own, "step": int(state.step),
            "residual": {k: v.numpy().copy() for k, v in opt.residual.items()},
            "params": {k: v.detach().numpy().copy()
                       for k, v in model.state_dict().items()},
            "exp_avg": [opt.state[p]["exp_avg"].numpy().copy()
                        for p in model.parameters()]}


def joined_mean(rows: np.ndarray, batch_size: int) -> dict:
    """``JoinedBatchIterator`` over this rank's ragged rows and
    ``global_masked_mean`` of them (and its gradient) over the world."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import data

    it = data.JoinedBatchIterator(rows, batch_size=batch_size)
    out = {"len": len(it), "local": it.local_steps, "means": [],
           "grads": [], "masks": []}
    for (batch,), mask in it:
        x = torch.from_numpy(batch).requires_grad_(True)
        m = data.global_masked_mean(x.sum(axis=1), mask)
        m.backward()
        out["means"].append(float(m))
        out["grads"].append(x.grad.numpy().copy())
        out["masks"].append(np.asarray(mask))
    out["negotiated"] = data.negotiate_steps(hvd.rank() + 1)
    return out


def global_mean_step(x: np.ndarray, y: np.ndarray, mask: np.ndarray,
                     lr: float) -> dict:
    """One SGD step of ``make_train_step`` (op Average) on this rank's
    rows of a ragged batch, the loss ``global_masked_mean`` of the
    per-row squared errors: the join recipe."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import data

    model = torch.nn.Linear(x.shape[1], y.shape[1], bias=False)
    with torch.no_grad():
        model.weight.zero_()

    def loss_fn(m, batch):
        xb, yb, mb = batch
        per_row = ((m(xb) - yb) ** 2).sum(dim=-1)
        return data.global_masked_mean(per_row, mb)

    step = hvd.make_train_step(loss_fn,
                               torch.optim.SGD(model.parameters(), lr=lr))
    loss = step(model, (_my_rows(x), _my_rows(y), _my_rows(mask)))
    return {"w": model.weight.detach().numpy().copy(), "loss": float(loss)}


def dcn_chaos(store: str, fault_step: int, total: int,
              seed: int = 0) -> dict:
    """The counterpart of ``tests/test_topo.py::TestChaosDcnRecovery`` on
    this world: an ``@elastic.run`` loop whose step ``s`` reduces a
    per-rank constant ``s`` over the hierarchical schedule of a 2 x 2
    simulated mesh; ``dcn:step=fault_step`` fails the cross-pod exchange
    of that step once, the loop rolls back, re-inits over a new
    rendezvous and converges to the flat total."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import faults
    from horovod_tpu_torch.elastic import TorchState, run
    from horovod_tpu_torch.elastic import state as state_mod
    from horovod_tpu_torch.topo import simulate

    saved_sleep = state_mod.time.sleep
    state_mod.time.sleep = lambda s: None
    try:
        with _owned_group(store):
            sim = simulate.simulated_mesh(2, 2)
            model = torch.nn.Linear(2, 1, bias=False)
            with torch.no_grad():
                model.weight.zero_()
            state = TorchState(model=model, step=0, accum=0.0)
            meta = {"tries": 0, "at_retry": None}

            @run
            def train(state):
                meta["tries"] += 1
                if meta["tries"] == 2:
                    meta["at_retry"] = (int(state.step), float(state.accum))
                while int(state.step) < total:
                    s = int(state.step)
                    stack = np.full((hvd.size(), 2), float(s), np.float32)
                    out = simulate.run_allreduce(sim, stack,
                                                 algo="hierarchical")
                    state.accum = float(state.accum) + float(out[0, 0])
                    with torch.no_grad():
                        state.model.weight.add_(1.0)
                    state.step = s + 1
                    state.commit()
                return state

            with faults.inject(f"dcn:step={fault_step},seed={seed}"):
                train(state)
                fired = [h for h in faults.history() if h[0] == "dcn"]
            return {"fired": fired, "tries": meta["tries"],
                    "at_retry": meta["at_retry"],
                    "accum": float(state.accum),
                    "weight": state.model.weight.detach().numpy().copy()}
    finally:
        state_mod.time.sleep = saved_sleep


# --- the host runtime: native coordinator, timeline, cross-process monitor ----

def _coordinator():
    """A native Coordinator over this world, rank 0 serving on a port it
    broadcasts (separate from the session's monitor)."""
    import torch.distributed as dist
    from horovod_tpu_torch.native import runtime as rt

    rank, n = dist.get_rank(), dist.get_world_size()
    box = [None]
    coord = None
    if rank == 0:
        coord = rt.Coordinator(0, n, port=0, timeout_s=30.0)
        box = [coord.bound_port]
    dist.broadcast_object_list(box, src=0)
    if rank:
        coord = rt.Coordinator(rank, n, port=box[0], timeout_s=30.0)
    return coord


def _responses(resps) -> list:
    return [(r.op, r.dtype, r.total_bytes, r.root_rank, list(r.names))
            for r in resps]


def native_coordinator(scenario: str) -> list:
    """One rank of ``test_native_runtime.py``'s coordinator cases, here
    across processes: the responses of each negotiate cycle."""
    import time

    import torch.distributed as dist
    from horovod_tpu_torch.native.runtime import Request

    rank = dist.get_rank()
    coord = _coordinator()
    out: list = []
    try:
        if scenario == "negotiate":
            out.append(_responses(coord.negotiate(
                [Request(rank=rank, name="g0", size_bytes=64)]
                if rank < 2 else [])))
            out.append(_responses(coord.negotiate(
                [Request(rank=rank, name="g0", size_bytes=64)]
                if rank == 2 else [])))
        elif scenario == "fusion":
            for _ in range(4):
                out.append(_responses(coord.negotiate(
                    [Request(rank=rank, name=f"grad{i}", size_bytes=100)
                     for i in range(3)])))
            out.append(coord.cache_hits())
        elif scenario == "barrier":
            if rank == 1:
                time.sleep(0.3)
            t0 = time.monotonic()
            coord.barrier()
            out.append(time.monotonic() - t0)
        elif scenario == "mismatch":
            try:
                coord.negotiate([Request(
                    rank=rank, name="g",
                    dtype="float32" if rank == 0 else "bfloat16")])
                out.append("ok")
            except RuntimeError:
                out.append("error")
    finally:
        coord.shutdown()
        coord.close()
    return out


def monitor_state() -> dict:
    """The session's cross-process monitor, started by ``init``: live,
    cycling over the native coordinator."""
    import time

    import horovod_tpu_torch as hvd

    mon = hvd.peek("cross_monitor")
    if mon is None:
        return {"running": False}
    deadline = time.monotonic() + 20
    while mon._coord.cycles < 2 and time.monotonic() < deadline:
        time.sleep(0.1)
    return {"running": mon._thread.is_alive(), "cycles": mon._coord.cycles,
            "failure": mon.failure}


def missing_rank_warning(warn_after_s: float) -> list:
    """A monitor of its own (window ``warn_after_s``): every rank
    dispatches ``both``, rank 0 alone ``only_rank0``; the warnings this
    rank's monitor logs."""
    import logging
    import time

    from horovod_tpu_torch.utils.cross_stall import CrossProcessMonitor

    import torch.distributed as dist

    records: list = []

    class _Capture(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    handler = _Capture()
    log = logging.getLogger("horovod_tpu_torch.utils.cross_stall")
    log.addHandler(handler)
    mon = CrossProcessMonitor(_coordinator(), warn_after_s=warn_after_s,
                              interval_s=0.1)
    try:
        mon.record_dispatch("both")
        if dist.get_rank() == 0:
            mon.record_dispatch("only_rank0")
        time.sleep(warn_after_s + 1.5)
        dist.barrier()
    finally:
        mon.stop()
        log.removeHandler(handler)
    return records


def timeline_program(path: str, program: list) -> list:
    """Run ``program`` (``(call, kwargs)`` pairs of the eager API, tensors
    given as numpy arrays) with a timeline open on ``path``; returns this
    rank's ``(tensor, phase, args)`` collective events, in file order."""
    import json

    import horovod_tpu_torch as hvd

    def tensor(v):
        return torch.from_numpy(v) if isinstance(v, np.ndarray) else v

    hvd.start_timeline(path)
    try:
        for call, kwargs in program:
            kwargs = {k: ([tensor(x) for x in v] if isinstance(v, list)
                          else tensor(v)) for k, v in kwargs.items()}
            getattr(hvd, call)(**kwargs)
    finally:
        hvd.stop_timeline()
    with open(path if hvd.rank() == 0 else f"{path}.rank{hvd.rank()}") as f:
        events = json.load(f)
    return [(e["args"]["tensor"], e["name"],
             {k: v for k, v in e["args"].items() if k != "tensor"})
            for e in events if e.get("cat") == "collective"]


def run_func_body(scale: float, bias: float = 0.0) -> dict:
    """``hvd.run``'s payload in ``tests/test_torch_port_run_func.py``: a
    module-level function, so the standard pickle takes it by reference.
    Joins the world on the CPU and sums ``rank + 1`` over it."""
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    out = hvd.allreduce(torch.full((1, 2), hvd.rank() + 1.0), op=hvd.Sum,
                        name="run_func")
    return {"rank": hvd.rank(), "size": hvd.size(),
            "cross": [hvd.cross_rank(), hvd.cross_size()],
            "sum": float(out[0, 0]) * scale + bias,
            "cloudpickle": "cloudpickle" in sys.modules}


# --- the step's collective-sequence check (analysis/step_check.py) -------------

def step_cases(microbatches: int) -> dict:
    """This rank's recordings of the shipped factories on the live world
    (``step_check._record_cases``), with the entries as lists."""
    from horovod_tpu_torch.analysis import step_check

    cases = step_check._record_cases(microbatches)
    return {k: ([list(e) for e in v] if isinstance(v, list) else v)
            for k, v in cases.items()}


def step_checks(microbatches: int) -> list:
    """``run_step_checks`` on the live world: every rank records, the
    sequences are gathered and judged."""
    from horovod_tpu_torch.analysis import step_check

    return [f.as_dict()
            for f in step_check.run_step_checks(microbatches=microbatches)]


def rank_dependent_plan() -> list:
    """A deliberately rank-divergent fused plan: rank 0 builds the
    overlapped reduce-scatter + all-gather wire, every other rank the
    plain allreduce — the two rendezvous differently.  Run it in a
    process with no world: the check then simulates the ranks (on a live
    world the mismatched collectives would fail the world itself)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.analysis import step_check as sc

    def bad():
        model, opt, batch = sc._toy_problem()
        if hvd.rank() == 0:
            return (hvd.make_train_step(sc._mse, opt, microbatches=2,
                                        overlap=True), model, batch)
        return hvd.make_train_step(sc._mse, opt), model, batch

    return [f.as_dict() for f in sc.check_step_rank_consistency(bad)]


def overlap_recording(microbatches: int, threshold: int,
                      compression: str) -> dict:
    """One overlap step of a four-leaf model whose fusion threshold cuts
    it into several buckets, recorded; with the planner's bucket count
    and the recorder's wire counts."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.analysis import step_check as sc
    from horovod_tpu_torch.ops import fusion

    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(64, 48),
                                torch.nn.Linear(48, 32))
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    batch = (torch.ones(12, 64), torch.ones(12, 32))
    step = hvd.make_train_step(
        sc._mse, opt, microbatches=microbatches, overlap=True,
        fusion_threshold=threshold,
        compression=getattr(hvd.Compression, compression))
    with sc.record_collectives() as seq:
        step(model, batch)
    _, leaves = fusion.tree_flatten(dict(model.named_parameters()))
    plan = fusion.plan_overlap_buckets(leaves, threshold,
                                       world_size=hvd.size())
    return {"seq": [list(e) for e in seq], "buckets": len(plan.members),
            "counts": list(sc.wire_counts(seq, compression))}


# --- the framework bindings (horovod_tpu_torch.torch, .tensorflow) ------------

def _binding_gpt(config: dict):
    from horovod_tpu_torch.models import GPT, GPTConfig

    cfg = GPTConfig(**{**config, "dtype": getattr(torch, config["dtype"])})
    return GPT(cfg, device="cpu", seed=0)


def _params_np(model) -> dict:
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


def binding_routes(config: dict, tokens: np.ndarray, steps: int,
                   compression: str = "none", num_groups: int = 0,
                   fused: bool = True) -> dict:
    """``steps`` AdamW steps of a narrow GPT (seed 0) through the torch
    binding's hook-driven ``DistributedOptimizer``, each recorded
    (``step_check.record_collectives``), then (``fused``) the same steps
    from the same weights through the core's ``make_train_step``; this
    rank trains on its rows of ``tokens``.  The losses are averaged over
    the ranks on both routes."""
    import horovod_tpu_torch as core
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.analysis import step_check as sc

    mine = _my_rows(tokens)
    batch = (mine[:, :-1], mine[:, 1:])
    model = _binding_gpt(config)
    loss_fn = core.models.lm_loss_fn(model)
    opt = hvd.DistributedOptimizer(
        _adamw(model.parameters()), named_parameters=model.named_parameters(),
        compression=getattr(hvd.Compression, compression),
        num_groups=num_groups)
    losses, seqs = [], []
    for _ in range(steps):
        with sc.record_collectives() as seq:
            opt.zero_grad()
            loss = loss_fn(model, batch)
            loss.backward()
            opt.step()
        seqs.append([list(e) for e in seq])
        losses.append(float(hvd.allreduce(loss.detach())))
    out = {"hook": {"losses": losses, "params": _params_np(model)},
           "seqs": seqs, "hooks": len(opt._hook_handles)}
    if fused:
        ref = _binding_gpt(config)
        step = core.make_train_step(core.models.lm_loss_fn(ref),
                                    _adamw(ref.parameters()),
                                    compression=core.Compression.none)
        out["fused"] = {"losses": [float(step(ref, batch))
                                   for _ in range(steps)],
                        "params": _params_np(ref)}
    return out


def binding_sync_bn(x: np.ndarray, weight: np.ndarray, bias: np.ndarray,
                    upstream: np.ndarray) -> dict:
    """The torch binding's ``SyncBatchNorm`` over this rank's rows of
    ``x``: one train-mode forward and the backward of ``sum(y ·
    upstream)`` (this rank's rows of ``upstream``)."""
    import horovod_tpu_torch.torch as hvd

    xs = _rows(x).requires_grad_(True)
    sbn = hvd.SyncBatchNorm(x.shape[1]).to(xs.dtype)
    with torch.no_grad():
        sbn.weight.copy_(torch.from_numpy(weight))
        sbn.bias.copy_(torch.from_numpy(bias))
    y = sbn(xs)
    (y * _rows(upstream)).sum().backward()
    return {"y": y.detach().numpy(), "x_grad": xs.grad.numpy(),
            "w_grad": sbn.weight.grad.numpy(),
            "b_grad": sbn.bias.grad.numpy(),
            "running_mean": sbn.running_mean.numpy(),
            "running_var": sbn.running_var.numpy()}


def keras_fit(x: np.ndarray, y: np.ndarray, weights: list, lr: float,
              epochs: int, batch_size: int) -> list:
    """A Keras MLP from ``weights`` fit on this rank's rows of ``(x, y)``
    through the TF binding's ``DistributedOptimizer`` (SGD), in order;
    its weights after."""
    import tensorflow as tf

    import horovod_tpu_torch.tensorflow as hvd

    model = keras_mlp(x.shape[1], y.shape[1])
    model.set_weights(weights)
    model.compile(optimizer=hvd.DistributedOptimizer(
        tf.keras.optimizers.SGD(lr)), loss="mse", jit_compile=False)
    model.fit(_my_rows(x).numpy(), _my_rows(y).numpy(), epochs=epochs,
              batch_size=batch_size, shuffle=False, verbose=0)
    return [np.array(w) for w in model.get_weights()]


def import_tensorflow() -> str:
    """TF and the port's TF binding (whose import loads the TF-XLA
    adapter, before this rank compiles anything)."""
    import tensorflow as tf
    import horovod_tpu_torch.tensorflow  # noqa: F401

    return tf.__version__


def keras_mlp(d_in: int, d_out: int):
    """The Keras MLP of the bindings' tests: ``d_in → 16 (tanh) →
    d_out``."""
    import tensorflow as tf

    model = tf.keras.Sequential([
        tf.keras.Input(shape=(d_in,)),
        tf.keras.layers.Dense(16, activation="tanh"),
        tf.keras.layers.Dense(d_out)])
    return model


TF_XLA_DTYPES = ("float32", "float64", "float16", "bfloat16", "int32",
                 "int64")
TF_XLA_OPS = ("Sum", "Average", "Min", "Max", "Product")
# (prescale, postscale) of the float cases: powers of two and 3, exact on
# the small integers of the test in every float dtype.
TF_XLA_SCALES = {"Sum": (0.5, 3.0), "Average": (2.0, 0.25)}


def tf_xla_allreduce(a: np.ndarray, b: np.ndarray,
                     v: np.ndarray, w: np.ndarray) -> dict:
    """Rank 0 holds ``a`` and ``v``, rank 1 ``b`` and ``w``.  Under
    ``tf.function(jit_compile=True)`` and eagerly: the dense allreduce of
    every dtype × op, the float dtypes' pre- and post-scaled Sum and
    Average, one mixed-dtype grouped Sum and Average, the Adasum of
    ``v`` (f32) alone and grouped with its f64 copy; the adapter ops in
    the compiled graph.  bfloat16 results come back as float32 (exact)."""
    import tensorflow as tf
    import horovod_tpu_torch.tensorflow as hvd

    mine = a if hvd.rank() == 0 else b
    vec = v if hvd.rank() == 0 else w

    def step(x, y):
        out = {}
        for dtype in TF_XLA_DTYPES:
            t = tf.cast(x, dtype)
            for op in TF_XLA_OPS:
                out[f"{dtype}-{op}"] = hvd.allreduce(
                    t, op=getattr(hvd, op), name=f"{dtype}-{op}")
            if dtype.startswith("float") or dtype == "bfloat16":
                for op, (pre, post) in TF_XLA_SCALES.items():
                    out[f"{dtype}-{op}-scaled"] = hvd.allreduce(
                        t, op=getattr(hvd, op), prescale_factor=pre,
                        postscale_factor=post, name=f"{dtype}-{op}-scaled")
        for op in ("Sum", "Average"):
            group = hvd.grouped_allreduce(
                [tf.cast(x, d) for d in TF_XLA_DTYPES], op=getattr(hvd, op),
                name=f"mixed-{op}")
            out.update({f"mixed-{op}-{d}": g
                        for d, g in zip(TF_XLA_DTYPES, group)})
        out["adasum"] = hvd.allreduce(y, op=hvd.Adasum, name="adasum")
        g32, g64 = hvd.grouped_allreduce([y, tf.cast(y, tf.float64)],
                                         op=hvd.Adasum, name="adasum-grouped")
        out.update({"adasum-grouped-float32": g32,
                    "adasum-grouped-float64": g64})
        return out

    def host(outs):
        return {k: (t.numpy().astype(np.float32) if t.dtype == tf.bfloat16
                    else t.numpy()) for k, t in outs.items()}

    x, y = tf.constant(mine), tf.constant(vec)
    f = tf.function(step, jit_compile=True)
    ops = sorted({op.type for op in f.get_concrete_function(
        x, y).graph.get_operations() if op.type.startswith("HvdTpu")})
    return {"ops": ops, "jit": host(f(x, y)), "eager": host(step(x, y))}


def mxnet_trainer(grad: np.ndarray, x: np.ndarray, lr: float) -> dict:
    """Through the port's MXNet binding on the reference's API stand-in
    (``tests/mxnet_shim.py``): one ``DistributedTrainer`` SGD step on this
    rank's gradient ``grad * (rank + 1)`` from a zero weight, the
    in-place Sum of ``x * (rank + 1)`` and the broadcast of rank 0's
    ``x``."""
    import mxnet_shim

    mx = mxnet_shim.install()
    try:
        import horovod_tpu_torch.mxnet as hvd

        k = hvd.rank() + 1
        p = mx.Parameter("w", np.zeros_like(grad), grad * k)
        trainer = hvd.DistributedTrainer({"w": p}, "sgd",
                                         {"learning_rate": lr})
        trainer.step(batch_size=1)
        summed = mx.nd.array(x * k)
        hvd.allreduce_(summed, op=hvd.Sum)
        sent = mx.nd.array(x if k == 1 else x * 0)
        return {"weight": p.list_data()[0].asnumpy(),
                "sum": summed.asnumpy(),
                "broadcast": hvd.broadcast(sent, root_rank=0).asnumpy()}
    finally:
        mxnet_shim.uninstall()
        for m in list(sys.modules):
            if m.startswith("horovod_tpu_torch.mxnet"):
                del sys.modules[m]


# --- the spark and Ray control planes' task bodies (shipped by reference) -------

TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                 "LOCAL_RANK", "LOCAL_WORLD_SIZE", "GROUP_RANK",
                 "GROUP_WORLD_SIZE")


def launched_rank(x: np.ndarray) -> dict:
    """A rank started by ``spark.run`` or ``RayExecutor`` (the session is
    up): torchrun's variables it was given, the session's facts, and the
    Sum of ``x * (rank + 1)``."""
    import torch.distributed as dist
    import horovod_tpu_torch as hvd

    k = hvd.rank() + 1
    out = hvd.allreduce(torch.from_numpy(x * k), op=hvd.Sum, name="launched")
    return {"env": {v: os.environ.get(v) for v in TORCHRUN_VARS},
            "rank": hvd.rank(), "size": hvd.size(),
            "local_rank": hvd.local_rank(), "local_size": hvd.local_size(),
            "device": str(hvd.device()), "backend": dist.get_backend(),
            "pid": os.getpid(), "sum": out.numpy()}


def failing_rank(message: str) -> int:
    """Raises on rank 1 (after both ranks joined the world)."""
    import horovod_tpu_torch as hvd

    if hvd.rank() == 1:
        raise ValueError(message)
    return hvd.rank()


def rank_and_pid() -> tuple:
    import horovod_tpu_torch as hvd

    return hvd.rank(), os.getpid()


def session_device() -> dict:
    """The device this rank's ``init`` chose and the cards it sees."""
    import horovod_tpu_torch as hvd

    return {"rank": hvd.rank(), "local_rank": hvd.local_rank(),
            "device": str(hvd.device()),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}
