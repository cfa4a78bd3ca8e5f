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
        for r in range(self.n):
            extra = per_rank[r] if per_rank is not None else {}
            self.tasks[r].put((name, {**kwargs, **extra}))
        out = [None] * self.n
        errors = []
        for _ in range(self.n):
            try:
                rank, ok, value = self.results.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(f"{name}: no answer within {timeout} s")
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
