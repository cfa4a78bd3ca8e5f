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
        "alltoall": hvd.alltoall(t, splits=splits).numpy(),
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
              env: dict = None) -> dict:
    """``steps`` data-parallel AdamW steps of the port's GPT from the
    given flax-layout params; this rank trains on its half of the global
    batch.  ``wrap=False`` hands the step a plain torch optimizer, so the
    step itself allreduces; ``zero=True`` takes ZeRO-1 steps
    (``make_zero_train_step``) and also returns the shapes of this
    rank's optimizer state.  ``env`` sets knobs (``HOROVOD_*``) for these
    steps only."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import GPT, GPTConfig, load_jax_params

    cfg = GPTConfig(**{**config, "dtype": getattr(torch, config["dtype"])})
    model = GPT(cfg)
    load_jax_params(model, params)
    comp = getattr(hvd.Compression, compression)
    loss_fn = hvd.models.lm_loss_fn(model)
    if zero:
        step = hvd.make_zero_train_step(
            loss_fn, _adamw, compression=comp, error_feedback=error_feedback)
    elif wrap:
        step = hvd.make_train_step(loss_fn, hvd.DistributedOptimizer(
            _adamw(model.parameters()), compression=comp,
            error_feedback=error_feedback))
    else:
        step = hvd.make_train_step(loss_fn, _adamw(model.parameters()),
                                   compression=comp)
    mine = _my_rows(tokens)
    batch = (mine[:, :-1], mine[:, 1:])
    with _knobs(env or {}):
        losses = [float(step(model, batch)) for _ in range(steps)]
    out = {"losses": losses,
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
