"""A gloo world of worker processes for the PyTorch port's tests.

The workers run functions of this module by name, on the CPU, through
``horovod_tpu_torch`` after ``init(device="cpu")``.  This module's top
level imports only the standard library, numpy and torch: the JAX
reference is computed in the parent test process and passed in as numpy
arrays.  One world is spawned per test module (``World``) and reused by
its tests.
"""

from __future__ import annotations

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


def train_gpt(config: dict, params: dict, tokens: np.ndarray,
              compression: str, error_feedback: bool, steps: int,
              wrap: bool = True) -> dict:
    """``steps`` data-parallel AdamW steps of the port's GPT from the
    given flax-layout params; this rank trains on its half of the global
    batch (rows ``[rank * b, (rank + 1) * b)``).  ``wrap=False`` hands
    the step a plain torch optimizer, so the step itself allreduces."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import GPT, GPTConfig, load_jax_params

    cfg = GPTConfig(**{**config, "dtype": getattr(torch, config["dtype"])})
    model = GPT(cfg)
    load_jax_params(model, params)
    comp = getattr(hvd.Compression, compression)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    loss_fn = hvd.models.lm_loss_fn(model)
    if wrap:
        step = hvd.make_train_step(loss_fn, hvd.DistributedOptimizer(
            opt, compression=comp, error_feedback=error_feedback))
    else:
        step = hvd.make_train_step(loss_fn, opt, compression=comp)
    b = tokens.shape[0] // hvd.size()
    mine = torch.from_numpy(tokens[hvd.rank() * b:(hvd.rank() + 1) * b])
    batch = (mine[:, :-1], mine[:, 1:])
    losses = [float(step(model, batch)) for _ in range(steps)]
    return {"losses": losses,
            "params": {n: p.detach().numpy().copy()
                       for n, p in model.named_parameters()}}
