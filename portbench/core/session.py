"""One rank of one run: set-up, the checked steps, the window and the
trace; the reference's readings; the summaries gathered to rank 0.

The program is the port's data-parallel step, built as its users build
it: the model on this rank's card holding the benchmark's weights,
``hvd.broadcast_parameters``, ``hvd.DistributedOptimizer`` around
``torch.optim.AdamW`` on the cell's wire, ``hvd.make_train_step``.  Set-up
drives that one step object through the first steps (``checked_steps``,
on batches whose rows all differ) and records what the reference is held
to; the same object then runs the timing steps and the window.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import math
import os
import statistics
import sys
import time
from typing import List

import torch

from . import judge
from .feed import Pool
from .spec import Cell, family_module, reference_module
from .weights import make_weights

FORBIDDEN = ("jax", "jaxlib", "flax", "horovod_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is, as a whole, one of
    :data:`FORBIDDEN` (``horovod_tpu_torch`` is not ``horovod_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Program:
    """The step object and everything it holds."""
    model: torch.nn.Module
    inner: torch.optim.Optimizer
    step: object
    batches: list
    names: List[str]


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build_program(cell: Cell, seed: int, rank: int, world: int, dev,
                  pool: Pool) -> Program:
    import horovod_tpu_torch as hvd

    fam = family_module(cell)
    cfg = cell.config
    weights = make_weights(fam.leaf_specs(cfg), seed, dev)
    model, loss_fn = fam.build(cfg, weights, dev)
    del weights
    if world > 1:
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    o = cfg["optimizer"]
    inner = torch.optim.AdamW(model.parameters(), lr=o["lr"],
                              betas=tuple(o["betas"]), eps=o["eps"],
                              weight_decay=o["weight_decay"])
    wire = cell.workload["wire"]
    opt = hvd.DistributedOptimizer(
        inner, compression=getattr(hvd.Compression, wire["compression"]),
        error_feedback=bool(wire["error_feedback"]))
    step = hvd.make_train_step(loss_fn, opt)
    return Program(model=model, inner=inner, step=step,
                   batches=pool.rank_batches(rank),
                   names=[n for n, _ in model.named_parameters()])


def checked_steps(cell: Cell, prog: Program, seed: int, dev) -> dict:
    """Run the first ``checked_steps`` steps and read what the reference
    is compared on: each step's loss (averaged over the ranks by the
    step), each leaf's first gradient as AdamW got it (its first moment
    after one step is ``(1 - beta1) g``), each leaf's change after the
    last step (the weights made again from the seed)."""
    params = dict(prog.model.named_parameters())
    beta1 = float(cell.config["optimizer"]["betas"][0])
    parts = family_module(cell).leaf_parts(cell.config)
    losses, grad_norms = [], None
    for s in range(int(cell.workload["checked_steps"])):
        losses.append(prog.step(prog.model, prog.batches[s % len(prog.batches)]))
        if s == 0:
            moments = {n: prog.inner.state.get(params[n], {}).get(
                "exp_avg", torch.zeros_like(params[n])) for n in prog.names}
            grad_norms = judge.part_norms(moments, parts, 1.0 / (1.0 - beta1))
            del moments
    w0 = make_weights(family_module(cell).leaf_specs(cell.config), seed, dev)
    with torch.no_grad():
        change = judge.part_norms({n: params[n] - w0[n] for n in prog.names},
                                  parts)
    del w0
    return {"losses": [float(x) for x in losses], "grad_norms": grad_norms,
            "change_norms": change}


def reference_readings(cell: Cell, seed: int, world: int, dev, pool: Pool,
                       mm=None, attend=None) -> dict:
    """The reference's first steps from the same weights and batches
    (every rank's), in float32, or with ``mm`` as its product and
    ``attend`` as its attention.  Each
    rank's batch goes through in blocks of ``reference_rows`` rows, so
    that float32 activations fit; every row weighs the same in the loss,
    so the mean over blocks is the mean over the batch."""
    from portbench.reference import train

    fam = family_module(cell)
    weights = make_weights(fam.leaf_specs(cell.config), seed, dev)
    rows = int(cell.workload["reference_rows"])
    steps = [[tuple(t[i:i + rows] for t in pool.batch(s, r))
              for r in range(world) for i in range(0, pool.rows, rows)]
             for s in range(int(cell.workload["checked_steps"]))]
    kwargs = {} if mm is None else {"mm": mm}
    loss = reference_module(cell).loss
    if attend is not None:
        loss = functools.partial(loss, attend=attend)
    out = train.run(loss, cell.config, weights, steps,
                    fam.leaf_parts(cell.config), **kwargs)
    del weights
    return out


def free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def agree_steps(estimate_s: float, seconds: float, world: int, dev) -> int:
    """The window's step count: ``seconds`` over the slowest rank's step
    estimate, the same on every rank."""
    if world > 1:
        import torch.distributed as dist

        t = torch.tensor([estimate_s], dtype=torch.float64, device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        estimate_s = float(t)
    return max(1, math.ceil(seconds / estimate_s))


def window(prog: Program, first: int, n: int, dev) -> dict:
    """``n`` steps from pool batch ``first``: the wall time ending on a
    synchronise, each step's device time between CUDA events recorded
    after it (read after the window), each step call's host time, and
    the losses (finite-checked after the window)."""
    cuda = dev.type == "cuda"
    marks = ([torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
             if cuda else [])
    host, losses, ends = [], [], []
    batches, k = prog.batches, first
    sync(dev)
    t0 = time.perf_counter()
    if cuda:
        marks[0].record()
    for i in range(n):
        h = time.perf_counter()
        losses.append(prog.step(prog.model, batches[k % len(batches)]))
        k += 1
        h1 = time.perf_counter()
        host.append(h1 - h)
        if cuda:
            marks[i + 1].record()
        else:
            ends.append(h1)
    sync(dev)
    wall = time.perf_counter() - t0
    if cuda:
        step_s = [marks[i].elapsed_time(marks[i + 1]) / 1e3 for i in range(n)]
    else:
        step_s = [b - a for a, b in zip([t0] + ends[:-1], ends)]
    failed = int((~torch.isfinite(torch.stack(losses).float())).sum())
    return dict(steps=n, wall_s=wall, step_s=step_s, host_s=host,
                failed=failed, next=k)


def _profiled(prog: Program, first: int, n: int, dev, path: str,
              host_ops: bool):
    from torch.profiler import ProfilerActivity, profile, record_function

    from .trace import Trace

    cuda = dev.type == "cuda"
    acts = ([ProfilerActivity.CUDA] if cuda else []) + (
        [ProfilerActivity.CPU] if host_ops or not cuda else [])
    batches = prog.batches
    sync(dev)
    with profile(activities=acts) as prof:
        with record_function("portbench.window"):
            for i in range(n):
                with record_function("portbench.step"):
                    prog.step(prog.model, batches[(first + i) % len(batches)])
            sync(dev)
    prof.export_chrome_trace(path)
    try:
        return Trace.load(path)
    finally:
        os.remove(path)


def traced_steps(prog: Program, first: int, n: int, dev, path: str):
    """Two traces of ``n`` steps each: the device's alone (CUDA activity
    only: the host runs at its own pace, so busy and idle time, kernel
    times and the breakdown come from it), then the device's with the
    host's ops and the benchmark's ``portbench.window`` and
    ``portbench.step`` spans (the host runs slower under it; it links
    kernels to the host op that launched them)."""
    return (_profiled(prog, first, n, dev, path, host_ops=False),
            _profiled(prog, first + n, n, dev, path, host_ops=True))


def start(device: str):
    """Join the port's world (NCCL on this rank's card, or gloo on the
    CPU in the tests) with TF32 off: the configurations' float32 stays
    float32.  Returns the rank's device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import horovod_tpu_torch as hvd

    if device == "cuda":
        hvd.ops.build_kernels()
        hvd.init()
    else:
        hvd.init(device="cpu")
    return hvd.device()


def run_rank(cell: Cell, seed: int, seconds: float, trace: bool, rank: int,
             world: int, device: str, t0: float, scratch: str) -> dict:
    """One rank's run up to the reference, in the port's world (left
    for the caller to shut down).  Returns its numbers, with what the
    reference needs: the checked steps' readings (``checked``), the
    batches (``pool``) and the device."""
    dev = start(device)
    w = cell.workload
    fam = family_module(cell)
    pool = Pool(cell.traffic, fam.vocab_size(cell.config), seed, world, dev)
    prog = build_program(cell, seed, rank, world, dev, pool)
    mine = checked_steps(cell, prog, seed, dev)
    k = int(w["checked_steps"])
    timed = []
    for _ in range(int(w["timing_steps"])):
        sync(dev)
        t = time.perf_counter()
        prog.step(prog.model, prog.batches[k % len(prog.batches)])
        sync(dev)
        timed.append(time.perf_counter() - t)
        k += 1
    n = agree_steps(statistics.median(timed), seconds, world, dev)
    sync(dev)
    setup_s = time.time() - t0
    win = window(prog, k, n, dev)
    out = dict(rank=rank, setup_s=setup_s, window=win)
    if trace:
        out["trace"], out["host_trace"] = traced_steps(
            prog, win["next"], int(w["trace_steps"]), dev,
            f"{scratch}/trace{rank}.json")
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                         if dev.type == "cuda" else 0)
    out["leaf_numels"] = [p.numel() for p in prog.model.parameters()
                          if p.requires_grad]
    del prog
    free(dev)
    out.update(checked=mine, pool=pool, device=dev)
    return out


def gather(mine: dict, world: int):
    """Every rank's summary on rank 0, in rank order, over the port's
    process group (None on the other ranks)."""
    if world == 1:
        return [mine]
    import torch.distributed as dist

    ranks = [None] * world if dist.get_rank() == 0 else None
    dist.gather_object(mine, ranks, dst=0)
    return ranks


def device_name(dev_type: str) -> str:
    return torch.cuda.get_device_name(0) if dev_type == "cuda" else "cpu"
