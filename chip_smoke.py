#!/usr/bin/env python3
"""Smoke run of horovod_tpu_torch on one CUDA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds the kernels from
   ``horovod_tpu_torch/csrc`` (one nvcc per source, in parallel) and
   prints the build time.
2. Kernel phase: each hand-written kernel against its plain PyTorch
   version, on the card, at the shapes the main path gives it.  The int8
   kernels must match bit for bit, and on rows holding NaN or Inf as
   well; flash attention within the bf16 tolerance (3e-2 on O, 1e-4 on
   lse) and, row by row, within 1e-2 of the row's largest |O|.  Prints
   each kernel's median time, its plain version's, its bound and, where
   one PyTorch call computes the same function, that call's time as a
   yardstick the port never calls: ``q * s[:, None]`` for the
   dequantize, ``F.scaled_dot_product_attention`` for flash attention.
3. Model check: a small GPT with flash attention against the same GPT
   with plain attention, f32, on the card (logits within 1e-4).
4. Train phase: five steps of GPT-medium (24 layers, d_model 1024,
   16 heads, seq 1024, batch 8, flash attention, bf16 activations) with
   AdamW and the int8 wire with error feedback, in a one-rank NCCL
   world, from a seed.  The launch counts are set to 0 just before and
   read just after; every loss must be finite and the flash, quantize
   and dequantize kernels must have launched.
5. Two-rank train phase: two processes share the card over gloo (NCCL
   refuses two ranks on one device) and take two steps of GPT-medium's
   widths at 2 layers on the int8+EF wire, which at two ranks runs its
   reduce-scatter and so the dequantize-accumulate kernel.  The replicas
   must agree and every kernel must have launched.
6. Prints the ``kernels`` JSON line, then the result line.  ``launches``
   is the count from the one-rank train phase, and for
   dequantize_accumulate from the two-rank phase.

Exits non-zero, with no result line, on any failure or without a CUDA
device.  TF32 is off for matmuls and convolutions.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12              # dense bf16 tensor-core peak
F32_FLOPS = 67e12                # f32 outside the tensor cores
L2_FLUSH_BYTES = 128 * 2**20     # more than the 50 MB L2
HOLD_CYCLES = 50_000_000         # ~25 ms of the card's clock

GPT_MEDIUM = dict(vocab_size=32000, n_layer=24, n_head=16, d_model=1024,
                  d_ff=4096, max_seq_len=1024, attention="flash")
BATCH, SEQ, STEPS = 8, 1024, 5
WIRE_RANKS, WIRE_LAYERS, WIRE_STEPS = 2, 2, 2


def log(*args) -> None:
    print(*args, flush=True)


def card_and_power_limit() -> str:
    """The first card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call of ``fn``, in ms.

    Each call sits between its own pair of CUDA events, after a write of
    L2_FLUSH_BYTES that evicts the 50 MB L2 (the main path finds these
    operands cold).  The stream is held back while the host enqueues every
    call, so the host's time between launches is not counted."""
    import torch

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(HOLD_CYCLES)
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound(nbytes: float, flops: float, peak_flops: float) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the peak rate for their type.  Both
    times are kept, as ``bytes_ms`` and ``ops_ms``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes_ms=t_bytes, ops_ms=t_ops)


def bitwise_equal(a, b) -> bool:
    """Same shape and bits; NaN matches NaN whatever its payload."""
    import torch

    if a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        nan = a.isnan()
        if not torch.equal(nan, b.isnan()):
            return False
        a = a.view(torch.int32).masked_fill(nan, 0)
        b = b.view(torch.int32).masked_fill(nan, 0)
    return bool(torch.equal(a, b))


def non_finite_check(dev) -> None:
    """Rows holding NaN or Inf: the quantize kernel carries NaN into the
    scale and stores a NaN payload as 0, as its plain version does, so
    the rows dequantize to NaN."""
    import torch
    from horovod_tpu_torch.ops import int8_kernels as ik

    x = torch.randn((4, 1024), device=dev)
    x[0, 5], x[1, 700], x[2, 0] = math.nan, math.inf, -math.inf
    q, s = ik.quantize_blocks(x)
    q_ref, s_ref = ik.quantize_blocks_plain(x)
    out = ik.dequantize_blocks(q, s)
    if not (bitwise_equal(q, q_ref) and bitwise_equal(s, s_ref)
            and bitwise_equal(out, ik.dequantize_blocks_plain(q, s))
            and bool(out[:3].isnan().all()) and bool(out[3].isfinite().all())):
        raise AssertionError("int8 kernels differ from their plain versions "
                             "on non-finite rows")


def kernel_phase(dev, gen):
    import torch
    import torch.nn.functional as F
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import int8_kernels as ik

    rows = []

    # B2 / B4 at the largest leaf of the EF roundtrip: lm_head's gradient,
    # 1024 x 32000 elements, as rows of 1024.
    r, b = 32000, 1024
    x = torch.randn((r, b), generator=gen, device=dev)
    x[0].zero_()                                  # an all-zero block
    q, s = ik.quantize_blocks(x)
    q_ref, s_ref = ik.quantize_blocks_plain(x)
    if not (bitwise_equal(q, q_ref) and bitwise_equal(s, s_ref)):
        raise AssertionError("quantize_blocks differs from its plain version")
    ms = time_ms(lambda: ik.quantize_blocks(x))
    plain = time_ms(lambda: ik.quantize_blocks_plain(x))
    bnd = bound(r * b * 4 + r * b + r * 4, 4 * r * b, F32_FLOPS)
    rows.append(dict(name="quantize_blocks", route="cuda",
                     source="horovod_tpu_torch/csrc/int8_kernels.cu",
                     replaces="horovod_tpu/ops/pallas_collectives.py:74",
                     max_abs_err=float((q.float() - q_ref.float()).abs().max()),
                     ms=ms, plain_ms=plain, **bnd,
                     library_ms=None))

    out = ik.dequantize_blocks(q, s)
    ref = ik.dequantize_blocks_plain(q, s)
    if not bitwise_equal(out, ref):
        raise AssertionError("dequantize_blocks differs from its plain version")
    # One PyTorch call computes the same product: int8 * f32 promotes to
    # f32 inside a single elementwise kernel, rounded once.
    if not bitwise_equal(torch.mul(q, s[:, None]), out):
        raise AssertionError("q * s[:, None] differs from dequantize_blocks")
    ms = time_ms(lambda: ik.dequantize_blocks(q, s))
    plain = time_ms(lambda: ik.dequantize_blocks_plain(q, s))
    lib = time_ms(lambda: torch.mul(q, s[:, None]))
    bnd = bound(r * b + r * 4 + r * b * 4, r * b, F32_FLOPS)
    rows.append(dict(name="dequantize_blocks", route="cuda",
                     source="horovod_tpu_torch/csrc/int8_kernels.cu",
                     replaces="horovod_tpu/ops/pallas_collectives.py:85",
                     max_abs_err=float((out - ref).abs().max()),
                     ms=ms, plain_ms=plain, **bnd,
                     library_ms=lib))

    # B3 with 8 contributors: one 64 MiB f32 fusion bucket over 8 ranks is
    # a shard of 2048 blocks of 1024.
    n, m = 8, 2048
    qn = torch.randint(-127, 128, (n, m, b), generator=gen, device=dev,
                       dtype=torch.int8)
    sn = torch.rand((n, m), generator=gen, device=dev) * 1e-2
    out = ik.dequantize_accumulate(qn, sn)
    ref = ik.dequantize_accumulate_plain(qn, sn)
    if not bitwise_equal(out, ref):
        raise AssertionError(
            "dequantize_accumulate differs from its plain version")
    ms = time_ms(lambda: ik.dequantize_accumulate(qn, sn))
    plain = time_ms(lambda: ik.dequantize_accumulate_plain(qn, sn))
    bnd = bound(n * m * b + n * m * 4 + m * b * 4, 2 * n * m * b, F32_FLOPS)
    rows.append(dict(name="dequantize_accumulate", route="cuda",
                     source="horovod_tpu_torch/csrc/int8_kernels.cu",
                     replaces="horovod_tpu/ops/pallas_collectives.py:90",
                     max_abs_err=float((out - ref).abs().max()),
                     ms=ms, plain_ms=plain, **bnd,
                     library_ms=None))

    # B1 at GPT-medium: B*H = 8*16, T = 1024, D = 64, causal, bf16.
    bh, t, d = BATCH * GPT_MEDIUM["n_head"], SEQ, 64
    q3, k3, v3 = (torch.randn((bh, t, d), generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(3))
    scale = d ** -0.5
    o, lse = fa.flash_fwd(q3, k3, v3, scale, True)
    o_ref, lse_ref = fa.flash_fwd_plain(q3, k3, v3, scale, True)
    diff = (o.float() - o_ref.float()).abs()
    err_o = float(diff.max())
    err_lse = float((lse - lse_ref).abs().max())
    # Late causal rows average hundreds of keys and |O| is small there, so
    # each row is also held to its own scale: a missed or mis-masked key
    # tile shows in the row's relative error.  Both sides round O to bf16,
    # so they may differ by one bf16 ulp, at most 2**-7 of the row's
    # largest |O|: the 1e-2 limit leaves room for that and no more.
    err_row = float((diff.amax(-1) / o_ref.float().abs().amax(-1)).max())
    if not (err_o <= 3e-2 and err_lse <= 1e-4 and err_row <= 1e-2):
        raise AssertionError(f"flash_fwd off its plain version: O {err_o}, "
                             f"lse {err_lse}, row-relative {err_row}")
    ms = time_ms(lambda: fa.flash_fwd(q3, k3, v3, scale, True))
    plain = time_ms(lambda: fa.flash_fwd_plain(q3, k3, v3, scale, True))
    q4, k4, v4 = (y.reshape(BATCH, -1, t, d) for y in (q3, k3, v3))
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True))
    pairs = t * (t + 1) // 2                      # causal (q, k) pairs
    bnd = bound(4 * bh * t * d * 2 + bh * t * 4, 4 * bh * pairs * d,
                BF16_FLOPS)
    rows.append(dict(name="flash_fwd", route="cuda",
                     source="horovod_tpu_torch/csrc/flash_attention.cu",
                     replaces="horovod_tpu/ops/pallas_attention.py:38",
                     max_abs_err=err_o, max_abs_err_lse=err_lse,
                     max_row_rel_err=err_row,
                     ms=ms, plain_ms=plain, **bnd,
                     library_ms=lib))
    for row in rows:
        log(f"kernel {row['name']}: {row['ms']} ms, plain {row['plain_ms']} "
            f"ms, bound {row['bound_ms']} ms ({row['bound_by']}; bytes "
            f"{row['bytes_ms']} ms, operations {row['ops_ms']} ms), library "
            f"{row['library_ms']} ms, max_abs_err {row['max_abs_err']}")
    return rows


def model_check(dev) -> None:
    """Small f32 GPT: flash attention on the card against plain
    attention, same weights, a length that is not a tile multiple."""
    import torch
    import horovod_tpu_torch as hvd

    small = dict(vocab_size=512, n_layer=2, n_head=2, d_model=128, d_ff=256,
                 max_seq_len=256, dtype=torch.float32)
    flash = hvd.models.GPT(hvd.models.GPTConfig(attention="flash", **small),
                           device=dev, seed=1)
    full = hvd.models.GPT(hvd.models.GPTConfig(attention="full", **small),
                          device=dev, seed=1)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, 512, (2, 200), generator=gen, device=dev)
    with torch.no_grad():
        a, b = flash(tokens), full(tokens)
    err = float((a - b).abs().max())
    if not (torch.isfinite(a).all() and a.shape == (2, 200, 512)
            and err <= 1e-4):
        raise AssertionError(f"small GPT flash vs full: max_abs_err {err}")
    log(f"model check: small GPT flash vs full logits max_abs_err {err}")


def gpt_medium_step(dev, n_layer: int = GPT_MEDIUM["n_layer"],
                    data_seed: int = 0):
    """(model, step, batch): GPT-medium (at ``n_layer`` layers) from seed
    0 on ``dev``, broadcast from rank 0, and its train step with AdamW on
    the int8+EF wire, as a user of the port writes it; the batch is
    random tokens from ``data_seed``."""
    import torch
    import horovod_tpu_torch as hvd

    cfg = hvd.models.GPTConfig(**{**GPT_MEDIUM, "n_layer": n_layer})
    model = hvd.models.GPT(cfg, device=dev, seed=0)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4),
        compression=hvd.Compression.int8, error_feedback=True)
    step = hvd.make_train_step(hvd.models.lm_loss_fn(model), opt)
    gen = torch.Generator(device=dev).manual_seed(data_seed)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, SEQ + 1),
                           generator=gen, device=dev)
    return model, step, (tokens[:, :-1], tokens[:, 1:])


def train_phase(dev, card: str):
    import torch
    import horovod_tpu_torch as hvd

    model, step, batch = gpt_medium_step(dev)
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hvd.ops.reset_launch_counts()
    losses, times = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        loss = step(model, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    counts = hvd.ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    for name in ("flash_fwd", "quantize_blocks", "dequantize_blocks"):
        if counts[name] <= 0:
            raise AssertionError(f"{name} never launched on the train path")
    tok_s = BATCH * SEQ * (STEPS - 1) / sum(times[1:])
    log(f"train: GPT-medium {n_params} params, losses {losses}")
    log(f"train: step seconds {times}")
    log(f"train: {tok_s:.1f} tokens/s (steps 2-{STEPS}), peak memory "
        f"{peak / 2**30:.2f} GiB, on {card}")
    log(f"train: launches {counts}")
    return counts


def _wire_rank(rank: int, store: str, results) -> None:
    """One rank of the two-rank train phase (run in its own process)."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch as hvd

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WIRE_RANKS)
    hvd.init(device="cuda:0")
    try:
        # Each rank trains on its own batch.
        model, step, batch = gpt_medium_step(
            hvd.device(), n_layer=WIRE_LAYERS, data_seed=1 + rank)
        hvd.ops.reset_launch_counts()
        losses = [float(step(model, batch)) for _ in range(WIRE_STEPS)]
        counts = hvd.ops.launch_counts()
        digest = sum(float(p.detach().double().sum())
                     for p in model.parameters())
        results.put((rank, losses, counts, digest))
    finally:
        hvd.shutdown()
        dist.destroy_process_group()


def wire_phase():
    """The train path on two ranks, which is the only way to reach the
    int8 wire's reduce-scatter (kernel dequantize_accumulate).  NCCL
    refuses two ranks on one device, so the two processes share the card
    over gloo, which stages CUDA tensors through the host.  GPT-medium's
    widths at WIRE_LAYERS layers."""
    import multiprocessing as mp
    import queue
    import tempfile

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_wire_rank,
                             args=(r, os.path.join(tmp, "store"), results))
                 for r in range(WIRE_RANKS)]
        for p in procs:
            p.start()
        out = {}
        deadline = time.monotonic() + 600
        try:
            while len(out) < WIRE_RANKS:
                try:
                    rank, losses, counts, digest = results.get(timeout=5)
                    out[rank] = (losses, counts, digest)
                except queue.Empty:
                    failed = [p.exitcode for p in procs if p.exitcode]
                    if failed or time.monotonic() > deadline:
                        raise AssertionError(
                            f"two-rank train phase: no answer (exit codes "
                            f"{[p.exitcode for p in procs]})")
        finally:
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
                    p.join()
    losses, counts, digest = out[0]
    if not all(math.isfinite(v) for v in losses + out[1][0]):
        raise AssertionError(f"non-finite loss: {out}")
    if out[1][2] != digest:
        raise AssertionError(f"replicas differ after the steps: {out}")
    for name, n in counts.items():
        if n <= 0 or out[1][1][name] <= 0:
            raise AssertionError(f"{name} never launched on the two-rank path")
    log(f"train, {WIRE_RANKS} ranks on one card: {WIRE_LAYERS} layers, "
        f"losses {losses} / {out[1][0]}, launches {counts}")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch as hvd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_and_power_limit()
    log(card)
    t0 = time.perf_counter()
    hvd.ops.build_kernels()
    log(f"build: {time.perf_counter() - t0:.1f} s")

    hvd.init()
    try:
        dev = hvd.device()
        gen = torch.Generator(device=dev).manual_seed(0)
        rows = kernel_phase(dev, gen)
        non_finite_check(dev)
        model_check(dev)
        counts = train_phase(dev, card)
        torch.cuda.empty_cache()
        wire_counts = wire_phase()
    finally:
        hvd.shutdown()
    for row in rows:
        # One rank never reaches the reduce-scatter: its kernel counts on
        # the two-rank path.
        path = "2 ranks" if row["name"] == "dequantize_accumulate" else "1 rank"
        row["launches_by_path"] = {"1 rank": counts[row["name"]],
                                   "2 ranks": wire_counts[row["name"]]}
        row["launches"] = row["launches_by_path"][path]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
