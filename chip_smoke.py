#!/usr/bin/env python3
"""Smoke run of horovod_tpu_torch on one CUDA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds the kernels from
   ``horovod_tpu_torch/csrc`` (one nvcc per source, in parallel) and
   prints the build time.
2. Kernel phase: each hand-written kernel against its plain PyTorch
   version, on the card, at the shapes the main paths give it.  The int8
   kernels (B2-B4) and the fused apply kernels (B6, B7) must match bit
   for bit, on rows holding NaN (and for B2-B4 Inf) as well; flash
   attention (B1, the bf16 tensor-core kernel) within the bf16 tolerance
   (3e-2 on O, 1e-4 on lse) and, row by row, within 1e-2 of the row's
   largest |O|, on normal and on peaky (q * 8) scores, at GPT-medium's
   causal shape and at BERT-Large's non-causal one; the blocked
   matmul (B5) with a bf16 and with an f32 x within twice its plain
   version's error against an f64 product plus 1e-6 of the product's
   largest |value|.  B1 and B5 also print their TFLOP/s beside the
   yardstick's.  Prints each
   kernel's median time, its plain version's, its bound and, where one
   PyTorch call computes the same function, that call's time as a
   yardstick the port never calls: ``q * s[:, None]`` for the
   dequantize, ``F.scaled_dot_product_attention`` for flash attention,
   ``torch.addcmul`` for the SGD apply, ``torch.matmul`` of the f32
   operands for B5.  B4 and B3 run their vector route at the main
   shapes, B3 also at the two-rank paths' 2 contributors (bitwise, NaN
   and Inf rows, timed); their scalar route (bitwise too) is timed at a
   ragged block of nearly the same bytes (b = 1023), and a device copy
   of the same bytes, and the vector route once more after a flush that
   leaves the L2 clean, show what limits them.
3. Model check: small GPTs with flash attention against the same GPTs
   with plain attention, on the card: f32 (logits within 1e-4) and bf16
   at head dim 64 (within 5e-2).
4. Train phase ("1 rank"): five data-parallel steps of GPT-medium (24
   layers, d_model 1024, 16 heads, seq 1024, batch 8, flash attention,
   bf16 activations) with AdamW and the int8 wire with error feedback,
   in a one-rank NCCL world, from a seed.  Every loss must be finite,
   and the flash, quantize and dequantize kernels must have launched.
   Then the chunked LM head on the same model: one forward and backward
   with the dense loss and one with ``vocab_chunk_size=1024``, the losses
   within rtol 1e-5 and lm_head's gradient within rtol 1e-4 / atol 1e-6,
   each one's peak memory printed.
5. ZeRO phase ("zero 1 rank"): the same model, batch and optimizer
   through ``make_zero_train_step`` (optimizer state on the rank's flat
   shards, int8+EF reduce-scatter wire, exact parameter all-gather), five
   steps; the same checks, tokens/s and peak memory beside the
   data-parallel phase's.
6. Two-rank phases: two processes share the card over gloo (NCCL refuses
   two ranks on one device) at GPT-medium's widths and WIRE_LAYERS
   layers, each rank on its own batch.
   - "2 ranks": two data-parallel steps on the int8+EF wire, whose
     reduce-scatter runs the dequantize-accumulate kernel (B3); the
     replicas must agree.
   - "sharded 2 ranks": (a) two ZeRO steps on the int8+EF wire, after
     which the replicas' parameters must be bit-identical; (b) for every
     leaf of one backward's gradients, ``fused_quantize_reducescatter``
     (bit for bit the plain versions of B2 and B3 applied to every
     rank's gradient, gathered exactly) then
     ``fused_allgather_adam_apply`` (steps 1 and 2) and
     ``fused_allgather_sgd_apply`` (B6, B7), each within 1e-6 abs/rel of
     ``int8_allgather`` + the plain update, and bit for bit the same on
     both ranks; (c) ``unshard_matmul`` (B5) on block 0's four Dense
     layers with their real input activations against the rank's column
     shard of the weight, held to the f64 rule of step 2.
7. "4 ranks": four processes share the card over gloo, at GPT-medium's
   widths and WIRE_LAYERS layers, each rank on its own batch.  The
   process sets {0, 2} and {1, 3} run at the same time.  (a) The eager
   API on CUDA tensors: the int8 allreduce of lm_head's gradient shape
   over the global set (async: ``poll`` before and after the wait) and
   over each pair, bit for bit the tier's plain form (plain B2 and B3
   over the gathered inputs), and of its bf16 cast over the global set,
   bit for bit the reference's rounding in plain form (plain B2 and B4,
   each contribution rounded to bf16, an f32 sum in rank order rounded
   once, the divide in bf16); ragged allgather and alltoall, broadcast,
   reducescatter, barrier and join against what the inputs give; a call
   on the other pair must raise.  (b) One model per pair on the int8+EF
   wire over the pair: the grouped int8 allreduce of one backward's
   gradient leaves, bit for bit the plain form of each fusion bucket,
   then WIRE_STEPS steps; replicas within a pair bitwise equal, the two
   pairs' models different.  (c) ``op=Adasum``: WIRE_STEPS steps over
   all four ranks, the first step's combined gradient of every leaf
   within rtol 1e-4 and atol 1e-5 of a float64 numpy Adasum tree of the
   ranks' gradients, then WIRE_STEPS over {0, 1, 2} (pre-fold and
   post-scatter; rank 3 stays out); replicas bitwise equal.  (d)
   ``backward_passes_per_step=2`` over each pair: after call 1 the
   parameters keep their bits, after call 2 they have moved.  B1-B4
   must have launched; prints the phase's seconds and each rank's peak
   memory.
8. "microbatch 2 ranks": two processes share the card over gloo, at
   GPT-medium's full width and depth, each rank on its own batch of 8:
   ``make_train_step(lm_loss_fn(model, vocab_chunk_size=1024),
   AdamW, compression=int8, microbatches=4)`` (the overlap wire: each
   microbatch's reduce-scatter started before the next one's backward,
   one all-gather at the update), 3 steps.  (a) Step 1's reduced
   gradient bit for bit the plain B2-B4 composition over the captured
   per-microbatch gradients (each microbatch's reduce-scatter added into
   accumulators from zero, one all-gather, / 4); (b) one step with
   ``two_phase=True`` and one microbatch from the same weights, its
   reduced gradients bit for bit the single-phase int8 allreduce of the
   same gradients; (c) replicas bitwise equal after every step; (d)
   finite losses; (e) B1-B4 launched.  Prints the phase's seconds, each
   rank's peak memory and the step times with the overlap wire and with
   ``overlap=False`` (gloo on one card: not a wire's time).
9. "resnet50 1 rank": ``bench.py``'s full preset, ResNet-50 (1000
   classes, bf16 activations, f32 parameters, BatchNorm in train mode)
   on NHWC [256, 224, 224, 3] seeded images, SGD(0.1, momentum 0.9) in
   a DistributedOptimizer through ``make_train_step``: five steps on
   the int8 + error-feedback wire (B2 and B4 must launch), then five on
   the fp16 wire (``bench.py --fp16-allreduce``); finite losses,
   images/s over steps 2-5, peak memory, B2/B4 launches a step.
10. "resnet50 2 ranks": two processes share the card over gloo, full
   ResNet-50, 32 images a rank, every BatchNorm synchronised over both
   ranks, the int8 + EF wire, 3 steps: parameters and running
   statistics bitwise equal on both ranks after every step, B2-B4
   launched; then an f32 ResNet-50 with the same starting weights,
   synchronised, against one process's forward of the 64 images with
   plain BatchNorm: logits within 1e-3 of their scale, running
   statistics within 1e-3 of each buffer's scale.
11. "bert-large 1 rank": ``benchmarks/bert_finetune_bench.py``'s
   configuration (BERT-Large, flash attention, seq 128, batch 32,
   AdamW(2e-5, weight decay 1e-4) on the fp16 wire), 5 steps: B1 must
   launch 24 times a step, each non-causal; seqs/s, peak memory.  Then
   ``BertForMaskedLM`` at BERT-Large's size in f32, one forward and
   backward with the dense and with the chunked head: losses within
   rtol 1e-5, the tied embedding's gradient within rtol 1e-4 / atol
   1e-6, both peaks printed.
12. "vgg16 / inception3 1 rank": ``bench.py``'s shapes (224 and 299
   inputs, 1000 classes, bf16), batch 128, one warm-up step, then one
   step on the int8 + EF wire (B2 and B4 must launch; VGG's fc6
   gradient of 102.8 M elements is the wire's largest leaf).
13. Route check: the profiler's device trace must show a bf16
   flash_fwd call at the step's shape run the tensor-core kernel
   (flash_fwd_wgmma) and an f32 one the CUDA-core kernel, a bf16
   non-causal one at BERT-Large's shape the tensor-core kernel, and B4
   and B3 at rows of 1024 run their vector kernel and at rows of 1023
   only their scalar one.  It runs last, so that the profiler touches
   none of the timed phases.
14. Prints the ``kernels`` JSON line (all seven kernels, with their
   launches on every path; ``launches`` is the count on the path that
   reaches the kernel; B4's and B3's rows give their ``kernel_route`` and
   a ``scalar_route``), then the result line.  Every kernel must have
   launched on at least one path.

The launch counts are set to 0 just before each path is driven and read
just after it, before any comparison launches a kernel again.  Exits
non-zero, with no result line, on any failure or without a CUDA device.
TF32 is off for matmuls and convolutions.
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
SET_RANKS = 4                    # the "4 ranks" phase's world
MICROBATCHES, MB_STEPS = 4, 3    # the "microbatch 2 ranks" phase's
IMAGE_CLASSES = 1000
IMAGE_SIDE = {"resnet50": 224, "vgg16": 224, "inception3": 299}  # bench.py
RESNET_BATCH, RESNET_STEPS = 256, 5          # bench.py's full preset
RESNET_RANK_BATCH, RESNET_RANK_STEPS = 32, 3  # "resnet50 2 ranks"
CONVNET_BATCH = 128                          # bench.py's VGG/Inception
BERT_BATCH, BERT_SEQ, BERT_STEPS = 32, 128, 5  # bert_finetune_bench.py
SGD_MOMENTUM = dict(lr=0.1, momentum=0.9)    # optax.sgd(0.1, momentum=0.9)
BERT_ADAMW = dict(lr=2e-5, weight_decay=1e-4)  # optax.adamw(2e-5)
VOCAB_CHUNK = 1024               # tokens a chunk of the chunked LM head
APPLY_LR = 0.1                   # the fused apply's, as the reference test's
ADAMW = dict(lr=3e-4, weight_decay=1e-4)


def log(*args) -> None:
    print(*args, flush=True)


def card_and_power_limit() -> str:
    """The first card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3,
            dirty_l2: bool = True) -> float:
    """Median device time of one call of ``fn``, in ms.

    Each call sits between its own pair of CUDA events, after a write of
    L2_FLUSH_BYTES that evicts the 50 MB L2 (the main path finds these
    operands cold, and the L2 full of other kernels' dirty lines).  With
    ``dirty_l2=False`` the flush reads those bytes instead, so the L2
    holds only clean lines and ``fn`` pays no write-back of the flush's.
    The stream is held back while the host enqueues every call, so the
    host's time between launches is not counted."""
    import torch

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(HOLD_CYCLES)
    for start, end in events:
        if dirty_l2:
            flush.zero_()
        else:
            flush.max()
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

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype in (torch.bfloat16, torch.float16):
        return bool(torch.equal(a.view(torch.int16), b.view(torch.int16)))
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

    rows.append(dequantize_row(dev, gen, q, s))
    rows.append(dequantize_accumulate_row(dev, gen))
    rows.append(flash_kernel_row(dev, gen))
    rows += apply_kernel_rows(dev, gen)
    rows.append(matmul_kernel_row(dev, gen))
    for row in rows:
        log(f"kernel {row['name']}: {row['ms']} ms, plain {row['plain_ms']} "
            f"ms, bound {row['bound_ms']} ms ({row['bound_by']}; bytes "
            f"{row['bytes_ms']} ms, operations {row['ops_ms']} ms), library "
            f"{row['library_ms']} ms, max_abs_err {row['max_abs_err']}")
        if "scalar_route" in row:
            sc = row["scalar_route"]
            log(f"kernel {row['name']}: vector route {row['ms']} ms "
                f"({row['ms_clean_l2']} with a clean L2), a copy of the same "
                f"bytes {row['copy_ms']} ms ({row['copy_ms_clean_l2']}); "
                f"scalar route at {sc['shape']} {sc['ms']} ms, plain "
                f"{sc['plain_ms']} ms, bound {sc['bound_ms']} ms, library "
                f"{sc['library_ms']} ms")
        if "bert_large" in row:
            bl = row["bert_large"]
            log(f"kernel {row['name']}: at {bl['shape']} non-causal "
                f"(BERT-Large) {bl['ms']} ms, plain {bl['plain_ms']} ms, "
                f"bound {bl['bound_ms']} ms ({bl['bound_by']}; bytes "
                f"{bl['bytes_ms']} ms, operations {bl['ops_ms']} ms), SDPA "
                f"{bl['library_ms']} ms")
        if "two_ranks" in row:
            tr = row["two_ranks"]
            log(f"kernel {row['name']}: at {tr['shape']} (two ranks) "
                f"{tr['ms']} ms, plain {tr['plain_ms']} ms, bound "
                f"{tr['bound_ms']} ms, bitwise with NaN/Inf rows")
    return rows


def copy_times(nbytes: int, dev) -> dict:
    """A device copy moving ``nbytes`` (half read, half written), the rate
    this card reaches for that many bytes under the same timing, after a
    flush that leaves the L2 dirty (``copy_ms``) and one that leaves it
    clean (``copy_ms_clean_l2``)."""
    import torch

    src = torch.empty(nbytes // 2, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    return dict(copy_ms=time_ms(lambda: dst.copy_(src)),
                copy_ms_clean_l2=time_ms(lambda: dst.copy_(src),
                                         dirty_l2=False))


def scalar_route(fn, plain, args, nbytes: int, flops: int, lib=None) -> dict:
    """The scalar route of B4 or B3 at a ragged block (b = 1023, the bytes
    of the main shape less a 1024th): bitwise against the plain version,
    then its times, bound and, where given, the library call's time."""
    out = fn(*args)
    if not bitwise_equal(out, plain(*args)):
        raise AssertionError(f"{fn.__name__}'s scalar route differs from "
                             "its plain version")
    return dict(shape=list(args[0].shape), ms=time_ms(lambda: fn(*args)),
                plain_ms=time_ms(lambda: plain(*args)),
                **bound(nbytes, flops, F32_FLOPS),
                library_ms=None if lib is None else time_ms(
                    lambda: lib(*args)))


def dequantize_row(dev, gen, q, s) -> dict:
    """B4 on its vector route at lm_head's [32000, 1024] (B2's output),
    bitwise against its plain version and against ``q * s[:, None]``,
    which one PyTorch call computes (int8 * f32 promotes to f32 inside a
    single elementwise kernel, rounded once); its scalar route at [32000,
    1023]; a copy of the same bytes."""
    import torch
    from horovod_tpu_torch.ops import int8_kernels as ik

    r, b = q.shape
    out = ik.dequantize_blocks(q, s)
    ref = ik.dequantize_blocks_plain(q, s)
    if not bitwise_equal(out, ref):
        raise AssertionError("dequantize_blocks differs from its plain version")
    if not bitwise_equal(torch.mul(q, s[:, None]), out):
        raise AssertionError("q * s[:, None] differs from dequantize_blocks")

    def mul(qq, ss):
        return torch.mul(qq, ss[:, None])

    nbytes = r * b + r * 4 + r * b * 4
    row = dict(name="dequantize_blocks", route="cuda", kernel_route="vector",
               source="horovod_tpu_torch/csrc/int8_kernels.cu",
               replaces="horovod_tpu/ops/pallas_collectives.py:85",
               max_abs_err=float((out - ref).abs().max()),
               ms=time_ms(lambda: ik.dequantize_blocks(q, s)),
               ms_clean_l2=time_ms(lambda: ik.dequantize_blocks(q, s),
                                   dirty_l2=False),
               plain_ms=time_ms(lambda: ik.dequantize_blocks_plain(q, s)),
               **bound(nbytes, r * b, F32_FLOPS),
               library_ms=time_ms(lambda: mul(q, s)),
               **copy_times(nbytes, dev))
    rb = b - 1
    qr = torch.randint(-127, 128, (r, rb), generator=gen, device=dev,
                       dtype=torch.int8)
    row["scalar_route"] = scalar_route(
        ik.dequantize_blocks, ik.dequantize_blocks_plain, (qr, s),
        r * rb * 5 + r * 4, r * rb, lib=mul)
    return row


def dequantize_accumulate_row(dev, gen) -> dict:
    """B3 with 8 contributors on its vector route: one 64 MiB f32 fusion
    bucket over 8 ranks is a shard of 2048 blocks of 1024; its scalar
    route at [8, 2048, 1023]; a copy of the same bytes."""
    import torch
    from horovod_tpu_torch.ops import int8_kernels as ik

    n, m, b = 8, 2048, 1024
    qn = torch.randint(-127, 128, (n, m, b), generator=gen, device=dev,
                       dtype=torch.int8)
    sn = torch.rand((n, m), generator=gen, device=dev) * 1e-2
    out = ik.dequantize_accumulate(qn, sn)
    ref = ik.dequantize_accumulate_plain(qn, sn)
    if not bitwise_equal(out, ref):
        raise AssertionError(
            "dequantize_accumulate differs from its plain version")
    nbytes = n * m * b + n * m * 4 + m * b * 4
    row = dict(name="dequantize_accumulate", route="cuda",
               kernel_route="vector",
               source="horovod_tpu_torch/csrc/int8_kernels.cu",
               replaces="horovod_tpu/ops/pallas_collectives.py:90",
               max_abs_err=float((out - ref).abs().max()),
               ms=time_ms(lambda: ik.dequantize_accumulate(qn, sn)),
               ms_clean_l2=time_ms(lambda: ik.dequantize_accumulate(qn, sn),
                                   dirty_l2=False),
               plain_ms=time_ms(
                   lambda: ik.dequantize_accumulate_plain(qn, sn)),
               **bound(nbytes, 2 * n * m * b, F32_FLOPS),
               library_ms=None, **copy_times(nbytes, dev))
    rb = b - 1
    qr = torch.randint(-127, 128, (n, m, rb), generator=gen, device=dev,
                       dtype=torch.int8)
    row["scalar_route"] = scalar_route(
        ik.dequantize_accumulate, ik.dequantize_accumulate_plain, (qr, sn),
        n * m * rb + n * m * 4 + m * rb * 4, 2 * n * m * rb)
    row["two_ranks"] = two_rank_accumulate(dev)
    return row


def two_rank_accumulate(dev) -> dict:
    """B3 as the two-rank paths run it: 2 contributors, a 64 MiB f32
    fusion bucket's shard of 8192 blocks of 1024, on its vector route,
    bitwise against its plain version with NaN, +Inf and -Inf scales in
    either contributor's rows; then its times and bound."""
    import torch
    from horovod_tpu_torch.ops import int8_kernels as ik

    gen = torch.Generator(device=dev).manual_seed(2)
    n, m, b = 2, 8192, 1024
    q = torch.randint(-127, 128, (n, m, b), generator=gen, device=dev,
                      dtype=torch.int8)
    s = torch.rand((n, m), generator=gen, device=dev) * 1e-2
    s[0, 1], s[1, 2], s[0, 3], s[1, 3] = math.nan, math.inf, -math.inf, 1.0
    out = ik.dequantize_accumulate(q, s)
    if ik._dequant_route(b, q.data_ptr(), out.data_ptr(),
                         out.numel()) != "vector":
        raise AssertionError("two-rank dequantize_accumulate left the "
                             "vector route")
    ref = ik.dequantize_accumulate_plain(q, s)
    if not (bitwise_equal(out, ref) and bool(out[1:3].isnan().any())
            and bool(out[0].isfinite().all())):
        raise AssertionError("dequantize_accumulate at 2 contributors "
                             "differs from its plain version")
    nbytes = n * m * b + n * m * 4 + m * b * 4
    return dict(shape=[n, m, b],
                ms=time_ms(lambda: ik.dequantize_accumulate(q, s)),
                plain_ms=time_ms(lambda: ik.dequantize_accumulate_plain(q, s)),
                **bound(nbytes, 2 * n * m * b, F32_FLOPS))


def device_kernels(fn):
    """(``fn()``, the names of the CUDA kernels it launched, as the
    profiler's device trace records them): which kernel really ran."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, [e.key for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA]


def route_check(dev) -> None:
    """Which kernel each call really launches, read from the profiler's
    device trace: at the GPT step's shape a bf16 flash_fwd must run
    flash_fwd_wgmma and an f32 one only the CUDA-core flash_fwd, and at
    BERT-Large's non-causal shape a bf16 one flash_fwd_wgmma; B4 at
    lm_head's rows of 1024 and B3 at a two-rank bucket's shard must run
    their vector route, and at a ragged block (1023) only their scalar
    route.  It runs after the timed phases, so that the profiler touches
    none."""
    import torch
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import int8_kernels as ik

    q3 = torch.randn((BATCH * GPT_MEDIUM["n_head"], SEQ, 64), device=dev)
    qb = torch.randn((BERT_BATCH * 16, BERT_SEQ, 64), device=dev).bfloat16()
    for x, causal, tensor_cores in ((q3.bfloat16(), True, True),
                                    (q3, True, False), (qb, False, True)):
        _, names = device_kernels(
            lambda: fa.flash_fwd(x, x, x, 0.125, causal))
        wgmma = any("flash_fwd_wgmma" in n for n in names)
        cores = any("flash_fwd" in n and "wgmma" not in n for n in names)
        if (wgmma, cores) != (tensor_cores, not tensor_cores):
            raise AssertionError(f"{x.dtype} flash_fwd launched {names}")
        log(f"route check: {x.dtype} {tuple(x.shape)} causal={causal} "
            f"flash_fwd ran {[n for n in names if 'flash_fwd' in n]}")
    for wrapper, lead in (("dequantize_blocks", (32000,)),
                          ("dequantize_accumulate", (2, 8192))):
        for b, route in ((1024, "vector"), (1023, "scalar")):
            q = torch.zeros(lead + (b,), dtype=torch.int8, device=dev)
            s = torch.ones(lead, device=dev)
            fn = getattr(ik, wrapper)
            _, names = device_kernels(lambda: fn(q, s))
            ran = ik.routes_run(names, wrapper)
            if ran != {route}:
                raise AssertionError(f"{wrapper} at {tuple(q.shape)} ran "
                                     f"{ran}, not {route}: {names}")
            log(f"route check: {wrapper} at {tuple(q.shape)} ran {route} "
                f"{[n for n in names if 'quantize' in n]}")


def flash_errors(q3, k3, v3, scale: float, causal: bool = True):
    """(O, lse, row-relative) error of the kernel against its plain
    version, and whether all three are inside the bf16 limits."""
    from horovod_tpu_torch.ops import flash_attention as fa

    o, lse = fa.flash_fwd(q3, k3, v3, scale, causal)
    o_ref, lse_ref = fa.flash_fwd_plain(q3, k3, v3, scale, causal)
    diff = (o.float() - o_ref.float()).abs()
    err_o = float(diff.max())
    err_lse = float((lse - lse_ref).abs().max())
    # Late causal rows average hundreds of keys and |O| is small there, so
    # each row is also held to its own scale: a missed or mis-masked key
    # tile shows in the row's relative error.  Both sides round O to bf16,
    # so they may differ by one bf16 ulp, at most 2**-7 of the row's
    # largest |O|: the 1e-2 limit leaves room for that and no more.
    err_row = float((diff.amax(-1) / o_ref.float().abs().amax(-1)).max())
    return err_o, err_lse, err_row, (err_o <= 3e-2 and err_lse <= 1e-4
                                     and err_row <= 1e-2)


def flash_case(dev, gen, batch: int, heads: int, t: int, causal: bool,
               label: str) -> dict:
    """B1 at ``[batch * heads, t, 64]`` bf16 (the tensor-core kernel),
    held to the bf16 limits on normal scores and on peaky ones (q * 8:
    the running max moves by many units between key tiles, so the
    rescale of O and of the denominator is exercised); then its time,
    its plain version's, SDPA's and its bound (4·BH·pairs·D FLOPs,
    pairs the (q, k) pairs the mask keeps)."""
    import torch
    import torch.nn.functional as F
    from horovod_tpu_torch.ops import flash_attention as fa

    bh, d = batch * heads, 64
    q3, k3, v3 = (torch.randn((bh, t, d), generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(3))
    scale = d ** -0.5
    errs = {}
    for name, q in (("normal", q3), ("peaky", (q3.float() * 8).bfloat16())):
        err_o, err_lse, err_row, ok = flash_errors(q, k3, v3, scale, causal)
        log(f"kernel flash_fwd ({label}, {name} scores): O {err_o}, lse "
            f"{err_lse}, row-relative {err_row}")
        if not ok:
            raise AssertionError(f"flash_fwd ({label}, {name} scores) off "
                                 f"its plain version: O {err_o}, lse "
                                 f"{err_lse}, row-relative {err_row}")
        errs[name] = (err_o, err_lse, err_row)
    ms = time_ms(lambda: fa.flash_fwd(q3, k3, v3, scale, causal))
    plain = time_ms(lambda: fa.flash_fwd_plain(q3, k3, v3, scale, causal))
    q4, k4, v4 = (y.reshape(batch, heads, t, d) for y in (q3, k3, v3))
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=causal))
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = 4 * bh * pairs * d
    bnd = bound(4 * bh * t * d * 2 + bh * t * 4, flops, BF16_FLOPS)
    log(f"kernel flash_fwd ({label}): {flops / ms / 1e9} TFLOP/s, SDPA "
        f"{flops / lib / 1e9} TFLOP/s")
    (err_o, err_lse, err_row), peaky = errs["normal"], errs["peaky"]
    return dict(shape=[bh, t, d], causal=causal, max_abs_err=err_o,
                max_abs_err_lse=err_lse, max_row_rel_err=err_row,
                peaky_errs=peaky, tflops=flops / ms / 1e9,
                library_tflops=flops / lib / 1e9, ms=ms, plain_ms=plain,
                **bnd, library_ms=lib)


def flash_kernel_row(dev, gen):
    """B1 at GPT-medium (B*H = 8*16, T = 1024, D = 64, causal, bf16), the
    row's main shape, and at BERT-Large's (B*H = 32*16, T = Tk = 128,
    D = 64, non-causal, bf16) as its ``bert_large`` shape."""
    row = flash_case(dev, gen, BATCH, GPT_MEDIUM["n_head"], SEQ, True,
                     "GPT-medium")
    bert = flash_case(dev, gen, BERT_BATCH, 16, BERT_SEQ, False,
                      "BERT-Large")
    del row["shape"], row["causal"]
    return dict(name="flash_fwd", route="cuda",
                source="horovod_tpu_torch/csrc/flash_attention.cu",
                replaces="horovod_tpu/ops/pallas_attention.py:38",
                **row, bert_large=bert)


def apply_kernel_rows(dev, gen):
    """B6 and B7 at GPT-medium's largest leaf, lm_head [1024, 32000], as
    the fused apply gets it at two ranks: 2 contributors of 16000 blocks
    of 1024.  One gradient row has a NaN scale (and a 0 payload, as B2
    writes it), which must turn its elements NaN in kernel and plain
    version alike."""
    import torch
    from horovod_tpu_torch.ops import apply_kernels as ak

    n, m, b = 2, 16000, 1024
    k = m * b
    q = torch.randint(-127, 128, (n, m, b), generator=gen, device=dev,
                      dtype=torch.int8)
    s = torch.rand((n, m), generator=gen, device=dev) * 1e-3
    s[1, 7], q[1, 7] = math.nan, 0
    p = torch.randn(n * k, generator=gen, device=dev) * 0.02
    mu = torch.randn(n * k, generator=gen, device=dev) * 1e-3
    nu = torch.rand(n * k, generator=gen, device=dev) * 1e-6
    rows, elems = [], n * k

    def err(a, r):
        return float((a - r).nan_to_num(0.0).abs().max())

    out = ak.sgd_apply(q, s, p, lr=APPLY_LR)
    ref = ak.sgd_apply_plain(q, s, p, lr=APPLY_LR)
    nan_row = slice(k + 7 * b, k + 8 * b)      # contributor 1, block 7
    if not (bitwise_equal(out, ref) and bool(out[nan_row].isnan().all())):
        raise AssertionError("sgd_apply differs from its plain version")
    # The one PyTorch call that takes int8 payload and scales to the SGD
    # update, if it takes these dtypes: p + (-lr) * q * s.
    p2, q2, s2 = p.view(n * m, b), q.view(n * m, b), s.view(n * m, 1)
    try:
        lib_out = torch.addcmul(p2, q2, s2, value=-APPLY_LR)
        lib = time_ms(lambda: torch.addcmul(p2, q2, s2, value=-APPLY_LR))
        log(f"kernel sgd_apply: torch.addcmul is {err(lib_out.view(-1), ref)}"
            " from the plain version")
    except RuntimeError as exc:
        lib = None
        log(f"kernel sgd_apply: torch.addcmul refuses int8 and f32: {exc}")
    ms = time_ms(lambda: ak.sgd_apply(q, s, p, lr=APPLY_LR))
    plain = time_ms(lambda: ak.sgd_apply_plain(q, s, p, lr=APPLY_LR))
    bnd = bound(elems * (1 + 4 + 4) + n * m * 4, 3 * elems, F32_FLOPS)
    rows.append(dict(name="sgd_apply", route="cuda",
                     source="horovod_tpu_torch/csrc/fused_apply.cu",
                     replaces="horovod_tpu/ops/pallas_collectives.py:329",
                     max_abs_err=err(out, ref), ms=ms, plain_ms=plain, **bnd,
                     library_ms=lib))

    consts = dict(lr=APPLY_LR, b1=0.9, b2=0.999, eps=1e-8,
                  bc1=1.0 - 0.9 ** 2, bc2=1.0 - 0.999 ** 2)
    outs = ak.adam_apply(q, s, p, mu, nu, **consts)
    refs = ak.adam_apply_plain(q, s, p, mu, nu, **consts)
    if not all(bitwise_equal(a, r) and bool(a[nan_row].isnan().all())
               for a, r in zip(outs, refs)):
        raise AssertionError("adam_apply differs from its plain version")
    ms = time_ms(lambda: ak.adam_apply(q, s, p, mu, nu, **consts))
    plain = time_ms(lambda: ak.adam_apply_plain(q, s, p, mu, nu, **consts))
    bnd = bound(elems * (1 + 3 * 4 + 3 * 4) + n * m * 4, 14 * elems,
                F32_FLOPS)
    log("kernel adam_apply: no library yardstick (no one PyTorch call "
        "takes int8 payload and scales to an Adam update)")
    rows.append(dict(name="adam_apply", route="cuda",
                     source="horovod_tpu_torch/csrc/fused_apply.cu",
                     replaces="horovod_tpu/ops/pallas_collectives.py:336",
                     max_abs_err=max(err(a, r) for a, r in zip(outs, refs)),
                     ms=ms, plain_ms=plain, **bnd, library_ms=None))
    return rows


def f64_rule(y, x, w):
    """(kernel error, plain error, passed): B5's result against the f64
    product, allowed twice its plain version's error plus 1e-6 of the
    product's largest |value| (no exact equality: the sums run in other
    orders)."""
    from horovod_tpu_torch.ops import matmul_kernel as mk

    ref = x.double() @ w.double()
    err = float((y.double() - ref).abs().max())
    err_plain = float((mk.matmul_plain(x, w).double() - ref).abs().max())
    return err, err_plain, err <= 2 * err_plain + 1e-6 * float(ref.abs().max())


def matmul_kernel_row(dev, gen):
    """B5 at GPT-medium's ff1: the block input of B*T = 8*1024 rows, bf16,
    @ the f32 kernel [1024, 4096], at n = 1.  The same product with an f32
    x is held to the f64 rule too: with a bf16 output its rounding hides
    the sum's error, with an f32 one a lost bf16 piece or a TF32 sum would
    fail.  The bound is that of the products the kernel runs on the bf16
    tensor cores: 3 of 2·M·N·K for a bf16 x (6 for an f32 one)."""
    import torch
    from horovod_tpu_torch.ops import matmul_kernel as mk

    rows, d, ff = BATCH * SEQ, GPT_MEDIUM["d_model"], GPT_MEDIUM["d_ff"]
    x_f32 = torch.randn((rows, d), generator=gen, device=dev)
    x = x_f32.to(torch.bfloat16)
    w = torch.randn((d, ff), generator=gen, device=dev) * d ** -0.5
    errs = {}
    for name, xin in (("bf16", x), ("f32", x_f32)):
        err, err_plain, ok = f64_rule(mk.blocked_matmul(xin, w), xin, w)
        log(f"kernel blocked_matmul ({name} x): max |kernel - f64| {err}, "
            f"max |plain - f64| {err_plain}")
        if not ok:
            raise AssertionError(f"blocked_matmul ({name} x) outside the "
                                 "f64 rule")
        errs[name] = (err, err_plain)
    err, err_plain = errs["bf16"]
    x32 = x.float()
    ms = time_ms(lambda: mk.blocked_matmul(x, w))
    ms_f32_x = time_ms(lambda: mk.blocked_matmul(x_f32, w))
    plain = time_ms(lambda: mk.matmul_plain(x, w))
    lib = time_ms(lambda: torch.matmul(x32, w))
    flops = 2 * rows * d * ff
    bnd = bound(rows * d * 2 + d * ff * 4 + rows * ff * 2, 3 * flops,
                BF16_FLOPS)
    bnd_f32_x = bound(rows * d * 4 + d * ff * 4 + rows * ff * 4, 6 * flops,
                      BF16_FLOPS)["bound_ms"]
    log(f"kernel blocked_matmul: {flops / ms / 1e9} TFLOP/s of the f32 "
        f"product (bf16 x; {flops / ms_f32_x / 1e9} with an f32 x, "
        f"{ms_f32_x} ms against a bound of {bnd_f32_x} ms for its 6 bf16 "
        f"piece products), torch.matmul f32 {flops / lib / 1e9} TFLOP/s")
    return dict(name="blocked_matmul", route="cuda",
                source="horovod_tpu_torch/csrc/matmul.cu",
                replaces="horovod_tpu/ops/pallas_collectives.py:473",
                max_abs_err=err, max_abs_err_plain=err_plain,
                max_abs_err_f32_x=errs["f32"][0],
                max_abs_err_plain_f32_x=errs["f32"][1], ms=ms,
                ms_f32_x=ms_f32_x, bound_ms_f32_x=bnd_f32_x,
                tflops=flops / ms / 1e9,
                library_tflops=flops / lib / 1e9,
                plain_ms=plain, **bnd, library_ms=lib)


def model_check(dev) -> None:
    """Small GPTs, flash attention on the card against plain attention,
    same weights, a length that is not a tile multiple: in f32 (the
    CUDA-core kernel, logits within 1e-4) and in bf16 at D = 64 (the
    tensor-core kernel, logits within 5e-2, the bf16 model tests'
    limit)."""
    import torch
    import horovod_tpu_torch as hvd

    for dtype, limit, route in ((torch.float32, 1e-4, "cuda_cores"),
                                (torch.bfloat16, 5e-2, "wgmma")):
        small = dict(vocab_size=512, n_layer=2, n_head=2, d_model=128,
                     d_ff=256, max_seq_len=256, dtype=dtype)
        flash = hvd.models.GPT(hvd.models.GPTConfig(attention="flash",
                                                    **small),
                               device=dev, seed=1)
        full = hvd.models.GPT(hvd.models.GPTConfig(attention="full", **small),
                              device=dev, seed=1)
        gen = torch.Generator(device=dev).manual_seed(1)
        tokens = torch.randint(0, 512, (2, 200), generator=gen, device=dev)
        with torch.no_grad():
            a, b = flash(tokens), full(tokens)
        err = float((a - b).abs().max())
        if not (torch.isfinite(a).all() and a.shape == (2, 200, 512)
                and err <= limit):
            raise AssertionError(f"small {dtype} GPT flash vs full: "
                                 f"max_abs_err {err}")
        log(f"model check: small {dtype} GPT flash ({route}) vs full logits "
            f"max_abs_err {err} (limit {limit})")


def gpt_medium(dev, n_layer: int = GPT_MEDIUM["n_layer"],
               data_seed: int = 0, broadcast: bool = True):
    """(model, batch): GPT-medium (at ``n_layer`` layers) from seed 0 on
    ``dev``, broadcast from rank 0 unless ``broadcast`` is False (a path
    that not every rank takes), and a batch of random tokens from
    ``data_seed``."""
    import torch
    import horovod_tpu_torch as hvd

    cfg = hvd.models.GPTConfig(**{**GPT_MEDIUM, "n_layer": n_layer})
    model = hvd.models.GPT(cfg, device=dev, seed=0)
    if broadcast:
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    gen = torch.Generator(device=dev).manual_seed(data_seed)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, SEQ + 1),
                           generator=gen, device=dev)
    return model, (tokens[:, :-1], tokens[:, 1:])


def dp_step(model):
    """The data-parallel step with AdamW on the int8+EF wire, as a user
    of the port writes it."""
    import torch
    import horovod_tpu_torch as hvd

    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), **ADAMW),
        compression=hvd.Compression.int8, error_feedback=True)
    return hvd.make_train_step(hvd.models.lm_loss_fn(model), opt)


def zero_step(model):
    """The ZeRO-1 step with the same optimizer and wire: AdamW over this
    rank's flat shards, the int8+EF reduce-scatter, the exact all-gather."""
    import torch
    import horovod_tpu_torch as hvd

    return hvd.make_zero_train_step(
        hvd.models.lm_loss_fn(model),
        lambda shards: torch.optim.AdamW(shards, **ADAMW),
        compression=hvd.Compression.int8, error_feedback=True)


def run_steps(label: str, step, model, batch, steps: int) -> dict:
    """``steps`` steps with the launch counts set to 0 just before and
    read just after: losses, step seconds (host clock, each step ending
    in a synchronise), each step's new device allocations (the caching
    allocator's cudaMalloc calls), counts and peak memory.  Every loss
    must be finite."""
    import torch
    import horovod_tpu_torch as hvd

    def device_allocs() -> int:
        return torch.cuda.memory_stats().get("num_device_alloc", -1)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hvd.ops.reset_launch_counts()
    losses, times, mallocs = [], [], []
    for _ in range(steps):
        n0 = device_allocs()
        t0 = time.perf_counter()
        losses.append(float(step(model, batch)))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        mallocs.append(device_allocs() - n0)
    counts = hvd.ops.launch_counts()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{label}: non-finite loss: {losses}")
    return dict(losses=losses, times=times, mallocs=mallocs, counts=counts,
                peak=torch.cuda.max_memory_allocated())


def timed_steps(label: str, model, step, batch, card: str):
    """STEPS GPT-medium steps on one rank (:func:`run_steps`): (counts,
    tokens/s over steps 2-STEPS, peak memory in bytes).  Also logs the
    tokens/s over steps 3-STEPS and each step's new device allocations.
    The flash, quantize and dequantize kernels must have launched."""
    n_params = sum(p.numel() for p in model.parameters())
    run = run_steps(label, step, model, batch, STEPS)
    counts, times, peak = run["counts"], run["times"], run["peak"]
    for name in ("flash_fwd", "quantize_blocks", "dequantize_blocks"):
        if counts[name] <= 0:
            raise AssertionError(f"{name} never launched on the {label} path")
    tok_s = BATCH * SEQ * (STEPS - 1) / sum(times[1:])
    steady = BATCH * SEQ * (STEPS - 2) / sum(times[2:])
    log(f"{label}: GPT-medium {n_params} params, losses {run['losses']}")
    log(f"{label}: step seconds {times}, device allocations {run['mallocs']}")
    log(f"{label}: {tok_s:.1f} tokens/s (steps 2-{STEPS}; {steady:.1f} over "
        f"steps 3-{STEPS}), peak memory {peak / 2**30:.2f} GiB, on {card}")
    log(f"{label}: launches {counts}")
    return counts, tok_s, peak


def train_phase(dev, card: str):
    model, batch = gpt_medium(dev)
    return timed_steps("train", model, dp_step(model), batch, card)


def zero_phase(dev, card: str, dp_tok_s: float, dp_peak: int):
    model, batch = gpt_medium(dev)
    counts, tok_s, peak = timed_steps("zero", model, zero_step(model),
                                      batch, card)
    log(f"zero: {tok_s:.1f} tokens/s and {peak / 2**30:.2f} GiB peak, beside "
        f"the data-parallel step's {dp_tok_s:.1f} tokens/s and "
        f"{dp_peak / 2**30:.2f} GiB")
    return counts


def digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order: equal digests mean equal
    bits."""
    import hashlib
    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().reshape(-1).view(torch.uint8)
                 .cpu().numpy().tobytes())
    return h.hexdigest()


def flat_pad(t, n: int):
    """``t`` flattened and zero padded to a multiple of ``n``."""
    import torch

    flat = t.detach().reshape(-1)
    pad = (-flat.numel()) % n
    return torch.cat([flat, flat.new_zeros(pad)]) if pad else flat


def adam_unfused(p, mu, nu, g, step: int):
    """The reference test's unfused Adam update, in torch ops on the
    gathered gradient (``tests/test_pallas_collectives.py``)."""
    import torch

    b1, b2, eps = 0.9, 0.999, 1e-8
    m_new = b1 * mu + (1 - b1) * g
    v_new = b2 * nu + (1 - b2) * (g * g)
    upd = (m_new / (1.0 - b1 ** step)) / (
        torch.sqrt(v_new / (1.0 - b2 ** step)) + eps)
    return p - APPLY_LR * upd, m_new, v_new


BLOCK0_DENSE = ("attn.qkv", "attn.out", "mlp.up", "mlp.down")


def dp_two_ranks(dev, rank: int) -> dict:
    """Path "2 ranks": data-parallel steps, each rank on its own batch."""
    import torch
    import horovod_tpu_torch as hvd

    model, batch = gpt_medium(dev, n_layer=WIRE_LAYERS, data_seed=1 + rank)
    step = dp_step(model)
    torch.cuda.reset_peak_memory_stats()
    hvd.ops.reset_launch_counts()
    losses = [float(step(model, batch)) for _ in range(WIRE_STEPS)]
    counts = hvd.ops.launch_counts()
    return dict(losses=losses, counts=counts,
                peak=torch.cuda.max_memory_allocated(),
                params=digest(p for _, p in sorted(model.named_parameters())))


def plain_reducescatter(flats, rank: int):
    """Rank ``rank``'s shard of the int8 wire's average of ``flats`` (one
    flat f32 vector a rank, in rank order), from the plain versions of B2
    and B3 with the wire's block and pad rules: what
    ``fused_quantize_reducescatter`` must return, bit for bit."""
    import torch
    from horovod_tpu_torch.ops import int8_kernels as ik

    n = len(flats)
    k = flats[0].numel() // n
    b = max(1, min(1024, k))
    pad = (-k) % b
    qs, ss = [], []
    for flat in flats:
        chunk = flat[rank * k:(rank + 1) * k]
        if pad:
            chunk = torch.cat([chunk, chunk.new_zeros(pad)])
        q, s = ik.quantize_blocks_plain(chunk.reshape(-1, b))
        qs.append(q)
        ss.append(s)
    acc = ik.dequantize_accumulate_plain(torch.stack(qs), torch.stack(ss))
    return acc.reshape(-1)[:k] / n


def sharded_two_ranks(dev, rank: int) -> dict:
    """Path "sharded 2 ranks": (a) ZeRO steps, (b) the fused all-gather +
    apply of every leaf of one backward's gradients, (c) the unshard
    matmul of block 0's Dense layers.  The counts are read after (c);
    the comparisons come after that."""
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import fused_collectives as fc
    from horovod_tpu_torch.ops.fusion import tree_flatten
    from horovod_tpu_torch.ops.quantization import int8_allgather

    n = hvd.size()
    model, batch = gpt_medium(dev, n_layer=WIRE_LAYERS, data_seed=1 + rank)
    step = zero_step(model)
    torch.cuda.reset_peak_memory_stats()
    hvd.ops.reset_launch_counts()
    losses = [float(step(model, batch)) for _ in range(WIRE_STEPS)]
    peak = torch.cuda.max_memory_allocated()
    params = digest(p for _, p in sorted(model.named_parameters()))

    block0, inputs = model.block_0, {}
    hooks = [block0.get_submodule(name).register_forward_hook(
        lambda mod, args, out, name=name: inputs.__setitem__(
            name, args[0].detach()))
        for name in BLOCK0_DENSE]
    model.zero_grad(set_to_none=True)
    hvd.models.lm_loss_fn(model)(model, batch).backward()
    for h in hooks:
        h.remove()
    fused = []
    names, leaves = tree_flatten(dict(model.named_parameters()))
    for name, p in zip(names, leaves):
        pf = flat_pad(p, n)
        shard = fc.fused_quantize_reducescatter(flat_pad(p.grad, n),
                                                op="average")
        zeros = torch.zeros_like(pf)
        a1 = fc.fused_allgather_adam_apply(pf, zeros, zeros, shard,
                                           lr=APPLY_LR, step=1)
        a2 = fc.fused_allgather_adam_apply(*a1, shard, lr=APPLY_LR, step=2)
        sgd = fc.fused_allgather_sgd_apply(pf, shard, lr=APPLY_LR)
        fused.append((name, pf, shard, a1, a2, sgd))
    unshard = []
    for name in BLOCK0_DENSE:
        # The unshard product assumes the same activation on every rank.
        x = inputs[name].reshape(-1, inputs[name].shape[-1]).contiguous()
        dist.broadcast(x, src=0)
        w = block0.get_submodule(name).kernel.detach()
        cols = w.shape[1] // n
        y = hvd.optim.unshard_matmul(x, w[:, rank * cols:(rank + 1) * cols])
        unshard.append((name, x, w, y))
    counts = hvd.ops.launch_counts()

    for (name, _, shard, *_), p in zip(fused, leaves):
        grad = flat_pad(p.grad, n)
        grads = [torch.empty_like(grad) for _ in range(n)]
        dist.all_gather(grads, grad)
        if not bitwise_equal(shard, plain_reducescatter(grads, rank)):
            raise AssertionError(f"{name}: the int8 reduce-scatter differs "
                                 "from its plain form")
    worst = 0.0
    for name, pf, shard, a1, a2, sgd in fused:
        g = int8_allgather(shard)
        zeros = torch.zeros_like(pf)
        pairs = list(zip(a1, adam_unfused(pf, zeros, zeros, g, step=1)))
        pairs += zip(a2, adam_unfused(*a1, g, step=2))
        pairs.append((sgd, pf - APPLY_LR * g))
        for got, ref in pairs:
            if not torch.allclose(got, ref, rtol=1e-6, atol=1e-6):
                raise AssertionError(f"{name}: fused apply off the unfused "
                                     "form by more than 1e-6")
            worst = max(worst, float((got - ref).abs().max()))
    errors = []
    for name, x, w, y in unshard:
        err, err_plain, ok = f64_rule(y, x, w)
        if not ok:
            raise AssertionError(f"unshard_matmul {name}: {err} against the "
                                 f"plain version's {err_plain}")
        errors.append((name, tuple(x.shape), tuple(w.shape), err, err_plain))
    results = digest(t for _, _, _, a1, a2, sgd in fused
                     for t in (*a1, *a2, sgd))
    return dict(losses=losses, counts=counts, params=params, peak=peak,
                results=results + digest(y for *_, y in unshard),
                apply_err=worst, unshard=errors)


def plain_stack_allreduce(xs, op: str):
    """The eager int8 tier's plain form over the contributions ``xs`` (in
    rank order within the set): each quantized once by the plain B2 in
    blocks of ``wire_block_size(numel, n)`` from element 0, summed by the
    plain B3, divided by n for average.  What ``hvd.allreduce(x,
    compression=Compression.int8)`` must return, bit for bit."""
    import torch
    from horovod_tpu_torch.ops import int8_kernels as ik
    from horovod_tpu_torch.ops.quantization import wire_block_size

    n, numel = len(xs), xs[0].numel()
    b = wire_block_size(numel, n)
    qs, ss = zip(*(ik.quantize_blocks_plain(flat_pad(x, b).reshape(-1, b))
                   for x in xs))
    acc = ik.dequantize_accumulate_plain(torch.stack(qs), torch.stack(ss))
    acc = acc.reshape(-1)[:numel].reshape(xs[0].shape)
    return acc / n if op == "average" else acc


def plain_half_stack_allreduce(xs, op: str):
    """The eager int8 tier's plain form for bf16 or f16 contributions
    ``xs`` (in rank order): each quantized once by the plain B2 as
    :func:`plain_stack_allreduce` does, dequantized by the plain B4 and
    rounded to the dtype; the rounded rows added in f32 in rank order
    from zero, the sum rounded to the dtype once, divided by n in the
    dtype for average (the reference's rounding, ROADMAP F4)."""
    import torch
    from horovod_tpu_torch.ops import int8_kernels as ik
    from horovod_tpu_torch.ops.quantization import wire_block_size

    n, numel, dtype = len(xs), xs[0].numel(), xs[0].dtype
    b = wire_block_size(numel, n)
    acc = torch.zeros(numel, dtype=torch.float32, device=xs[0].device)
    for x in xs:
        q, s = ik.quantize_blocks_plain(flat_pad(x.float(), b).reshape(-1, b))
        row = ik.dequantize_blocks_plain(q, s).reshape(-1)[:numel].to(dtype)
        acc = acc + row.float()
    r = acc.to(dtype)
    return (r / n if op == "average" else r).reshape(xs[0].shape)


def adasum_tree_f64(rows):
    """The Adasum of ``rows`` (float64 numpy vectors, in rank order) by
    the reference's tree: the extra members fold into the first, then
    distance doubling; every product and sum in float64."""
    import numpy as np

    def pair(a, b):
        dot, asq, bsq = np.dot(a, b), np.dot(a, a), np.dot(b, b)
        return ((1.0 - (dot / (2 * asq) if asq > 0 else 0.0)) * a
                + (1.0 - (dot / (2 * bsq) if bsq > 0 else 0.0)) * b)

    n = len(rows)
    p = 1 << (n.bit_length() - 1)
    vals = list(rows)
    for e in range(n - p):
        vals[e] = pair(vals[e], vals[p + e])
    d = 1
    while d < p:
        for i in range(0, p, 2 * d):
            vals[i] = pair(vals[i], vals[i + d])
        d *= 2
    return vals[0]


def gather_world(t):
    """Every rank's ``t`` (the same shape on each), ``[world, *shape]``,
    by an exact all-gather."""
    import torch.distributed as dist

    world = dist.get_world_size()
    out = t.new_empty(world * t.numel())
    dist.all_gather_into_tensor(out, t.contiguous().reshape(-1))
    return out.reshape((world,) + tuple(t.shape))


def ragged_rows(rank: int, dev):
    """Rank ``rank``'s ragged input: 3 * (rank + 1) rows of 5."""
    import torch

    k = 3 * (rank + 1)
    return torch.arange(k * 5, dtype=torch.float32, device=dev).reshape(
        k, 5) + 1000 * rank


def ragged_splits(rank: int, n: int):
    k = 3 * (rank + 1)
    return [(k * (j + 1)) // n - (k * j) // n for j in range(n)]


def eager_api(dev, rank: int, sets: dict) -> dict:
    """(a) The eager API on CUDA tensors over the global set and over the
    rank's pair ({0, 2} or {1, 3}, both at once): the int8 allreduce of
    lm_head's gradient shape (async over the global set), ragged
    allgather and alltoall, broadcast, reducescatter, barrier, join, and
    a call on the other pair, which must raise.  Returns the results,
    checked by :func:`check_eager` after the launch counts are read."""
    import torch
    import horovod_tpu_torch as hvd

    mine, other = sets["pair"], sets["other pair"]
    gen = torch.Generator(device=dev).manual_seed(10 + rank)
    x = torch.randn((GPT_MEDIUM["vocab_size"], GPT_MEDIUM["d_model"]),
                    generator=gen, device=dev) * (1 + rank)
    int8 = hvd.Compression.int8
    h = hvd.allreduce_async(x, compression=int8, name="lm_head.global")
    poll_before = hvd.poll(h)
    glob = hvd.synchronize(h)
    in_pair = hvd.allreduce(x, op=hvd.Sum, compression=int8,
                            process_set=mine)
    half = hvd.allreduce(x.to(torch.bfloat16), compression=int8,
                         name="lm_head.bf16")
    n = mine.size()
    ragged = ragged_rows(rank, dev)
    out = dict(x=x, glob=glob, in_pair=in_pair, half=half,
               poll_before=poll_before,
               poll_after=hvd.poll(h),
               gathered=hvd.allgather(ragged, process_set=mine),
               a2a=hvd.alltoall(ragged, ragged_splits(rank, n),
                                process_set=mine),
               bcast=hvd.broadcast(x[:4], mine.ranks[-1], process_set=mine),
               rs=hvd.reducescatter(x[:8], op=hvd.Average))
    hvd.barrier(process_set=mine)
    out["join"] = hvd.join()
    try:
        hvd.allreduce(x[:2], process_set=other)
        out["non_member"] = "no error"
    except ValueError as exc:
        out["non_member"] = str(exc)
    return out


def check_eager(rank: int, sets: dict, got: dict) -> dict:
    """(a)'s checks: the int8 results bit for bit against the tier's plain
    form over the gathered inputs, the rest against what every rank's
    inputs give."""
    import torch

    mine = sets["pair"]
    xs = gather_world(got["x"])
    ok = {
        "int8_global": bitwise_equal(
            got["glob"], plain_stack_allreduce(list(xs), "average")),
        "int8_pair": bitwise_equal(
            got["in_pair"], plain_stack_allreduce([xs[r] for r in mine.ranks],
                                                  "sum")),
        "int8_bf16_global": bitwise_equal(
            got["half"], plain_half_stack_allreduce(
                list(xs.to(torch.bfloat16)), "average")),
        "poll_after": got["poll_after"],
        "join": got["join"] == SET_RANKS - 1,
        "non_member": "not a member" in got["non_member"],
    }
    dev = xs.device
    ok["ragged_allgather"] = torch.equal(got["gathered"], torch.cat(
        [ragged_rows(r, dev) for r in mine.ranks]))
    me, n = mine.ranks.index(rank), mine.size()
    parts = []
    for s in mine.ranks:
        sp = ragged_splits(s, n)
        parts.append(ragged_rows(s, dev)[sum(sp[:me]):sum(sp[:me + 1])])
    gathered, received = got["a2a"]
    ok["ragged_alltoall"] = (torch.equal(gathered, torch.cat(parts)) and
                             received.tolist() == [ragged_splits(s, n)[me]
                                                   for s in mine.ranks])
    ok["broadcast"] = torch.equal(got["bcast"], xs[mine.ranks[-1]][:4])
    mean = xs[:, :8].sum(0) / SET_RANKS
    ok["reducescatter"] = torch.allclose(
        got["rs"], mean[2 * rank:2 * rank + 2], rtol=1e-6, atol=1e-5)
    return dict(ok=ok, poll_before=got["poll_before"])


def set_dp(dev, rank: int, sets: dict) -> dict:
    """(b) Process-set data parallelism: one model per pair, each rank on
    its own batch, the int8+EF wire over the pair; first the int8
    grouped allreduce of one backward's gradient leaves over the pair,
    then WIRE_STEPS steps."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops.fusion import tree_flatten

    mine = sets["pair"]
    model, batch = gpt_medium(dev, n_layer=WIRE_LAYERS, data_seed=20 + rank)
    loss_fn = hvd.models.lm_loss_fn(model)
    loss_fn(model, batch).backward()
    _, grads = tree_flatten({n: p.grad for n, p in model.named_parameters()})
    grads = [g.clone() for g in grads]
    grouped = hvd.grouped_allreduce(grads, compression=hvd.Compression.int8,
                                    process_set=mine)
    model.zero_grad(set_to_none=True)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), **ADAMW),
        compression=hvd.Compression.int8, error_feedback=True,
        process_set=mine)
    step = hvd.make_train_step(loss_fn, opt, process_set=mine)
    losses = [float(step(model, batch)) for _ in range(WIRE_STEPS)]
    return dict(losses=losses, grads=grads, grouped=grouped,
                params=digest(p for _, p in sorted(model.named_parameters())))


def check_grouped(mine, grads, grouped) -> dict:
    """(b)'s grouped int8 allreduce, bucket by bucket (the fusion plan the
    call ran): bit for bit the tier's plain form over the pair's fused
    buckets, gathered exactly."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops.fusion import plan_fused_buckets

    buckets = plan_fused_buckets(grads, hvd.config().fusion_threshold)
    for members in buckets:
        fused = torch.cat([grads[i].reshape(-1) for i in members])
        rows = hvd.allgather(fused, process_set=mine).reshape(mine.size(), -1)
        got = torch.cat([grouped[i].reshape(-1) for i in members])
        if not bitwise_equal(got, plain_stack_allreduce(list(rows),
                                                        "average")):
            raise AssertionError("grouped int8 allreduce differs from its "
                                 "plain form")
    return dict(digest=digest(grouped), buckets=len(buckets))


def adasum_steps(dev, rank: int, sets: dict) -> dict:
    """(c) op=Adasum: WIRE_STEPS steps over all ranks (the first taken by
    hand, so each rank's gradient is kept for the check), then
    WIRE_STEPS over the set {0, 1, 2} (pre-fold and post-scatter), which
    rank 3 stays out of."""
    import torch
    import horovod_tpu_torch as hvd

    out = {}
    model, batch = gpt_medium(dev, n_layer=WIRE_LAYERS, data_seed=30 + rank)
    loss_fn = hvd.models.lm_loss_fn(model)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), **ADAMW), op=hvd.Adasum,
        named_parameters=model.named_parameters())
    loss_fn(model, batch).backward()
    out["local"] = {n: p.grad.clone() for n, p in model.named_parameters()}
    opt.step()
    out["combined"] = {n: p.grad.clone()
                       for n, p in model.named_parameters()}
    step = hvd.make_train_step(loss_fn, opt)
    out["losses"] = [float(step(model, batch))
                     for _ in range(WIRE_STEPS - 1)]
    out["params"] = digest(p for _, p in sorted(model.named_parameters()))
    del model, opt, step
    three = sets["first three"]
    if three.included():
        model, batch = gpt_medium(dev, n_layer=WIRE_LAYERS,
                                  data_seed=40 + rank, broadcast=False)
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), **ADAMW), op=hvd.Adasum,
            process_set=three)
        step = hvd.make_train_step(hvd.models.lm_loss_fn(model), opt,
                                   process_set=three)
        out["losses_three"] = [float(step(model, batch))
                               for _ in range(WIRE_STEPS)]
        out["params_three"] = digest(
            p for _, p in sorted(model.named_parameters()))
    return out


def check_adasum(rank: int, local: dict, combined: dict) -> float:
    """(c)'s first step: every leaf's combined gradient against the
    float64 numpy Adasum tree of the ranks' gradients, rtol 1e-4 and atol
    1e-5 (``tests/test_adasum.py``'s).  Every rank joins the gathers;
    rank 0 checks.  Returns the largest error over the limit's scale."""
    import numpy as np

    worst = 0.0
    for name in sorted(local):
        rows = gather_world(local[name].reshape(-1))
        if rank:
            continue
        rows = rows.double().cpu().numpy()
        want = adasum_tree_f64(list(rows))
        got = combined[name].reshape(-1).double().cpu().numpy()
        scale = 1e-5 + 1e-4 * np.abs(want)
        ratio = float((np.abs(got - want) / scale).max())
        if ratio > 1.0:
            raise AssertionError(f"Adasum of {name} off the float64 tree: "
                                 f"{ratio} x the tolerance")
        worst = max(worst, ratio)
    return worst


def accumulation(dev, rank: int, sets: dict) -> dict:
    """(d) backward_passes_per_step=2 over the pair: call 1 only adds the
    gradients up (the parameters keep their bits), call 2 reduces and
    steps."""
    import torch
    import horovod_tpu_torch as hvd

    mine = sets["pair"]
    model, batch = gpt_medium(dev, n_layer=WIRE_LAYERS, data_seed=50 + rank)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), **ADAMW),
        backward_passes_per_step=2, process_set=mine)
    step = hvd.make_train_step(hvd.models.lm_loss_fn(model), opt,
                               process_set=mine)

    def params():
        return digest(p for _, p in sorted(model.named_parameters()))

    digests = [params()]
    losses = []
    for _ in range(2):
        losses.append(float(step(model, batch)))
        digests.append(params())
    return dict(losses=losses, digests=digests)


def set_ranks(dev, rank: int) -> dict:
    """Path "4 ranks": (a)-(d) with the launch counts set to 0 just before
    and read just after, then the checks."""
    import torch
    import horovod_tpu_torch as hvd

    sets = {"pair": None, "other pair": None}
    for ranks in ([0, 2], [1, 3]):             # collective, in this order
        ps = hvd.add_process_set(ranks)
        sets["pair" if rank in ranks else "other pair"] = ps
    sets["first three"] = hvd.add_process_set([0, 1, 2])
    torch.cuda.reset_peak_memory_stats()
    hvd.ops.reset_launch_counts()
    t0 = time.perf_counter()
    eager = eager_api(dev, rank, sets)
    dp = set_dp(dev, rank, sets)
    ada = adasum_steps(dev, rank, sets)
    acc = accumulation(dev, rank, sets)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = hvd.ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    eager_ok = check_eager(rank, sets, eager)
    grouped = check_grouped(sets["pair"], dp.pop("grads"), dp.pop("grouped"))
    adasum_err = check_adasum(rank, ada.pop("local"), ada.pop("combined"))
    hvd.barrier()                 # leave together: rank 0 checked last
    return dict(counts=counts, seconds=seconds, peak=peak, eager=eager_ok,
                dp=dp, grouped=grouped, adasum=ada, adasum_err=adasum_err,
                acc=acc, pair=list(sets["pair"].ranks))


def four_rank_phase():
    """Path "4 ranks": the collective API, process-set data parallelism,
    Adasum and gradient accumulation (``set_ranks``), four processes
    sharing the card over gloo.  Returns rank 0's launch counts."""
    t0 = time.perf_counter()
    res = spawn_ranks(SET_WORKER_FLAG, SET_RANKS)
    return check_four_ranks(res, time.perf_counter() - t0)


def check_four_ranks(res: list, seconds: float):
    """The "4 ranks" checks across the ranks' results; logs them and
    returns rank 0's launch counts."""
    for r, out in enumerate(res):
        bad = [k for k, v in out["eager"]["ok"].items() if not v]
        if bad:
            raise AssertionError(f"4 ranks: rank {r}'s eager API failed {bad}")
        for name in ("flash_fwd", "quantize_blocks", "dequantize_blocks",
                     "dequantize_accumulate"):
            if out["counts"][name] <= 0:
                raise AssertionError(f"{name} never launched on the 4 ranks "
                                     f"path (rank {r})")
        losses = (out["dp"]["losses"] + out["adasum"]["losses"]
                  + out["acc"]["losses"]
                  + out["adasum"].get("losses_three", []))
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"4 ranks: non-finite loss on rank {r}")
        d = out["acc"]["digests"]
        if not (d[1] == d[0] and d[2] != d[0]):
            raise AssertionError("4 ranks: backward_passes_per_step=2 moved "
                                 "the parameters on call 1 or not on call 2")

    def same(key, ranks):
        return len({key(res[r]) for r in ranks}) == 1

    for pair in ([0, 2], [1, 3]):
        for what, key in (("params", lambda o: o["dp"]["params"]),
                          ("grouped", lambda o: o["grouped"]["digest"]),
                          ("accumulation", lambda o: o["acc"]["digests"][2])):
            if not same(key, pair):
                raise AssertionError(f"4 ranks: set {pair}'s replicas differ "
                                     f"({what})")
    if res[0]["dp"]["params"] == res[1]["dp"]["params"]:
        raise AssertionError("4 ranks: the two sets' models should differ")
    if not same(lambda o: o["adasum"]["params"], range(SET_RANKS)):
        raise AssertionError("4 ranks: Adasum replicas differ")
    if not same(lambda o: o["adasum"]["params_three"], range(3)):
        raise AssertionError("4 ranks: Adasum replicas of {0, 1, 2} differ")
    r0 = res[0]
    shape = [GPT_MEDIUM["vocab_size"], GPT_MEDIUM["d_model"]]
    log(f"4 ranks: eager int8 allreduce of {shape} bitwise "
        f"its plain form over the global set and both pairs, and of its "
        f"bf16 cast over the global set (each contribution rounded to bf16 "
        f"before the f32 sum); poll before the wait "
        f"{[o['eager']['poll_before'] for o in res]}, after True")
    log(f"4 ranks: pair DP losses {[o['dp']['losses'] for o in res]}; "
        f"grouped int8 allreduce of the gradient leaves bitwise its plain "
        f"form over {r0['grouped']['buckets']} fusion buckets")
    log(f"4 ranks: Adasum losses {r0['adasum']['losses']}, over {{0, 1, 2}} "
        f"{r0['adasum']['losses_three']}; first step within "
        f"{r0['adasum_err']} of the float64 tree's tolerance (limit 1)")
    log(f"4 ranks: accumulation losses {[o['acc']['losses'] for o in res]}")
    log(f"4 ranks: {seconds:.1f} s for the phase, {[round(o['seconds'], 1) for o in res]} "
        f"s of path per rank; peak memory per rank "
        f"{[round(o['peak'] / 2**30, 2) for o in res]} GiB; launches "
        f"{r0['counts']}")
    return r0["counts"]


def dense_and_chunked(model, loss_fn_for, batch, param):
    """One forward and backward of ``model`` with ``loss_fn_for(0)`` (the
    dense head) and one with ``loss_fn_for(VOCAB_CHUNK)`` (the chunked
    head), same weights and batch: ``{chunk: (loss, param's gradient,
    peak memory, memory held before)}``."""
    import torch

    runs = {}
    for chunk in (0, VOCAB_CHUNK):
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss = loss_fn_for(chunk)(model, batch)
        loss.backward()
        torch.cuda.synchronize()
        runs[chunk] = (float(loss.detach()), param().grad.clone(),
                       torch.cuda.max_memory_allocated(), base)
    return runs


def heads_agree(label: str, runs: dict) -> tuple:
    """The chunked head's loss within rtol 1e-5 of the dense one's and
    its gradient within rtol 1e-4 / atol 1e-6 (``tests/test_xent.py``'s
    tolerances): (dense, chunked, gradient error); raises otherwise."""
    import torch

    (dense, g_dense, _, _), (chunked, g_chunked, _, _) = \
        runs[0], runs[VOCAB_CHUNK]
    err = float((g_chunked - g_dense).abs().max())
    if not (math.isfinite(dense) and abs(chunked - dense) <= 1e-5 * abs(dense)
            and torch.allclose(g_chunked, g_dense, rtol=1e-4, atol=1e-6)):
        raise AssertionError(f"{label}: chunked loss {chunked} against the "
                             f"dense {dense}, gradient off by {err}")
    return dense, chunked, err


def xent_check(dev) -> None:
    """Part of "1 rank": the chunked LM head on the full-depth model.
    One forward and backward with the dense ``lm_loss_fn`` and one with
    ``vocab_chunk_size=VOCAB_CHUNK``, same weights and batch: the losses
    and lm_head's gradient held by :func:`heads_agree`; logs each one's
    peak memory."""
    import horovod_tpu_torch as hvd

    model, batch = gpt_medium(dev)
    runs = dense_and_chunked(
        model, lambda chunk: hvd.models.lm_loss_fn(
            model, vocab_chunk_size=chunk), batch,
        lambda: model.lm_head.kernel)
    dense, chunked, err = heads_agree("chunked LM head", runs)
    peak_dense, base = runs[0][2], runs[0][3]
    peak_chunked = runs[VOCAB_CHUNK][2]
    log(f"xent: GPT-medium batch {BATCH}, loss dense {dense} chunked "
        f"{chunked} (chunk {VOCAB_CHUNK}), lm_head gradient max_abs_err "
        f"{err}; peak memory dense {peak_dense / 2**30:.3f} GiB, chunked "
        f"{peak_chunked / 2**30:.3f} GiB ({(peak_dense - peak_chunked) / 2**30:.3f}"
        f" GiB saved; {base / 2**30:.3f} GiB held before each)")


def plain_allgather(shards):
    """The int8 all-gather's plain form over every rank's shard (in rank
    order): each quantized by the plain B2 in blocks of min(1024, k), the
    tail zero padded, and dequantized by the plain B4."""
    import torch
    from horovod_tpu_torch.ops import int8_kernels as ik

    out = []
    for shard in shards:
        k = shard.numel()
        b = max(1, min(1024, k))
        q, s = ik.quantize_blocks_plain(flat_pad(shard, b).reshape(-1, b))
        out.append(ik.dequantize_blocks_plain(q, s).reshape(-1)[:k])
    return torch.cat(out)


def plain_overlap_grads(captured, plan, dev):
    """Step 1's reduced gradients built from the plain versions of B2-B4
    over the per-microbatch gradient leaves this rank captured (every
    rank's, gathered exactly, bucket by bucket): each microbatch's
    reduce-scatter of every rank's shard added into accumulators from
    zero in microbatch order, then one all-gather, then / MICROBATCHES.
    What the overlap wire must give, bit for bit."""
    import torch

    n = plan.n
    out = [None] * len(captured[0])
    for bi, members in enumerate(plan.members):
        acc = [torch.zeros(plan.shard_elems[bi], device=dev)
               for _ in range(n)]
        for leaves in captured:
            flat = torch.cat([leaves[j].reshape(-1) for j in members]).to(dev)
            flats = list(gather_world(flat_pad(flat, n)))
            acc = [a + plain_reducescatter(flats, r)
                   for r, a in enumerate(acc)]
        full = plain_allgather(acc)[:plan.payload[bi]]
        for j, piece in zip(members, torch.split(full, plan.cols[bi])):
            out[j] = piece.reshape(captured[0][j].shape) / MICROBATCHES
    return out


def mb_step(model, **kwargs):
    """The slice's step: AdamW, the int8 wire, MICROBATCHES microbatches
    (the overlap wire unless ``overlap=False``) and the chunked LM head."""
    import torch
    import horovod_tpu_torch as hvd

    kwargs.setdefault("microbatches", MICROBATCHES)
    return hvd.make_train_step(
        hvd.models.lm_loss_fn(model, vocab_chunk_size=VOCAB_CHUNK),
        torch.optim.AdamW(model.parameters(), **ADAMW),
        compression=hvd.Compression.int8, **kwargs)


def microbatch_ranks(dev, rank: int) -> dict:
    """Path "microbatch 2 ranks" (and, over NCCL on four cards,
    ``scripts/torch_port_sets_nccl.py --microbatch``): MB_STEPS steps of :func:`mb_step` on
    full-depth GPT-medium, each rank on its own batch of BATCH rows, the
    launch counts set to 0 just before and read just after; step 1's
    per-microbatch gradients are captured at the overlap wire's entry.
    Then (a) step 1's reduced gradients against
    :func:`plain_overlap_grads`; (b) one step with ``two_phase=True``
    and one microbatch from the starting weights, its reduced gradients
    against the single-phase int8 allreduce of the same gradients; and
    the step time with ``overlap=False``."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import fusion
    from horovod_tpu_torch.ops.fusion import tree_flatten

    model, batch = gpt_medium(dev, data_seed=1 + rank)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = mb_step(model)
    captured, plans = [], []
    wire = fusion.overlap_reduce_scatter

    def capture(leaves, plan, **kwargs):
        if len(captured) < MICROBATCHES:
            captured.append([g.detach().cpu() for g in leaves])
            plans.append(plan)
        return wire(leaves, plan, **kwargs)

    losses, digests, times = [], [], []
    fusion.overlap_reduce_scatter = capture
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        hvd.ops.reset_launch_counts()
        t0 = time.perf_counter()
        for i in range(MB_STEPS):
            t = time.perf_counter()
            losses.append(float(step(model, batch)))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            if i == 0:
                reduced = [p.grad.detach().clone() for p in tree_flatten(
                    dict(model.named_parameters()))[1]]
            digests.append(digest(p for _, p in
                                  sorted(model.named_parameters())))
        seconds = time.perf_counter() - t0
        counts = hvd.ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
    finally:
        fusion.overlap_reduce_scatter = wire

    # (a) the overlap wire against the plain composition.
    want = plain_overlap_grads(captured, plans[0], dev)
    plan_ok = all(p == plans[0] for p in plans)
    a_bad = [j for j, (g, w) in enumerate(zip(reduced, want))
             if not bitwise_equal(g, w)]
    buckets = len(plans[0].members)
    del captured, want, reduced

    # (b) two-phase against single-phase, on the same gradients.
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(start[n])
    del start
    seen = {}
    two_phase = fusion.fused_two_phase_apply

    def capture_two_phase(leaves, **kwargs):
        seen["in"] = [g.detach().clone() for g in leaves]
        seen["out"] = two_phase(leaves, **kwargs)
        seen["threshold"] = kwargs["threshold"]
        return seen["out"]

    fusion.fused_two_phase_apply = capture_two_phase
    try:
        tp_loss = float(mb_step(model, microbatches=1, two_phase=True)(
            model, batch))
    finally:
        fusion.fused_two_phase_apply = two_phase
    single = fusion.fused_apply(
        seen["in"], lambda f: hvd.Compression.int8.spmd_allreduce(
            f, op="average"), seen["threshold"])
    b_bad = [j for j, (g, w) in enumerate(zip(seen["out"], single))
             if not bitwise_equal(g, w)]
    sizes = [sum(seen["in"][i].numel() * 4 for i in bucket)
             for bucket in fusion.plan_fused_buckets(seen["in"],
                                                     seen["threshold"])]
    flags = fusion.plan_two_phase_flags(
        sizes, hvd.size(), hvd.config().cost_alpha_us,
        hvd.config().cost_beta_gbps)
    del seen, single

    # The same step without the overlap wire, timed.
    off = mb_step(model, overlap=False)
    off_times = []
    for _ in range(2):
        t = time.perf_counter()
        float(off(model, batch))
        torch.cuda.synchronize()
        off_times.append(time.perf_counter() - t)
    return dict(losses=losses, digests=digests, times=times,
                off_times=off_times, seconds=seconds, counts=counts,
                peak=peak, plan_ok=plan_ok, a_bad=a_bad, buckets=buckets,
                b_bad=b_bad, two_phase_buckets=sum(flags),
                tp_loss=tp_loss)


def microbatch_phase():
    """Path "microbatch 2 ranks", two processes sharing the card over
    gloo (:func:`microbatch_ranks`, :func:`check_microbatch`).  Returns
    rank 0's launch counts."""
    t0 = time.perf_counter()
    res = spawn_ranks(MB_WORKER_FLAG, WIRE_RANKS)
    return check_microbatch(res, time.perf_counter() - t0,
                            "microbatch 2 ranks",
                            "gloo staging through the host, both ranks on "
                            "one card: not a wire's time")


def check_microbatch(res: list, seconds: float, label: str, wire: str):
    """The checks across every rank's results of :func:`microbatch_ranks`;
    logs them (the step times with ``wire``, what carried the
    collectives) and returns rank 0's launch counts."""
    for r, out in enumerate(res):
        if not all(math.isfinite(v) for v in out["losses"] + [out["tp_loss"]]):
            raise AssertionError(f"{label}: non-finite loss on "
                                 f"rank {r}: {out['losses']}")
        if not out["plan_ok"] or out["a_bad"]:
            raise AssertionError(
                f"{label}: step 1's reduced gradient differs from "
                f"the plain composition on rank {r} (leaves {out['a_bad']})")
        if out["b_bad"]:
            raise AssertionError(
                f"{label}: two-phase differs from single-phase on "
                f"rank {r} (leaves {out['b_bad']})")
        for name in ("flash_fwd", "quantize_blocks", "dequantize_accumulate",
                     "dequantize_blocks"):
            if out["counts"][name] <= 0:
                raise AssertionError(f"{name} never launched on the "
                                     f"{label} path (rank {r})")
    if any(out["digests"] != res[0]["digests"] for out in res):
        raise AssertionError(f"{label}: replicas differ")
    r0 = res[0]
    log(f"{label}: GPT-medium, all {GPT_MEDIUM['n_layer']} layers, "
        f"batch {BATCH} a rank in {MICROBATCHES} microbatches, int8 overlap "
        f"wire over {r0['buckets']} buckets, chunked head ({VOCAB_CHUNK}); "
        f"losses {[o['losses'] for o in res]}; replicas bitwise equal after "
        f"every step")
    log(f"{label}: (a) step 1's reduced gradient bitwise the plain "
        f"B2-B4 composition (accumulate from zero, one all-gather, "
        f"/ {MICROBATCHES}); (b) two_phase=True bitwise the single-phase "
        f"int8 allreduce ({r0['two_phase_buckets']} buckets decomposed)")
    log(f"{label}: {seconds:.1f} s for the phase, "
        f"{[round(o['seconds'], 1) for o in res]} s of path per rank; peak "
        f"memory per rank {[round(o['peak'] / 2**30, 2) for o in res]} GiB; "
        f"launches {r0['counts']}")
    log(f"{label}: step seconds with the overlap wire "
        f"{[o['times'] for o in res]}, with overlap=False "
        f"{[o['off_times'] for o in res]} ({wire})")
    return r0["counts"]


# --- the model zoo: ResNet-50, BERT-Large, VGG-16, Inception-V3 -------------

def image_loss(module, batch):
    """``bench.py``'s loss: softmax cross-entropy of the f32 logits."""
    import torch

    images, labels = batch
    logp = torch.log_softmax(module(images).float(), dim=-1)
    return -torch.gather(logp, -1, labels[:, None]).mean()


def images_batch(dev, batch: int, side: int, seed: int):
    """Synthetic NHWC bf16 images and labels from a seeded generator on
    the card, as ``bench.py`` makes them."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    images = torch.randn((batch, side, side, 3), generator=gen, device=dev)
    labels = torch.randint(0, IMAGE_CLASSES, (batch,), generator=gen,
                           device=dev)
    return images.to(torch.bfloat16), labels


def sgd_step(model, compression: str):
    """``bench.py``'s optimizer, ``optax.sgd(0.1, momentum=0.9)`` (torch's
    SGD with momentum 0.9), in a DistributedOptimizer on ``compression``
    (error feedback with int8) through ``make_train_step``."""
    import torch
    import horovod_tpu_torch as hvd

    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), **SGD_MOMENTUM),
        compression=getattr(hvd.Compression, compression),
        error_feedback=compression == "int8")
    return hvd.make_train_step(image_loss, opt)


def per_second(items: int, run: dict) -> float:
    """Items a second on the host clock over the steps after the first."""
    return items * (len(run["times"]) - 1) / sum(run["times"][1:])


def resnet_phase(dev, card: str):
    """Path "resnet50 1 rank": ``bench.py``'s full preset, ResNet-50 at
    1000 classes in bf16 with f32 parameters, BatchNorm in train mode,
    NHWC [RESNET_BATCH, 224, 224, 3] images, SGD-momentum; RESNET_STEPS
    steps on the int8 + error-feedback wire (B2 and B4 at n = 1), then
    as many on the fp16 wire (``bench.py --fp16-allreduce``).  Returns
    the two runs' launch counts."""
    import torch
    import horovod_tpu_torch as hvd

    model = hvd.models.ResNet50(num_classes=IMAGE_CLASSES,
                                dtype=torch.bfloat16, device=dev, seed=0)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    side = IMAGE_SIDE["resnet50"]
    batch = images_batch(dev, RESNET_BATCH, side, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    runs = {}
    for wire in ("int8", "fp16"):
        runs[wire] = run_steps(f"resnet50 1 rank ({wire})",
                               sgd_step(model, wire), model, batch,
                               RESNET_STEPS)
        torch.cuda.empty_cache()
    int8 = runs["int8"]["counts"]
    for name in ("quantize_blocks", "dequantize_blocks"):
        if int8[name] <= 0:
            raise AssertionError(f"{name} never launched on the resnet50 "
                                 "1 rank path")
    for wire, run in runs.items():
        log(f"resnet50 1 rank ({wire} wire): ResNet-50 {n_params} params, "
            f"batch {RESNET_BATCH} at {side}x{side} bf16, losses "
            f"{run['losses']}, "
            f"step seconds {run['times']}, {per_second(RESNET_BATCH, run)} "
            f"images/s (steps 2-{RESNET_STEPS}), peak memory "
            f"{run['peak'] / 2**30:.2f} GiB, on {card}")
    log(f"resnet50 1 rank: B2 {int8['quantize_blocks'] / RESNET_STEPS} and "
        f"B4 {int8['dequantize_blocks'] / RESNET_STEPS} launches a step on "
        f"the int8 wire; launches {int8}; fp16 wire {runs['fp16']['counts']}")
    return int8, runs["fp16"]["counts"]


def resnet_ranks(dev, rank: int) -> dict:
    """Path "resnet50 2 ranks": full ResNet-50 (bf16), every BatchNorm
    synchronised over the global set, RESNET_RANK_BATCH images a rank,
    SGD-momentum on the int8 + EF wire, RESNET_RANK_STEPS steps (the
    counts set to 0 just before and read just after), the digests of
    the parameters and of the running statistics after every step.
    Then the oracle for the synchronised statistics: an f32 ResNet-50
    with the same starting weights, synchronised, forwards this rank's
    images in train mode; rank 0 forwards every rank's images, gathered,
    through the same model with plain BatchNorm."""
    import torch
    import horovod_tpu_torch as hvd

    ps = hvd.global_process_set()
    model = hvd.models.ResNet50(num_classes=IMAGE_CLASSES,
                                dtype=torch.bfloat16, bn_process_set=ps,
                                device=dev, seed=0)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    batch = images_batch(dev, RESNET_RANK_BATCH, IMAGE_SIDE["resnet50"],
                         seed=100 + rank)
    step = sgd_step(model, "int8")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hvd.ops.reset_launch_counts()
    t0 = time.perf_counter()
    losses, params, stats = [], [], []
    for _ in range(RESNET_RANK_STEPS):
        losses.append(float(step(model, batch)))
        params.append(digest(p for _, p in sorted(model.named_parameters())))
        stats.append(digest(b for _, b in sorted(model.named_buffers())))
    seconds = time.perf_counter() - t0
    counts = hvd.ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    del model, step
    torch.cuda.empty_cache()

    images = batch[0].float()
    with torch.no_grad():
        synced = hvd.models.ResNet50(num_classes=IMAGE_CLASSES,
                                     bn_process_set=ps, device=dev, seed=0)
        logits = synced(images)
        synced_stats = {n: b.clone() for n, b in synced.named_buffers()}
        del synced
        everyone = gather_world(images).reshape(-1, *images.shape[1:])
        all_logits = gather_world(logits)
        oracle = dict(err=None, scale=None, stats_err=None)
        if rank == 0:
            plain = hvd.models.ResNet50(num_classes=IMAGE_CLASSES,
                                        device=dev, seed=0)
            want = plain(everyone)
            got = all_logits.reshape(want.shape)
            oracle = dict(
                err=float((got - want).abs().max()),
                scale=float(want.abs().max()),
                stats_err=max(float((synced_stats[n] - b).abs().max()
                                    / b.abs().max())
                              for n, b in plain.named_buffers()))
    return dict(losses=losses, params=params, stats=stats, counts=counts,
                seconds=seconds, peak=peak, oracle=oracle)


def resnet_two_rank_phase():
    """Path "resnet50 2 ranks" (:func:`resnet_ranks`), two processes on
    one card over gloo: replicas and running statistics bitwise equal
    after every step, B2-B4 launched, finite losses, and step 1's
    logits of the synchronised f32 model within 1e-3 of their scale of
    the one-process forward over the concatenated batch with plain
    BatchNorm (the statistics differ by f32 rounding only; a rank that
    normalised with its own statistics would be off by tens of percent),
    every running statistic within 1e-3 of its buffer's largest |value|.
    Returns rank 0's launch counts."""
    t0 = time.perf_counter()
    res = spawn_ranks(RESNET_WORKER_FLAG, WIRE_RANKS)
    seconds = time.perf_counter() - t0
    label = "resnet50 2 ranks"
    for r, out in enumerate(res):
        if not all(math.isfinite(v) for v in out["losses"]):
            raise AssertionError(f"{label}: non-finite loss on rank {r}")
        for name in ("quantize_blocks", "dequantize_accumulate",
                     "dequantize_blocks"):
            if out["counts"][name] <= 0:
                raise AssertionError(f"{name} never launched on the {label} "
                                     f"path (rank {r})")
    for key in ("params", "stats", "losses"):
        if any(out[key] != res[0][key] for out in res):
            raise AssertionError(f"{label}: the ranks' {key} differ")
    oracle = res[0]["oracle"]
    if not (oracle["err"] <= 1e-3 * oracle["scale"]
            and oracle["stats_err"] <= 1e-3):
        raise AssertionError(f"{label}: synchronised BatchNorm off the "
                             f"concatenated-batch oracle: {oracle}")
    r0 = res[0]
    log(f"{label}: ResNet-50 bf16, SyncBN over both ranks, batch "
        f"{RESNET_RANK_BATCH} a rank, int8+EF wire, losses {r0['losses']}; "
        f"parameters and running statistics bitwise equal on both ranks "
        f"after every step")
    log(f"{label}: f32 oracle, step 1's weights: synchronised logits within "
        f"{oracle['err']} of the one-process forward of "
        f"{WIRE_RANKS * RESNET_RANK_BATCH} images with plain BatchNorm "
        f"(scale {oracle['scale']}, limit 1e-3 of it); running statistics "
        f"within {oracle['stats_err']} of each buffer's scale (limit 1e-3)")
    log(f"{label}: {seconds:.1f} s for the phase, "
        f"{[round(o['seconds'], 1) for o in res]} s of steps per rank; peak "
        f"memory per rank {[round(o['peak'] / 2**30, 2) for o in res]} GiB; "
        f"launches {r0['counts']} (gloo staging through the host)")
    return r0["counts"]


def bert_phase(dev, card: str):
    """Path "bert-large 1 rank": ``benchmarks/bert_finetune_bench.py``'s
    configuration, ``BertForSequenceClassification(BertConfig.large(
    attention="flash"), num_classes=2)``, seq BERT_SEQ, batch
    BERT_BATCH, AdamW(2e-5, weight decay 1e-4) in a DistributedOptimizer
    on the fp16 wire, BERT_STEPS steps: B1 must launch once a layer a
    step, every call non-causal.  Then the masked-LM head, dense and
    chunked (:func:`mlm_check`).  Returns the counts."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import flash_attention as fa

    cfg = hvd.models.BertConfig.large(attention="flash")
    model = hvd.models.BertForSequenceClassification(cfg, num_classes=2,
                                                     device=dev, seed=0)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (BERT_BATCH, BERT_SEQ),
                        generator=gen, device=dev)
    labels = torch.randint(0, 2, (BERT_BATCH,), generator=gen, device=dev)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), **BERT_ADAMW),
        compression=hvd.Compression.fp16)
    step = hvd.make_train_step(hvd.models.classification_loss_fn(model), opt)
    flash, causal = fa._Flash3, set()

    class Recording(flash):
        """The attention's autograd function, recording each call's
        causal flag (the kernel wrapper and its count are untouched)."""

        @staticmethod
        def forward(ctx, q3, k3, v3, scale, is_causal):
            causal.add(bool(is_causal))
            return flash.forward(ctx, q3, k3, v3, scale, is_causal)

    fa._Flash3 = Recording
    try:
        run = run_steps("bert-large 1 rank", step, model, (ids, labels),
                        BERT_STEPS)
    finally:
        fa._Flash3 = flash
    counts = run["counts"]
    if counts["flash_fwd"] != cfg.n_layer * BERT_STEPS or causal != {False}:
        raise AssertionError(f"bert-large: flash_fwd launched "
                             f"{counts['flash_fwd']} times (want "
                             f"{cfg.n_layer * BERT_STEPS}), causal {causal}")
    n_params = sum(p.numel() for p in model.parameters())
    log(f"bert-large 1 rank: BERT-Large {n_params} params, seq {BERT_SEQ}, "
        f"batch {BERT_BATCH}, fp16 wire, losses {run['losses']}, step "
        f"seconds {run['times']}, {per_second(BERT_BATCH, run)} seqs/s "
        f"(steps 2-{BERT_STEPS}), peak memory {run['peak'] / 2**30:.2f} "
        f"GiB, on {card}")
    log(f"bert-large 1 rank: flash_fwd {counts['flash_fwd'] / BERT_STEPS} "
        f"launches a step, every one non-causal; launches {counts}")
    del model, opt, step
    torch.cuda.empty_cache()
    mlm_check(dev)
    return counts


def mlm_check(dev) -> None:
    """Part of "bert-large 1 rank": ``BertForMaskedLM`` at BERT-Large's
    widths and depth, one forward and backward with the dense
    ``masked_lm_loss_fn`` and one with ``vocab_chunk_size=VOCAB_CHUNK``,
    same weights and batch (15% of the positions labelled).  In f32
    activations, so that the two heads compute one function: with bf16
    ones the dense head's tied product rounds its logits to bf16 and
    the chunked head's f32 product does not (the reference's contract
    too).  The losses and the tied embedding's gradient held by
    :func:`heads_agree`; logs each one's peak memory."""
    import torch
    import horovod_tpu_torch as hvd

    cfg = hvd.models.BertConfig.large(attention="flash",
                                      dtype=torch.float32)
    model = hvd.models.BertForMaskedLM(cfg, device=dev, seed=1)
    gen = torch.Generator(device=dev).manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (BERT_BATCH, BERT_SEQ),
                        generator=gen, device=dev)
    targets = torch.randint(0, cfg.vocab_size, (BERT_BATCH, BERT_SEQ),
                            generator=gen, device=dev)
    mask = (torch.rand((BERT_BATCH, BERT_SEQ), generator=gen, device=dev)
            < 0.15).float()
    runs = dense_and_chunked(
        model, lambda chunk: hvd.models.masked_lm_loss_fn(
            model, vocab_chunk_size=chunk), (ids, targets, mask),
        lambda: model.bert.tok_embed.embedding)
    dense, chunked, err = heads_agree("masked LM head", runs)
    log(f"bert-large mlm: f32, batch {BERT_BATCH} x {BERT_SEQ}, loss dense "
        f"{dense} chunked {chunked} (chunk {VOCAB_CHUNK}), tied embedding "
        f"gradient max_abs_err {err}; peak memory dense "
        f"{runs[0][2] / 2**30:.3f} GiB, chunked "
        f"{runs[VOCAB_CHUNK][2] / 2**30:.3f} GiB")


def convnet_phase(dev, card: str):
    """Paths "vgg16 1 rank" and "inception3 1 rank": ``bench.py``'s
    shapes (224 and 299 inputs, 1000 classes, bf16), CONVNET_BATCH
    images, one warm-up step, then one step on the int8 + EF wire with
    the counts set to 0 just before and read just after.  VGG's fc6
    gradient (25088 x 4096) is the largest leaf the wire carries.
    Returns ``{path: counts}``."""
    import torch
    import horovod_tpu_torch as hvd

    counts = {}
    for name, cls in (("vgg16", hvd.models.VGG16),
                      ("inception3", hvd.models.InceptionV3)):
        side = IMAGE_SIDE[name]
        kwargs = dict(image_size=side) if name == "vgg16" else {}
        model = cls(num_classes=IMAGE_CLASSES, dtype=torch.bfloat16,
                    device=dev, seed=0, **kwargs)
        batch = images_batch(dev, CONVNET_BATCH, side, seed=1)
        step = sgd_step(model, "int8")
        float(step(model, batch))
        run = run_steps(f"{name} 1 rank", step, model, batch, 1)
        c = run["counts"]
        for k in ("quantize_blocks", "dequantize_blocks"):
            if c[k] <= 0:
                raise AssertionError(f"{k} never launched on {name}")
        largest = max(p.numel() for p in model.parameters())
        log(f"{name} 1 rank: {sum(p.numel() for p in model.parameters())} "
            f"params (largest leaf {largest}), batch {CONVNET_BATCH} at "
            f"{side}x{side} bf16, int8+EF step after a warm-up: loss "
            f"{run['losses'][0]}, {run['times'][0]} s, "
            f"{CONVNET_BATCH / run['times'][0]} images/s, peak memory "
            f"{run['peak'] / 2**30:.2f} GiB, launches {c}, on {card}")
        counts[f"{name} 1 rank"] = c
        del model, step
        torch.cuda.empty_cache()
    return counts


WORKER_FLAG = "--two-rank-worker"
SET_WORKER_FLAG = "--four-rank-worker"
MB_WORKER_FLAG = "--microbatch-worker"
RESNET_WORKER_FLAG = "--resnet-worker"
WORKER_FLAGS = (WORKER_FLAG, SET_WORKER_FLAG, MB_WORKER_FLAG,
                RESNET_WORKER_FLAG)


def rank_worker(flag: str, rank: int, tmp: str) -> None:
    """One rank of a multi-rank phase, run as ``chip_smoke.py FLAG RANK
    DIR``: joins the gloo world of the flag's size through ``DIR/store``,
    runs the phase's path and writes its results to
    ``DIR/rank<RANK>.json``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch as hvd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = SET_RANKS if flag == SET_WORKER_FLAG else WIRE_RANKS
    dist.init_process_group("gloo",
                            init_method=f"file://{os.path.join(tmp, 'store')}",
                            rank=rank, world_size=world)
    hvd.init(device="cuda:0")
    try:
        if flag == WORKER_FLAG:
            dp = dp_two_ranks(hvd.device(), rank)
            torch.cuda.empty_cache()
            res = dict(dp=dp, sharded=sharded_two_ranks(hvd.device(), rank))
        elif flag == MB_WORKER_FLAG:
            res = microbatch_ranks(hvd.device(), rank)
        elif flag == RESNET_WORKER_FLAG:
            res = resnet_ranks(hvd.device(), rank)
        else:
            res = set_ranks(hvd.device(), rank)
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        hvd.shutdown()
        dist.destroy_process_group()


def child_processes() -> list:
    """The pids of this process's living children (Linux ``/proc``)."""
    import glob

    pids = []
    for path in glob.glob(f"/proc/{os.getpid()}/task/*/children"):
        with open(path) as f:
            pids += [int(p) for p in f.read().split()]
    return pids


def spawn_ranks(flag: str, world: int) -> list:
    """Run ``world`` ranks of a phase as plain subprocesses of this script
    (multiprocessing would leave its resource tracker running), each
    waited for or killed before this returns; their results in rank
    order.  NCCL refuses several ranks on one device, so they share the
    card over gloo, which stages CUDA tensors through the host."""
    import tempfile

    script = os.path.abspath(__file__)
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen([sys.executable, script, flag, str(r), tmp])
                 for r in range(world)]
        deadline = time.monotonic() + 600
        try:
            while (any(p.poll() is None for p in procs)
                   and not any(p.returncode for p in procs)
                   and time.monotonic() < deadline):
                time.sleep(1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        codes = [p.returncode for p in procs]
        if any(codes):
            raise AssertionError(f"{flag}: exit codes {codes}")
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                out.append(json.load(f))
    return out


def two_rank_phase():
    """The paths that only two ranks reach: the int8 wire's reduce-scatter
    (kernel dequantize_accumulate) and the sharded optimizer's fused
    kernels, at GPT-medium's widths and WIRE_LAYERS layers."""
    out = {r: (res["dp"], res["sharded"])
           for r, res in enumerate(spawn_ranks(WORKER_FLAG, WIRE_RANKS))}
    (dp0, sh0), (dp1, sh1) = out[0], out[1]
    for path, a, b, kernels in (
            ("2 ranks", dp0, dp1, ("flash_fwd", "quantize_blocks",
                                   "dequantize_blocks",
                                   "dequantize_accumulate")),
            ("sharded 2 ranks", sh0, sh1, ("dequantize_accumulate",
                                           "sgd_apply", "adam_apply",
                                           "blocked_matmul"))):
        if not all(math.isfinite(v) for v in a["losses"] + b["losses"]):
            raise AssertionError(f"{path}: non-finite loss: {a} / {b}")
        if a["params"] != b["params"]:
            raise AssertionError(f"{path}: replicas differ after the steps")
        for name in kernels:
            if a["counts"][name] <= 0 or b["counts"][name] <= 0:
                raise AssertionError(f"{name} never launched on the {path} "
                                     "path")
        log(f"{path} on one card: {WIRE_LAYERS} layers, losses "
            f"{a['losses']} / {b['losses']}, peak memory per rank "
            f"{a['peak'] / 2**30:.2f} / {b['peak'] / 2**30:.2f} GiB, "
            f"launches {a['counts']}")
    if sh0["results"] != sh1["results"]:
        raise AssertionError("sharded 2 ranks: the ranks' fused results "
                             "differ")
    log(f"sharded 2 ranks: fused apply within {sh0['apply_err']} of the "
        f"unfused form (limit 1e-6 abs/rel), ranks bitwise equal")
    for name, xs, ws, err, err_plain in sh0["unshard"]:
        log(f"sharded 2 ranks: unshard_matmul block_0.{name} x {xs} @ w "
            f"{ws}: max |kernel - f64| {err}, max |plain - f64| {err_plain}")
    return dp0["counts"], sh0["counts"]


# The path whose launches a kernel's row reports: the one that reaches it.
PATH_OF = {"dequantize_accumulate": "2 ranks", "sgd_apply": "sharded 2 ranks",
           "adam_apply": "sharded 2 ranks",
           "blocked_matmul": "sharded 2 ranks"}


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
    t0 = t_start = time.perf_counter()
    hvd.ops.build_kernels()
    log(f"build: {time.perf_counter() - t0:.1f} s")

    hvd.init()
    try:
        dev = hvd.device()
        gen = torch.Generator(device=dev).manual_seed(0)
        rows = kernel_phase(dev, gen)
        non_finite_check(dev)
        model_check(dev)
        counts, dp_tok_s, dp_peak = train_phase(dev, card)
        torch.cuda.empty_cache()
        xent_check(dev)
        torch.cuda.empty_cache()
        zero_counts = zero_phase(dev, card, dp_tok_s, dp_peak)
        torch.cuda.empty_cache()
        wire_counts, sharded_counts = two_rank_phase()
        set_counts = four_rank_phase()
        mb_counts = microbatch_phase()
        resnet_counts, resnet_fp16_counts = resnet_phase(dev, card)
        torch.cuda.empty_cache()
        resnet_ranks_counts = resnet_two_rank_phase()
        bert_counts = bert_phase(dev, card)
        torch.cuda.empty_cache()
        convnet_counts = convnet_phase(dev, card)
        route_check(dev)
    finally:
        hvd.shutdown()
    by_path = {"1 rank": counts, "zero 1 rank": zero_counts,
               "2 ranks": wire_counts, "sharded 2 ranks": sharded_counts,
               "4 ranks": set_counts, "microbatch 2 ranks": mb_counts,
               "resnet50 1 rank": resnet_counts,
               "resnet50 1 rank fp16": resnet_fp16_counts,
               "resnet50 2 ranks": resnet_ranks_counts,
               "bert-large 1 rank": bert_counts, **convnet_counts}
    if {row["name"] for row in rows} != set(counts):
        raise AssertionError("the kernels line does not list every kernel")
    for row in rows:
        row["launches_by_path"] = {path: c[row["name"]]
                                   for path, c in by_path.items()}
        row["launches"] = row["launches_by_path"][
            PATH_OF.get(row["name"], "1 rank")]
        if not any(row["launches_by_path"].values()):
            raise AssertionError(f"{row['name']} launched on no path")
    if child_processes():
        raise AssertionError(f"processes left running: {child_processes()}")
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] and sys.argv[1] in WORKER_FLAGS:
        rank_worker(sys.argv[1], int(sys.argv[2]), sys.argv[3])
        sys.exit(0)
    sys.exit(main())
