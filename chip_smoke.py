#!/usr/bin/env python3
"""Smoke run of horovod_tpu_torch on one CUDA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds the kernels from
   ``horovod_tpu_torch/csrc`` (one nvcc per source, in parallel) and
   prints the build time.  The backend probe
   (``utils.backend_probe.wait_for_backend(attempts=1)``, a subprocess
   asking ``torch.cuda``) must find platform ``gpu``, this card's name
   and at least one device; ``utils.mfu.peak_tflops_info`` must give
   (989.0, ``device_kind_table``) on an H100 80GB HBM3 (printed on any
   other card).
2. Kernel phase: each hand-written kernel against its plain PyTorch
   version, on the card, at the shapes the main paths give it.  The int8
   kernels (B2-B4) and the fused apply kernels (B6, B7) must match bit
   for bit, on rows holding NaN (and for B2-B4 Inf) as well; flash
   attention (B1, the bf16 tensor-core kernel) within the bf16 tolerance
   (3e-2 on O, 1e-4 on lse) and, row by row, within 1e-2 of the row's
   largest |O|, on normal and on peaky (q * 8) scores, at GPT-medium's
   causal shape, at BERT-Large's non-causal one, at the ring's
   blocks (causal and non-causal) and at the two rows a rank of the
   pipeline, moe and fsdp paths runs (causal); the blocked
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
   each one's peak memory printed.  Observability (the registry and the
   span ring emptied before the steps): a scrape of this process's
   ``/metrics`` (``HVD_TPU_METRICS_PORT``, a free local port) must show
   ``hvd_tpu_steps_total{kind="train"}`` 5, ``hvd_tpu_tokens_total``
   5 x 8 x 1024, the step-time histogram counting 5 with p50 > 0,
   ``hvd_tpu_tokens_per_s`` > 0, ``hvd_tpu_fusion_traces_total{tier=
   "spmd"}`` 1 (one plan record for the build) and its wire bytes > 0;
   the histogram's p50 is printed beside the synchronised step time;
   ``flight.dump("chip_smoke")`` must write the 5 ``hvd_tpu_step``
   roots; then 4 pairs of builds of the same 5 steps, the metrics gate
   off then on (the hooks' overhead from the medians of steps 2-5,
   printed, not a gate).  Last, one more step under
   ``utils.mfu.count_flops`` (aten's FLOPs; the flash forward, called
   through ctypes, is not counted) and its ``mfu_pct`` at the median
   synchronised step time of steps 2-5, printed, not a gate.
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
   memory.  (e) Observability: each rank's
   ``hvd_tpu_collective_dispatch_total{op}`` must equal the calls it made
   to the seven entry points in (a)-(d) (counted by wrapping them);
   ``cross_rank_summary`` must return the same dict on the four ranks;
   ``check_stragglers`` on a series with rank 2 at 3x the median must
   flag rank 2 only, on every rank.
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
12. "hierarchical 4 ranks": four processes share the card over gloo
   under ``HVD_TPU_TOPO_SPEC=2x2`` and ``HVD_TPU_HIERARCHICAL_INNER=2``,
   full ResNet-50 (bf16, BatchNorm local), 32 images a rank. (1) The
   resolved topology must be 2x2 (a spec that did not factor the world
   would run flat); the compiler's choice a fusion bucket at the default
   α/β under ``auto`` is printed. (2) 3 steps with
   ``HVD_TPU_TOPO_SCHEDULE=hierarchical`` on the int8 + EF wire: finite
   losses, replicas bitwise equal after every step, step 1's reduced
   gradient bit for bit the reduce-scatter inside each pod, the
   allreduce across pods and the all-gather inside the pod composed from
   the plain B2-B4 over every rank's captured bucket; B2-B4 must
   launch; then 2 steps on the flat wire, timed. (3) Integer-valued f32
   of ResNet-50's gradient size (the int8 wire: a per-rank constant on
   the 127·2^k grid) through the flat, two-phase and hierarchical
   schedules on none, fp16, bf16 and int8: bit for bit alike, and alike
   on every rank; ``hvd_tpu_topo_schedules_total{algo="hierarchical"}``
   and ``hvd_tpu_topo_wire_bytes_total{tier="ici"|"dcn"}`` must be > 0,
   each step's root span must hold the three stage spans
   (``hvd_tpu_topo_rs_intra`` / ``_xpod`` / ``_ag_intra``) once a
   hierarchical bucket, and ``hvd_tpu_topo_cost_beta_gbps`` must be set
   for both tiers after the first step. (4) The eager ``allreduce`` with
   ``HOROVOD_HIERARCHICAL_ALLREDUCE`` on (one reduce-scatter of width 2)
   and off, Sum, Average and an int32 Average: bit for bit; the pair
   {0, 2} with it on runs flat. (5) ``make_train_step(microbatches=2,
   overlap=True)`` under ``hierarchical`` (every bucket hierarchical):
   the reduced gradient within 1e-5 of each leaf's largest |value| of
   the flat overlap wire on the same captured gradients, and bit for bit
   on integer-valued leaves. Prints the step seconds hierarchical
   against flat (gloo on one card: not a wire's time), peak memory a
   rank and rank 0's B2/B3/B4 launches.
13. "sequence-parallel 4 ranks": four processes share the card over gloo
   under ``HVD_TPU_MESH_PLAN=data=2,fsdp=2`` (init must have run one
   ``hvd_tpu_plan_compile`` span, and ``hvd_tpu_plan_axes`` must equal
   the plan's axes).  (1) GPT-medium's widths
   (``benchmarks/gpt_bench.py``'s: vocab 32000, 24 layers, 16 heads,
   d_model 1024, d_ff 4096, bf16 activations, f32 parameters) at 4096
   positions, ``attention='ring'`` on the ``'flash'`` engine, on the
   mesh ``{'dp': 1, 'sp': 2, 'tp': 2}`` (``examples/
   gpt_long_context.py``'s at four slots): ``shard_params``,
   ``shard_batch`` of 2 × 4096 tokens from seed 0, 3 AdamW steps of
   ``make_spmd_train_step``: finite losses, the same global loss on
   every rank, the replicated leaves bitwise equal on the four ranks
   after every step, B1 launched on every rank; step 1's loss within
   1e-2 of a one-rank ``attention='flash'`` step on the same weights
   and tokens (rank 0 alone, after the others have left) and its
   gathered parameters at most 2·lr + 1e-6 apart, at most 5% of them
   by more than lr / 2.  (2) At 2 layers, the same widths: the ring's
   ``'xla'`` engine and Ulysses against the ring's flash engine (logits
   within 5e-2 of max(1, |logits|)); a ``{'dp': 2, 'sp': 2}`` step,
   replicas bitwise equal; one int8 ``make_train_step`` step under the
   ``data=2,fsdp=2`` plan against the 1-D plan's (losses within rtol
   1e-6, parameters within rtol 1e-5 / atol 1e-6), B2-B4 launched.
   Prints the step seconds and peak memory per rank beside the card.
14. "pipeline 4 ranks": four processes share the card over gloo.
   GPT-medium (24 layers) as ``PipelinedGPT`` on ``{'pp': 4}``: four
   stages of six blocks, 4 microbatches of 2 × 1024 tokens (the batch of
   8 × 1024 from seed 0 on every rank), 7 ticks, 3 AdamW steps of
   ``make_spmd_train_step``: finite losses, the same on every rank, the
   embedding and head bitwise equal on the four ranks after every step,
   B1 launched exactly 3 × 7 × 6 times a rank; step 1 against the
   one-rank GPT step on the same weights (the pipelined model draws
   GPT's) and tokens, rank 0 alone after the others leave (the limits of
   step 13's oracle); at 4 layers (one block a stage) a remat step: the
   plain step's loss (1e-6) and parameters (1e-6), B1 twice as often.
15. "moe 4 ranks": four processes share the card over gloo.
   GPT-medium's widths, 24 layers, every second FFN a mixture of 8
   experts (top-2, capacity factor 1.25) on ``{'dp': 2, 'ep': 2}``
   (``shard_params``: four experts a rank), 4 × 1024 tokens from seed 0,
   3 AdamW steps on ``lm_loss_fn``: finite losses, the same on every
   rank, the replicated leaves bitwise equal on the four ranks and the
   experts on each dp pair, B1 24 times a step; step 1 against the
   one-rank MoE GPT on the whole batch, full depth, rank 0 alone.
16. "fsdp 4 ranks": four processes share the card over gloo under
   ``HVD_TPU_MESH_PLAN=fsdp=4``.  GPT-medium (24 layers) through
   ``make_fsdp_train_step`` (each parameter cut on its largest
   divisible dim, AdamW on the slices), 2 × 1024 tokens a rank, 3 steps:
   finite losses, the same on every rank, B1 24 times a step; step 1
   against the one-rank data-parallel step on the whole batch; peak
   memory a rank beside the oracle's; at 2 layers one HSDP step
   (``data=2,fsdp=2``, derived from the session plan) against one
   ``fsdp=4`` step (loss within 1e-5, parameters within step 13's
   limits), the data replicas' slices bitwise equal.
17. "autotune 2 ranks": two processes share the card over gloo under
   ``HOROVOD_AUTOTUNE=1`` (1 warmup and 3 scored windows of 2 steps)
   with the int8 wire and error feedback: GPT-medium's widths at 2
   layers, ``make_train_step`` with AdamW in a DistributedOptimizer, 14
   steps: the step is the autotuner's, it freezes, both ranks apply the
   same points, every applied point lies on its knob's lattice, the live
   config is the last one, the replicas agree, and B2, B3 and B4
   launched; ``obs.instrument.autotune_log()`` must hold one window
   entry a scored (and warmup) window and the applied points equal to
   ``applied_knobs``, on both ranks.  Prints the windows' scores.
18. "vgg16 / inception3 1 rank": ``bench.py``'s shapes (224 and 299
   inputs, 1000 classes, bf16), batch 128, one warm-up step, then one
   step on the int8 + EF wire (B2 and B4 must launch; VGG's fc6
   gradient of 102.8 M elements is the wire's largest leaf).
19. "durable 1 rank": GPT-medium (24 layers) with the "1 rank"
   phase's AdamW on the int8+EF wire, a batch of 8 x 1024 tokens a
   step from seed 1000 + step, deterministic algorithms on.  Run A: 6
   steps, twice (the run-to-run floor).  Run B: ``TorchState(model,
   optimizer, step=)`` with ``attach_durable(AsyncCheckpointer(tmp,
   max_to_keep=2), every=2)``, each step journaled (its token seed) and
   committed, stopped after step 4, the writer drained; the model,
   optimizer and checkpointer dropped.  A model from another seed
   ``resume()``s: step 4 with no journal tail, and steps 5-6 must equal
   run A's losses and final parameters bit for bit (or within A's
   run-to-run spread, said so).  Damage drill: under
   ``checkpoint:step=4,mode=corrupt`` step 4 is written again and
   bit-flipped; a model from a third seed ``resume()``s at step 2 with
   the journal's 3-6, the flight ring holds the damaged-step event, and
   the replay of 3-6 must equal run A.  The temp dir's free space is
   checked first (a save is ~5.9 GB).  Prints the save stall (p50, max),
   the write time, bytes a save, the restore time, the commit (device to
   pinned host) and the step times with and without saves.  Its launch
   counts are run B's, the resume's and the replay's (not run A's).
20. "elastic 2 ranks": two processes share the card over gloo in a
   group the session owns (``init(backend="gloo")`` from torchrun's
   variables), GPT-medium's widths at WIRE_LAYERS layers, the int8+EF
   wire: an ``@elastic.run`` loop of 4 steps, each committing and
   allreducing its loss eagerly.  Unfaulted, with ``state.sync()``
   after the step-2 commit; then under ``collective:step=2``: the fault
   must fire once on each rank, 2 tries, 1
   ``hvd_tpu_elastic_resets_total{kind="rollback"}``, a re-init on
   cuda:0 over gloo one rendezvous generation on, the flight dump must
   name the spec and carry the one firing, and the final parameters
   must equal the unfaulted run's bit for bit (the sync hands both ranks
   rank 0's residual); B1-B4 must launch.
21. "launcher 2 ranks": ``python -m horovod_tpu_torch.runner -np 2
   --timeline-filename DIR/tl.json --timeline-mark-cycles
   --stall-check-warning-time-seconds 15 --output-filename DIR/out``
   starts two ranks of this script (``--launcher-worker DIR``), which
   share the card over gloo in a group the session owns.  Each checks
   torchrun's variables and the launch's HMAC key, the native library
   loaded, the timeline writing through ``NativeTimeline`` and the
   cross-process monitor running; then full-depth GPT-medium, a batch
   of 8 x 1024 from seed 0 + rank, ``dp_step``'s AdamW on the int8+EF
   wire, 3 steps each followed by an eager ``allreduce`` of the loss:
   finite losses, replicas bitwise equal, B1-B4 launched.  The native
   planner's plans of the 197 leaves must equal ``plan_buckets_py``,
   and its two-phase and two-tier choices on the same bytes their
   Python twins.  The stall drill: no warning during the steps; rank 1
   sleeps 20 s before an eager ``allreduce`` named ``stall_probe``;
   rank 0's monitor must log the missing-rank warning naming it (read
   from ``DIR/out/rank.0.stderr``) and rank 1's inspector count
   ``hvd_tpu_stall_events_total{kind="warn"}`` >= 1.  The wire: each
   rank serves a ``BasicService`` keyed by the launch's secret; rank 0
   pings both (clock offsets), merges both span rings (3
   ``hvd_tpu_step`` roots a rank, no unresolved parent) and scrapes
   rank 1's steps (3).  The parent checks the exit code, that no
   process is left, both timelines (3 ``ENQUEUE`` and 3 ``EXECUTE``
   for ``loss``, the broadcast's events, 3 step spans, 3 ``train``
   counters, cycle marks) and ``--check-build`` (the four kernel
   libraries and the native runtime built).  Prints the phase's
   seconds, the step times, each timeline's bytes and events, a
   timeline activity's host cost on each writer beside an eager
   allreduce's, and the native planner's time beside the Python one's.
22. "remote 2 hosts": the multi-host launch on one machine: a child
   driver process (``chip_smoke.py --remote-driver DIR``) runs ``python
   -m horovod_tpu_torch.runner -H fake-host-a:1,fake-host-b:1`` with
   ``remote.ssh_exec`` replaced by ``local_exec`` (two task agents on
   loopback; the card's host has no sshd), three times.  (1) The ranks
   (``--remote-worker train DIR``) record torchrun's variables: each
   must have WORLD_SIZE 2, LOCAL_RANK 0, LOCAL_WORLD_SIZE 1, GROUP_RANK
   its rank, GROUP_WORLD_SIZE 2, one MASTER_ADDR:MASTER_PORT on both and
   the same key; ``cross_rank()`` its rank and ``cross_size()`` 2; then
   "launcher 2 ranks"' steps (:func:`launch_steps`, deterministic
   algorithms on in both): losses, parameter digest, launch counts and
   fusion-plan tiers must equal that phase's bit for bit (the launch
   route may change no number), B1-B4 launched.  (2) Failure drill:
   rank 1 exits 7 while rank 0 sleeps; the launcher must return 7
   within 60 s.  (3) Agent-ping drill under
   ``HVD_TPU_AGENT_PING_INTERVAL=1``, ``HVD_TPU_AGENT_MAX_MISSED=2``:
   both ranks sleep, the driver is killed with SIGKILL, and both agents
   must abort their ranks and exit within 30 s.  After each launch no
   agent, rank or child may be left running.
23. "run_func 2 ranks": ``hvd.run(chip_smoke.run_func_body,
   args=("cuda:0",), np=2)`` (the function reached through the module
   ``chip_smoke``, so the standard pickle finds it in the workers), then
   the same with ``hosts="fake-host-a:1,fake-host-b:1"`` and a
   ``workdir`` through the agent mesh: each rank joins the world on the
   card over gloo and int8-allreduces a [32000, 1024] f32 tensor from
   seed ``rank`` (the eager stack tier: B2, then B3); the results must
   come back in rank order, the digests alike and equal to the plain
   B2/B3 composition over the same seeds computed here, B2 and B3
   launched on every rank, no process left.
24. Route check: the profiler's device trace must show a bf16
   flash_fwd call at the step's shape run the tensor-core kernel
   (flash_fwd_wgmma) and an f32 one the CUDA-core kernel, a bf16
   non-causal one at BERT-Large's shape the tensor-core kernel, and B4
   and B3 at rows of 1024 run their vector kernel and at rows of 1023
   only their scalar one.  It runs last, so that the profiler touches
   none of the timed phases.
25. Prints the ``kernels`` JSON line (all seven kernels, with their
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

import contextlib
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
OVERHEAD_TURNS = 4               # off/on pairs of builds timing the hooks
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
        if "rank_rows" in row:
            rr = row["rank_rows"]
            log(f"kernel {row['name']}: at {rr['shape']} causal (two rows: "
                f"the pipeline, moe and fsdp paths) {rr['ms']} ms, plain "
                f"{rr['plain_ms']} ms, bound {rr['bound_ms']} ms "
                f"({rr['bound_by']}; bytes {rr['bytes_ms']} ms, operations "
                f"{rr['ops_ms']} ms), SDPA {rr['library_ms']} ms")
        for rb in row.get("ring_block", []):
            log(f"kernel {row['name']}: at {rb['shape']} "
                f"{'causal' if rb['causal'] else 'non-causal'} (a ring "
                f"block) {rb['ms']} ms, plain {rb['plain_ms']} ms, bound "
                f"{rb['bound_ms']} ms ({rb['bound_by']}; bytes "
                f"{rb['bytes_ms']} ms, operations {rb['ops_ms']} ms), SDPA "
                f"{rb['library_ms']} ms")
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
    row's main shape, at BERT-Large's (B*H = 32*16, T = Tk = 128,
    D = 64, non-causal, bf16) as its ``bert_large`` shape, and at the
    "sequence-parallel 4 ranks" ring's blocks (B*H = 2*8, T = Tk = 2048,
    D = 64, causal and non-causal) as its ``ring_block`` shapes."""
    row = flash_case(dev, gen, BATCH, GPT_MEDIUM["n_head"], SEQ, True,
                     "GPT-medium")
    bert = flash_case(dev, gen, BERT_BATCH, 16, BERT_SEQ, False,
                      "BERT-Large")
    ring = [flash_case(dev, gen, SP_BATCH,
                       GPT_MEDIUM["n_head"] // SP_LAYOUT["tp"],
                       SP_SEQ // SP_LAYOUT["sp"], causal,
                       f"ring block, {'causal' if causal else 'non-causal'}")
            for causal in (True, False)]
    rank_rows = flash_case(dev, gen, BATCH // PIPE_MICRO,
                           GPT_MEDIUM["n_head"], SEQ, True,
                           "two rows: a pipeline microbatch, a moe or fsdp "
                           "rank's batch")
    del row["shape"], row["causal"]
    return dict(name="flash_fwd", route="cuda",
                source="horovod_tpu_torch/csrc/flash_attention.cu",
                replaces="horovod_tpu/ops/pallas_attention.py:38",
                **row, bert_large=bert, ring_block=ring, rank_rows=rank_rows)


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
    return counts, tok_s, peak, times


def scrape(port: int):
    """This rank's scrape port: ``/metrics`` as ``({sample: value},
    [family names])`` and ``/metrics.json``'s snapshot."""
    import urllib.request

    base = f"http://127.0.0.1:{port}"
    with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
        text = r.read().decode()
    samples, families = {}, []
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            families.append(line.split()[2])
        elif line and not line.startswith("#"):
            key, _, value = line.rpartition(" ")
            samples[key] = float(value)
    with urllib.request.urlopen(base + "/metrics.json", timeout=30) as r:
        snapshot = json.loads(r.read().decode())["metrics"]
    return samples, families, snapshot


def obs_train_checks(dev, card: str, sync_times: list, model, batch) -> float:
    """The "1 rank" phase's observability checks after its STEPS steps
    (the registry and the span ring emptied just before them): the
    scrape of ``HVD_TPU_METRICS_PORT`` (steps, tokens, the step-time
    histogram, tokens/s, one ``spmd`` plan record for the build and its
    wire bytes), the histogram's p50 beside the synchronised step time,
    a flight dump holding the STEPS step roots, and the hooks' overhead:
    OVERHEAD_TURNS pairs of builds of STEPS steps, the metrics gate off
    then on (the medians of their steps 2-STEPS; not a gate).
    Returns the seconds these checks added."""
    import statistics
    import tempfile
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.obs import flight, metrics

    t0 = time.perf_counter()
    samples, families, snapshot = scrape(hvd.basics.metrics_port())
    (hist,) = snapshot["hvd_tpu_step_time_seconds"]
    want = {'hvd_tpu_steps_total{kind="train"}': STEPS,
            "hvd_tpu_tokens_total": STEPS * BATCH * SEQ,
            'hvd_tpu_step_time_seconds_count{kind="train"}': STEPS,
            'hvd_tpu_fusion_traces_total{tier="spmd"}': 1}
    for key, value in want.items():
        if samples.get(key) != value:
            raise AssertionError(f"train: scraped {key} = {samples.get(key)}"
                                 f", not {value}")
    tok_s = samples["hvd_tpu_tokens_per_s"]
    wire = samples['hvd_tpu_wire_bytes_total{tier="spmd"}']
    if not (hist["p50"] > 0 and tok_s > 0 and wire > 0):
        raise AssertionError(f"train: scraped step time {hist}, tokens/s "
                             f"{tok_s}, spmd wire bytes {wire}")
    synced = statistics.median(sync_times)
    log(f"train: scraped families {families}")
    log(f"train: step-time histogram p50 {hist['p50']} s (host "
        f"dispatch-to-dispatch, no synchronise in the hooks), synchronised "
        f"step time median {synced} s, p50/synchronised "
        f"{hist['p50'] / synced}; tokens/s gauge {tok_s}; spmd wire bytes "
        f"{wire}; on {card}")
    with tempfile.TemporaryDirectory() as tmp:
        flight.configure(directory=tmp)
        path = flight.dump("chip_smoke")
        with open(path) as f:
            doc = json.load(f)
        flight.configure(directory="")
    roots = [sp for sp in doc["spans"]
             if sp["name"] == "hvd_tpu_step" and sp["parent_id"] is None]
    if len(roots) != STEPS:
        raise AssertionError(f"train: the flight dump holds {len(roots)} "
                             f"step roots, not {STEPS}")
    log(f"train: flight dump {os.path.basename(path)}: keys {sorted(doc)}, "
        f"{len(doc['spans'])} spans, {len(roots)} hvd_tpu_step roots")
    # The hooks' cost, in turns after the phase's warm-up: off, on, four
    # times over, each a fresh build of STEPS steps; steps 2-STEPS of each.
    times = {False: [], True: []}
    for on in (False, True) * OVERHEAD_TURNS:
        metrics.configure(enabled=on)
        try:
            run = run_steps(f"train, HVD_TPU_METRICS={int(on)}",
                            dp_step(model), model, batch, STEPS)
        finally:
            metrics.configure(enabled=True)
        times[on] += run["times"][1:]
    on_s, off_s = (statistics.median(times[k]) for k in (True, False))
    q_on, q_off = (statistics.quantiles(times[k], n=4) for k in (True, False))
    log(f"train: synchronised step seconds in {OVERHEAD_TURNS} turns of "
        f"off then on, steps 2-{STEPS} of each: with the hooks "
        f"{times[True]}, with HVD_TPU_METRICS=0 {times[False]}; medians "
        f"{on_s} / {off_s} s, overhead {100 * (on_s - off_s) / off_s}% "
        f"(not a gate; quartiles with the hooks {q_on[0]}-{q_on[2]} s, "
        f"without {q_off[0]}-{q_off[2]} s), on {card}")
    return time.perf_counter() - t0


def probe_check(card: str) -> None:
    """The backend probe (a subprocess asking ``torch.cuda``) must find
    this card; the MFU table's peak for it is printed (989 TFLOP/s from
    the table on an H100 80GB HBM3, the one gate)."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.utils import backend_probe, mfu

    info = backend_probe.wait_for_backend(attempts=1)
    name = torch.cuda.get_device_name(0)
    if info["platform"] != "gpu" or info["device_kind"] != name \
            or info["n_devices"] < 1:
        raise AssertionError(f"backend probe: {info} on {name}")
    peak = mfu.peak_tflops_info(torch.device("cuda", 0))
    if name == "NVIDIA H100 80GB HBM3" and peak != (989.0,
                                                   "device_kind_table"):
        raise AssertionError(f"peak_tflops_info on {name}: {peak}")
    log(f"backend probe: {info['platform']}, {info['device_kind']}, "
        f"{info['n_devices']} device(s), {info['elapsed_s']} s; "
        f"peak_tflops_info {peak}; on {card}")


def step_mfu(dev, card: str, model, batch, step_s: float) -> None:
    """One more step under ``count_flops`` (aten's FLOPs; the flash
    forward, called through ctypes, is not counted) and ``mfu_pct`` at
    ``step_s`` against the card's peak: printed, not a gate."""
    from horovod_tpu_torch.utils import mfu

    _, flops = mfu.count_flops(dp_step(model), model, batch)
    peak, source = mfu.peak_tflops_info(dev)
    pct = 100.0 * flops / step_s / (peak * 1e12) if flops and peak else None
    log(f"train: one step's counted aten FLOPs {flops}, mfu_pct {pct} at "
        f"the synchronised step median {step_s} s and {peak} TFLOP/s "
        f"({source}), on {card}")


def train_phase(dev, card: str):
    from horovod_tpu_torch.obs import metrics, trace

    model, batch = gpt_medium(dev)
    metrics.registry().reset()
    trace.clear()
    step = dp_step(model)
    counts, tok_s, peak, times = timed_steps("train", model, step, batch,
                                             card)
    del step
    obs_s = obs_train_checks(dev, card, times, model, batch)
    step_mfu(dev, card, model, batch, statistics.median(times[1:]))
    return counts, tok_s, peak, obs_s


def zero_phase(dev, card: str, dp_tok_s: float, dp_peak: int):
    model, batch = gpt_medium(dev)
    counts, tok_s, peak, _ = timed_steps("zero", model, zero_step(model),
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


def plain_reducescatter(flats, rank: int, op: str = "average"):
    """Rank ``rank``'s shard of the int8 wire's average (or, with ``op``
    "sum", sum) of ``flats`` (one flat f32 vector a rank, in rank order),
    from the plain versions of B2 and B3 with the wire's block and pad
    rules: what ``fused_quantize_reducescatter`` must return, bit for
    bit."""
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
    acc = acc.reshape(-1)[:k]
    return acc / n if op == "average" else acc


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


DISPATCH_KINDS = ("allreduce", "grouped_allreduce", "allgather", "broadcast",
                  "alltoall", "reducescatter", "grouped_reducescatter")


@contextlib.contextmanager
def counted_dispatches(calls: dict):
    """Count, by kind, the calls this rank makes to the collective API's
    seven entry points (``<kind>_async``, which every other form goes
    through) that return, wherever the port's modules bind them."""
    from horovod_tpu_torch.ops import collectives as C

    originals = {k: getattr(C, f"{k}_async") for k in DISPATCH_KINDS}
    patched = []

    def counting(kind, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)   # a call that raises dispatched nothing
            calls[kind] = calls.get(kind, 0) + 1
            return out
        return call

    wrappers = {k: counting(k, fn) for k, fn in originals.items()}
    for mod in [m for name, m in list(sys.modules.items())
                if name.startswith("horovod_tpu_torch") and m is not None]:
        for kind, fn in originals.items():
            if getattr(mod, f"{kind}_async", None) is fn:
                setattr(mod, f"{kind}_async", wrappers[kind])
                patched.append((mod, kind))
    try:
        yield calls
    finally:
        for mod, kind in patched:
            setattr(mod, f"{kind}_async", originals[kind])


def obs_set_checks(rank: int, calls: dict) -> dict:
    """The "4 ranks" phase's observability checks: the dispatch counter
    by op against the calls counted, ``cross_rank_summary`` (collective;
    the parent compares the four), and ``check_stragglers`` on a series
    with rank 2 at 3x the median (every rank must flag rank 2 only)."""
    from horovod_tpu_torch.obs import aggregate, metrics

    t0 = time.perf_counter()
    snap = metrics.registry().snapshot()
    counted = {row["labels"]["op"]: row["value"] for row in
               snap.get("hvd_tpu_collective_dispatch_total", [])}
    summary = aggregate.cross_rank_summary({"calls": sum(calls.values())})
    flagged = aggregate.check_stragglers([1.0, 1.0, 3.0, 1.0], factor=2.0,
                                         my_rank=rank)
    suspect = metrics.registry().snapshot()["hvd_tpu_straggler_suspect"]
    return dict(calls=calls, counted=counted, summary=summary,
                flagged=flagged, suspect=suspect[0]["value"],
                seconds=time.perf_counter() - t0)


def set_ranks(dev, rank: int) -> dict:
    """Path "4 ranks": (a)-(d) with the launch counts set to 0 just before
    and read just after, then the checks."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.obs import metrics

    sets = {"pair": None, "other pair": None}
    for ranks in ([0, 2], [1, 3]):             # collective, in this order
        ps = hvd.add_process_set(ranks)
        sets["pair" if rank in ranks else "other pair"] = ps
    sets["first three"] = hvd.add_process_set([0, 1, 2])
    metrics.registry().reset()
    torch.cuda.reset_peak_memory_stats()
    hvd.ops.reset_launch_counts()
    t0 = time.perf_counter()
    with counted_dispatches({}) as calls:
        eager = eager_api(dev, rank, sets)
        dp = set_dp(dev, rank, sets)
        ada = adasum_steps(dev, rank, sets)
        acc = accumulation(dev, rank, sets)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = hvd.ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    obs = obs_set_checks(rank, calls)

    eager_ok = check_eager(rank, sets, eager)
    grouped = check_grouped(sets["pair"], dp.pop("grads"), dp.pop("grouped"))
    adasum_err = check_adasum(rank, ada.pop("local"), ada.pop("combined"))
    hvd.barrier()                 # leave together: rank 0 checked last
    return dict(counts=counts, seconds=seconds, peak=peak, eager=eager_ok,
                dp=dp, grouped=grouped, adasum=ada, adasum_err=adasum_err,
                acc=acc, pair=list(sets["pair"].ranks), obs=obs)


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
    for r, out in enumerate(res):
        o = out["obs"]
        if o["counted"] != o["calls"] or not o["calls"]:
            raise AssertionError(f"4 ranks: rank {r}'s dispatch counter "
                                 f"{o['counted']} != its calls {o['calls']}")
        if o["summary"] != res[0]["obs"]["summary"]:
            raise AssertionError(f"4 ranks: cross_rank_summary differs on "
                                 f"rank {r}")
        if o["flagged"] != [2] or o["suspect"] != float(r == 2):
            raise AssertionError(f"4 ranks: check_stragglers on rank {r}: "
                                 f"{o['flagged']}, suspect {o['suspect']}")
    r0 = res[0]
    log(f"4 ranks: hvd_tpu_collective_dispatch_total by op equals the calls "
        f"each rank made: {[o['obs']['calls'] for o in res]}; "
        f"cross_rank_summary the same on the four ranks: "
        f"{r0['obs']['summary']}; check_stragglers flags rank 2 only on "
        f"every rank; {[o['obs']['seconds'] for o in res]} s of checks a "
        f"rank")
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


# --- "hierarchical 4 ranks": the two-tier schedule on ResNet-50 -------------

HIER_ENV = {"HVD_TPU_TOPO_SPEC": "2x2", "HVD_TPU_HIERARCHICAL_INNER": "2"}
HIER_STEPS, HIER_FLAT_STEPS, HIER_MICROBATCHES = 3, 2, 2


@contextlib.contextmanager
def knobs(**fields):
    """The live config with ``fields`` swapped in for the block (the
    knobs that ``HVD_TPU_TOPO_SCHEDULE`` and
    ``HOROVOD_HIERARCHICAL_ALLREDUCE`` set at init), on this rank."""
    import dataclasses
    from horovod_tpu_torch import basics

    old = basics._session
    basics._session = dataclasses.replace(
        old, config=dataclasses.replace(old.config, **fields))
    try:
        yield
    finally:
        basics._session = old


def plain_allreduce_int8(xs):
    """The int8 allreduce's sum over ``xs`` (one f32 vector a member, in
    member order) from the plain B2-B4: pad to the member count,
    reduce-scatter, all-gather, cut the pad."""
    n, numel = len(xs), xs[0].numel()
    padded = [flat_pad(x, n) for x in xs]
    shards = [plain_reducescatter(padded, i, op="sum") for i in range(n)]
    return plain_allgather(shards)[:numel]


def plain_hierarchical(flats, pods: int, chips: int):
    """The hierarchical schedule's sum over ``flats`` (one flat f32
    vector a rank, in rank order, padded to ``pods * chips``) on the int8
    wire, composed from the plain versions of B2-B4 with each tier's
    block and pad rules: the reduce-scatter inside each pod (``chips``
    contributors), the allreduce of each fragment across the pods at its
    chip index (``pods``), the all-gather inside the pod.  Every rank
    ends with this vector."""
    frags = [[plain_reducescatter(flats[p * chips:(p + 1) * chips], c,
                                  op="sum") for c in range(chips)]
             for p in range(pods)]
    crossed = [plain_allreduce_int8([frags[p][c] for p in range(pods)])
               for c in range(chips)]
    return plain_allgather(crossed)


def collective_calls(calls: list):
    """Wrap torch.distributed's reduce-scatter so each call appends its
    group's width to ``calls``; returns the restore function."""
    import torch.distributed as dist

    fn = dist.reduce_scatter_tensor

    def spy(*args, **kwargs):
        calls.append(dist.get_world_size(kwargs.get("group")))
        return fn(*args, **kwargs)

    dist.reduce_scatter_tensor = spy
    return lambda: setattr(dist, "reduce_scatter_tensor", fn)


def hier_steps(dev, rank: int, model, batch) -> dict:
    """Check 2: HIER_STEPS int8+EF steps under
    ``HVD_TPU_TOPO_SCHEDULE=hierarchical`` (the launch counts set to 0
    just before and read just after), step 1's reduced gradient against
    :func:`plain_hierarchical` over every rank's captured bucket, then
    HIER_FLAT_STEPS steps on the flat wire, timed."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import fusion

    step = sgd_step(model, "int8")
    seen = {}
    apply = fusion.fused_two_phase_apply

    def capture(leaves, **kwargs):
        first = not seen
        if first:
            seen["in"] = [g.detach().clone() for g in leaves]
            seen.update(kwargs)
        out = apply(leaves, **kwargs)
        if first:
            seen["out"] = [g.detach().clone() for g in out]
        return out

    from horovod_tpu_torch.obs import metrics, trace

    losses, times, digests, beta = [], [], [], None
    trace.clear()
    fusion.fused_two_phase_apply = capture
    try:
        with knobs(topo_schedule="hierarchical"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            hvd.ops.reset_launch_counts()
            for _ in range(HIER_STEPS):
                t = time.perf_counter()
                losses.append(float(step(model, batch)))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
                digests.append(digest(p for _, p in
                                      sorted(model.named_parameters())))
                if beta is None:
                    beta = metrics.registry().snapshot().get(
                        "hvd_tpu_topo_cost_beta_gbps", [])
            counts = hvd.ops.launch_counts()
            peak = torch.cuda.max_memory_allocated()
    finally:
        fusion.fused_two_phase_apply = apply
    obs = obs_hier_checks(trace.snapshot(), beta)

    n = hvd.size()
    topo = seen["schedule"].topo
    algos, bad = [], []
    for members in fusion.plan_fused_buckets(seen["in"], seen["threshold"]):
        flat = torch.cat([seen["in"][i].reshape(-1) for i in members])
        algos.append(seen["schedule"].compile(flat.numel() * 4).algo)
        flats = list(gather_world(flat_pad(flat, n)))
        want = plain_hierarchical(flats, topo.pods, topo.chips_per_pod)
        got = torch.cat([seen["out"][i].reshape(-1) for i in members])
        if not bitwise_equal(got, want[:flat.numel()] / n):
            bad.append(members[0])
    del seen

    flat_times = []
    for _ in range(HIER_FLAT_STEPS):
        t = time.perf_counter()
        losses.append(float(step(model, batch)))
        torch.cuda.synchronize()
        flat_times.append(time.perf_counter() - t)
    return dict(losses=losses, times=times, flat_times=flat_times,
                digests=digests, counts=counts, peak=peak, algos=algos,
                bad=bad, obs=obs)


TOPO_STAGES = ("hvd_tpu_topo_rs_intra", "hvd_tpu_topo_xpod",
               "hvd_tpu_topo_ag_intra")


def obs_hier_checks(spans: list, beta: list) -> dict:
    """The "hierarchical 4 ranks" phase's observability record: the topology
    metrics, the stage spans under each step's root (by stage name, a
    step) and the estimator's β gauge read after the first step."""
    from horovod_tpu_torch.obs import metrics

    snap = metrics.registry().snapshot()

    def by(name, label):
        return {row["labels"][label]: row["value"]
                for row in snap.get(name, [])}

    roots = [sp for sp in spans if sp["name"] == "hvd_tpu_step"
             and sp["parent_id"] is None]
    stages = []
    for root in roots:
        kids = [sp["name"] for sp in spans
                if sp["parent_id"] == root["span_id"]]
        stages.append({name: kids.count(name) for name in TOPO_STAGES})
    return dict(schedules=by("hvd_tpu_topo_schedules_total", "algo"),
                tier_bytes=by("hvd_tpu_topo_wire_bytes_total", "tier"),
                stages=stages, beta={row["labels"]["tier"]: row["value"]
                                     for row in beta})


def hier_exact(dev, rank: int, numel: int, topo) -> dict:
    """Check 3: ``numel`` integer-valued f32 elements a rank (the int8
    wire: a per-rank constant on the 127·2^k grid) through the flat,
    two-phase and hierarchical schedules, Average, on each wire: whether
    the three agree bit for bit on this rank, and the result's digest."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.topo import schedule as ts

    gen = torch.Generator(device=dev).manual_seed(200 + rank)
    ints = torch.randint(-8, 9, (numel,), generator=gen,
                         device=dev).float()
    grid = torch.full((numel,), 127.0 * 2 ** (rank % 3), device=dev)
    out = {}
    for wire, x in (("none", ints), ("fp16", ints), ("bf16", ints),
                    ("int8", grid)):
        comp = getattr(hvd.Compression, wire)
        got = [ts.execute_schedule(
            x, ts.compile_bucket_schedule(numel * 4, topo, force=algo),
            op="average", compression=comp) for algo in ts.ALGOS]
        out[wire] = dict(equal=all(bitwise_equal(got[0], g)
                                   for g in got[1:]),
                         digest=digest(got[:1]))
    return out


def hier_eager(dev, rank: int, numel: int) -> dict:
    """Check 4: the eager ``allreduce`` of integer-valued data with
    ``HOROVOD_HIERARCHICAL_ALLREDUCE`` on and off (Sum, Average, and an
    int32 Average): bit for bit equal, and the reduce-scatters issued
    (one of width 2 when on, none when off); then the pair {0, 2} (and
    {1, 3}) with it on: the flat path, the exact sum of the pair."""
    import torch
    import horovod_tpu_torch as hvd

    gen = torch.Generator(device=dev).manual_seed(300 + rank)
    ints = torch.randint(-100, 101, (numel,), generator=gen,
                         device=dev).float()
    cases = {"sum": (ints, hvd.Sum), "average": (ints, hvd.Average),
             "int average": (ints.int(), hvd.Average)}
    out = {}
    for name, (x, op) in cases.items():
        got, calls = {}, {}
        for hier in (True, False):
            seen = []
            restore = collective_calls(seen)
            try:
                with knobs(hierarchical_allreduce=hier):
                    got[hier] = hvd.allreduce(x, op=op)
            finally:
                restore()
            calls[hier] = seen
        out[name] = dict(equal=bitwise_equal(got[True], got[False]),
                         calls=calls[True], flat_calls=calls[False])
    pairs = [hvd.add_process_set(r) for r in ([0, 2], [1, 3])]
    mine = next(ps for ps in pairs if rank in ps.ranks)
    seen = []
    restore = collective_calls(seen)
    try:
        with knobs(hierarchical_allreduce=True):
            got = hvd.allreduce(ints, op=hvd.Sum, process_set=mine)
    finally:
        restore()
    everyone = gather_world(ints)
    want = everyone[list(mine.ranks)].sum(0)
    for ps in pairs:
        hvd.remove_process_set(ps)
    out["pair"] = dict(equal=bitwise_equal(got, want), calls=seen)
    return out


def hier_microbatch(dev, rank: int, model, batch) -> dict:
    """Check 5: one ``make_train_step(microbatches=2, overlap=True)`` step
    under ``HVD_TPU_TOPO_SCHEDULE=hierarchical`` on the exact wire (SGD at
    lr 0: the weights stay), its per-microbatch gradients captured at the
    overlap wire's entry.  The reduced gradient against the flat overlap
    wire run on the same captured gradients, within 1e-5 of each leaf's
    largest |value|; then integer-valued leaves of the same shapes
    through both wires, bit for bit."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import fusion
    from horovod_tpu_torch.ops.fusion import tree_flatten

    captured, kwargs_seen = [], {}
    wire = fusion.overlap_reduce_scatter

    def capture(leaves, plan, **kwargs):
        captured.append([g.detach().clone() for g in leaves])
        kwargs_seen.update(kwargs, plan=plan)
        return wire(leaves, plan, **kwargs)

    step = hvd.make_train_step(
        image_loss, torch.optim.SGD(model.parameters(), lr=0.0),
        microbatches=HIER_MICROBATCHES, overlap=True)
    fusion.overlap_reduce_scatter = capture
    try:
        with knobs(topo_schedule="hierarchical"):
            loss = float(step(model, batch))
    finally:
        fusion.overlap_reduce_scatter = wire
    reduced = [p.grad.detach().clone() for p in tree_flatten(
        dict(model.named_parameters()))[1]]
    plan, topo = kwargs_seen["plan"], kwargs_seen["topo"]
    hier_buckets = sum(fusion._overlap_bucket_schedule(plan, bi, topo)
                       is not None for bi in range(len(plan.members)))

    def overlap(mbs, compiler):
        acc = fusion.zero_overlap_shards(plan, device=dev)
        for leaves in mbs:
            shards = fusion.overlap_reduce_scatter(
                leaves, plan, op="average", topo=compiler).wait()
            acc = tuple(a + s for a, s in zip(acc, shards))
        return [g / len(mbs) for g in fusion.overlap_all_gather(
            acc, plan, mbs[0], topo=compiler)]

    flat = overlap(captured, None)
    worst = max(float((g - f).abs().max() / f.abs().max().clamp_min(1e-30))
                for g, f in zip(reduced, flat))
    gen = torch.Generator(device=dev).manual_seed(400 + rank)
    ints = [[torch.randint(-8, 9, g.shape, generator=gen, device=dev).float()
             for g in leaves] for leaves in captured]
    exact = all(bitwise_equal(a, b) for a, b in
                zip(overlap(ints, topo), overlap(ints, None)))
    return dict(loss=loss, worst=worst, exact=exact,
                buckets=len(plan.members), hier_buckets=hier_buckets)


def hier_ranks(dev, rank: int) -> dict:
    """Path "hierarchical 4 ranks" (and, over NCCL on four cards,
    ``scripts/torch_port_sets_nccl.py --topology 2x2``): under
    ``HVD_TPU_TOPO_SPEC=2x2`` and ``HVD_TPU_HIERARCHICAL_INNER=2``, full
    ResNet-50 (bf16, local BatchNorm), RESNET_RANK_BATCH images a rank.
    (1) the resolved topology and the compiler's choice a fusion bucket
    at the default α/β under ``auto``; (2)-(5) :func:`hier_steps`,
    :func:`hier_exact`, :func:`hier_eager`, :func:`hier_microbatch`."""
    import dataclasses
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import fusion
    from horovod_tpu_torch.topo import schedule as ts
    from horovod_tpu_torch.topo.topology import config_topology

    topo = config_topology(hvd.size())
    model = hvd.models.ResNet50(num_classes=IMAGE_CLASSES,
                                dtype=torch.bfloat16, device=dev, seed=0)
    batch = images_batch(dev, RESNET_RANK_BATCH, IMAGE_SIDE["resnet50"],
                         seed=100 + rank)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    leaves = fusion.tree_flatten(dict(model.named_parameters()))[1]
    auto = ts.maybe_compiler(hvd.size(), mode="auto")
    sizes = [sum(leaves[i].numel() * 4 for i in m) for m in
             fusion.plan_fused_buckets(leaves, hvd.config().fusion_threshold)]
    choice = [[b, auto.compile(b).algo] for b in sizes]
    numel = sum(p.numel() for p in leaves)
    t0 = time.perf_counter()
    steps = hier_steps(dev, rank, model, batch)
    seconds = time.perf_counter() - t0
    torch.cuda.empty_cache()
    exact = hier_exact(dev, rank, numel, topo)
    eager = hier_eager(dev, rank, numel)
    mb = hier_microbatch(dev, rank, model, batch)
    hvd.barrier()
    return dict(topo=list(dataclasses.astuple(topo)), choice=choice,
                numel=numel, seconds=seconds, steps=steps, exact=exact,
                eager=eager, mb=mb, peak=torch.cuda.max_memory_allocated())


def hierarchical_phase():
    """Path "hierarchical 4 ranks" (:func:`hier_ranks`), four processes
    sharing the card over gloo.  Returns rank 0's launch counts."""
    t0 = time.perf_counter()
    res = spawn_ranks(HIER_WORKER_FLAG, SET_RANKS)
    return check_hierarchical(res, time.perf_counter() - t0,
                              "hierarchical 4 ranks",
                              "gloo staging through the host, four ranks on "
                              "one card: not a wire's time")


def check_hierarchical(res: list, seconds: float, label: str, wire: str):
    """The checks of :func:`hier_ranks` across every rank's results; logs
    them (the step times with ``wire``, what carried the collectives) and
    returns rank 0's launch counts."""
    for r, out in enumerate(res):
        if out["topo"] != [2, 2]:
            raise AssertionError(f"{label}: rank {r} resolved the topology "
                                 f"{out['topo']}, not 2x2")
        s = out["steps"]
        if not all(math.isfinite(v) for v in s["losses"]
                   + [out["mb"]["loss"]]):
            raise AssertionError(f"{label}: non-finite loss on rank {r}: "
                                 f"{s['losses']}")
        if set(s["algos"]) != {"hierarchical"} or s["bad"]:
            raise AssertionError(
                f"{label}: step 1's reduced gradient is not the plain "
                f"hierarchical composition on rank {r} (buckets {s['algos']}"
                f", differing at leaves {s['bad']})")
        for name in ("quantize_blocks", "dequantize_accumulate",
                     "dequantize_blocks"):
            if s["counts"][name] <= 0:
                raise AssertionError(f"{name} never launched on the {label} "
                                     f"path (rank {r})")
        bad = [w for w, v in out["exact"].items() if not v["equal"]]
        if bad:
            raise AssertionError(f"{label}: flat, two-phase and hierarchical "
                                 f"differ on exact data, rank {r}: {bad}")
        for name, v in out["eager"].items():
            want_calls = [] if name == "pair" else [2]
            if not v["equal"] or v["calls"] != want_calls \
                    or v.get("flat_calls", []) != []:
                raise AssertionError(f"{label}: eager {name} on rank {r}: "
                                     f"{v}")
        mb = out["mb"]
        if not (mb["worst"] <= 1e-5 and mb["exact"]
                and mb["hier_buckets"] == mb["buckets"]):
            raise AssertionError(f"{label}: microbatch overlap wire on rank "
                                 f"{r}: {mb}")
        o = s["obs"]
        n_hier = len(s["algos"])
        if not (o["schedules"].get("hierarchical", 0) > 0
                and o["tier_bytes"].get("ici", 0) > 0
                and o["tier_bytes"].get("dcn", 0) > 0
                and len(o["stages"]) == HIER_STEPS
                and all(st == dict.fromkeys(TOPO_STAGES, n_hier)
                        for st in o["stages"])
                and set(o["beta"]) == {"ici", "dcn"}
                and min(o["beta"].values()) > 0):
            raise AssertionError(f"{label}: observability on rank {r}: {o}")
    if any(o["steps"]["digests"] != res[0]["steps"]["digests"] for o in res):
        raise AssertionError(f"{label}: replicas differ")
    for wire_name in res[0]["exact"]:
        if len({o["exact"][wire_name]["digest"] for o in res}) != 1:
            raise AssertionError(f"{label}: ranks differ on exact data "
                                 f"({wire_name})")
    r0 = res[0]
    s0 = r0["steps"]
    log(f"{label}: topology {r0['topo'][0]}x{r0['topo'][1]} on every rank; "
        f"auto at the default α/β chose {r0['choice']} (bucket bytes, "
        f"algorithm)")
    log(f"{label}: ResNet-50 bf16, local BatchNorm, batch "
        f"{RESNET_RANK_BATCH} a rank, int8+EF wire, {HIER_STEPS} steps "
        f"hierarchical then {HIER_FLAT_STEPS} flat, losses "
        f"{[o['steps']['losses'] for o in res]}; replicas bitwise equal "
        f"after every hierarchical step; step 1's reduced gradient bitwise "
        f"the plain B2-B4 composition over {len(s0['algos'])} buckets")
    log(f"{label}: {r0['numel']} integer-valued elements through flat, "
        f"two-phase and hierarchical (Average): bitwise on "
        f"{sorted(r0['exact'])} (int8 on the 127·2^k grid); eager "
        f"HOROVOD_HIERARCHICAL_ALLREDUCE Sum, Average, int Average bitwise "
        f"flat, the pair {{0, 2}} flat; microbatches={HIER_MICROBATCHES} "
        f"overlap wire {r0['mb']['hier_buckets']}/{r0['mb']['buckets']} "
        f"buckets hierarchical, within "
        f"{max(o['mb']['worst'] for o in res)} of the flat wire (limit 1e-5 "
        f"of each leaf's scale), bitwise on exact data")
    o0 = s0["obs"]
    log(f"{label}: hvd_tpu_topo_schedules_total {o0['schedules']}, "
        f"hvd_tpu_topo_wire_bytes_total {o0['tier_bytes']}; every step's "
        f"root holds {o0['stages'][0]} stage spans ({len(s0['algos'])} "
        f"hierarchical buckets); hvd_tpu_topo_cost_beta_gbps after step 1 "
        f"{o0['beta']}")
    log(f"{label}: step seconds hierarchical "
        f"{[o['steps']['times'] for o in res]}, flat "
        f"{[o['steps']['flat_times'] for o in res]} ({wire})")
    log(f"{label}: {seconds:.1f} s for the phase, "
        f"{[round(o['seconds'], 1) for o in res]} s of steps per rank; peak "
        f"memory per rank {[round(o['peak'] / 2**30, 2) for o in res]} GiB; "
        f"rank 0's launches over the {HIER_STEPS} hierarchical steps "
        f"{s0['counts']} (B2 {s0['counts']['quantize_blocks']}, B3 "
        f"{s0['counts']['dequantize_accumulate']}, B4 "
        f"{s0['counts']['dequantize_blocks']})")
    return s0["counts"]


# --- "sequence-parallel 4 ranks": ring attention and tensor parallelism -----

SEQ_ENV = {"HVD_TPU_MESH_PLAN": "data=2,fsdp=2"}
SP_LAYOUT = {"dp": 1, "sp": 2, "tp": 2}  # examples/gpt_long_context.py, 4 slots
SP_SEQ, SP_BATCH, SP_STEPS, SP_SHORT_LAYERS = 4096, 2, 3, 2
# Step 1 against the one-rank flash step (bf16 activations both): the
# loss within 1e-2 of it; an Adam step moves an element by at most lr
# (plus a weight decay of lr·1e-4·|p|), so no updated parameter may
# differ by more than 2·lr + 1e-6 (more means a wrong weight, slice or
# gather), and at most SP_FLIP_SHARE of them by more than lr / 2 (an
# update pointing the other way: bf16 rounding flips the sign of
# gradients near zero only).
SP_LOSS_REL, SP_FLIP_SHARE = 1e-2, 0.05
SP_LOGITS_LIMIT = 5e-2   # bf16 logits, of max(1, |logits|): model_check's


def sp_model(dev, layout: dict, n_layer: int, attention: str = "ring",
             engine: str = "flash"):
    """GPT-medium's widths at ``n_layer`` layers and SP_SEQ positions on
    the mesh of ``layout`` from seed 0, sharded (this rank's tp slices):
    (model, mesh)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import make_mesh, shard_params

    cfg = hvd.models.GPTConfig(**{
        **GPT_MEDIUM, "n_layer": n_layer, "max_seq_len": SP_SEQ,
        "attention": attention, "attention_engine": engine})
    mesh = make_mesh(layout)
    model = hvd.models.GPT(cfg, mesh=mesh, device=dev, seed=0)
    return shard_params(model, mesh), mesh


def sp_tokens(dev):
    """The global batch, SP_BATCH × SP_SEQ tokens from seed 0."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, GPT_MEDIUM["vocab_size"],
                           (SP_BATCH, SP_SEQ + 1), generator=gen, device=dev)
    return tokens[:, :-1], tokens[:, 1:]


def sp_main(dev, rank: int) -> dict:
    """The main run: SP_STEPS ``make_spmd_train_step`` steps of the
    24-layer model on SP_LAYOUT, ring attention on the flash engine,
    AdamW; the launch counts set to 0 just before and read just after.
    Step 1's parameters, gathered, go back on rank 0 (on the host)."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import (gather_params, init_opt_state,
                                            make_spmd_train_step,
                                            param_shardings, shard_batch)
    from horovod_tpu_torch.plan import P

    model, mesh = sp_model(dev, SP_LAYOUT, GPT_MEDIUM["n_layer"])
    opt = init_opt_state(lambda ps: torch.optim.AdamW(ps, **ADAMW), model)
    step = make_spmd_train_step(hvd.models.lm_loss_fn(model), opt)
    batch = shard_batch(sp_tokens(dev), mesh, P("dp", "sp"))
    whole = [n for n, s in param_shardings(model, mesh).items()
             if not any(s)]
    losses, times, digests, first = [], [], [], None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hvd.ops.reset_launch_counts()
    for i in range(SP_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step(model, batch)))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        digests.append(digest(p for n, p in model.named_parameters()
                              if n in whole))
        if i == 0:
            gathered = gather_params(model, mesh)
            if rank == 0:
                first = {n: t.cpu() for n, t in gathered.items()}
            del gathered
    counts = hvd.ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    params = sum(p.numel() for p in model.parameters())
    return dict(losses=losses, times=times, digests=digests, counts=counts,
                peak=peak, params=params), first


def sp_logits(dev, layout: dict, attention: str, engine: str):
    """One forward of the SP_SHORT_LAYERS model on ``layout``: this
    rank's logits."""
    import torch
    from horovod_tpu_torch.parallel import shard_batch
    from horovod_tpu_torch.plan import P

    model, mesh = sp_model(dev, layout, SP_SHORT_LAYERS, attention, engine)
    inputs = shard_batch(sp_tokens(dev)[0], mesh, P("dp", "sp"))
    with torch.no_grad():
        return model(inputs)


def logits_err(a, b) -> dict:
    """``a``'s largest difference from ``b``, against SP_LOGITS_LIMIT of
    ``b``'s scale."""
    scale = max(1.0, float(b.abs().max()))
    err = float((a - b).abs().max())
    return dict(err=err, scale=scale, ok=bool(a.isfinite().all())
                and err <= SP_LOGITS_LIMIT * scale)


def sp_short_checks(dev, rank: int) -> dict:
    """At SP_SHORT_LAYERS layers, GPT-medium's widths: the ring's 'xla'
    engine against its 'flash' engine and Ulysses against the ring (one
    forward's logits each), a {'dp': 2, 'sp': 2} step (its digest: the
    dp replicas must agree), and one ``make_train_step`` step on the int8
    wire under the session plan ``data=2,fsdp=2`` against the same step
    on the 1-D plan (the contract of ``tests/test_mesh_plan.py::
    test_2d_plan_matches_1d_numerics``)."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import (init_opt_state,
                                            make_spmd_train_step,
                                            shard_batch)
    from horovod_tpu_torch.plan import P

    out = {}
    flash = sp_logits(dev, SP_LAYOUT, "ring", "flash")
    out["engines"] = logits_err(sp_logits(dev, SP_LAYOUT, "ring", "xla"),
                                flash)
    out["ulysses"] = logits_err(sp_logits(dev, SP_LAYOUT, "ulysses", "xla"),
                                flash)
    del flash
    torch.cuda.empty_cache()

    model, mesh = sp_model(dev, {"dp": 2, "sp": 2}, SP_SHORT_LAYERS)
    opt = init_opt_state(lambda ps: torch.optim.AdamW(ps, **ADAMW), model)
    step = make_spmd_train_step(hvd.models.lm_loss_fn(model), opt)
    loss = float(step(model, shard_batch(sp_tokens(dev), mesh,
                                         P("dp", "sp"))))
    out["dp_sp"] = dict(loss=loss, digest=digest(
        p for _, p in sorted(model.named_parameters())))
    del model, opt, step
    torch.cuda.empty_cache()

    def int8_step():
        model, batch = gpt_medium(dev, n_layer=SP_SHORT_LAYERS,
                                  data_seed=100 + rank)
        step = hvd.make_train_step(
            hvd.models.lm_loss_fn(model),
            torch.optim.AdamW(model.parameters(), **ADAMW),
            compression=hvd.Compression.int8)
        hvd.ops.reset_launch_counts()
        loss = float(step(model, batch))
        return model, loss, hvd.ops.launch_counts()

    plan = hvd.mesh_plan().describe()
    two, loss2, counts2 = int8_step()
    hvd.apply_mesh_plan(None)
    one, loss1, _ = int8_step()
    worst = max(float(((a - b).abs() / (1e-6 + 1e-5 * b.abs())).max())
                for a, b in zip(two.parameters(), one.parameters())
                for a, b in ((a.detach(), b.detach()),))
    out["plan_int8"] = dict(
        plan=plan, loss=loss2, loss_1d=loss1, worst=worst, counts=counts2,
        bitwise=all(bitwise_equal(a, b) for a, b in
                    zip(two.parameters(), one.parameters())))
    return out


def sp_oracle(dev, first: dict, loss: float) -> dict:
    """The one-rank ``attention='flash'`` step on the same weights (seed
    0) and tokens, with no collective (rank 0 runs it alone, after the
    other ranks have freed their memory): step 1's loss and updated
    parameters against the ring run's."""
    import horovod_tpu_torch as hvd

    cfg = hvd.models.GPTConfig(**{**GPT_MEDIUM, "max_seq_len": SP_SEQ})
    return one_rank_oracle(dev, cfg, sp_tokens(dev), first, loss)


def one_rank_oracle(dev, cfg, batch, first: dict, loss: float) -> dict:
    """One AdamW step of ``GPT(cfg, seed=0)`` on the whole ``batch`` on
    this rank alone, no collective: its loss and updated parameters
    against a parallel run's step 1 (``first``: GPT's names, whole
    tensors, on the host; ``loss``)."""
    import torch
    import horovod_tpu_torch as hvd

    model = hvd.models.GPT(cfg, device=dev, seed=0)
    opt = torch.optim.AdamW(model.parameters(), **ADAMW)
    torch.cuda.reset_peak_memory_stats()
    ref = hvd.models.lm_loss_fn(model)(model, batch)
    ref.backward()
    opt.step()
    lr = ADAMW["lr"]
    worst, flips, total, leaf_worst = 0.0, 0, 0, ("", 0.0)
    for name, p in model.named_parameters():
        d = (first[name].to(dev) - p.detach()).abs()
        worst = max(worst, float(d.max()))
        n = int((d > lr / 2).sum())
        flips, total = flips + n, total + d.numel()
        if n / d.numel() > leaf_worst[1]:
            leaf_worst = (name, n / d.numel())
    if set(first) != {name for name, _ in model.named_parameters()}:
        raise AssertionError("the oracle's parameters are not the run's")
    return dict(loss=float(ref.detach()), run_loss=loss, worst=worst,
                flip_share=flips / total, leaf_worst=list(leaf_worst),
                peak=torch.cuda.max_memory_allocated())


def oracle_ok(o: dict) -> bool:
    """Step 1 within SP_LOSS_REL of the oracle's loss, no updated
    parameter more than 2·lr + 1e-6 from its, at most SP_FLIP_SHARE of
    them by more than lr / 2."""
    return (abs(o["run_loss"] - o["loss"]) <= SP_LOSS_REL * abs(o["loss"])
            and o["worst"] <= 2 * ADAMW["lr"] + 1e-6
            and o["flip_share"] <= SP_FLIP_SHARE)


def oracle_line(label: str, o: dict) -> str:
    lr = ADAMW["lr"]
    return (f"{label}: step 1 against the one-rank step: loss "
            f"{o['run_loss']} vs {o['loss']} (limit {SP_LOSS_REL} relative); "
            f"updated parameters at most {o['worst']} apart (limit 2·lr + "
            f"1e-6 = {2 * lr + 1e-6}), {o['flip_share']} of them by more "
            f"than lr/2 (limit {SP_FLIP_SHARE}; worst leaf "
            f"{o['leaf_worst']}); the oracle's peak "
            f"{o['peak'] / 2**30:.2f} GiB")


def seq_ranks(dev, rank: int) -> dict:
    """Path "sequence-parallel 4 ranks" (and, over NCCL on four cards,
    ``scripts/torch_port_sets_nccl.py --spmd``): :func:`sp_main`, then
    :func:`sp_short_checks`; then every rank but 0 frees its memory and
    leaves, and rank 0 runs :func:`sp_oracle`."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.obs import metrics, trace

    compiles = [sp["args"] for sp in trace.snapshot()
                if sp["name"] == "hvd_tpu_plan_compile"]
    axes = {row["labels"]["axis"]: row["value"] for row in
            metrics.registry().snapshot().get("hvd_tpu_plan_axes", [])}
    plan = dict(hvd.mesh_plan().axes)
    t0 = time.perf_counter()
    main, first = sp_main(dev, rank)
    seconds = time.perf_counter() - t0
    torch.cuda.empty_cache()
    short = sp_short_checks(dev, rank)
    torch.cuda.empty_cache()
    hvd.barrier()
    out = dict(main, seconds=seconds, short=short,
               obs=dict(compiles=compiles, axes=axes, plan=plan))
    if rank == 0:
        out["oracle"] = sp_oracle(dev, first, main["losses"][0])
    return out


def sequence_parallel_phase(card: str):
    """Path "sequence-parallel 4 ranks" (:func:`seq_ranks`), four
    processes sharing the card over gloo.  Returns rank 0's launch
    counts."""
    t0 = time.perf_counter()
    res = spawn_ranks(SEQ_WORKER_FLAG, SET_RANKS)
    return check_sequence_parallel(
        res, time.perf_counter() - t0, "sequence-parallel 4 ranks",
        "gloo staging through the host, four ranks on one card: not a "
        "wire's time", card)


def check_sequence_parallel(res: list, seconds: float, label: str,
                            wire: str, card: str):
    """The checks of :func:`seq_ranks` across every rank's results; logs
    them and returns rank 0's launch counts."""
    r0 = res[0]
    for r, out in enumerate(res):
        if not all(math.isfinite(v) for v in out["losses"]):
            raise AssertionError(f"{label}: non-finite loss on rank {r}: "
                                 f"{out['losses']}")
        if out["losses"] != r0["losses"]:
            raise AssertionError(f"{label}: the ranks' global losses differ")
        if out["digests"] != r0["digests"]:
            raise AssertionError(f"{label}: replicated leaves differ between "
                                 f"rank 0 and rank {r}")
        if out["counts"]["flash_fwd"] <= 0:
            raise AssertionError(f"flash_fwd never launched on the {label} "
                                 f"path (rank {r})")
        s = out["short"]
        for name in ("engines", "ulysses"):
            if not s[name]["ok"]:
                raise AssertionError(f"{label}: {name} check on rank {r}: "
                                     f"{s[name]}")
        if s["dp_sp"]["digest"] != r0["short"]["dp_sp"]["digest"] \
                or not math.isfinite(s["dp_sp"]["loss"]):
            raise AssertionError(f"{label}: dp x sp replicas differ (rank "
                                 f"{r})")
        p = s["plan_int8"]
        if not (p["plan"] == SEQ_ENV["HVD_TPU_MESH_PLAN"]
                and abs(p["loss"] - p["loss_1d"]) <= 1e-6 * abs(p["loss_1d"])
                and p["worst"] <= 1.0 and math.isfinite(p["loss"])
                and all(p["counts"][k] > 0 for k in (
                    "quantize_blocks", "dequantize_accumulate",
                    "dequantize_blocks"))):
            raise AssertionError(f"{label}: the data=2,fsdp=2 int8 step off "
                                 f"the 1-D one on rank {r}: {p}")
        ob = out["obs"]
        if not (ob["compiles"] == [{"spec": SEQ_ENV["HVD_TPU_MESH_PLAN"]}]
                and ob["axes"] == {k: float(v) for k, v in ob["plan"].items()}):
            raise AssertionError(f"{label}: plan compile span / axes gauge "
                                 f"on rank {r}: {ob}")
    log(f"{label}: one hvd_tpu_plan_compile span {r0['obs']['compiles']} a "
        f"rank at init; hvd_tpu_plan_axes {r0['obs']['axes']} = the plan")
    o = r0["oracle"]
    if not oracle_ok(o):
        raise AssertionError(f"{label}: step 1 off the one-rank flash step: "
                             f"{o}")
    layout = ",".join(f"{k}={v}" for k, v in SP_LAYOUT.items())
    log(f"{label}: GPT-medium widths, {GPT_MEDIUM['n_layer']} layers, "
        f"{SP_BATCH} x {SP_SEQ} tokens, ring attention on the flash engine, "
        f"{layout}, {r0['params']} parameters a rank, AdamW, losses "
        f"{r0['losses']} (every rank); replicated leaves bitwise equal on "
        f"the four ranks after every step")
    log(oracle_line(label, o))
    s0 = r0["short"]
    log(f"{label}: {SP_SHORT_LAYERS} layers: ring 'xla' vs 'flash' logits "
        f"{[o['short']['engines']['err'] for o in res]}, Ulysses vs ring "
        f"{[o['short']['ulysses']['err'] for o in res]} (limit "
        f"{SP_LOGITS_LIMIT} of max(1, |logits|), scales "
        f"{[o['short']['engines']['scale'] for o in res]}); dp=2,sp=2 step "
        f"replicas bitwise equal; int8 make_train_step under "
        f"HVD_TPU_MESH_PLAN={s0['plan_int8']['plan']} vs the 1-D plan: "
        f"losses {s0['plan_int8']['loss']} / {s0['plan_int8']['loss_1d']}, "
        f"worst parameter {max(o['short']['plan_int8']['worst'] for o in res)}"
        f" of rtol 1e-5 + atol 1e-6, bitwise "
        f"{[o['short']['plan_int8']['bitwise'] for o in res]}")
    log(f"{label}: step seconds {[o['times'] for o in res]} (steps 2-"
        f"{SP_STEPS}: {[o['times'][1:] for o in res]}; {wire}); peak memory "
        f"per rank {[round(o['peak'] / 2**30, 2) for o in res]} GiB; on "
        f"{card}")
    log(f"{label}: {seconds:.1f} s for the phase; flash_fwd launches per "
        f"rank over the {SP_STEPS} steps "
        f"{[o['counts']['flash_fwd'] for o in res]}; rank 0's {r0['counts']}")
    return r0["counts"]


# --- "pipeline 4 ranks", "moe 4 ranks", "fsdp 4 ranks", "autotune 2 ranks" ----

PIPE_LAYOUT = {"pp": 4}
PIPE_MICRO, PIPE_STEPS, PIPE_REMAT_LAYERS = 4, 3, 4
MOE_LAYOUT = {"dp": 2, "ep": 2}
MOE = dict(moe_experts=8, moe_top_k=2, moe_capacity_factor=1.25,
           moe_every=2)                    # GPTConfig's MoE defaults
MOE_BATCH, MOE_STEPS = 4, 3
FSDP_ENV = {"HVD_TPU_MESH_PLAN": "fsdp=4"}
FSDP_STEPS, FSDP_SHORT_LAYERS = 3, 2
AUTOTUNE_ENV = {"HOROVOD_AUTOTUNE": "1",
                "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": "1",
                "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE": "2",
                "HVD_TPU_AUTOTUNE_MAX_SAMPLES": "3",
                "HVD_TPU_COMPRESSION": "int8", "HVD_TPU_ERROR_FEEDBACK": "1"}
AUTOTUNE_STEPS = 14    # 1 unscored + 1 warmup and 3 scored windows of 2,
                       # 3 unscored rebuilds, then 2 frozen


def whole_tokens(dev, rows: int):
    """``rows`` × SEQ tokens from seed 0: (inputs, targets), the same on
    every rank."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, GPT_MEDIUM["vocab_size"], (rows, SEQ + 1),
                           generator=gen, device=dev)
    return tokens[:, :-1], tokens[:, 1:]


def parallel_steps(step, model, batch, steps: int, digest_of) -> dict:
    """``steps`` steps of ``step(model, batch)`` with the launch counts set
    to 0 just before and read just after: losses, step seconds, the
    digest of ``digest_of(model)`` after every step, counts, peak."""
    import torch
    import horovod_tpu_torch as hvd

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hvd.ops.reset_launch_counts()
    losses, times, digests = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(step(model, batch)))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        digests.append(digest(digest_of(model)))
    return dict(losses=losses, times=times, digests=digests,
                counts=hvd.ops.launch_counts(),
                peak=torch.cuda.max_memory_allocated())


def pipe_model(dev, n_layer: int, remat: bool = False):
    """PipelinedGPT at GPT-medium's widths, ``n_layer`` layers over
    PIPE_LAYOUT, PIPE_MICRO microbatches, from seed 0 (GPT's weights)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import make_mesh

    cfg = hvd.models.GPTConfig(**{**GPT_MEDIUM, "n_layer": n_layer})
    return hvd.models.PipelinedGPT(cfg, make_mesh(PIPE_LAYOUT),
                                   n_micro=PIPE_MICRO, remat=remat,
                                   device=dev, seed=0)


def pipe_step(model):
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import init_opt_state, make_spmd_train_step

    opt = init_opt_state(lambda ps: torch.optim.AdamW(ps, **ADAMW), model)
    return make_spmd_train_step(hvd.models.pipelined_lm_loss_fn(model), opt)


def pipe_outside(model):
    """The leaves outside the pipeline (embedding, head): whole on every
    rank."""
    return [p for n, p in sorted(model.named_parameters())
            if not n.startswith("stages.")]


def pipe_gathered(model, rank: int):
    """Rank 0: every parameter under GPT's names on the host, the stages'
    blocks gathered over ``pp`` (collective); None elsewhere."""
    import torch
    import torch.distributed as dist

    out, k = {}, model.blocks_per_stage
    for name, p in model.named_parameters():
        head, rest = name.split(".", 1)
        if head != "stages":
            out[rest] = p.detach().to("cpu", copy=True)
            continue
        pieces = [torch.empty_like(p) for _ in range(model.n_stages)]
        dist.all_gather(pieces, p.detach().contiguous())
        block, leaf = rest.split(".", 1)
        i = int(block.split("_")[1])
        for s, piece in enumerate(pieces):
            out[f"block_{s * k + i}.{leaf}"] = piece.cpu()
    return out if rank == 0 else None


def pipe_remat_check(dev) -> dict:
    """At PIPE_REMAT_LAYERS layers (one block a stage): one step without
    and one with remat from the same weights: losses, the largest
    parameter difference after, B1 launches of each."""
    import torch
    import horovod_tpu_torch as hvd

    out = {}
    params = []
    for remat in (False, True):
        model = pipe_model(dev, PIPE_REMAT_LAYERS, remat)
        step = pipe_step(model)
        hvd.ops.reset_launch_counts()
        loss = float(step(model, whole_tokens(dev, BATCH)))
        out[f"remat_{remat}"] = dict(
            loss=loss, flash=hvd.ops.launch_counts()["flash_fwd"])
        params.append([p.detach().clone() for p in model.parameters()])
        del model, step
        torch.cuda.empty_cache()
    out["worst"] = max(float((a - b).abs().max())
                       for a, b in zip(*params))
    return out


def pipe_ranks(dev, rank: int) -> dict:
    """Path "pipeline 4 ranks": GPT-medium (24 layers) as four stages of
    six blocks, PIPE_MICRO microbatches of BATCH / PIPE_MICRO rows, the
    whole batch on every rank (dp 1), PIPE_STEPS AdamW steps of
    ``make_spmd_train_step``; step 1's parameters gathered to rank 0;
    then the remat check; then rank 0 alone runs the one-rank oracle."""
    import torch
    import horovod_tpu_torch as hvd

    t0 = time.perf_counter()
    model = pipe_model(dev, GPT_MEDIUM["n_layer"])
    step = pipe_step(model)
    batch = whole_tokens(dev, BATCH)
    first = None

    def outside_then_gather(m):
        nonlocal first
        if first is None:
            first = pipe_gathered(m, rank) or {}
        return pipe_outside(m)

    run = parallel_steps(step, model, batch, PIPE_STEPS, outside_then_gather)
    run.update(seconds=time.perf_counter() - t0, stage=model.stage_index,
               params=sum(p.numel() for p in model.parameters()))
    del model, step
    torch.cuda.empty_cache()
    run["remat"] = pipe_remat_check(dev)
    torch.cuda.empty_cache()
    hvd.barrier()
    if rank == 0:
        cfg = hvd.models.GPTConfig(**GPT_MEDIUM)
        run["oracle"] = one_rank_oracle(dev, cfg, batch, first,
                                        run["losses"][0])
    return run


def moe_ranks(dev, rank: int) -> dict:
    """Path "moe 4 ranks": GPT-medium's widths, 24 layers, every second
    FFN a mixture of 8 experts (top-2, capacity factor 1.25) on
    MOE_LAYOUT (the experts cut over ep, the batch over dp), MOE_BATCH ×
    SEQ tokens from seed 0, MOE_STEPS AdamW steps of
    ``make_spmd_train_step`` on ``lm_loss_fn`` alone; step 1's parameters
    gathered (to the host, leaf by leaf); then rank 0 alone runs the
    one-rank oracle on the whole batch."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import (gather_params, init_opt_state,
                                            make_mesh, make_spmd_train_step,
                                            moe_aux_loss, param_shardings,
                                            shard_batch, shard_params)
    from horovod_tpu_torch.plan import P

    t0 = time.perf_counter()
    cfg = hvd.models.GPTConfig(**{**GPT_MEDIUM, **MOE})
    mesh = make_mesh(MOE_LAYOUT)
    model = shard_params(hvd.models.GPT(cfg, mesh=mesh, device=dev, seed=0),
                         mesh)
    torch.cuda.empty_cache()
    opt = init_opt_state(lambda ps: torch.optim.AdamW(ps, **ADAMW), model)
    step = make_spmd_train_step(hvd.models.lm_loss_fn(model), opt)
    whole = whole_tokens(dev, MOE_BATCH)
    batch = shard_batch(whole, mesh, P("dp", None))
    replicated = [n for n, s in param_shardings(model, mesh).items()
                  if not any(s)]
    first = None

    def whole_then_gather(m):
        nonlocal first
        if first is None:
            first = gather_params(m, mesh, to="cpu")
            if rank != 0:
                first = {}
        return [p for n, p in m.named_parameters() if n in replicated]

    run = parallel_steps(step, model, batch, MOE_STEPS, whole_then_gather)
    run["aux"] = float(moe_aux_loss(model, weight=1.0))
    run["expert_digest"] = digest(p for n, p in sorted(
        model.named_parameters()) if n not in replicated)
    run.update(seconds=time.perf_counter() - t0,
               params=sum(p.numel() for p in model.parameters()))
    del model, opt, step
    torch.cuda.empty_cache()
    hvd.barrier()
    if rank == 0:
        run["oracle"] = one_rank_oracle(dev, cfg, whole, first,
                                        run["losses"][0])
    return run


def fsdp_model_step(dev, n_layer: int):
    """GPT-medium (``n_layer`` layers) from seed 0 through
    ``make_fsdp_train_step`` on the session plan: (model, optimizer,
    step)."""
    import torch
    import horovod_tpu_torch as hvd

    cfg = hvd.models.GPTConfig(**{**GPT_MEDIUM, "n_layer": n_layer})
    model = hvd.models.GPT(cfg, device=dev, seed=0)
    shard, step = hvd.make_fsdp_train_step(
        hvd.models.lm_loss_fn(model),
        lambda ps: torch.optim.AdamW(ps, **ADAMW))
    model, opt = shard(model)
    torch.cuda.empty_cache()
    return model, opt, step


def fsdp_rows(dev, rank: int, n: int):
    inputs, targets = whole_tokens(dev, BATCH)
    rows = BATCH // n
    return (inputs[rank * rows:(rank + 1) * rows],
            targets[rank * rows:(rank + 1) * rows])


def fsdp_short(dev, rank: int) -> dict:
    """At FSDP_SHORT_LAYERS layers: one step under ``fsdp=4`` and one
    under HSDP ``data=2,fsdp=2`` (derived from the session plan) from the
    same weights and rows: their step-1 parameters gathered, the loss,
    and the digest of the rank's slices (the data replicas must
    agree)."""
    import horovod_tpu_torch as hvd

    out = {}
    for spec in ("fsdp=4", "data=2,fsdp=2"):
        hvd.apply_mesh_plan(spec)
        model, opt, step = fsdp_model_step(dev, FSDP_SHORT_LAYERS)
        loss = float(step(model, opt, fsdp_rows(dev, rank, SET_RANKS)))
        whole = step.gather(model)
        out[spec] = dict(loss=loss, dp_axis=step.dp_axis,
                         slices=digest(p for _, p in sorted(
                             model.named_parameters())),
                         whole={n: t.cpu() for n, t in whole.items()})
    hvd.apply_mesh_plan(FSDP_ENV["HVD_TPU_MESH_PLAN"])
    a, b = out["fsdp=4"]["whole"], out["data=2,fsdp=2"]["whole"]
    lr = ADAMW["lr"]
    diffs = [(a[n] - b[n]).abs() for n in a]
    short = dict(loss=out["fsdp=4"]["loss"],
                 loss_hsdp=out["data=2,fsdp=2"]["loss"],
                 dp_axis=out["data=2,fsdp=2"]["dp_axis"],
                 slices=out["data=2,fsdp=2"]["slices"],
                 worst=max(float(d.max()) for d in diffs),
                 flip_share=sum(int((d > lr / 2).sum()) for d in diffs)
                 / sum(d.numel() for d in diffs))
    return short


def fsdp_ranks(dev, rank: int) -> dict:
    """Path "fsdp 4 ranks" under ``HVD_TPU_MESH_PLAN=fsdp=4``: GPT-medium
    (24 layers) through ``make_fsdp_train_step`` (every parameter cut on
    its largest divisible dim over the four ranks, AdamW on the slices),
    BATCH / 4 rows a rank, FSDP_STEPS steps; step 1's parameters gathered
    to the host; the HSDP check at FSDP_SHORT_LAYERS layers; then rank 0
    alone runs the one-rank data-parallel step on the whole batch."""
    import torch
    import horovod_tpu_torch as hvd

    t0 = time.perf_counter()
    model, opt, step = fsdp_model_step(dev, GPT_MEDIUM["n_layer"])
    first = None

    def slices_then_gather(m):
        nonlocal first
        if first is None:
            whole = step.gather(m)
            first = {n: t.cpu() for n, t in whole.items()} if rank == 0 \
                else {}
            del whole
        return [p for _, p in sorted(m.named_parameters())]

    run = parallel_steps(lambda m, b: step(m, opt, b), model,
                         fsdp_rows(dev, rank, SET_RANKS), FSDP_STEPS,
                         slices_then_gather)
    run.update(seconds=time.perf_counter() - t0,
               params=sum(p.numel() for p in model.parameters()))
    del model, opt, step
    torch.cuda.empty_cache()
    run["short"] = fsdp_short(dev, rank)
    torch.cuda.empty_cache()
    hvd.barrier()
    if rank == 0:
        cfg = hvd.models.GPTConfig(**GPT_MEDIUM)
        run["oracle"] = one_rank_oracle(dev, cfg, whole_tokens(dev, BATCH),
                                        first, run["losses"][0])
    return run


def autotune_ranks(dev, rank: int) -> dict:
    """Path "autotune 2 ranks" under AUTOTUNE_ENV (``HOROVOD_AUTOTUNE=1``,
    the int8 wire with error feedback): GPT-medium's widths at
    WIRE_LAYERS layers, each rank on its own batch, AUTOTUNE_STEPS calls
    of ``make_train_step`` (AdamW in a DistributedOptimizer), which comes
    back as the autotuner's step: the knobs it searched, every applied
    point, the live config after, and the windows' scores (rank 0's
    log)."""
    import dataclasses
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.optim import AutotunedTrainStep

    pm = hvd.parameter_manager()
    model, batch = gpt_medium(dev, n_layer=WIRE_LAYERS, data_seed=100 + rank)
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(model.parameters(),
                                                     **ADAMW))
    step = hvd.make_train_step(hvd.models.lm_loss_fn(model), opt)
    start = dataclasses.asdict(hvd.config())
    run = parallel_steps(step, model, batch, AUTOTUNE_STEPS, lambda m: [])
    run.update(tuned=isinstance(step, AutotunedTrainStep),
               replicas=digest(p for _, p in sorted(model.named_parameters())),
               knobs=list(pm.knob_names), frozen=pm.frozen,
               applied=step.applied_knobs, start=start,
               config=dataclasses.asdict(hvd.config()))
    from horovod_tpu_torch.obs import instrument

    run["decisions"] = instrument.autotune_log()
    log_path = hvd.config().autotune_log
    if rank == 0 and log_path:
        with open(log_path) as f:
            run["scores"] = [json.loads(line) for line in f]
    return run


def check_pipeline(res: list, seconds: float, label: str, wire: str,
                   card: str):
    r0 = res[0]
    ticks = PIPE_MICRO + PIPE_LAYOUT["pp"] - 1
    blocks = GPT_MEDIUM["n_layer"] // PIPE_LAYOUT["pp"]
    for r, out in enumerate(res):
        if not all(math.isfinite(v) for v in out["losses"]) \
                or out["losses"] != r0["losses"]:
            raise AssertionError(f"{label}: losses differ or are not finite "
                                 f"on rank {r}: {out['losses']}")
        if out["digests"] != r0["digests"]:
            raise AssertionError(f"{label}: the embedding or head differs "
                                 f"between rank 0 and rank {r}")
        if out["counts"]["flash_fwd"] != PIPE_STEPS * ticks * blocks:
            raise AssertionError(
                f"{label}: rank {r} launched flash_fwd "
                f"{out['counts']['flash_fwd']} times, not {PIPE_STEPS} steps "
                f"x {ticks} ticks x {blocks} blocks")
        rm = out["remat"]
        if not (rm["remat_True"]["flash"] == 2 * rm["remat_False"]["flash"]
                and abs(rm["remat_True"]["loss"] - rm["remat_False"]["loss"])
                <= 1e-6 * abs(rm["remat_False"]["loss"])
                and rm["worst"] <= 1e-6):
            raise AssertionError(f"{label}: remat off the plain step on rank "
                                 f"{r}: {rm}")
    if not oracle_ok(r0["oracle"]):
        raise AssertionError(f"{label}: step 1 off the one-rank step: "
                             f"{r0['oracle']}")
    log(f"{label}: GPT-medium, {GPT_MEDIUM['n_layer']} layers as "
        f"{PIPE_LAYOUT['pp']} stages of {blocks}, {PIPE_MICRO} microbatches "
        f"of {BATCH // PIPE_MICRO} x {SEQ} tokens, {ticks} ticks, "
        f"{[o['params'] for o in res]} parameters a rank, AdamW, losses "
        f"{r0['losses']} (every rank); embedding and head bitwise equal on "
        f"the four ranks after every step")
    log(oracle_line(label, r0["oracle"]))
    rm = r0["remat"]
    log(f"{label}: {PIPE_REMAT_LAYERS} layers, remat against none: losses "
        f"{rm['remat_True']['loss']} / {rm['remat_False']['loss']}, largest "
        f"parameter difference after the step {rm['worst']}, flash_fwd "
        f"{rm['remat_True']['flash']} / {rm['remat_False']['flash']}")
    log(f"{label}: step seconds {[o['times'] for o in res]} ({wire}); peak "
        f"memory per rank {[round(o['peak'] / 2**30, 2) for o in res]} GiB; "
        f"on {card}")
    log(f"{label}: {seconds:.1f} s for the phase; flash_fwd launches per "
        f"rank {[o['counts']['flash_fwd'] for o in res]}; rank 0's "
        f"{r0['counts']}")
    return r0["counts"]


def check_moe(res: list, seconds: float, label: str, wire: str, card: str):
    r0 = res[0]
    coords = [dict(zip(MOE_LAYOUT, divmod(r, MOE_LAYOUT["ep"])))
              for r in range(len(res))]
    for r, out in enumerate(res):
        if not all(math.isfinite(v) for v in out["losses"]) \
                or out["losses"] != r0["losses"]:
            raise AssertionError(f"{label}: losses differ or are not finite "
                                 f"on rank {r}: {out['losses']}")
        if out["digests"] != r0["digests"]:
            raise AssertionError(f"{label}: replicated leaves differ between "
                                 f"rank 0 and rank {r}")
        twin = next(q for q in range(len(res)) if q != r
                    and coords[q]["ep"] == coords[r]["ep"])
        if out["expert_digest"] != res[twin]["expert_digest"]:
            raise AssertionError(f"{label}: the experts of ranks {r} and "
                                 f"{twin} (one ep index) differ")
        if out["counts"]["flash_fwd"] != MOE_STEPS * GPT_MEDIUM["n_layer"]:
            raise AssertionError(f"{label}: rank {r} launched flash_fwd "
                                 f"{out['counts']['flash_fwd']} times")
    if not oracle_ok(r0["oracle"]):
        raise AssertionError(f"{label}: step 1 off the one-rank step: "
                             f"{r0['oracle']}")
    layout = ",".join(f"{k}={v}" for k, v in MOE_LAYOUT.items())
    log(f"{label}: GPT-medium widths, {GPT_MEDIUM['n_layer']} layers, "
        f"{GPT_MEDIUM['n_layer'] // MOE['moe_every']} MoE blocks of "
        f"{MOE['moe_experts']} experts (top-{MOE['moe_top_k']}, capacity "
        f"factor {MOE['moe_capacity_factor']}), {layout}, {MOE_BATCH} x "
        f"{SEQ} tokens, {[o['params'] for o in res]} parameters a rank, "
        f"AdamW on lm_loss_fn, losses {r0['losses']} (every rank), aux loss "
        f"after {r0['aux']}; replicated leaves bitwise equal on the four "
        f"ranks, experts on each dp pair, after every step")
    log(oracle_line(label, r0["oracle"]))
    log(f"{label}: step seconds {[o['times'] for o in res]} ({wire}); peak "
        f"memory per rank {[round(o['peak'] / 2**30, 2) for o in res]} GiB; "
        f"on {card}")
    log(f"{label}: {seconds:.1f} s for the phase; flash_fwd launches per "
        f"rank {[o['counts']['flash_fwd'] for o in res]}; rank 0's "
        f"{r0['counts']}")
    return r0["counts"]


def check_fsdp(res: list, seconds: float, label: str, wire: str, card: str):
    r0 = res[0]
    for r, out in enumerate(res):
        if not all(math.isfinite(v) for v in out["losses"]) \
                or out["losses"] != r0["losses"]:
            raise AssertionError(f"{label}: losses differ or are not finite "
                                 f"on rank {r}: {out['losses']}")
        if out["counts"]["flash_fwd"] != FSDP_STEPS * GPT_MEDIUM["n_layer"]:
            raise AssertionError(f"{label}: rank {r} launched flash_fwd "
                                 f"{out['counts']['flash_fwd']} times")
        s = out["short"]
        twin = res[r ^ 2]["short"]          # the other data index
        if s["slices"] != twin["slices"] or s["dp_axis"] != "data":
            raise AssertionError(f"{label}: HSDP replicas {r}, {r ^ 2} "
                                 f"differ, or no data axis: {s['dp_axis']}")
        if not (abs(s["loss_hsdp"] - s["loss"]) <= 1e-5 * abs(s["loss"])
                and s["worst"] <= 2 * ADAMW["lr"] + 1e-6
                and s["flip_share"] <= SP_FLIP_SHARE):
            raise AssertionError(f"{label}: HSDP off FSDP at "
                                 f"{FSDP_SHORT_LAYERS} layers on rank {r}: "
                                 f"{s}")
    if not oracle_ok(r0["oracle"]):
        raise AssertionError(f"{label}: step 1 off the one-rank step: "
                             f"{r0['oracle']}")
    log(f"{label}: GPT-medium, {GPT_MEDIUM['n_layer']} layers, "
        f"make_fsdp_train_step under HVD_TPU_MESH_PLAN="
        f"{FSDP_ENV['HVD_TPU_MESH_PLAN']}, {BATCH // SET_RANKS} x {SEQ} "
        f"tokens a rank, {[o['params'] for o in res]} parameters a rank (the "
        f"slices), AdamW, losses {r0['losses']} (every rank)")
    log(oracle_line(label, r0["oracle"]))
    s = r0["short"]
    log(f"{label}: {FSDP_SHORT_LAYERS} layers, HSDP data=2,fsdp=2 against "
        f"fsdp=4: losses {s['loss_hsdp']} / {s['loss']}, parameters at most "
        f"{s['worst']} apart, {s['flip_share']} by more than lr/2; the data "
        f"replicas' slices bitwise equal")
    log(f"{label}: step seconds {[o['times'] for o in res]} ({wire}); peak "
        f"memory per rank {[round(o['peak'] / 2**30, 2) for o in res]} GiB "
        f"(the one-rank step's {r0['oracle']['peak'] / 2**30:.2f}); on "
        f"{card}")
    log(f"{label}: {seconds:.1f} s for the phase; flash_fwd launches per "
        f"rank {[o['counts']['flash_fwd'] for o in res]}; rank 0's "
        f"{r0['counts']}")
    return r0["counts"]


def check_autotune(res: list, seconds: float, label: str, wire: str,
                   card: str):
    from horovod_tpu_torch import basics

    r0 = res[0]
    if not (r0["tuned"] and r0["frozen"] and r0["applied"]):
        raise AssertionError(f"{label}: the step did not tune and freeze: "
                             f"{r0['knobs']} {r0['applied']}")
    for r, out in enumerate(res):
        if out["applied"] != r0["applied"] or out["config"] != r0["config"]:
            raise AssertionError(f"{label}: rank {r} applied other knobs "
                                 "than rank 0")
        if out["replicas"] != r0["replicas"]:
            raise AssertionError(f"{label}: the replicas differ after the "
                                 "steps")
        if not all(math.isfinite(v) for v in out["losses"]):
            raise AssertionError(f"{label}: non-finite loss on rank {r}")
    for point in r0["applied"]:
        if not ((1 << 20) <= point["fusion_threshold"] <= (1 << 28)
                and 1 <= point["compressor"]
                <= len(basics._COMPRESSOR_LATTICE)):
            raise AssertionError(f"{label}: an applied point off its lattice: "
                                 f"{point}")
    last = r0["applied"][-1]
    if (r0["config"]["fusion_threshold"] != last["fusion_threshold"]
            or r0["config"]["compression"]
            != basics._COMPRESSOR_LATTICE[last["compressor"] - 1]):
        raise AssertionError(f"{label}: the live config is not the last "
                             f"applied point: {r0['config']}")
    for name in ("quantize_blocks", "dequantize_blocks",
                 "dequantize_accumulate"):
        if r0["counts"][name] <= 0:
            raise AssertionError(f"{name} never launched on the {label} path")
    warmup = int(AUTOTUNE_ENV["HOROVOD_AUTOTUNE_WARMUP_SAMPLES"])
    scored = [line for line in r0["scores"] if line["note"] != "frozen"]
    for r, out in enumerate(res):
        d = out["decisions"]
        windows = [e for e in d if e["event"] == "window"]
        applied = [e["applied"] for e in d if e["event"] != "window"]
        if not (len(windows) == len(scored) + warmup
                and applied == out["applied"]
                and [e["proposal"] for e in windows]
                == [e["proposal"] for e in r0["decisions"]
                    if e["event"] == "window"]):
            raise AssertionError(f"{label}: rank {r}'s autotune decision log "
                                 f"{d} against {len(scored)} scored "
                                 f"windows and applied {out['applied']}")
    log(f"{label}: autotune_log: {len(scored)} scored + {warmup} "
        f"warmup window entries and {len(r0['applied'])} applied points "
        f"(= applied_knobs) on both ranks: {r0['decisions']}")
    scores = [(line["knobs"], line["score"], line["note"])
              for line in r0.get("scores", [])]
    log(f"{label}: GPT-medium widths, {WIRE_LAYERS} layers, knobs "
        f"{r0['knobs']} from threshold {r0['start']['fusion_threshold']} on "
        f"{r0['start']['compression']}; applied {r0['applied']} (both ranks); "
        f"frozen at {last}; losses {r0['losses']}")
    log(f"{label}: window scores (samples/s a rank; knobs, score, note) "
        f"{scores}")
    log(f"{label}: step seconds {[o['times'] for o in res]} ({wire}); peak "
        f"memory per rank {[round(o['peak'] / 2**30, 2) for o in res]} GiB; "
        f"on {card}")
    log(f"{label}: {seconds:.1f} s for the phase; rank 0's launches "
        f"{r0['counts']}")
    return r0["counts"]


def parallel_phase(flag: str, world: int, check, label: str, card: str):
    """Run ``world`` ranks of ``flag``'s path, sharing the card over gloo,
    and hand every rank's results to ``check``: rank 0's launch
    counts."""
    t0 = time.perf_counter()
    res = spawn_ranks(flag, world)
    return check(res, time.perf_counter() - t0, label,
                 f"gloo staging through the host, {world} ranks on one "
                 "card: not a wire's time", card)


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


# --- durable state and recovery ------------------------------------------------

DURABLE_STEPS, DURABLE_EVERY, DURABLE_CRASH = 6, 2, 4
DURABLE_SEED0 = 1000             # step s draws its tokens from seed 1000 + s
ELASTIC_STEPS, ELASTIC_FAULT = 4, 2   # "elastic 2 ranks": dispatch 2 fails


def durable_batch(dev, seed: int):
    """A batch of GPT-medium tokens from ``seed`` (the seed the journal
    records for its step)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, GPT_MEDIUM["vocab_size"], (BATCH, SEQ + 1),
                           generator=gen, device=dev)
    return tokens[:, :-1], tokens[:, 1:]


def durable_model(dev, seed: int, n_layer: int = GPT_MEDIUM["n_layer"]):
    """(model, optimizer, step): GPT-medium from ``seed`` and
    :func:`dp_step`'s AdamW on the int8+EF wire, the optimizer kept."""
    import torch
    import horovod_tpu_torch as hvd

    cfg = hvd.models.GPTConfig(**{**GPT_MEDIUM, "n_layer": n_layer})
    model = hvd.models.GPT(cfg, device=dev, seed=seed)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), **ADAMW),
        compression=hvd.Compression.int8, error_feedback=True)
    return model, opt, hvd.make_train_step(hvd.models.lm_loss_fn(model), opt)


def param_digest(model) -> str:
    return digest(p for _, p in sorted(model.named_parameters()))


def durable_run_a(dev) -> dict:
    """Run A: DURABLE_STEPS steps from seed 0, uninterrupted."""
    import torch

    model, _, step = durable_model(dev, 0)
    losses, times = [], []
    for s in range(1, DURABLE_STEPS + 1):
        t0 = time.perf_counter()
        losses.append(float(step(model, durable_batch(dev, DURABLE_SEED0 + s))))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    params = {n: p.detach().to("cpu", copy=True)
              for n, p in model.named_parameters()}
    return dict(losses=losses, times=times, digest=param_digest(model),
                params=params)


def durable_replay(dev, step, model, entries) -> list:
    """Run the journaled steps ``entries`` (each batch from its ``rng``
    seed): their losses."""
    return [float(step(model, durable_batch(dev, int(e["rng"]))))
            for e in entries]


def ckpt_summary(name: str) -> dict:
    """The registry's summary of the unlabelled histogram ``name``."""
    from horovod_tpu_torch.obs import metrics

    return metrics.registry().snapshot()[name][0]


def durable_phase(dev, card: str) -> dict:
    """Path "durable 1 rank": GPT-medium at full width and depth with
    :func:`dp_step`'s AdamW on the int8+EF wire.

    Run A (twice: the run-to-run floor): DURABLE_STEPS steps.  Run B: a
    ``TorchState`` with ``attach_durable(AsyncCheckpointer, every=2)``,
    each step journaled (its token seed) and committed, stopped after
    step DURABLE_CRASH; the writer drained; the model, optimizer and
    checkpointer dropped (the crash).  Resume into a model built from
    another seed: ``resume()`` must hand back step DURABLE_CRASH, and
    steps 5-6 must equal run A's, losses and final parameters, bit for
    bit (or within A's own run-to-run spread).  Damage drill: under
    ``checkpoint:step=4,mode=corrupt`` step 4 is written again (and
    bit-flipped); ``resume()`` must fall back to step 2 plus the journal
    tail 3-6, leave ``ckpt_step_damaged`` in the flight ring, and the
    replay of 3-6 equal run A.  The launch counts: run B, the resume and
    the replay (not run A, the oracle)."""
    import shutil
    import tempfile

    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import faults
    from horovod_tpu_torch.ckpt import AsyncCheckpointer
    from horovod_tpu_torch.elastic import TorchState
    from horovod_tpu_torch.obs import flight, metrics

    t_phase = time.perf_counter()
    # cuBLAS and the kernels are deterministic on one stream; this makes
    # torch pick its deterministic implementations too (and warn where
    # it has none), for the bit-for-bit oracle.
    torch.use_deterministic_algorithms(True, warn_only=True)
    a1 = durable_run_a(dev)
    torch.cuda.empty_cache()
    a2 = durable_run_a(dev)
    torch.cuda.empty_cache()
    deterministic = a1["digest"] == a2["digest"] and a1["losses"] == a2["losses"]
    spread = max(float((a1["params"][n] - a2["params"][n]).abs().max())
                 for n in a1["params"])
    loss_spread = max(abs(x - y) for x, y in zip(a1["losses"], a2["losses"]))
    del a2
    n_params = sum(p.numel() for p in a1["params"].values())
    log(f"durable 1 rank: GPT-medium {n_params} params; run A twice: "
        f"losses {a1['losses']}, run-to-run parameter spread {spread}, "
        f"loss spread {loss_spread}"
        + ("" if deterministic else " (the step is not deterministic)"))

    def agrees(losses, want, model) -> bool:
        if deterministic:
            return losses == want and param_digest(model) == a1["digest"]
        got = {n: p.detach().cpu() for n, p in model.named_parameters()}
        return (max(abs(x - y) for x, y in zip(losses, want)) <= loss_spread
                and max(float((got[n] - a1["params"][n]).abs().max())
                        for n in got) <= spread)

    tmp = tempfile.mkdtemp(prefix="hvd_durable_")
    try:
        per_save = 4 * n_params * 4           # params, two moments, residual
        free = shutil.disk_usage(tmp).free
        log(f"durable 1 rank: {free / 2**30:.1f} GiB free under {tmp}, "
            f"{per_save / 2**30:.2f} GiB a save")
        if free < 3.5 * per_save:
            raise AssertionError(
                f"durable 1 rank: {free / 2**30:.1f} GiB free under {tmp}; "
                f"the phase keeps 2 saves of {per_save / 2**30:.2f} GiB and "
                "writes a third beside them")

        # Run B, stopped after step DURABLE_CRASH.  The launch counts are
        # the path's own: run B, the resume and the replay.
        hvd.ops.reset_launch_counts()
        model, opt, step = durable_model(dev, 0)
        ck = AsyncCheckpointer(tmp, max_to_keep=2, async_save=True)
        state = TorchState(model=model, optimizer=opt, step=0)
        state.attach_durable(ck, every=DURABLE_EVERY)
        b_times, commit_times = [], []
        for s in range(1, DURABLE_CRASH + 1):
            t0 = time.perf_counter()
            step(model, durable_batch(dev, DURABLE_SEED0 + s))
            t1 = time.perf_counter()
            state.step = s
            state.journal_step(s, rng=DURABLE_SEED0 + s)
            state.commit()
            torch.cuda.synchronize()
            commit_times.append(time.perf_counter() - t1)
            b_times.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        ck.wait_until_finished()
        drain = time.perf_counter() - t0
        ck.close()
        stall, write = (ckpt_summary("hvd_tpu_ckpt_save_stall_us"),
                        ckpt_summary("hvd_tpu_ckpt_write_us"))
        saved = ck._store.read_manifest(DURABLE_CRASH).nbytes
        del state, model, opt, step, ck              # the crash
        torch.cuda.empty_cache()

        # Resume into a model from another seed.
        model, opt, step = durable_model(dev, 7)
        before = param_digest(model)
        ck = AsyncCheckpointer(tmp, max_to_keep=2, async_save=True)
        state = TorchState(model=model, optimizer=opt, step=0)
        t0 = time.perf_counter()
        info = ck.resume()
        restore_s = time.perf_counter() - t0
        if (info.snapshot_step, info.exact_step, info.replay) != \
                (DURABLE_CRASH, DURABLE_CRASH, []):
            raise AssertionError(f"durable 1 rank: resume() gave step "
                                 f"{info.snapshot_step} + {info.replay}")
        state.load_payload(info.tree)
        del info
        if param_digest(model) == before or int(state.step) != DURABLE_CRASH:
            raise AssertionError("durable 1 rank: the restore changed "
                                 "nothing")
        tail = [{"step": s, "rng": DURABLE_SEED0 + s}
                for s in range(DURABLE_CRASH + 1, DURABLE_STEPS + 1)]
        losses = durable_replay(dev, step, model, tail)
        for e in tail:
            ck.journal_step(e["step"], rng=e["rng"])
        if not agrees(losses, a1["losses"][DURABLE_CRASH:], model):
            raise AssertionError(
                f"durable 1 rank: steps 5-6 after the resume {losses} "
                f"left run A's {a1['losses'][DURABLE_CRASH:]}")
        log(f"durable 1 rank: resume at step {DURABLE_CRASH}, steps 5-6 "
            f"losses {losses}, final parameters "
            + ("bit for bit run A's" if deterministic else
               "within run A's run-to-run spread"))

        # Damage drill: step 4 written again and damaged.
        with faults.inject(f"checkpoint:step={DURABLE_CRASH},mode=corrupt"):
            state.save_to(ck, DURABLE_CRASH, force=True)
            ck.wait_until_finished()
            fired = faults.history()
        del state, model, opt, step
        torch.cuda.empty_cache()
        model, opt, step = durable_model(dev, 11)
        state = TorchState(model=model, optimizer=opt, step=0)
        info = ck.resume()
        replay = [int(e["step"]) for e in info.replay]
        damaged = [e for e in flight.events()
                   if e["kind"] == "ckpt_step_damaged"
                   and e.get("step") == DURABLE_CRASH]
        if (fired != [("checkpoint", DURABLE_CRASH, "corrupt")]
                or info.snapshot_step != DURABLE_EVERY
                or replay != list(range(DURABLE_EVERY + 1,
                                        DURABLE_STEPS + 1))
                or not damaged):
            raise AssertionError(
                f"durable 1 rank: damage drill fired {fired}, resumed at "
                f"{info.snapshot_step} + {replay}, flight "
                f"{len(damaged)} damaged-step events")
        state.load_payload(info.tree)
        entries = info.replay
        del info
        losses = durable_replay(dev, step, model, entries)
        if not agrees(losses, a1["losses"][DURABLE_EVERY:], model):
            raise AssertionError(
                f"durable 1 rank: the replay of steps 3-6 {losses} left "
                f"run A's {a1['losses'][DURABLE_EVERY:]}")
        ck.close()
        counts = hvd.ops.launch_counts()
        log(f"durable 1 rank: damage drill: step {DURABLE_CRASH} corrupt, "
            f"fell back to step {DURABLE_EVERY} + journal {replay}, replay "
            "equals run A")
        for name in ("flash_fwd", "quantize_blocks", "dequantize_blocks"):
            if counts[name] <= 0:
                raise AssertionError(f"{name} never launched on the durable "
                                     "1 rank path")
        a_step = statistics.median(a1["times"][1:])
        log(f"durable 1 rank: save stall p50 {stall['p50']} us, max "
            f"{stall['p99']} us ({stall['count']} saves: nearest-rank p99 "
            f"of <= 50 is the max); write p50 {write['p50']} us, max "
            f"{write['p99']} us; {saved} bytes a save; drain after step "
            f"{DURABLE_CRASH} {drain:.3f} s; restore (resume of step "
            f"{DURABLE_CRASH}, verified) {restore_s:.3f} s; commit (device "
            f"to pinned host) {commit_times} s; step time with commits and "
            f"saves {b_times} s against {a1['times']} s without (median "
            f"{statistics.median(b_times[1:]):.4f} vs {a_step:.4f}); on "
            f"{card}")
        log(f"durable 1 rank: launches {counts}, "
            f"{time.perf_counter() - t_phase:.1f} s")
        return counts
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(tmp, ignore_errors=True)


def elastic_loop(dev, faulted: bool) -> dict:
    """One rank's ``@elastic.run`` loop at GPT-medium's widths and
    WIRE_LAYERS layers: each step a :func:`dp_step`-style int8+EF step,
    an eager ``hvd.allreduce`` of the loss (the ``collective`` site's
    dispatches) and a commit.  ``faulted``: ``collective:step=
    ELASTIC_FAULT`` fires once (rollback, backoff, re-init on this device
    over a new rendezvous, restore, sync, finish); else the loop calls
    ``state.sync()`` after the same commit the fault rolls back to."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import basics, faults
    from horovod_tpu_torch.elastic import TorchState, run

    model, opt, step = durable_model(dev, 0, n_layer=WIRE_LAYERS)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    batch = durable_batch(dev, 1 + hvd.rank())
    state = TorchState(model=model, optimizer=opt, step=0)
    meta = {"tries": 0, "losses": []}

    @run
    def train(state):
        meta["tries"] += 1
        while int(state.step) < ELASTIC_STEPS:
            loss = step(model, batch)
            meta["losses"].append(float(hvd.allreduce(loss.detach(),
                                                      name="loss")))
            state.step = int(state.step) + 1
            state.commit()
            if not faulted and int(state.step) == ELASTIC_FAULT:
                state.sync()
        return state

    gen0 = basics.rendezvous_generation()
    if faulted:
        with faults.inject(f"collective:step={ELASTIC_FAULT}"):
            train(state)
            fired = faults.history()
    else:
        train(state)
        fired = []
    return dict(tries=meta["tries"], losses=meta["losses"], fired=fired,
                generations=[gen0, basics.rendezvous_generation()],
                device=str(hvd.device()), backend=basics.backend(),
                params=param_digest(model))


def elastic_ranks(dev, rank: int) -> dict:
    """Path "elastic 2 ranks": the unfaulted loop (the oracle), then the
    faulted one from the same weights (the main path: launch counts and
    the rollback counter read around it), then the flight dump."""
    import json as _json

    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.obs import flight, metrics

    torch.use_deterministic_algorithms(True, warn_only=True)
    plain = elastic_loop(dev, faulted=False)
    torch.cuda.empty_cache()

    def rollbacks():
        return sum(s["value"] for s in metrics.registry().snapshot().get(
            "hvd_tpu_elastic_resets_total", [])
            if dict(s["labels"]).get("kind") == "rollback")

    before = rollbacks()
    t0 = time.perf_counter()
    hvd.ops.reset_launch_counts()
    faulted = elastic_loop(hvd.device(), faulted=True)
    counts = hvd.ops.launch_counts()
    seconds = time.perf_counter() - t0
    with open(flight.last_dumps()[-1]) as f:
        doc = _json.load(f)
    return dict(plain=plain, faulted=faulted, counts=counts, seconds=seconds,
                rollbacks=rollbacks() - before,
                dump={k: doc[k] for k in ("reason", "fault_spec",
                                          "fault_history")})


def check_elastic(res: list, seconds: float, label: str, wire: str,
                  card: str):
    spec = f"collective:step={ELASTIC_FAULT}"
    for r, out in enumerate(res):
        f, p = out["faulted"], out["plain"]
        if [tuple(h) for h in f["fired"]] != \
                [("collective", ELASTIC_FAULT, "raise:loss")]:
            raise AssertionError(f"{label}: rank {r} fired {f['fired']}")
        if f["tries"] != 2 or p["tries"] != 1:
            raise AssertionError(f"{label}: rank {r} tried {f['tries']} "
                                 f"times (unfaulted {p['tries']})")
        if out["rollbacks"] != 1:
            raise AssertionError(f"{label}: rank {r} counted "
                                 f"{out['rollbacks']} rollbacks")
        if f["generations"][1] != f["generations"][0] + 1 or \
                f["device"] != "cuda:0" or f["backend"] != "gloo":
            raise AssertionError(f"{label}: rank {r} re-init went to "
                                 f"{f['device']} / {f['backend']}, "
                                 f"generations {f['generations']}")
        dump = out["dump"]
        if (dump["reason"] != "horovod_internal_error"
                or dump["fault_spec"] != spec
                or [tuple(h) for h in dump["fault_history"]]
                != [tuple(h) for h in f["fired"]]):
            raise AssertionError(f"{label}: rank {r} flight dump {dump}")
        if f["params"] != p["params"]:
            raise AssertionError(f"{label}: rank {r}'s parameters differ "
                                 "from the unfaulted run that synced after "
                                 "the same commit")
        if f["params"] != res[0]["faulted"]["params"]:
            raise AssertionError(f"{label}: the replicas differ")
        for name in ("flash_fwd", "quantize_blocks", "dequantize_blocks",
                     "dequantize_accumulate"):
            if out["counts"][name] <= 0:
                raise AssertionError(f"{name} never launched on the {label} "
                                     "path")
    r0 = res[0]
    log(f"{label}: {WIRE_LAYERS} layers, {ELASTIC_STEPS} steps, {spec} fired "
        f"once on each rank, 2 tries, 1 rollback, re-init on cuda:0 over "
        f"gloo, rendezvous generation {r0['faulted']['generations']}, "
        f"final parameters bitwise the unfaulted run's; losses "
        f"{r0['faulted']['losses']} (unfaulted {r0['plain']['losses']}); "
        f"faulted loop {r0['seconds']:.1f} s, phase {seconds:.1f} s ({wire}) "
        f"on {card}; launches {r0['counts']}")
    return r0["counts"]


# --- "launcher 2 ranks": the host runtime through the port's launcher -------

LAUNCHER_WORKER_FLAG = "--launcher-worker"
LAUNCHER_RANKS, LAUNCHER_STEPS = 2, 3
STALL_WINDOW_S = 15.0      # well above a step here (2 ranks, gloo, one card)
LAUNCHER_TIMEOUT_S = 900.0
PLANNER_CALLS = 200        # timed calls of each planner on the 197 leaves
ACTIVITY_CALLS = 5000      # timed timeline activities a writer
CONTRACT_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                 "GROUP_RANK", "GROUP_WORLD_SIZE", "MASTER_ADDR",
                 "MASTER_PORT")
MISSING_RANK_WARNING = ("was dispatched by this process but is not "
                        "globally ready")


def stall_warns() -> float:
    """This process's ``hvd_tpu_stall_events_total{kind="warn"}``."""
    from horovod_tpu_torch.obs import metrics

    return sum(s["value"] for s in metrics.registry().snapshot().get(
        "hvd_tpu_stall_events_total", [])
        if dict(s["labels"]).get("kind") == "warn")


def per_call_us(fn, calls: int) -> float:
    """Mean host time of one call of ``fn`` over ``calls`` calls, in µs."""
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) / calls * 1e6


def planner_checks(plans: list) -> dict:
    """The fusion plans the native planner gave the step, each against
    ``plan_buckets_py`` on the same sizes; its two-phase and two-tier
    choices on the same bytes against their Python twins; both planners'
    host time on the 197 leaves."""
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.native import planner as nplanner
    from horovod_tpu_torch.ops import fusion
    from horovod_tpu_torch.topo.costmodel import default_params
    from horovod_tpu_torch.topo.schedule import choose_algo
    from horovod_tpu_torch.topo.topology import MeshTopology

    leaves = [p for p in plans if len(p[0]) == 197]
    if not leaves:
        raise AssertionError(
            "launcher 2 ranks: the native planner never planned the 197 "
            f"gradient leaves (plans of {[len(p[0]) for p in plans]} leaves)")
    for sizes, threshold, got in plans:
        if got != fusion.plan_buckets_py(sizes, threshold):
            raise AssertionError("launcher 2 ranks: a native fusion plan "
                                 "differs from plan_buckets_py")
    sizes, threshold, plan = leaves[0]
    payloads = [sum(sizes[i] for i in b) for b in plan]
    cfg = basics.config()
    flags = nplanner.plan_two_phase_flags(payloads, 2, cfg.cost_alpha_us,
                                          cfg.cost_beta_gbps)
    if flags != fusion.plan_two_phase_flags(payloads, 2, cfg.cost_alpha_us,
                                            cfg.cost_beta_gbps):
        raise AssertionError("launcher 2 ranks: native two-phase flags "
                             "differ from the Python twin's")
    params = default_params()
    algos = {}
    for pods, chips in ((1, 2), (2, 1), (2, 2)):
        topo = MeshTopology(pods, chips)
        got = nplanner.plan_hierarchical(
            payloads + sizes, pods, chips, params.ici.alpha_us,
            params.ici.beta_gbps, params.dcn.alpha_us, params.dcn.beta_gbps)
        if got != [choose_algo(b, topo, params) for b in payloads + sizes]:
            raise AssertionError(f"launcher 2 ranks: native schedule choice "
                                 f"at {pods}x{chips} differs from "
                                 "choose_algo's")
        algos[f"{pods}x{chips}"] = sorted(set(got))
    return dict(
        buckets=len(plan), threshold=threshold, two_phase=sum(flags),
        algos=algos,
        native_us=per_call_us(lambda: nplanner.plan_buckets(sizes,
                                                            threshold),
                              PLANNER_CALLS),
        python_us=per_call_us(lambda: fusion.plan_buckets_py(sizes,
                                                             threshold),
                              PLANNER_CALLS))


def timeline_cost(dev, tmp: str, rank: int) -> dict:
    """Host cost of one timeline activity on each writer (the native
    writer thread, the Python one, none open), and an eager allreduce of
    one element on the session's timeline: an allreduce writes two
    activities (ENQUEUE, EXECUTE)."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.utils.timeline import Timeline

    out = {}
    for label, path, native in (
            ("native", os.path.join(tmp, f"cost{rank}.native.json"), True),
            ("python", os.path.join(tmp, f"cost{rank}.python.json"), False),
            ("off", None, False)):
        tl = Timeline(path, use_native=native)
        if native and not tl.native:
            raise AssertionError("the native timeline writer did not open")

        def activity():
            with tl.activity("loss", "EXECUTE", {"op": "average"}):
                pass

        out[f"{label}_us"] = per_call_us(activity, ACTIVITY_CALLS)
        tl.close()
    x = torch.ones(1, device=dev)
    for _ in range(3):
        hvd.allreduce(x, name="timeline_cost")
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        hvd.allreduce(x, name="timeline_cost")
        times.append((time.perf_counter() - t0) * 1e6)
    out["eager_allreduce_us"] = statistics.median(times)
    return out


def wire_checks(rank: int) -> dict:
    """Each rank serves a ``BasicService`` keyed by the launcher's secret;
    rank 0 pings both (clock offsets), takes each one's span ring and
    rank 1's metrics, and merges the two traces."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.obs import trace
    from horovod_tpu_torch.runner.common import network, secret

    key = secret.secret_from_env()
    svc = network.BasicService(f"rank{rank}", key)
    ports = hvd.allgather_object(svc.port)
    out = {}
    try:
        if rank == 0:
            clients = [network.BasicClient(f"rank{r}",
                                           [("127.0.0.1", ports[r])], key)
                       for r in range(LAUNCHER_RANKS)]
            offsets = {}
            for r, client in enumerate(clients):
                samples = []
                for _ in range(8):
                    send = trace.now_us()
                    resp = client.ping()
                    samples.append((send, trace.now_us(), resp.clock_us))
                offsets[r] = trace.estimate_clock_offset(samples)
            # Rank 1's ring first, this rank's last: every client span of
            # the exchange is then closed in the merged set.
            rings = {1: clients[1].request(network.TraceRequest()),
                     0: clients[0].request(network.TraceRequest())}
            scraped = clients[1].request(network.MetricsRequest())
            merged = trace.merge_traces(
                {f"rank{r}": (offsets[r][0], rings[r].spans) for r in rings})
            pid_of = {e["args"]["name"]: e["pid"] for e in merged
                      if e.get("ph") == "M"}
            roots = {label: sum(1 for e in merged
                                if e.get("ph") == "X" and e["pid"] == pid
                                and e["name"] == "hvd_tpu_step"
                                and not e["args"].get("parent_id"))
                     for label, pid in pid_of.items()}
            steps = [s["value"] for s in scraped.snapshot["metrics"].get(
                "hvd_tpu_steps_total", [])
                if dict(s["labels"]).get("kind") == "train"]
            out = dict(
                offsets_us={r: list(o) for r, o in offsets.items()},
                ring_ranks=[rings[0].rank, rings[1].rank],
                roots=roots,
                unresolved=trace.unresolved_parents(rings[0].spans
                                                    + rings[1].spans),
                merged_events=len(merged), scraped_steps=steps,
                scraped_rank=scraped.snapshot.get("rank"))
        hvd.barrier(name="wire_done")
    finally:
        svc.shutdown()
    return out


def fusion_tiers() -> list:
    """The tiers of the fusion plans this process recorded
    (``hvd_tpu_fusion_traces_total{tier}``)."""
    from horovod_tpu_torch.obs import metrics

    return sorted(dict(s["labels"])["tier"] for s in metrics.registry()
                  .snapshot().get("hvd_tpu_fusion_traces_total", []))


def launch_steps(dev, rank: int, plans=None) -> dict:
    """The steps of "launcher 2 ranks" and "remote 2 hosts", one rank:
    full-depth GPT-medium from seed 0, a batch from seed 0 + rank,
    ``dp_step``'s AdamW on the int8+EF wire, LAUNCHER_STEPS steps each
    followed by an eager ``allreduce`` of the loss, the launch counts set
    to 0 just before and read just after.  Deterministic algorithms are
    on, so that two launches can be held to each other bit for bit.
    With a ``plans`` list, the native planner's plans of the steps are
    appended to it."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.native import planner as nplanner

    torch.use_deterministic_algorithms(True, warn_only=True)
    model, batch = gpt_medium(dev, data_seed=rank)
    step = dp_step(model)
    native_plan = nplanner.plan_buckets

    def recorded(sizes, threshold):
        got = native_plan(sizes, threshold)
        plans.append((list(sizes), int(threshold), got))
        return got

    if plans is not None:
        nplanner.plan_buckets = recorded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hvd.ops.reset_launch_counts()
    losses, times = [], []
    try:
        for _ in range(LAUNCHER_STEPS):
            t0 = time.perf_counter()
            loss = step(model, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(hvd.allreduce(loss.detach(), name="loss")))
    finally:
        nplanner.plan_buckets = native_plan
    counts = hvd.ops.launch_counts()
    return dict(losses=losses, times=times, counts=counts,
                peak=torch.cuda.max_memory_allocated(),
                params=param_digest(model), tiers=fusion_tiers())


def launcher_ranks(dev, rank: int, tmp: str) -> dict:
    """Path "launcher 2 ranks", one rank under the port's launcher:
    :func:`launch_steps`; the native planner's plans; the stall drill;
    the wire."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.native import bindings

    tl, monitor = hvd.timeline(), hvd.peek("cross_monitor")
    if not bindings.available():
        raise AssertionError("the native runtime did not load")
    if not (tl.enabled and tl.native):
        raise AssertionError("the timeline does not write through "
                             "NativeTimeline")
    if monitor is None or not monitor._thread.is_alive():
        raise AssertionError("the cross-process monitor is not running")
    plans = []
    steps = launch_steps(dev, rank, plans)
    planner = planner_checks(plans)
    cost = timeline_cost(dev, tmp, rank)
    warns_before = stall_warns()
    reported_before = sorted(monitor._reported)
    if rank == 1:
        time.sleep(STALL_WINDOW_S + 5)
    t0 = time.perf_counter()
    hvd.allreduce(torch.ones(1, device=dev), name="stall_probe")
    probe_wait = time.perf_counter() - t0
    warns_after = stall_warns()
    wire = wire_checks(rank)
    return dict(**steps, planner=planner, cost=cost,
                warns_before=warns_before, warns_after=warns_after,
                reported_before=reported_before, probe_wait=probe_wait,
                monitor_failure=monitor.failure, wire=wire,
                cycles=hvd.peek("cross_monitor")._coord.cycles)


def launcher_worker(tmp: str) -> None:
    """One rank of "launcher 2 ranks", started by ``python -m
    horovod_tpu_torch.runner``: checks the launcher's environment, joins
    the world the session owns (gloo: NCCL refuses two ranks on one
    card), runs :func:`launcher_ranks` and writes ``DIR/rank<r>.json``."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.runner.common.secret import SECRET_ENV

    env = os.environ
    rank = int(env["RANK"])
    want = dict(WORLD_SIZE=str(LAUNCHER_RANKS), LOCAL_RANK=str(rank),
                LOCAL_WORLD_SIZE=str(LAUNCHER_RANKS), GROUP_RANK="0",
                GROUP_WORLD_SIZE="1", HOROVOD_TIMELINE_MARK_CYCLES="1",
                HOROVOD_STALL_CHECK_TIME_SECONDS=str(STALL_WINDOW_S))
    wrong = {k: env.get(k) for k, v in want.items() if env.get(k) != v}
    missing = [k for k in (*CONTRACT_VARS, SECRET_ENV, "HOROVOD_TIMELINE")
               if not env.get(k)]
    if wrong or missing or not env["MASTER_PORT"].isdigit():
        raise AssertionError(f"launcher env contract: wrong {wrong}, "
                             f"missing {missing}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hvd.init(device="cuda:0", backend="gloo")
    try:
        res = launcher_ranks(hvd.device(), rank, tmp)
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        hvd.shutdown()


def timeline_events(path: str) -> dict:
    """One rank's timeline file: parsed (it must be a Chrome-trace JSON
    array) and counted."""
    with open(path) as f:
        events = json.load(f)

    def count(name, ph, tensor=None, **args):
        return sum(1 for e in events
                   if e.get("name") == name and e.get("ph") == ph
                   and (tensor is None
                        or e.get("args", {}).get("tensor") == tensor)
                   and all(e.get("args", {}).get(k) == v
                           for k, v in args.items()))

    counters = [e for e in events if e.get("ph") == "C"
                and e.get("name") == "train"]
    return dict(
        bytes=os.path.getsize(path), events=len(events),
        loss_enqueue=count("ENQUEUE", "X", "loss", op="average"),
        loss_execute=count("EXECUTE", "X", "loss", op="average"),
        broadcast=count("EXECUTE", "X", root=0),
        steps=count("hvd_tpu_step", "X"),
        train_counters=sum(1 for e in counters
                           if {"step_time_ms", "tokens_per_s"}
                           <= set(e.get("args", {}))),
        cycles=count("CYCLE", "i"))


def check_launcher(res: list, logs: dict, files: dict, build: str,
                   seconds: float, label: str, wire: str, card: str):
    for r, out in enumerate(res):
        if not all(math.isfinite(v) for v in out["losses"]):
            raise AssertionError(f"{label}: rank {r} non-finite losses "
                                 f"{out['losses']}")
        if out["losses"] != res[0]["losses"] or \
                out["params"] != res[0]["params"]:
            raise AssertionError(f"{label}: the replicas differ")
        for name in ("flash_fwd", "quantize_blocks", "dequantize_blocks",
                     "dequantize_accumulate"):
            if out["counts"][name] <= 0:
                raise AssertionError(f"{name} never launched on the {label} "
                                     f"path (rank {r})")
        if out["warns_before"] != 0 or out["reported_before"]:
            raise AssertionError(
                f"{label}: rank {r} warned of a stall during the steps "
                f"({out['warns_before']} warnings, monitor "
                f"{out['reported_before']})")
        if out["monitor_failure"]:
            raise AssertionError(f"{label}: rank {r}'s cross-process monitor "
                                 f"failed: {out['monitor_failure']}")
        tl = files[r]
        if (tl["loss_enqueue"], tl["loss_execute"]) != (LAUNCHER_STEPS,) * 2 \
                or tl["broadcast"] < 1 or tl["steps"] != LAUNCHER_STEPS \
                or tl["train_counters"] != LAUNCHER_STEPS or tl["cycles"] < 1:
            raise AssertionError(f"{label}: rank {r}'s timeline {tl}")
    if res[1]["warns_after"] < 1:
        raise AssertionError(f"{label}: rank 1's stall inspector counted "
                             f"{res[1]['warns_after']} warnings in the drill")
    missing = [line for line in logs[0].splitlines()
               if MISSING_RANK_WARNING in line]
    if len(missing) != 1 or "'stall_probe'" not in missing[0]:
        raise AssertionError(f"{label}: rank 0's missing-rank warnings: "
                             f"{missing}")
    w = res[0]["wire"]
    if w["roots"] != {"rank0": LAUNCHER_STEPS, "rank1": LAUNCHER_STEPS} \
            or w["unresolved"] or w["scraped_steps"] != [LAUNCHER_STEPS] \
            or w["scraped_rank"] != 1 or w["ring_ranks"] != [0, 1]:
        raise AssertionError(f"{label}: the wire: {w}")
    for name in ("int8_kernels", "flash_attention", "fused_apply",
                 "matmul"):
        if f"[X] csrc/{name}.cu: built" not in build:
            raise AssertionError(f"--check-build: {name} not built:\n{build}")
    if "[X] native runtime built (ABI 3" not in build:
        raise AssertionError(f"--check-build: native runtime:\n{build}")
    r0, p = res[0], res[0]["planner"]
    cost = r0["cost"]
    log(f"{label}: GPT-medium 24 layers through python -m "
        f"horovod_tpu_torch.runner -np 2, losses {r0['losses']}, replicas "
        f"bitwise equal, step seconds {r0['times']} (median "
        f"{statistics.median(r0['times']):.3f}), peak memory per rank "
        f"{r0['peak'] / 2**30:.2f} / {res[1]['peak'] / 2**30:.2f} GiB, "
        f"phase {seconds:.1f} s ({wire}) on {card}")
    log(f"{label}: native planner {p['buckets']} buckets of the 197 leaves "
        f"(threshold {p['threshold']}) bitwise plan_buckets_py, "
        f"{p['two_phase']} two-phase, schedule choices {p['algos']} equal "
        f"to choose_algo; plan_buckets {p['native_us']:.1f} µs native "
        f"against {p['python_us']:.1f} µs Python a call")
    log(f"{label}: timeline activity {cost['native_us']:.2f} µs on the "
        f"native writer, {cost['python_us']:.2f} µs on the Python one, "
        f"{cost['off_us']:.2f} µs with none open; an eager allreduce of one "
        f"element {cost['eager_allreduce_us']:.1f} µs (gloo, median of 20) "
        f"writes two")
    for r in range(LAUNCHER_RANKS):
        log(f"{label}: rank {r} timeline {files[r]['bytes']} bytes, "
            f"{files[r]['events']} events ({files[r]})")
    log(f"{label}: stall drill (window {STALL_WINDOW_S} s): rank 1 counted "
        f"{res[1]['warns_after']} warnings, rank 0 waited "
        f"{r0['probe_wait']:.1f} s and warned: {missing[0].strip()}")
    log(f"{label}: wire: clock offsets {w['offsets_us']} µs, merged "
        f"{w['merged_events']} events, 3 hvd_tpu_step roots a rank, rank "
        f"1's scrape steps {w['scraped_steps']}; monitor cycles "
        f"{r0['cycles']}; launches {r0['counts']}")
    return r0["counts"]


def launcher_phase(card: str):
    """Run "launcher 2 ranks" through ``python -m
    horovod_tpu_torch.runner`` in its own session (killed with its
    workers on a timeout) and check what it left: the exit code, no
    process left over, both timelines, the drill's warning in rank 0's
    stderr, and ``--check-build``."""
    import shutil
    import signal
    import tempfile

    repo = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_launcher_")
    out_dir = os.path.join(tmp, "out")
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(
               p for p in (repo, os.environ.get("PYTHONPATH")) if p)}
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner",
           "-np", str(LAUNCHER_RANKS),
           "--timeline-filename", os.path.join(tmp, "tl.json"),
           "--timeline-mark-cycles",
           "--stall-check-warning-time-seconds", str(STALL_WINDOW_S),
           "--output-filename", out_dir,
           sys.executable, os.path.abspath(__file__), LAUNCHER_WORKER_FLAG,
           tmp]
    try:
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, env=env, cwd=repo,
                                start_new_session=True)
        try:
            code = proc.wait(timeout=LAUNCHER_TIMEOUT_S)
        finally:
            if proc.poll() is None or child_processes():
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        seconds = time.perf_counter() - t0
        logs = {}
        for r in range(LAUNCHER_RANKS):
            with open(os.path.join(out_dir, f"rank.{r}.stderr")) as f:
                logs[r] = f.read()
        if code != 0:
            for r, text in logs.items():
                print(f"--- rank {r} stderr (tail)\n{text[-4000:]}",
                      file=sys.stderr)
            raise AssertionError(f"launcher 2 ranks: the launcher exited "
                                 f"{code}")
        if child_processes():
            raise AssertionError(f"launcher 2 ranks: processes left running: "
                                 f"{child_processes()}")
        res = []
        for r in range(LAUNCHER_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                res.append(json.load(f))
        files = {r: timeline_events(os.path.join(
                     tmp, "tl.json" + (f".rank{r}" if r else "")))
                 for r in range(LAUNCHER_RANKS)}
        build = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.runner",
             "--check-build"], env=env, cwd=repo, capture_output=True,
            text=True, check=True, timeout=300).stdout
        counts = check_launcher(res, logs, files, build, seconds,
                                "launcher 2 ranks",
                                "gloo staging through the host, 2 ranks on "
                                "one card: not a wire's time", card)
        return counts, res
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


REMOTE_DRIVER_FLAG = "--remote-driver"
REMOTE_WORKER_FLAG = "--remote-worker"
REMOTE_HOSTS = "fake-host-a:1,fake-host-b:1"   # two agents on loopback
REMOTE_TIMEOUT_S = 600.0
DRILL_EXIT = 7               # rank 1's exit code in the failure drill
DRILL_LIMIT_S = 60.0         # the launcher must return it within this
DRILL_SLEEP_S = 300.0        # the drills' sleeping ranks, never waited out
PING_ENV = {"HVD_TPU_AGENT_PING_INTERVAL": "1",
            "HVD_TPU_AGENT_MAX_MISSED": "2"}
PING_LIMIT_S = 30.0          # agents and workers gone after the driver dies
RUN_FUNC_SHAPE = (32000, 1024)   # lm_head's gradient, as "4 ranks"


def remote_driver(tmp: str, argv: list) -> int:
    """The child driver process of "remote 2 hosts": the launcher's CLI
    (``argv``) with ``remote.ssh_exec`` replaced by ``local_exec`` (the
    card's host has no sshd), each agent's pid appended to
    ``DIR/agents``."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from horovod_tpu_torch.runner import launch, remote

    def exec_local(host, agent_argv, secret_hex, **ssh_opts):
        proc = remote.local_exec(host, agent_argv, secret_hex, **ssh_opts)
        with open(os.path.join(tmp, "agents"), "a") as f:
            f.write(f"{proc.pid}\n")
        return proc

    remote.ssh_exec = exec_local
    return launch.main(argv)


def remote_worker(mode: str, tmp: str) -> None:
    """One rank of "remote 2 hosts", started by a task agent; writes its
    pid to ``DIR/pid<rank>``.  ``train``: checks nothing itself, records
    torchrun's variables and the key's hash, joins the world on the card
    over gloo and runs :func:`launch_steps`, results to
    ``DIR/rank<r>.json``.  ``fail``: rank 1 exits DRILL_EXIT once rank 0
    sleeps.  ``sleep``: both ranks sleep."""
    import hashlib

    env = os.environ
    rank = int(env["RANK"])
    with open(os.path.join(tmp, f"pid{rank}"), "w") as f:
        f.write(str(os.getpid()))
    if mode == "fail" and rank == 1:
        deadline = time.monotonic() + 60
        while not os.path.exists(os.path.join(tmp, "pid0")) \
                and time.monotonic() < deadline:
            time.sleep(0.1)
        sys.exit(DRILL_EXIT)
    if mode in ("fail", "sleep"):
        time.sleep(DRILL_SLEEP_S)
        return
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.runner.common.secret import SECRET_ENV

    key = env.get(SECRET_ENV)
    contract = {k: env.get(k) for k in CONTRACT_VARS}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hvd.init(device="cuda:0", backend="gloo")
    try:
        out = launch_steps(hvd.device(), rank)
        out.update(env=contract, cross=[hvd.cross_rank(), hvd.cross_size()],
                   local=[hvd.local_rank(), hvd.local_size()],
                   key=hashlib.sha256(key.encode()).hexdigest()
                   if key else None)
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        hvd.shutdown()


def pid_alive(pid: int) -> bool:
    """Whether ``pid`` runs (a zombie does not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def launched_pids(tmp: str) -> list:
    """The agents' and the ranks' pids one remote launch recorded."""
    pids = []
    agents = os.path.join(tmp, "agents")
    if os.path.exists(agents):
        with open(agents) as f:
            pids += [int(p) for p in f.read().split()]
    for r in range(LAUNCHER_RANKS):
        path = os.path.join(tmp, f"pid{r}")
        if os.path.exists(path):
            with open(path) as f:
                pids.append(int(f.read()))
    return pids


def remote_launch(tmp: str, mode: str, env=None):
    """Start the child driver: ``chip_smoke.py --remote-driver DIR -H
    REMOTE_HOSTS -- python chip_smoke.py --remote-worker MODE DIR``, in
    a session of its own."""
    repo = os.path.dirname(os.path.abspath(__file__))
    script = os.path.abspath(__file__)
    os.makedirs(tmp)
    run_env = {**os.environ, **(env or {}),
               "PYTHONPATH": os.pathsep.join(
                   p for p in (repo, os.environ.get("PYTHONPATH")) if p)}
    return subprocess.Popen(
        [sys.executable, script, REMOTE_DRIVER_FLAG, tmp, "-H",
         REMOTE_HOSTS, "--", sys.executable, script, REMOTE_WORKER_FLAG,
         mode, tmp], env=run_env, cwd=repo, start_new_session=True)


def end_launch(proc, tmp: str) -> list:
    """Kill whatever of a remote launch still runs (its driver's session,
    then every recorded pid); returns the pids that were still alive."""
    import signal

    left = [p for p in launched_pids(tmp) if pid_alive(p)]
    if proc.poll() is None:
        left.append(proc.pid)
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
    for pid in left:
        with contextlib.suppress(ProcessLookupError):
            os.kill(pid, signal.SIGKILL)
    return left


def check_remote(res: list, base: list, seconds: float, card: str) -> dict:
    """"remote 2 hosts"'s steps against "launcher 2 ranks"' (``base``):
    the environment contract a rank, then losses, parameters, launch
    counts and fusion tiers bit for bit."""
    label = "remote 2 hosts"
    masters = {(r["env"]["MASTER_ADDR"], r["env"]["MASTER_PORT"])
               for r in res}
    for r, out in enumerate(res):
        want = dict(RANK=str(r), WORLD_SIZE="2", LOCAL_RANK="0",
                    LOCAL_WORLD_SIZE="1", GROUP_RANK=str(r),
                    GROUP_WORLD_SIZE="2")
        got = {k: out["env"][k] for k in want}
        if got != want or not out["key"] or out["key"] != res[0]["key"] \
                or len(masters) != 1 or not out["env"]["MASTER_PORT"]:
            raise AssertionError(f"{label}: rank {r}'s environment {got} "
                                 f"(want {want}), rendezvous {masters}, "
                                 f"key hashes {[o['key'] for o in res]}")
        if out["cross"] != [r, 2] or out["local"] != [0, 1]:
            raise AssertionError(f"{label}: rank {r} cross {out['cross']}, "
                                 f"local {out['local']}")
        b = base[r]
        if (out["losses"], out["params"]) != (b["losses"], b["params"]):
            raise AssertionError(
                f"{label}: rank {r} differs from launcher 2 ranks: losses "
                f"{out['losses']} against {b['losses']}, parameters "
                f"{out['params'][:16]} against {b['params'][:16]}")
        if out["counts"] != b["counts"] or out["tiers"] != b["tiers"]:
            raise AssertionError(
                f"{label}: rank {r} launches {out['counts']} tiers "
                f"{out['tiers']} against launcher 2 ranks' {b['counts']} "
                f"{b['tiers']}")
        for name in ("flash_fwd", "quantize_blocks", "dequantize_blocks",
                     "dequantize_accumulate"):
            if out["counts"][name] <= 0:
                raise AssertionError(f"{name} never launched on the {label} "
                                     f"path (rank {r})")
    r0 = res[0]
    log(f"{label}: python -m horovod_tpu_torch.runner -H {REMOTE_HOSTS} "
        f"through the driver/task mesh, rendezvous {masters.pop()}; "
        f"GPT-medium 24 layers, losses {r0['losses']} and parameters "
        f"bitwise launcher 2 ranks', fusion tiers {r0['tiers']} (launcher "
        f"2 ranks: {base[0]['tiers']}), cross {[o['cross'] for o in res]}")
    log(f"{label}: step seconds {r0['times']} (median "
        f"{statistics.median(r0['times']):.3f}), peak memory per rank "
        f"{r0['peak'] / 2**30:.2f} / {res[1]['peak'] / 2**30:.2f} GiB, "
        f"launch {seconds:.1f} s (gloo staging through the host, 2 ranks "
        f"on one card: not a wire's time) on {card}; launches "
        f"{r0['counts']}")
    return r0["counts"]


def remote_phase(card: str, base: list) -> dict:
    """"remote 2 hosts": three launches of ``python -m
    horovod_tpu_torch.runner -H fake-host-a:1,fake-host-b:1`` from a
    child driver: the steps (against "launcher 2 ranks"), the failure
    drill and the agent-ping drill.  None may leave a process behind."""
    import signal
    import tempfile

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_remote_") as top:
        tmp = os.path.join(top, "train")
        t0 = time.perf_counter()
        proc = remote_launch(tmp, "train")
        try:
            code = proc.wait(timeout=REMOTE_TIMEOUT_S)
        finally:
            left = end_launch(proc, tmp) + child_processes()
        seconds = time.perf_counter() - t0
        if code != 0 or left:
            raise AssertionError(f"remote 2 hosts: the launcher exited "
                                 f"{code}, processes left {left}")
        res = []
        for r in range(LAUNCHER_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                res.append(json.load(f))
        counts = check_remote(res, base, seconds, card)

        tmp = os.path.join(top, "fail")
        t0 = time.perf_counter()
        proc = remote_launch(tmp, "fail")
        try:
            code = proc.wait(timeout=DRILL_LIMIT_S)
        finally:
            seconds = time.perf_counter() - t0
            left = end_launch(proc, tmp) + child_processes()
        if code != DRILL_EXIT or left:
            raise AssertionError(f"remote 2 hosts: failure drill exited "
                                 f"{code} in {seconds:.1f} s, processes "
                                 f"left {left}")
        log(f"remote 2 hosts: failure drill: rank 1 exited {DRILL_EXIT}, "
            f"the launcher returned {code} in {seconds:.1f} s (limit "
            f"{DRILL_LIMIT_S:.0f} s), rank 0 ended, no process left")

        tmp = os.path.join(top, "ping")
        proc = remote_launch(tmp, "sleep", env=PING_ENV)
        try:
            deadline = time.monotonic() + REMOTE_TIMEOUT_S
            while len(launched_pids(tmp)) < 2 + LAUNCHER_RANKS \
                    and proc.poll() is None and time.monotonic() < deadline:
                time.sleep(0.2)
            pids = launched_pids(tmp)
            if len(pids) < 2 + LAUNCHER_RANKS or proc.poll() is not None:
                raise AssertionError(f"remote 2 hosts: ping drill: ranks not "
                                     f"started (pids {pids}, driver "
                                     f"{proc.poll()})")
            os.kill(proc.pid, signal.SIGKILL)
            proc.wait()
            t0 = time.perf_counter()
            while any(pid_alive(p) for p in pids) \
                    and time.perf_counter() - t0 < PING_LIMIT_S:
                time.sleep(0.2)
            seconds = time.perf_counter() - t0
        finally:
            left = end_launch(proc, tmp) + child_processes()
        if left:
            raise AssertionError(f"remote 2 hosts: ping drill: processes "
                                 f"left {PING_LIMIT_S:.0f} s after the "
                                 f"driver's SIGKILL: {left}")
        log(f"remote 2 hosts: agent-ping drill ({PING_ENV}): the driver "
            f"killed, both agents aborted their ranks and exited; nothing "
            f"left after {seconds:.1f} s (limit {PING_LIMIT_S:.0f} s)")
    log(f"remote 2 hosts: phase {time.perf_counter() - t_phase:.1f} s on "
        f"{card}")
    return counts


def run_func_body(device: str) -> tuple:
    """One rank of "run_func 2 ranks", the function ``hvd.run`` ships (by
    reference, as ``chip_smoke.run_func_body``): joins the world on
    ``device`` over gloo, int8-allreduces a RUN_FUNC_SHAPE f32 tensor
    from seed ``rank`` (the stack tier: B2, then B3), the launch counts
    around it; returns ``(rank, digest, device name, counts)``."""
    import torch
    import horovod_tpu_torch as hvd

    hvd.init(device=device, backend="gloo")
    rank = hvd.rank()
    x = run_func_input(rank, device)
    torch.cuda.synchronize()
    hvd.ops.reset_launch_counts()
    out = hvd.allreduce(x, compression=hvd.Compression.int8,
                        name="run_func")
    torch.cuda.synchronize()
    counts = hvd.ops.launch_counts()
    return rank, digest([out]), torch.cuda.get_device_name(0), counts


def run_func_input(rank: int, device: str):
    import torch

    gen = torch.Generator(device=device).manual_seed(rank)
    return torch.randn(RUN_FUNC_SHAPE, generator=gen, device=device)


def run_func_phase(card: str, device: str = "cuda:0") -> dict:
    """"run_func 2 ranks": ``hvd.run(chip_smoke.run_func_body, np=2)``,
    then the same through the agent mesh (``hosts=REMOTE_HOSTS``,
    ``workdir=``, ``remote.ssh_exec`` replaced by ``local_exec`` for the
    call): results in rank order, the digests alike on both ranks and
    bit for bit the plain B2 and B3 over the same seeds, B2 and B3
    launched, no process left."""
    import tempfile
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.runner import remote

    import chip_smoke   # by name, not __main__: the workers import it

    want = digest([plain_stack_allreduce(
        [run_func_input(r, device) for r in range(LAUNCHER_RANKS)],
        "average")])
    torch.cuda.empty_cache()
    runs = {}
    t0 = time.perf_counter()
    runs["local"] = hvd.run(chip_smoke.run_func_body, args=(device,),
                            np=LAUNCHER_RANKS)
    seconds = {"local": time.perf_counter() - t0}
    ssh_exec = remote.ssh_exec
    remote.ssh_exec = remote.local_exec
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_run_func_") as wd:
            t0 = time.perf_counter()
            runs["agents"] = hvd.run(chip_smoke.run_func_body,
                                     args=(device,), np=LAUNCHER_RANKS,
                                     hosts=REMOTE_HOSTS, workdir=wd)
            seconds["agents"] = time.perf_counter() - t0
    finally:
        remote.ssh_exec = ssh_exec
    name = torch.cuda.get_device_name(0)
    for route, results in runs.items():
        ranks = [r[0] for r in results]
        digests = {r[1] for r in results}
        if ranks != list(range(LAUNCHER_RANKS)) or digests != {want} \
                or {r[2] for r in results} != {name}:
            raise AssertionError(
                f"run_func 2 ranks ({route}): ranks {ranks}, digests "
                f"{digests} against the plain {want}, cards "
                f"{[r[2] for r in results]}")
        for rank, *_, counts in results:
            for kernel in ("quantize_blocks", "dequantize_accumulate"):
                if counts[kernel] <= 0:
                    raise AssertionError(f"{kernel} never launched on the "
                                         f"run_func 2 ranks path ({route}, "
                                         f"rank {rank})")
    if child_processes():
        raise AssertionError(f"run_func 2 ranks: processes left running: "
                             f"{child_processes()}")
    log(f"run_func 2 ranks: hvd.run(chip_smoke.run_func_body, np=2) local "
        f"{seconds['local']:.1f} s and through the agent mesh "
        f"{seconds['agents']:.1f} s: results in rank order, the int8 "
        f"allreduce of {list(RUN_FUNC_SHAPE)} f32 bitwise its plain form "
        f"({want[:16]}) on both ranks and routes, on {card}; launches "
        f"{runs['local'][0][3]}")
    return runs["local"][0][3]


WORKER_FLAG = "--two-rank-worker"
SET_WORKER_FLAG = "--four-rank-worker"
MB_WORKER_FLAG = "--microbatch-worker"
RESNET_WORKER_FLAG = "--resnet-worker"
HIER_WORKER_FLAG = "--hier-worker"
SEQ_WORKER_FLAG = "--seq-worker"
PIPE_WORKER_FLAG = "--pipe-worker"
MOE_WORKER_FLAG = "--moe-worker"
FSDP_WORKER_FLAG = "--fsdp-worker"
AUTOTUNE_WORKER_FLAG = "--autotune-worker"
ELASTIC_WORKER_FLAG = "--elastic-worker"
# Each multi-rank path's world, environment (read by hvd.init) and body.
RANK_PATHS = {
    PIPE_WORKER_FLAG: (SET_RANKS, {}, "pipe_ranks"),
    MOE_WORKER_FLAG: (SET_RANKS, {}, "moe_ranks"),
    FSDP_WORKER_FLAG: (SET_RANKS, FSDP_ENV, "fsdp_ranks"),
    AUTOTUNE_WORKER_FLAG: (WIRE_RANKS, AUTOTUNE_ENV, "autotune_ranks"),
}
WORKER_FLAGS = (WORKER_FLAG, SET_WORKER_FLAG, MB_WORKER_FLAG,
                RESNET_WORKER_FLAG, HIER_WORKER_FLAG, SEQ_WORKER_FLAG,
                ELASTIC_WORKER_FLAG, *RANK_PATHS)


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
    world = (SET_RANKS if flag in (SET_WORKER_FLAG, HIER_WORKER_FLAG,
                                   SEQ_WORKER_FLAG)
             else WIRE_RANKS)
    if flag == HIER_WORKER_FLAG:
        os.environ.update(HIER_ENV)             # read by hvd.init
    if flag == SEQ_WORKER_FLAG:
        os.environ.update(SEQ_ENV)
    if flag in RANK_PATHS:
        world, env, _ = RANK_PATHS[flag]
        os.environ.update(env)
        if flag == AUTOTUNE_WORKER_FLAG:
            os.environ["HOROVOD_AUTOTUNE_LOG"] = os.path.join(
                tmp, "autotune.jsonl")
    if flag == ELASTIC_WORKER_FLAG:
        # The session owns its group, made from torchrun's variables (the
        # parent sets MASTER_ADDR and MASTER_PORT): an elastic re-init
        # then rendezvouses anew.
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
        hvd.init(device="cuda:0", backend="gloo")
    else:
        dist.init_process_group(
            "gloo", init_method=f"file://{os.path.join(tmp, 'store')}",
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
        elif flag == HIER_WORKER_FLAG:
            res = hier_ranks(hvd.device(), rank)
        elif flag == SEQ_WORKER_FLAG:
            res = seq_ranks(hvd.device(), rank)
        elif flag == ELASTIC_WORKER_FLAG:
            res = elastic_ranks(hvd.device(), rank)
        elif flag in RANK_PATHS:
            res = globals()[RANK_PATHS[flag][2]](hvd.device(), rank)
        else:
            res = set_ranks(hvd.device(), rank)
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        hvd.shutdown()
        if dist.is_initialized():
            dist.destroy_process_group()


def child_processes() -> list:
    """The pids of this process's living children (Linux ``/proc``)."""
    import glob

    pids = []
    for path in glob.glob(f"/proc/{os.getpid()}/task/*/children"):
        with open(path) as f:
            pids += [int(p) for p in f.read().split()]
    return pids


def spawn_ranks(flag: str, world: int, env=None) -> list:
    """Run ``world`` ranks of a phase as plain subprocesses of this script
    (multiprocessing would leave its resource tracker running), each
    waited for or killed before this returns; their results in rank
    order.  NCCL refuses several ranks on one device, so they share the
    card over gloo, which stages CUDA tensors through the host.  ``env``
    is added to the ranks' environment."""
    import tempfile

    script = os.path.abspath(__file__)
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen([sys.executable, script, flag, str(r), tmp],
                                  env={**os.environ, **(env or {})})
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
    probe_check(card)

    # The "1 rank" phase scrapes this process's /metrics; the ranks the
    # multi-rank phases spawn serve none (the variable is read at init).
    os.environ["HVD_TPU_METRICS_PORT"] = str(hvd.basics._free_port())
    try:
        hvd.init()
    finally:
        del os.environ["HVD_TPU_METRICS_PORT"]
    try:
        dev = hvd.device()
        gen = torch.Generator(device=dev).manual_seed(0)
        rows = kernel_phase(dev, gen)
        non_finite_check(dev)
        model_check(dev)
        counts, dp_tok_s, dp_peak, obs_seconds = train_phase(dev, card)
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
        hier_counts = hierarchical_phase()
        seq_counts = sequence_parallel_phase(card)
        new_paths = {}
        for flag, check, label in (
                (PIPE_WORKER_FLAG, check_pipeline, "pipeline 4 ranks"),
                (MOE_WORKER_FLAG, check_moe, "moe 4 ranks"),
                (FSDP_WORKER_FLAG, check_fsdp, "fsdp 4 ranks"),
                (AUTOTUNE_WORKER_FLAG, check_autotune, "autotune 2 ranks")):
            torch.cuda.empty_cache()
            new_paths[label] = parallel_phase(flag, RANK_PATHS[flag][0],
                                              check, label, card)
        convnet_counts = convnet_phase(dev, card)
        torch.cuda.empty_cache()
        durable_counts = durable_phase(dev, card)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        elastic_counts = check_elastic(
            spawn_ranks(ELASTIC_WORKER_FLAG, WIRE_RANKS,
                        env={"MASTER_ADDR": "127.0.0.1",
                             "MASTER_PORT": str(hvd.basics._free_port())}),
            time.perf_counter() - t0, "elastic 2 ranks",
            "gloo staging through the host, 2 ranks on one card: not a "
            "wire's time", card)
        torch.cuda.empty_cache()
        launcher_counts, launcher_res = launcher_phase(card)
        torch.cuda.empty_cache()
        remote_counts = remote_phase(card, launcher_res)
        run_func_counts = run_func_phase(card)
        route_check(dev)
    finally:
        hvd.shutdown()
    by_path = {"1 rank": counts, "zero 1 rank": zero_counts,
               "2 ranks": wire_counts, "sharded 2 ranks": sharded_counts,
               "4 ranks": set_counts, "microbatch 2 ranks": mb_counts,
               "resnet50 1 rank": resnet_counts,
               "resnet50 1 rank fp16": resnet_fp16_counts,
               "resnet50 2 ranks": resnet_ranks_counts,
               "hierarchical 4 ranks": hier_counts,
               "sequence-parallel 4 ranks": seq_counts, **new_paths,
               "bert-large 1 rank": bert_counts, **convnet_counts,
               "durable 1 rank": durable_counts,
               "elastic 2 ranks": elastic_counts,
               "launcher 2 ranks": launcher_counts,
               "remote 2 hosts": remote_counts,
               "run_func 2 ranks": run_func_counts}
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
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, "
        f"{obs_seconds:.1f} s of it the \"1 rank\" phase's observability "
        f"checks (the scrape, the flight dump and {2 * OVERHEAD_TURNS} x "
        f"{STEPS} more steps, without and with the hooks)")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [LAUNCHER_WORKER_FLAG]:
        launcher_worker(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:2] == [REMOTE_DRIVER_FLAG]:
        sys.exit(remote_driver(sys.argv[2], sys.argv[3:]))
    if sys.argv[1:2] == [REMOTE_WORKER_FLAG]:
        remote_worker(sys.argv[2], sys.argv[3])
        sys.exit(0)
    if sys.argv[1:2] and sys.argv[1] in WORKER_FLAGS:
        rank_worker(sys.argv[1], int(sys.argv[2]), sys.argv[3])
        sys.exit(0)
    sys.exit(main())
