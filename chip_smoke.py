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
   other card).  Then "hvdlint (host)": ``horovod_tpu_torch.analysis.
   run()`` over this checkout (the AST checkers, the kernel check
   included) must give 0 unsuppressed findings and the kernel check
   must see the eight ``@kernel`` wrappers; prints the seconds, the
   checkers and check ids run and the modules read.  ``import
   horovod_tpu_torch.torch`` must work; on a host without tensorflow
   (the card's) ``import horovod_tpu_torch.tensorflow`` and ``.keras``
   must raise an ``ImportError`` naming it, and a line says the TF and
   Keras bindings do not run on the card.
2. Kernel phase: each hand-written kernel against its plain PyTorch
   version, on the card, at the shapes the main paths give it.  The int8
   kernels (B2-B4) and the fused apply kernels (B6, B7) must match bit
   for bit, on rows holding NaN (and for B2-B4 Inf) as well; flash
   attention (B1, the bf16 tensor-core kernel) within the bf16 tolerance
   (3e-2 on O, 1e-4 on lse) and, row by row, within 1e-2 of the row's
   largest |O|, on normal and on peaky (q * 8) scores, at GPT-medium's
   causal shape, at BERT-Large's non-causal one, at the ring's
   blocks (causal and non-causal), at the two rows a rank of the
   pipeline, moe and fsdp paths runs (causal) and at the "serve 1
   rank" oracle's ragged forwards (B*H 16, causal, T 17 and 900 in
   bf16, T 17 and 931 through the f32 CUDA-core kernel within 2e-5 on
   O, 1e-4 on lse, 1e-2 row-relative); the flash backward (bf16
   tensor-core kernels) at the benchmark cells' layers (GPT: B*H 256, T
   1024, causal; BERT: B*H 2048, T 128, non-causal), each of dQ, dK and
   dV within 1.25x of the plain version's own bf16 error against the
   plain version on f32 upcasts of the same inputs; the blocked
   matmul (B5) with a bf16 and with an f32 x within twice its plain
   version's error against an f64 product plus 1e-6 of the product's
   largest |value|.  B1 and B5 also print their TFLOP/s beside the
   yardstick's.  Prints each
   kernel's median time, its plain version's, its bound and, where one
   PyTorch call computes the same function, that call's time as a
   yardstick the port never calls: ``q * s[:, None]`` for the
   dequantize, ``F.scaled_dot_product_attention`` for flash attention
   (its backward through ``torch.autograd.grad`` for the backward),
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
     replicas must agree.  The steps run under the step recorder
     (``analysis.step_check.record_collectives``): the two ranks'
     sequences of collectives (op, dtype, element count, group width)
     must be equal; prints their length and ops (the ZeRO steps of
     "sharded 2 ranks" likewise).
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
   finite losses; (e) B1-B4 launched; (f) each step's recorded
   collectives equal on both ranks, its int8 overlap wire 4 × buckets
   reduce-scatter phases and one all-gather phase a bucket, the
   planner's (two calls a phase: payload and scales).  Prints the
   sequences' lengths, the phase's seconds, each
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
   (``benchmarks/gpt_bench.py``'s: vocab 32000, 16 heads, d_model 1024,
   d_ff 4096, bf16 activations, f32 parameters; 6 layers, SP_LAYERS,
   cut from 24 for the script's time) at 4096
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
   GPT-medium (8 layers, PIPE_LAYERS, cut from 24 for the script's
   time) as ``PipelinedGPT`` on ``{'pp': 4}``: four stages of two
   blocks, 4 microbatches of 2 × 1024 tokens (the batch of
   8 × 1024 from seed 0 on every rank), 7 ticks, 3 AdamW steps of
   ``make_spmd_train_step``: finite losses, the same on every rank, the
   embedding and head bitwise equal on the four ranks after every step,
   B1 launched exactly 3 × 7 × 6 times a rank; step 1 against the
   one-rank GPT step on the same weights (the pipelined model draws
   GPT's) and tokens, rank 0 alone after the others leave (the limits of
   step 13's oracle); at 4 layers (one block a stage) a remat step: the
   plain step's loss (1e-6) and parameters (1e-6), B1 twice as often.
15. "moe 4 ranks": four processes share the card over gloo.
   GPT-medium's widths, 6 layers (MOE_LAYERS, cut from 24 for the
   script's time), every second FFN a mixture of 8
   experts (top-2, capacity factor 1.25) on ``{'dp': 2, 'ep': 2}``
   (``shard_params``: four experts a rank), 4 × 1024 tokens from seed 0,
   3 AdamW steps on ``lm_loss_fn``: finite losses, the same on every
   rank, the replicated leaves bitwise equal on the four ranks and the
   experts on each dp pair, B1 6 times a step; step 1 against the
   one-rank MoE GPT on the whole batch, at the same depth, rank 0 alone.
   Then, in the same world, 2 layers (MOE_SP_LAYERS) on ``{'sp': 2,
   'ep': 2}`` with ring attention on the flash engine (each rank 4 × 512
   tokens, routed over the global token order): one AdamW step, its
   loss, aux loss and replicated leaves the same on every rank, B1
   launched on every rank, against the one-rank MoE GPT at 2 layers.
16. "fsdp 4 ranks": four processes share the card over gloo under
   ``HVD_TPU_MESH_PLAN=fsdp=4``.  GPT-medium (8 layers, FSDP_LAYERS,
   cut from 24 for the script's time) through
   ``make_fsdp_train_step`` (each parameter cut on its largest
   divisible dim, AdamW on the slices, a block's parameters gathered
   for its forward and again for its backward), 2 × 1024 tokens a rank,
   3 steps: finite losses, the same on every rank, B1 8 times a step;
   every rank's ``peak_gathered_bytes`` at most the root's bytes plus
   twice the largest block's and below half the whole model's; step 1's
   recorded collectives equal on every rank; step 1 against the
   one-rank data-parallel step on the whole batch; peak memory a rank
   beside the oracle's, the resting bytes (slices and AdamW state) and
   the whole model's; at 2 layers one HSDP step
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
19. "durable 1 rank": GPT-medium's widths at 4 layers (DURABLE_LAYERS,
   cut from 24 for the script's time limit) with the "1 rank"
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
   checked first (a save is ~1.9 GB).  Prints the save stall (p50, max),
   the write time, bytes a save, the restore time, the commit (device to
   pinned host) and the step times with and without saves.  Its launch
   counts are run B's, the resume's and the replay's (not run A's).
20. "torch binding 2 ranks": two processes share the card over gloo
   (``--binding-worker``).  GPT-medium at 24 layers (flash attention,
   bf16 activations, f32 parameters from seed 0, broadcast through
   ``horovod_tpu_torch.torch.broadcast_parameters``), AdamW(3e-4, weight
   decay 1e-4), 8 x 1024 tokens a rank from seed ``rank``.  (a) Three
   steps through ``horovod_tpu_torch.torch.DistributedOptimizer(...,
   named_parameters=...)`` on ``Compression.none`` (one
   post-accumulate hook a parameter, each ``allreduce_async_`` started
   during backward), then three from the same weights through
   ``make_train_step`` with ``Compression.none``: losses and parameters
   within 1e-6 relative (both sum two f32 values and halve them, so bit
   for bit is expected; printed), a handle in flight when each backward
   returned, one allreduce a parameter a step.  (b) Three steps on
   ``Compression.fp16`` with ``num_groups=4``: finite losses, step 1's
   loss bit for bit (a)'s, step 1's reduced gradient within fp16's
   rounding of (a)'s (|Δ| ≤ (2u(1 + u) + 2^-24) max_r |g_r| + 2^-23,
   u = 2^-11, the Max over the ranks' local gradients an allreduce).
   Both ranks' collective sequences (``step_check.record_collectives``)
   equal in (a) and (b).  (c) ``SyncBatchNorm(64)`` on ``[32, 64, 112, 112]`` a
   rank (ResNet-50's stem), f32 and bf16, the backward of ``sum(y ·
   dy)``: rank 0 holds the output, ``running_mean``, the unbiased
   ``running_var``, the input gradient and the ranks' summed weight and
   bias gradients against ``nn.BatchNorm2d`` in f64 on both ranks'
   batches concatenated (max |Δ| / max |oracle| ≤ 1e-5 in f32, 5e-2 in
   bf16).  Prints the hook route's step times beside the fused route's
   (gloo stages through the host: not a wire's time), the peak memory a
   rank and B1's launches (the hook steps of (a) and (b)).
21. "elastic 2 ranks": two processes share the card over gloo in a
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
22. "launcher 2 ranks": ``python -m horovod_tpu_torch.runner -np 2
   --timeline-filename DIR/tl.json --timeline-mark-cycles
   --stall-check-warning-time-seconds 15 --output-filename DIR/out``
   starts two ranks of this script (``--launcher-worker DIR``), which
   share the card over gloo in a group the session owns.  Each checks
   torchrun's variables and the launch's HMAC key, the native library
   loaded, the timeline writing through ``NativeTimeline`` and the
   cross-process monitor running; then GPT-medium at 6 layers
   (``LAUNCH_LAYERS``, cut from 24, widths kept), a batch of 8 x 1024
   from seed 0 + rank, ``dp_step``'s AdamW on the int8+EF wire, 3 steps
   each followed by an eager ``allreduce`` of the loss: finite losses,
   replicas bitwise equal, B1-B4 launched.  The native planner's plans
   of the step's 53 gradient leaves must equal ``plan_buckets_py``,
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
23. "remote 2 hosts": the multi-host launch on one machine: a child
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
24. "run_func 2 ranks": ``hvd.run(chip_smoke.run_func_body,
   args=("cuda:0",), np=2)`` (the function reached through the module
   ``chip_smoke``, so the standard pickle finds it in the workers), then
   the same with ``hosts="fake-host-a:1,fake-host-b:1"`` and a
   ``workdir`` through the agent mesh: each rank joins the world on the
   card over gloo and int8-allreduces a [32000, 1024] f32 tensor from
   seed ``rank`` (the eager stack tier: B2, then B3); the results must
   come back in rank order, the digests alike and equal to the plain
   B2/B3 composition over the same seeds computed here, B2 and B3
   launched on every rank, no process left.
25. "serve 1 rank", in a process of its own (``--serve-worker``, a gloo
   world of one; after bf16 serving at these prompt lengths
   ``torch.profiler`` records no device event in that process, and the
   route check needs them): GPT-medium (``benchmarks/gpt_bench.py``'s widths,
   24 layers, flash attention, f32 parameters from seed 0) served by
   ``hvd.serve``'s engine at the reference's defaults (8 slots, buckets
   64/256/1024, a paged cache of 16-token blocks, drafts of 4).  (a)
   The model with f32 activations, then with bf16: prompts of 17, 200,
   480 and 900 tokens from seed 0, 32 greedy tokens each through the
   dense engine, the paged engine and the paged engine with the model
   as its own drafter (``spec=True``), against the full-forward argmax
   loop (B1 in every forward).  Tokens must equal the oracle's wherever
   its top-1/top-2 logit gap is at least ``SERVE_MARGIN`` (1e-3 f32,
   0.25 bf16, logit units); a first differing token is allowed only
   under the margin and ends the comparison.  Prints the positions
   compared and the largest |Δlogit| of the engine's ``lm_head`` rows
   against the oracle's (dense and paged).  Then the dense and the
   paged engine teacher-forced (each slot's next input set to the
   oracle's token before every step): all 128 rows' logits within
   ``SERVE_LOGIT_LIMIT`` (half the margin: 5e-4 f32, 0.125 bf16) of the
   oracle's, and the tokens equal wherever the margin holds; two
   control faults patched into ``cached_attention`` on the bf16 paged
   engine (K/V rounded to fp8, positions one early) must exceed that
   limit.  (b) The bf16 model behind
   ``ContinuousBatcher`` with the self-drafter: 24 requests from seed 0
   in a closed loop of 8 clients, prompts of 16-900 tokens, 32 tokens
   each, half greedy and half at temperature 0.8 / top-k 50, 8 sharing
   a 512-token system prompt and a 4-token turn header (prefix hits and
   copy-on-write: at least 7 hits and 1 copy), 4 greedy ones
   speculative: every request must finish whole; prints tokens/s, TTFT
   and TPOT p50/p99, the prefix-hit ratio, tokens a verify, the KV
   blocks in use at most, peak memory and, on an engine with no
   drafter, the plain decode step's time with all 8 slots busy
   (readings, not gates).  Then
   the preemption drill on a one-slot engine of the f32 model (the
   reference's sole-active-slot contract): a batch request preempted by
   an interactive one with a 1 s deadline must resume to its
   uninterrupted tokens, greedy (f32 margin rule) and at temperature
   0.8 (exactly).  (c) ``serve:step=0,mode=evict`` at the allocation of
   a request sharing a primed prompt's system tokens: it must fire
   once, evict the primed prompt's cached tail, and the request and the
   primed prompt served again must equal the oracle (f32 margin rule):
   recomputed blocks, never stale ones.  B1 must launch exactly 24
   times an oracle forward in (a) and never in the engine's traffic.
26. "serve 2 replicas", in a process of its own (``--replicas-worker``):
   two ``InferenceServer``s on the card, each with
   its own engine of the bf16 model, behind a ``Router`` over the HMAC
   wire: 8 greedy requests sent at once must finish with one replica's
   tokens (the bf16 margin rule, margins from the full-forward oracle)
   and both replicas must serve; then ``serve:step=3,mode=kill`` on
   replica A mid-decode (a fresh router's first pick): the request must
   complete on B with the same tokens, A dead, B's completed count up
   by one, and a replay of its id answered from the router's cache (no
   lost response, no duplicate).  Prints the phase's seconds and the
   wire's.
27. "fleet 3 replicas", in a process of its own (``--fleet-worker``):
   a prefill replica and two decode replicas (``InferenceServer``s on
   the card, each with its own engine of the bf16 model at the
   reference's defaults) behind a ``Router`` over the HMAC wire.  12
   greedy requests from seed 0 sent at once (prompts of 17 to 900
   tokens, 4 of them the 512-token system prompt, the turn header and a
   user turn; 32 tokens each): every response must name a decode
   replica in ``migrated_to``, every transfer must verify its block
   digests on the receiver (12 verified, none rejected, the blocks each
   prompt holds), and the tokens must equal one unified replica's
   wherever the full-forward oracle's margin holds (bf16 margin rule).
   Drills: ``serve:step=0,mode=migrate`` (one block damaged after its
   digest): the receiver rejects it and the prefill replica decodes the
   request with the same tokens; a ``FleetController`` with
   ``collector=`` a ``TelemetryPlane``'s collector: a round on the
   plane's scrape of the three replicas (the router's own stats poll
   never called, no action), a forced ``scale_out("decode")`` through
   an in-process ``ReplicaLauncher`` (the new replica scraped, requests
   served), then its ``drain_and_retire`` under requests in flight,
   retired with every request answered; ``serve:step=0,mode=kill`` on
   the prefill replica at its handoff (mid-migration): the request
   completes exactly once, on a decode replica, the prefill replica
   dead, a replay of its id answered from the router's cache.  Prints
   ``migrate_ms`` p50 and p99, the bytes moved a request, TTFT and TPOT
   p50 on the disaggregated route, one request's ``migrate_ms`` alone
   on the idle fleet and the peak memory (readings).
28. "swap 2 replicas", in a process of its own (``--swap-worker``),
   GPT-medium's widths at 8 layers (SWAP_LAYERS; cut from 24 for the
   script's time limit beside the TP phases):
   step 1 (the bf16 model's boot weights, f32 parameters) and step 2
   (the boot weights with ``lm_head`` and the last block's MLP moved by
   a seeded draw) written through ``AsyncCheckpointer``; two unified
   replicas, each with its own copy of the boot model and a
   ``WeightSubscriber`` on the store (polling off: the controller's
   roll is the only swap), behind a ``Router``.
   ``FleetController.roll_swap(2, max_concurrent=1)`` under a closed
   loop of 8 clients: no request dropped, each response's tokens its
   version's (a fresh engine on that step's weights, the bf16 margin
   rule with that step's full-forward margins), the pulled leaves
   exactly the three moved ones, ``pulled_bytes`` their bytes and under
   the step's; every request after the roll step 2's.  The rollback to
   step 1 restores the boot parameters bit for bit and the boot tokens,
   each prompt served alone, bit for bit.  ``swap:p=1,mode=corrupt-
   shard``: the swap is rejected, ``SwapResponse.weights_version`` is
   still 1, the boot tokens still served.  Prints the write, roll and
   swap times and the pulled bytes.
29. "serve tp 2", in a process of its own (``--tp-worker``): GPT-medium
   (8 layers, TP_LAYERS, cut from 24 for the script's time;
   bf16 activations, f32 parameters from seed 0) in a
   tensor-parallel engine of two shards on the one card
   (``devices=["cuda:0", "cuda:0"]``) beside a tp = 1 engine on the same
   weights, both at the reference's defaults.  (a) Greedy on prompts of
   17/200/480/900 tokens, 32 tokens, with both engines' ``lm_head``
   rows tapped: prints whether they are bit for bit tp = 1's, else the
   largest |Δlogit|, and the tokens must equal tp = 1's under the bf16
   margin rule; temperature 0.8 / top-k 50 tokens must be equal when
   the logits are; a prefix hit and a copy-on-write divergence (the hit
   counted, the shared tokens, one copy at least) and a self-drafted
   speculative batch, tokens under the margin rule.  (b) A tp = 2
   prefill replica hands 4 requests (17/200/280/480 tokens), one at a
   time, to a tp = 1 decode replica over the HMAC wire, two shard
   streams each (both shards' frames, the manifest with ``tp_degree``
   2 on each shard's first frame, every transfer verified); then
   ``serve:step=0,mode=migrate`` on a fresh prompt: rejected on the
   receiver, decoded by the sender.  Prints each ``migrate_ms`` and
   the bytes moved.  (c) "swap 2 replicas"' step 1 → step 2 (3 leaves)
   pulled by a ``WeightSubscriber`` into a tp = 2 engine:
   ``pulled_bytes_per_shard`` must sum to ``pulled_bytes_full`` plus
   the replicated leaves' extra copies, ``pulled_bytes`` be the widest
   shard, and the tokens after the flip be step 2's (margin rule).
   (d) The lockstep drill: a leader ``InferenceServer(tp_peers=)`` and a
   follower ``ShardServer`` in a child (``--tp-shard-worker``, with
   ``serve:step=2,mode=kill`` armed there), each driving a whole
   engine, behind a ``Router`` beside a tp = 1 survivor: 12 greedy
   requests must all complete with the survivor's tokens, the replica
   die once (``shard_rank_lost``), the router bench it with one strike,
   the follower's fault fire once.  B1 must launch TP_LAYERS times an
   oracle forward and nothing else any kernel.  Prints tokens/s and TPOT p50
   of 8 requests of 64 tokens at once on each engine (readings: two
   shards on one card cannot show tensor parallelism's gain) and the
   peak memory.
30. "fleet sim (host)", in a process of its own (``--sim-worker``), no
   device work: the port's ``FleetSim`` over the real router, fleet
   controller, QoS gate and queues on a virtual clock.  Capacity: 1000
   replicas, 10^4 requests at 2000 rps, seed 1, ``serve:p=0.001,seed=2,
   mode=kill``: no invariant violated, at least one kill, under 60 s of
   wall time; prints events/s.  Calibration: an unloaded 4-replica run
   (2000 requests at 5 rps) on a ``ReplicaProfile`` fitted by
   ``LatencyDist`` from this run's readings (TTFT and TPOT p50/p99 of
   "serve 1 rank"'s traffic and ``migrate_ms`` mean/p99 of "fleet 3
   replicas", all at 24 layers; the swap ms of "swap 2 replicas", at
   its 8 layers): TTFT p50 and p99 within ±15% of the profile's.  The
   band checks the simulator's fit to the profile (its sampler and
   queueing), not the card: the profile is the card's readings, and an
   unloaded sim returns them whatever they are.  The death-spiral and migration-convoy
   drills must page within 3 collection rounds; clean seeded runs must
   stay silent.  The card's name is printed beside the readings.
31. "sanitize serve 1 rank", in a process of its own
   (``--sanitize-worker``) started with ``HVD_TPU_SANITIZE=raise`` in its
   environment: ``analysis.sanitizer.install()`` over the package, then
   GPT-medium's widths at SANITIZE_LAYERS layers (bf16 activations, f32
   parameters from seed 0): an ``InferenceServer`` on the paged engine
   (two slots) and the batcher with QoS over the HMAC wire takes 8
   requests of 64 tokens (two batch requests, an interactive one that
   preempts one of them under a 1 ms TTFT SLO, one cancelled while
   queued, four standard ones at once), then one ``AsyncCheckpointer``
   save of the parameters.  Every request must finish with its tokens
   (the cancelled one with "cancelled"), one preemption; no sanitizer
   violation, and ``audit_check`` must find no KV block or buffer set
   held (the pool and the buffer pool registered).  Prints, not gated,
   tokens/s of the same traffic run warm with the sanitizer on and,
   after ``uninstall()``, off.
32. Route check: the profiler's device trace must show a bf16
   flash_fwd call at the step's shape run the tensor-core kernel
   (flash_fwd_wgmma) and an f32 one the CUDA-core kernel, a bf16
   non-causal one at BERT-Large's shape the tensor-core kernel, and B4
   and B3 at rows of 1024 run their vector kernel and at rows of 1023
   only their scalar one.  It runs last, so that the profiler touches
   none of the timed phases.
33. Prints the ``kernels`` JSON line (all eight kernels, with their
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
import gc
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
MB_LAYERS = 12                   # its depth, cut from 24 (the script's time)
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
    rows.append(flash_bwd_kernel_row(dev, gen))
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
        if "f32" in row:
            f = row["f32"]
            log(f"kernel {row['name']}: at {f['shape']} "
                f"{'causal' if f['causal'] else 'non-causal'} f32 (the CUDA-"
                f"core route) {f['ms']} ms, plain {f['plain_ms']} ms, bound "
                f"{f['bound_ms']} ms ({f['bound_by']}; bytes {f['bytes_ms']} "
                f"ms, operations {f['ops_ms']} ms)")
        if "rank_rows" in row:
            rr = row["rank_rows"]
            log(f"kernel {row['name']}: at {rr['shape']} causal (two rows: "
                f"the pipeline, moe and fsdp paths) {rr['ms']} ms, plain "
                f"{rr['plain_ms']} ms, bound {rr['bound_ms']} ms "
                f"({rr['bound_by']}; bytes {rr['bytes_ms']} ms, operations "
                f"{rr['ops_ms']} ms), SDPA {rr['library_ms']} ms")
        for so in row.get("serve_oracle", []):
            log(f"kernel {row['name']}: at {so['shape']} causal {so['dtype']} "
                f"(the serve oracle) {so['ms']} ms, plain {so['plain_ms']} "
                f"ms, bound {so['bound_ms']} ms ({so['bound_by']}; bytes "
                f"{so['bytes_ms']} ms, operations {so['ops_ms']} ms), SDPA "
                f"{so['library_ms']} ms, errors O {so['max_abs_err']} lse "
                f"{so['max_abs_err_lse']} row {so['max_row_rel_err']}")
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


# B1's limits against its plain version, by input type (the card test
# ``test_flash_fwd_matches_plain_version``'s): on O, on lse, and on each
# row of O relative to the row's largest |O|.
FLASH_LIMITS = {"bfloat16": (3e-2, 1e-4, 1e-2), "float32": (2e-5, 1e-4, 1e-2)}


def flash_errors(q3, k3, v3, scale: float, causal: bool = True):
    """(O, lse, row-relative) error of the kernel against its plain
    version, and whether all three are inside the input type's
    ``FLASH_LIMITS``."""
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
    lim_o, lim_lse, lim_row = FLASH_LIMITS[str(q3.dtype).split(".")[-1]]
    return err_o, err_lse, err_row, (err_o <= lim_o and err_lse <= lim_lse
                                     and err_row <= lim_row)


def flash_case(dev, gen, batch: int, heads: int, t: int, causal: bool,
               label: str, dtype: str = "bfloat16") -> dict:
    """B1 at ``[batch * heads, t, 64]`` in ``dtype`` (bf16: the
    tensor-core kernel, f32: the CUDA-core one), held to the type's
    ``FLASH_LIMITS`` on normal scores and on peaky ones (q * 8: the
    running max moves by many units between key tiles, so the rescale
    of O and of the denominator is exercised); then its time, its plain
    version's, SDPA's and its bound (4·BH·pairs·D FLOPs, pairs the
    (q, k) pairs the mask keeps)."""
    import torch
    import torch.nn.functional as F
    from horovod_tpu_torch.ops import flash_attention as fa

    bh, d = batch * heads, 64
    dt = getattr(torch, dtype)
    q3, k3, v3 = (torch.randn((bh, t, d), generator=gen, device=dev).to(dt)
                  for _ in range(3))
    scale = d ** -0.5
    errs = {}
    for name, q in (("normal", q3), ("peaky", (q3.float() * 8).to(dt))):
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
    bnd = bound(4 * bh * t * d * q3.element_size() + bh * t * 4, flops,
                BF16_FLOPS if dt == torch.bfloat16 else F32_FLOPS)
    log(f"kernel flash_fwd ({label}): {flops / ms / 1e9} TFLOP/s, SDPA "
        f"{flops / lib / 1e9} TFLOP/s")
    (err_o, err_lse, err_row), peaky = errs["normal"], errs["peaky"]
    return dict(shape=[bh, t, d], causal=causal, dtype=dtype,
                max_abs_err=err_o, max_abs_err_lse=err_lse,
                max_row_rel_err=err_row,
                peaky_errs=peaky, tflops=flops / ms / 1e9,
                library_tflops=flops / lib / 1e9, ms=ms, plain_ms=plain,
                **bnd, library_ms=lib)


def flash_kernel_row(dev, gen):
    """B1 at GPT-medium (B*H = 8*16, T = 1024, D = 64, causal, bf16), the
    row's main shape, at BERT-Large's (B*H = 32*16, T = Tk = 128,
    D = 64, non-causal, bf16) as its ``bert_large`` shape, and at the
    "sequence-parallel 4 ranks" ring's blocks (B*H = 2*8, T = Tk = 2048,
    D = 64, causal and non-causal) as its ``ring_block`` shapes, and at
    the "serve 1 rank" oracle's ragged forwards (B*H = 1*16, causal:
    T = 17 and 900 bf16, T = 17 and 931 f32, the ends of its four
    prompts' ranges) as its ``serve_oracle`` shapes."""
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
    serve = [flash_case(dev, gen, 1, GPT_MEDIUM["n_head"], t, True,
                        f"serve oracle, {dtype} T={t}", dtype)
             for dtype, t in SERVE_FLASH_SHAPES]
    del row["shape"], row["causal"], row["dtype"]
    return dict(name="flash_fwd", route="cuda",
                source="horovod_tpu_torch/csrc/flash_attention.cu",
                replaces="horovod_tpu/ops/pallas_attention.py:38",
                **row, bert_large=bert, ring_block=ring, rank_rows=rank_rows,
                serve_oracle=serve)


FLASH_BWD_SPLIT_LIMIT = 1.25    # x the plain version's own bf16 error


def flash_bwd_case(dev, gen, bh: int, t: int, causal: bool,
                   label: str) -> dict:
    """The flash backward at ``[bh, t, 64]`` bf16 from the forward
    kernel's O and lse: each of dQ, dK and dV within
    ``FLASH_BWD_SPLIT_LIMIT`` times the plain version's own relative
    Frobenius error against the plain version on f32 upcasts; then its
    time, its plain version's, SDPA's backward's and its bound (five
    products of 2·BH·pairs·D; Q, O, dO, dQ, K, V, dK, dV in bf16 and the
    f32 lse and delta, each moved once)."""
    import torch
    import torch.nn.functional as F
    from horovod_tpu_torch.ops import flash_attention as fa

    d = 64
    scale = d ** -0.5
    q3, k3, v3, do3 = (torch.randn((bh, t, d), generator=gen,
                                   device=dev).bfloat16() for _ in range(4))
    o3, lse = fa.flash_fwd(q3, k3, v3, scale, causal)
    args = (q3, k3, v3, o3, lse, do3)
    got = fa.flash_bwd(*args, scale, causal)
    f32 = [x.float() for x in args]
    ref = fa.flash_bwd_plain(*f32[:4], lse, f32[5], scale=scale,
                             causal=causal)
    plain = fa.flash_bwd_plain(*args, scale=scale, causal=causal)

    def rel(a, r):
        return float((a.double() - r.double()).norm() / r.double().norm())

    ratios = [rel(a, r) / rel(p, r) for a, p, r in zip(got, plain, ref)]
    log(f"kernel flash_bwd ({label}): dQ, dK, dV relative error "
        f"{[rel(a, r) for a, r in zip(got, ref)]}, "
        f"{ratios} x the plain version's bf16 output's")
    if max(ratios) > FLASH_BWD_SPLIT_LIMIT:
        raise AssertionError(f"flash_bwd ({label}) beyond its split "
                             f"contract: {ratios}")
    del ref, f32
    ms = time_ms(lambda: fa.flash_bwd(*args, scale, causal))
    plain_ms = time_ms(lambda: fa.flash_bwd_plain(*args, scale=scale,
                                                  causal=causal))
    q4, k4, v4 = (x.reshape(bh // 16, 16, t, d).detach().requires_grad_()
                  for x in (q3, k3, v3))
    out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
    dout = do3.reshape(out.shape)
    lib = time_ms(lambda: torch.autograd.grad(out, (q4, k4, v4), dout,
                                              retain_graph=True))
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = 10 * bh * pairs * d
    bnd = bound(2 * bh * d * 8 * t + 4 * 2 * bh * t, flops, BF16_FLOPS)
    log(f"kernel flash_bwd ({label}): {flops / ms / 1e9} TFLOP/s, SDPA "
        f"backward {flops / lib / 1e9} TFLOP/s")
    return dict(shape=[bh, t, d], causal=causal,
                max_abs_err=max(float((a.float() - p.float()).abs().max())
                                for a, p in zip(got, plain)),
                split_ratios=ratios, tflops=flops / ms / 1e9,
                library_tflops=flops / lib / 1e9, ms=ms, plain_ms=plain_ms,
                **bnd, library_ms=lib)


def flash_bwd_f32_case(dev, gen, bh: int, t: int, causal: bool) -> dict:
    """The f32 route (the CUDA-core kernels) at ``[bh, t, 64]``: each of
    dQ, dK and dV against float64 attention within B5's f64 rule (twice
    the plain version's largest error plus 1e-6 of the largest |value|);
    then its time, its plain version's and its bound (five products of
    2·BH·pairs·D at the f32 rate; the eight tensors f32, lse and delta,
    once)."""
    import torch
    from horovod_tpu_torch.ops import flash_attention as fa

    d = 64
    scale = d ** -0.5
    q3, k3, v3, do3 = (torch.randn((bh, t, d), generator=gen, device=dev)
                       for _ in range(4))
    o3, lse = fa.flash_fwd(q3, k3, v3, scale, causal)
    args = (q3, k3, v3, o3, lse, do3)
    got = fa.flash_bwd(*args, scale, causal)
    plain = fa.flash_bwd_plain(*args, scale=scale, causal=causal)
    q, k, v, do = (x.double() for x in (q3, k3, v3, do3))
    s = torch.matmul(q, k.transpose(1, 2)) * scale
    if causal:
        s = s.masked_fill(~torch.ones((t, t), dtype=torch.bool,
                                      device=dev).tril(), float("-inf"))
    p = torch.softmax(s, dim=-1)
    ds = p * (torch.matmul(do, v.transpose(1, 2))
              - (do * torch.matmul(p, v)).sum(-1)[..., None]) * scale
    ref = (torch.matmul(ds, k), torch.matmul(ds.transpose(1, 2), q),
           torch.matmul(p.transpose(1, 2), do))
    errs = [(float((a.double() - r).abs().max()),
             float((b.double() - r).abs().max()), float(r.abs().max()))
            for a, b, r in zip(got, plain, ref)]
    log(f"kernel flash_bwd (f32, [{bh}, {t}, {d}], causal {causal}): dQ, "
        f"dK, dV max |kernel - f64|, max |plain - f64|, max |f64| {errs}")
    if not all(e <= 2 * ep + 1e-6 * m for e, ep, m in errs):
        raise AssertionError(f"flash_bwd (f32) outside the f64 rule: {errs}")
    del ref, s, p, ds
    ms = time_ms(lambda: fa.flash_bwd(*args, scale, causal))
    plain_ms = time_ms(lambda: fa.flash_bwd_plain(*args, scale=scale,
                                                  causal=causal))
    pairs = t * (t + 1) // 2 if causal else t * t
    bnd = bound(4 * bh * d * 8 * t + 4 * 2 * bh * t, 10 * bh * pairs * d,
                F32_FLOPS)
    return dict(shape=[bh, t, d], causal=causal,
                max_abs_err=max(e for e, _, _ in errs), ms=ms,
                plain_ms=plain_ms, **bnd)


def flash_bwd_kernel_row(dev, gen):
    """The flash backward at the GPT cell's layer (B*H 16*16, T 1024,
    causal), the row's main shape, at the BERT cell's (B*H 128*16, T 128,
    non-causal) as its ``bert_large`` shape, and the f32 route at the
    "bert-large 1 rank" phase's f32 check (B*H 32*16, T 128) as ``f32``."""
    row = flash_bwd_case(dev, gen, 256, 1024, True, "GPT cell")
    bert = flash_bwd_case(dev, gen, 2048, 128, False, "BERT cell")
    f32 = flash_bwd_f32_case(dev, gen, 512, 128, False)
    del row["causal"]
    return dict(name="flash_bwd", route="cuda",
                source="horovod_tpu_torch/csrc/flash_attention_bwd.cu",
                replaces="none (pallas_attention._flash_bwd is plain jnp)",
                **row, bert_large=bert, f32=f32)


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

    from horovod_tpu_torch.analysis.step_check import record_collectives

    model, batch = gpt_medium(dev, n_layer=WIRE_LAYERS, data_seed=1 + rank)
    step = dp_step(model)
    torch.cuda.reset_peak_memory_stats()
    hvd.ops.reset_launch_counts()
    with record_collectives() as seq:
        losses = [float(step(model, batch)) for _ in range(WIRE_STEPS)]
    counts = hvd.ops.launch_counts()
    return dict(losses=losses, counts=counts, seq=[list(e) for e in seq],
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
    from horovod_tpu_torch.analysis.step_check import record_collectives
    from horovod_tpu_torch.ops import fused_collectives as fc
    from horovod_tpu_torch.ops.fusion import tree_flatten
    from horovod_tpu_torch.ops.quantization import int8_allgather

    n = hvd.size()
    model, batch = gpt_medium(dev, n_layer=WIRE_LAYERS, data_seed=1 + rank)
    step = zero_step(model)
    torch.cuda.reset_peak_memory_stats()
    hvd.ops.reset_launch_counts()
    with record_collectives() as seq:
        losses = [float(step(model, batch)) for _ in range(WIRE_STEPS)]
    zero_seq = [list(e) for e in seq]
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
                apply_err=worst, unshard=errors, seq=zero_seq)


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


def microbatch_ranks(dev, rank: int,
                     n_layer: int = GPT_MEDIUM["n_layer"]) -> dict:
    """Path "microbatch 2 ranks" (at MB_LAYERS layers) and, over NCCL on
    four cards, ``scripts/torch_port_sets_nccl.py --microbatch`` (full
    depth): MB_STEPS steps of :func:`mb_step` on GPT-medium at
    ``n_layer`` layers, each rank on its own batch of BATCH rows, the
    launch counts set to 0 just before and read just after; step 1's
    per-microbatch gradients are captured at the overlap wire's entry.
    Then (a) step 1's reduced gradients against
    :func:`plain_overlap_grads`; (b) one step with ``two_phase=True``
    and one microbatch from the starting weights, its reduced gradients
    against the single-phase int8 allreduce of the same gradients; and
    the step time with ``overlap=False``."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.analysis.step_check import record_collectives
    from horovod_tpu_torch.ops import fusion
    from horovod_tpu_torch.ops.fusion import tree_flatten

    model, batch = gpt_medium(dev, n_layer, data_seed=1 + rank)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = mb_step(model)
    captured, plans = [], []
    wire = fusion.overlap_reduce_scatter

    def capture(leaves, plan, **kwargs):
        if len(captured) < MICROBATCHES:
            captured.append([g.detach().cpu() for g in leaves])
            plans.append(plan)
        return wire(leaves, plan, **kwargs)

    losses, digests, times, seqs = [], [], [], []
    fusion.overlap_reduce_scatter = capture
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        hvd.ops.reset_launch_counts()
        t0 = time.perf_counter()
        for i in range(MB_STEPS):
            t = time.perf_counter()
            with record_collectives() as seq:
                losses.append(float(step(model, batch)))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            seqs.append([list(e) for e in seq])
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
                tp_loss=tp_loss, seqs=seqs, n_layer=n_layer)


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
    for i in range(MB_STEPS):
        recorded_sequences(label, [out["seqs"][i] for out in res],
                           f"step {i + 1}", microbatches=MICROBATCHES,
                           buckets=r0["buckets"], compression="int8")
    log(f"{label}: GPT-medium, {r0['n_layer']} layers, "
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
    metrics, the stage spans under each step's ``hvd_tpu_wire`` span, the
    root's child (by stage name, a step) and the estimator's β gauge read
    after the first step."""
    from horovod_tpu_torch.obs import metrics

    snap = metrics.registry().snapshot()

    def by(name, label):
        return {row["labels"][label]: row["value"]
                for row in snap.get(name, [])}

    roots = [sp for sp in spans if sp["name"] == "hvd_tpu_step"
             and sp["parent_id"] is None]
    stages = []
    for root in roots:
        wires = {sp["span_id"] for sp in spans if sp["name"] == "hvd_tpu_wire"
                 and sp["parent_id"] == root["span_id"]}
        kids = [sp["name"] for sp in spans if sp["parent_id"] in wires]
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
        f"wire span holds {o0['stages'][0]} stage spans ({len(s0['algos'])} "
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
# The main run's depth: cut from 24, widths kept (the script's
# time beside the analysis tier's paths).
SP_LAYERS = 6
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
    SP_LAYERS-layer model on SP_LAYOUT, ring attention on the flash engine,
    AdamW; the launch counts set to 0 just before and read just after.
    Step 1's parameters, gathered, go back on rank 0 (on the host)."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import (gather_params, init_opt_state,
                                            make_spmd_train_step,
                                            param_shardings, shard_batch)
    from horovod_tpu_torch.plan import P

    model, mesh = sp_model(dev, SP_LAYOUT, SP_LAYERS)
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

    cfg = hvd.models.GPTConfig(**{**GPT_MEDIUM, "max_seq_len": SP_SEQ,
                                  "n_layer": SP_LAYERS})
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
    log(f"{label}: GPT-medium widths, {SP_LAYERS} layers, "
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
PIPE_LAYERS = 8     # cut from 24, widths kept (the script's time)
MOE_LAYOUT = {"dp": 2, "ep": 2}
MOE = dict(moe_experts=8, moe_top_k=2, moe_capacity_factor=1.25,
           moe_every=2)                    # GPTConfig's MoE defaults
MOE_BATCH, MOE_STEPS = 4, 3
# Cut from 24, widths kept: the script's time beside the
# analysis tier's paths ("hvdlint (host)", "sanitize serve 1 rank").
MOE_LAYERS = 6
# The sequence-parallel MoE step: routing over the global token order
# under sp, ring attention on the flash engine.
MOE_SP_LAYOUT, MOE_SP_LAYERS = {"sp": 2, "ep": 2}, 2
FSDP_ENV = {"HVD_TPU_MESH_PLAN": "fsdp=4"}
FSDP_STEPS, FSDP_SHORT_LAYERS = 3, 2
# Cut from 24, widths kept (the script's time); 8, not 6, so that the
# blocks outweigh the root (embeddings, lm_head) and the gathered peak
# (the root and one block) falls below half the whole model.
FSDP_LAYERS = 8
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
    """Path "pipeline 4 ranks": GPT-medium's widths at PIPE_LAYERS layers
    as four stages, PIPE_MICRO microbatches of BATCH / PIPE_MICRO rows, the
    whole batch on every rank (dp 1), PIPE_STEPS AdamW steps of
    ``make_spmd_train_step``; step 1's parameters gathered to rank 0;
    then the remat check; then rank 0 alone runs the one-rank oracle."""
    import torch
    import horovod_tpu_torch as hvd

    t0 = time.perf_counter()
    model = pipe_model(dev, PIPE_LAYERS)
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
        cfg = hvd.models.GPTConfig(**{**GPT_MEDIUM, "n_layer": PIPE_LAYERS})
        run["oracle"] = one_rank_oracle(dev, cfg, batch, first,
                                        run["losses"][0])
    return run


def moe_ranks(dev, rank: int) -> dict:
    """Path "moe 4 ranks": GPT-medium's widths, MOE_LAYERS layers, every
    second FFN a mixture of 8 experts (top-2, capacity factor 1.25) on
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
    cfg = hvd.models.GPTConfig(**{**GPT_MEDIUM, **MOE,
                                  "n_layer": MOE_LAYERS})
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
    run["sp"], sp_first = moe_sp_step(dev, rank, whole)
    torch.cuda.empty_cache()
    hvd.barrier()
    if rank == 0:
        run["oracle"] = one_rank_oracle(dev, cfg, whole, first,
                                        run["losses"][0])
        del first
        torch.cuda.empty_cache()
        run["sp"]["oracle"] = one_rank_oracle(
            dev, hvd.models.GPTConfig(**{**GPT_MEDIUM, **MOE,
                                         "n_layer": MOE_SP_LAYERS}),
            whole, sp_first, run["sp"]["losses"][0])
    return run


def moe_sp_step(dev, rank: int, whole) -> tuple:
    """The MoE GPT at MOE_SP_LAYERS layers on MOE_SP_LAYOUT (each rank a
    ``[MOE_BATCH, SEQ / 2]`` block of ``whole``, the experts over ep),
    ring attention on the flash engine: one AdamW step of
    ``make_spmd_train_step`` (launch counts from 0), the aux loss after
    it, and its parameters gathered (rank 0's on the host, ``{}``
    elsewhere)."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import (gather_params, init_opt_state,
                                            make_mesh, make_spmd_train_step,
                                            moe_aux_loss, param_shardings,
                                            shard_batch, shard_params)
    from horovod_tpu_torch.plan import P

    cfg = hvd.models.GPTConfig(**{**GPT_MEDIUM, **MOE,
                                  "n_layer": MOE_SP_LAYERS,
                                  "attention": "ring",
                                  "attention_engine": "flash"})
    mesh = make_mesh(MOE_SP_LAYOUT)
    model = shard_params(hvd.models.GPT(cfg, mesh=mesh, device=dev, seed=0),
                         mesh)
    opt = init_opt_state(lambda ps: torch.optim.AdamW(ps, **ADAMW), model)
    step = make_spmd_train_step(hvd.models.lm_loss_fn(model), opt)
    replicated = [n for n, s in param_shardings(model, mesh).items()
                  if not any(s)]
    run = parallel_steps(step, model, shard_batch(whole, mesh, P("dp", "sp")),
                         1, lambda m: [p for n, p in m.named_parameters()
                                       if n in replicated])
    run["aux"] = float(moe_aux_loss(model, weight=1.0))
    first = gather_params(model, mesh, to="cpu")
    del model, opt, step
    return run, (first if rank == 0 else {})


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


def fsdp_bytes(step, model, opt) -> dict:
    """The units' whole bytes (the root's, the largest block's, every
    parameter's) and the rank's resting bytes (its slices and the
    optimizer state)."""
    size = {n: p.numel() * p.element_size()
            * (1 if step.split[n] is None else step.n)
            for n, p in model.named_parameters()}
    root, blocks = step.units(model)
    resting = sum(p.numel() * p.element_size() for p in model.parameters())
    resting += sum(v.numel() * v.element_size() for st in opt.state.values()
                   for v in st.values() if hasattr(v, "numel"))
    return dict(root_bytes=sum(size[n] for n in root),
                block_bytes=max(sum(size[n] for n in names)
                                for _, names in blocks),
                whole_bytes=sum(size.values()), resting=resting)


def fsdp_ranks(dev, rank: int) -> dict:
    """Path "fsdp 4 ranks" under ``HVD_TPU_MESH_PLAN=fsdp=4``: GPT-medium
    (FSDP_LAYERS layers) through ``make_fsdp_train_step`` (every parameter cut on
    its largest divisible dim over the four ranks, AdamW on the slices; a
    block's parameters gathered for its forward and again for its
    backward), BATCH / 4 rows a rank, FSDP_STEPS steps, step 1's
    collectives recorded, each step's ``peak_gathered_bytes``; step 1's
    parameters gathered to the host; the HSDP check at FSDP_SHORT_LAYERS
    layers; then rank 0 alone runs the one-rank data-parallel step on the
    whole batch."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.analysis.step_check import record_collectives

    t0 = time.perf_counter()
    model, opt, step = fsdp_model_step(dev, FSDP_LAYERS)
    first, gathered, seq = None, [], []

    def slices_then_gather(m):
        nonlocal first
        if first is None:
            whole = step.gather(m)
            first = {n: t.cpu() for n, t in whole.items()} if rank == 0 \
                else {}
            del whole
        return [p for _, p in sorted(m.named_parameters())]

    def one_step(m, b):
        if gathered:
            loss = step(m, opt, b)
        else:
            with record_collectives() as calls:
                loss = step(m, opt, b)
            seq.extend(list(e) for e in calls)
        gathered.append(step.peak_gathered_bytes)
        return loss

    run = parallel_steps(one_step, model, fsdp_rows(dev, rank, SET_RANKS),
                         FSDP_STEPS, slices_then_gather)
    run.update(seconds=time.perf_counter() - t0,
               params=sum(p.numel() for p in model.parameters()),
               gathered=gathered, seq=seq, **fsdp_bytes(step, model, opt))
    del model, opt, step
    torch.cuda.empty_cache()
    run["short"] = fsdp_short(dev, rank)
    torch.cuda.empty_cache()
    hvd.barrier()
    if rank == 0:
        cfg = hvd.models.GPTConfig(**{**GPT_MEDIUM, "n_layer": FSDP_LAYERS})
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
    blocks = PIPE_LAYERS // PIPE_LAYOUT["pp"]
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
    log(f"{label}: GPT-medium, {PIPE_LAYERS} layers as "
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
        if out["counts"]["flash_fwd"] != MOE_STEPS * MOE_LAYERS:
            raise AssertionError(f"{label}: rank {r} launched flash_fwd "
                                 f"{out['counts']['flash_fwd']} times")
    if not oracle_ok(r0["oracle"]):
        raise AssertionError(f"{label}: step 1 off the one-rank step: "
                             f"{r0['oracle']}")
    sp0 = r0["sp"]
    for r, out in enumerate(res):
        sp = out["sp"]
        if not (math.isfinite(sp["losses"][0])
                and sp["losses"] == sp0["losses"]
                and sp["digests"] == sp0["digests"]
                and sp["aux"] == sp0["aux"]):
            raise AssertionError(f"{label}: the sp step's loss, aux loss or "
                                 f"replicated leaves differ on rank {r}: "
                                 f"{sp['losses']} {sp['aux']}")
        if sp["counts"]["flash_fwd"] <= 0:
            raise AssertionError(f"{label}: flash_fwd never launched on the "
                                 f"sp step (rank {r})")
    if not oracle_ok(sp0["oracle"]):
        raise AssertionError(f"{label}: the sp step off the one-rank step: "
                             f"{sp0['oracle']}")
    layout = ",".join(f"{k}={v}" for k, v in MOE_LAYOUT.items())
    log(f"{label}: GPT-medium widths, {MOE_LAYERS} layers, "
        f"{MOE_LAYERS // MOE['moe_every']} MoE blocks of "
        f"{MOE['moe_experts']} experts (top-{MOE['moe_top_k']}, capacity "
        f"factor {MOE['moe_capacity_factor']}), {layout}, {MOE_BATCH} x "
        f"{SEQ} tokens, {[o['params'] for o in res]} parameters a rank, "
        f"AdamW on lm_loss_fn, losses {r0['losses']} (every rank), aux loss "
        f"after {r0['aux']}; replicated leaves bitwise equal on the four "
        f"ranks, experts on each dp pair, after every step")
    log(oracle_line(label, r0["oracle"]))
    sp_layout = ",".join(f"{k}={v}" for k, v in MOE_SP_LAYOUT.items())
    log(f"{label}: {MOE_SP_LAYERS} layers on {sp_layout}, ring attention on "
        f"the flash engine, {MOE_BATCH} x {SEQ // MOE_SP_LAYOUT['sp']} "
        f"tokens a rank, routed over the global token order: loss "
        f"{sp0['losses']}, aux loss {sp0['aux']} (every rank), replicated "
        f"leaves bitwise equal; step seconds "
        f"{[o['sp']['times'] for o in res]}; flash_fwd launches per rank "
        f"{[o['sp']['counts']['flash_fwd'] for o in res]}")
    log(oracle_line(f"{label} (sp)", sp0["oracle"]))
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
        if out["counts"]["flash_fwd"] != FSDP_STEPS * FSDP_LAYERS:
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
        bound = out["root_bytes"] + 2 * out["block_bytes"]
        if not all(p <= bound and 2 * p < out["whole_bytes"]
                   for p in out["gathered"]):
            raise AssertionError(
                f"{label}: rank {r}'s gathered peaks {out['gathered']} over "
                f"the root and two blocks ({bound}) or not below half the "
                f"model ({out['whole_bytes']})")
    if not oracle_ok(r0["oracle"]):
        raise AssertionError(f"{label}: step 1 off the one-rank step: "
                             f"{r0['oracle']}")
    recorded_sequences(label, [o["seq"] for o in res], "step 1")
    log(f"{label}: GPT-medium, {FSDP_LAYERS} layers, "
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
    log(f"{label}: peak_gathered_bytes per rank and step "
        f"{[o['gathered'] for o in res]} (limit: the root "
        f"{r0['root_bytes']} + twice the largest block's {r0['block_bytes']} "
        f"= {r0['root_bytes'] + 2 * r0['block_bytes']}, and below half of "
        f"the whole model's {r0['whole_bytes']}); peak memory a rank "
        f"{r0['peak']} bytes beside its resting "
        f"{[o['resting'] for o in res]} (slices and AdamW state) and the "
        f"whole model's {r0['whole_bytes']}")
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
    and hand every rank's results to ``check``; returns what it returns
    (rank 0's launch counts)."""
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
    before = hvd.ops.launch_counts()["flash_bwd"]
    runs = dense_and_chunked(
        model, lambda chunk: hvd.models.masked_lm_loss_fn(
            model, vocab_chunk_size=chunk), (ids, targets, mask),
        lambda: model.bert.tok_embed.embedding)
    bwd = hvd.ops.launch_counts()["flash_bwd"] - before
    if bwd != 2 * cfg.n_layer:
        raise AssertionError(f"bert-large mlm: flash_bwd launched {bwd} "
                             f"times in two backwards of {cfg.n_layer} "
                             "layers")
    dense, chunked, err = heads_agree("masked LM head", runs)
    log(f"bert-large mlm: f32, batch {BERT_BATCH} x {BERT_SEQ}, loss dense "
        f"{dense} chunked {chunked} (chunk {VOCAB_CHUNK}), the f32 flash "
        f"backward {bwd} launches, tied embedding "
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
# "durable 1 rank"'s depth, cut from 24 to keep the whole script inside
# its time limit beside the serving fleet's phases; the widths are kept.
DURABLE_LAYERS = 4
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


def durable_model(dev, seed: int, n_layer: int = DURABLE_LAYERS):
    """(model, optimizer, step): GPT-medium's widths from ``seed`` and
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
    """Path "durable 1 rank": GPT-medium at full width, DURABLE_LAYERS
    layers deep, with :func:`dp_step`'s AdamW on the int8+EF wire.

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
# "launcher 2 ranks" and "remote 2 hosts" (held to each other bit for
# bit): cut from 24 layers, widths kept, for the script's time.
LAUNCH_LAYERS = 6
STALL_WINDOW_S = 15.0      # well above a step here (2 ranks, gloo, one card)
LAUNCHER_TIMEOUT_S = 900.0
PLANNER_CALLS = 200        # timed calls of each planner on the step's leaves
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


def planner_checks(plans: list, n_leaves: int) -> dict:
    """The fusion plans the native planner gave the step, each against
    ``plan_buckets_py`` on the same sizes; its two-phase and two-tier
    choices on the same bytes against their Python twins; both planners'
    host time on the step's ``n_leaves`` gradient leaves."""
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.native import planner as nplanner
    from horovod_tpu_torch.ops import fusion
    from horovod_tpu_torch.topo.costmodel import default_params
    from horovod_tpu_torch.topo.schedule import choose_algo
    from horovod_tpu_torch.topo.topology import MeshTopology

    leaves = [p for p in plans if len(p[0]) == n_leaves]
    if not leaves:
        raise AssertionError(
            f"launcher 2 ranks: the native planner never planned the "
            f"{n_leaves} gradient leaves (plans of "
            f"{[len(p[0]) for p in plans]} leaves)")
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
        leaves=n_leaves, buckets=len(plan), threshold=threshold,
        two_phase=sum(flags),
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
    GPT-medium at LAUNCH_LAYERS layers from seed 0, a batch from seed 0 +
    rank,
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
    model, batch = gpt_medium(dev, n_layer=LAUNCH_LAYERS, data_seed=rank)
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
                params=param_digest(model), tiers=fusion_tiers(),
                leaves=sum(p.requires_grad for p in model.parameters()))


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
    planner = planner_checks(plans, steps["leaves"])
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
    log(f"{label}: GPT-medium {LAUNCH_LAYERS} layers through python -m "
        f"horovod_tpu_torch.runner -np 2, losses {r0['losses']}, replicas "
        f"bitwise equal, step seconds {r0['times']} (median "
        f"{statistics.median(r0['times']):.3f}), peak memory per rank "
        f"{r0['peak'] / 2**30:.2f} / {res[1]['peak'] / 2**30:.2f} GiB, "
        f"phase {seconds:.1f} s ({wire}) on {card}")
    log(f"{label}: native planner {p['buckets']} buckets of the "
        f"{p['leaves']} leaves "
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
        f"GPT-medium {LAUNCH_LAYERS} layers, losses {r0['losses']} and "
        f"parameters "
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


# --- "spark run 2 tasks" and "ray executor 2 actors" ----------------------------

SPARK_TASKS, SPARK_STEPS = 2, 2
RAY_ACTORS = 2


def stand_ins():
    """The stand-ins for pyspark's barrier stage and Ray's actors
    (``tests/torch_port_{spark,ray}_shim.py``: local processes, the
    standard library only): the card's host has neither package."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_port_ray_shim
    import torch_port_spark_shim

    return torch_port_spark_shim, torch_port_ray_shim


def spark_train_fn() -> dict:
    """One task of "spark run 2 tasks", the function ``spark.run`` ships
    (by reference, as ``chip_smoke.spark_train_fn``) into a session that
    the task's ``init(device="cuda:0", backend="gloo")`` made: GPT-medium
    at 24 layers from seed 0, broadcast through the torch binding, this
    rank's 8 x 1024 tokens from seed ``rank``, SPARK_STEPS AdamW steps
    through the hook-driven ``DistributedOptimizer`` on
    ``Compression.none`` (as "torch binding 2 ranks"' (a)), each step's
    loss averaged; the launch counts set to 0 just before the steps and
    read just after."""
    import torch
    import horovod_tpu_torch as core
    import horovod_tpu_torch.torch as hvd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, rank = core.device(), core.rank()
    model, batch = binding_model(dev, rank)
    loss_fn = core.models.lm_loss_fn(model)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), **ADAMW),
        named_parameters=model.named_parameters(),
        compression=hvd.Compression.none)
    torch.cuda.synchronize()
    core.ops.reset_launch_counts()
    losses = []
    t0 = time.perf_counter()
    for _ in range(SPARK_STEPS):
        opt.zero_grad()
        loss = loss_fn(model, batch)
        loss.backward()
        opt.step()
        losses.append(float(hvd.allreduce(loss.detach(), name="loss")))
    torch.cuda.synchronize()
    return dict(rank=rank, size=core.size(), device=str(dev),
                card=torch.cuda.get_device_name(dev), losses=losses,
                counts=core.ops.launch_counts(), pid=os.getpid(),
                seconds=time.perf_counter() - t0,
                env={k: os.environ.get(k) for k in CONTRACT_VARS})


def spark_phase(card: str, want: list, device: str = "cuda:0") -> dict:
    """"spark run 2 tasks": ``horovod_tpu_torch.spark.run(
    chip_smoke.spark_train_fn, num_proc=2, device="cuda:0",
    backend="gloo")`` over the pyspark stand-in.  Gates: results in rank
    order, both tasks on cuda:0 of this card with torchrun's variables,
    both losses bit for bit "torch binding 2 ranks" (a)'s first
    SPARK_STEPS (``want``), B1 launched 24 x SPARK_STEPS times a task, no
    process left."""
    import torch
    from horovod_tpu_torch import spark

    import chip_smoke   # by name, not __main__: the tasks import it

    spark_shim, _ = stand_ins()
    torch.cuda.empty_cache()
    spark_shim.install()
    t0 = time.perf_counter()
    try:
        res = spark.run(chip_smoke.spark_train_fn, num_proc=SPARK_TASKS,
                        device=device, backend="gloo")
    finally:
        spark_shim.uninstall()
    seconds = time.perf_counter() - t0
    name = torch.cuda.get_device_name(0)
    flash = GPT_MEDIUM["n_layer"] * SPARK_STEPS
    if [r["rank"] for r in res] != list(range(SPARK_TASKS)):
        raise AssertionError(f"spark run 2 tasks: results in rank order "
                             f"{[r['rank'] for r in res]}")
    for r in res:
        if (r["device"], r["card"], r["size"]) != (device, name,
                                                   SPARK_TASKS) \
                or r["env"]["RANK"] != str(r["rank"]) \
                or r["env"]["WORLD_SIZE"] != str(SPARK_TASKS):
            raise AssertionError(f"spark run 2 tasks: task {r['rank']} on "
                                 f"{r['device']} of {r['card']}, env "
                                 f"{r['env']}")
        if r["losses"] != list(want[:SPARK_STEPS]):
            raise AssertionError(
                f"spark run 2 tasks: task {r['rank']}'s losses "
                f"{r['losses']} are not torch binding 2 ranks' "
                f"{want[:SPARK_STEPS]} bit for bit")
        if r["counts"]["flash_fwd"] != flash:
            raise AssertionError(
                f"flash_fwd launched {r['counts']['flash_fwd']} times on "
                f"the spark run 2 tasks path (task {r['rank']}), not "
                f"{flash}")
    if child_processes():
        raise AssertionError(f"spark run 2 tasks: processes left running: "
                             f"{child_processes()}")
    log(f"spark run 2 tasks: spark.run(chip_smoke.spark_train_fn, "
        f"num_proc={SPARK_TASKS}, device={device!r}, backend='gloo') over "
        f"the pyspark stand-in (local task processes, no cluster): "
        f"GPT-medium {GPT_MEDIUM['n_layer']} layers, {BATCH} x {SEQ} tokens "
        f"a task, losses "
        f"{res[0]['losses']} / {res[1]['losses']}, bit for bit torch "
        f"binding 2 ranks' (a); tasks {[r['pid'] for r in res]} on "
        f"{name}, env {res[1]['env']}; steps {res[0]['seconds']:.1f} s; "
        f"launches {res[0]['counts']}; phase {seconds:.1f} s on {card}")
    return res[0]["counts"]


def ray_body() -> tuple:
    """One rank of "ray executor 2 actors", the function the executor runs
    (by reference) in the session its ``setup`` made: the int8 allreduce
    of a RUN_FUNC_SHAPE f32 tensor from seed ``rank`` (the stack tier:
    B2, then B3), the launch counts around it; returns ``(rank, digest,
    device, card name, counts, pid)``."""
    import torch
    import horovod_tpu_torch as hvd

    rank, dev = hvd.rank(), str(hvd.device())
    x = run_func_input(rank, dev)
    torch.cuda.synchronize()
    hvd.ops.reset_launch_counts()
    out = hvd.allreduce(x, compression=hvd.Compression.int8, name="ray")
    torch.cuda.synchronize()
    counts = hvd.ops.launch_counts()
    return (rank, digest([out]), dev, torch.cuda.get_device_name(0), counts,
            os.getpid())


def ray_rank() -> tuple:
    """``(rank, size, pid)`` of the actor it runs in."""
    import horovod_tpu_torch as hvd

    return hvd.rank(), hvd.size(), os.getpid()


def ray_phase(card: str, device: str = "cuda:0") -> dict:
    """"ray executor 2 actors": ``RayExecutor(num_workers=2, use_gpu=True,
    device="cuda:0", backend="gloo")`` over the Ray stand-in: ``start()``,
    ``run(chip_smoke.ray_body)``, ``execute_single(chip_smoke.ray_rank,
    rank=0)``, ``shutdown()``.  Gates: results in rank order, the digest
    bit for bit the plain B2 -> B3 over the same seeds on both ranks, B2
    and B3 launched, no actor process left."""
    import torch
    from horovod_tpu_torch.ray import RayExecutor

    import chip_smoke   # by name: the actors import it

    _, ray_shim = stand_ins()
    want = digest([plain_stack_allreduce(
        [run_func_input(r, device) for r in range(RAY_ACTORS)], "average")])
    torch.cuda.empty_cache()
    ray_shim.install()
    t0 = time.perf_counter()
    try:
        ex = RayExecutor(num_workers=RAY_ACTORS, use_gpu=True, device=device,
                         backend="gloo")
        ex.start()
        try:
            res = ex.run(chip_smoke.ray_body)
            single = ex.execute_single(chip_smoke.ray_rank, rank=0)
        finally:
            ex.shutdown()
    finally:
        ray_shim.uninstall()
    seconds = time.perf_counter() - t0
    name = torch.cuda.get_device_name(0)
    ranks = [r[0] for r in res]
    if ranks != list(range(RAY_ACTORS)) or {r[1] for r in res} != {want} \
            or {(r[2], r[3]) for r in res} != {(device, name)}:
        raise AssertionError(
            f"ray executor 2 actors: ranks {ranks}, digests "
            f"{[r[1] for r in res]} against the plain {want}, devices "
            f"{[(r[2], r[3]) for r in res]}")
    if single != (0, RAY_ACTORS, res[0][5]):
        raise AssertionError(f"ray executor 2 actors: execute_single(rank=0)"
                             f" gave {single}, rank 0's actor is "
                             f"{res[0][5]}")
    for rank, *_, counts, _pid in res:
        for kernel in ("quantize_blocks", "dequantize_accumulate"):
            if counts[kernel] <= 0:
                raise AssertionError(f"{kernel} never launched on the ray "
                                     f"executor 2 actors path (rank {rank})")
    if ray_shim.live_actors() or child_processes():
        raise AssertionError(f"ray executor 2 actors: actors left running: "
                             f"{ray_shim.live_actors()} "
                             f"{child_processes()}")
    log(f"ray executor 2 actors: RayExecutor(num_workers={RAY_ACTORS}, "
        f"use_gpu=True, device={device!r}, backend='gloo') over the Ray "
        f"stand-in (local actor processes, no cluster): start, run, "
        f"execute_single, shutdown in {seconds:.1f} s; results in rank "
        f"order, the int8 allreduce of {list(RUN_FUNC_SHAPE)} f32 bitwise "
        f"its plain form ({want[:16]}) on both actors, on {card}; "
        f"launches {res[0][4]}")
    return res[0][4]


# --- "serve 1 rank" and "serve 2 replicas" -------------------------------------

# The engine at the reference's defaults (config.py: HVD_TPU_SERVE_*):
# 8 slots, buckets (64, 256, 1024), a paged cache of 16-token blocks,
# speculative drafts of 4.
SERVE_ENGINE = dict(max_slots=8, prefill_buckets=(64, 256, 1024),
                    kv_cache="paged", kv_block=16)
SERVE_SPEC_K = 4
SERVE_ORACLE_LENS = (17, 200, 480, 900)
# B1's rows at the oracle's forwards (T from 17 to 931, B*H 16): the ends
# of that range in each input type, held to the type's FLASH_LIMITS.
SERVE_FLASH_SHAPES = (("bfloat16", 17), ("bfloat16", 900),
                      ("float32", 17), ("float32", 931))
SERVE_NEW_TOKENS = 32
SERVE_REQUESTS, SERVE_CLIENTS = 24, 8      # the closed loop's
SERVE_SYSTEM, SERVE_SHARED, SERVE_SPEC = 512, 8, 4
SERVE_HEADER = (101, 102, 103, 104)        # a turn header after the system
SERVE_TEMPERATURE, SERVE_TOP_K = 0.8, 50
SERVE_REPLICA_REQUESTS = 8
SERVE_KILL_STEP = 3                        # the decode event A dies at
# The oracle's top-1/top-2 logit gap under which a cache path may pick
# the other token: rounding differs between the full forward (flash
# attention, T = n) and the cache paths (plain attention, T = 1 decode,
# T = k + 1 verify).  Tokens are compared wherever the gap is at least
# this, in logit units (the logits' scale is ~1 at these random
# weights).  Fixed before the first chip run; never loosened.
SERVE_MARGIN = {"float32": 1e-3, "bfloat16": 0.25}
# The teacher-forced gate: the engine fed the oracle's tokens, every
# logits row compared (no walk cut short by a near tie).  Half the token
# margin: within it, no position whose oracle margin reaches SERVE_MARGIN
# can change its argmax.  Fixed before its first chip run; never
# loosened.  Each control fault (SERVE_CONTROLS) must exceed it.
SERVE_LOGIT_LIMIT = {k: v / 2 for k, v in SERVE_MARGIN.items()}


def serve_model(dev, dtype, n_layer: int = GPT_MEDIUM["n_layer"]):
    """GPT-medium (``benchmarks/gpt_bench.py``'s widths, 24 layers unless
    ``n_layer`` cuts the depth, flash attention) from seed 0 with
    activations in ``dtype``."""
    import torch
    import horovod_tpu_torch as hvd

    cfg = hvd.models.GPTConfig(**dict(GPT_MEDIUM, n_layer=n_layer),
                               dtype=dtype)
    model = hvd.models.GPT(cfg, device=dev, seed=0)
    model.requires_grad_(False)
    return model


def serve_oracle(model, prompts, n: int):
    """The full-forward argmax loop (B1 in every forward): per prompt
    ``(tokens, margins, logits [n, V] f32)``, the margin being the top-1
    minus top-2 logit at each step."""
    import torch

    dev = next(model.parameters()).device
    out = []
    with torch.inference_mode():
        for prompt in prompts:
            seq, toks, margins, rows = list(prompt), [], [], []
            for _ in range(n):
                logits = model(torch.tensor([seq], device=dev))[0, -1].float()
                top2 = logits.topk(2).values
                toks.append(int(logits.argmax()))
                margins.append(float(top2[0] - top2[1]))
                rows.append(logits)
                seq.append(toks[-1])
            out.append((toks, margins, torch.stack(rows)))
    return out


def margin_match(got, want, margins, limit: float):
    """Walk the two token lists: equal tokens are compared (counted
    where the oracle's margin holds); the first difference is allowed
    only where the margin is under ``limit`` (a near tie), and ends the
    walk, since every later token follows another prefix.  Returns
    ``(ok, positions compared, where the walk stopped or None)``."""
    compared = 0
    for j, (g, w, m) in enumerate(zip(got, want, margins)):
        if g != w:
            return m < limit, compared, j
        compared += m >= limit
    return len(got) == len(want), compared, None


class LogitTap:
    """Records the engine's ``lm_head`` outputs: a prefill's row of its
    last prompt token, a decode's row of every slot."""

    def __init__(self, model):
        self.calls = []
        self.handle = model.lm_head.register_forward_hook(
            lambda mod, inp, out: self.calls.append(out.detach().float()))

    def rows(self, prompts, n: int):
        """Per prompt ``[n, V]``: slot s's prefill (call s), then decode
        call j's row s (the slots started one after another, then
        stepped together)."""
        import torch

        k = len(prompts)
        per = []
        for s, prompt in enumerate(prompts):
            first = self.calls[s][0, len(prompt) - 1]
            dec = [self.calls[k + j][s, 0] for j in range(n - 1)]
            per.append(torch.stack([first] + dec))
        return per

    def close(self):
        self.handle.remove()


def engine_tokens(engine, prompts, n: int, spec: bool = False):
    """Start every prompt in its own slot, then step all together until
    each has ``n`` tokens (a speculative burst may overshoot: cut)."""
    from horovod_tpu_torch.serve import SamplingParams

    toks = {s: [engine.start(s, p, SamplingParams(max_new_tokens=n,
                                                  spec=spec))]
            for s, p in enumerate(prompts)}
    while any(len(t) < n for t in toks.values()):
        for s, got in engine.step().items():
            toks[s].extend(got)
    for s in toks:
        engine.release(s)
    return [toks[s][:n] for s in range(len(prompts))]


def forced_rows(engine, model, prompts, forced, n: int):
    """The engine teacher-forced along ``forced`` (per prompt, the
    oracle's ``n`` tokens): before every decode step each slot's next
    input is set to the oracle's token, so every position sees the
    oracle's context.  Returns per prompt the ``[n, V]`` ``lm_head``
    rows and the engine's own greedy tokens."""
    from horovod_tpu_torch.serve import SamplingParams

    tap = LogitTap(model)
    try:
        toks = {s: [engine.start(s, p, SamplingParams(max_new_tokens=n))]
                for s, p in enumerate(prompts)}
        for j in range(n - 1):
            with engine._slot_lock:      # the decode's input tokens
                for s in toks:
                    engine._last_tokens[s] = forced[s][j]
            for s, got in engine.step().items():
                toks[s].extend(got)
        for s in toks:
            engine.release(s)
    finally:
        tap.close()
    return tap.rows(prompts, n), [toks[s] for s in range(len(prompts))]


def forced_check(engine, model, prompts, oracle, name: str):
    """:func:`forced_rows` against the oracle: ``(largest |Δlogit| over
    every row, positions whose tokens were compared, the first position
    where the tokens differ past the margin or None)``."""
    n = SERVE_NEW_TOKENS
    rows, toks = forced_rows(engine, model, prompts,
                             [o[0] for o in oracle], n)
    dlogit, compared, bad = 0.0, 0, None
    for i, (want, margins, ref) in enumerate(oracle):
        dlogit = max(dlogit, float((rows[i] - ref).abs().max()))
        for j in range(n):
            if margins[j] >= SERVE_MARGIN[name]:
                compared += 1
                if toks[i][j] != want[j] and bad is None:
                    bad = (i, j)
    return dlogit, compared, bad


def _fp8_kv(attend):
    """Control fault: the K/V written to the cache rounded to fp8."""
    import torch

    def fault(q, k, v, cache, positions):
        k, v = (y.to(torch.float8_e4m3fn).to(y.dtype) for y in (k, v))
        return attend(q, k, v, cache, positions)
    return fault


def _shifted_positions(attend):
    """Control fault: the cache write and the mask one position early."""
    def fault(q, k, v, cache, positions):
        return attend(q, k, v, cache, (positions - 1).clamp(min=0))
    return fault


# Faults the teacher-forced gate must see on the bf16 paged engine: a
# cache of a coarser type, and an off-by-one scatter and mask.
SERVE_CONTROLS = {"fp8 K/V": _fp8_kv, "positions - 1": _shifted_positions}


def forced_controls(model, prompts, oracle, name: str) -> dict:
    """Each of SERVE_CONTROLS patched into the cache paths'
    ``cached_attention``: the teacher-forced |Δlogit| must exceed
    SERVE_LOGIT_LIMIT, or the gate could not see such a fault."""
    import torch
    from horovod_tpu_torch.models import transformer
    from horovod_tpu_torch.serve import InferenceEngine

    limit = SERVE_LOGIT_LIMIT[name]
    attend, out = transformer.cached_attention, {}
    for label, make in SERVE_CONTROLS.items():
        transformer.cached_attention = make(attend)
        try:
            engine = InferenceEngine(model, **SERVE_ENGINE)
            dlogit, _, _ = forced_check(engine, model, prompts, oracle,
                                        name)
        finally:
            transformer.cached_attention = attend
        del engine
        gc.collect()
        out[label] = dlogit
        log(f"serve 1 rank: (a) control {label}, {name} paged, teacher-"
            f"forced: largest |dlogit| {dlogit} (limit {limit}: must fail)")
        if not dlogit > limit:
            raise AssertionError(
                f"serve 1 rank: the teacher-forced gate misses the control "
                f"fault {label}: |dlogit| {dlogit} <= {limit}")
    torch.cuda.empty_cache()
    return out


def serve_prompts(seed: int, lengths, vocab: int):
    import numpy as np

    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(0, vocab, n)] for n in lengths]


def oracle_phase(dev, models: dict) -> dict:
    """(a): the f32 and the bf16 model through the dense engine, the
    paged engine and the paged engine with the self-drafter, against the
    full-forward oracle, under :func:`margin_match`."""
    import torch
    from horovod_tpu_torch.serve import InferenceEngine

    prompts = serve_prompts(0, SERVE_ORACLE_LENS, GPT_MEDIUM["vocab_size"])
    report = {}
    for name, model in models.items():
        limit = SERVE_MARGIN[name]
        oracle = serve_oracle(model, prompts, SERVE_NEW_TOKENS)
        for path, kw in (("dense", dict(kv_cache="dense")),
                         ("paged", {}),
                         ("paged+spec", dict(drafter=model,
                                             spec_k=SERVE_SPEC_K))):
            engine = InferenceEngine(model, **{**SERVE_ENGINE, **kw})
            spec = "drafter" in kw
            tap = None if spec else LogitTap(model)
            try:
                got = engine_tokens(engine, prompts, SERVE_NEW_TOKENS, spec)
            finally:
                if tap is not None:
                    tap.close()
            tapped = (None if tap is None
                      else tap.rows(prompts, SERVE_NEW_TOKENS))
            compared, dlogit = 0, None
            for i, (toks, margins, rows) in enumerate(oracle):
                ok, n_cmp, stop = margin_match(got[i], toks, margins, limit)
                if not ok:
                    raise AssertionError(
                        f"serve 1 rank: {name} {path} prompt of "
                        f"{len(prompts[i])} tokens differs from the oracle "
                        f"at token {stop} where its margin is "
                        f"{margins[stop]} (limit {limit}): {got[i]} "
                        f"against {toks}")
                compared += n_cmp
                if tapped is not None:
                    upto = SERVE_NEW_TOKENS if stop is None else stop + 1
                    d = float((tapped[i][:upto] - rows[:upto]).abs().max())
                    dlogit = d if dlogit is None else max(dlogit, d)
            report[f"{name} {path}"] = dict(
                compared=compared, max_dlogit=dlogit,
                kv=engine.kv_stats().get("spec_accept_per_verify"))
            log(f"serve 1 rank: (a) {name} {path}: {compared} of "
                f"{len(prompts) * SERVE_NEW_TOKENS} positions compared "
                f"(margin >= {limit}), tokens equal the oracle's there; "
                f"largest |dlogit| against the oracle "
                f"{'not captured (self-drafter)' if dlogit is None else dlogit}"
                + (f", {report[f'{name} {path}']['kv']} tokens a verify"
                   if spec else ""))
            del engine, tap, tapped
            gc.collect()   # an engine and its block pool form a cycle
            if not spec:
                engine = InferenceEngine(model, **{**SERVE_ENGINE, **kw})
                d, n_cmp, bad = forced_check(engine, model, prompts, oracle,
                                             name)
                del engine
                gc.collect()
                if d > SERVE_LOGIT_LIMIT[name] or bad is not None:
                    raise AssertionError(
                        f"serve 1 rank: {name} {path} teacher-forced: "
                        f"|dlogit| {d} (limit {SERVE_LOGIT_LIMIT[name]}), "
                        f"first token past the margin that differs "
                        f"(prompt, position) {bad}")
                report[f"{name} {path}"].update(forced_dlogit=d,
                                                forced_compared=n_cmp)
                log(f"serve 1 rank: (a) {name} {path}, teacher-forced: "
                    f"largest |dlogit| over all "
                    f"{len(prompts) * SERVE_NEW_TOKENS} rows {d} (limit "
                    f"{SERVE_LOGIT_LIMIT[name]}), tokens equal the oracle's "
                    f"at all {n_cmp} positions past the margin")
            torch.cuda.empty_cache()
        if name == "bfloat16":
            report["controls"] = forced_controls(model, prompts, oracle,
                                                 name)
    return report


def traffic_requests(vocab: int):
    """SERVE_REQUESTS requests from seed 0: prompts of 16-900 tokens,
    SERVE_SHARED of them a SERVE_SYSTEM-token system prompt plus a turn
    header plus a user turn; every other one greedy, the rest at
    temperature 0.8 / top-k 50; SERVE_SPEC greedy ones speculative."""
    import numpy as np
    from horovod_tpu_torch.serve import SamplingParams

    rng = np.random.RandomState(0)
    system = [int(t) for t in rng.randint(0, vocab, SERVE_SYSTEM)]
    reqs, n_spec = [], 0
    for i in range(SERVE_REQUESTS):
        if i % 3 == 0 and len([r for r in reqs if r[2]]) < SERVE_SHARED:
            user = int(rng.randint(8, 900 - SERVE_SYSTEM - len(SERVE_HEADER)))
            prompt = (system + list(SERVE_HEADER)
                      + [int(t) for t in rng.randint(0, vocab, user)])
            shared = True
        else:
            prompt = [int(t) for t in
                      rng.randint(0, vocab, int(rng.randint(16, 901)))]
            shared = False
        greedy = i % 2 == 0
        spec = greedy and n_spec < SERVE_SPEC and not shared
        n_spec += spec
        sp = (SamplingParams(max_new_tokens=SERVE_NEW_TOKENS, spec=spec)
              if greedy else
              SamplingParams(max_new_tokens=SERVE_NEW_TOKENS,
                             temperature=SERVE_TEMPERATURE,
                             top_k=SERVE_TOP_K))
        reqs.append((prompt, sp, shared))
    return reqs


def traffic_phase(model, card: str) -> dict:
    """(b): the closed loop of SERVE_CLIENTS clients through
    ``ContinuousBatcher`` on the engine with the self-drafter."""
    import torch
    from horovod_tpu_torch.serve import ContinuousBatcher, InferenceEngine

    vocab = model.config.vocab_size
    todo = traffic_requests(vocab)
    assert sum(r[2] for r in todo) == SERVE_SHARED
    assert sum(r[1].spec for r in todo) == SERVE_SPEC
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine = InferenceEngine(model, **SERVE_ENGINE, drafter=model,
                             spec_k=SERVE_SPEC_K)
    batcher = ContinuousBatcher(engine, default_deadline_s=0)
    done, live, peak_blocks = [], [], 0
    t0 = time.perf_counter()
    while todo or live:
        while todo and len(live) < SERVE_CLIENTS:
            prompt, sp, _ = todo.pop(0)
            live.append(batcher.submit(prompt, sp))
        batcher.step()
        peak_blocks = max(peak_blocks, engine._kv.blocks_in_use())
        done += [r for r in live if r.done.is_set()]
        live = [r for r in live if not r.done.is_set()]
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    bad = [(r.request_id, r.error, len(r.tokens)) for r in done
           if r.error is not None or len(r.tokens) != SERVE_NEW_TOKENS
           or not all(0 <= t < vocab for t in r.tokens)]
    snap = batcher.snapshot()
    if bad or len(done) != SERVE_REQUESTS:
        raise AssertionError(f"serve 1 rank: traffic requests failed: {bad}")
    if snap["kv_prefix_hits_total"] < SERVE_SHARED - 1 \
            or snap["kv_cow_copies_total"] < 1:
        raise AssertionError(
            f"serve 1 rank: {snap['kv_prefix_hits_total']} prefix hits and "
            f"{snap['kv_cow_copies_total']} copy-on-write copies for "
            f"{SERVE_SHARED} requests sharing a system prompt")
    tokens = sum(len(r.tokens) for r in done)
    reading = dict(seconds=seconds, tok_per_s=tokens / seconds,
                   ttft_ms_p50=snap["ttft_ms_p50"],
                   ttft_ms_p99=snap["ttft_ms_p99"],
                   tpot_ms_p50=snap["tpot_ms_p50"],
                   tpot_ms_p99=snap["tpot_ms_p99"],
                   prefix_hit_ratio=snap["prefix_hit_ratio"],
                   spec_accept_per_verify=snap["spec_accept_per_verify"],
                   cow=snap["kv_cow_copies_total"], peak_blocks=peak_blocks,
                   blocks=snap["kv_blocks_total"], peak_gib=peak / 2**30)
    del batcher, engine
    reading.update(decode_cadence(model))
    log(f"serve 1 rank: (b) {SERVE_REQUESTS} requests, {SERVE_CLIENTS} "
        f"clients in a closed loop, {tokens} tokens in {seconds:.3f} s: "
        f"{reading['tok_per_s']:.1f} tokens/s, TTFT p50 "
        f"{reading['ttft_ms_p50']} ms p99 {reading['ttft_ms_p99']} ms, TPOT "
        f"p50 {reading['tpot_ms_p50']} ms p99 {reading['tpot_ms_p99']} ms, "
        f"prefix-hit ratio {reading['prefix_hit_ratio']} "
        f"({snap['kv_prefix_hits_total']} hits, {reading['cow']} "
        f"copy-on-write copies), spec {reading['spec_accept_per_verify']} "
        f"tokens a verify, KV blocks in use at most {peak_blocks} of "
        f"{reading['blocks']}, peak memory {reading['peak_gib']:.2f} GiB; "
        f"plain decode at {SERVE_ENGINE['max_slots']} busy slots (no "
        f"drafter) {reading['decode_ms']:.3f} ms a step on the host clock "
        f"({reading['decode_tok_s']:.1f} tokens/s), on {card}")
    return reading


def decode_cadence(model, steps: int = 16) -> dict:
    """A reading beside the traffic: ``steps`` plain decode steps with
    every slot busy (64-token prompts, greedy, no drafter), host clock
    over synchronised steps."""
    import torch
    from horovod_tpu_torch.serve import InferenceEngine, SamplingParams

    engine = InferenceEngine(model, **SERVE_ENGINE)
    prompts = serve_prompts(5, (64,) * SERVE_ENGINE["max_slots"],
                            model.config.vocab_size)
    for s, p in enumerate(prompts):
        engine.start(s, p, SamplingParams(max_new_tokens=steps + 4))
    engine.step()                       # the decode's first call
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()                   # ends in a host copy: synchronised
    ms = (time.perf_counter() - t0) / steps * 1e3
    del engine
    gc.collect()
    return dict(decode_ms=ms,
                decode_tok_s=SERVE_ENGINE["max_slots"] * 1e3 / ms)


def preempt_drill(model) -> dict:
    """(b), the preemption drill on a one-slot engine (the reference's
    sole-active-slot contract, ``tests/test_qos.py``): a batch request
    of 200 prompt tokens is preempted after 4 steps by an interactive
    one with a 1 s deadline, then resumes; its tokens must equal the
    uninterrupted run's, greedy (under the f32 margin rule) and at
    temperature 0.8 (exactly: the generator's state is restored)."""
    from horovod_tpu_torch.serve import (ContinuousBatcher, InferenceEngine,
                                         SamplingParams)

    vocab = model.config.vocab_size
    prompt = serve_prompts(2, (200,), vocab)[0]
    interactive = serve_prompts(3, (64,), vocab)[0]
    one_slot = {**SERVE_ENGINE, "max_slots": 1}
    out = {}
    for temp in (0.0, SERVE_TEMPERATURE):
        sp = SamplingParams(max_new_tokens=SERVE_NEW_TOKENS,
                            temperature=temp,
                            top_k=SERVE_TOP_K if temp else 0)
        ref = InferenceEngine(model, **one_slot, seed=5)
        want = [ref.start(0, prompt, sp)]
        while len(want) < SERVE_NEW_TOKENS:
            want.extend(ref.step()[0])
        del ref
        batcher = ContinuousBatcher(InferenceEngine(model, **one_slot,
                                                    seed=5),
                                    default_deadline_s=0)
        breq = batcher.submit(prompt, sp, qos_class="batch")
        for _ in range(4):
            batcher.step()
        ireq = batcher.submit(interactive, SamplingParams(max_new_tokens=4),
                              deadline_s=1.0, qos_class="interactive")
        while not (ireq.done.is_set() and breq.done.is_set()):
            batcher.step()
        if ireq.error is not None or breq.error is not None \
                or breq.preemptions != 1:
            raise AssertionError(
                f"serve 1 rank: preemption drill at temperature {temp}: "
                f"interactive {ireq.error}, batch {breq.error}, "
                f"{breq.preemptions} preemptions")
        out[temp] = (breq.tokens, want, breq.prefix_hit_tokens)
    toks, margins, _ = serve_oracle(model, [prompt], SERVE_NEW_TOKENS)[0]
    got, want, hit = out[0.0]
    ok, compared, stop = margin_match(got, want, margins,
                                      SERVE_MARGIN["float32"])
    if not ok or out[SERVE_TEMPERATURE][0] != out[SERVE_TEMPERATURE][1]:
        raise AssertionError(
            f"serve 1 rank: a preempted request did not resume to its "
            f"uninterrupted tokens: greedy {got} against {want} (stop "
            f"{stop}), temperature {out[SERVE_TEMPERATURE][0]} against "
            f"{out[SERVE_TEMPERATURE][1]}")
    log(f"serve 1 rank: (b) preemption drill: a batch request preempted "
        f"after 4 steps by an interactive one resumed with a prefix hit of "
        f"{hit} tokens to its uninterrupted tokens, greedy ({compared} of "
        f"{SERVE_NEW_TOKENS} positions past the f32 margin) and at "
        f"temperature {SERVE_TEMPERATURE} (all {SERVE_NEW_TOKENS} equal)")
    return dict(compared=compared, prefix_hit=hit)


def evict_drill(model) -> dict:
    """(c): prime a prompt (64 system tokens + 5), then under
    ``serve:step=0,mode=evict`` (the next allocation) serve a prompt
    sharing the system tokens: the forced eviction must drop the
    primed prompt's cached tail; the request, and the primed prompt
    served again, must give the oracle's tokens (f32 margin rule) from
    recomputed, never stale, blocks."""
    from horovod_tpu_torch import faults
    from horovod_tpu_torch.serve import (ContinuousBatcher, InferenceEngine,
                                         SamplingParams)

    vocab = model.config.vocab_size
    system = serve_prompts(4, (64,), vocab)[0]
    first, second = system + [7, 8, 9, 10, 11], system + [9, 9, 9]
    n = 8
    batcher = ContinuousBatcher(InferenceEngine(model, **SERVE_ENGINE),
                                default_deadline_s=0)
    engine = batcher.engine

    def serve(prompt):
        req = batcher.submit(prompt, SamplingParams(max_new_tokens=n))
        while not req.done.is_set():
            batcher.step()
        if req.error is not None:
            raise AssertionError(f"serve 1 rank: evict drill: {req.error}")
        return req

    primed = serve(first)
    cached = engine.prefix_probe(first)
    with faults.inject("serve:step=0,mode=evict"):
        hit = serve(second)
        fired = [h for h in faults.history() if h[0] == "serve"]
    after = engine.prefix_probe(first)
    again = serve(first)
    stats = engine.kv_stats()
    oracle = serve_oracle(model, [first, second], n)
    checks = [margin_match(r.tokens, toks, margins, SERVE_MARGIN["float32"])
              for r, (toks, margins, _) in zip((primed, hit, again),
                                               (oracle[0], oracle[1],
                                                oracle[0]))]
    if fired != [("serve", 0, "evict")] or stats["kv_evictions_total"] < 1 \
            or after >= cached or not all(ok for ok, *_ in checks):
        raise AssertionError(
            f"serve 1 rank: evict drill: fired {fired}, evictions "
            f"{stats['kv_evictions_total']}, resident prefix {cached} -> "
            f"{after}, oracle checks {checks}")
    log(f"serve 1 rank: (c) serve:step=0,mode=evict fired once, "
        f"{stats['kv_evictions_total']} block(s) evicted, the primed "
        f"prompt's resident prefix {cached} -> {after} tokens; the three "
        f"requests equal the oracle at {[c[1] for c in checks]} of {n} "
        f"positions each (f32 margin)")
    return dict(evictions=stats["kv_evictions_total"])


def serve_phase(dev, card: str) -> dict:
    """Path "serve 1 rank": (a) the oracle, (b) the traffic and the
    preemption drill, (c) the evict drill.  The launch counts are set
    to 0 just before and read just after; B1 runs in the oracle's
    forwards only (the engine's attention is plain torch, as the
    reference's is)."""
    import torch
    import horovod_tpu_torch as hvd

    t0 = time.perf_counter()
    bf16 = serve_model(dev, torch.bfloat16)
    f32 = serve_model(dev, torch.float32)
    f32.load_state_dict(bf16.state_dict())
    hvd.ops.reset_launch_counts()
    oracle = oracle_phase(dev, {"float32": f32, "bfloat16": bf16})
    counts_a = hvd.ops.launch_counts()
    traffic = traffic_phase(bf16, card)
    engine_counts = {k: v - counts_a[k]
                     for k, v in hvd.ops.launch_counts().items()}
    preempt = preempt_drill(f32)
    evict = evict_drill(f32)
    counts = hvd.ops.launch_counts()
    n_forwards = 2 * len(SERVE_ORACLE_LENS) * SERVE_NEW_TOKENS
    want = n_forwards * GPT_MEDIUM["n_layer"]
    if counts_a["flash_fwd"] != want or any(engine_counts.values()):
        raise AssertionError(
            f"serve 1 rank: the oracle launched flash_fwd "
            f"{counts_a['flash_fwd']} times (want {want}); the traffic "
            f"launched {engine_counts}")
    seconds = time.perf_counter() - t0
    log(f"serve 1 rank: {seconds:.1f} s; the oracle's {n_forwards} forwards "
        f"launched flash_fwd {want} times, the engine's traffic no kernel "
        f"({engine_counts}); launches {counts}; on {card}")
    del bf16, f32
    gc.collect()
    torch.cuda.empty_cache()
    return counts, dict(seconds=seconds, oracle=oracle, traffic=traffic,
                        preempt=preempt, evict=evict)


def serve_ranks(dev, rank: int) -> dict:
    """Path "serve 1 rank" in a process of its own (``--serve-worker``):
    after bf16 serving at these prompt lengths ``torch.profiler`` records
    no device event in the process that served (bisected on the card:
    the bf16 oracle and the traffic leave it so, the f32 drills do not),
    and the route check, last in the main process, reads those events."""
    counts, report = serve_phase(dev, card_and_power_limit())
    return dict(counts=counts, report=report)


def replica_ranks(dev, rank: int) -> dict:
    """Path "serve 2 replicas" in a process of its own
    (``--replicas-worker``), as :func:`serve_ranks`."""
    counts, report = replicas_phase(dev, card_and_power_limit())
    return dict(counts=counts, report=report)


def replicas_phase(dev, card: str) -> dict:
    """Path "serve 2 replicas": two ``InferenceServer``s on the card,
    each with its own engine of the bf16 model, behind a ``Router`` over
    the HMAC wire.  SERVE_REPLICA_REQUESTS greedy requests sent at once
    must finish with their one-replica tokens (the bf16 margin rule,
    margins from the full-forward oracle); then ``serve:mode=kill`` at
    replica A's decode event SERVE_KILL_STEP: the request completes on
    B with the same tokens, A dead, B's count up by one, a replay of the
    request id answered from the router's cache (no duplicate)."""
    import concurrent.futures
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import faults
    from horovod_tpu_torch.runner.common.secret import make_secret_key
    from horovod_tpu_torch.serve import (ContinuousBatcher, InferenceEngine,
                                         InferenceServer, ReplicaSpec, Router,
                                         SamplingParams)
    from horovod_tpu_torch.utils.retry import RetryPolicy

    t0 = time.perf_counter()
    model = serve_model(dev, torch.bfloat16)
    vocab = model.config.vocab_size
    rng_lens = [16 + 37 * i for i in range(SERVE_REPLICA_REQUESTS + 1)]
    prompts = serve_prompts(1, rng_lens, vocab)
    hvd.ops.reset_launch_counts()
    # One replica's tokens: the same prompts through one engine.
    one = ContinuousBatcher(InferenceEngine(model, **SERVE_ENGINE),
                            default_deadline_s=0)
    reqs = [one.submit(p, SamplingParams(max_new_tokens=SERVE_NEW_TOKENS))
            for p in prompts]
    while not all(r.done.is_set() for r in reqs):
        one.step()
    want = [r.tokens for r in reqs]
    del one
    gc.collect()
    oracle = serve_oracle(model, prompts, SERVE_NEW_TOKENS)
    key = make_secret_key()
    servers = [InferenceServer(
        ContinuousBatcher(InferenceEngine(model, **SERVE_ENGINE),
                          default_deadline_s=0),
        key=key, name=name, host="127.0.0.1") for name in ("serve-a",
                                                           "serve-b")]
    specs = [ReplicaSpec(s.name, [("127.0.0.1", s.port)]) for s in servers]
    policy = RetryPolicy(attempts=6, base_delay_s=0.02, max_delay_s=0.2)
    limit = SERVE_MARGIN["bfloat16"]
    try:
        router = Router(specs, key, retry_policy=policy)
        t1 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(
                SERVE_REPLICA_REQUESTS) as pool:
            resps = list(pool.map(
                lambda i: router.generate(prompts[i],
                                          max_new_tokens=SERVE_NEW_TOKENS,
                                          request_id=f"rep-{i}"),
                range(SERVE_REPLICA_REQUESTS)))
        wire_s = time.perf_counter() - t1
        compared = 0
        for i, resp in enumerate(resps):
            ok, n_cmp, stop = margin_match(resp.tokens or [], want[i],
                                           oracle[i][1], limit)
            if resp.error is not None or not ok:
                raise AssertionError(
                    f"serve 2 replicas: request {i}: {resp.error}, tokens "
                    f"{resp.tokens} against one replica's {want[i]} (stop "
                    f"{stop})")
            compared += n_cmp
        served = {n: e["completed"] for n, e in router.replica_stats().items()}
        if sorted(served.values())[0] == 0:
            raise AssertionError(f"serve 2 replicas: one replica served "
                                 f"nothing: {served}")
        # The kill drill: a fresh router sends its first request to A.
        drill = Router(specs, key, retry_policy=policy)
        i = SERVE_REPLICA_REQUESTS
        before = servers[1]._batcher.stats.snapshot()["requests_completed"]
        with faults.inject(f"serve:step={SERVE_KILL_STEP},mode=kill"):
            resp = drill.generate(prompts[i], max_new_tokens=SERVE_NEW_TOKENS,
                                  request_id="kill-0")
            fired = [h for h in faults.history() if h[0] == "serve"]
        again = drill.generate([1], max_new_tokens=2, request_id="kill-0")
        after = servers[1]._batcher.stats.snapshot()["requests_completed"]
        ok, n_kill, stop = margin_match(resp.tokens or [], want[i],
                                        oracle[i][1], limit)
        if resp.error is not None or not ok or again is not resp \
                or fired != [("serve", SERVE_KILL_STEP, "kill")] \
                or [s.dead for s in servers] != [True, False] \
                or after != before + 1:
            raise AssertionError(
                f"serve 2 replicas: kill drill: {resp.error}, tokens "
                f"{resp.tokens} against {want[i]} (stop {stop}), fired "
                f"{fired}, dead {[s.dead for s in servers]}, B completed "
                f"{before} -> {after}, replay cached {again is resp}")
    finally:
        for s in servers:
            s.shutdown()
        gc.collect()
    counts = hvd.ops.launch_counts()
    seconds = time.perf_counter() - t0
    log(f"serve 2 replicas: {SERVE_REPLICA_REQUESTS} requests over the HMAC "
        f"wire in {wire_s:.3f} s, served {served}, tokens equal one "
        f"replica's at {compared} positions past the bf16 margin; kill "
        f"drill: replica A died at decode event {SERVE_KILL_STEP}, the "
        f"request completed on B ({n_kill} positions compared), one "
        f"response, the replay answered from the router's cache; "
        f"{seconds:.1f} s in all; launches {counts} (the oracle's "
        f"forwards); on {card}")
    del model
    torch.cuda.empty_cache()
    return counts, dict(seconds=seconds, wire_s=wire_s, served=served)


# "fleet 3 replicas": a prefill replica and two decode replicas.
FLEET_REQUESTS = 12
FLEET_SHARED = 4                      # of them a SERVE_SYSTEM-token prefix
FLEET_DRILL_PROMPTS = 7               # migrate, 4 controller, kill, alone
FLEET_DRAIN_S = 60.0                  # the controller drill's bound


def fleet_prompts(vocab: int):
    """FLEET_REQUESTS prompts from seed 0, 17 to 900 tokens, FLEET_SHARED
    of them the SERVE_SYSTEM-token system prompt, the turn header and a
    user turn; then the drills' prompts (40 to 240 tokens)."""
    import numpy as np

    rng = np.random.RandomState(0)
    system = [int(t) for t in rng.randint(0, vocab, SERVE_SYSTEM)]
    lengths = [17, 900] + [int(n) for n in rng.randint(
        17, 901, FLEET_REQUESTS - FLEET_SHARED - 2)]
    prompts = []
    for i in range(FLEET_REQUESTS):
        if i % 3 == 1:
            user = int(rng.randint(8, 900 - SERVE_SYSTEM - len(SERVE_HEADER)))
            prompts.append(system + list(SERVE_HEADER)
                           + [int(t) for t in rng.randint(0, vocab, user)])
        else:
            prompts.append([int(t) for t in rng.randint(0, vocab,
                                                       lengths.pop(0))])
    drills = [[int(t) for t in rng.randint(0, vocab, 40 + 40 * j)]
              for j in range(FLEET_DRILL_PROMPTS)]
    return prompts, drills


class MigrationTap:
    """Counts the transfers a decode server's receive buffer completed
    (every block digest-verified there) and the ones it rejected."""

    def __init__(self, server):
        self.verified, self.rejected, self.blocks, self.bytes = 0, 0, [], []
        add = server._migrations.add

        def tapped(frame):
            from horovod_tpu_torch.serve.fleet import MigrationError

            try:
                out = add(frame)
            except MigrationError:
                self.rejected += 1
                raise
            if out is not None:
                manifest, k, v = out
                self.verified += 1
                self.blocks.append(int(manifest["n_blocks"]))
                self.bytes.append(int(k.numel() * k.element_size()
                                      + v.numel() * v.element_size()))
            return out

        server._migrations.add = tapped


def fleet_ranks(dev, rank: int) -> dict:
    """Path "fleet 3 replicas" in a process of its own
    (``--fleet-worker``), as :func:`serve_ranks`."""
    counts, report = fleet_phase(dev, card_and_power_limit())
    return dict(counts=counts, report=report)


def fleet_phase(dev, card: str):
    """Path "fleet 3 replicas": a prefill replica and two decode
    replicas (``InferenceServer``s on the card, each with its own
    engine of the bf16 model at the reference's defaults) behind a
    ``Router`` over the HMAC wire on loopback.  FLEET_REQUESTS greedy
    requests sent at once must each be migrated to a decode replica
    (``migrated_to``), every transfer digest-verified on the receiver,
    and their tokens one unified replica's wherever the oracle's margin
    holds.  Drills: ``serve:mode=migrate`` (the receiver rejects the
    damaged block, the prefill replica decodes the request itself with
    the same tokens); a ``FleetController`` round on a real
    ``TelemetryPlane`` scrape, a forced ``scale_out("decode")`` through
    an in-process ``ReplicaLauncher``, then ``drain_and_retire`` of the
    new replica under traffic, no request lost; ``serve:mode=kill`` on
    the prefill replica at its handoff (mid-migration): the request
    completes once, on a decode replica, and a replay of its id is
    answered from the router's cache."""
    import concurrent.futures
    import threading
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import faults
    from horovod_tpu_torch.obs.collector import (FleetCollector, Target,
                                                 TelemetryPlane)
    from horovod_tpu_torch.runner.common.secret import make_secret_key
    from horovod_tpu_torch.serve import (ContinuousBatcher, FleetController,
                                         InferenceEngine, InferenceServer,
                                         ReplicaLauncher, ReplicaSpec, Router,
                                         SamplingParams)
    from horovod_tpu_torch.serve.metrics import percentile
    from horovod_tpu_torch.utils.retry import RetryPolicy

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = serve_model(dev, torch.bfloat16)
    prompts, drills = fleet_prompts(model.config.vocab_size)
    every = prompts + drills
    n = SERVE_NEW_TOKENS
    limit = SERVE_MARGIN["bfloat16"]
    hvd.ops.reset_launch_counts()
    # One unified replica's tokens: every prompt through one engine.
    one = ContinuousBatcher(InferenceEngine(model, **SERVE_ENGINE),
                            default_deadline_s=0)
    reqs = [one.submit(p, SamplingParams(max_new_tokens=n)) for p in every]
    while not all(r.done.is_set() for r in reqs):
        one.step()
    want = [r.tokens for r in reqs]
    del one, reqs
    gc.collect()
    oracle = serve_oracle(model, every, n)
    key = make_secret_key()

    def server(name, role):
        return InferenceServer(
            ContinuousBatcher(InferenceEngine(model, **SERVE_ENGINE),
                              default_deadline_s=0, role=role),
            key=key, name=name, host="127.0.0.1")

    def spec(s):
        return ReplicaSpec(s.name, [("127.0.0.1", s.port)], role=s.role)

    def check(i, resp, what, migrated):
        ok, cmp, stop = margin_match(resp.tokens or [], want[i],
                                     oracle[i][1], limit)
        if resp.error is not None or not ok or (
                migrated is not None and resp.migrated_to not in migrated):
            raise AssertionError(
                f"fleet 3 replicas: {what}: {resp.error}, migrated to "
                f"{resp.migrated_to}, tokens {resp.tokens} against one "
                f"replica's {want[i]} (stop {stop})")
        return cmp

    servers = [server("fleet-pre", "prefill"), server("fleet-d0", "decode"),
               server("fleet-d1", "decode")]
    taps = [MigrationTap(s) for s in servers[1:]]
    policy = RetryPolicy(attempts=8, base_delay_s=0.02, max_delay_s=0.2)
    decoders = {s.name for s in servers[1:]}

    class Launcher(ReplicaLauncher):
        def __init__(self):
            self.live, self.retired = {}, []

        def launch(self, role, host=None):
            s = server(f"fleet-new-{len(self.live) + len(self.retired)}",
                       role)
            self.live[s.name] = s
            return spec(s)

        def retire(self, name):
            self.live.pop(name).shutdown()
            self.retired.append(name)

    launcher = Launcher()
    try:
        router = Router([spec(s) for s in servers], key, retry_policy=policy)
        timing = {}

        def send(i):
            t = time.perf_counter()
            resp = router.generate(every[i], max_new_tokens=n,
                                   request_id=f"fleet-{i}")
            timing[i] = time.perf_counter() - t
            return resp

        t1 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(FLEET_REQUESTS) as pool:
            resps = list(pool.map(send, range(FLEET_REQUESTS)))
        wire_s = time.perf_counter() - t1
        compared = sum(check(i, r, f"request {i}", decoders)
                       for i, r in enumerate(resps))
        verified = sum(t.verified for t in taps)
        if verified != FLEET_REQUESTS or any(t.rejected for t in taps):
            raise AssertionError(
                f"fleet 3 replicas: {verified} transfers verified, "
                f"{[t.rejected for t in taps]} rejected")
        want_blocks = sorted(-(-len(p) // SERVE_ENGINE["kv_block"])
                             for p in prompts)
        if sorted(b for t in taps for b in t.blocks) != want_blocks:
            raise AssertionError(f"fleet 3 replicas: blocks moved "
                                 f"{[t.blocks for t in taps]}")
        moved = [b for t in taps for b in t.bytes]
        migrate_ms = [r.migrate_ms for r in resps]
        ttft = [r.ttft_ms for r in resps]
        tpot = [(timing[i] * 1e3 - r.ttft_ms) / (n - 1)
                for i, r in enumerate(resps)]
        by_target = {d: sum(r.migrated_to == d for r in resps)
                     for d in sorted(decoders)}
        # One migration on an idle fleet: the transfer without the other
        # replicas' threads competing for the interpreter.
        i = FLEET_REQUESTS + 6
        alone = router.generate(every[i], max_new_tokens=n,
                                request_id="fleet-alone")
        check(i, alone, "the request alone", decoders)
        alone_bytes = taps[0].bytes[-1] if alone.migrated_to == \
            servers[1].name else taps[1].bytes[-1]

        # serve:mode=migrate — one block damaged after its digest.
        i = FLEET_REQUESTS
        with faults.inject("serve:step=0,mode=migrate"):
            resp = router.generate(every[i], max_new_tokens=n,
                                   request_id="fleet-migrate")
            fired = [h for h in faults.history() if h[0] == "serve"]
        check(i, resp, "migrate drill", {None})
        rejected = sum(t.rejected for t in taps)
        if fired != [("serve", 0, "migrate")] or rejected != 1:
            raise AssertionError(f"fleet 3 replicas: migrate drill fired "
                                 f"{fired}, {rejected} rejections")

        # The controller on a real TelemetryPlane scrape.
        def targets():
            live = servers + list(launcher.live.values())
            return [Target(s.name, (("127.0.0.1", s.port),), s.role)
                    for s in live if not s.dead]

        plane = TelemetryPlane(FleetCollector(targets, key=key,
                                              timeout_s=2.0), period_s=1.0)
        controller = FleetController(router, launcher,
                                     collector=plane.collector,
                                     scale_in_idle_s=3600.0,
                                     drain_deadline_s=FLEET_DRAIN_S,
                                     stats_timeout_s=2.0)
        polled = []
        direct = router.replica_stats
        router.replica_stats = lambda **kw: polled.append(1) or direct(**kw)
        alerts = plane.run_round()
        scraped = plane.collector.latest_stats()
        first = controller.poll_once()
        if polled or sorted(scraped) != sorted(s.name for s in servers) \
                or any("stats" not in e for e in scraped.values()) \
                or first:
            raise AssertionError(
                f"fleet 3 replicas: controller round: polled the router "
                f"{len(polled)} times, scraped {scraped}, acted {first}")
        new = controller.scale_out("decode")
        plane.run_round()
        scaled = plane.collector.latest_stats()
        idx = list(range(FLEET_REQUESTS + 1, FLEET_REQUESTS + 3))
        with concurrent.futures.ThreadPoolExecutor(len(idx)) as pool:
            during = list(pool.map(send, idx))
        controller.drain_and_retire(new.name)
        late = list(range(FLEET_REQUESTS + 3, FLEET_REQUESTS + 5))
        lost = []
        threads = [threading.Thread(
            target=lambda j=j: lost.append((j, send(j))), daemon=True)
            for j in late]
        for t in threads:
            t.start()
        deadline = time.monotonic() + FLEET_DRAIN_S + 30.0
        retire_actions = []
        while controller.draining() and time.monotonic() < deadline:
            plane.run_round()
            retire_actions += controller.poll_once()
            time.sleep(0.05)
        for t in threads:
            t.join(timeout=300.0)
        for j, r in zip(idx, during):
            check(j, r, f"scale-out request {j}", decoders | {new.name})
        for j, r in lost:
            check(j, r, f"drain request {j}", decoders | {new.name, None})
        if controller.draining() or launcher.retired != [new.name] \
                or len(lost) != len(late) or len(scaled) != 4 \
                or [a["action"] for a in retire_actions] != ["retire"]:
            raise AssertionError(
                f"fleet 3 replicas: scale cycle: draining "
                f"{controller.draining()}, retired {launcher.retired}, "
                f"{len(lost)} of {len(late)} drain requests answered, "
                f"{len(scaled)} replicas scraped, {retire_actions}")
        router.replica_stats = direct

        # serve:mode=kill on the prefill replica at its handoff.
        i = FLEET_REQUESTS + 5
        drill = Router([spec(s) for s in servers], key, retry_policy=policy)
        before = {s.name: s._batcher.stats.snapshot()["requests_completed"]
                  for s in servers}
        with faults.inject("serve:step=0,mode=kill"):
            resp = drill.generate(every[i], max_new_tokens=n,
                                  request_id="fleet-kill")
            fired = [h for h in faults.history() if h[0] == "serve"]
        again = drill.generate([1], max_new_tokens=2, request_id="fleet-kill")
        after = {s.name: s._batcher.stats.snapshot()["requests_completed"]
                 for s in servers}
        done = {k: after[k] - before[k] for k in after}
        check(i, resp, "kill drill", {None})
        if fired != [("serve", 0, "kill")] or again is not resp \
                or [s.dead for s in servers] != [True, False, False] \
                or sorted(done.values()) != [0, 0, 1] \
                or done["fleet-pre"] != 0:
            raise AssertionError(
                f"fleet 3 replicas: kill drill: fired {fired}, dead "
                f"{[s.dead for s in servers]}, completed {done}, replay "
                f"cached {again is resp}")
    finally:
        for s in list(launcher.live.values()) + servers:
            s.shutdown()
        gc.collect()
    counts = hvd.ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    seconds = time.perf_counter() - t0
    report = dict(
        seconds=seconds, wire_s=wire_s, compared=compared,
        by_target=by_target,
        migrate_ms_mean=statistics.mean(migrate_ms),
        migrate_ms_p50=percentile(migrate_ms, 50),
        migrate_ms_p99=percentile(migrate_ms, 99),
        bytes_per_request=statistics.mean(moved),
        ttft_ms_p50=percentile(ttft, 50), tpot_ms_p50=percentile(tpot, 50),
        alone_migrate_ms=alone.migrate_ms, alone_bytes=alone_bytes,
        peak_gib=peak / 2**30, alerts=[a["alert"] for a in alerts])
    log(f"fleet 3 replicas: {FLEET_REQUESTS} requests prefilled on "
        f"fleet-pre and migrated ({by_target}) in {wire_s:.3f} s, "
        f"{verified} transfers digest-verified, tokens one unified "
        f"replica's at {compared} positions past the bf16 margin; "
        f"migrate_ms p50 {report['migrate_ms_p50']} p99 "
        f"{report['migrate_ms_p99']}, {report['bytes_per_request']:.0f} "
        f"bytes a request, TTFT p50 {report['ttft_ms_p50']} ms, TPOT p50 "
        f"{report['tpot_ms_p50']} ms; alone on an idle fleet "
        f"{alone.migrate_ms} ms for {alone_bytes} bytes; migrate drill "
        f"rejected at the "
        f"receiver and decoded locally; controller round on the plane's "
        f"scrape, scale-out to {new.name} and its drain-and-retire with no "
        f"request lost; kill drill on fleet-pre answered once by a decode "
        f"replica; peak {report['peak_gib']:.2f} GiB; {seconds:.1f} s in "
        f"all; launches {counts} (the oracle's forwards); on {card}")
    del model
    torch.cuda.empty_cache()
    return counts, report


# "swap 2 replicas": two unified replicas on a checkpoint store.
SWAP_PROMPT_LENS = (16, 48, 96, 160, 224, 288, 352, 416)
SWAP_CLIENTS = 8
SWAP_BITWISE = 4                      # prompts served alone, boot vs rollback
# Depth cut for the script's time limit beside the TP phases; widths
# kept (PERF.md section 4).
SWAP_LAYERS = 8
SWAP_PERTURBED = ("lm_head.kernel",
                  f"block_{SWAP_LAYERS - 1}.mlp.up.kernel",
                  f"block_{SWAP_LAYERS - 1}.mlp.down.kernel")


def swap_ranks(dev, rank: int) -> dict:
    """Path "swap 2 replicas" in a process of its own
    (``--swap-worker``), as :func:`serve_ranks`."""
    counts, report = swap_phase(dev, card_and_power_limit())
    return dict(counts=counts, report=report)


def swap_step2(boot: dict, dev) -> dict:
    """Step 2's tree: the boot weights with SWAP_PERTURBED moved by a
    seeded draw of each leaf's own spread."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(2)
    out = dict(boot)
    for name in SWAP_PERTURBED:
        p = boot[name]
        out[name] = p + p.std() * torch.randn(p.shape, generator=gen,
                                             device=dev, dtype=p.dtype)
    return out


def routed_tokens(router, prompts, tag: str, alone: bool = True):
    """Each prompt through the router, one after another (``alone``) or
    all at once: ``(tokens, version)`` in prompt order."""
    import concurrent.futures

    def one(i):
        resp = router.generate(prompts[i], max_new_tokens=SERVE_NEW_TOKENS,
                               request_id=f"{tag}-{i}")
        if resp.error is not None:
            raise AssertionError(f"swap 2 replicas: {tag} {i}: {resp.error}")
        return resp.tokens, resp.weights_version

    if alone:
        return [one(i) for i in range(len(prompts))]
    with concurrent.futures.ThreadPoolExecutor(len(prompts)) as pool:
        return list(pool.map(one, range(len(prompts))))


def swap_phase(dev, card: str):
    """Path "swap 2 replicas" (GPT-medium's widths at SWAP_LAYERS
    layers): step 1 (the boot weights of the bf16
    model, f32 parameters) and step 2 (SWAP_PERTURBED moved) written
    through ``AsyncCheckpointer``; two unified ``InferenceServer``s,
    each with its own copy of the boot model and a ``WeightSubscriber``
    on the store (``swap_store=``; polling off, so the controller's roll
    is the only swap), behind a ``Router``.  ``FleetController.
    roll_swap(2, max_concurrent=1)`` under a closed loop of SWAP_CLIENTS
    clients: no request dropped, every response's tokens its version's
    (the bf16 margin rule against a fresh engine on that step's weights,
    margins from that step's full-forward oracle), the pulled leaves
    exactly SWAP_PERTURBED, ``pulled_bytes`` their bytes and under the
    step's; after the roll every request is step 2's.  The rollback to
    step 1 restores the boot parameters bit for bit and the boot tokens
    of SWAP_BITWISE prompts, each served alone, bit for bit.  ``swap:mode=corrupt-shard``:
    the swap is rejected, ``SwapResponse.weights_version`` is still 1
    and the replicas keep serving step 1."""
    import tempfile
    import threading
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import faults
    from horovod_tpu_torch.ckpt import (AsyncCheckpointer, ShardStore,
                                        diff_manifest)
    from horovod_tpu_torch.runner.common.secret import make_secret_key
    from horovod_tpu_torch.serve import (ContinuousBatcher, FleetController,
                                         InferenceEngine, InferenceServer,
                                         ReplicaLauncher, ReplicaSpec, Router,
                                         SamplingParams)
    from horovod_tpu_torch.serve.swap import leaf_digests
    from horovod_tpu_torch.utils.retry import RetryPolicy

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    n = SERVE_NEW_TOKENS
    limit = SERVE_MARGIN["bfloat16"]
    models = [serve_model(dev, torch.bfloat16, SWAP_LAYERS)
              for _ in range(2)]
    vocab = models[0].config.vocab_size
    prompts = serve_prompts(3, SWAP_PROMPT_LENS, vocab)
    boot = {k: p.detach() for k, p in models[0].named_parameters()}
    boot_host = {k: p.to("cpu", copy=True) for k, p in boot.items()}
    step2 = swap_step2(boot, dev)
    hvd.ops.reset_launch_counts()

    def engine_ref(model):
        b = ContinuousBatcher(InferenceEngine(model, **SERVE_ENGINE),
                              default_deadline_s=0)
        reqs = [b.submit(p, SamplingParams(max_new_tokens=n))
                for p in prompts]
        while not all(r.done.is_set() for r in reqs):
            b.step()
        return [r.tokens for r in reqs]

    # Each step's oracle: a fresh engine's tokens, the full forward's
    # margins (step 2's model built only for this, then dropped).
    refs = {1: (engine_ref(models[0]),
                serve_oracle(models[0], prompts, n))}
    m2 = serve_model(dev, torch.bfloat16, SWAP_LAYERS)
    with torch.no_grad():
        for k, p in m2.named_parameters():
            p.copy_(step2[k])
    refs[2] = (engine_ref(m2), serve_oracle(m2, prompts, n))
    del m2
    gc.collect()
    torch.cuda.empty_cache()
    differ = sum(a != b for a, b in zip(refs[1][0], refs[2][0]))
    if not differ:
        raise AssertionError("swap 2 replicas: step 2's tokens equal step "
                             "1's: the oracle cannot tell the versions")

    def check(i, tokens, version, what):
        if version not in refs:
            raise AssertionError(f"swap 2 replicas: {what}: version "
                                 f"{version}")
        ok, cmp, stop = margin_match(tokens or [], refs[version][0][i],
                                     refs[version][1][i][1], limit)
        if not ok:
            raise AssertionError(
                f"swap 2 replicas: {what}: tokens {tokens} against step "
                f"{version}'s {refs[version][0][i]} (stop {stop})")
        return cmp

    class NoLaunch(ReplicaLauncher):
        def launch(self, role, host=None):
            raise AssertionError("the swap path launches no replica")

        def retire(self, name):
            pass

    key = make_secret_key()
    with tempfile.TemporaryDirectory() as store_dir:
        t1 = time.perf_counter()
        with AsyncCheckpointer(store_dir, world=1, scheme="dp",
                               async_save=False) as ckpt:
            for step, tree in ((1, boot), (2, step2)):
                ckpt.save(step, tree)
                ckpt.journal_step(step)
        write_s = time.perf_counter() - t1
        manifest2 = ShardStore(store_dir).validate_step(2)
        changed = sorted(diff_manifest(manifest2, {
            p: d for p, (d, _) in leaf_digests(boot).items()})[1].values())
        if changed != sorted(repr(k) for k in SWAP_PERTURBED):
            raise AssertionError(f"swap 2 replicas: step 2 differs from "
                                 f"the boot weights at {changed}")
        want_bytes = sum(step2[k].numel() * step2[k].element_size()
                         for k in SWAP_PERTURBED)
        del step2
        servers = [InferenceServer(
            ContinuousBatcher(InferenceEngine(m, weights_version=1,
                                              **SERVE_ENGINE),
                              default_deadline_s=0),
            key=key, name=f"swap-{c}", host="127.0.0.1",
            swap_store=store_dir, subscribe=False)
            for c, m in zip("ab", models)]
        try:
            router = Router([ReplicaSpec(s.name, [("127.0.0.1", s.port)])
                             for s in servers], key,
                            retry_policy=RetryPolicy(attempts=10,
                                                     base_delay_s=0.02,
                                                     max_delay_s=0.3))
            controller = FleetController(router, NoLaunch(),
                                         min_per_role=1)
            boot_seq = routed_tokens(router, prompts[:SWAP_BITWISE], "boot")
            for i, (toks, v) in enumerate(boot_seq):
                check(i, toks, v, f"boot request {i}")
            # The roll under a closed loop of SWAP_CLIENTS clients.
            rows, lock, stop = [], threading.Lock(), threading.Event()

            def client(c):
                k = 0
                while not stop.is_set():
                    i = (c + k) % len(prompts)
                    try:
                        resp = router.generate(
                            prompts[i], max_new_tokens=n,
                            request_id=f"loop-{c}-{k}")
                        row = (i, resp.tokens, resp.weights_version,
                               resp.error)
                    except Exception as e:   # a dropped request
                        row = (i, None, None, repr(e))
                    with lock:
                        rows.append(row)
                    k += 1

            clients = [threading.Thread(target=client, args=(c,),
                                        daemon=True)
                       for c in range(SWAP_CLIENTS)]
            for t in clients:
                t.start()
            time.sleep(0.5)
            t2 = time.perf_counter()
            outcomes = controller.roll_swap(2, max_concurrent=1,
                                            timeout=300.0)
            roll_s = time.perf_counter() - t2
            time.sleep(0.5)
            stop.set()
            for t in clients:
                t.join(timeout=300.0)
            if any(t.is_alive() for t in clients):
                raise AssertionError("swap 2 replicas: a client hung")
            dropped = [r for r in rows if r[3] is not None]
            if dropped or not rows:
                raise AssertionError(f"swap 2 replicas: {len(dropped)} of "
                                     f"{len(rows)} requests dropped: "
                                     f"{dropped[:3]}")
            compared = sum(check(i, toks, v, f"loop request {i}")
                           for i, toks, v, _ in rows)
            versions = {v: sum(r[2] == v for r in rows) for v in (1, 2)}
            pulls = [s.subscriber.last_swap for s in servers]
            if not all(o["ok"] and o["weights_version"] == 2
                       for o in outcomes) \
                    or any(p["pulled_leaves"] != len(SWAP_PERTURBED)
                           or p["pulled_bytes"] != want_bytes
                           or not p["pulled_bytes"] < p["total_bytes"]
                           for p in pulls):
                raise AssertionError(f"swap 2 replicas: roll {outcomes}, "
                                     f"pulls {pulls}")
            after = routed_tokens(router, prompts, "step2", alone=False)
            for i, (toks, v) in enumerate(after):
                if v != 2:
                    raise AssertionError(f"swap 2 replicas: request {i} "
                                         f"after the roll on version {v}")
                check(i, toks, v, f"post-roll request {i}")
            # Back to step 1: the boot parameters and tokens, bitwise.
            back = controller.rollback(1, timeout=300.0)
            again = routed_tokens(router, prompts[:SWAP_BITWISE],
                                  "rollback")
            bitwise = all(
                torch.equal(p.detach().cpu(), boot_host[k])
                for s in servers
                for k, p in s._batcher.engine.params.items())
            if not all(o["ok"] and o["weights_version"] == 1 for o in back) \
                    or again != boot_seq or not bitwise:
                raise AssertionError(
                    f"swap 2 replicas: rollback {back}: parameters bitwise "
                    f"{bitwise}, tokens bitwise {again == boot_seq}")
            # swap:mode=corrupt-shard: rejected, step 1 keeps serving.
            with faults.inject("swap:p=1,mode=corrupt-shard"):
                bad = [router.swap_replica(s.name, 2, timeout=300.0)
                       for s in servers]
                fired = [h for h in faults.history() if h[0] == "swap"]
            still = routed_tokens(router, prompts[:2], "corrupt")
            if any(not (b.error or "").startswith("rejected")
                   or b.weights_version != 1 for b in bad) \
                    or still != boot_seq[:2] or not fired:
                raise AssertionError(
                    f"swap 2 replicas: corrupt drill: "
                    f"{[(b.error, b.weights_version) for b in bad]}, "
                    f"fired {len(fired)}, step 1 still served "
                    f"{still == boot_seq[:2]}")
        finally:
            for s in servers:
                s.shutdown()
            gc.collect()
    counts = hvd.ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    seconds = time.perf_counter() - t0
    report = dict(seconds=seconds, write_s=write_s, roll_s=roll_s,
                  swap_ms=[o["swap_ms"] for o in outcomes],
                  rollback_ms=[o["swap_ms"] for o in back],
                  pulled_bytes=[o["pulled_bytes"] for o in outcomes],
                  total_bytes=pulls[0]["total_bytes"], requests=len(rows),
                  versions=versions, compared=compared, differ=differ,
                  peak_gib=peak / 2**30)
    log(f"swap 2 replicas: steps 1 and 2 written in {write_s:.1f} s; "
        f"roll_swap(2, max_concurrent=1) in {roll_s:.3f} s under "
        f"{SWAP_CLIENTS} clients: {len(rows)} requests, none dropped "
        f"(by version {versions}), tokens their version's at {compared} "
        f"positions past the bf16 margin ({differ} of {len(prompts)} "
        f"prompts differ between the steps); swap ms "
        f"{report['swap_ms']}, pulled {report['pulled_bytes']} of "
        f"{report['total_bytes']} bytes ({len(SWAP_PERTURBED)} leaves: "
        f"{', '.join(SWAP_PERTURBED)}); rollback ms "
        f"{report['rollback_ms']}, parameters and tokens bit for bit the "
        f"boot's; corrupt-shard rejected ({len(fired)} firings), version 1 "
        f"serving; peak {report['peak_gib']:.2f} GiB; {seconds:.1f} s in "
        f"all; launches {counts} (the oracles' forwards); on {card}")
    del models
    torch.cuda.empty_cache()
    return counts, report


# --- "serve tp 2": a tensor-parallel replica, two shards on one card ----------

TP_DEGREE = 2
TP_DEVICES = ("cuda:0", "cuda:0")     # the shard list: both on the one card
TP_MIGRATE_LENS = (17, 200, 280, 480)  # 280: the lone transfer compared
TP_ALONE_LEN = 280
TP_DRILL_REQUESTS, TP_DRILL_TOKENS = 12, 6
TP_KILL_STEP = 2                      # the follower's decode event it dies at
TP_LOAD_REQUESTS, TP_LOAD_PROMPT = 8, 64   # the tokens/s reading's batch
TP_SWAP_PROMPTS = 2
TP_SHARD_FLAG = "--tp-shard-worker"
TP_LAYERS = 8     # cut from 24, widths kept (the script's time)


def tp_ranks(dev, rank: int) -> dict:
    """Path "serve tp 2" in a process of its own (``--tp-worker``), as
    :func:`serve_ranks`."""
    counts, report = tp_phase(dev, card_and_power_limit())
    return dict(counts=counts, report=report)


def tp_shard_worker(tmp: str) -> None:
    """The lockstep drill's follower shard, run as ``chip_smoke.py
    --tp-shard-worker DIR``: a ``ShardServer`` over a whole engine of
    the bf16 model (the same seed as the leader's) with
    ``serve:step=TP_KILL_STEP,mode=kill`` armed in this process only;
    writes its port to ``DIR/port``, waits for ``DIR/done``, then writes
    the fault history to ``DIR/shard.json``."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from horovod_tpu_torch import faults
    from horovod_tpu_torch.serve import InferenceEngine, ShardServer

    torch.backends.cuda.matmul.allow_tf32 = False
    with open(os.path.join(tmp, "key"), "rb") as f:
        key = f.read()
    engine = InferenceEngine(serve_model(torch.device(TP_DEVICES[0]),
                                         torch.bfloat16, TP_LAYERS),
                             **SERVE_ENGINE)
    shard = ShardServer(engine, key, name="tp-shard-1", host="127.0.0.1")
    try:
        faults.configure(f"serve:step={TP_KILL_STEP},mode=kill")
        with open(os.path.join(tmp, "port.part"), "w") as f:
            f.write(str(shard.port))
        os.replace(os.path.join(tmp, "port.part"),
                   os.path.join(tmp, "port"))
        deadline = time.monotonic() + 600
        while not os.path.exists(os.path.join(tmp, "done")):
            if time.monotonic() > deadline:
                raise TimeoutError("tp shard: the leader never finished")
            time.sleep(0.1)
        with open(os.path.join(tmp, "shard.json"), "w") as f:
            json.dump({"history": faults.history(), "dead": shard._dead}, f)
    finally:
        shard.shutdown()


def tp_phase(dev, card: str):
    """Path "serve tp 2": GPT-medium (bf16 activations, f32 parameters
    from seed 0) in a tensor-parallel engine of two shards on the one
    card (``devices=TP_DEVICES``) beside a tp = 1 engine on the same
    weights, both at the reference's defaults.  (a) Token identity:
    greedy (the ``lm_head`` rows tapped on both engines: bit for bit or
    the largest |Δlogit|, the tokens under the bf16 margin rule against
    tp = 1's) and temperature 0.8 / top-k 50 (equal when the logits
    are) on prompts of 17/200/480/900 tokens, 32 tokens; a prefix hit
    and a copy-on-write divergence; a self-drafted speculative batch.
    (b) A tp = 2 prefill replica hands TP_MIGRATE_LENS' requests, one at
    a time, to a tp = 1 decode replica over the HMAC wire, one stream a
    head shard, both shards' digests verified on the receiver;
    ``serve:mode=migrate``: the damaged shard rejected, the request
    decoded by the sender.  (c) Step 1 → step 2 of "swap 2 replicas"
    (SWAP_PERTURBED) pulled by a ``WeightSubscriber`` into a tp = 2
    engine: the shards' pulled bytes sum to the whole diff plus the
    replicated leaves' extra copies, and the tokens after the flip are
    step 2's.  (d) The lockstep drill: a leader ``InferenceServer(
    tp_peers=)`` and a follower ``ShardServer`` in a child process
    (``--tp-shard-worker``, ``serve:step=TP_KILL_STEP,mode=kill`` armed
    there), each driving a whole engine, behind a ``Router`` beside a
    tp = 1 survivor: TP_DRILL_REQUESTS greedy requests all complete with
    the survivor's tokens, the replica dies once (``shard_rank_lost``)
    and is benched with one strike.  Readings: tokens/s and TPOT p50 of
    TP_LOAD_REQUESTS requests at once on each engine, the peak memory.
    B1 runs only in the full-forward oracles."""
    import tempfile
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import faults
    from horovod_tpu_torch.ckpt import AsyncCheckpointer
    from horovod_tpu_torch.plan import tp_owned_slice
    from horovod_tpu_torch.runner.common.secret import make_secret_key
    from horovod_tpu_torch.serve import (ContinuousBatcher, InferenceEngine,
                                         InferenceServer, ReplicaSpec, Router,
                                         SamplingParams, WeightSubscriber)
    from horovod_tpu_torch.serve.metrics import percentile
    from horovod_tpu_torch.utils.retry import RetryPolicy

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = serve_model(dev, torch.bfloat16, TP_LAYERS)
    vocab = model.config.vocab_size
    n = SERVE_NEW_TOKENS
    limit = SERVE_MARGIN["bfloat16"]
    prompts = serve_prompts(0, SERVE_ORACLE_LENS, vocab)
    forwards = 0
    hvd.ops.reset_launch_counts()

    def oracle_of(model_, ps, k):
        nonlocal forwards
        forwards += len(ps) * k
        return serve_oracle(model_, ps, k)

    def pair(**kw):
        return (InferenceEngine(model, **SERVE_ENGINE, **kw),
                InferenceEngine(model, tp=TP_DEGREE, devices=TP_DEVICES,
                                **SERVE_ENGINE, **kw))

    def margin_check(got, want, margins, what):
        ok, cmp, stop = margin_match(got, want, margins, limit)
        if not ok:
            raise AssertionError(f"serve tp 2: {what}: tokens {got} against "
                                 f"{want} (stop {stop})")
        return cmp

    def sampled(engine):
        sp = SamplingParams(max_new_tokens=n, temperature=SERVE_TEMPERATURE,
                            top_k=SERVE_TOP_K)
        toks = {s: [engine.start(s, p, sp)] for s, p in enumerate(prompts)}
        while any(len(t) < n for t in toks.values()):
            for s, got in engine.step().items():
                toks[s].extend(got)
        for s in toks:
            engine.release(s)
        return [toks[s][:n] for s in range(len(prompts))]

    def agree(a, b):
        return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                    len(a))

    # (a) token identity.
    oracle = oracle_of(model, prompts, n)
    e1, e2 = pair()
    taps = [LogitTap(e._model) for e in (e1, e2)]
    try:
        greedy = [engine_tokens(e, prompts, n) for e in (e1, e2)]
    finally:
        for t in taps:
            t.close()
    rows = [t.rows(prompts, n) for t in taps]
    bitwise = greedy[0] == greedy[1] and all(
        torch.equal(a, b) for a, b in zip(rows[0], rows[1]))
    dlogit = 0.0
    for i in range(len(prompts)):
        j = min(agree(greedy[0][i], greedy[1][i]), n - 1) + 1
        dlogit = max(dlogit, float((rows[0][i][:j] - rows[1][i][:j])
                                   .abs().max()))
    del taps, rows
    compared = sum(margin_check(greedy[1][i], greedy[0][i], oracle[i][1],
                                f"greedy prompt {i}")
                   for i in range(len(prompts)))
    temps = [sampled(e) for e in (e1, e2)]
    temp_agree = [agree(a, b) for a, b in zip(temps[0], temps[1])]
    if bitwise and temps[0] != temps[1]:
        raise AssertionError(f"serve tp 2: bitwise logits but temperature "
                             f"tokens agree only to {temp_agree}")
    del e1, e2
    gc.collect()
    # A prefix hit, then two live requests sharing a partial tail block.
    blk = SERVE_ENGINE["kv_block"]
    pre = prompts[3][:2 * blk]
    pa, pb = pre + [1], pre + [2]
    ca = prompts[2][:blk + 4]
    cb = ca + [3]
    side = [pa, pb, ca, cb]
    side_n = 8
    side_oracle = oracle_of(model, side, side_n)
    cache_runs = []
    for eng in pair():
        a = engine_tokens(eng, [pa], side_n)[0]
        hits0 = eng.kv_stats()["kv_prefix_hits_total"]
        b = engine_tokens(eng, [pb], side_n)[0]
        hit = eng.kv_stats()["kv_prefix_hits_total"] > hits0
        x = [eng.start(0, ca, SamplingParams(max_new_tokens=side_n))]
        x.extend(eng.step()[0])
        y = [eng.start(1, cb, SamplingParams(max_new_tokens=side_n))]
        shared = eng.prefix_hit_tokens(1)
        while len(x) < side_n or len(y) < side_n:
            got = eng.step()
            x.extend(got[0])
            y.extend(got[1])
        cow = eng.kv_stats()["kv_cow_copies_total"]
        eng.release(0)
        eng.release(1)
        if not hit or shared != len(ca) or cow < 1:
            raise AssertionError(
                f"serve tp 2: tp={eng.tp}: prefix hit {hit}, shared "
                f"{shared} of {len(ca)} tokens, {cow} copy-on-write copies")
        cache_runs.append((a, b, x[:side_n], y[:side_n], cow))
        del eng
        gc.collect()
    compared += sum(margin_check(cache_runs[1][i], cache_runs[0][i],
                                 side_oracle[i][1], f"prefix/COW {i}")
                    for i in range(4))
    # A self-drafted speculative batch.
    spec_runs, accept = [], []
    for eng in pair(drafter=model, spec_k=SERVE_SPEC_K):
        spec_runs.append(engine_tokens(eng, prompts, n, spec=True))
        accept.append(eng.kv_stats()["spec_accept_per_verify"])
        del eng
        gc.collect()
    compared += sum(margin_check(spec_runs[1][i], spec_runs[0][i],
                                 oracle[i][1], f"speculative prompt {i}")
                    for i in range(len(prompts)))
    log(f"serve tp 2: (a) logits bit for bit tp=1's: {bitwise} (largest "
        f"|dlogit| {dlogit} over the greedy rows); greedy, prefix hit + "
        f"copy-on-write ({cache_runs[1][4]} copies) and speculative tokens "
        f"equal tp=1's at {compared} positions past the bf16 margin; "
        f"temperature {SERVE_TEMPERATURE} / top-k {SERVE_TOP_K} tokens "
        f"agree for {temp_agree} of {n} positions; tokens a verify "
        f"{accept[0]} (tp=1) / {accept[1]} (tp=2)")

    # (b) per-shard migration, tp=2 prefill -> tp=1 decode.
    key = make_secret_key()
    policy = RetryPolicy(attempts=8, base_delay_s=0.02, max_delay_s=0.2)
    # The last prompt, fresh to the prefix directory, is the drill's.
    mig_prompts = serve_prompts(4, TP_MIGRATE_LENS + TP_MIGRATE_LENS[:1],
                                vocab)
    mig_oracle = oracle_of(model, mig_prompts, n)
    want = engine_tokens(InferenceEngine(model, **SERVE_ENGINE),
                         mig_prompts, n)
    gc.collect()

    def spec_of(s):
        return ReplicaSpec(s.name, [("127.0.0.1", s.port)], role=s.role)

    pre_s = InferenceServer(
        ContinuousBatcher(InferenceEngine(model, tp=TP_DEGREE,
                                          devices=TP_DEVICES,
                                          **SERVE_ENGINE),
                          default_deadline_s=0, role="prefill"),
        key=key, name="tp-pre", host="127.0.0.1")
    dec_s = InferenceServer(
        ContinuousBatcher(InferenceEngine(model, **SERVE_ENGINE),
                          default_deadline_s=0, role="decode"),
        key=key, name="tp-dec", host="127.0.0.1")
    tap = MigrationTap(dec_s)
    shards_seen = []
    add = dec_s._migrations.add

    def seen(frame):
        shards_seen.append((frame.shard, frame.n_shards,
                            None if frame.manifest is None
                            else frame.manifest.get("tp_degree")))
        return add(frame)

    dec_s._migrations.add = seen
    try:
        router = Router([spec_of(pre_s), spec_of(dec_s)], key,
                        retry_policy=policy)
        mig = []
        for i, p in enumerate(mig_prompts[:-1]):
            resp = router.generate(p, max_new_tokens=n,
                                   request_id=f"tp-mig-{i}")
            if resp.error is not None or resp.migrated_to != "tp-dec":
                raise AssertionError(f"serve tp 2: migration {i}: "
                                     f"{resp.error}, {resp.migrated_to}")
            compared += margin_check(resp.tokens, want[i], mig_oracle[i][1],
                                     f"migrated request {i}")
            mig.append(resp.migrate_ms)
        firsts = [s for s in shards_seen if s[2] is not None]
        if tap.verified != len(mig) or tap.rejected \
                or sorted({s[:2] for s in shards_seen}) != [(0, 2), (1, 2)] \
                or len(firsts) != 2 * len(mig) \
                or any(s[2] != TP_DEGREE for s in firsts):
            raise AssertionError(
                f"serve tp 2: {tap.verified} transfers verified, "
                f"{tap.rejected} rejected, frames {sorted(set(shards_seen))}")
        alone = TP_MIGRATE_LENS.index(TP_ALONE_LEN)
        with faults.inject("serve:step=0,mode=migrate"):
            bad = router.generate(mig_prompts[-1], max_new_tokens=n,
                                  request_id="tp-mig-bad")
            fired = [h for h in faults.history() if h[0] == "serve"]
        if fired != [("serve", 0, "migrate")] or tap.rejected != 1 \
                or bad.error is not None or bad.migrated_to is not None:
            raise AssertionError(
                f"serve tp 2: migrate drill: fired {fired}, "
                f"{tap.rejected} rejected, {bad.error}, {bad.migrated_to}")
        compared += margin_check(bad.tokens, want[-1], mig_oracle[-1][1],
                                 "migrate drill")
    finally:
        pre_s.shutdown()
        dec_s.shutdown()
        gc.collect()
    log(f"serve tp 2: (b) {len(mig)} requests ({TP_MIGRATE_LENS} "
        f"tokens) migrated tp=2 -> tp=1 one at a time, two shard streams "
        f"each, every transfer's shard digests verified; migrate_ms {mig} "
        f"for {tap.bytes} bytes ({TP_ALONE_LEN} tokens: {mig[alone]} ms for "
        f"{tap.bytes[alone]} bytes); serve:mode=migrate rejected on the "
        f"receiver, decoded by the sender")

    # (c) the swap's shard pull into a tp=2 engine.
    boot = {k: p.detach() for k, p in model.named_parameters()}
    step2 = swap_step2(boot, dev)
    swap_prompts = serve_prompts(3, SWAP_PROMPT_LENS, vocab)[:TP_SWAP_PROMPTS]
    m2 = serve_model(dev, torch.bfloat16, TP_LAYERS)
    with torch.no_grad():
        for k, p in m2.named_parameters():
            p.copy_(step2[k])
    swap_oracle = oracle_of(m2, swap_prompts, n)
    swap_want = engine_tokens(InferenceEngine(m2, **SERVE_ENGINE),
                              swap_prompts, n)
    del m2
    gc.collect()
    full = sum(step2[k].numel() * step2[k].element_size()
               for k in SWAP_PERTURBED)
    extra = sum((TP_DEGREE - 1) * step2[k].numel() * step2[k].element_size()
                for k in SWAP_PERTURBED
                if tp_owned_slice(k, tuple(step2[k].shape), TP_DEGREE, 0)
                is None)
    with tempfile.TemporaryDirectory() as store_dir:
        with AsyncCheckpointer(store_dir, world=1, scheme="dp",
                               async_save=False) as ckpt:
            for step, tree in ((1, boot), (2, step2)):
                ckpt.save(step, tree)
                ckpt.journal_step(step)
        del step2
        engine = InferenceEngine(model, tp=TP_DEGREE, devices=TP_DEVICES,
                                 weights_version=1, **SERVE_ENGINE)
        batcher = ContinuousBatcher(engine, default_deadline_s=0)
        batcher.start()
        try:
            sub = WeightSubscriber(batcher, store_dir, deadline_s=300.0)
            flipped = sub.poll_once()
            last = dict(sub.last_swap)
            reqs = [batcher.submit(p, SamplingParams(max_new_tokens=n))
                    for p in swap_prompts]
            for r in reqs:
                if not r.done.wait(timeout=300) or r.error is not None:
                    raise AssertionError(f"serve tp 2: post-swap request: "
                                         f"{r.error}")
        finally:
            batcher.stop()
        del engine, batcher
        gc.collect()
    per_shard = last.get("pulled_bytes_per_shard") or []
    if flipped != 2 or last.get("tp") != TP_DEGREE \
            or last["pulled_leaves"] != len(SWAP_PERTURBED) \
            or last["pulled_bytes_full"] != full \
            or sum(per_shard) != full + extra \
            or last["pulled_bytes"] != max(per_shard):
        raise AssertionError(f"serve tp 2: swap pull {last} (want full "
                             f"{full}, replicated extra {extra})")
    compared += sum(margin_check(r.tokens, swap_want[i], swap_oracle[i][1],
                                 f"post-swap request {i}")
                    for i, r in enumerate(reqs))
    log(f"serve tp 2: (c) step 1 -> 2 pulled by shard: "
        f"{last['pulled_bytes_per_shard']} bytes a shard, sum "
        f"{sum(per_shard)} = the whole diff {full} + replicated extra "
        f"{extra}, pulled_bytes (the widest shard) {last['pulled_bytes']}; "
        f"pull, stage and flip {last['ms']} ms; tokens after the flip step "
        f"2's")

    # (d) the lockstep drill: the follower in a child process, started
    # first so that its start-up overlaps the drill's oracle.
    drill = [[i + 1, i + 2, i + 3] for i in range(TP_DRILL_REQUESTS)]
    script = os.path.abspath(__file__)
    servers = []
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "key"), "wb") as f:
            f.write(key)
        proc = subprocess.Popen([sys.executable, script, TP_SHARD_FLAG, tmp])
        try:
            drill_oracle = oracle_of(model, drill, TP_DRILL_TOKENS)
            ref = InferenceEngine(model, **SERVE_ENGINE)
            solo_want = [engine_tokens(ref, [p], TP_DRILL_TOKENS)[0]
                         for p in drill]
            del ref
            gc.collect()
            deadline = time.monotonic() + 600
            while not os.path.exists(os.path.join(tmp, "port")):
                if proc.poll() is not None or time.monotonic() > deadline:
                    raise AssertionError(f"serve tp 2: the follower shard "
                                         f"never served (exit "
                                         f"{proc.returncode})")
                time.sleep(0.2)
            with open(os.path.join(tmp, "port")) as f:
                port = int(f.read())
            leader = InferenceServer(
                ContinuousBatcher(InferenceEngine(model, **SERVE_ENGINE),
                                  default_deadline_s=0),
                key=key, name="tp-leader", host="127.0.0.1",
                tp_peers=[("tp-shard-1", [("127.0.0.1", port)])])
            servers.append(leader)
            solo = InferenceServer(
                ContinuousBatcher(InferenceEngine(model, **SERVE_ENGINE),
                                  default_deadline_s=0),
                key=key, name="tp-solo", host="127.0.0.1")
            servers.append(solo)
            router = Router([spec_of(leader), spec_of(solo)], key,
                            probation_s=300.0,
                            retry_policy=RetryPolicy(attempts=10,
                                                     base_delay_s=0.05,
                                                     max_delay_s=0.5))
            t1 = time.perf_counter()
            answers = []
            for i, p in enumerate(drill):
                resp = router.generate(p, max_new_tokens=TP_DRILL_TOKENS,
                                       request_id=f"tp-drill-{i}")
                if resp.error is not None \
                        or len(resp.tokens) != TP_DRILL_TOKENS:
                    raise AssertionError(f"serve tp 2: drill request {i}: "
                                         f"{resp.error}")
                answers.append(resp.tokens)
            drill_s = time.perf_counter() - t1
            stats = router.replica_stats()
            benched = sorted(k for k, v in stats.items() if not v["healthy"])
            reason = leader._batcher._killed or ""
            dead = (leader.dead, solo.dead)
            with open(os.path.join(tmp, "done"), "w") as f:
                f.write("ok")
            proc.wait(timeout=120)
            with open(os.path.join(tmp, "shard.json")) as f:
                shard = json.load(f)
        finally:
            for s in servers:
                s.shutdown()
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    if proc.returncode or shard["history"] != [["serve", TP_KILL_STEP,
                                                "kill"]] \
            or dead != (True, False) \
            or not reason.startswith("shard_rank_lost") \
            or benched != ["tp-leader"]:
        raise AssertionError(
            f"serve tp 2: drill: follower exit {proc.returncode}, history "
            f"{shard['history']}, leader and survivor dead {dead} "
            f"({reason}), benched {benched}")
    compared += sum(margin_check(a, solo_want[i], drill_oracle[i][1],
                                 f"drill request {i}")
                    for i, a in enumerate(answers))
    counts = hvd.ops.launch_counts()
    want_b1 = forwards * TP_LAYERS
    if counts["flash_fwd"] != want_b1 or any(
            v for k, v in counts.items() if k != "flash_fwd"):
        raise AssertionError(f"serve tp 2: launches {counts}; the oracles' "
                             f"{forwards} forwards want flash_fwd {want_b1}")
    log(f"serve tp 2: (d) lockstep drill: follower killed at its decode "
        f"event {TP_KILL_STEP} ({shard['dead']}), the replica died once "
        f"({reason.split(':')[0]}), benched {benched} with one strike, all "
        f"{TP_DRILL_REQUESTS} requests answered by the survivor in "
        f"{drill_s:.3f} s with its tokens")

    # Readings: TP_LOAD_REQUESTS requests at once on each engine.
    load = serve_prompts(5, [TP_LOAD_PROMPT] * TP_LOAD_REQUESTS, vocab)
    speed = {}
    for eng in pair():
        b = ContinuousBatcher(eng, default_deadline_s=0)
        reqs = [b.submit(p, SamplingParams(max_new_tokens=n)) for p in load]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        while not all(r.done.is_set() for r in reqs):
            b.step()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        snap = b.snapshot()
        speed[eng.tp] = dict(tok_per_s=sum(len(r.tokens) for r in reqs)
                             / secs, tpot_ms_p50=snap["tpot_ms_p50"],
                             ttft_ms_p50=snap["ttft_ms_p50"], seconds=secs)
        del b, eng, reqs
        gc.collect()
    peak = torch.cuda.max_memory_allocated()
    seconds = time.perf_counter() - t0
    report = dict(seconds=seconds, bitwise=bitwise, dlogit=dlogit,
                  compared=compared, temp_agree=temp_agree,
                  spec_accept=accept, migrate_ms=mig, migrate_bytes=tap.bytes,
                  alone_ms=mig[alone], alone_bytes=tap.bytes[alone],
                  swap=last, drill_s=drill_s, speed=speed,
                  peak_gib=peak / 2**30)
    log(f"serve tp 2: {TP_LOAD_REQUESTS} requests of {TP_LOAD_PROMPT} "
        f"tokens at once: tp=1 {speed[1]['tok_per_s']:.1f} tokens/s, TPOT "
        f"p50 {speed[1]['tpot_ms_p50']} ms; tp=2 (two shards on one card) "
        f"{speed[2]['tok_per_s']:.1f} tokens/s, TPOT p50 "
        f"{speed[2]['tpot_ms_p50']} ms; peak {report['peak_gib']:.2f} GiB; "
        f"{seconds:.1f} s in all; launches {counts} (the oracles' "
        f"{forwards} forwards); on {card}")
    del model
    torch.cuda.empty_cache()
    return counts, report


# --- "fleet sim (host)": the fleet simulator on this run's readings -----------

SIM_CAPACITY = dict(replicas=1000, requests=10_000, rate_rps=2000.0, seed=1,
                    fault="serve:p=0.001,seed=2,mode=kill", wall_s=60.0)
SIM_CALIBRATION = dict(replicas=4, requests=2000, rate_rps=5.0, seed=13,
                       band=0.15)
SIM_DRILL_ROUNDS = 3
SIM_CLEAN_SEEDS = (1, 2, 4)
SIM_READINGS_ENV = "CHIP_SMOKE_SIM_READINGS"


def sim_ranks(dev, rank: int) -> dict:
    """Path "fleet sim (host)" in a process of its own
    (``--sim-worker``); the earlier phases' readings arrive as JSON in
    ``CHIP_SMOKE_SIM_READINGS``."""
    counts, report = sim_phase(card_and_power_limit(),
                               json.loads(os.environ[SIM_READINGS_ENV]))
    return dict(counts=counts, report=report)


def sim_profile(readings: dict):
    """A ``ReplicaProfile`` fitted by ``LatencyDist`` from this run's
    readings: TTFT and TPOT p50/p99 of "serve 1 rank"'s traffic and
    ``migrate_ms`` mean/p99 of "fleet 3 replicas", at GPT-medium's 24
    layers; the swap ms of "swap 2 replicas" (mean and largest, as
    ``load_profile`` fits its swap), which runs at SWAP_LAYERS (8)."""
    from horovod_tpu_torch.serve.fleet.traces import (LatencyDist,
                                                      ReplicaProfile)

    return ReplicaProfile(
        ttft_ms=LatencyDist(readings["ttft_ms_p50"],
                            readings["ttft_ms_p99"]),
        tpot_ms=LatencyDist(readings["tpot_ms_p50"],
                            readings["tpot_ms_p99"]),
        migrate_ms=LatencyDist.from_mean_p99(readings["migrate_ms_mean"],
                                             readings["migrate_ms_p99"]),
        swap_ms=LatencyDist.from_mean_p99(statistics.mean(readings["swap_ms"]),
                                          max(readings["swap_ms"])),
        source=(f"chip_smoke: serve 1 rank, fleet 3 replicas (24 layers), "
                f"swap 2 replicas ({SWAP_LAYERS} layers)"))


def sim_phase(card: str, readings: dict):
    """Path "fleet sim (host)": the port's ``FleetSim`` (the real router,
    fleet controller, QoS gate and queues on a virtual clock; no device
    work).  Capacity: SIM_CAPACITY's 1000 replicas and 10^4 requests
    under ``serve:p=0.001,mode=kill``: no invariant violated, at least
    one kill, under 60 s of wall time.  Calibration: an unloaded
    4-replica run on :func:`sim_profile` (this run's card readings) must
    give TTFT p50 and p99 within ±15% of the profile's: a check of the
    simulator's fit to its profile, not of the card.  Drills: the
    death spiral (``control:mode=spiral``) and the migration convoy
    (``control:mode=convoy``) page within SIM_DRILL_ROUNDS collection
    rounds of their onset; clean seeded runs raise no alert."""
    import logging
    import math
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.serve.fleet.sim import FleetSim
    from horovod_tpu_torch.serve.fleet.traces import (LatencyDist,
                                                      ReplicaProfile,
                                                      make_trace)

    t0 = time.perf_counter()
    hvd.ops.reset_launch_counts()
    logging.disable(logging.WARNING)     # strikes and brownout, by the 1000
    try:
        cap = SIM_CAPACITY
        t1 = time.perf_counter()
        sim = FleetSim(replicas=cap["replicas"], seed=cap["seed"],
                       max_replicas=cap["replicas"], record_events=False)
        rep = sim.run(make_trace(cap["requests"], seed=cap["seed"],
                                 rate_rps=cap["rate_rps"]),
                      fault_spec=cap["fault"])
        wall = time.perf_counter() - t1
        capacity = dict(wall_s=wall, events=rep["events"],
                        events_per_s=rep["events"] / wall,
                        kills=rep["kills"], delivered=rep["delivered"],
                        violations=rep["invariants"]["violations_total"],
                        checks=rep["invariants"]["checks_total"])
        if wall >= cap["wall_s"] or rep["kills"] < 1 \
                or capacity["violations"] or rep["requests"] != \
                cap["requests"]:
            raise AssertionError(f"fleet sim (host): capacity {capacity}")
        prof = sim_profile(readings)
        cal = SIM_CALIBRATION
        sim = FleetSim(replicas=cal["replicas"], seed=cal["seed"],
                       profile=prof, scale_in_idle_s=1e9)
        rep = sim.run(make_trace(cal["requests"], seed=cal["seed"],
                                 rate_rps=cal["rate_rps"], burst_factor=1.0))
        calibration = dict(
            profile={f: [getattr(prof, f).p50_ms, getattr(prof, f).p99_ms]
                     for f in ("ttft_ms", "tpot_ms", "migrate_ms",
                               "swap_ms")},
            ttft_ms_p50=rep["ttft_ms_p50"], ttft_ms_p99=rep["ttft_ms_p99"])
        off = [abs(got - want) / want
               for got, want in ((rep["ttft_ms_p50"], prof.ttft_ms.p50_ms),
                                 (rep["ttft_ms_p99"], prof.ttft_ms.p99_ms))]
        calibration["off"] = off
        if rep["shed"] or rep["expired"] or max(off) >= cal["band"]:
            raise AssertionError(f"fleet sim (host): calibration "
                                 f"{calibration}, shed {rep['shed']}, "
                                 f"expired {rep['expired']}")

        def rounds_to_fire(alerts, onset, alert_id):
            fired = [a for a in alerts if a["alert"] == alert_id]
            if not fired:
                return None
            return max(1, math.ceil(fired[0]["t"] - onset))

        sim = FleetSim(replicas=4, seed=3, max_slots=2, queue_capacity=16,
                       brownout_high=0.5, brownout_low=0.2,
                       brownout_hold_s=10.0, scale_in_idle_s=1.0,
                       record_events=False)
        sim.attach_telemetry()
        rep = sim.run(make_trace(2000, seed=3, rate_rps=120.0,
                                 burst_factor=6.0),
                      fault_spec="control:p=1.0,seed=1,mode=spiral")
        spiral = rounds_to_fire(sim.alerts, rep["spiral_onset_t"],
                                "ladder_oscillation")
        pages = [a for a in sim.alerts if a["alert"] == "ladder_oscillation"]
        prof_convoy = ReplicaProfile(
            ttft_ms=LatencyDist(80.0, 300.0), tpot_ms=LatencyDist(30.0, 60.0),
            migrate_ms=LatencyDist(2500.0, 5000.0),
            swap_ms=LatencyDist(950.0, 3600.0))
        sim = FleetSim(roles={"prefill": 4, "decode": 4}, seed=5,
                       max_slots=4, profile=prof_convoy, convoy_bound=8,
                       record_events=False)
        sim.attach_telemetry(detect_overrides={"convoy_bound": 8.0})
        rep = sim.run(make_trace(1200, seed=5, rate_rps=150.0,
                                 prefix_pool=4096, prefix_skew=1.0,
                                 max_new_tokens=128),
                      fault_spec="control:p=1.0,seed=2,mode=convoy")
        onsets = [v["t"] for v in rep["invariants"]["violations"]
                  if v["invariant"] == "no_migration_convoy"]
        convoy = (rounds_to_fire(sim.alerts, min(onsets), "migration_convoy")
                  if onsets else None)
        clean = {}
        for seed in SIM_CLEAN_SEEDS:
            sim = FleetSim(replicas=6, seed=seed, record_events=False)
            sim.attach_telemetry()
            rep = sim.run(make_trace(300, seed=seed, rate_rps=40.0))
            clean[seed] = (rep["alerts_fired"],
                           rep["invariants"]["violations_total"])
        if spiral is None or spiral > SIM_DRILL_ROUNDS \
                or pages[0]["severity"] != "page" \
                or convoy is None or convoy > SIM_DRILL_ROUNDS \
                or any(a or v for a, v in clean.values()):
            raise AssertionError(
                f"fleet sim (host): drills: spiral paged in {spiral} "
                f"rounds, convoy in {convoy}, clean runs {clean}")
    finally:
        logging.disable(logging.NOTSET)
    counts = hvd.ops.launch_counts()
    seconds = time.perf_counter() - t0
    report = dict(seconds=seconds, capacity=capacity,
                  calibration=calibration, spiral_rounds=spiral,
                  convoy_rounds=convoy)
    log(f"fleet sim (host): capacity {cap['replicas']} replicas, "
        f"{cap['requests']} requests at {cap['rate_rps']} rps under "
        f"{cap['fault']}: {capacity['events']} events in "
        f"{capacity['wall_s']:.3f} s of wall time "
        f"({capacity['events_per_s']:.1f} events/s), {capacity['kills']} "
        f"kills, {capacity['delivered']} delivered, 0 of "
        f"{capacity['checks']} invariant checks violated; calibration (the "
        f"sim's fit to its profile, not a check of the card) on this run's "
        f"profile {calibration['profile']} (TTFT, TPOT, migrate_ms at 24 "
        f"layers, swap_ms at {SWAP_LAYERS}): TTFT p50 "
        f"{calibration['ttft_ms_p50']} ms p99 {calibration['ttft_ms_p99']} "
        f"ms, off by {[round(x, 4) for x in off]} (band "
        f"{SIM_CALIBRATION['band']}); death spiral paged in {spiral} "
        f"round(s), migration convoy in {convoy}, clean seeds "
        f"{list(SIM_CLEAN_SEEDS)} silent; {seconds:.1f} s in all, no device "
        f"work (launches {counts}); readings of {card}")
    return counts, report


# --- the analysis tier: hvdlint, the step recorder, hvdsan -------------------

SANITIZE_LAYERS = 4                  # GPT-medium's widths, cut to 4 layers
SANITIZE_PROMPT = 64                 # tokens a prompt, every request
SANITIZE_BATCH_TOKENS = 96           # the two batch requests' generations
SANITIZE_NEW_TOKENS = 32             # every other request's
SANITIZE_CANCEL_TOKENS = 200         # the request cancelled while queued
SANITIZE_ENV = {"HVD_TPU_SANITIZE": "raise"}


def hvdlint_phase() -> dict:
    """Path "hvdlint (host)": ``horovod_tpu_torch.analysis.run()`` over
    this checkout must give 0 unsuppressed findings, and the kernel check
    must see all eight ``@kernel`` wrappers.  Prints the seconds, the
    checkers and check ids run and the modules read."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import analysis
    from horovod_tpu_torch.analysis import kernels as lint_kernels

    t0 = time.perf_counter()
    findings = analysis.run()
    seconds = time.perf_counter() - t0
    if findings:
        raise AssertionError(
            f"hvdlint (host): {len(findings)} unsuppressed finding(s):\n"
            + "\n".join(f.format() for f in findings))
    wrappers = lint_kernels.kernel_wrappers()
    if sorted(wrappers) != sorted(hvd.ops.launch_counts()):
        raise AssertionError(
            f"hvdlint (host): the kernel check sees {sorted(wrappers)}, "
            f"the package registers {sorted(hvd.ops.launch_counts())}")
    checkers = analysis.default_checkers()
    ids = sorted({c for k in checkers for c in k.checks})
    modules = len(analysis.iter_source_files(
        analysis.LintConfig(root=analysis.repo_root())))
    log(f"hvdlint (host): 0 findings from {len(checkers)} checkers "
        f"({len(ids)} check ids) over {modules} modules in {seconds:.3f} s "
        f"on this host; the kernel check sees the {len(wrappers)} wrappers "
        f"{sorted(wrappers)}")
    bindings_on_host()
    return dict(seconds=seconds, checkers=len(checkers), checks=len(ids),
                modules=modules)


def bindings_on_host() -> None:
    """Part of "hvdlint (host)", a statement of what the card's host has,
    not a fallback: ``import horovod_tpu_torch.torch`` works; without
    tensorflow, ``import horovod_tpu_torch.tensorflow`` (and ``.keras``)
    raises an ``ImportError`` naming it, and without mxnet ``import
    horovod_tpu_torch.mxnet`` one naming mxnet (the CPU tests hold those
    bindings); ``.spark`` and ``.ray`` import, their ``FilesystemStore``
    and placement math work, and ``spark.run`` / ``RayExecutor.start``
    raise naming pyspark / ray until a stand-in is registered."""
    import importlib
    import importlib.util
    import tempfile

    binding = importlib.import_module("horovod_tpu_torch.torch")
    if not (binding.DistributedOptimizer and binding.SyncBatchNorm):
        raise AssertionError("hvdlint (host): horovod_tpu_torch.torch "
                             "lacks its optimizer or SyncBatchNorm")
    absent = {}
    for package, modules in (
            ("tensorflow", ("horovod_tpu_torch.tensorflow",
                            "horovod_tpu_torch.keras")),
            ("mxnet", ("horovod_tpu_torch.mxnet",))):
        if importlib.util.find_spec(package) is not None:
            for name in modules:
                importlib.import_module(name)
            continue
        absent[package] = modules
        for name in modules:
            try:
                importlib.import_module(name)
            except ImportError as e:
                if package not in str(e):
                    raise AssertionError(f"hvdlint (host): import {name}: "
                                         f"{e}")
            else:
                raise AssertionError(f"hvdlint (host): {name} imported on "
                                     f"a host without {package}")
    from horovod_tpu_torch import spark
    from horovod_tpu_torch.ray import RayExecutor, strategy

    with tempfile.TemporaryDirectory() as tmp:
        store = spark.FilesystemStore(tmp)
        path = os.path.join(store.get_checkpoint_path("r"), "x.pkl")
        store.write_serialized(path, {"a": 1})
        if store.read_serialized(path) != {"a": 1}:
            raise AssertionError("hvdlint (host): FilesystemStore round "
                                 "trip")
    bundles = strategy.pack_bundles(3, 2, 1, 2)
    if bundles != [{"CPU": 4, "GPU": 2}, {"CPU": 2, "GPU": 1}] \
            or strategy.ranks_per_bundle(3, bundles, 2) != [[0, 1], [2]]:
        raise AssertionError(f"hvdlint (host): pack_bundles {bundles}")
    gated = []
    for package, call in (
            ("pyspark", lambda: spark.run(print, num_proc=2)),
            ("ray", lambda: RayExecutor(num_workers=2).start())):
        if importlib.util.find_spec(package) is not None:
            continue
        try:
            call()
        except ImportError as e:
            if package not in str(e):
                raise AssertionError(f"hvdlint (host): {package}: {e}")
        else:
            raise AssertionError(f"hvdlint (host): {package} not required")
        gated.append(package)
    log(f"bindings (host): horovod_tpu_torch.torch, .spark and .ray import "
        f"(FilesystemStore and the placement math work); this host lacks "
        f"{sorted(absent)}, so "
        f"{sorted(m for ms in absent.values() for m in ms)} raise "
        f"ImportError naming them (the CPU tests hold those bindings), and "
        f"without {gated} spark.run / RayExecutor.start raise naming them "
        f"(their paths run below over the stand-ins)")


def recorded_sequences(path: str, seqs: list, what: str,
                       microbatches: int = 0, buckets: int = 0,
                       compression: str = "none") -> None:
    """The step recorder's gate on a multi-rank path: every rank's
    recorded collectives (``analysis.step_check.record_collectives``)
    equal rank 0's and, with ``microbatches``, the overlap wire's
    reduce-scatter and all-gather phases the planner's ``buckets``.
    Logs the length and the ops of rank 0's sequence."""
    import collections
    from horovod_tpu_torch.analysis import step_check

    findings = step_check.compare_sequences(
        seqs, path="chip_smoke.py", what=f"{path}: {what}")
    if microbatches:
        findings += step_check.planner_findings(
            [tuple(e) for e in seqs[0]], microbatches=microbatches,
            n_buckets=buckets, compression=compression,
            what=f"{path}: {what}")
    if findings or not seqs[0]:
        raise AssertionError(f"{path}: the step recorder: "
                             + ("; ".join(f.message for f in findings)
                                or "no collective recorded"))
    ops = dict(collections.Counter(e[0] for e in seqs[0]))
    extra = ""
    if microbatches:
        rs, ag = step_check.wire_counts(seqs[0], compression)
        extra = (f"; {rs} reduce-scatter and {ag} all-gather phases = "
                 f"{microbatches} microbatches x {buckets} buckets and "
                 f"{buckets}, the planner's")
    log(f"{path}: {what} recorded {[len(q) for q in seqs]} collectives "
        f"per rank, equal on every rank ({ops}){extra}")


def sanitize_traffic(model, key: bytes) -> dict:
    """"sanitize serve 1 rank"'s traffic: an ``InferenceServer`` on the
    paged engine (two slots) and the batcher with QoS (a 1 ms interactive
    TTFT SLO, so an interactive arrival preempts a batch generation) over
    the HMAC wire, 8 requests of SANITIZE_PROMPT tokens: two batch ones,
    an interactive one that preempts one of them, one cancelled while
    queued, four standard ones at once.  Returns the responses' tokens
    and errors, the preemption count and the seconds."""
    import concurrent.futures
    from horovod_tpu_torch.runner.common.network import BasicClient
    from horovod_tpu_torch.serve import (ContinuousBatcher, InferenceEngine,
                                         InferenceServer)
    from horovod_tpu_torch.serve.server import (CancelRequest,
                                                GenerateRequest)

    prompts = serve_prompts(11, (SANITIZE_PROMPT,) * 8,
                            model.config.vocab_size)
    engine = InferenceEngine(model, max_slots=2, prefill_buckets=(64, 256),
                             kv_cache="paged")
    batcher = ContinuousBatcher(engine, default_deadline_s=0,
                                qos_slo_ttft_ms=1.0)
    server = InferenceServer(batcher, key, name="sanitize", host="127.0.0.1")

    def client():
        return BasicClient("sanitize", [("127.0.0.1", server.port)], key)

    def gen(i: int, n: int, qos: str):
        return client().request(GenerateRequest(
            f"san-{i}", prompts[i], max_new_tokens=n, qos_class=qos),
            timeout=300.0)

    def wait_until(cond, what: str) -> None:
        deadline = time.monotonic() + 60.0
        while not cond(batcher.snapshot()):
            if time.monotonic() > deadline:
                raise AssertionError(f"sanitize serve 1 rank: no {what} "
                                     f"within 60 s: {batcher.snapshot()}")
            time.sleep(0.002)

    plan = ([(0, SANITIZE_BATCH_TOKENS, "batch"),
             (1, SANITIZE_BATCH_TOKENS, "batch")],
            (2, SANITIZE_NEW_TOKENS, "interactive"),
            (3, SANITIZE_CANCEL_TOKENS, "standard"),
            [(i, SANITIZE_NEW_TOKENS, "standard") for i in range(4, 8)])
    try:
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            futs = {i: pool.submit(gen, i, n, q) for i, n, q in plan[0]}
            wait_until(lambda s: s["active_slots"] == 2, "two active slots")
            i, n, q = plan[1]
            futs[i] = pool.submit(gen, i, n, q)
            futs[i].result(timeout=300.0)
            i, n, q = plan[2]
            futs[i] = pool.submit(gen, i, n, q)
            wait_until(lambda s: s["queue_depth"] >= 1, "queued request")
            client().request(CancelRequest(f"san-{i}"), timeout=60.0)
            for i, n, q in plan[3]:
                futs[i] = pool.submit(gen, i, n, q)
            resps = {i: f.result(timeout=300.0) for i, f in futs.items()}
        seconds = time.perf_counter() - t0
        stats = batcher.stats.snapshot()
    finally:
        server.shutdown()
    want = {i: n for i, n, _ in plan[0] + [plan[1]] + plan[3]}
    bad = [(i, r.error, len(r.tokens or [])) for i, r in resps.items()
           if (i in want and (r.error is not None
                              or len(r.tokens or []) != want[i]))
           or (i == plan[2][0] and r.error != "cancelled")]
    if bad or stats.get("preemptions") != 1:
        from horovod_tpu_torch.analysis import sanitizer

        raise AssertionError(
            f"sanitize serve 1 rank: requests {bad}, "
            f"{stats.get('preemptions')} preemptions (want 1), violations "
            f"{sanitizer.violations()}")
    tokens = sum(len(r.tokens or []) for r in resps.values())
    return dict(seconds=seconds, tokens=tokens, tok_s=tokens / seconds,
                engine=engine)


def sanitize_ranks(dev, rank: int) -> dict:
    """Path "sanitize serve 1 rank", in a process of its own
    (``--sanitize-worker``) started with ``HVD_TPU_SANITIZE=raise`` in its
    environment: ``sanitizer.install()`` over the package, then GPT-medium's
    widths at SANITIZE_LAYERS layers (bf16 activations, f32 parameters
    from seed 0) through :func:`sanitize_traffic` and one
    ``AsyncCheckpointer`` save of its parameters (so a ``BufferPool``
    registers).  Gates: no violation, and ``audit_check`` finds no KV
    block, buffer set or elastic slot held.  Then, printed and not gated,
    the same traffic warm, once instrumented and once after
    ``uninstall()``: tokens/s with the sanitizer on against off."""
    import tempfile
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.analysis import sanitizer
    from horovod_tpu_torch.ckpt import AsyncCheckpointer
    from horovod_tpu_torch.runner.common.secret import make_secret_key

    if sanitizer.mode() != "raise":
        raise AssertionError(f"sanitize serve 1 rank: sanitizer mode "
                             f"{sanitizer.mode()!r}, want 'raise'")
    t0 = time.perf_counter()
    stats = sanitizer.install()
    if not stats["installed"] or stats["skipped"]:
        raise AssertionError(f"sanitize serve 1 rank: install {stats}")
    model = serve_model(dev, torch.bfloat16, n_layer=SANITIZE_LAYERS)
    key = make_secret_key()
    hvd.ops.reset_launch_counts()
    gated = sanitize_traffic(model, key)
    counts = hvd.ops.launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        ck = AsyncCheckpointer(tmp, world=1, rank=0, async_save=True,
                               max_to_keep=1)
        t1 = time.perf_counter()
        ck.save(1, {n: p for n, p in model.named_parameters()})
        ck.wait_until_finished()
        save_s = time.perf_counter() - t1
        saved = ck._store.read_manifest(1).nbytes
        kinds = sanitizer.registered()
        leaks = sanitizer.audit_check(record=False)
        ck.close()
    del gated["engine"]
    violations = sanitizer.violations()
    if violations or leaks or not {"kv_pool", "buffer_pool"} <= set(kinds):
        raise AssertionError(
            f"sanitize serve 1 rank: violations {violations}, leaks {leaks}, "
            f"registered {kinds}")
    # The readings: the same traffic again, warm, instrumented and then
    # not (the gated run above is the process's first and pays its
    # warm-up).
    on = sanitize_traffic(model, key)
    del on["engine"]
    if sanitizer.violations():
        raise AssertionError(f"sanitize serve 1 rank: violations "
                             f"{sanitizer.violations()}")
    sanitizer.uninstall()
    off = sanitize_traffic(model, key)
    del off["engine"]
    seconds = time.perf_counter() - t0
    log(f"sanitize serve 1 rank: {stats['attributes']} guarded attributes "
        f"on {stats['classes']} classes in {stats['modules']} modules "
        f"instrumented (mode raise); GPT-medium's widths at "
        f"{SANITIZE_LAYERS} layers, bf16: 8 requests of {SANITIZE_PROMPT} "
        f"tokens through the server, the batcher, QoS and the paged engine "
        f"(one preempted, one cancelled), {gated['tokens']} tokens in "
        f"{gated['seconds']:.3f} s, the process's first; one "
        f"AsyncCheckpointer save of {saved} bytes in {save_s:.3f} s; 0 "
        f"violations, no resource held at audit (watching {kinds}); the "
        f"same traffic warm, instrumented, {on['tokens']} tokens in "
        f"{on['seconds']:.3f} s ({on['tok_s']:.1f} tokens/s), after "
        f"uninstall {off['tokens']} tokens in {off['seconds']:.3f} s "
        f"({off['tok_s']:.1f} tokens/s): on/off "
        f"{on['tok_s'] / off['tok_s']:.3f}; {seconds:.1f} s in all; "
        f"launches {counts}; on {card_and_power_limit()}")
    return dict(counts=counts, seconds=seconds, tok_s_first=gated["tok_s"],
                tok_s_on=on["tok_s"], tok_s_off=off["tok_s"], save_s=save_s,
                saved=saved)


# --- the framework bindings: horovod_tpu_torch.torch -------------------------

BINDING_STEPS = 3
BINDING_GROUPS = 4
BN_SHAPE = (32, 64, 112, 112)   # ResNet-50's stem output, a rank's, NCHW
# max |Δ| over max |oracle| per compared tensor.  bf16: the reference's
# numerics sum x and x² in the input's dtype (each sum rounded to bf16)
# before the f64 allreduce, and normalise in bf16.
BN_LIMIT = {"float32": 1e-5, "bfloat16": 5e-2}
FP16_UNIT = 2.0 ** -11          # float16's unit roundoff
# Step 1's fp16-wire average against the exact one: each rank's
# gradient, the f16 sum and the halving round once (u each, the sum's
# on up to 2 max_r |g_r| (1 + u)), the exact route's f32 sum once (2^-24
# of the sum); all over 2.  Subnormal steps add at most 2^-23.
FP16_BOUND_REL = 2 * FP16_UNIT * (1 + FP16_UNIT) + 2.0 ** -24
FP16_BOUND_ABS = 2.0 ** -23


def binding_model(dev, rank: int):
    """GPT-medium (``gpt_bench.py:106-112``, 24 layers) from seed 0,
    broadcast from rank 0 through the torch binding, and this rank's
    batch of 8 x 1024 tokens from seed ``rank``."""
    import horovod_tpu_torch.torch as hvd

    model, batch = gpt_medium(dev, data_seed=rank, broadcast=False)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    return model, batch


def hook_route(dev, rank: int, compression: str, num_groups: int) -> dict:
    """BINDING_STEPS AdamW steps through the torch binding's hook-driven
    ``DistributedOptimizer``, as its users write them; each step recorded
    (``step_check.record_collectives``) and timed, the launch counts set
    to 0 just before the steps and read just after.  Keeps the model,
    step 1's local gradients (read after backward, before ``step()``
    waits) and step 1's reduced gradients."""
    import torch
    import horovod_tpu_torch as core
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.analysis.step_check import record_collectives

    model, batch = binding_model(dev, rank)
    loss_fn = core.models.lm_loss_fn(model)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), **ADAMW),
        named_parameters=model.named_parameters(),
        compression=getattr(hvd.Compression, compression),
        num_groups=num_groups)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    params = dict(model.named_parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    core.ops.reset_launch_counts()
    losses, times, seqs, in_flight = [], [], [], []
    local = reduced = None
    for step in range(BINDING_STEPS):
        t0 = time.perf_counter()
        with record_collectives() as seq:
            opt.zero_grad()
            loss = loss_fn(model, batch)
            loss.backward()
            in_flight.append(len(opt._handles))
            if step == 0:
                local = {n: params[n].grad.detach().clone() for n in names}
            opt.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if step == 0:
            reduced = {n: params[n].grad.detach().clone() for n in names}
        seqs.append([list(e) for e in seq])
        losses.append(float(hvd.allreduce(loss.detach(), name="loss")))
    counts = core.ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    del opt
    model.zero_grad(set_to_none=True)
    return dict(model=model, local=local, reduced=reduced, losses=losses,
                times=times, seqs=seqs, in_flight=in_flight, counts=counts,
                peak=peak, hooks=len(names))


def fused_route(dev, rank: int) -> dict:
    """The same steps from the same weights through the core's
    ``make_train_step`` with ``Compression.none`` (one fused allreduce a
    bucket after backward), timed."""
    import torch
    import horovod_tpu_torch as core

    model, batch = binding_model(dev, rank)
    step = core.make_train_step(
        core.models.lm_loss_fn(model),
        torch.optim.AdamW(model.parameters(), **ADAMW),
        compression=core.Compression.none)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(BINDING_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step(model, batch)))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return dict(model=model, losses=losses, times=times,
                peak=torch.cuda.max_memory_allocated())


def param_delta(a, b) -> tuple:
    """(max |a - b| over max |b|, bitwise) over two models' parameters."""
    import torch

    worst, scale, bitwise = 0.0, 0.0, True
    with torch.no_grad():
        for (n, p), (m, q) in zip(a.named_parameters(),
                                  b.named_parameters()):
            assert n == m
            worst = max(worst, float((p - q).abs().max()))
            scale = max(scale, float(q.abs().max()))
            bitwise = bitwise and bitwise_equal(p, q)
    return worst / scale, bitwise


def fp16_excess(a: dict, local: dict, reduced: dict) -> dict:
    """Step 1's fp16-wire average (``reduced``) against the exact one
    (``a["reduced"]``), element by element, against fp16's rounding:
    |Δ| ≤ FP16_BOUND_REL · max_r |g_r| + FP16_BOUND_ABS, with ``max_r
    |g_r|`` a Max allreduce of the local gradients.  Returns the largest
    ratio of |Δ| to that bound (≤ 1 passes) and the largest |Δ|."""
    import horovod_tpu_torch.torch as hvd

    ratio, worst = 0.0, 0.0
    for n, g in reduced.items():
        m = hvd.allreduce(local[n].abs(), op=hvd.Max, name=f"max.{n}")
        delta = (g - a["reduced"][n]).abs()
        ratio = max(ratio, float((delta / (FP16_BOUND_REL * m
                                           + FP16_BOUND_ABS)).max()))
        worst = max(worst, float(delta.max()))
    return dict(ratio=ratio, max_abs=worst)


def sync_bn_case(dev, rank: int, dtype_name: str) -> dict:
    """(c): the torch binding's ``SyncBatchNorm(64)`` on this rank's
    ``BN_SHAPE`` input (seed 1000 + rank), the backward of ``sum(y ·
    dy)``; rank 0 holds every output against ``nn.BatchNorm2d`` in f64 on
    both ranks' batches concatenated: the output, ``running_mean``, the
    unbiased ``running_var``, the input gradient, and the ranks' summed
    weight and bias gradients.  Returns max |Δ| / max |oracle| a tensor
    (rank 0) and the seconds of the forward and backward."""
    import torch
    import horovod_tpu_torch.torch as hvd

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device=dev).manual_seed(1000 + rank)
    x = (torch.randn(BN_SHAPE, generator=gen, device=dev) * 2 + 0.5
         ).to(dtype).requires_grad_(True)
    dy = torch.randn(BN_SHAPE, generator=gen, device=dev).to(dtype)
    wgen = torch.Generator(device=dev).manual_seed(7)
    weight = torch.rand(BN_SHAPE[1], generator=wgen, device=dev) + 0.5
    bias = torch.randn(BN_SHAPE[1], generator=wgen, device=dev)
    bn = hvd.SyncBatchNorm(BN_SHAPE[1]).to(dev, dtype)
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = bn(x)
    (y * dy).sum().backward()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    # Gathered in f32 (exact for bf16), the oracle's inputs in f64.
    got = dict(
        y=hvd.allgather(y.detach().float()),
        x_grad=hvd.allgather(x.grad.float()),
        w_grad=hvd.allreduce(bn.weight.grad.float(), op=hvd.Sum),
        b_grad=hvd.allreduce(bn.bias.grad.float(), op=hvd.Sum),
        running_mean=bn.running_mean, running_var=bn.running_var)
    xs = hvd.allgather(x.detach().float())
    dys = hvd.allgather(dy.float())
    errs = {}
    if rank == 0:
        ref = torch.nn.BatchNorm2d(BN_SHAPE[1]).to(dev, torch.float64)
        with torch.no_grad():
            ref.weight.copy_(bn.weight)
            ref.bias.copy_(bn.bias)
        xr = xs.double().requires_grad_(True)
        yr = ref(xr)
        (yr * dys.double()).sum().backward()
        want = dict(y=yr.detach(), x_grad=xr.grad, w_grad=ref.weight.grad,
                    b_grad=ref.bias.grad, running_mean=ref.running_mean,
                    running_var=ref.running_var)
        for k, w in want.items():
            errs[k] = float((got[k].double() - w).abs().max()
                            / w.abs().max())
    return dict(errs=errs, seconds=seconds)


def binding_ranks(dev, rank: int) -> dict:
    """Path "torch binding 2 ranks" (``--binding-worker``), one rank: (a)
    the hook route (``Compression.none``) against the fused route from
    the same weights; (b) the hook route on ``Compression.fp16`` with
    ``num_groups=4``; (c) ``SyncBatchNorm`` at ResNet-50's stem shape,
    f32 and bf16."""
    import torch

    a = hook_route(dev, rank, "none", 0)
    del a["local"]
    fused = fused_route(dev, rank)
    rel, bitwise = param_delta(a["model"], fused["model"])
    del fused["model"]
    del a["model"]
    torch.cuda.empty_cache()
    b = hook_route(dev, rank, "fp16", BINDING_GROUPS)
    del b["model"]
    excess = fp16_excess(a, b.pop("local"), b.pop("reduced"))
    del a["reduced"]
    torch.cuda.empty_cache()
    bn = {name: sync_bn_case(dev, rank, name) for name in BN_LIMIT}
    return dict(a=a, b=b, fused=fused, rel=rel, bitwise=bitwise,
                excess=excess, bn=bn)


def check_binding(res: list, seconds: float, label: str, wire: str,
                  card: str):
    """The gates of "torch binding 2 ranks": (a) the hook route's losses
    and parameters within 1e-6 relative of the fused route's (both sum
    two f32 values an element and halve them: bit for bit is expected,
    printed), handles in flight before ``backward()`` returned, one
    allreduce a parameter; (b) finite losses, step 1's loss bit for bit
    (a)'s, step 1's reduced gradient within fp16's rounding of (a)'s,
    one grouped dispatch a group; both ranks' recorded sequences equal
    in (a) and (b); (c) SyncBatchNorm within ``BN_LIMIT``; B1 launched.
    Returns rank 0's launches over the hook-route steps of (a) and (b),
    and (a)'s losses ("spark run 2 tasks" must reproduce them)."""
    for r, out in enumerate(res):
        a, b, fused = out["a"], out["b"], out["fused"]
        if out["rel"] > 1e-6 or any(
                abs(x - y) > 1e-6 * abs(y)
                for x, y in zip(a["losses"], fused["losses"])):
            raise AssertionError(
                f"{label}: rank {r}: hook route against fused route: "
                f"parameters {out['rel']} relative, losses {a['losses']} "
                f"against {fused['losses']}")
        if not all(math.isfinite(v) for v in b["losses"]) \
                or b["losses"][0] != a["losses"][0]:
            raise AssertionError(f"{label}: rank {r}: fp16 losses "
                                 f"{b['losses']} (exact {a['losses']})")
        if out["excess"]["ratio"] > 1.0:
            raise AssertionError(f"{label}: rank {r}: fp16 reduced gradient "
                                 f"beyond fp16's rounding: {out['excess']}")
        if min(a["in_flight"] + b["in_flight"]) < 1:
            raise AssertionError(f"{label}: rank {r}: no handle in flight "
                                 f"when backward returned: {a['in_flight']}, "
                                 f"{b['in_flight']}")
        reduces = [sum(e[0] == "all_reduce" for e in s) for s in a["seqs"]]
        groups = [sum(e[0] == "all_reduce" for e in s) for s in b["seqs"]]
        if reduces != [a["hooks"]] * BINDING_STEPS \
                or min(groups) < BINDING_GROUPS:
            raise AssertionError(f"{label}: rank {r}: {reduces} allreduces "
                                 f"a step for {a['hooks']} parameters; "
                                 f"{groups} with {BINDING_GROUPS} groups")
        for name, case in out["bn"].items():
            bad = {k: v for k, v in case["errs"].items()
                   if not v <= BN_LIMIT[name]}
            if bad or (r == 0 and len(case["errs"]) != 6):
                raise AssertionError(f"{label}: SyncBatchNorm {name} beyond "
                                     f"{BN_LIMIT[name]}: {case['errs']}")
        for run in (a, b):
            if run["counts"]["flash_fwd"] <= 0:
                raise AssertionError(f"flash_fwd never launched on the "
                                     f"{label} path (rank {r})")
    for key in ("a", "b"):
        if res[0][key]["seqs"] != res[1][key]["seqs"]:
            raise AssertionError(f"{label}: ({key})'s recorded collective "
                                 "sequences differ between the ranks")
    r0 = res[0]
    a, b, fused = r0["a"], r0["b"], r0["fused"]
    log(f"{label}: GPT-medium 24 layers, 8 x 1024 tokens a rank, AdamW; "
        f"(a) hook route (Compression.none) against make_train_step from "
        f"the same weights: losses {a['losses']} / {fused['losses']}, "
        f"parameters max |Δ| {r0['rel']} relative (limit 1e-6), bitwise "
        f"{r0['bitwise']} (rank 1: {res[1]['bitwise']}); handles in flight "
        f"when backward returned {a['in_flight']}; {a['hooks']} hooks, one "
        f"allreduce each a step, sequences equal on both ranks")
    log(f"{label}: (b) fp16 + num_groups={BINDING_GROUPS}: losses "
        f"{b['losses']}, step 1's reduced gradient max |Δ| "
        f"{r0['excess']['max_abs']} from (a)'s, at most "
        f"{r0['excess']['ratio']:.4f} of fp16's rounding bound "
        f"({FP16_BOUND_REL} max_r |g_r| + 2^-23); "
        f"{[sum(e[0] == 'all_reduce' for e in s) for s in b['seqs']]} "
        f"allreduces a step, sequences equal on both ranks")
    log(f"{label}: step seconds hook {a['times']} (fp16 + groups "
        f"{b['times']}) against fused {fused['times']} ({wire}); peak "
        f"memory a rank {a['peak'] / 2**30:.2f} / "
        f"{res[1]['a']['peak'] / 2**30:.2f} GiB (hook), "
        f"{fused['peak'] / 2**30:.2f} (fused); launches (a) {a['counts']}, "
        f"(b) {b['counts']}")
    for name, case in r0["bn"].items():
        log(f"{label}: (c) SyncBatchNorm {name} {list(BN_SHAPE)} a rank "
            f"against nn.BatchNorm2d in f64 on the concatenated batch: max "
            f"|Δ| / max |oracle| {case['errs']} (limit {BN_LIMIT[name]}); "
            f"forward + backward {case['seconds']:.3f} s")
    log(f"{label}: phase {seconds:.1f} s on {card}")
    return ({k: a["counts"][k] + b["counts"][k] for k in a["counts"]},
            a["losses"])


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
SERVE_WORKER_FLAG = "--serve-worker"
REPLICAS_WORKER_FLAG = "--replicas-worker"
FLEET_WORKER_FLAG = "--fleet-worker"
SWAP_WORKER_FLAG = "--swap-worker"
TP_WORKER_FLAG = "--tp-worker"
SIM_WORKER_FLAG = "--sim-worker"
SANITIZE_WORKER_FLAG = "--sanitize-worker"
BINDING_WORKER_FLAG = "--binding-worker"
# Each multi-rank path's world, environment (read by hvd.init) and body.
RANK_PATHS = {
    PIPE_WORKER_FLAG: (SET_RANKS, {}, "pipe_ranks"),
    MOE_WORKER_FLAG: (SET_RANKS, {}, "moe_ranks"),
    FSDP_WORKER_FLAG: (SET_RANKS, FSDP_ENV, "fsdp_ranks"),
    AUTOTUNE_WORKER_FLAG: (WIRE_RANKS, AUTOTUNE_ENV, "autotune_ranks"),
    SERVE_WORKER_FLAG: (1, {}, "serve_ranks"),
    REPLICAS_WORKER_FLAG: (1, {}, "replica_ranks"),
    FLEET_WORKER_FLAG: (1, {}, "fleet_ranks"),
    SWAP_WORKER_FLAG: (1, {}, "swap_ranks"),
    TP_WORKER_FLAG: (1, {}, "tp_ranks"),
    SIM_WORKER_FLAG: (1, {}, "sim_ranks"),
    SANITIZE_WORKER_FLAG: (1, SANITIZE_ENV, "sanitize_ranks"),
    BINDING_WORKER_FLAG: (WIRE_RANKS, {}, "binding_ranks"),
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
            res = microbatch_ranks(hvd.device(), rank, MB_LAYERS)
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
    for path, a, b, steps in (("2 ranks", dp0, dp1, "DP"),
                              ("sharded 2 ranks", sh0, sh1, "ZeRO")):
        recorded_sequences(path, [a["seq"], b["seq"]],
                           f"{WIRE_STEPS} {steps} steps")
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


PHASE_SECONDS: dict = {}


def timed(label: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its wall time kept under ``label`` in
    PHASE_SECONDS (``main`` logs them before the result lines)."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kwargs)
    finally:
        PHASE_SECONDS[label] = round(time.perf_counter() - t0, 1)


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
    timed("probe", probe_check, card)
    timed("hvdlint (host)", hvdlint_phase)

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
        rows = timed("kernels", kernel_phase, dev, gen)
        timed("non-finite, model", lambda: (non_finite_check(dev),
                                             model_check(dev)))
        counts, dp_tok_s, dp_peak, obs_seconds = timed(
            "1 rank", train_phase, dev, card)
        torch.cuda.empty_cache()
        timed("xent", xent_check, dev)
        torch.cuda.empty_cache()
        zero_counts = timed("zero 1 rank", zero_phase, dev, card, dp_tok_s,
                            dp_peak)
        torch.cuda.empty_cache()
        wire_counts, sharded_counts = timed("2 ranks, sharded 2 ranks",
                                            two_rank_phase)
        set_counts = timed("4 ranks", four_rank_phase)
        mb_counts = timed("microbatch 2 ranks", microbatch_phase)
        resnet_counts, resnet_fp16_counts = timed(
            "resnet50 1 rank", resnet_phase, dev, card)
        torch.cuda.empty_cache()
        resnet_ranks_counts = timed("resnet50 2 ranks",
                                    resnet_two_rank_phase)
        bert_counts = timed("bert-large 1 rank", bert_phase, dev, card)
        torch.cuda.empty_cache()
        hier_counts = timed("hierarchical 4 ranks", hierarchical_phase)
        seq_counts = timed("sequence-parallel 4 ranks",
                           sequence_parallel_phase, card)
        new_paths = {}
        for flag, check, label in (
                (PIPE_WORKER_FLAG, check_pipeline, "pipeline 4 ranks"),
                (MOE_WORKER_FLAG, check_moe, "moe 4 ranks"),
                (FSDP_WORKER_FLAG, check_fsdp, "fsdp 4 ranks"),
                (AUTOTUNE_WORKER_FLAG, check_autotune, "autotune 2 ranks")):
            torch.cuda.empty_cache()
            new_paths[label] = timed(label, parallel_phase, flag,
                                     RANK_PATHS[flag][0], check, label,
                                     card)
        convnet_counts = timed("vgg16 / inception3 1 rank", convnet_phase,
                               dev, card)
        torch.cuda.empty_cache()
        durable_counts = timed("durable 1 rank", durable_phase, dev, card)
        torch.cuda.empty_cache()
        binding_counts, binding_losses = timed(
            "torch binding 2 ranks", parallel_phase, BINDING_WORKER_FLAG,
            WIRE_RANKS, check_binding, "torch binding 2 ranks", card)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        elastic_counts = timed("elastic 2 ranks", lambda: check_elastic(
            spawn_ranks(ELASTIC_WORKER_FLAG, WIRE_RANKS,
                        env={"MASTER_ADDR": "127.0.0.1",
                             "MASTER_PORT": str(hvd.basics._free_port())}),
            time.perf_counter() - t0, "elastic 2 ranks",
            "gloo staging through the host, 2 ranks on one card: not a "
            "wire's time", card))
        torch.cuda.empty_cache()
        launcher_counts, launcher_res = timed("launcher 2 ranks",
                                              launcher_phase, card)
        torch.cuda.empty_cache()
        remote_counts = timed("remote 2 hosts", remote_phase, card,
                              launcher_res)
        run_func_counts = timed("run_func 2 ranks", run_func_phase, card)
        torch.cuda.empty_cache()
        spark_counts = timed("spark run 2 tasks", spark_phase, card,
                             binding_losses)
        ray_counts = timed("ray executor 2 actors", ray_phase, card)
        torch.cuda.empty_cache()
        serve = timed("serve 1 rank", spawn_ranks, SERVE_WORKER_FLAG, 1)[0]
        replica_counts = timed("serve 2 replicas", spawn_ranks,
                               REPLICAS_WORKER_FLAG, 1)[0]["counts"]
        fleet = timed("fleet 3 replicas", spawn_ranks, FLEET_WORKER_FLAG,
                      1)[0]
        swap = timed("swap 2 replicas", spawn_ranks, SWAP_WORKER_FLAG, 1)[0]
        tp_counts = timed("serve tp 2", spawn_ranks, TP_WORKER_FLAG,
                          1)[0]["counts"]
        # The simulator's profile: this run's readings of the card.
        traffic = serve["report"]["traffic"]
        readings = {k: traffic[k] for k in ("ttft_ms_p50", "ttft_ms_p99",
                                            "tpot_ms_p50", "tpot_ms_p99")}
        readings.update(migrate_ms_mean=fleet["report"]["migrate_ms_mean"],
                        migrate_ms_p99=fleet["report"]["migrate_ms_p99"],
                        swap_ms=swap["report"]["swap_ms"])
        sim_counts = timed("fleet sim (host)", spawn_ranks,
                           SIM_WORKER_FLAG, 1,
                           env={SIM_READINGS_ENV: json.dumps(readings)}
                           )[0]["counts"]
        # The sanitizer's gate is read when the port is first imported:
        # the child gets it in its environment from the start.
        sanitize_counts = timed("sanitize serve 1 rank", spawn_ranks,
                                SANITIZE_WORKER_FLAG, 1,
                                env=SANITIZE_ENV)[0]["counts"]
        timed("route check", route_check, dev)
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
               "torch binding 2 ranks": binding_counts,
               "launcher 2 ranks": launcher_counts,
               "remote 2 hosts": remote_counts,
               "run_func 2 ranks": run_func_counts,
               "spark run 2 tasks": spark_counts,
               "ray executor 2 actors": ray_counts,
               "serve 1 rank": serve["counts"],
               "serve 2 replicas": replica_counts,
               "fleet 3 replicas": fleet["counts"],
               "swap 2 replicas": swap["counts"],
               "serve tp 2": tp_counts,
               "fleet sim (host)": sim_counts,
               "sanitize serve 1 rank": sanitize_counts}
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
    log("chip_smoke: seconds by phase, longest first: " + json.dumps(
        dict(sorted(PHASE_SECONDS.items(), key=lambda kv: -kv[1]))))
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
    if sys.argv[1:2] == [TP_SHARD_FLAG]:
        tp_shard_worker(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:2] and sys.argv[1] in WORKER_FLAGS:
        rank_worker(sys.argv[1], int(sys.argv[2]), sys.argv[3])
        sys.exit(0)
    sys.exit(main())
