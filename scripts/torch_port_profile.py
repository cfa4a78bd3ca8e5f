#!/usr/bin/env python3
"""Where the device time of a train step of horovod_tpu_torch goes, on
one CUDA card.

    python3 scripts/torch_port_profile.py [--zero] [--model resnet50]

Runs a train step of ``chip_smoke.py`` in a one-rank NCCL world: by
default GPT-medium's (24 layers, d_model 1024, 16 heads, seq 1024,
batch 8, flash attention, bf16 activations, AdamW, the int8 wire with
error feedback), the data-parallel step or, with ``--zero``, the ZeRO-1
step (``make_zero_train_step``); with ``--model resnet50`` the
"resnet50 1 rank" step (``bench.py``'s ResNet-50 at batch 256, bf16,
BatchNorm in train mode, SGD-momentum on the int8 + error-feedback
wire).  Two warm-up steps, then STEPS steps timed on the host clock,
then as many under ``torch.profiler``.  Prints the card's name and
power limit, the step time, the device time by group (the port's
kernels, convolutions, matrix products, the rest) and the device's idle
share (one minus the device's busy time over the unprofiled step time),
then the TOP kernels by device time, then one JSON line with the totals.

For GPT it also times one layer's attention at the step's shapes with
CUDA events: the forward kernel alone, and the forward with the
plain-torch backward, each beside ``F.scaled_dot_product_attention`` as
a yardstick that the port never calls.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from horovod_tpu_torch.ops.int8_kernels import ROUTE_KERNELS  # noqa: E402

STEPS = 2      # profiled steps, after as many timed without the profiler
TOP = 25       # kernels listed by device time

# Device-time groups, by substrings of the CUDA kernel's name; the first
# group that matches takes the kernel.  "quantize_rows" (B2) is a
# substring of "dequantize_rows" (B4), so B4 comes first.
GROUPS = (
    ("flash_fwd kernel (B1)", ("flash_fwd",)),
    ("convolutions (cuDNN)", ("conv", "fprop", "dgrad", "wgrad", "cudnn")),
    ("layout transposes (nchwToNhwc, nhwcToNchw)", ("nchwToNhwc",
                                                    "nhwcToNchw")),
    ("B3 dequantize_accumulate (both routes)",
     tuple(ROUTE_KERNELS["dequantize_accumulate"].values())),
    ("B4 dequantize_blocks (both routes)",
     tuple(ROUTE_KERNELS["dequantize_blocks"].values())),
    ("B2 quantize_blocks", ("quantize_rows",)),
    ("f32 products (cuBLAS, CUDA cores)", ("f32f32", "sgemm")),
    ("other products (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass")),
    ("optimizer (multi_tensor_apply)", ("multi_tensor_apply",)),
    ("log-softmax", ("SoftMax",)),
)
OTHER = "other (elementwise, reductions, copies)"


def group_of(kernel_name: str) -> str:
    for group, keys in GROUPS:
        if any(k in kernel_name for k in keys):
            return group
    return OTHER


def attention_times(dev) -> dict:
    """One layer's attention at GPT-medium's shapes, in ms."""
    import torch
    import torch.nn.functional as F
    from chip_smoke import BATCH, GPT_MEDIUM, SEQ, time_ms
    from horovod_tpu_torch.ops import flash_attention as fa

    h = GPT_MEDIUM["n_head"]
    d = GPT_MEDIUM["d_model"] // h
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v, do = (torch.randn((BATCH, SEQ, h, d), generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    for t in (q, k, v):
        t.requires_grad_(True)
    q4, k4, v4, do4 = (t.detach().transpose(1, 2).contiguous()
                       .requires_grad_(True) for t in (q, k, v, do))

    def port_fwd_bwd():
        fa.flash_attention(q, k, v, causal=True).backward(do)

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(q4, k4, v4, is_causal=True).backward(
            do4)

    with torch.no_grad():
        port_fwd = time_ms(lambda: fa.flash_attention(q, k, v, causal=True))
        sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True))
    return dict(port_fwd_ms=port_fwd, port_fwd_bwd_ms=time_ms(port_fwd_bwd),
                sdpa_fwd_ms=sdpa_fwd, sdpa_fwd_bwd_ms=time_ms(sdpa_fwd_bwd))


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--zero", action="store_true",
                        help="profile the ZeRO-1 step, not the "
                             "data-parallel one")
    parser.add_argument("--model", choices=["gpt-medium", "resnet50"],
                        default="gpt-medium",
                        help="the model whose step is profiled")
    args = parser.parse_args()
    if args.zero and args.model != "gpt-medium":
        parser.error("--zero profiles GPT-medium's ZeRO step only")
    if not torch.cuda.is_available():
        print("torch_port_profile: no CUDA device", file=sys.stderr)
        return 1
    import horovod_tpu_torch as hvd
    from chip_smoke import (IMAGE_CLASSES, IMAGE_SIDE, RESNET_BATCH,
                            card_and_power_limit, dp_step, gpt_medium,
                            images_batch, sgd_step, zero_step)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_and_power_limit()
    print(card, flush=True)
    hvd.ops.build_kernels()
    hvd.init()
    try:
        dev = hvd.device()
        if args.model == "resnet50":
            attn = None
            model = hvd.models.ResNet50(num_classes=IMAGE_CLASSES,
                                        dtype=torch.bfloat16, device=dev)
            batch = images_batch(dev, RESNET_BATCH, IMAGE_SIDE["resnet50"],
                                 seed=0)
            step = sgd_step(model, "int8")
        else:
            attn = attention_times(dev)
            model, batch = gpt_medium(dev)
            step = (zero_step if args.zero else dp_step)(model)
        for _ in range(2):
            step(model, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step(model, batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / STEPS
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(STEPS):
                step(model, batch)
            torch.cuda.synchronize()
    finally:
        hvd.shutdown()

    kernels = []
    for evt in prof.key_averages():
        # Device-side ranges of annotations (the optimizer's step) would
        # count their kernels twice.
        if (evt.device_type != DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
            continue
        kernels.append((evt.self_device_time_total / 1e3, evt.count,
                        evt.key))
    kernels.sort(reverse=True)
    busy_ms = sum(ms for ms, _, _ in kernels)
    if busy_ms <= 0:
        raise RuntimeError("the profiler recorded no device time")
    groups = {g: 0.0 for g, _ in GROUPS}
    groups[OTHER] = 0.0
    for ms, _, name in kernels:
        groups[group_of(name)] += ms
    # The profiler slows the host, so the idle share is taken against the
    # step time of the same steps without it.
    result = dict(card=card, model=args.model,
                  step="zero" if args.zero else "data-parallel",
                  steps=STEPS, step_ms=step_ms,
                  device_busy_ms_per_step=busy_ms / STEPS,
                  idle_share=1.0 - busy_ms / STEPS / step_ms,
                  groups_ms_per_step={g: ms / STEPS
                                      for g, ms in groups.items()},
                  attention_one_layer=attn)
    if args.model == "resnet50":
        result["images_per_s"] = RESNET_BATCH / (step_ms / 1e3)

    print(f"step {step_ms} ms, device busy {result['device_busy_ms_per_step']}"
          f" ms, idle share {result['idle_share']}"
          + (f", {result['images_per_s']} images/s"
             if "images_per_s" in result else ""))
    for g, ms in result["groups_ms_per_step"].items():
        print(f"  {g}: {ms} ms per step")
    if attn is not None:
        print(f"attention, one layer: {attn}")
    print(f"the {TOP} largest kernels: ms per step, launches per step, "
          "group, name")
    for ms, count, name in kernels[:TOP]:
        print(f"{ms / STEPS:12.4f} {count // STEPS:6d}  "
              f"{group_of(name)}  {name[:120]}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
