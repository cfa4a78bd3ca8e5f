#!/usr/bin/env python3
"""Does ``torch.profiler`` still record device events after serving?

    python3 scripts/serve_profiler_probe.py [CASE ...]

Each case runs in a fresh process on one CUDA card: GPT-medium
(``chip_smoke.py``'s widths, 24 layers, random weights from seed 0) does
one piece of the "serve 1 rank" phase's work, then a ``torch.profiler``
session (CPU and CUDA activities) around a few small device ops and one
bf16 B1 launch counts the CUDA events that its ``key_averages()`` holds,
all of them and B1's.  A case whose name ends in ``+warm`` opens one
such session before the work as well.

- ``idle``: no work (the control);
- ``{bf16,f32}-forward-{64,900}``: the full-forward argmax loop of the
  oracle, 32 forwards from a prompt of that length (flash attention,
  B1 in every forward);
- ``bf16-full-forward-900``: the same loop with plain attention (no B1);
- ``{bf16,f32}-engine-{64,900}``: a paged engine at the reference's
  defaults serving one prompt of that length for 32 decode steps (no B1);
- ``oracle-phase``, ``traffic-phase``, ``serve-phase``: ``chip_smoke``'s
  functions of the same names, the "serve 1 rank" path's (a), its (b)
  on the bf16 model, and the whole path.

Prints the card's name and power limit, a line per case, then one JSON
line ``{"cases": {case: {"events_before", "events_after", "seconds"}}}``
(each ``[all, B1's]``; ``events_before`` null without ``+warm``).
Exits 1 with no card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW_TOKENS = 32
CASES = ("idle", "bf16-forward-64", "bf16-forward-900", "f32-forward-900",
         "bf16-full-forward-900", "bf16-engine-64", "bf16-engine-900",
         "f32-engine-900", "bf16-forward-900+warm", "oracle-phase",
         "traffic-phase", "serve-phase")


def device_events() -> list:
    """``[all, B1's]`` CUDA events a fresh profiler session records
    around an elementwise op, a sum and one bf16 B1 launch at
    GPT-medium's step shape (the route check's first call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, ROOT)
    from horovod_tpu_torch.ops import flash_attention as fa

    x = torch.ones(1 << 20, device="cuda")
    q = torch.randn((128, 1024, 64), device="cuda").bfloat16()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        (x * 2).sum().item()
        fa.flash_fwd(q, q, q, 0.125, True)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    return [sum(e.count for e in events),
            sum(e.count for e in events if "flash_fwd" in e.key)]


def work(case: str) -> None:
    """The serving work of ``case`` (its name without ``+warm``)."""
    import torch

    sys.path.insert(0, ROOT)
    import horovod_tpu_torch as hvd
    from chip_smoke import GPT_MEDIUM, SERVE_ENGINE, serve_prompts
    from horovod_tpu_torch.serve import InferenceEngine, SamplingParams

    if case == "idle":
        return
    if case.endswith("-phase"):
        import chip_smoke as cs

        if case == "serve-phase":
            cs.serve_phase("cuda", cs.card_and_power_limit())
            return
        bf16 = cs.serve_model("cuda", torch.bfloat16)
        if case == "traffic-phase":
            cs.traffic_phase(bf16, cs.card_and_power_limit())
            return
        f32 = cs.serve_model("cuda", torch.float32)
        f32.load_state_dict(bf16.state_dict())
        cs.oracle_phase("cuda", {"float32": f32, "bfloat16": bf16})
        return
    dtype, rest = case.split("-", 1)
    kind, length = rest.rsplit("-", 1)
    attention = "full" if kind == "full-forward" else "flash"
    cfg = hvd.models.GPTConfig(
        **{**GPT_MEDIUM, "attention": attention},
        dtype={"bf16": torch.bfloat16, "f32": torch.float32}[dtype])
    model = hvd.models.GPT(cfg, device="cuda", seed=0)
    model.requires_grad_(False)
    prompt = serve_prompts(0, (int(length),), cfg.vocab_size)[0]
    with torch.inference_mode():
        if kind == "engine":
            engine = InferenceEngine(model, **SERVE_ENGINE)
            engine.start(0, prompt, SamplingParams(max_new_tokens=NEW_TOKENS))
            for _ in range(NEW_TOKENS - 1):
                engine.step()
            engine.release(0)
        else:
            seq = list(prompt)
            for _ in range(NEW_TOKENS):
                logits = model(torch.tensor([seq], device="cuda"))
                seq.append(int(logits[0, -1].argmax()))
    torch.cuda.synchronize()


def run_case(case: str) -> dict:
    t0 = time.perf_counter()
    warm = case.endswith("+warm")
    before = device_events() if warm else None
    work(case.removesuffix("+warm"))
    after = device_events()
    return dict(events_before=before, events_after=after,
                seconds=time.perf_counter() - t0)


def main(argv) -> int:
    if argv[:1] == ["--case"]:
        print(json.dumps(run_case(argv[1])), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("serve_profiler_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import card_and_power_limit

    print(card_and_power_limit(), flush=True)
    out = {}
    for case in argv or CASES:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--case", case], capture_output=True,
                              text=True, timeout=600)
        if proc.returncode != 0:
            print(f"{case}: exit {proc.returncode}\n{proc.stderr[-2000:]}",
                  flush=True)
            out[case] = None
            continue
        out[case] = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"{case}: {out[case]}", flush=True)
    print(json.dumps({"cases": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
