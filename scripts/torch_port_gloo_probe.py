#!/usr/bin/env python3
"""Which point-to-point transports gloo runs on CUDA tensors.

    python3 scripts/torch_port_gloo_probe.py

Two processes share card 0 over gloo (as ``chip_smoke.py``'s multi-rank
phases do) and try, each in its own pair of processes with a time limit,
to pass a bf16 ``[2, 2048, 8, 64]`` block (a ring block's K) from rank 0
to rank 1 and back: ``dist.send``/``dist.recv``,
``dist.batch_isend_irecv``, and one ``all_to_all_single`` whose splits
are all zero but one each way (the ring's rotation in
``horovod_tpu_torch/parallel/comm.py``).  Prints one line a transport
(ran and arrived exactly, ran and arrived wrong, raised, or timed out)
and a JSON line of the results; exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

TRANSPORTS = ("send_recv", "batch_isend_irecv", "all_to_all_single")
SHAPE = (2, 2048, 8, 64)


def worker(transport: str, rank: int, store: str) -> None:
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=2)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(rank)
    x = torch.randn(SHAPE, generator=gen, device=dev).to(torch.bfloat16)
    peer = 1 - rank
    out = torch.empty_like(x)
    try:
        if transport == "send_recv":
            if rank == 0:
                dist.send(x, peer)
                dist.recv(out, peer)
            else:
                dist.recv(out, peer)
                dist.send(x, peer)
        elif transport == "batch_isend_irecv":
            ops = [dist.P2POp(dist.isend, x, peer),
                   dist.P2POp(dist.irecv, out, peer)]
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        else:
            flat = x.reshape(-1).view(torch.uint8)
            got = torch.empty_like(flat)
            m = flat.numel()
            sizes = [m if j == peer else 0 for j in range(2)]
            dist.all_to_all_single(got, flat, output_split_sizes=sizes,
                                   input_split_sizes=sizes)
            out = got.view(torch.bfloat16).reshape(SHAPE)
        torch.cuda.synchronize()
        want = torch.randn(SHAPE, generator=torch.Generator(
            device=dev).manual_seed(peer), device=dev).to(torch.bfloat16)
        print("exact" if torch.equal(out, want) else "wrong", flush=True)
    finally:
        dist.destroy_process_group()


def run(transport: str) -> str:
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), transport, str(r),
             os.path.join(tmp, "store")], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(2)]
        outs = []
        try:
            for p in procs:
                out, err = p.communicate(timeout=120)
                outs.append((p.returncode, out.strip(), err.strip()))
        except subprocess.TimeoutExpired:
            return "timed out"
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    if all(code == 0 and out == "exact" for code, out, _ in outs):
        return "ran, exact"
    if all(code == 0 for code, _, _ in outs):
        return "ran, wrong values"
    errs = [err.splitlines()[-1] if err else f"exit {code}"
            for code, _, err in outs if code]
    return f"raised: {errs[0]}"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_port_gloo_probe: no CUDA device", file=sys.stderr)
        return 1
    print(f"torch {torch.__version__}, {torch.cuda.get_device_name(0)}",
          flush=True)
    results = {t: run(t) for t in TRANSPORTS}
    for t, r in results.items():
        print(f"gloo on CUDA tensors, {t}: {r}", flush=True)
    print(json.dumps({"gloo_cuda_p2p": results}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4:
        worker(sys.argv[1], int(sys.argv[2]), sys.argv[3])
        sys.exit(0)
    sys.exit(main())
