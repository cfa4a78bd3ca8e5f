#!/usr/bin/env python3
"""Which point-to-point transports, and whether FSDP2, gloo runs on
CUDA tensors.

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

Then four processes share card 0 over gloo and take two steps of FSDP2
(``torch.distributed.fsdp.fully_shard``, each parameter on its largest
dim that divides, as ``horovod_tpu_torch/optim/fsdp.py`` places it) on
a two-layer f32 MLP, Adam with global-norm clipping: over a 1-D mesh of
four (FSDP) and over a 2 × 2 mesh (HSDP: replicate × shard).  The
parameters must come out equal on every rank, and within 1e-5 of one
process's plain steps on the whole batch.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

TRANSPORTS = ("send_recv", "batch_isend_irecv", "all_to_all_single")
FSDP_MESHES = {"fsdp": ((4,), ("shard",)),
               "hsdp": ((2, 2), ("replicate", "shard"))}
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


def _fsdp_steps(model, x, y, steps: int = 2):
    import torch

    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    for _ in range(steps):
        loss = ((model(x) - y) ** 2).mean()
        loss.backward()
        torch.nn.utils.clip_grad_norm_(model.parameters(), 0.1)
        opt.step()
        opt.zero_grad()


def _mlp(dev):
    import torch

    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(64, 256), torch.nn.Tanh(),
                               torch.nn.Linear(256, 8)).to(dev)


def fsdp_worker(kind: str, rank: int, store: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=4)
    dev = torch.device("cuda", 0)
    try:
        gen = torch.Generator(device=dev).manual_seed(1)
        x = torch.randn(32, 64, generator=gen, device=dev)
        y = torch.randn(32, 8, generator=gen, device=dev)
        plain = _mlp(dev)
        _fsdp_steps(plain, x, y)
        model = _mlp(dev)
        shape, names = FSDP_MESHES[kind]
        mesh = init_device_mesh("cuda", shape, mesh_dim_names=names)

        def place(p):
            dims = [(s, i) for i, s in enumerate(p.shape) if s % 2 == 0]
            return Shard(max(dims)[1]) if dims else Shard(0)

        fully_shard(model[0], mesh=mesh, shard_placement_fn=place)
        fully_shard(model, mesh=mesh, shard_placement_fn=place)
        _fsdp_steps(model, x[rank * 8:(rank + 1) * 8],
                    y[rank * 8:(rank + 1) * 8])
        full = [p.full_tensor() for p in model.parameters()]
        err = max(float((a - b).abs().max())
                  for a, b in zip(full, plain.parameters()))
        mine = torch.cat([f.reshape(-1) for f in full])
        every = [torch.empty_like(mine) for _ in range(4)]
        dist.all_gather(every, mine)
        same = all(torch.equal(every[0], e) for e in every)
        print("exact" if same and err <= 1e-5 else f"wrong {err} {same}",
              flush=True)
    finally:
        dist.destroy_process_group()


def run(transport: str) -> str:
    world = 4 if transport in FSDP_MESHES else 2
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), transport, str(r),
             os.path.join(tmp, "store")], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(world)]
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
    fsdp = {k: run(k) for k in FSDP_MESHES}
    for k, r in fsdp.items():
        print(f"gloo on CUDA tensors, FSDP2 {k} {FSDP_MESHES[k][0]}: {r}",
              flush=True)
    print(json.dumps({"gloo_cuda_p2p": results, "gloo_cuda_fsdp2": fsdp}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4:
        (fsdp_worker if sys.argv[1] in FSDP_MESHES else worker)(
            sys.argv[1], int(sys.argv[2]), sys.argv[3])
        sys.exit(0)
    sys.exit(main())
