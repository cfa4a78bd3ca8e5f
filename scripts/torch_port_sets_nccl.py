#!/usr/bin/env python3
"""The "4 ranks" path of ``chip_smoke.py`` over NCCL, one rank per card.

    python3 scripts/torch_port_sets_nccl.py      # on a host with 4 cards
    python3 scripts/torch_port_sets_nccl.py --microbatch
    python3 scripts/torch_port_sets_nccl.py --topology 2x2
    python3 scripts/torch_port_sets_nccl.py --spmd
    python3 scripts/torch_port_sets_nccl.py --fsdp
    python3 scripts/torch_port_sets_nccl.py --moe

``chip_smoke.py`` runs its four ranks on one card over gloo, since NCCL
refuses several ranks on one device.  This script runs the same path
(``chip_smoke.set_ranks``: the eager collective API over the global set
and the pairs {0, 2} and {1, 3}, data parallelism per pair on the int8+EF
wire, Adasum over all four and over {0, 1, 2},
``backward_passes_per_step=2``) with ``hvd.init()``'s own backend, NCCL,
one process per card with the environment torchrun would give it, and
holds the results to the same checks (``chip_smoke.check_four_ranks``).
With ``--microbatch`` it runs ``chip_smoke.py``'s "microbatch 2 ranks"
path instead (``chip_smoke.microbatch_ranks``: full-depth GPT-medium,
four microbatches on the int8 overlap wire, the chunked head, with its
checks against the plain B2-B4 composition and the two-phase wire) on
four ranks, held to ``chip_smoke.check_microbatch``.  With
``--topology 2x2`` it runs ``chip_smoke.py``'s "hierarchical 4 ranks"
path (``chip_smoke.hier_ranks``: ResNet-50 under
``HVD_TPU_TOPO_SPEC=2x2`` and ``HVD_TPU_HIERARCHICAL_INNER=2``, the
hierarchical int8+EF steps against the plain B2-B4 composition, flat,
two-phase and hierarchical on exact data, the eager hierarchical
allreduce, the hierarchical overlap wire), held to
``chip_smoke.check_hierarchical``; the two tiers' groups are NCCL
communicators of their own.  With ``--spmd`` it runs the "sequence-
parallel 4 ranks" path (``chip_smoke.seq_ranks``: GPT-medium's widths
at 4096 tokens on ``{'dp': 1, 'sp': 2, 'tp': 2}``, ring attention on the
flash engine, ``make_spmd_train_step``; the short checks; the one-rank
oracle on rank 0's card) under ``HVD_TPU_MESH_PLAN=data=2,fsdp=2``, held
to ``chip_smoke.check_sequence_parallel``: the ring's K/V rotation and
the tensor-parallel sums then travel over NVLink.  With ``--fsdp`` it
runs the "fsdp 4 ranks" path (``chip_smoke.fsdp_ranks``: GPT-medium
through ``make_fsdp_train_step`` under ``HVD_TPU_MESH_PLAN=fsdp=4``, a
block gathered for its forward and again for its backward, the HSDP
check, the one-rank oracle) and with ``--moe`` the "moe 4 ranks" path
(``chip_smoke.moe_ranks``: the MoE GPT on ``{'dp': 2, 'ep': 2}``, then
the ``{'sp': 2, 'ep': 2}`` step with ring attention), both at the full
24 layers, held to ``chip_smoke.check_fsdp`` and ``check_moe``; each
rank has a card of its own, so its peak memory is that card's.  One
host's four cards are all NVLink, so its step times say nothing of a
network between nodes.
It prints each card's name and power limit, and exits non-zero, with no
result line, on a failure or with fewer than four cards.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_FLAG = "--nccl-worker"


MICROBATCH_FLAG = "--microbatch"
TOPOLOGY_FLAG = "--topology"
SPMD_FLAG = "--spmd"
FSDP_FLAG = "--fsdp"
MOE_FLAG = "--moe"
PATHS = {"sets": "set_ranks", "microbatch": "microbatch_ranks",
         "topology": "hier_ranks", "spmd": "seq_ranks",
         "fsdp": "fsdp_ranks", "moe": "moe_ranks"}


def _full_depth(cs) -> None:
    """The fsdp and moe paths at GPT-medium's 24 layers: one rank a card
    has the memory the shared card lacks."""
    cs.FSDP_LAYERS = cs.MOE_LAYERS = cs.GPT_MEDIUM["n_layer"]


def worker(rank: int, tmp: str, path: str) -> None:
    sys.path.insert(0, ROOT)
    import torch
    import chip_smoke as cs
    import horovod_tpu_torch as hvd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hvd.init()                                   # cuda:<LOCAL_RANK>, NCCL
    _full_depth(cs)
    try:
        res = getattr(cs, PATHS[path])(hvd.device(), rank)
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        hvd.shutdown()


def main(path: str) -> int:
    import torch

    if torch.cuda.device_count() < 4:
        print("torch_port_sets_nccl: needs 4 CUDA cards", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import horovod_tpu_torch as hvd

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    hvd.ops.build_kernels()                      # once, before the ranks
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    world = cs.SET_RANKS
    knobs = {"topology": cs.HIER_ENV, "spmd": cs.SEQ_ENV,
             "fsdp": cs.FSDP_ENV}.get(path, {})
    _full_depth(cs)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = []
        for r in range(world):
            env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                       WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       **knobs)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), WORKER_FLAG,
                 str(r), tmp, path], env=env))
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
            print(f"torch_port_sets_nccl: exit codes {codes}", file=sys.stderr)
            return 1
        res = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                res.append(json.load(f))
        seconds = time.perf_counter() - t0
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        nvlink = "NCCL, one rank a card, all four on one host's NVLink"
        if path == "microbatch":
            counts = cs.check_microbatch(res, seconds, "microbatch 4 ranks",
                                         "NCCL, one rank a card")
        elif path == "spmd":
            counts = cs.check_sequence_parallel(
                res, seconds, "sequence-parallel 4 ranks (NCCL)", nvlink,
                card)
        elif path in ("fsdp", "moe"):
            check = cs.check_fsdp if path == "fsdp" else cs.check_moe
            counts = check(res, seconds, f"{path} 4 ranks (NCCL)", nvlink,
                           card)
        elif path == "topology":
            counts = cs.check_hierarchical(
                res, seconds, "hierarchical 4 ranks (NCCL)",
                "NCCL, one rank a card, all four on one host's NVLink")
        else:
            counts = cs.check_four_ranks(res, seconds)
    print(json.dumps({"backend": "nccl", "cards": world, "path": path,
                      "launches": counts,
                      "seconds_per_rank": [o["seconds"] for o in res],
                      **({"step_seconds": [o["times"] for o in res]}
                         if path in ("spmd", "fsdp", "moe") else {}),
                      **({"peak_gathered_bytes": [o["gathered"] for o in res]}
                         if path == "fsdp" else {}),
                      "peak_bytes": [o["peak"] for o in res]}))
    return 0


def _path(argv) -> str:
    """The path the arguments select; ``--topology`` takes the one
    topology four cards factor into two tiers, ``2x2``."""
    if TOPOLOGY_FLAG in argv:
        spec = argv[argv.index(TOPOLOGY_FLAG) + 1:][:1]
        if spec != ["2x2"]:
            raise SystemExit(f"{TOPOLOGY_FLAG} takes 2x2 (four cards), got "
                             f"{spec}")
        return "topology"
    if SPMD_FLAG in argv:
        return "spmd"
    if FSDP_FLAG in argv:
        return "fsdp"
    if MOE_FLAG in argv:
        return "moe"
    return "microbatch" if MICROBATCH_FLAG in argv else "sets"


if __name__ == "__main__":
    if sys.argv[1:2] == [WORKER_FLAG]:
        worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        sys.exit(0)
    sys.exit(main(_path(sys.argv[1:])))
