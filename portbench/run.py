#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a host with as many CUDA cards as the
cell asks for.  Set-up makes the weights and a pool of batches on the
cards from ``--seed``, builds the port's data-parallel step, drives it
through the first steps (which the reference checks after the window)
and a few timing steps; the window then runs as many steps as
``--seconds`` holds and ends on a synchronise.  ``--trace 1`` profiles a
few more steps and reports the per-layer metrics instead of the
end-to-end ones.  The last line of standard output is one JSON object;
the numbers that decide ``correct`` are the last lines of standard error
and the result's ``limits``.  Exits non-zero, with no result, without
the cards, when a rank fails, or when a JAX module was loaded.
"""

from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "portbench", ".cache")


def fixed_caches() -> None:
    """Every build and kernel cache in fixed directories of the checkout,
    so that only a checkout's first run builds."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    fixed_caches()
    sys.path.insert(0, ROOT)
    from portbench.core import launch
    from portbench.core.spec import load_cell

    cell = load_cell(args.workload, ROOT)
    spec = dict(root=ROOT, cell=cell.name, seed=args.seed,
                seconds=args.seconds, trace=bool(args.trace), device="cuda",
                t0=T0, mode="run")
    return launch.run(spec, cell.chips)


if __name__ == "__main__":
    sys.exit(main())
