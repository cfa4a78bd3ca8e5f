#!/usr/bin/env python3
"""The readings the limits of ``correct`` are set from, in one process a
rank, with no window.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--faults unchanged_state,half_batch] \\
        [--fault-seeds 1,2,3] [--witness-seeds 1,2,3]

For each seed, the program's first steps as ``run.py`` drives them
(``program``), the same with each fault of ``core/faults.py`` planted,
and the control (``control``: the reference with its products in fp8,
``reference/fp8.py``, in the program's place) are each compared with the
float32 reference, as ``run.py`` compares.  On the witness seeds the
reference with ``reference/witness.py``'s attention in its place is
compared too: Δ of the attention backward from O rounded to bfloat16
(``witness_bf16_o``), and from the float32 O (``witness_f32_o``).  Rank 0
prints one JSON line a seed, then the largest and smallest reading of
each number over the seeds.  ``no_exchange`` needs two ranks or more.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ints(text: str):
    return [int(x) for x in text.split(",") if x]


def calibrate_rank(spec: dict) -> int:
    from portbench.core import faults, judge, session
    from portbench.core.feed import Pool
    from portbench.core.spec import family_module, load_cell
    from portbench.reference import fp8, witness

    cell = load_cell(spec["cell"], spec["root"])
    rank, world = spec["rank"], spec["world"]
    dev = session.start(spec["device"])
    fam = family_module(cell)
    order = list(dict.fromkeys(spec["seeds"] + spec["control_seeds"]
                               + spec["fault_seeds"]
                               + spec["witness_seeds"]))
    records = []
    for seed in order:
        t = time.perf_counter()
        pool = Pool(cell.traffic, fam.vocab_size(cell.config), seed, world,
                    dev)
        names = ["program"] if seed in spec["seeds"] else []
        names += [f for f in spec["faults"] if seed in spec["fault_seeds"]
                  and not (f == "no_exchange" and world == 1)]
        runs = {}
        for name in names:
            with faults.planted(None if name == "program" else name):
                prog = session.build_program(cell, seed, rank, world, dev,
                                             pool)
                runs[name] = session.checked_steps(cell, prog, seed, dev)
                del prog
                session.free(dev)
        if rank != 0:
            continue
        ref = session.reference_readings(cell, seed, world, dev, pool)
        rec = {"seed": seed}
        rec.update({n: judge.readings(r, ref) for n, r in runs.items()})
        worst = {n: judge.worst_leaves(r, ref) for n, r in runs.items()}
        if seed in spec["control_seeds"]:
            ctl = session.reference_readings(cell, seed, world, dev, pool,
                                             mm=fp8.matmul)
            rec["control"] = judge.readings(ctl, ref)
            worst["control"] = judge.worst_leaves(ctl, ref)
        if seed in spec["witness_seeds"]:
            for run, round_o in (("witness_bf16_o", True),
                                 ("witness_f32_o", False)):
                wit = session.reference_readings(
                    cell, seed, world, dev, pool,
                    attend=witness.attention(round_o))
                rec[run] = judge.readings(wit, ref)
                worst[run] = judge.worst_leaves(wit, ref)
        rec["losses"] = {"reference": ref["losses"],
                         **{n: r["losses"] for n, r in runs.items()}}
        rec["worst"] = worst
        rec["seconds"] = time.perf_counter() - t
        print(json.dumps(rec), flush=True)
        records.append(rec)
        session.free(dev)
    if rank == 0:
        spans = {}
        for rec in records:
            for run, values in rec.items():
                if run not in ("worst", "losses") and isinstance(values, dict):
                    for k, v in values.items():
                        spans.setdefault(run, {}).setdefault(k, []).append(v)
        print(json.dumps({run: {k: [min(v), max(v), len(v)]
                                for k, v in values.items()}
                          for run, values in spans.items()}), flush=True)
    import horovod_tpu_torch as hvd

    hvd.shutdown()
    return 0


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=_ints, default=[])
    parser.add_argument("--control-seeds", type=_ints, default=[])
    parser.add_argument("--faults", default="")
    parser.add_argument("--fault-seeds", type=_ints, default=[])
    parser.add_argument("--witness-seeds", type=_ints, default=[])
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench.core import launch
    from portbench.core.spec import load_cell
    from portbench.run import fixed_caches

    fixed_caches()
    cell = load_cell(args.workload, ROOT)
    spec = dict(root=ROOT, cell=cell.name, device="cuda", t0=time.time(),
                mode="calibrate", seeds=args.seeds,
                control_seeds=args.control_seeds,
                faults=[f for f in args.faults.split(",") if f],
                fault_seeds=args.fault_seeds,
                witness_seeds=args.witness_seeds)
    return launch.run(spec, cell.chips)


if __name__ == "__main__":
    sys.exit(main())
