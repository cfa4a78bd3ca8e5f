"""One rank's process: ``python -m portbench.core.rank '<spec json>'``.

The spec: ``root`` (the checkout), ``cell``, ``seed``, ``seconds``,
``trace``, ``device`` (``cuda``, or ``cpu`` in the tests), ``t0`` (the
run's start, ``time.time()``), ``scratch``, ``rank``, ``world``, and
``mode``: ``run`` (the benchmark) or ``calibrate`` (``calibrate.py``'s
readings); the tests and the calibration may name a ``fault``
(``faults.py``).  Every rank reduces its run to a summary, which rank 0
gathers over the port's process group; rank 0 then runs the reference,
decides ``correct`` and prints the result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import traceback


def _power_limit(device: str) -> str:
    if device != "cuda":
        return "none"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"unread ({e})"


def _card_missing(spec: dict) -> str:
    import torch

    if spec["device"] != "cuda":
        return ""
    if not torch.cuda.is_available():
        return "no CUDA device"
    if torch.cuda.device_count() < spec["world"]:
        return (f"{torch.cuda.device_count()} CUDA devices, the cell needs "
                f"{spec['world']}")
    return ""


def run_mode(spec: dict) -> int:
    import horovod_tpu_torch as hvd

    from . import judge, result, session
    from .spec import load_cell
    from portbench.work.counts import peaks_for

    cell = load_cell(spec["cell"], spec["root"])
    out = session.run_rank(cell, spec["seed"], spec["seconds"],
                           spec["trace"], spec["rank"], spec["world"],
                           spec["device"], spec["t0"], spec["scratch"])
    name = session.device_name(spec["device"])
    mine = result.summary(cell, out, name, peaks_for(name))
    mine["forbidden"] = session.forbidden_modules()
    ranks = session.gather(mine, spec["world"])
    hvd.shutdown()
    if spec["rank"] != 0:
        return 0
    ref = session.reference_readings(cell, spec["seed"], spec["world"],
                                     out["device"], out["pool"])
    failed = max(r["failed"] for r in ranks)
    correct, shown = judge.verdict(judge.readings(out["checked"], ref),
                                   cell.workload["limits"], failed)
    line = result.line(cell, ranks, spec["trace"], correct, shown,
                       _power_limit(spec["device"]))
    # Last, once everything this process runs has been loaded: the
    # reference, the metric readers, the verdict.
    found = sorted({m for r in ranks for m in r["forbidden"]}
                   | set(session.forbidden_modules()))
    if found:
        print(f"portbench: modules loaded that the port must not load: "
              f"{found}", file=sys.stderr)
        return 3
    print(f"losses {dict(program=out['checked']['losses'], reference=ref['losses'])}",
          file=sys.stderr)
    result.print_line(line, shown)
    return 0


def rank_main(spec: dict) -> int:
    from . import faults

    try:
        missing = _card_missing(spec)
        if missing:
            print(f"portbench: {missing}", file=sys.stderr)
            return 2
        with faults.planted(spec.get("fault")):
            if spec["mode"] == "calibrate":
                from portbench.calibrate import calibrate_rank

                return calibrate_rank(spec)
            return run_mode(spec)
    except Exception:  # a rank's failure is reported, never a result
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(rank_main(json.loads(sys.argv[1])))
