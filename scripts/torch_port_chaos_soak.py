#!/usr/bin/env python3
"""Chaos soak of the PyTorch port: loop the port's fault-injection
recovery tests over random injection points and write a pass/fail
summary JSON.

The counterpart of ``scripts/chaos_soak.py`` (same flags, same summary)
for ``horovod_tpu_torch``.  Each iteration draws a fresh (fault step,
seed) pair, exports it as ``HVD_TPU_CHAOS_STEP`` / ``HVD_TPU_CHAOS_SEED``
and runs the ``chaos``-marked tests of the mode's target files in a
pytest subprocess, with a flight-recorder directory of its own
(``HVD_TPU_FLIGHT_DIR``; a failed iteration's dumps are listed in its
row under ``flight_dumps``).  The modes and their targets:

* ``train``: ``tests/test_torch_port_faults.py`` (the single-process
  twin of the reference's chaos recovery drill: ``collective:step=N``
  under ``@elastic.run``, rollback, re-init, convergence);
* ``serve``: ``tests/test_torch_port_serve_batcher.py``,
  ``_serve_router.py`` and ``_fleet.py`` (kill mid-decode and mid-
  speculative-decode, the evict drill, kill mid-migration);
* ``dcn``: ``tests/test_torch_port_topo.py`` (the cross-pod exchange);
* ``ckpt``: ``tests/test_torch_port_ckpt.py`` (kill mid-save, resume);
* ``swap``: ``tests/test_torch_port_swap.py`` (the hot-swap drill);
* ``qos``: ``tests/test_torch_port_serve_qos.py`` (the brownout drill);
* ``sim``: ``tests/test_torch_port_fleet_sim.py`` (the fleet simulator);
* ``obs``: ``tests/test_torch_port_telemetry.py`` (the collector drill).

The port's tests run each rank as a process of its own already, so
there is no ``--mp`` target: ``--mp`` is refused for every mode, by
name, as is a mode without a target.  ``--modes a,b`` runs several
modes' loops and writes one merged summary (tallies under
``per_mode``).

``--sanitize`` runs each iteration under ``HVD_TPU_SANITIZE=soft``: the
port's runtime sanitizer (``horovod_tpu_torch/analysis/sanitizer.py``)
is installed in the pytest process before collection and writes its
report at exit (``HVD_TPU_SANITIZE_REPORT``); its violations and leaked
resources are the run's ``sanitizer_findings``, totalled in
``sanitizer_findings_total``, and a run with a finding counts as
failed.  The reference's sanitizer, which the tests' conftest installs
under the same switch, writes its own report beside it
(``reference_sanitizer.json``), kept with a failed run's dumps.

Usage::

    python scripts/torch_port_chaos_soak.py --runs 20 --out soak.json
    python scripts/torch_port_chaos_soak.py --runs 5 --modes sim,qos,swap
    python scripts/torch_port_chaos_soak.py --runs 1 --mode qos --sanitize
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import random
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TARGETS = {
    # (mode, mp) -> pytest target; every target's chaos tests read
    # HVD_TPU_CHAOS_STEP/_SEED, so one knob pair drives all of them.
    # The port has no multi-process twins (its tests' ranks are
    # processes already), so there is no (mode, True) entry.
    ("train", False): "tests/test_torch_port_faults.py",
    ("serve", False): ("tests/test_torch_port_serve_batcher.py "
                       "tests/test_torch_port_serve_router.py "
                       "tests/test_torch_port_fleet.py"),
    ("dcn", False): "tests/test_torch_port_topo.py",
    ("ckpt", False): "tests/test_torch_port_ckpt.py",
    ("swap", False): "tests/test_torch_port_swap.py",
    ("qos", False): "tests/test_torch_port_serve_qos.py",
    ("sim", False): "tests/test_torch_port_fleet_sim.py",
    ("obs", False): "tests/test_torch_port_telemetry.py",
}
MODES = tuple(dict.fromkeys(mode for mode, _ in TARGETS))

# The pytest process of a --sanitize iteration: the port's sanitizer is
# installed (its report at argv[1]) before pytest collects anything, then
# the reference's report path is set for the conftest's own sanitizer.
_SANITIZED_PYTEST = """
import os, sys
sys.path.insert(0, os.getcwd())
os.environ["HVD_TPU_SANITIZE_REPORT"] = sys.argv[1]
from horovod_tpu_torch.analysis import sanitizer
sanitizer.install()
os.environ["HVD_TPU_SANITIZE_REPORT"] = sys.argv[2]
import pytest
sys.exit(pytest.main(sys.argv[3:]))
"""


def run_once(target: str, step: int, seed: int, timeout_s: float,
             flight_dir: str, sanitize: bool = False) -> dict:
    """One iteration: the target's chaos tests under the (step, seed)
    knobs; its row of the summary."""
    env = dict(os.environ)
    env.update({
        "JAX_PLATFORMS": env.get("JAX_PLATFORMS", "cpu"),
        "HVD_TPU_CHAOS_STEP": str(step),
        "HVD_TPU_CHAOS_SEED": str(seed),
        # A failed iteration's postmortem dumps (obs/flight.py) are
        # listed in its row.
        "HVD_TPU_FLIGHT_DIR": flight_dir,
    })
    args = [*target.split(), "-q", "-m", "chaos", "-p", "no:cacheprovider"]
    sanitize_report = os.path.join(flight_dir, "sanitizer.json")
    if sanitize:
        # Soft mode: violations are recorded (and flight-recorded), never
        # raised, so a drill that kills a replica mid-operation is not
        # misread as a new failure.
        os.makedirs(flight_dir, exist_ok=True)
        env["HVD_TPU_SANITIZE"] = "soft"
        cmd = [sys.executable, "-c", _SANITIZED_PYTEST, sanitize_report,
               os.path.join(flight_dir, "reference_sanitizer.json"), *args]
    else:
        cmd = [sys.executable, "-m", "pytest", *args]
    t0 = time.monotonic()
    try:
        proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                              text=True, timeout=timeout_s)
        rc, tail = proc.returncode, proc.stdout[-2000:]
    except subprocess.TimeoutExpired:
        rc, tail = -1, f"timeout after {timeout_s}s"
    result = {
        "step": step,
        "seed": seed,
        "rc": rc,
        "passed": rc == 0,
        "duration_s": round(time.monotonic() - t0, 2),
        "tail": tail,
    }
    if sanitize:
        findings = []
        try:
            with open(sanitize_report) as f:
                rep = json.load(f)
            findings = list(rep.get("violations", []))
            findings += [{"kind": "resource-leak", "message": m}
                         for m in rep.get("leaks", [])]
        except (OSError, ValueError):
            pass
        result["sanitizer_findings"] = len(findings)
        if findings:
            result["sanitizer"] = findings
            result["passed"] = False
    if result["passed"]:
        # Drills dump on every injected firing even when they recover;
        # only a failed run keeps its postmortems.
        result["tail"] = ""
        shutil.rmtree(flight_dir, ignore_errors=True)
    else:
        result["flight_dumps"] = sorted(
            glob.glob(os.path.join(flight_dir, "*.json")))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=10,
                    help="number of randomized iterations (default 10)")
    ap.add_argument("--mp", action="store_true",
                    help="the multi-process twins of the reference's "
                         "soak: the port has none, so every mode refuses "
                         "it")
    ap.add_argument("--mode", choices=MODES, default="train",
                    help="the drill to soak (the module docstring lists "
                         "each mode's target): " + ", ".join(MODES))
    ap.add_argument("--modes", default=None,
                    help="comma-separated list of modes (e.g. "
                         "'sim,qos,swap'): run every listed mode's "
                         "soak loop back to back and write ONE merged "
                         "pass/fail summary (per-mode tallies under "
                         "'per_mode', exit 0 iff every run of every "
                         "mode passed); overrides --mode")
    ap.add_argument("--sanitize", action="store_true",
                    help="run each iteration under HVD_TPU_SANITIZE=soft "
                         "with the port's sanitizer installed: its "
                         "lock-discipline and resource-leak findings are "
                         "recorded per run (sanitizer_findings), totalled "
                         "in the summary, and fail the run")
    ap.add_argument("--master-seed", type=int, default=None,
                    help="seed for the (step, seed) draw itself — a "
                         "seeded soak is replayable end to end")
    ap.add_argument("--max-step", type=int, default=24,
                    help="injection points are drawn from [0, max-step]")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="per-iteration pytest timeout in seconds")
    ap.add_argument("--out", default="chaos_soak.json",
                    help="summary JSON path (default chaos_soak.json)")
    ap.add_argument("--flight-root", default=None,
                    help="root for per-iteration flight-recorder dump "
                         "dirs (default: <out>.flight/); failed "
                         "iterations keep their dumps, passed ones are "
                         "cleaned up")
    args = ap.parse_args(argv)

    rng = random.Random(args.master_seed)
    if args.modes:
        modes = [m.strip() for m in args.modes.split(",") if m.strip()]
        if not modes:
            ap.error("--modes needs at least one mode")
        bad = [m for m in modes if (m, False) not in TARGETS]
        if bad:
            ap.error(f"--modes: unknown mode(s) {', '.join(bad)}")
    else:
        modes = [args.mode]
    for mode in modes:
        if (mode, args.mp) not in TARGETS:
            ap.error(f"--mode {mode} has no --mp target in the port")
    flight_root = os.path.abspath(args.flight_root or args.out + ".flight")
    runs = []
    for mode in modes:
        target = TARGETS[(mode, args.mp)]
        for i in range(args.runs):
            step = rng.randrange(0, args.max_step + 1)
            seed = rng.randrange(0, 1 << 30)
            print(f"[torch_port_chaos_soak] {mode} run {i + 1}/{args.runs}: "
                  f"target={target} step={step} seed={seed}", flush=True)
            # Single-mode keeps the historical iter_NNNN dump-dir names;
            # a merged soak namespaces per mode so iterations can't
            # collide across modes.
            leaf = (f"iter_{i:04d}" if len(modes) == 1
                    else f"{mode}_iter_{i:04d}")
            result = run_once(target, step, seed, args.timeout,
                              os.path.join(flight_root, leaf),
                              sanitize=args.sanitize)
            result["mode"] = mode
            print(f"[torch_port_chaos_soak]   -> "
                  f"{'PASS' if result['passed'] else 'FAIL'} "
                  f"({result['duration_s']}s)", flush=True)
            runs.append(result)

    summary = {
        # Merged across --modes: 'target'/'mode' stay the historical
        # single-mode scalars when one mode ran, comma-joined otherwise.
        "target": " ".join(dict.fromkeys(
            TARGETS[(m, args.mp)] for m in modes)),
        "mode": ",".join(modes),
        "master_seed": args.master_seed,
        "total": len(runs),
        "passed": sum(r["passed"] for r in runs),
        "failed": sum(not r["passed"] for r in runs),
        "flight_root": flight_root,
        "runs": runs,
    }
    if len(modes) > 1:
        summary["per_mode"] = {
            m: {
                "target": TARGETS[(m, args.mp)],
                "total": sum(r["mode"] == m for r in runs),
                "passed": sum(r["mode"] == m and r["passed"]
                              for r in runs),
                "failed": sum(r["mode"] == m and not r["passed"]
                              for r in runs),
            }
            for m in modes
        }
    if args.sanitize:
        summary["sanitize"] = True
        summary["sanitizer_findings_total"] = sum(
            r.get("sanitizer_findings", 0) for r in runs)
    try:   # all-green soak: don't leave an empty dump root behind
        os.rmdir(flight_root)
    except OSError:
        pass
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=2)
    print(f"[torch_port_chaos_soak] {summary['passed']}/{summary['total']} passed; "
          f"summary -> {args.out}")
    return 0 if summary["failed"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
