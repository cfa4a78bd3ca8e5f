"""hvdlint for the port: ``python -m horovod_tpu_torch.analysis``.

Counterpart of ``scripts/hvdlint.py``.  Runs the AST analyzers
(rank-divergent collectives, knob consistency, lock discipline and
lock-order cycles, registry drift, wire protocol, bounded waits, the
kernel wrappers' discipline) and, with ``--step``, the step check, which
records the collectives a training step issues on each rank of a
one-process world standing in for two.  ``docs/lint.md`` lists the
check ids shared with the reference; the README's port section lists
the port's own.

Exit codes: 0 clean, 1 unsuppressed finding(s), 2 usage or internal
error (an unknown check id is named), 3 nothing analyzed (an empty run
must be loud, not green).

Usage::

    python -m horovod_tpu_torch.analysis                 # table, AST tier
    python -m horovod_tpu_torch.analysis --step          # + the step check
    python -m horovod_tpu_torch.analysis --json out.json
    python -m horovod_tpu_torch.analysis --select locks,kernels
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from . import (CHECK_CATALOG, CHECK_GROUPS, LintConfig, expand_select,
               iter_source_files, record_findings_metric, repo_root, run,
               run_step_checks)


def _table(findings) -> str:
    if not findings:
        return "hvdlint: clean (0 unsuppressed findings)"
    w_loc = max(len(f"{f.path}:{f.line}") for f in findings)
    w_chk = max(len(f.check) for f in findings)
    lines = [f"hvdlint: {len(findings)} unsuppressed finding(s)", ""]
    for f in findings:
        loc = f"{f.path}:{f.line}"
        lines.append(f"  {loc:<{w_loc}}  {f.severity:<7}  "
                     f"{f.check:<{w_chk}}  {f.message}")
    return "\n".join(lines)


def _counts(findings) -> dict:
    out: dict = {}
    for f in findings:
        out[f.check] = out.get(f.check, 0) + 1
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.analysis",
        description="distributed-correctness static analysis of "
                    "horovod_tpu_torch (docs/lint.md)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also write a JSON artifact (use '-' for stdout)")
    ap.add_argument("--step", action="store_true",
                    help="run the step check too (imports torch and "
                         "builds the shipped steps; seconds)")
    ap.add_argument("--select", action="append", default=None,
                    metavar="CHECK-ID",
                    help="run only these check ids (repeatable; "
                         "comma-separated values and group aliases — "
                         "protocol, waits, locks, knobs, kernels — expand)")
    ap.add_argument("--sanitize-report", action="store_true",
                    help="also report what the runtime sanitizer would "
                         "instrument under HVD_TPU_SANITIZE=1 and the "
                         "violations recorded in this process")
    ap.add_argument("--root", default=str(repo_root()),
                    help="repo root (default: the package's checkout)")
    args = ap.parse_args(argv)

    select = None
    if args.select:
        select = expand_select(args.select)
        unknown = [c for c in select if c not in CHECK_CATALOG]
        if unknown:
            print(f"hvdlint: unknown check id(s) {unknown}; known ids: "
                  f"{sorted(CHECK_CATALOG)}; groups: "
                  f"{sorted(CHECK_GROUPS)}", file=sys.stderr)
            return 2
    root = Path(args.root)
    try:
        if not iter_source_files(LintConfig(root=root)):
            print(f"hvdlint: no python sources under {root}/"
                  f"{LintConfig(root=root).package} — nothing analyzed",
                  file=sys.stderr)
            return 3
        findings = list(run(root, select=select))
        if args.step and (select is None
                          or "step-rank-divergence" in select):
            findings += run_step_checks()
            record_findings_metric(findings)
    except Exception as e:  # internal error ≠ finding ≠ clean
        print(f"hvdlint: internal error: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 2

    sanitize = None
    if args.sanitize_report:
        from . import sanitizer
        sanitize = sanitizer.guard_inventory(root)
        sanitize["violations"] = sanitizer.violations()
        print(f"hvdsan: would instrument {sanitize['attributes']} guarded "
              f"attribute(s) across {sanitize['classes']} class(es) in "
              f"{sanitize['modules']} module(s); "
              f"{len(sanitize['violations'])} recorded violation(s)")

    print(_table(findings))
    if args.json:
        payload = {
            "tool": "hvdlint",
            "package": LintConfig(root=root).package,
            "root": str(root),
            "step": bool(args.step),
            "select": select,
            "findings": [f.as_dict() for f in findings],
            "counts": _counts(findings),
        }
        if sanitize is not None:
            payload["sanitize"] = sanitize
        text = json.dumps(payload, indent=2, sort_keys=True)
        if args.json == "-":
            print(text)
        else:
            Path(args.json).write_text(text + "\n")
            print(f"hvdlint: JSON artifact written to {args.json}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
