"""hvdlint: distributed-correctness static analysis for horovod_tpu_torch.

Counterpart of ``horovod_tpu/analysis/``.  Usage (the CLI wraps this,
``python -m horovod_tpu_torch.analysis``)::

    from horovod_tpu_torch import analysis
    findings = analysis.run()               # AST analyzers, no torch
    findings += analysis.run_step_checks()  # recorded-step analyzer

The analyzers and the check catalog live in :mod:`.core`,
:mod:`.rank_divergence`, :mod:`.knobs`, :mod:`.locks`,
:mod:`.registries`, :mod:`.protocol`, :mod:`.waits`, :mod:`.kernels` and
:mod:`.step_check`; ``docs/lint.md`` is the catalog of the ids the port
shares with the reference, and the README's port section lists the
port's own.  Zero unsuppressed findings is a tier-1 invariant
(``tests/test_torch_port_analysis.py``).

The AST tier and the sanitizer import no torch at module level.  Only
:func:`run_step_checks` and :func:`record_findings_metric` reach the
rest of the port, lazily.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence

from .core import (CHECK_CATALOG, CHECK_GROUPS, Checker, Finding,
                   LintConfig, all_check_ids, expand_select,
                   iter_source_files, run_checks)

__all__ = [
    "CHECK_CATALOG", "CHECK_GROUPS", "Checker", "Finding", "LintConfig",
    "all_check_ids", "expand_select", "iter_source_files", "run_checks",
    "default_checkers", "repo_root", "run", "run_step_checks",
    "record_findings_metric",
]


def default_checkers() -> List[type]:
    from .kernels import KernelChecker
    from .knobs import KnobChecker
    from .locks import LockChecker
    from .protocol import ProtocolChecker
    from .rank_divergence import RankDivergenceChecker
    from .registries import (FaultSiteChecker, MeshAxisChecker,
                             MetricNameChecker, ObservabilityChecker,
                             SpanNameChecker)
    from .waits import WaitChecker
    return [RankDivergenceChecker, KnobChecker, LockChecker,
            FaultSiteChecker, MeshAxisChecker, MetricNameChecker,
            SpanNameChecker, ObservabilityChecker, ProtocolChecker,
            WaitChecker, KernelChecker]


def repo_root() -> Path:
    """The checkout the package was imported from (the package's parent,
    where ``docs/``, ``tests/`` and ``chip_smoke.py`` live)."""
    return Path(__file__).resolve().parent.parent.parent


def run(root: Optional[Path] = None,
        select: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run the AST analyzers over the package; returns unsuppressed
    findings (empty = clean)."""
    cfg = LintConfig(root=Path(root) if root else repo_root(),
                     select=expand_select(list(select)) if select else None)
    return run_checks(cfg)


def run_step_checks(microbatches: int = 2) -> List[Finding]:
    """Run the recorded-step analyzer over the shipped step factories
    (imports torch and builds steps; seconds, not milliseconds)."""
    from . import step_check
    return step_check.run_step_checks(microbatches=microbatches)


def record_findings_metric(findings: Sequence[Finding]) -> None:
    """Publish per-check finding counts as
    ``hvd_tpu_lint_findings_total{check=…}`` so lint state shows up in
    metrics snapshots next to the signals it protects.  A metrics layer
    that is off (HVD_TPU_METRICS=0) records nothing."""
    from ..obs import metrics as _m
    if not _m.enabled():
        return
    fam = _m.registry().counter(
        "hvd_tpu_lint_findings_total",
        "Unsuppressed hvdlint findings per check id, accumulated over "
        "in-process analyzer runs")
    counts: dict = {}
    for f in findings:
        counts[f.check] = counts.get(f.check, 0) + 1
    for check, n in sorted(counts.items()):
        fam.labels(check=check).inc(n)
    if not counts:
        # A clean run still leaves a scrapeable series: 0 findings is
        # the signal dashboards alert on the absence of.
        fam.labels(check="none").inc(0)
