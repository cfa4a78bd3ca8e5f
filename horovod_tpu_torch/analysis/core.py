"""hvdlint core: the checker framework the analyzers plug into.

Counterpart of ``horovod_tpu/analysis/core.py``.  The distributed
stack's correctness rests on *cross-file* invariants no unit test sees
whole: every rank must issue the identical collective sequence (the
classic deadlock class), every ``HVD_TPU_*`` knob must flow through
``config.py`` and ``docs/env_vars.md``, every shared mutable field must
be touched under its lock, every kernel wrapper must keep its dispatch
rule, and the fault-site / metric catalogs must match their docs.  This
package is that verification layer: pure-AST analyzers (no torch import
— the gate runs in seconds) plus the step check (:mod:`.step_check`),
which records the collectives a training step really issues on each
rank.  The CLI is ``python -m horovod_tpu_torch.analysis``.

Framework pieces:

* :class:`Finding` — one diagnostic: check id, file:line, severity,
  message.
* :class:`Checker` — base class; subclasses implement
  :meth:`Checker.check_module` (per-file AST pass) and/or
  :meth:`Checker.finalize` (whole-package pass, where cross-file
  invariants are judged).
* Suppressions — ``# hvdlint: disable=<id> -- <why>`` trailing a line
  (or on its own line, covering the next statement line).  The
  justification text is **mandatory**: an unexplained suppression is
  itself a finding (``bad-suppression``), and a suppression that
  matches nothing is reported as ``useless-suppression`` so stale
  exemptions cannot outlive the code they excused.
* :class:`LintConfig` — project paths and per-run check selection.
* :func:`run_checks` — discover files, run every registered checker,
  apply suppressions, return the surviving findings.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Finding", "Checker", "LintConfig", "Suppression", "SourceModule",
    "run_checks", "all_check_ids", "iter_source_files", "CHECK_CATALOG",
    "CHECK_GROUPS", "expand_select", "terminal_name",
]


def terminal_name(expr: "ast.expr") -> str:
    """Terminal identifier of a call target / attribute chain:
    ``hvd.ops.allreduce`` → ``allreduce``, ``allreduce`` → same, else
    "".  THE shared unwrapper every analyzer matches names with."""
    if isinstance(expr, ast.Attribute):
        return expr.attr
    if isinstance(expr, ast.Name):
        return expr.id
    return ""

SEVERITIES = ("error", "warning")

# Check-id catalog: id -> (severity, one-line description).  docs/lint.md
# renders this table; tests assert the two stay in sync.
CHECK_CATALOG: "Dict[str, Tuple[str, str]]" = {
    "rank-divergent-collective": (
        "error", "collective reachable only under a rank()-conditioned "
                 "branch or after a rank-conditioned early exit — the "
                 "cross-rank deadlock class"),
    "unknown-knob": (
        "error", "HVD_TPU_*/HOROVOD_* env name used in code but not "
                 "declared in config.py (Config.from_env or "
                 "PRE_INIT_KNOBS)"),
    "undocumented-knob": (
        "error", "declared knob with no row in docs/env_vars.md"),
    "unconsumed-knob": (
        "error", "Config field no code outside config.py ever reads "
                 "(dead knob; _NOOP_KNOBS are exempt)"),
    "raw-env-read": (
        "error", "os.environ read of a knob outside config.py that is "
                 "not registered pre-init (PRE_INIT_KNOBS)"),
    "unguarded-mutation": (
        "error", "mutation of a `# guarded-by: <lock>` field outside a "
                 "`with <lock>:` block"),
    "lock-order-cycle": (
        "error", "cycle in the cross-module lock acquisition-order "
                 "graph (ABBA deadlock class)"),
    "unknown-fault-site": (
        "error", "faults.inject()/on_* site absent from the config.py "
                 "fault grammar"),
    "fault-site-doc-drift": (
        "error", "fault site in the config.py grammar missing from "
                 "docs/fault_injection.md"),
    "unknown-mesh-axis": (
        "error", "literal mesh-axis name (PartitionSpec entry, axis= "
                 "keyword, or *_axis default) absent from the "
                 "config.py MESH_AXES plan catalog"),
    "metric-name": (
        "error", "obs metric violates naming rules (hvd_tpu_ prefix; "
                 "counters end _total, others must not)"),
    "metric-doc-drift": (
        "error", "registered obs metric missing from the docs/metrics.md "
                 "catalog"),
    "metric-tenant-cardinality": (
        "error", "tenant-labeled metric series minted outside the obs "
                 "registry's 64-series cardinality cap (an unbounded "
                 "tenant-id label is a memory leak per tenant)"),
    "span-name": (
        "error", "trace span violates naming rules (hvd_tpu_ prefix on "
                 "every literal span/record_span/instant/layer name)"),
    "span-doc-drift": (
        "error", "recorded trace span missing from the docs/tracing.md "
                 "span catalog and the port's own "
                 "(horovod_tpu_torch/obs/spans.md)"),
    "detector-doc-drift": (
        "error", "alert/detector id in the obs/detect.py DETECTORS "
                 "catalog missing from the docs/observability.md "
                 "detector table"),
    "alert-severity": (
        "error", "detector severity outside the page/ticket vocabulary "
                 "(obs/detect.py DETECTORS)"),
    "step-rank-divergence": (
        "error", "recorded train-step collective sequence (op, dtype, "
                 "element count, group size) differs across ranks, or "
                 "disagrees with the planner's bucket schedule"),
    "unhandled-request-frame": (
        "error", "wire *Request frame defined in a protocol module that "
                 "no BasicService _handle dispatches — clients get the "
                 "base handler's AckResponse (silent drift)"),
    "mismatched-response": (
        "error", "a handler's dispatch branch does not return the "
                 "frame's paired <Stem>Response (or any *Response at "
                 "all) — request/response pairing drift"),
    "protocol-doc-drift": (
        "error", "wire frame missing from the docs/serving.md protocol "
                 "table"),
    "unbounded-wait": (
        "error", "blocking call (thread join, sync-primitive wait, "
                 "queue get, lock acquire, control-plane request) with "
                 "no timeout/deadline — one wedged peer hangs the "
                 "process"),
    "kernel-dispatch": (
        "error", "@kernel wrapper whose first branch is not `if not "
                 "on_card(x): return <plain>(...)`, that wraps its launch "
                 "in try/except (a quiet fallback), or that never adds "
                 "one to its launches count"),
    "kernel-parity": (
        "error", "@kernel wrapper whose plain version no "
                 "tests/test_torch_port_*.py names or that chip_smoke.py "
                 "does not name, or an extern \"C\" symbol in csrc/*.cu "
                 "that no ops/ module binds"),
    "useless-suppression": (
        "warning", "hvdlint suppression that matched no finding"),
    "bad-suppression": (
        "error", "suppression without a justification, or naming an "
                 "unknown check id"),
}


def all_check_ids() -> List[str]:
    return list(CHECK_CATALOG)


# Named check groups for --select convenience: one analyzer family per
# alias, so CI configs say `--select protocol,waits` instead of three
# ids.  Group names deliberately do not collide with check ids.
CHECK_GROUPS: "Dict[str, Tuple[str, ...]]" = {
    "protocol": ("unhandled-request-frame", "mismatched-response",
                 "protocol-doc-drift"),
    "waits": ("unbounded-wait",),
    "locks": ("unguarded-mutation", "lock-order-cycle"),
    "knobs": ("unknown-knob", "undocumented-knob", "unconsumed-knob",
              "raw-env-read"),
    "kernels": ("kernel-dispatch", "kernel-parity"),
}


def expand_select(items: Optional[Sequence[str]]) -> Optional[List[str]]:
    """Normalize a --select list: split comma-joined values and expand
    :data:`CHECK_GROUPS` aliases into their check ids.  Unknown names
    pass through (the CLI validates and reports them)."""
    if items is None:
        return None
    out: List[str] = []
    for item in items:
        for tok in (t.strip() for t in str(item).split(",")):
            if not tok:
                continue
            for cid in CHECK_GROUPS.get(tok, (tok,)):
                if cid not in out:
                    out.append(cid)
    return out


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic, stable enough to gate CI on: ``check`` is the
    catalog id, ``path`` is repo-relative, ``line`` is 1-based."""

    check: str
    path: str
    line: int
    message: str
    severity: str = "error"

    def format(self) -> str:
        return f"{self.path}:{self.line}: {self.severity}: " \
               f"[{self.check}] {self.message}"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


# Suppression-comment syntax (module docstring has the full form): the
# separator before the justification may be ``--`` or an em/en dash; the
# justification is mandatory (enforced in parse_suppressions, reported
# as bad-suppression).
_SUPPRESS_RE = re.compile(
    r"#\s*hvdlint:\s*disable=(?P<ids>[a-z0-9,\- ]+?)"
    r"(?:\s*(?:--|—|–)\s*(?P<why>.*))?$")


@dataclasses.dataclass
class Suppression:
    path: str
    line: int            # line the suppression COVERS (itself or next)
    check_ids: Tuple[str, ...]
    why: str
    used: bool = False


def _comment_tokens(text: str) -> List[Tuple[int, int, str]]:
    """(line, col, comment_text) for every real COMMENT token — regexing
    raw lines would see suppression syntax quoted inside strings and
    docstrings (this package's own sources do exactly that)."""
    import io
    import tokenize
    out = []
    try:
        for tok in tokenize.generate_tokens(io.StringIO(text).readline):
            if tok.type == tokenize.COMMENT:
                out.append((tok.start[0], tok.start[1], tok.string))
    except (tokenize.TokenError, IndentationError,
            SyntaxError):  # pragma: no cover - the ast.parse gate ran first
        pass
    return out


def parse_suppressions(path: str, text: str) -> Tuple[List[Suppression],
                                                      List[Finding]]:
    """Scan source comments for suppressions.  A trailing comment
    covers its own line; a comment alone on a line covers the next
    line.  Malformed suppressions (no justification, unknown id) are
    findings, not silent exemptions."""
    sups: List[Suppression] = []
    findings: List[Finding] = []
    lines = text.splitlines()
    for i, col, comment in _comment_tokens(text):
        m = _SUPPRESS_RE.search(comment)
        if not m:
            if "hvdlint:" in comment and "disable" in comment:
                findings.append(Finding(
                    "bad-suppression", path, i,
                    "unparseable hvdlint suppression (syntax: "
                    "# hvdlint: disable=<check-id> -- <why>)"))
            continue
        ids = tuple(s.strip() for s in m.group("ids").split(",") if s.strip())
        why = (m.group("why") or "").strip()
        bad = [cid for cid in ids if cid not in CHECK_CATALOG]
        if bad:
            findings.append(Finding(
                "bad-suppression", path, i,
                f"unknown check id(s) {bad} in suppression; known ids: "
                f"{sorted(CHECK_CATALOG)}"))
            continue
        if not why:
            findings.append(Finding(
                "bad-suppression", path, i,
                "suppression has no justification; write "
                "# hvdlint: disable=<id> -- <why this is safe>"))
            continue
        trailing = bool(lines[i - 1][:col].strip()) if i <= len(lines) else False
        covered = i if trailing else i + 1
        sups.append(Suppression(path, covered, ids, why))
    return sups, findings


@dataclasses.dataclass
class SourceModule:
    """One parsed source file, shared by every checker so the tree is
    read and parsed exactly once per run."""

    path: str            # repo-relative, posix separators
    abspath: Path
    text: str
    tree: ast.AST
    lines: List[str]

    @property
    def modname(self) -> str:
        return self.path[:-3].replace("/", ".")


@dataclasses.dataclass
class LintConfig:
    """Project configuration for one lint run."""

    root: Path                       # repo root
    package: str = "horovod_tpu_torch"   # package dir to analyze, rel. root
    env_vars_doc: str = "docs/env_vars.md"
    fault_doc: str = "docs/fault_injection.md"
    metrics_doc: str = "docs/metrics.md"
    tracing_doc: str = "docs/tracing.md"
    port_tracing_doc: str = "horovod_tpu_torch/obs/spans.md"
    serving_doc: str = "docs/serving.md"
    observability_doc: str = "docs/observability.md"
    select: Optional[Sequence[str]] = None   # None = all checks
    exclude_dirs: Tuple[str, ...] = ("__pycache__",)

    def enabled(self, check_id: str) -> bool:
        return self.select is None or check_id in self.select

    def doc_text(self, rel: str) -> str:
        p = self.root / rel
        return p.read_text() if p.exists() else ""


def iter_source_files(cfg: LintConfig) -> List[Path]:
    pkg = cfg.root / cfg.package
    out = []
    for p in sorted(pkg.rglob("*.py")):
        if any(part in cfg.exclude_dirs for part in p.parts):
            continue
        out.append(p)
    return out


class Checker:
    """Base analyzer.  Subclasses set ``checks`` (the catalog ids they
    can emit) and override :meth:`check_module` and/or
    :meth:`finalize`.  Emitted findings route through the framework's
    suppression filter — checkers never special-case exemptions."""

    checks: Tuple[str, ...] = ()

    def __init__(self, cfg: LintConfig) -> None:
        self.cfg = cfg
        self.findings: List[Finding] = []

    def emit(self, check: str, path: str, line: int, message: str) -> None:
        assert check in self.checks, f"{type(self).__name__} emitted " \
                                     f"undeclared check {check!r}"
        sev = CHECK_CATALOG[check][0]
        self.findings.append(Finding(check, path, line, message, sev))

    def check_module(self, mod: SourceModule) -> None:  # per-file pass
        pass

    def finalize(self) -> None:                         # cross-file pass
        pass


def _load_modules(cfg: LintConfig) -> List[SourceModule]:
    mods = []
    for p in iter_source_files(cfg):
        text = p.read_text()
        rel = p.relative_to(cfg.root).as_posix()
        try:
            tree = ast.parse(text, filename=rel)
        except SyntaxError as e:
            raise RuntimeError(f"hvdlint: cannot parse {rel}: {e}") from e
        mods.append(SourceModule(rel, p, text, tree, text.splitlines()))
    return mods


def run_checks(cfg: LintConfig,
               checker_classes: Optional[Sequence[type]] = None,
               modules: Optional[List[SourceModule]] = None,
               ) -> List[Finding]:
    """Run every checker over the package; return unsuppressed findings
    (suppressed ones are dropped; unused suppressions become
    ``useless-suppression`` findings)."""
    if checker_classes is None:
        from . import default_checkers
        checker_classes = default_checkers()
    mods = modules if modules is not None else _load_modules(cfg)

    suppressions: List[Suppression] = []
    findings: List[Finding] = []
    for m in mods:
        sups, bad = parse_suppressions(m.path, m.text)
        suppressions.extend(sups)
        findings.extend(bad)

    checkers = [cls(cfg) for cls in checker_classes]
    for chk in checkers:
        for m in mods:
            chk.check_module(m)
        chk.finalize()
        findings.extend(chk.findings)

    # Suppressions are matched against the FULL finding set before any
    # --select filtering: a scoped run must not misread a legitimate
    # suppression (whose check is merely deselected) as useless.
    kept: List[Finding] = []
    for f in findings:
        sup = _matching_suppression(suppressions, f)
        if sup is not None:
            sup.used = True
        elif cfg.enabled(f.check):
            kept.append(f)
    if cfg.enabled("useless-suppression"):
        for s in suppressions:
            if not s.used:
                kept.append(Finding(
                    "useless-suppression", s.path, s.line,
                    f"suppression for {list(s.check_ids)} matched no "
                    f"finding — remove it or re-justify", "warning"))
    kept.sort(key=lambda f: (f.path, f.line, f.check))
    return kept


def _matching_suppression(sups: Iterable[Suppression],
                          f: Finding) -> Optional[Suppression]:
    for s in sups:
        if s.path == f.path and s.line == f.line and f.check in s.check_ids:
            return s
    return None
