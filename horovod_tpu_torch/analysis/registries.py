"""Registry consistency (``unknown-fault-site`` /
``fault-site-doc-drift`` / ``metric-name`` / ``metric-doc-drift``).

Counterpart of ``horovod_tpu/analysis/registries.py``; the port's
sites, axes, metrics, spans and detectors carry the reference's names,
so the same ``docs/`` catalogs hold them.  Each catalog is checked
against its single source of truth:

* **Fault sites.**  ``config.FAULT_SITES`` (and its ``_FAULT_MODES``
  grammar) is the namespace.  Every literal spec passed to
  ``faults.inject("site:…")`` and every ``faults.on_<site>*`` hook
  called in the package must name a declared site, and every declared
  site must have a row in ``docs/fault_injection.md`` — a chaos drill
  against an undeclared site silently no-ops, which invalidates the
  run it was supposed to harden.
* **Metric names.**  Registrations on the obs registry
  (``.counter("…")`` / ``.gauge("…")`` / ``.histogram("…")`` with a
  literal name) must follow the naming rules — ``hvd_tpu_`` prefix,
  counters end ``_total``, gauges/histograms must not — and appear in
  the ``docs/metrics.md`` catalog.  Dashboards are written against the
  docs; an undocumented series is invisible operational surface.
* **Mesh axes** (``unknown-mesh-axis``).  ``config.MESH_AXES`` is the
  planner's axis vocabulary (``plan/``).  Every literal
  axis name in a ``PartitionSpec``/``P(...)``, every string passed to
  an ``axis``/``axis_name``/``*_axis`` keyword, and every such
  parameter default must come from that catalog — a typo'd axis name
  builds a mesh/sharding that silently diverges from the plan's
  derived wiring instead of failing loudly.
* **Span names** (``span-name`` / ``span-doc-drift``).  Literal span
  names passed to the tracing layer (``trace.span("…")`` /
  ``trace.record_span("…")`` / ``trace.instant("…")`` on any
  trace-module receiver, plus the ``_record_phase(req, "…", …)``
  span-forwarding helper convention) must carry the ``hvd_tpu_`` prefix
  and have a
  row in the ``docs/tracing.md`` span catalog — ``trace_merge``'s
  critical-path reports and the flight-recorder postmortems are read
  against that catalog, so an undocumented span is a hop nobody can
  attribute.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Optional, Set, Tuple

from .core import Checker, LintConfig, SourceModule, terminal_name as _terminal

_METRIC_KINDS = ("counter", "gauge", "histogram")


class FaultSiteChecker(Checker):
    checks = ("unknown-fault-site", "fault-site-doc-drift")

    def __init__(self, cfg: LintConfig) -> None:
        super().__init__(cfg)
        self.sites: Set[str] = set()
        self.site_line: int = 1
        self.config_path: str = ""
        self.hooks: Set[str] = set()       # on_* defs in faults.py
        # (path, line, site) for inject() literals; (path, line, hook)
        self.inject_refs: list = []
        self.hook_refs: list = []

    def check_module(self, mod: SourceModule) -> None:
        if mod.path.endswith("/config.py"):
            self.config_path = mod.path
            for node in mod.tree.body:
                if isinstance(node, ast.Assign) and any(
                        isinstance(t, ast.Name) and t.id == "FAULT_SITES"
                        for t in node.targets):
                    self.site_line = node.lineno
                    if isinstance(node.value, (ast.Tuple, ast.List)):
                        self.sites = {
                            e.value for e in node.value.elts
                            if isinstance(e, ast.Constant)
                            and isinstance(e.value, str)}
        if mod.path.endswith("/faults.py"):
            for node in mod.tree.body:
                if isinstance(node, ast.FunctionDef) and \
                        node.name.startswith("on_"):
                    self.hooks.add(node.name)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _terminal(node.func)
            if name == "inject" and _receiver_is(node.func, "faults"):
                if node.args and isinstance(node.args[0], ast.Constant) \
                        and isinstance(node.args[0].value, str):
                    spec = node.args[0].value
                    for clause in spec.split(";"):
                        site = clause.strip().partition(":")[0].strip()
                        if site:
                            self.inject_refs.append(
                                (mod.path, node.lineno, site))
            elif name.startswith("on_") and _receiver_is(node.func, "faults") \
                    and not mod.path.endswith("/faults.py"):
                self.hook_refs.append((mod.path, node.lineno, name))

    def finalize(self) -> None:
        if not self.sites:
            raise RuntimeError("hvdlint: config.FAULT_SITES not found — "
                               "fault-site checks need the grammar")
        doc = self.cfg.doc_text(self.cfg.fault_doc)
        for path, line, site in self.inject_refs:
            if site not in self.sites:
                self.emit(
                    "unknown-fault-site", path, line,
                    f"faults.inject() names site {site!r}, not in the "
                    f"config.py grammar {sorted(self.sites)} — the drill "
                    f"would no-op")
        for path, line, hook in self.hook_refs:
            if hook not in self.hooks:
                self.emit(
                    "unknown-fault-site", path, line,
                    f"faults.{hook}() has no hook definition in "
                    f"faults.py — the site cannot fire")
        for site in sorted(self.sites):
            # A documented site has a catalog row: a table line starting
            # with | `site` |.
            if not re.search(rf"^\|\s*`{re.escape(site)}`\s*\|", doc,
                             re.MULTILINE):
                self.emit(
                    "fault-site-doc-drift", self.config_path, self.site_line,
                    f"fault site {site!r} has no row in the "
                    f"{self.cfg.fault_doc} site catalog")


def _receiver_is(func: ast.expr, modname: str) -> bool:
    """True only for the package idiom ``faults.x(...)`` — bare ``on_*``
    names are callback parameters all over the tree (retry hooks,
    elastic callbacks), not fault hooks."""
    return (isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Name)
            and func.value.id == modname)


_TENANT_LABELS = ("tenant", "tenant_id")


class MetricNameChecker(Checker):
    checks = ("metric-name", "metric-doc-drift",
              "metric-tenant-cardinality")

    def __init__(self, cfg: LintConfig) -> None:
        super().__init__(cfg)
        # name -> (kind, path, line) first registration seen
        self.metrics: Dict[str, Tuple[str, str, int]] = {}

    def _check_tenant_labels(self, mod: SourceModule) -> None:
        """``metric-tenant-cardinality``: a ``.labels(tenant=…)`` call
        must sit on an obs-registry metric family — the registry's
        64-series cap (overflow collapses to ``other``) is what makes
        an open-ended tenant-id label safe.  A tenant label minted on
        anything else (a hand-rolled dict-of-series, a raw exporter)
        grows one series per tenant forever: at "millions of users"
        that is a memory leak wearing a dashboard."""
        # One-level local resolution: ``fam = reg.counter(...)`` then
        # ``fam.labels(tenant=...)`` is the capped idiom too.
        family_names: Set[str] = set()
        for node in ast.walk(mod.tree):
            if (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)
                    and _terminal(node.value.func) in _METRIC_KINDS
                    and _metric_receiver(node.value.func)):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        family_names.add(t.id)
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and _terminal(node.func) == "labels"):
                continue
            tenant_kw = next((kw for kw in node.keywords
                              if kw.arg in _TENANT_LABELS), None)
            if tenant_kw is None:
                continue
            recv = node.func.value if isinstance(node.func,
                                                 ast.Attribute) else None
            capped = (
                (isinstance(recv, ast.Call)
                 and _terminal(recv.func) in _METRIC_KINDS
                 and _metric_receiver(recv.func))
                or (isinstance(recv, ast.Name)
                    and recv.id in family_names))
            if not capped:
                self.emit(
                    "metric-tenant-cardinality", mod.path, node.lineno,
                    f"per-tenant label {tenant_kw.arg!r} minted outside "
                    f"the obs registry — tenant-labeled series must ride "
                    f"the registry's 64-series overflow cap "
                    f"(docs/metrics.md cardinality rules)")

    def check_module(self, mod: SourceModule) -> None:
        if mod.path.endswith("obs/metrics.py"):
            return  # the generic registry itself registers nothing
        self._check_tenant_labels(mod)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            kind = _terminal(node.func)
            if kind not in _METRIC_KINDS or not node.args:
                continue
            arg = node.args[0]
            if not (isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)):
                continue
            name = arg.value
            if not name.startswith("hvd_tpu_"):
                # Same method names exist off the registry (e.g.
                # Timeline.counter takes a free-form track name); only
                # registry-shaped receivers are held to metric rules.
                if _metric_receiver(node.func):
                    self.emit(
                        "metric-name", mod.path, node.lineno,
                        f"metric {name!r} must carry the hvd_tpu_ prefix "
                        f"(docs/metrics.md naming rules)")
                continue
            if kind == "counter" and not name.endswith("_total"):
                self.emit(
                    "metric-name", mod.path, node.lineno,
                    f"counter {name!r} must end in _total "
                    f"(docs/metrics.md naming rules)")
            if kind in ("gauge", "histogram") and name.endswith("_total"):
                self.emit(
                    "metric-name", mod.path, node.lineno,
                    f"{kind} {name!r} must not end in _total — that "
                    f"suffix is the counter marker")
            prev = self.metrics.get(name)
            if prev and prev[0] != kind:
                self.emit(
                    "metric-name", mod.path, node.lineno,
                    f"{name!r} registered as {kind} here but as "
                    f"{prev[0]} at {prev[1]}:{prev[2]} — one family, "
                    f"one kind")
            self.metrics.setdefault(name, (kind, mod.path, node.lineno))

    def finalize(self) -> None:
        doc = self.cfg.doc_text(self.cfg.metrics_doc)
        documented = set(re.findall(r"hvd_tpu_[a-z0-9_]+", doc))
        for name, (kind, path, line) in sorted(self.metrics.items()):
            if name not in documented:
                self.emit(
                    "metric-doc-drift", path, line,
                    f"{kind} {name!r} is registered but missing from the "
                    f"{self.cfg.metrics_doc} catalog")


class SpanNameChecker(Checker):
    checks = ("span-name", "span-doc-drift")

    _FUNCS = ("span", "record_span", "instant", "layer")
    _FORWARDER = "_record_phase"

    def __init__(self, cfg: LintConfig) -> None:
        super().__init__(cfg)
        # name -> (path, line) first recording seen
        self.spans: Dict[str, Tuple[str, int]] = {}

    def check_module(self, mod: SourceModule) -> None:
        if mod.path.endswith("obs/trace.py"):
            return  # the generic tracing layer itself records nothing
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            term = _terminal(node.func)
            if term == self._FORWARDER and len(node.args) >= 2:
                # span-forwarding helper convention: name is the second
                # positional (``self._record_phase(req, "name", ...)``)
                arg = node.args[1]
            elif term in self._FUNCS and _trace_receiver(node.func) \
                    and node.args:
                arg = node.args[0]
            else:
                continue
            if not (isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)):
                continue
            name = arg.value
            if not name.startswith("hvd_tpu_"):
                self.emit(
                    "span-name", mod.path, node.lineno,
                    f"span {name!r} must carry the hvd_tpu_ prefix "
                    f"({self.cfg.tracing_doc} naming rules)")
                continue
            self.spans.setdefault(name, (mod.path, node.lineno))

    def finalize(self) -> None:
        # The port's own spans have a catalog of their own; the message
        # stays the reference's, letter for letter.
        doc = (self.cfg.doc_text(self.cfg.tracing_doc)
               + self.cfg.doc_text(self.cfg.port_tracing_doc))
        documented = set(re.findall(r"hvd_tpu_[a-z0-9_]+", doc))
        for name, (path, line) in sorted(self.spans.items()):
            if name not in documented:
                self.emit(
                    "span-doc-drift", path, line,
                    f"span {name!r} is recorded but missing from the "
                    f"{self.cfg.tracing_doc} span catalog")


_ALERT_SEVERITIES = ("page", "ticket")


class ObservabilityChecker(Checker):
    """``detector-doc-drift`` / ``alert-severity``: the telemetry
    plane's alert catalog (``obs/detect.py``'s literal ``DETECTORS``
    tuple, plus the ``slo_burn:`` family the SLO evaluator emits) must
    match the operator-facing detector table in
    ``docs/observability.md``.  Pages are routed and runbooks are
    written against that table — an undocumented alert id is a page
    nobody can act on, and a typo'd severity silently drops out of the
    paging pipeline."""

    checks = ("detector-doc-drift", "alert-severity")

    def __init__(self, cfg: LintConfig) -> None:
        super().__init__(cfg)
        self.detect_path: str = ""
        self.catalog_line: int = 1
        # id -> (severity, line)
        self.detectors: Dict[str, Tuple[str, int]] = {}
        self.emits_slo_burn: bool = False
        self.slo_path: str = ""
        self.slo_line: int = 1

    def check_module(self, mod: SourceModule) -> None:
        if mod.path.endswith("obs/detect.py"):
            self.detect_path = mod.path
            for node in mod.tree.body:
                if isinstance(node, ast.Assign) and any(
                        isinstance(t, ast.Name) and t.id == "DETECTORS"
                        for t in node.targets):
                    self.catalog_line = node.lineno
                    if isinstance(node.value, (ast.Tuple, ast.List)):
                        for row in node.value.elts:
                            if (isinstance(row, (ast.Tuple, ast.List))
                                    and len(row.elts) == 2
                                    and all(isinstance(e, ast.Constant)
                                            and isinstance(e.value, str)
                                            for e in row.elts)):
                                det_id, sev = (e.value for e in row.elts)
                                self.detectors[det_id] = (sev, row.lineno)
        if mod.path.endswith("obs/slo.py"):
            # The SLO evaluator's alert family: any f-string id with
            # the slo_burn: prefix marks the family as emitted.
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Constant) \
                        and isinstance(node.value, str) \
                        and node.value.startswith("slo_burn:"):
                    self.emits_slo_burn = True
                    self.slo_path = mod.path
                    self.slo_line = node.lineno

    def finalize(self) -> None:
        if not self.detect_path and not self.emits_slo_burn:
            return   # tree has no telemetry plane (fixture roots)
        if not self.detectors:
            raise RuntimeError(
                "hvdlint: obs/detect.py DETECTORS not found — the "
                "observability checks need the alert catalog")
        doc = self.cfg.doc_text(self.cfg.observability_doc)
        for det_id in sorted(self.detectors):
            sev, line = self.detectors[det_id]
            if sev not in _ALERT_SEVERITIES:
                self.emit(
                    "alert-severity", self.detect_path, line,
                    f"detector {det_id!r} has severity {sev!r}, not in "
                    f"{_ALERT_SEVERITIES} — it would drop out of the "
                    f"paging pipeline")
            if not re.search(rf"^\|\s*`{re.escape(det_id)}`\s*\|", doc,
                             re.MULTILINE):
                self.emit(
                    "detector-doc-drift", self.detect_path, line,
                    f"detector {det_id!r} has no row in the "
                    f"{self.cfg.observability_doc} detector catalog")
        if self.emits_slo_burn and "slo_burn" not in doc:
            self.emit(
                "detector-doc-drift", self.slo_path, self.slo_line,
                f"the slo_burn: alert family is emitted but not "
                f"described in {self.cfg.observability_doc}")


_SPEC_CALLS = ("P", "PartitionSpec")
_AXIS_KWARGS = ("axis", "axis_name")


def _is_axis_param(name: str) -> bool:
    return name in _AXIS_KWARGS or name.endswith("_axis")


class MeshAxisChecker(Checker):
    """``unknown-mesh-axis``: literal axis names must come from the
    ``config.MESH_AXES`` planner vocabulary (the MeshPlan axis catalog,
    docs/mesh_plan.md).  Covered positions: positional entries of
    ``P(...)``/``PartitionSpec(...)`` (including tuple entries — the
    multi-axis reduce wire), string values of ``axis``/``axis_name``/
    ``*_axis`` keywords on any call, and string defaults of parameters
    with those names."""

    checks = ("unknown-mesh-axis",)

    def __init__(self, cfg: LintConfig) -> None:
        super().__init__(cfg)
        self.axes: Set[str] = set()
        self.refs: list = []       # (path, line, name, where)

    def _collect(self, mod: SourceModule, node: ast.expr,
                 where: str) -> None:
        elts = (node.elts if isinstance(node, (ast.Tuple, ast.List))
                else [node])
        for e in elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, str):
                self.refs.append((mod.path, e.lineno, e.value, where))

    def check_module(self, mod: SourceModule) -> None:
        if mod.path.endswith("/config.py"):
            for node in mod.tree.body:
                if isinstance(node, ast.Assign) and any(
                        isinstance(t, ast.Name) and t.id == "MESH_AXES"
                        for t in node.targets):
                    if isinstance(node.value, (ast.Tuple, ast.List)):
                        self.axes = {
                            e.value for e in node.value.elts
                            if isinstance(e, ast.Constant)
                            and isinstance(e.value, str)}
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                if _terminal(node.func) in _SPEC_CALLS:
                    for arg in node.args:
                        self._collect(mod, arg, "PartitionSpec entry")
                for kw in node.keywords:
                    if kw.arg and _is_axis_param(kw.arg):
                        self._collect(mod, kw.value,
                                      f"{kw.arg}= keyword")
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                a = node.args
                pos = a.posonlyargs + a.args
                for param, default in zip(pos[len(pos)
                                              - len(a.defaults):],
                                          a.defaults):
                    if _is_axis_param(param.arg) and default is not None:
                        self._collect(mod, default,
                                      f"{param.arg}= default")
                for param, default in zip(a.kwonlyargs, a.kw_defaults):
                    if _is_axis_param(param.arg) and default is not None:
                        self._collect(mod, default,
                                      f"{param.arg}= default")

    def finalize(self) -> None:
        if not self.axes:
            raise RuntimeError("hvdlint: config.MESH_AXES not found — "
                               "mesh-axis checks need the axis catalog")
        for path, line, name, where in self.refs:
            if name not in self.axes:
                self.emit(
                    "unknown-mesh-axis", path, line,
                    f"axis name {name!r} ({where}) is not in the "
                    f"config.MESH_AXES plan catalog "
                    f"{tuple(sorted(self.axes))} — a typo'd axis "
                    f"silently diverges from the MeshPlan wiring "
                    f"(docs/mesh_plan.md)")


def _trace_receiver(func: ast.expr) -> bool:
    """Is the receiver the tracing module (``trace.span``,
    ``trace_mod.record_span``, ``_trace.instant``)?  Same-named methods
    exist elsewhere (``Timeline`` has free-form track names) and are
    not held to span rules."""
    if not isinstance(func, ast.Attribute):
        return False
    recv = func.value
    text = ""
    if isinstance(recv, ast.Attribute):
        text = recv.attr
    elif isinstance(recv, ast.Name):
        text = recv.id
    return "trace" in text.lower()


def _metric_receiver(func: ast.expr) -> bool:
    """Is the receiver registry-shaped (``registry().counter``,
    ``reg.gauge``, ``self._registry.histogram``)?"""
    if not isinstance(func, ast.Attribute):
        return False
    recv = func.value
    text = ""
    if isinstance(recv, ast.Call):
        text = _terminal(recv.func)
    elif isinstance(recv, ast.Attribute):
        text = recv.attr
    elif isinstance(recv, ast.Name):
        text = recv.id
    return "reg" in text.lower()
