"""Knob consistency (``unknown-knob`` / ``undocumented-knob`` /
``unconsumed-knob`` / ``raw-env-read``).

The knob contract the tree grew by convention, now machine-checked:

* ``config.py`` is THE knob namespace.  A knob is *declared* when
  ``Config.from_env`` (or a helper it calls) reads it via the
  ``_env*`` family, or when it is listed in ``config.PRE_INIT_KNOBS``
  (knobs legitimately read before/outside ``init`` — launcher wiring,
  import-time gates, subprocess re-exec sentinels).
* Every ``HVD_TPU_*``/``HOROVOD_*`` name used in package code must be
  declared (``unknown-knob``) and have a row in ``docs/env_vars.md``
  (``undocumented-knob``; either prefix spelling in the docs counts —
  the two are aliases).
* A raw ``os.environ`` **read** of a knob outside ``config.py`` must
  name a ``PRE_INIT_KNOBS`` entry (``raw-env-read``) — everything else
  flows through the typed frozen ``Config``.  Writes are exempt: the
  ray/spark integrations legitimately *set* wiring vars for workers.
* Every ``Config`` field must be read somewhere outside ``config.py``
  (``unconsumed-knob``) — a dead knob is doc rot waiting to mislead an
  operator.  ``_NOOP_KNOBS`` (accepted-but-warns reference knobs) are
  exempt: their consumption *is* the warning.

Counterpart of ``horovod_tpu/analysis/knobs.py``; the port's
``Config.from_env`` is a classmethod building ``cls(...)``, which counts
like ``Config(...)``.

Everything here is AST-driven against the real ``config.py`` source,
so adding a knob the blessed way is automatically picked up; adding it
any other way is a finding.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from .core import Checker, LintConfig, SourceModule, terminal_name

KNOB_RE = re.compile(r"^(HVD_TPU_|HOROVOD_)([A-Z0-9_]+)$")

_ENV_HELPERS = ("_env", "_env_bool", "_env_int", "_env_float",
                "_env_opt_int", "_env_pos_int", "_env_int_tuple",
                "_env_choice")


def _knob_suffix(s: str) -> Optional[str]:
    m = KNOB_RE.match(s)
    return m.group(2) if m else None


def _env_suffixes_in(node: ast.AST) -> Set[str]:
    """Suffixes read via ``_env*("SUFFIX", ...)`` anywhere under node."""
    out: Set[str] = set()
    for sub in ast.walk(node):
        if (isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name)
                and sub.func.id in _ENV_HELPERS and sub.args
                and isinstance(sub.args[0], ast.Constant)
                and isinstance(sub.args[0].value, str)):
            out.add(sub.args[0].value)
    return out


class ConfigModel:
    """Parsed view of ``config.py``: declared knobs, field map,
    pre-init registry, no-op set."""

    def __init__(self, tree: ast.AST, path: str) -> None:
        self.path = path
        self.declared: Set[str] = set()          # knob suffixes
        self.pre_init: Set[str] = set()
        self.noop: Set[str] = set()
        self.field_to_suffixes: Dict[str, Set[str]] = {}
        self.decl_lines: Dict[str, int] = {}
        self._parse(tree)

    def _parse(self, tree: ast.AST) -> None:
        helper_suffixes: Dict[str, Set[str]] = {}
        from_env: Optional[ast.FunctionDef] = None
        for node in ast.walk(tree):
            if isinstance(node, ast.FunctionDef):
                if node.name == "from_env":
                    from_env = node
                elif node.name not in _ENV_HELPERS:
                    sufs = _env_suffixes_in(node)
                    if sufs:
                        helper_suffixes[node.name] = sufs
            elif isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name) and tgt.id in (
                            "PRE_INIT_KNOBS",):
                        self.pre_init |= _string_elts(node.value)
                    if isinstance(tgt, ast.Name) and tgt.id == "_NOOP_KNOBS":
                        self.noop |= _dict_keys(node.value)
        if from_env is None:
            raise RuntimeError(
                f"hvdlint: {self.path} has no Config.from_env — the knob "
                f"checker keys its namespace off it")

        # Names assigned inside from_env (e.g. ``timeline = _env("TIMELINE")``).
        local_sufs: Dict[str, Set[str]] = {}
        for node in ast.walk(from_env):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                sufs = self._suffixes_of_expr(node.value, helper_suffixes, {})
                if sufs:
                    local_sufs[node.targets[0].id] = sufs

        for node in ast.walk(from_env):
            # ``Config(...)`` or, in the classmethod, ``cls(...)``.
            if isinstance(node, ast.Call) \
                    and terminal_name(node.func) in ("Config", "cls"):
                for kw in node.keywords:
                    if kw.arg is None:
                        continue
                    sufs = self._suffixes_of_expr(kw.value, helper_suffixes,
                                                  local_sufs)
                    self.field_to_suffixes[kw.arg] = sufs
                    for s in sufs:
                        self.declared.add(s)
                        self.decl_lines.setdefault(s, kw.value.lineno)

    def _suffixes_of_expr(self, expr: ast.expr,
                          helper_suffixes: Dict[str, Set[str]],
                          local_sufs: Dict[str, Set[str]]) -> Set[str]:
        out = set(_env_suffixes_in(expr))
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Call):
                callee = terminal_name(sub.func)
                if callee in helper_suffixes:
                    out |= helper_suffixes[callee]
            elif isinstance(sub, ast.Name) and sub.id in local_sufs:
                out |= local_sufs[sub.id]
        return out

    def known(self, suffix: str) -> bool:
        return suffix in self.declared or suffix in self.pre_init


def _string_elts(node: ast.expr) -> Set[str]:
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return {e.value for e in node.elts
                if isinstance(e, ast.Constant) and isinstance(e.value, str)}
    return set()


def _dict_keys(node: ast.expr) -> Set[str]:
    if isinstance(node, ast.Dict):
        return {k.value for k in node.keys
                if isinstance(k, ast.Constant) and isinstance(k.value, str)}
    return set()


def _is_env_read(call: ast.Call) -> bool:
    """``os.environ.get(...)`` / ``os.getenv(...)`` — the read side."""
    f = call.func
    if isinstance(f, ast.Attribute):
        if f.attr == "get" and isinstance(f.value, ast.Attribute) \
                and f.value.attr == "environ":
            return True
        if f.attr == "getenv":
            return True
    return False


class KnobChecker(Checker):
    checks = ("unknown-knob", "undocumented-knob", "unconsumed-knob",
              "raw-env-read")

    def __init__(self, cfg: LintConfig) -> None:
        super().__init__(cfg)
        self.model: Optional[ConfigModel] = None
        # (path, line, suffix, is_raw_read) for every knob reference
        self.refs: List[Tuple[str, int, str, bool]] = []
        self.field_reads: Set[str] = set()

    def check_module(self, mod: SourceModule) -> None:
        is_config = mod.path.endswith("/config.py")
        if is_config:
            self.model = ConfigModel(mod.tree, mod.path)
            return
        docstring_lines = _docstring_linenos(mod.tree)
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Attribute):
                self.field_reads.add(node.attr)
            # config._env("SUFFIX") imported elsewhere is a blessed read
            # of the dual-prefix namespace — still must name a known knob.
            # (Some modules carry a local _env taking FULL names; those
            # literals are already caught by the constant scan below.)
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                    and node.func.id == "_env" and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                    and not KNOB_RE.match(node.args[0].value)
                    and re.fullmatch(r"[A-Z0-9_]+", node.args[0].value)):
                self.refs.append((mod.path, node.lineno,
                                  node.args[0].value, False))
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                if node.lineno in docstring_lines:
                    continue
                suf = _knob_suffix(node.value)
                if suf:
                    self.refs.append((mod.path, node.lineno, suf, False))
            if isinstance(node, ast.Call) and _is_env_read(node) and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    suf = _knob_suffix(arg.value)
                    if suf:
                        self.refs.append((mod.path, node.lineno, suf, True))
            # os.environ["X"] subscript reads (loads only)
            if isinstance(node, ast.Subscript) and isinstance(
                    node.ctx, ast.Load) and isinstance(
                    node.value, ast.Attribute) and \
                    node.value.attr == "environ" and isinstance(
                    node.slice, ast.Constant) and isinstance(
                    node.slice.value, str):
                suf = _knob_suffix(node.slice.value)
                if suf:
                    self.refs.append((mod.path, node.lineno, suf, True))

    def finalize(self) -> None:
        if self.model is None:
            raise RuntimeError("hvdlint: config.py not found in the scanned "
                               "package — knob checks need it")
        doc = self.cfg.doc_text(self.cfg.env_vars_doc)
        doc_sufs = {_knob_suffix(m) for m in re.findall(
            r"(?:HVD_TPU_|HOROVOD_)[A-Z0-9_]+", doc)}

        flagged_unknown: Set[Tuple[str, int, str]] = set()
        for path, line, suf, is_read in self.refs:
            if not self.model.known(suf):
                key = (path, line, suf)
                if key not in flagged_unknown:
                    flagged_unknown.add(key)
                    self.emit(
                        "unknown-knob", path, line,
                        f"env knob *_{suf} is not declared in config.py "
                        f"(Config.from_env) nor registered in "
                        f"PRE_INIT_KNOBS — add it to the namespace or "
                        f"drop the read")
            elif is_read and suf not in self.model.pre_init:
                self.emit(
                    "raw-env-read", path, line,
                    f"raw os.environ read of *_{suf} outside config.py; "
                    f"knobs flow through the typed Config — read "
                    f"basics.config() instead, or register the knob in "
                    f"config.PRE_INIT_KNOBS if it must be readable "
                    f"before init")

        for suf in sorted(self.model.declared | self.model.pre_init):
            if suf not in doc_sufs:
                self.emit(
                    "undocumented-knob", self.model.path,
                    self.model.decl_lines.get(suf, 1),
                    f"knob *_{suf} is declared but has no row in "
                    f"{self.cfg.env_vars_doc}")

        for field, sufs in sorted(self.model.field_to_suffixes.items()):
            if field in self.field_reads:
                continue
            if sufs & self.model.noop:
                continue  # consumption IS the warn_noop_knobs warning
            self.emit(
                "unconsumed-knob", self.model.path,
                min((self.model.decl_lines.get(s, 1) for s in sufs),
                    default=1),
                f"Config.{field} ({', '.join(sorted(sufs)) or 'no env'}) "
                f"is never read outside config.py — dead knob")


def _docstring_linenos(tree: ast.AST) -> Set[int]:
    """Line numbers spanned by docstrings (knob names in prose are
    documentation, not configuration surface)."""
    out: Set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef,
                             ast.AsyncFunctionDef, ast.ClassDef)):
            if (node.body and isinstance(node.body[0], ast.Expr)
                    and isinstance(node.body[0].value, ast.Constant)
                    and isinstance(node.body[0].value.value, str)):
                c = node.body[0].value
                out.update(range(c.lineno, (c.end_lineno or c.lineno) + 1))
    return out
