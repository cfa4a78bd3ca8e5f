"""hvdsan: opt-in runtime concurrency sanitizer for the distributed tier.

Counterpart of ``horovod_tpu/analysis/sanitizer.py``.  The static lock
checker (:mod:`.locks`) proves every *write site* of a ``# guarded-by:
<lock>`` field sits inside a lexical ``with <lock>:`` block — but it
cannot see reads, helper chains that mutate through an alias, or locks
held by the wrong *object*.  hvdsan closes the gap at runtime, the
Eraser/ThreadSanitizer way:

* **Descriptor instrumentation.**  Under ``HVD_TPU_SANITIZE=1``,
  :func:`install` scans the package sources for the same ``guarded-by``
  annotations the static checker consumes, imports each annotated
  module, and replaces every annotated *class* attribute with a data
  descriptor.  Every read AND write then asserts the declared lock is
  held by the current thread.  Lock attributes themselves are wrapped
  in a :class:`TrackedLock` proxy (canonical per underlying lock) that
  maintains a thread-local held-set — so "held" means *this* thread
  holds *that* lock object, not "some same-named lock somewhere".
  :func:`uninstall` puts every class back as it was.
* **Eraser lockset pass.**  Each instrumented field carries the classic
  Eraser state machine: *exclusive* while only its creating thread
  touches it (``__init__`` and single-threaded use are naturally
  exempt), *shared* from the first second-thread access.  Once shared,
  the candidate lockset — the intersection of locks held across all
  accesses — is tracked per field; an empty intersection is a race
  witness even when no single access was provably wrong.
* **Resource-lifecycle audit.**  Refcounted pools register themselves
  when the sanitizer is enabled (``BlockPool``, ``BufferPool``,
  ``ElasticDriver`` slot reservations); :func:`audit_check` reports any
  resource still held — the leaked-block / leaked-buffer / leaked-slot
  class.  ``tests/torch_port_sanitize.py`` holds the port's tests to it.

Modes (``HVD_TPU_SANITIZE``, or ``HOROVOD_SANITIZE``): ``1``/``on``/
``raise`` — violations raise :class:`SanitizerError` at the access (the
test-suite mode); ``soft``/``record`` — violations are recorded
(:func:`violations`), mirrored into the flight recorder
(``obs/flight.py``) and the metrics registry
(``hvd_tpu_sanitizer_violations_total{kind}``), and execution continues.
``HVD_TPU_SANITIZE_REPORT=<path>`` writes a JSON report of violations +
leaks at process exit.

Scope notes: only *class* attributes are instrumented — module-level
guarded globals (``obs/flight.py``'s rings etc.) stay covered by the
static write-site checker.  The module imports no torch and nothing
heavy at import time, so ``serve``/``ckpt``/``elastic`` call sites can
register resources with one cheap gate check.
"""

from __future__ import annotations

import ast
import atexit
import json
import os
import threading
import weakref
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "SanitizerError", "enabled", "mode", "install", "uninstall",
    "installed", "instrument_class", "TrackedLock", "violations",
    "reset", "maybe_register", "audit_check", "audit_reset",
    "audit_baseline", "registered", "collect_class_guards",
    "guard_inventory", "record_violations_metric",
]

_RAISE = {"1", "true", "yes", "on", "raise"}
_SOFT = {"soft", "record", "report"}


class SanitizerError(AssertionError):
    """A concurrency-discipline violation caught at runtime.  Subclasses
    ``AssertionError`` so a violation inside a test fails it like any
    broken assertion would."""


# ---------------------------------------------------------------------------
# mode / env gate
# ---------------------------------------------------------------------------

_mode_lock = threading.Lock()
_mode_cached: Optional[str] = None     # guarded-by: _mode_lock
_mode_forced: Optional[str] = None     # guarded-by: _mode_lock


def _env_mode() -> str:
    raw = os.environ.get("HOROVOD_SANITIZE") \
        or os.environ.get("HVD_TPU_SANITIZE") or ""
    raw = raw.strip().lower()
    if raw in _RAISE:
        return "raise"
    if raw in _SOFT:
        return "soft"
    return "off"


def mode() -> str:
    """Resolved sanitizer mode: ``off`` / ``raise`` / ``soft``.  Cached
    after first read (the hot-path contract); tests pin it via
    :func:`install`'s ``mode=`` or clear with :func:`reset`."""
    global _mode_cached
    m = _mode_cached
    if m is None:
        with _mode_lock:
            if _mode_cached is None:
                _mode_cached = _mode_forced or _env_mode()
            m = _mode_cached
    return m


def enabled() -> bool:
    return mode() != "off"


def _force_mode(m: Optional[str]) -> None:
    global _mode_cached, _mode_forced
    with _mode_lock:
        _mode_forced = m
        _mode_cached = m


# ---------------------------------------------------------------------------
# tracked locks + thread-local held set
# ---------------------------------------------------------------------------

_tls = threading.local()


def _held() -> "Dict[int, TrackedLock]":
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = {}
    return h


def _busy() -> bool:
    return bool(getattr(_tls, "busy", False))


class TrackedLock:
    """Canonical proxy around one ``threading`` primitive (Lock / RLock /
    Condition / Semaphore).  Forwards everything; maintains the
    per-thread held registry the guarded-attribute descriptors consult.
    ``name`` is the attribute the lock was first seen under (the
    name-based fallback for foreign-lock guards, matching the static
    checker's ``Class._lock`` semantics)."""

    def __init__(self, raw: Any, name: str) -> None:
        self._raw = raw
        self.name = name
        self._counts: Dict[int, int] = {}   # thread id -> recursion depth

    # -- acquisition ---------------------------------------------------------

    def _on_acquired(self) -> None:
        tid = threading.get_ident()
        self._counts[tid] = self._counts.get(tid, 0) + 1
        _held()[id(self)] = self

    def _on_released(self) -> None:
        tid = threading.get_ident()
        n = self._counts.get(tid, 0) - 1
        if n <= 0:
            self._counts.pop(tid, None)
            _held().pop(id(self), None)
        else:
            self._counts[tid] = n

    def acquire(self, *args: Any, **kwargs: Any) -> Any:
        got = self._raw.acquire(*args, **kwargs)
        if got is not False:
            self._on_acquired()
        return got

    def release(self, *args: Any, **kwargs: Any) -> Any:
        out = self._raw.release(*args, **kwargs)
        self._on_released()
        return out

    def __enter__(self) -> "TrackedLock":
        self._raw.__enter__()
        self._on_acquired()
        return self

    def __exit__(self, *exc: Any) -> Any:
        out = self._raw.__exit__(*exc)
        self._on_released()
        return out

    # -- Condition surface (wait keeps the wrapper registered: the
    # waiting thread touches no guarded state while blocked, and other
    # threads acquire through this same wrapper) ----------------------------

    def wait(self, timeout: Optional[float] = None) -> Any:
        return self._raw.wait(timeout)

    def wait_for(self, predicate: Any,
                 timeout: Optional[float] = None) -> Any:
        return self._raw.wait_for(predicate, timeout)

    def __getattr__(self, item: str) -> Any:
        return getattr(self._raw, item)

    def __repr__(self) -> str:   # pragma: no cover - diagnostics only
        return f"TrackedLock({self.name!r}, {self._raw!r})"


# Canonical map: one wrapper per underlying lock object, however many
# attributes it is reached through.  Strong refs by design: lock
# primitives are not weakref-able, and the sanitizer is an opt-in test/
# soak mode where lock lifetime ~ process lifetime.
_wrap_lock_registry: Dict[int, TrackedLock] = {}
_wrap_registry_lock = threading.Lock()


def _wrap(raw: Any, name: str) -> TrackedLock:
    if isinstance(raw, TrackedLock):
        return raw
    with _wrap_registry_lock:
        w = _wrap_lock_registry.get(id(raw))
        if w is None or w._raw is not raw:
            w = TrackedLock(raw, name)
            _wrap_lock_registry[id(raw)] = w
        return w


# ---------------------------------------------------------------------------
# violations
# ---------------------------------------------------------------------------

_viol_lock = threading.Lock()
_violations: List[dict] = []           # guarded-by: _viol_lock
_viol_seen: set = set()                # guarded-by: _viol_lock (dedupe keys)


def violations() -> List[dict]:
    """Recorded violations (soft mode records; raise mode records then
    raises — the report survives the exception)."""
    with _viol_lock:
        return [dict(v) for v in _violations]


def _already(kind: str, where: str) -> bool:
    with _viol_lock:
        return (kind, where) in _viol_seen


def reset() -> None:
    """Drop recorded violations, locksets, and the cached mode (tests:
    the next :func:`mode` call re-reads the env)."""
    global _mode_cached, _mode_forced
    with _viol_lock:
        _violations.clear()
        _viol_seen.clear()
    with _lockset_lock:
        _locksets.clear()
    with _mode_lock:
        _mode_forced = None
        _mode_cached = None


def record_violations_metric(vs: List[dict]) -> None:
    """Publish per-kind violation counts as
    ``hvd_tpu_sanitizer_violations_total{kind=…}`` — the
    :func:`~horovod_tpu_torch.analysis.record_findings_metric` mirror for the
    runtime tier.  Fail-soft when the metrics layer is off."""
    from ..obs import metrics as _m
    if not _m.enabled():
        return
    fam = _m.registry().counter(
        "hvd_tpu_sanitizer_violations_total",
        "hvdsan runtime concurrency-sanitizer violations per kind "
        "(lock-assert, lockset, resource-leak)")
    counts: Dict[str, int] = {}
    for v in vs:
        counts[v["kind"]] = counts.get(v["kind"], 0) + 1
    for kind, n in sorted(counts.items()):
        fam.labels(kind=kind).inc(n)


def _report(kind: str, where: str, message: str,
            witness: Optional[dict] = None) -> None:
    v = {"kind": kind, "where": where, "message": message,
         "witness": witness or {}}
    dedupe = (kind, where)
    _tls.busy = True
    try:
        with _viol_lock:
            fresh = dedupe not in _viol_seen
            if fresh:
                _viol_seen.add(dedupe)
                _violations.append(v)
        if fresh:
            try:
                from ..obs import flight as _flight
                _flight.record("sanitizer", violation=kind, where=where,
                               message=message)
            except Exception:
                pass
            try:
                record_violations_metric([v])
            except Exception:
                pass
        if mode() == "raise":
            raise SanitizerError(f"hvdsan[{kind}] {where}: {message}")
    finally:
        _tls.busy = False


# ---------------------------------------------------------------------------
# descriptors
# ---------------------------------------------------------------------------

_SHARED = "<shared>"

_lockset_lock = threading.Lock()
# field key -> {"threads": {tid: held-name-set}, "ids": candidate lock-id
# set (None = virgin), "names": candidate lock-name set}
_locksets: Dict[str, dict] = {}        # guarded-by: _lockset_lock


class _LockAttr:
    """Descriptor for a lock-holding attribute: wraps every assigned
    primitive in the canonical :class:`TrackedLock`.  Reads migrate
    pre-install raw values (instances built before :func:`install`)."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.slot = "_hvdsan_l_" + name

    def __get__(self, obj: Any, objtype: Any = None) -> Any:
        if obj is None:
            return self
        d = obj.__dict__
        if self.slot in d:
            return d[self.slot]
        if self.name in d:                      # pre-install instance
            w = _wrap(d[self.name], self.name)
            d[self.slot] = w
            return w
        raise AttributeError(self.name)

    def __set__(self, obj: Any, value: Any) -> None:
        if value is not None and not isinstance(value, TrackedLock) \
                and hasattr(value, "acquire"):
            value = _wrap(value, self.name)
        # Slot and real name stay in sync so an uninstall (or an
        # instance outliving the sanitizer) never sees stale state.
        obj.__dict__[self.slot] = value
        obj.__dict__[self.name] = value

    def __delete__(self, obj: Any) -> None:
        obj.__dict__.pop(self.slot, None)
        obj.__dict__.pop(self.name, None)


class _GuardedAttr:
    """Descriptor for one ``# guarded-by`` field: every read and write
    runs the Eraser state machine + declared-lock assertion."""

    _MISSING = object()

    def __init__(self, name: str, lock_spec: str, owner: str,
                 class_default: Any = _MISSING) -> None:
        self.name = name
        self.lock_spec = lock_spec       # "_lock" or "Class._lock"
        self.owner = owner               # "module.Class" for messages
        self.slot = "_hvdsan_v_" + name
        self.state_slot = "_hvdsan_s_" + name
        # A shadowed class-level default (``count = 0`` style) keeps
        # answering reads on instances that never assigned the field.
        self.class_default = class_default

    # -- storage -------------------------------------------------------------

    def __get__(self, obj: Any, objtype: Any = None) -> Any:
        if obj is None:
            return self
        self._check(obj, "read")
        d = obj.__dict__
        if self.slot in d:
            return d[self.slot]
        if self.name in d:                      # pre-install instance
            d[self.slot] = d[self.name]
            return d[self.slot]
        if self.class_default is not self._MISSING:
            return self.class_default
        raise AttributeError(
            f"{type(obj).__name__!s} object has no attribute {self.name!r}")

    def __set__(self, obj: Any, value: Any) -> None:
        self._check(obj, "write")
        # Dual write (slot + real name) keeps instances valid across an
        # uninstall; reads prefer the slot only for the migration case.
        obj.__dict__[self.slot] = value
        obj.__dict__[self.name] = value

    def __delete__(self, obj: Any) -> None:
        self._check(obj, "del")
        obj.__dict__.pop(self.slot, None)
        obj.__dict__.pop(self.name, None)

    # -- the check -----------------------------------------------------------

    def _check(self, obj: Any, op: str) -> None:
        if _busy() or mode() == "off":
            return
        d = obj.__dict__
        tid = threading.get_ident()
        st = d.get(self.state_slot)
        if st is None:
            d[self.state_slot] = tid        # exclusive to first thread
            return
        if st != _SHARED:
            if st == tid:
                return                      # still single-threaded
            d[self.state_slot] = _SHARED    # second thread: now shared
        held = _held()
        where = f"{self.owner}.{self.name}"
        # Eraser lockset intersection (per field, across accesses).
        # Witness threads are keyed name#ident: bare idents get REUSED
        # once a thread exits, which would collapse two sequential
        # racing threads into one witness row.
        tkey = f"{threading.current_thread().name}#{tid}"
        held_names = {w.name for w in held.values()}
        # Lockset records live per INSTANCE (the Eraser granularity is
        # the memory location): two pools each correctly guarded by
        # their own lock must not intersect to empty across instances.
        ls_slot = "_hvdsan_ls_" + self.name
        with _lockset_lock:
            rec = d.get(ls_slot)
            if rec is None:
                rec = d[ls_slot] = {"threads": {}, "ids": None}
            _locksets[where] = rec      # latest witness per field name
            rec["threads"][tkey] = sorted(held_names)
            ids = {lid: w.name for lid, w in held.items()}
            if rec["ids"] is None:
                rec["ids"] = ids
            else:
                rec["ids"] = {lid: n for lid, n in rec["ids"].items()
                              if lid in ids}
            lockset_empty = not rec["ids"]
            # The witness lockset is the IDENTITY intersection (named):
            # two threads holding different locks that happen to share a
            # name intersect to empty — exactly the wrong-object race.
            witness = {"threads": dict(rec["threads"]),
                       "lockset": sorted(set(rec["ids"].values()))}
        if not self._declared_held(obj, held):
            _report(
                "lock-assert", where,
                f"{op} of `# guarded-by: {self.lock_spec}` field without "
                f"holding {self.lock_spec} (thread {tid} holds "
                f"{sorted(held_names) or 'no tracked locks'})",
                witness)
        elif lockset_empty and len(witness["threads"]) > 1 \
                and not _already("lock-assert", where):
            # A field that already failed the declared-lock assert gets
            # no second lockset report: the intersection is empty as a
            # CONSEQUENCE of the caught violation, and re-flagging every
            # later (correctly locked) access would bury the witness.
            _report(
                "lockset", where,
                "accesses across threads share NO common lock "
                "(Eraser lockset intersection is empty) — per-thread "
                f"held sets: {witness['threads']}",
                witness)

    def _declared_held(self, obj: Any,
                       held: "Dict[int, TrackedLock]") -> bool:
        spec = self.lock_spec
        attr = spec.rsplit(".", 1)[-1]
        if "." not in spec:
            lock = obj.__dict__.get("_hvdsan_l_" + attr)
            if lock is None:
                raw = obj.__dict__.get(attr)
                lock = _wrap(raw, attr) if raw is not None else None
            if isinstance(lock, TrackedLock):
                return id(lock) in held
        # Foreign lock (`Class._lock`) or unresolvable own lock: the
        # name-based fallback — the exact semantics the static checker
        # documents for non-self receivers.
        return any(w.name == attr for w in held.values())


# ---------------------------------------------------------------------------
# annotation scan (AST, shared shape with analysis.locks)
# ---------------------------------------------------------------------------

def _package_root(root: Optional[Path]) -> Path:
    if root is not None:
        return Path(root)
    return Path(__file__).resolve().parent.parent.parent


def collect_class_guards(root: Optional[Path] = None,
                         ) -> Dict[str, Dict[str, Dict[str, str]]]:
    """Scan package sources for ``# guarded-by`` annotations on class
    attributes: ``{module: {Class: {attr: lock_spec}}}``.  Pure AST —
    usable from the CLI's ``--sanitize-report`` without
    importing the package."""
    from .core import LintConfig, iter_source_files
    from .locks import GUARDED_RE

    cfg = LintConfig(root=_package_root(root))
    out: Dict[str, Dict[str, Dict[str, str]]] = {}
    for p in iter_source_files(cfg):
        text = p.read_text()
        if "guarded-by" not in text:
            continue
        try:
            tree = ast.parse(text)
        except SyntaxError:      # pragma: no cover - tree gate runs first
            continue
        lines = text.splitlines()
        rel = p.relative_to(cfg.root).as_posix()
        modname = rel[:-3].replace("/", ".")
        for stmt in tree.body:
            if not isinstance(stmt, ast.ClassDef):
                continue
            guards: Dict[str, str] = {}
            for node in ast.walk(stmt):
                tgt = None
                if isinstance(node, ast.Assign) and len(node.targets) == 1:
                    tgt = node.targets[0]
                elif isinstance(node, ast.AnnAssign):
                    tgt = node.target
                if not (isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"):
                    continue
                if 1 <= node.lineno <= len(lines):
                    m = GUARDED_RE.search(lines[node.lineno - 1])
                    if m:
                        guards[tgt.attr] = m.group(1)
            if guards:
                out.setdefault(modname, {})[stmt.name] = guards
    return out


def guard_inventory(root: Optional[Path] = None) -> dict:
    """Summary of what :func:`install` would instrument — the
    ``--sanitize-report`` payload."""
    guards = collect_class_guards(root)
    per_module = {
        mod: {cls: dict(attrs) for cls, attrs in classes.items()}
        for mod, classes in sorted(guards.items())
    }
    n_attrs = sum(len(a) for c in guards.values() for a in c.values())
    return {
        "modules": len(guards),
        "classes": sum(len(c) for c in guards.values()),
        "attributes": n_attrs,
        "guards": per_module,
    }


# ---------------------------------------------------------------------------
# install / uninstall
# ---------------------------------------------------------------------------

_install_lock = threading.Lock()
# (class, attribute, what the class held there before: _MISSING if
# nothing), so uninstall puts back exactly what install replaced.
_installed_classes: List[Tuple[type, str, Any]] = []   # guarded-by: _install_lock
_installed_flag = False                           # guarded-by: _install_lock


def installed() -> bool:
    with _install_lock:
        return _installed_flag


def instrument_class(cls: type, guards: Dict[str, str],
                     owner: Optional[str] = None) -> int:
    """Install guarded-attribute + lock descriptors on ``cls`` for the
    given ``{attr: lock_spec}`` map.  Public so tests can instrument a
    fixture class directly.  Returns the number of attributes
    instrumented (idempotent per attribute)."""
    owner = owner or f"{cls.__module__}.{cls.__qualname__}"
    if getattr(cls, "__dictoffset__", 0) == 0:
        # __slots__-only class: no instance dict for the descriptor's
        # value/state storage.  Skipped — the static write-site checker
        # keeps covering these (the three obs metric sample classes).
        return 0
    n = 0
    lock_attrs = {spec.rsplit(".", 1)[-1] for spec in guards.values()}
    with _install_lock:
        for la in sorted(lock_attrs):
            if not isinstance(cls.__dict__.get(la), _LockAttr):
                _installed_classes.append(
                    (cls, la, cls.__dict__.get(la, _GuardedAttr._MISSING)))
                setattr(cls, la, _LockAttr(la))
        for attr, spec in sorted(guards.items()):
            if attr in lock_attrs:
                continue   # a lock is its own synchronization
            if isinstance(cls.__dict__.get(attr), _GuardedAttr):
                continue
            default = cls.__dict__.get(attr, _GuardedAttr._MISSING)
            setattr(cls, attr, _GuardedAttr(attr, spec, owner,
                                            class_default=default))
            _installed_classes.append((cls, attr, default))
            n += 1
    return n


def install(root: Optional[Path] = None,
            mode_override: Optional[str] = None) -> dict:
    """Instrument every annotated class in the package.  No-op (and
    ``{"installed": False}``) when the sanitizer is off.  Modules that
    fail to import (optional framework shims) are skipped and listed in
    the returned summary."""
    import importlib

    global _installed_flag
    if mode_override is not None:
        _force_mode(mode_override)
    if not enabled():
        return {"installed": False, "mode": mode()}
    guards = collect_class_guards(root)
    stats = {"installed": True, "mode": mode(), "modules": 0,
             "classes": 0, "attributes": 0, "skipped": []}
    for modname, classes in sorted(guards.items()):
        try:
            mod = importlib.import_module(modname)
        except Exception as e:
            stats["skipped"].append(f"{modname}: {e}")
            continue
        stats["modules"] += 1
        for clsname, attrs in sorted(classes.items()):
            cls = getattr(mod, clsname, None)
            if not isinstance(cls, type):
                stats["skipped"].append(f"{modname}.{clsname}: not found")
                continue
            stats["classes"] += 1
            stats["attributes"] += instrument_class(cls, attrs)
    with _install_lock:
        _installed_flag = True
    report_path = os.environ.get("HOROVOD_SANITIZE_REPORT") \
        or os.environ.get("HVD_TPU_SANITIZE_REPORT")
    if report_path:
        atexit.register(_write_report, report_path)
    return stats


def uninstall() -> None:
    """Remove every installed descriptor, putting back what each class
    held there before (instances created while instrumented keep their
    values under the real names too, so they stay valid; their locks
    stay wrapped in a forwarding :class:`TrackedLock`)."""
    global _installed_flag
    with _install_lock:
        for cls, attr, original in reversed(_installed_classes):
            if isinstance(cls.__dict__.get(attr), (_GuardedAttr, _LockAttr)):
                if original is _GuardedAttr._MISSING:
                    delattr(cls, attr)
                else:
                    setattr(cls, attr, original)
        _installed_classes.clear()
        _installed_flag = False
    with _lockset_lock:
        _locksets.clear()


def _write_report(path: str) -> None:
    """Process-exit report (``HVD_TPU_SANITIZE_REPORT``): violations +
    leaked resources."""
    try:
        payload = {
            "mode": mode(),
            "violations": violations(),
            "leaks": audit_check(record=False),
        }
        with open(path, "w") as f:
            json.dump(payload, f, indent=1)
    except Exception:    # fail-soft: a reporter must not mask the run
        pass


# ---------------------------------------------------------------------------
# resource-lifecycle audit
# ---------------------------------------------------------------------------

# kind -> probe returning the number of still-held resources.
_PROBES = {
    "kv_pool": lambda p: p.blocks_in_use(),
    "buffer_pool": lambda p: p.outstanding(),
    "elastic_slots": lambda d: d.reserved_slots(),
}

_audit_lock = threading.Lock()
_audited: List[Tuple[str, Any]] = []   # guarded-by: _audit_lock (weakrefs)


def maybe_register(kind: str, obj: Any) -> None:
    """Register a refcounted resource owner for the teardown audit.
    One cheap gate check when the sanitizer is off — safe to call from
    every ``__init__`` in serve/ckpt/elastic."""
    if not enabled():
        return
    assert kind in _PROBES, f"unknown audit kind {kind!r}"
    with _audit_lock:
        _audited.append((kind, weakref.ref(obj)))


def audit_baseline() -> Dict[int, int]:
    """Per-entry held counts right now (dead registrations pruned) —
    take at test setup and pass to :func:`audit_check` so long-lived
    shared fixtures are audited for what THIS test leaked (the delta),
    not for state inherited from earlier tests."""
    out: Dict[int, int] = {}
    with _audit_lock:
        _audited[:] = [(k, r) for (k, r) in _audited if r() is not None]
        entries = list(_audited)
    for i, (kind, ref) in enumerate(entries):
        obj = ref()
        if obj is None:
            continue
        try:
            out[i] = _PROBES[kind](obj)
        except Exception:
            pass
    return out


def audit_check(record: bool = True,
                baseline: Optional[Dict[int, int]] = None) -> List[str]:
    """Leak descriptions for every registered, still-live resource
    owner holding MORE than its baseline (default baseline: zero —
    anything held is a leak).  ``record=True`` also files each leak as
    a ``resource-leak`` violation (flight + metric; raises in raise
    mode like any other violation)."""
    leaks: List[str] = []
    with _audit_lock:
        entries = list(_audited)
    for i, (kind, ref) in enumerate(entries):
        obj = ref()
        if obj is None:
            continue
        try:
            n = _PROBES[kind](obj)
        except Exception:
            continue
        floor = (baseline or {}).get(i, 0)
        if n > floor:
            leaks.append(
                f"{kind}:{type(obj).__name__}@{id(obj):#x} still holds "
                f"{n} resource(s) at audit"
                + (f" (baseline {floor})" if floor else ""))
    if record:
        for leak in leaks:
            _report("resource-leak", leak.split(" still ", 1)[0], leak)
    return leaks


def registered() -> Dict[str, int]:
    """Live registrations by kind (``{"kv_pool": 1, ...}``): which
    resource owners the audit is watching right now."""
    out: Dict[str, int] = {}
    with _audit_lock:
        for kind, ref in _audited:
            if ref() is not None:
                out[kind] = out.get(kind, 0) + 1
    return out


def audit_reset() -> None:
    """Drop audit registrations (between tests)."""
    with _audit_lock:
        _audited.clear()
