"""Lock discipline (``unguarded-mutation``) and cross-module lock-order
cycle detection (``lock-order-cycle``).

The tree's lock-holding modules (batcher, router, the elastic host
manager, obs registry/export, faults, stall …) share one invariant —
*this field is only touched under that lock* — that would otherwise
live only in comments.  This analyzer makes it declarative and checked:

* A field is declared lock-guarded by a trailing annotation on the
  line that introduces it::

      self._queue = deque()    # guarded-by: _lock
      _history = []            # guarded-by: _lock          (module level)
      self.strikes = 0         # guarded-by: Router._lock   (foreign lock)

  An unqualified name resolves to a lock of the declaring class (or a
  module-level lock); ``Class._lock`` names another class's lock in
  the same module — the router pattern, where replica-state fields are
  guarded by the *router's* lock.
* Any mutation of a guarded field — assignment, augmented assignment,
  ``del``, subscript store, or a call of a known mutator method
  (``append``/``pop``/``update``/…) — outside a lexical ``with
  <lock>:`` block is a finding.  Guards are matched module-wide by
  attribute name, so ``rep.strikes += 1`` is checked even though the
  receiver is not ``self``.  ``__init__`` (and module top level) is
  exempt: the object is not yet shared while it is being built.
* Lock identities form a graph: acquiring lock B while holding lock A
  (a nested ``with``, or a call — resolved through the package call
  graph to a fixpoint — into code that acquires B) adds edge A→B.  A
  cycle is the ABBA deadlock class and is reported with a witness
  edge.

Lexical scoping means a mutation under a caller-held lock needs a
suppression with its justification — which is exactly the reviewable
artifact such a call contract should leave behind.

Counterpart of ``horovod_tpu/analysis/locks.py``, with one change to how
a call finds its callee.  The reference resolves a call by its terminal
name: same module first, then the one definition of that name in the
package.  That lets an attribute call on a receiver nobody can type
(``self._file.write(...)``, ``flow.queue.remove(...)``) land on an
unrelated class's ``write`` or ``remove`` only because the name is
unique today, and invents lock-order edges.  Here a call resolves only
through what its receiver is known to be:

* ``f(...)``: a function ``f`` of the same module, or the one imported
  under that name;
* ``self.m(...)`` / ``cls.m(...)``: a method of the enclosing class or
  of its bases;
* ``mod.f(...)``: a function of the module imported as ``mod``, and
  ``Cls.m(...)`` a method of a class defined or imported under ``Cls``;
* ``x.m(...)`` / ``self.x.m(...)``: a method of ``x``'s class, where
  ``x`` is a parameter annotated with a package class, a local assigned
  only from one package class's constructor, or an attribute the class
  assigns only from one package class's constructor.

Any other receiver resolves to nothing.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from .core import Checker, LintConfig, SourceModule, terminal_name

GUARDED_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_][A-Za-z0-9_.]*)")

# Method names that mutate their receiver in place.
MUTATORS = {
    "append", "appendleft", "extend", "extendleft", "insert", "add",
    "update", "setdefault", "pop", "popleft", "popitem", "remove",
    "discard", "clear", "sort", "reverse", "rotate",
}

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore"}


def _is_lock_ctor(value: ast.expr) -> bool:
    if not isinstance(value, ast.Call):
        return False
    f = value.func
    name = f.attr if isinstance(f, ast.Attribute) else (
        f.id if isinstance(f, ast.Name) else "")
    return name in _LOCK_CTORS


def _looks_like_lock(name: str) -> bool:
    return "lock" in name.lower() or name.endswith("_cv")


class _FuncInfo:
    """Per-function facts for the lock-order graph."""

    def __init__(self, qualname: str, modname: str,
                 cls_name: Optional[str]) -> None:
        self.qualname = qualname
        self.modname = modname
        self.cls_name = cls_name
        self.acquires: Set[str] = set()          # lock ids acquired directly
        self.calls: Set[_CallKey] = set()        # callees (unresolved)
        # (held lock id, callee, path, line) — edges resolved once the
        # whole package call graph is known.
        self.calls_under: List[Tuple[str, _CallKey, str, int]] = []
        self.nested: List[Tuple[str, str, str, int]] = []  # (A, B, path, line)


class LockChecker(Checker):
    checks = ("unguarded-mutation", "lock-order-cycle")

    def __init__(self, cfg: LintConfig) -> None:
        super().__init__(cfg)
        self.funcs: Dict[str, _FuncInfo] = {}
        # (modname, class or None, function name) -> qualname
        self.defs: Dict[Tuple[str, Optional[str], str], str] = {}
        # class name -> [(modname, base names)]
        self.classes: Dict[str, List[Tuple[str, List[str]]]] = {}
        # (modname, class) -> {attr: constructor's class name}
        self.attr_types: Dict[Tuple[str, str], Dict[str, str]] = {}
        # modname -> {alias: (dotted module, imported name or None)}
        self.imports: Dict[str, Dict[str, Tuple[str, Optional[str]]]] = {}
        self.modnames: Set[str] = set()

    # ----- per-module pass ------------------------------------------------
    def check_module(self, mod: SourceModule) -> None:
        self._collect_types(mod)
        module_locks: Set[str] = set()
        module_guarded: Dict[str, str] = {}   # module var -> lock id
        class_locks: Dict[str, Set[str]] = {}  # class -> lock attr names
        for stmt in mod.tree.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                name = stmt.targets[0].id
                if _is_lock_ctor(stmt.value):
                    module_locks.add(name)
            elif isinstance(stmt, ast.ClassDef):
                class_locks[stmt.name] = self._collect_class_locks(stmt)

        def resolve(lockname: str, cls_name: Optional[str]) -> str:
            if "." in lockname:                      # Class._lock
                return f"{mod.modname}.{lockname}"
            if cls_name and (lockname in class_locks.get(cls_name, ())
                             or not (lockname in module_locks)):
                return f"{mod.modname}.{cls_name}.{lockname}"
            return f"{mod.modname}.{lockname}"

        # Second scan: collect guarded-by annotations.  Per-class maps
        # bind `self.X` precisely; the module-wide union covers foreign
        # receivers (the router's `rep.strikes` pattern).
        attr_guards: Dict[str, str] = {}              # any-receiver fallback
        class_guards: Dict[str, Dict[str, str]] = {}  # class -> attr -> lock
        for stmt in mod.tree.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                g = self._annotation(mod, stmt.lineno)
                if g:
                    module_guarded[stmt.targets[0].id] = resolve(g, None)
            elif isinstance(stmt, ast.ClassDef):
                for node in ast.walk(stmt):
                    tgt = None
                    if isinstance(node, ast.Assign) and len(node.targets) == 1:
                        tgt = node.targets[0]
                    elif isinstance(node, ast.AnnAssign):
                        tgt = node.target
                    if isinstance(tgt, ast.Attribute) and isinstance(
                            tgt.value, ast.Name) and tgt.value.id == "self":
                        g = self._annotation(mod, node.lineno)
                        if g:
                            lid = resolve(g, stmt.name)
                            attr_guards[tgt.attr] = lid
                            class_guards.setdefault(stmt.name, {})[
                                tgt.attr] = lid

        ctx = _ModuleCtx(module_locks, module_guarded, attr_guards,
                         class_locks, class_guards)
        for stmt in mod.tree.body:
            if isinstance(stmt, ast.ClassDef):
                for sub in stmt.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        self._check_function(
                            mod, sub, stmt.name, ctx,
                            exempt=sub.name in ("__init__", "__new__"))
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._check_function(mod, stmt, None, ctx, exempt=False)

    def _collect_class_locks(self, cls: ast.ClassDef) -> Set[str]:
        locks: Set[str] = set()
        for node in ast.walk(cls):
            tgt = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt = node.targets[0]
            elif isinstance(node, ast.AnnAssign):
                tgt = node.target
            if isinstance(tgt, ast.Attribute) and isinstance(
                    tgt.value, ast.Name) and tgt.value.id == "self":
                value = getattr(node, "value", None)
                if (value is not None and _is_lock_ctor(value)) \
                        or _looks_like_lock(tgt.attr):
                    locks.add(tgt.attr)
        return locks

    def _annotation(self, mod: SourceModule, lineno: int) -> Optional[str]:
        if 1 <= lineno <= len(mod.lines):
            m = GUARDED_RE.search(mod.lines[lineno - 1])
            if m:
                return m.group(1)
        return None

    # ----- per-function lexical walk --------------------------------------
    def _check_function(self, mod: SourceModule, fn: ast.FunctionDef,
                        cls_name: Optional[str], ctx: "_ModuleCtx",
                        exempt: bool) -> None:
        qual = f"{mod.path}::{cls_name + '.' if cls_name else ''}{fn.name}"
        info = _FuncInfo(qual, mod.modname, cls_name)
        self.funcs[qual] = info
        self.defs[(mod.modname, cls_name, fn.name)] = qual
        local_types = _local_types(fn)

        def lock_id(expr: ast.expr) -> Optional[str]:
            if isinstance(expr, ast.Attribute) and isinstance(
                    expr.value, ast.Name) and expr.value.id == "self" \
                    and cls_name:
                if expr.attr in ctx.class_locks.get(cls_name, set()) \
                        or _looks_like_lock(expr.attr):
                    return f"{mod.modname}.{cls_name}.{expr.attr}"
            if isinstance(expr, ast.Name) and (
                    expr.id in ctx.module_locks
                    or _looks_like_lock(expr.id)):
                return f"{mod.modname}.{expr.id}"
            # rep._lock style: a lock attribute on a non-self receiver
            # is identified by the receiver-independent attr name.
            if isinstance(expr, ast.Attribute) and _looks_like_lock(expr.attr):
                return f"{mod.modname}.?.{expr.attr}"
            return None

        def guard_for(expr: ast.expr) -> Optional[Tuple[str, str]]:
            if isinstance(expr, ast.Attribute):
                recv = (expr.value.id if isinstance(expr.value, ast.Name)
                        else "…")
                if recv == "self":
                    # self.X binds to the enclosing class's own guards —
                    # another class's same-named attr is a different field.
                    lock = ctx.class_guards.get(cls_name or "", {}).get(
                        expr.attr)
                else:
                    lock = ctx.attr_guards.get(expr.attr)
                if lock:
                    return f"{recv}.{expr.attr}", lock
            if isinstance(expr, ast.Name) and expr.id in ctx.module_guarded:
                return expr.id, ctx.module_guarded[expr.id]
            return None

        def walk(node: ast.AST, held: Tuple[str, ...]) -> None:
            if isinstance(node, (ast.With, ast.AsyncWith)):
                acquired = []
                for item in node.items:
                    lid = lock_id(item.context_expr)
                    if lid:
                        # `with A, B:` acquires left-to-right, so B's
                        # predecessor is A even though both sit in one
                        # statement — the ABBA one-liner must edge too.
                        prior = (held + tuple(acquired))
                        if prior:
                            info.nested.append((prior[-1], lid, mod.path,
                                                node.lineno))
                        acquired.append(lid)
                        info.acquires.add(lid)
                for item in node.items:
                    walk(item.context_expr, held)
                new_held = held + tuple(acquired)
                for s in node.body:
                    walk(s, new_held)
                return
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node is not fn:
                # A closure body (thread targets, callbacks) executes
                # later, NOT under the lexically-enclosing with — check
                # it with an empty held set so unguarded mutations in
                # `threading.Thread(target=...)` bodies stay visible.
                for s in node.body:
                    walk(s, ())
                return
            if isinstance(node, ast.Call):
                callee = _call_key(node.func, local_types)
                if callee is not None:
                    info.calls.add(callee)
                    if held:
                        info.calls_under.append((held[-1], callee, mod.path,
                                                 node.lineno))
                f = node.func
                if isinstance(f, ast.Attribute) and f.attr in MUTATORS:
                    g = guard_for(f.value)
                    if g and not exempt:
                        self._require(g, held, mod, node.lineno,
                                      f"{g[0]}.{f.attr}(...)")
            for tgt, desc in _mutation_targets(node):
                g = guard_for(tgt)
                if g and not exempt:
                    self._require(g, held, mod, node.lineno, desc % g[0])
            for child in ast.iter_child_nodes(node):
                walk(child, held)

        for stmt in fn.body:
            walk(stmt, ())

    def _require(self, guard: Tuple[str, str], held: Tuple[str, ...],
                 mod: SourceModule, lineno: int, what: str) -> None:
        field, lock = guard
        short = lock.rsplit(".", 1)[1]
        if lock in held:
            return
        # Name-only fallback for unresolvable receivers, on BOTH sides:
        # `_state.config = ...` under `with st.lock:` (st aliases the
        # singleton) cannot be matched exactly by a lexical checker.
        # But a `self.X` mutation CAN name its lock exactly (`with
        # self.<lock>:`), so there the fallback is off — holding some
        # other object's same-named lock is precisely the race this
        # check exists for.
        if not field.startswith("self.") and any(
                ".?." in h and h.rsplit(".", 1)[1] == short for h in held):
            return
        self.emit(
            "unguarded-mutation", mod.path, lineno,
            f"{what} mutates a field declared `# guarded-by: {short}` "
            f"outside `with {short}:` — wrap the mutation or suppress "
            f"with the call contract that protects it")

    # ----- lock-order graph -----------------------------------------------
    def finalize(self) -> None:
        may_acquire: Dict[str, Set[str]] = {
            q: set(i.acquires) for q, i in self.funcs.items()}
        resolved_calls: Dict[str, Set[str]] = {}
        for q, info in self.funcs.items():
            outs: Set[str] = set()
            for callee in info.calls:
                outs.update(self._resolve(q, callee))
            resolved_calls[q] = outs
        changed = True
        while changed:
            changed = False
            for q, outs in resolved_calls.items():
                for callee_q in outs:
                    extra = may_acquire.get(callee_q, set()) - may_acquire[q]
                    if extra:
                        may_acquire[q] |= extra
                        changed = True

        edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
        for q, info in self.funcs.items():
            for a, b, path, line in info.nested:
                if a != b:
                    edges.setdefault((a, b), (path, line))
            for held, callee, path, line in info.calls_under:
                for callee_q in self._resolve(q, callee):
                    for b in may_acquire.get(callee_q, ()):
                        if b != held:
                            edges.setdefault((held, b), (path, line))

        for cycle in _find_cycles({k for k in edges}):
            members = set(cycle)
            witness = next(((a, b) for (a, b) in sorted(edges)
                            if a in members and b in members))
            path, line = edges[witness]
            self.emit(
                "lock-order-cycle", path, line,
                f"lock acquisition cycle {' -> '.join(cycle + [cycle[0]])}: "
                f"two threads taking these locks in opposite order "
                f"deadlock — impose one global order or drop a lock")

    # ----- call resolution ------------------------------------------------
    def _collect_types(self, mod: SourceModule) -> None:
        """Record what the resolver needs of one module: its imports,
        its classes with their bases, and the attributes each class
        assigns only from one constructor."""
        self.modnames.add(mod.modname)
        pkg = mod.modname.split(".")[:-1]
        imports: Dict[str, Tuple[str, Optional[str]]] = {}
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        imports[a.asname] = (a.name, None)
                    else:
                        top = a.name.split(".")[0]
                        imports[top] = (top, None)
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    base = pkg[:len(pkg) - (node.level - 1)]
                    dotted = ".".join(base + ([node.module]
                                              if node.module else []))
                else:
                    dotted = node.module or ""
                for a in node.names:
                    imports[a.asname or a.name] = (dotted, a.name)
        self.imports[mod.modname] = imports
        for stmt in mod.tree.body:
            if not isinstance(stmt, ast.ClassDef):
                continue
            self.classes.setdefault(stmt.name, []).append(
                (mod.modname, [terminal_name(b) for b in stmt.bases]))
            types: Dict[str, Optional[str]] = {}
            for node in ast.walk(stmt):
                if not (isinstance(node, ast.Assign)
                        and len(node.targets) == 1):
                    continue
                tgt = node.targets[0]
                if not (isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"):
                    continue
                ctor = _ctor_name(node.value)
                if tgt.attr in types and types[tgt.attr] != ctor:
                    ctor = None          # assigned from two sources
                types[tgt.attr] = ctor
            self.attr_types[(mod.modname, stmt.name)] = {
                k: v for k, v in types.items() if v}

    def _module(self, dotted: str) -> Optional[str]:
        """The scanned module a dotted import name denotes, if any."""
        if dotted in self.modnames:
            return dotted
        if dotted + ".__init__" in self.modnames:
            return dotted + ".__init__"
        return None

    def _class(self, name: str, hint: str
               ) -> Optional[Tuple[str, List[str]]]:
        """(modname, bases) of the package class ``name`` as seen from
        module ``hint``: defined there, imported there, or unique."""
        cands = self.classes.get(name, [])
        for c in cands:
            if c[0] == hint:
                return c
        imp = self.imports.get(hint, {}).get(name)
        if imp is not None and imp[1] is not None:
            src = self._module(imp[0])
            for c in cands:
                if c[0] == src:
                    return c
        return cands[0] if len(cands) == 1 else None

    def _method(self, cls: str, meth: str, hint: str,
                depth: int = 0) -> List[str]:
        found = self._class(cls, hint)
        if found is None or depth > 8:
            return []
        modname, bases = found
        q = self.defs.get((modname, cls, meth))
        if q is not None:
            return [q]
        for b in bases:
            out = self._method(b, meth, modname, depth + 1)
            if out:
                return out
        return []

    def _resolve(self, caller_qual: str, callee: "_CallKey") -> List[str]:
        """Resolve a call through what its receiver is known to be (the
        module docstring lists the rules); an unknown receiver resolves
        to nothing — an over-broad graph would invent cycles."""
        info = self.funcs[caller_qual]
        mod = info.modname
        kind, recv, name = callee
        if kind == "name":
            q = self.defs.get((mod, None, name))
            if q is not None:
                return [q]
            imp = self.imports.get(mod, {}).get(name)
            if imp is not None and imp[1] is not None:
                src = self._module(imp[0])
                if src is not None:
                    q = self.defs.get((src, None, imp[1]))
                    return [q] if q else []
            return []
        if kind == "self":
            return (self._method(info.cls_name, name, mod)
                    if info.cls_name else [])
        if kind == "attr":
            if not info.cls_name:
                return []
            found = self._class(info.cls_name, mod)
            cls = (self.attr_types.get((found[0], info.cls_name), {})
                   .get(recv) if found else None)
            return self._method(cls, name, mod) if cls else []
        if kind == "typed":
            return self._method(recv, name, mod)
        # kind == "alias": a module or a class bound in this module
        imp = self.imports.get(mod, {}).get(recv)
        if imp is not None:
            dotted = imp[0] if imp[1] is None else f"{imp[0]}.{imp[1]}"
            src = self._module(dotted)
            if src is not None:
                q = self.defs.get((src, None, name))
                return [q] if q else []
        return self._method(recv, name, mod)


# (kind, receiver, name): kind "name" (``f()``), "self" (``self.m()``),
# "attr" (``self.x.m()``, receiver x), "typed" (receiver is a class
# name), "alias" (``n.m()``: n a module or a class).
_CallKey = Tuple[str, str, str]


def _ctor_name(value: ast.expr) -> Optional[str]:
    """``Cls`` for ``Cls(...)`` / ``mod.Cls(...)`` with a capitalised
    terminal name (a constructor by convention), else None."""
    if isinstance(value, ast.Call):
        name = terminal_name(value.func)
        if name[:1].isupper():
            return name
    return None


def _annotation_class(ann: Optional[ast.expr]) -> Optional[str]:
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        name = ann.value.strip().rsplit(".", 1)[-1]
        return name if name.isidentifier() and name[:1].isupper() else None
    if isinstance(ann, (ast.Name, ast.Attribute)):
        name = terminal_name(ann)
        return name if name[:1].isupper() else None
    return None


def _local_types(fn: ast.FunctionDef) -> Dict[str, str]:
    """Names of ``fn`` whose class is known: parameters annotated with a
    class, and locals every assignment of which is one constructor."""
    out: Dict[str, Optional[str]] = {}
    a = fn.args
    for arg in a.posonlyargs + a.args + a.kwonlyargs:
        cls = _annotation_class(arg.annotation)
        if cls:
            out[arg.arg] = cls
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    ctor = _ctor_name(node.value)
                    if tgt.id in out and out[tgt.id] != ctor:
                        ctor = None
                    out[tgt.id] = ctor
    return {k: v for k, v in out.items() if v}


def _call_key(func: ast.expr, local_types: Dict[str, str]
              ) -> Optional[_CallKey]:
    if isinstance(func, ast.Name):
        return ("name", "", func.id)
    if not isinstance(func, ast.Attribute):
        return None
    recv = func.value
    if isinstance(recv, ast.Name):
        if recv.id in ("self", "cls"):
            return ("self", "", func.attr)
        if recv.id in local_types:
            return ("typed", local_types[recv.id], func.attr)
        return ("alias", recv.id, func.attr)
    if isinstance(recv, ast.Attribute) and isinstance(recv.value, ast.Name) \
            and recv.value.id == "self":
        return ("attr", recv.attr, func.attr)
    return None


class _ModuleCtx:
    def __init__(self, module_locks: Set[str], module_guarded: Dict[str, str],
                 attr_guards: Dict[str, str],
                 class_locks: Dict[str, Set[str]],
                 class_guards: Dict[str, Dict[str, str]]) -> None:
        self.module_locks = module_locks
        self.module_guarded = module_guarded
        self.attr_guards = attr_guards
        self.class_locks = class_locks
        self.class_guards = class_guards


def _mutation_targets(node: ast.AST):
    """Yield ``(target_expr, 'desc %s')`` for assignment-like mutations.
    For subscript stores the *base* is what must be guarded."""
    if isinstance(node, ast.Assign):
        for t in node.targets:
            yield from _targets_of(t)
    elif isinstance(node, ast.AugAssign):
        yield from _targets_of(node.target)
    elif isinstance(node, ast.AnnAssign):
        if node.value is not None:
            yield from _targets_of(node.target)
    elif isinstance(node, ast.Delete):
        for t in node.targets:
            yield from _targets_of(t, deleting=True)


def _targets_of(t: ast.expr, deleting: bool = False):
    verb = "del %s" if deleting else "%s = ..."
    if isinstance(t, (ast.Attribute, ast.Name)):
        yield t, verb
    elif isinstance(t, ast.Subscript):
        yield t.value, "del %s[...]" if deleting else "%s[...] = ..."
    elif isinstance(t, (ast.Tuple, ast.List)):
        for e in t.elts:
            yield from _targets_of(e, deleting)


def _find_cycles(edges: Set[Tuple[str, str]]) -> List[List[str]]:
    """One witness cycle per strongly-connected component with >1 node
    (or a self-loop) — deterministic, no exponential enumeration."""
    graph: Dict[str, List[str]] = {}
    for a, b in sorted(edges):
        graph.setdefault(a, []).append(b)
        graph.setdefault(b, [])
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    sccs: List[List[str]] = []
    counter = [0]

    def strongconnect(v: str) -> None:
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        for w in graph[v]:
            if w not in index:
                strongconnect(w)
                low[v] = min(low[v], low[w])
            elif w in on_stack:
                low[v] = min(low[v], index[w])
        if low[v] == index[v]:
            comp = []
            while True:
                w = stack.pop()
                on_stack.discard(w)
                comp.append(w)
                if w == v:
                    break
            sccs.append(comp)

    for v in sorted(graph):
        if v not in index:
            strongconnect(v)

    cycles = []
    for comp in sccs:
        if len(comp) > 1:
            cycles.append(sorted(comp))
        elif (comp[0], comp[0]) in edges:
            cycles.append(comp)
    return cycles
