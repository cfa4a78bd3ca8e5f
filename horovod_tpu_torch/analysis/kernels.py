"""The kernel wrappers' discipline (``kernel-dispatch`` /
``kernel-parity``).

The port's check in place of ``horovod_tpu/analysis/pallas.py``'s
``pallas-interpret-flag``.  Where the reference threads an
``interpret=`` flag so that every Pallas kernel runs on the CPU test
mesh, the port has one dispatch rule (``ops/kernel_common.py``): a CUDA
tensor launches the hand-written kernel, a CPU tensor takes the kernel's
plain PyTorch version, and there is no fallback from one to the other.
Every wrapper registered with ``@kernel`` is held to it:

``kernel-dispatch``
  (a) the wrapper's first ``if`` is ``if not on_card(<operand>):
  return <plain>(...)``, where ``<plain>`` is a function of the package
  and not itself a ``@kernel``; (b) no ``try``/``except`` in the wrapper
  (a quiet fallback to the plain version would hide a broken kernel);
  (c) the wrapper adds one to its ``launches`` count
  (``<wrapper>.launches += 1``), which ``chip_smoke.py`` reads to show
  the main path went through the kernel.

``kernel-parity``
  (d) some ``tests/test_torch_port_*.py`` names the plain version (the
  CPU parity test against the JAX reference) and ``chip_smoke.py`` names
  the wrapper (the parity check on the card); (e) every ``extern "C"``
  symbol in ``csrc/*.cu`` is bound by some ``ops/`` module (its name is
  a string there, the key of the module's ctypes signature table).
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from .core import Checker, LintConfig, SourceModule, terminal_name

_EXTERN_RE = re.compile(r'extern\s+"C"\s+[^;{(]*?\b([A-Za-z_]\w*)\s*\(')


def _is_kernel_decorated(fn: ast.FunctionDef) -> bool:
    return any(terminal_name(d) == "kernel" for d in fn.decorator_list)


def _first_if(body: List[ast.stmt]) -> Optional[ast.If]:
    for stmt in body:
        if isinstance(stmt, ast.If):
            return stmt
    return None


def _plain_branch(node: ast.If) -> Optional[str]:
    """``<plain>`` when ``node`` is ``if not on_card(x): return
    <plain>(...)``, else None."""
    test = node.test
    if not (isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not)
            and isinstance(test.operand, ast.Call)
            and terminal_name(test.operand.func) == "on_card"
            and len(test.operand.args) == 1):
        return None
    if node.orelse or len(node.body) != 1:
        return None
    ret = node.body[0]
    if not (isinstance(ret, ast.Return) and isinstance(ret.value, ast.Call)):
        return None
    return terminal_name(ret.value.func) or None


def _counts_launch(fn: ast.FunctionDef) -> bool:
    for node in ast.walk(fn):
        if (isinstance(node, ast.AugAssign) and isinstance(node.op, ast.Add)
                and isinstance(node.target, ast.Attribute)
                and node.target.attr == "launches"
                and isinstance(node.target.value, ast.Name)
                and node.target.value.id == fn.name
                and isinstance(node.value, ast.Constant)
                and node.value.value == 1):
            return True
    return False


def _names_word(text: str, name: str) -> bool:
    return re.search(rf"\b{re.escape(name)}\b", text) is not None


class KernelChecker(Checker):
    checks = ("kernel-dispatch", "kernel-parity")

    def __init__(self, cfg: LintConfig) -> None:
        super().__init__(cfg)
        # (path, line, wrapper, plain or None)
        self.wrappers: List[Tuple[str, int, str, Optional[str]]] = []
        self.functions: Set[str] = set()     # module-level defs
        self.bound: Set[str] = set()         # string constants in ops/

    def check_module(self, mod: SourceModule) -> None:
        in_ops = f"{self.cfg.package}/ops/" in mod.path
        for stmt in mod.tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions.add(stmt.name)
                if _is_kernel_decorated(stmt):
                    self._check_wrapper(mod, stmt)
        if in_ops:
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Constant) \
                        and isinstance(node.value, str):
                    self.bound.add(node.value)

    def _check_wrapper(self, mod: SourceModule, fn: ast.FunctionDef) -> None:
        first = _first_if(fn.body)
        plain = _plain_branch(first) if first is not None else None
        if plain is None:
            self.emit(
                "kernel-dispatch", mod.path, fn.lineno,
                f"@kernel {fn.name}: its first branch must be `if not "
                f"on_card(<operand>): return <plain>(...)` — the CPU "
                f"takes the plain version, the card the kernel")
        for node in ast.walk(fn):
            if isinstance(node, ast.Try) and node.handlers:
                self.emit(
                    "kernel-dispatch", mod.path, node.lineno,
                    f"@kernel {fn.name} catches exceptions around its "
                    f"launch — a quiet fallback to the plain version "
                    f"hides a broken kernel; let the launch raise")
        if not _counts_launch(fn):
            self.emit(
                "kernel-dispatch", mod.path, fn.lineno,
                f"@kernel {fn.name} never adds one to its launches count "
                f"(`{fn.name}.launches += 1` where it launches) — no run "
                f"can show its main path went through the kernel")
        self.wrappers.append((mod.path, fn.lineno, fn.name, plain))

    def finalize(self) -> None:
        kernels = {w[2] for w in self.wrappers}
        tests = "\n".join(
            p.read_text() for p in
            sorted((self.cfg.root / "tests").glob("test_torch_port_*.py")))
        smoke_path = self.cfg.root / "chip_smoke.py"
        smoke = smoke_path.read_text() if smoke_path.exists() else ""
        for path, line, name, plain in self.wrappers:
            if plain is not None and (plain not in self.functions
                                      or plain in kernels):
                self.emit(
                    "kernel-dispatch", path, line,
                    f"@kernel {name}: its CPU branch calls {plain!r}, "
                    f"which is not a plain function of the package")
            if plain is not None and not _names_word(tests, plain):
                self.emit(
                    "kernel-parity", path, line,
                    f"@kernel {name}: no tests/test_torch_port_*.py names "
                    f"its plain version {plain} — nothing holds it "
                    f"against the reference on the CPU")
            if not _names_word(smoke, name):
                self.emit(
                    "kernel-parity", path, line,
                    f"@kernel {name}: chip_smoke.py does not name it — "
                    f"nothing holds the kernel against its plain version "
                    f"on the card")
        for path, line, symbol in _extern_symbols(self.cfg):
            if symbol not in self.bound:
                self.emit(
                    "kernel-parity", path, line,
                    f"extern \"C\" {symbol} is bound by no "
                    f"{self.cfg.package}/ops/ module — a kernel nothing "
                    f"can launch")


def _extern_symbols(cfg: LintConfig) -> List[Tuple[str, int, str]]:
    out = []
    for p in sorted((cfg.root / cfg.package / "csrc").glob("*.cu")):
        text = p.read_text()
        rel = p.relative_to(cfg.root).as_posix()
        for m in _EXTERN_RE.finditer(text):
            line = text.count("\n", 0, m.start()) + 1
            out.append((rel, line, m.group(1)))
    return out


def kernel_wrappers(root: Optional[Path] = None
                    ) -> Dict[str, Tuple[str, int, Optional[str]]]:
    """``{wrapper: (path, line, plain version)}`` for every ``@kernel``
    the checker sees in the package under ``root``."""
    from . import repo_root
    from .core import _load_modules

    chk = KernelChecker(LintConfig(root=Path(root) if root else repo_root()))
    for m in _load_modules(chk.cfg):
        chk.check_module(m)
    return {name: (path, line, plain)
            for path, line, name, plain in chk.wrappers}
