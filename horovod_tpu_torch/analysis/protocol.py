"""Wire-protocol consistency (``unhandled-request-frame``,
``mismatched-response``, ``protocol-doc-drift``).

Counterpart of ``horovod_tpu/analysis/protocol.py``, the same logic over
the port's frames (``runner/common/network.py``, ``serve/server.py``)
and ``BasicService`` handlers.

The control plane grew from 4 frame types to 20+ across three modules
(``runner/common/network.py``, ``runner/common/service.py``,
``serve/server.py``) — and nothing verified that a newly added
``*Request`` class is actually dispatched by some :class:`BasicService`
handler, that the handler answers with the frame's paired response, or
that the operator-facing protocol table keeps up.  A request nobody
dispatches falls through to the base handler's ``AckResponse`` — the
silent-drift failure where a client blocks on a typed response that
never comes.

What this checker proves, purely from the AST:

* **Protocol modules** are those defining :class:`BasicService` or a
  subclass of it (by base-name match — the serving endpoint and the
  driver/task services).  A *wire frame* is any class named
  ``*Request`` (nonempty stem) defined in a protocol module; internal
  queue items (``ServeRequest``) and non-protocol ``Request`` classes
  are exempt because their modules host no service.
* **Dispatch** — every wire frame appears as the class operand of some
  ``isinstance(req, Frame)`` test inside a ``_handle`` method (or a
  tuple operand of one), package-wide: frames defined in ``network.py``
  may be dispatched by the serving endpoint and vice versa.
* **Pairing** — inside the dispatching branch, the handler must return
  the frame's stem-matched ``<Stem>Response`` when such a class exists
  anywhere in the protocol modules (``PingRequest`` → ``PingResponse``);
  frames with no paired response class must still return *some*
  ``*Response``.  Returns are resolved through one level of
  ``self._helper(...)`` indirection (the serving endpoint's pattern).
* **Docs** — every wire frame has a row in the ``docs/serving.md``
  protocol table (backtick-quoted, like every other doc-drift check).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .core import Checker, LintConfig, SourceModule, terminal_name


def _base_names(cls: ast.ClassDef) -> Set[str]:
    return {terminal_name(b) for b in cls.bases}


class ProtocolChecker(Checker):
    checks = ("unhandled-request-frame", "mismatched-response",
              "protocol-doc-drift")

    def __init__(self, cfg: LintConfig) -> None:
        super().__init__(cfg)
        # (frame name) -> (path, line) of its class def
        self.frames: Dict[str, Tuple[str, int]] = {}
        self.responses: Set[str] = set()
        self.dispatched: Set[str] = set()
        # frame -> (path, line, returned response-class names)
        self.branch_returns: Dict[str, Tuple[str, int, Set[str]]] = {}
        self._service_mods: Set[str] = set()

    # ----- per-module pass ------------------------------------------------
    def check_module(self, mod: SourceModule) -> None:
        classes = [s for s in mod.tree.body if isinstance(s, ast.ClassDef)]
        is_protocol_mod = any(
            c.name == "BasicService" or "BasicService" in _base_names(c)
            for c in classes)
        if not is_protocol_mod:
            return
        self._service_mods.add(mod.path)
        helpers: Dict[Tuple[str, str], ast.FunctionDef] = {}
        for cls in classes:
            for fn in cls.body:
                if isinstance(fn, ast.FunctionDef):
                    helpers[(cls.name, fn.name)] = fn
        for cls in classes:
            if cls.name.endswith("Request") and len(cls.name) > len("Request"):
                self.frames[cls.name] = (mod.path, cls.lineno)
            elif cls.name.endswith("Response") \
                    and len(cls.name) > len("Response"):
                self.responses.add(cls.name)
        for cls in classes:
            handler = helpers.get((cls.name, "_handle"))
            if handler is not None:
                self._scan_handler(mod, cls, handler, helpers)

    def _scan_handler(self, mod: SourceModule, cls: ast.ClassDef,
                      fn: ast.FunctionDef,
                      helpers: Dict[Tuple[str, str], ast.FunctionDef]) -> None:
        for node in ast.walk(fn):
            if not (isinstance(node, ast.If)
                    and isinstance(node.test, ast.Call)
                    and terminal_name(node.test.func) == "isinstance"
                    and len(node.test.args) == 2):
                continue
            for frame in self._isinstance_operands(node.test.args[1]):
                self.dispatched.add(frame)
                returned = self._returned_responses(cls, node.body, helpers)
                prev = self.branch_returns.get(frame)
                if prev is None:
                    self.branch_returns[frame] = (mod.path, node.lineno,
                                                  returned)
                else:
                    self.branch_returns[frame] = (prev[0], prev[1],
                                                  prev[2] | returned)

    @staticmethod
    def _isinstance_operands(arg: ast.expr) -> List[str]:
        ops = arg.elts if isinstance(arg, ast.Tuple) else [arg]
        return [n for n in (terminal_name(o) for o in ops)
                if n.endswith("Request") and len(n) > len("Request")]

    def _returned_responses(self, cls: ast.ClassDef, body: List[ast.stmt],
                            helpers: Dict[Tuple[str, str], ast.FunctionDef],
                            depth: int = 0) -> Set[str]:
        """Response-class names a dispatch branch can return: direct
        ``return XResponse(...)`` constructors, plus one level of
        ``return self._helper(...)`` indirection."""
        out: Set[str] = set()
        for stmt in body:
            for node in ast.walk(stmt):
                if not isinstance(node, ast.Return) or node.value is None:
                    continue
                val = node.value
                if isinstance(val, ast.Call):
                    name = terminal_name(val.func)
                    if name.endswith("Response"):
                        out.add(name)
                    elif depth == 0 and isinstance(val.func, ast.Attribute) \
                            and isinstance(val.func.value, ast.Name) \
                            and val.func.value.id == "self":
                        helper = helpers.get((cls.name, name))
                        if helper is not None:
                            out |= self._returned_responses(
                                cls, helper.body, helpers, depth=1)
        return out

    # ----- cross-file pass ------------------------------------------------
    def finalize(self) -> None:
        doc = self.cfg.doc_text(getattr(self.cfg, "serving_doc",
                                        "docs/serving.md"))
        for frame, (path, line) in sorted(self.frames.items()):
            if frame not in self.dispatched:
                self.emit(
                    "unhandled-request-frame", path, line,
                    f"wire frame {frame} is dispatched by no BasicService "
                    f"_handle — clients sending it get the base handler's "
                    f"AckResponse (silent protocol drift); add an "
                    f"isinstance dispatch or delete the frame")
                continue
            stem = frame[:-len("Request")]
            paired = stem + "Response"
            binfo = self.branch_returns.get(frame)
            if binfo is None:
                continue
            bpath, bline, returned = binfo
            if paired in self.responses:
                if paired not in returned:
                    self.emit(
                        "mismatched-response", bpath, bline,
                        f"handler branch for {frame} never returns its "
                        f"paired {paired} (returns "
                        f"{sorted(returned) or 'nothing resolvable'}) — "
                        f"pairing drift breaks every typed client")
            elif not returned:
                self.emit(
                    "mismatched-response", bpath, bline,
                    f"handler branch for {frame} returns no *Response "
                    f"the checker can resolve — answer with AckResponse "
                    f"or a typed response")
            # Doc row: backtick-quoted frame name in the protocol table.
            if f"`{frame}`" not in doc:
                self.emit(
                    "protocol-doc-drift", path, line,
                    f"wire frame {frame} has no row in docs/serving.md's "
                    f"protocol table — every frame ships documented")
