"""Bounded-wait discipline (``unbounded-wait``).

Counterpart of ``horovod_tpu/analysis/waits.py``, the same logic.  Its
receiver-name rule leaves a collective handle's ``wait()`` alone, which
covers the port's ``Handle.wait()`` and ``torch.distributed``'s
``Work.wait()`` alike.

The drain/stall bugs review passes kept hand-catching on the serving
and checkpoint tiers share one shape: a blocking call with no deadline
— a ``join()`` on a wedged thread, a ``Condition.wait()`` nothing will
ever notify, a control-plane ``request()`` against a dead peer — turns
one component's failure into a silent whole-process hang.  The policy
this checker enforces: **every blocking call passes a timeout/deadline,
or carries a justified suppression** (``# hvdlint:
disable=unbounded-wait -- <why unbounded is correct here>``), which is
exactly the reviewable artifact an intentionally-infinite wait should
leave behind.

What counts as blocking (receiver-sensitive, to keep the check precise
rather than noisy — ``Handle.wait()`` collective results and
``str.join`` are not thread waits):

* ``<thread>.join(...)`` — receiver named like a thread (contains
  ``thread``) or assigned from a ``Thread(...)`` constructor in the
  same function; bounded by a positional or ``timeout=`` argument.
* ``<sync>.wait(...)`` / ``<sync>.wait_for(pred, ...)`` — receiver
  named like a synchronization primitive (``*_cv``, ``*lock*``,
  ``*event*``, ``*_stop``, ``*_abort``, ``*done*``, …) or assigned
  from an ``Event``/``Condition``/``Semaphore`` constructor; bounded by
  a positional timeout (``wait``: first arg; ``wait_for``: second) or
  ``timeout=``.
* ``<queue>.get(...)`` — receiver named like a queue (contains
  ``queue`` or ends ``_q``) or assigned from a ``Queue(...)``
  constructor; bounded by ``timeout=`` or ``block=False``.
* ``<lock>.acquire(...)`` — lock-named receiver; bounded by
  ``timeout=`` or ``blocking=False``.  (``with lock:`` stays exempt:
  the idiom has no timeout form, and lock holds are bounded by the
  lock-order-cycle check instead.)
* ``client.request(Frame(...), ...)`` — the control-plane RPC: any
  ``.request`` call whose first argument constructs a ``*Request``
  frame, or whose receiver is named like a client; bounded by
  ``timeout=``.  (The transport's probe timeout bounds each socket op,
  but the *response* wait is the caller's contract — every call site
  states its own deadline.)
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Set

from .core import Checker, SourceModule, terminal_name

_SYNC_NAME = re.compile(
    r"(lock|_cv$|^cv$|cond|event|^_?ev$|_stop$|^stop$|_abort$|^abort$|"
    r"done|ready|finished|sem\b|semaphore|barrier)", re.IGNORECASE)
_THREAD_NAME = re.compile(r"thread", re.IGNORECASE)
_QUEUE_NAME = re.compile(r"(queue|_q$)", re.IGNORECASE)
_CLIENT_NAME = re.compile(r"client", re.IGNORECASE)

_SYNC_CTORS = {"Event", "Condition", "Semaphore", "BoundedSemaphore",
               "Barrier"}
_THREAD_CTORS = {"Thread", "Process"}
_QUEUE_CTORS = {"Queue", "SimpleQueue", "LifoQueue", "PriorityQueue"}


def _kw(call: ast.Call, *names: str) -> bool:
    return any(kw.arg in names for kw in call.keywords)


def _kw_is_false(call: ast.Call, name: str) -> bool:
    for kw in call.keywords:
        if kw.arg == name and isinstance(kw.value, ast.Constant) \
                and kw.value.value is False:
            return True
    return False


class WaitChecker(Checker):
    checks = ("unbounded-wait",)

    # ----- per-module pass ------------------------------------------------
    def check_module(self, mod: SourceModule) -> None:
        for stmt in ast.walk(mod.tree):
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._check_function(mod, stmt)

    def _check_function(self, mod: SourceModule, fn: ast.FunctionDef) -> None:
        # Constructor-tracked local names: `t = threading.Thread(...)`
        # makes `t.join()` a thread join whatever the variable is named.
        kinds: Dict[str, str] = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Call):
                ctor = terminal_name(node.value.func)
                if ctor in _THREAD_CTORS:
                    kinds[node.targets[0].id] = "thread"
                elif ctor in _SYNC_CTORS:
                    kinds[node.targets[0].id] = "sync"
                elif ctor in _QUEUE_CTORS:
                    kinds[node.targets[0].id] = "queue"
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute):
                self._check_call(mod, node, kinds)

    # ----- one call -------------------------------------------------------
    def _check_call(self, mod: SourceModule, call: ast.Call,
                    kinds: Dict[str, str]) -> None:
        meth = call.func.attr
        recv = call.func.value
        rname = terminal_name(recv)
        rkind = kinds.get(rname, "")

        if meth == "join":
            if not (rkind == "thread" or _THREAD_NAME.search(rname)):
                return
            if call.args or _kw(call, "timeout"):
                return
            self._flag(mod, call, f"{rname}.join()",
                       "pass timeout= and handle a still-alive thread")
        elif meth == "wait":
            if not (rkind == "sync" or _SYNC_NAME.search(rname)):
                return
            if call.args or _kw(call, "timeout"):
                return
            self._flag(mod, call, f"{rname}.wait()",
                       "pass a timeout (loop and re-check if the wait "
                       "is legitimately long)")
        elif meth == "wait_for":
            if not (rkind == "sync" or _SYNC_NAME.search(rname)):
                return
            if len(call.args) >= 2 or _kw(call, "timeout"):
                return
            self._flag(mod, call, f"{rname}.wait_for(...)",
                       "pass timeout= and handle the False return")
        elif meth == "get":
            if not (rkind == "queue" or _QUEUE_NAME.search(rname)):
                return
            if _kw(call, "timeout") or _kw_is_false(call, "block"):
                return
            self._flag(mod, call, f"{rname}.get()",
                       "pass timeout= (and catch queue.Empty)")
        elif meth == "acquire":
            if not ("lock" in rname.lower() or rname.endswith("_cv")
                    or rkind == "sync"):
                return
            if _kw(call, "timeout") or _kw_is_false(call, "blocking"):
                return
            self._flag(mod, call, f"{rname}.acquire()",
                       "pass timeout= (or use `with lock:` for a "
                       "plain critical section)")
        elif meth == "request":
            frame_arg = bool(
                call.args and isinstance(call.args[0], ast.Call)
                and terminal_name(call.args[0].func).endswith("Request"))
            if not (frame_arg or _CLIENT_NAME.search(rname)):
                return
            if _kw(call, "timeout"):
                return
            what = (terminal_name(call.args[0].func)
                    if frame_arg else f"{rname}.request")
            self._flag(mod, call, f"request({what})",
                       "pass timeout= — the response wait must state "
                       "its own deadline")

    def _flag(self, mod: SourceModule, call: ast.Call, what: str,
              fix: str) -> None:
        self.emit(
            "unbounded-wait", mod.path, call.lineno,
            f"{what} blocks with no deadline — a wedged peer/thread "
            f"turns into a silent whole-process hang; {fix}, or suppress "
            f"with the reason unbounded is correct here")
