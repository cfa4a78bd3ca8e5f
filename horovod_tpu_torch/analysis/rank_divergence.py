"""Rank-divergent collective detection (``rank-divergent-collective``).

Counterpart of ``horovod_tpu/analysis/rank_divergence.py``, with
``torch.distributed``'s names.  The Horovod deadlock class: every rank
must issue the identical collective sequence, so a collective dispatched
only inside a ``rank() == 0`` branch (or after an early ``return`` taken
only on some ranks) hangs the rest of the world at the next collective.
This analyzer checks it lexically:

* A branch condition is **rank-conditioned** when its expression tree
  contains a call to a rank oracle (``rank``/``local_rank``/
  ``cross_rank``/``process_index``/``process_id`` and torch's
  ``get_rank``/``get_group_rank``/``get_global_rank``, any attribute
  spelling: ``hvd.rank()``, ``dist.get_rank()``, ``self.rank()``) or a
  name assigned from one earlier in the same function (one-level taint).
* Collectives lexically inside such a branch are flagged: the port's
  Horovod API (``ops/collectives.py``) and ``torch.distributed``'s
  entry points, ``new_group`` included (every rank of the world must
  call it).
* If a rank-conditioned branch ends in ``return``/``raise``/
  ``continue``/``break``, the *remainder of the enclosing block* is
  only reached by some ranks, so collectives there are flagged too.

This is deliberately syntactic — it cannot prove a dynamic dispatch
divergent — but it catches the whole ``if rank() == 0:
hvd.broadcast(...)`` family, and the step check (:mod:`.step_check`)
covers the recorded-step side of the same claim.
"""

from __future__ import annotations

import ast
from typing import List, Set

from .core import Checker, SourceModule, terminal_name as _terminal_name

# Functions whose CALL is a cross-rank rendezvous.  Matched on the
# terminal attribute name, so ``hvd.allreduce``, ``C.allreduce_slots``
# and a bare ``allreduce`` all hit.
COLLECTIVE_NAMES: Set[str] = {
    "allreduce", "allreduce_async", "allreduce_slots",
    "grouped_allreduce", "grouped_allreduce_async", "grouped_allreduce_slots",
    "allgather", "allgather_async", "allgather_slots", "allgather_object",
    "grouped_allgather", "grouped_allgather_async",
    "broadcast", "broadcast_async", "broadcast_slots",
    "broadcast_object", "broadcast_variables", "broadcast_parameters",
    "alltoall", "alltoall_async", "alltoall_slots",
    "reducescatter", "reducescatter_async", "reducescatter_slots",
    "grouped_reducescatter", "grouped_reducescatter_async",
    "grouped_reducescatter_slots",
    "barrier", "join", "cross_rank_summary",
    # torch.distributed's entry points (new_group is collective over
    # the whole world; all_gather_single is all_gather_into_tensor's
    # newer name)
    "all_reduce", "reduce_scatter_tensor", "reduce_scatter",
    "all_gather_into_tensor", "all_gather_single", "all_gather",
    "all_to_all_single", "all_to_all", "broadcast_object_list",
    "all_gather_object", "gather", "scatter", "reduce",
    "monitored_barrier", "new_group",
}

# Rank oracles: a call to any of these taints the condition.
RANK_FNS: Set[str] = {"rank", "local_rank", "cross_rank",
                      "process_index", "process_id",
                      "get_rank", "get_group_rank", "get_global_rank"}


def _is_rank_expr(node: ast.expr, tainted: Set[str]) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and _terminal_name(sub.func) in RANK_FNS:
            return True
        if isinstance(sub, ast.Name) and sub.id in tainted:
            return True
    return False


def _collective_calls(node: ast.AST) -> List[ast.Call]:
    return [sub for sub in ast.walk(node)
            if isinstance(sub, ast.Call)
            and _terminal_name(sub.func) in COLLECTIVE_NAMES]


def _diverges(stmt: ast.stmt) -> bool:
    """Does this statement end its branch for the ranks that take it?"""
    if isinstance(stmt, (ast.Return, ast.Raise, ast.Continue, ast.Break)):
        return True
    if isinstance(stmt, ast.If):
        return (bool(stmt.body) and _diverges(stmt.body[-1])
                and bool(stmt.orelse) and _diverges(stmt.orelse[-1]))
    return False


class RankDivergenceChecker(Checker):
    checks = ("rank-divergent-collective",)

    def check_module(self, mod: SourceModule) -> None:
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._check_function(mod, node)

    def _check_function(self, mod: SourceModule,
                        fn: ast.FunctionDef) -> None:
        tainted: Set[str] = set()
        for sub in ast.walk(fn):
            if isinstance(sub, ast.Assign) and isinstance(sub.value, ast.Call):
                if _terminal_name(sub.value.func) in RANK_FNS:
                    for tgt in sub.targets:
                        if isinstance(tgt, ast.Name):
                            tainted.add(tgt.id)
        self._walk_block(mod, fn.body, tainted, fn.name)

    def _walk_block(self, mod: SourceModule, body: List[ast.stmt],
                    tainted: Set[str], fname: str) -> None:
        divergent_tail = False
        for stmt in body:
            if divergent_tail:
                # Only the ranks that did NOT take the early exit reach
                # this code.
                self._flag_calls(mod, stmt, fname,
                                 "after a rank-conditioned early exit")
                continue
            if isinstance(stmt, ast.If) and _is_rank_expr(stmt.test, tainted):
                for branch in (stmt.body, stmt.orelse):
                    for s in branch:
                        self._flag_calls(mod, s, fname,
                                         "inside a rank-conditioned branch")
                if ((stmt.body and _diverges(stmt.body[-1]))
                        or (stmt.orelse and _diverges(stmt.orelse[-1]))):
                    divergent_tail = True
            elif isinstance(stmt, ast.If):
                self._walk_block(mod, stmt.body, tainted, fname)
                self._walk_block(mod, stmt.orelse, tainted, fname)
            elif isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                self._walk_block(mod, stmt.body, tainted, fname)
                self._walk_block(mod, stmt.orelse, tainted, fname)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                self._walk_block(mod, stmt.body, tainted, fname)
            elif isinstance(stmt, ast.Try):
                for blk in (stmt.body, stmt.orelse, stmt.finalbody):
                    self._walk_block(mod, blk, tainted, fname)
                for h in stmt.handlers:
                    self._walk_block(mod, h.body, tainted, fname)

    def _flag_calls(self, mod: SourceModule, stmt: ast.stmt, fname: str,
                    where: str) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return  # a def is not a dispatch; the body is checked on call
        for call in _collective_calls(stmt):
            name = _terminal_name(call.func)
            self.emit(
                "rank-divergent-collective", mod.path, call.lineno,
                f"collective {name}() in {fname}() is reachable {where}: "
                f"ranks that skip it deadlock the world at the next "
                f"rendezvous — hoist it out or make every rank "
                f"participate")
