"""The numbers that decide ``correct``, and the verdict.

The program and the reference each give: the loss of each of the first
steps, the norm of each leaf's first gradient (the program's as its
optimizer got it), and the norm of each leaf's change after those
steps.  Compared, by the worst leaf and never by the norm of a
difference:

- ``loss_gap``: the largest ``|loss - ref| / |ref|`` over the steps;
- ``grad_gap``: the largest ``| |g| - |g_ref| |`` over the leaves,
  against the larger of that leaf's reference norm and the median
  leaf's (some gradients are all but zero);
- ``change_gap_worst``: the same of each leaf's change after the last
  step, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (below that, Adam moves a leaf by
  round-off alone: a key's bias under softmax, a pooler the loss never
  reads);
- ``change_gap``: the median of those leaves' gaps of change.  Where a
  leaf's true gradient is small beside the rounding of the program's
  bfloat16 attention backward (the query and key products of deep
  blocks), Adam, which takes every gradient to unit steps, moves it by
  noise, and the worst leaf reads that noise on every seed
  (``PERF.md``); the median leaf's gap is steady from seed to seed.

Each has its limit in ``workloads/<cell>.json``; a limit of null is not
judged (``PERF.md`` names such a number with its readings).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, Optional

NAMES = ("loss_gap", "grad_gap", "change_gap", "change_gap_worst")
MOVED_SHARE = 1e-3


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              names: Iterable[str]) -> Dict[str, float]:
    """Each leaf's gap of norms against the larger of its reference norm
    and the median leaf's."""
    names = list(names)
    if not names:
        return {}
    median = statistics.median(ref[n] for n in names)
    out = {}
    for n in names:
        gap = abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], median, 1e-30)
        out[n] = gap if math.isfinite(gap) else math.inf
    return out


def _worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
                names: Iterable[str]) -> float:
    gaps = leaf_gaps(prog, ref, names)
    return max(gaps.values()) if gaps else math.inf


def worst_leaves(prog: dict, ref: dict, k: int = 4) -> dict:
    """The ``k`` leaves with the widest gaps of each number, for a look."""
    out = {}
    for key, names in (("grad_gap", ref["grad_norms"]),
                       ("change_gap", moved_leaves(ref["grad_norms"]))):
        norms = "grad_norms" if key == "grad_gap" else "change_norms"
        gaps = leaf_gaps(prog[norms], ref[norms], names)
        out[key] = [[n, g, prog[norms].get(n), ref[norms][n]] for n, g in
                    sorted(gaps.items(), key=lambda kv: -kv[1])[:k]]
    return out


def part_norms(tensors: Dict[str, "torch.Tensor"], parts: Dict[str, int],
               scale: float = 1.0) -> Dict[str, float]:
    """The norm of each leaf, times ``scale``; a leaf that ``parts``
    names (a fused q, k, v product) is cut along its last axis into that
    many equal parts, each a leaf of its own (``<name>.0``, ...): a key's
    bias is nought to rounding in the reference while its query's is not.
    One read from the device."""
    import torch

    names, norms = [], []
    for name, t in tensors.items():
        k = parts.get(name, 1)
        pieces = t.detach().float().chunk(k, dim=-1) if k > 1 else [t.detach().float()]
        for i, piece in enumerate(pieces):
            names.append(f"{name}.{i}" if k > 1 else name)
            norms.append(piece.norm())
    values = (torch.stack(norms) * scale).tolist() if norms else []
    return dict(zip(names, values))


def moved_leaves(ref_grad_norms: Dict[str, float]):
    median = statistics.median(ref_grad_norms.values())
    return [n for n, g in ref_grad_norms.items() if g >= MOVED_SHARE * median]


def readings(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers of :data:`NAMES`, ``prog`` against ``ref``."""
    gaps = [abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])]
    loss_gap = (max(gaps) if len(gaps) == len(ref["losses"])
                and all(math.isfinite(g) for g in gaps) else math.inf)
    moved = moved_leaves(ref["grad_norms"])
    change = leaf_gaps(prog["change_norms"], ref["change_norms"], moved)
    return dict(
        loss_gap=loss_gap,
        grad_gap=_worst_leaf(prog["grad_norms"], ref["grad_norms"],
                             ref["grad_norms"]),
        change_gap=statistics.median(change.values()) if change else math.inf,
        change_gap_worst=max(change.values()) if change else math.inf)


def verdict(values: Dict[str, float], limits: Dict[str, Optional[float]],
            failed_steps: int) -> tuple:
    """``(correct, {name: {"value", "limit"}})``: correct when no step
    failed and every judged number is within its limit."""
    shown = {}
    ok = failed_steps == 0
    for name in NAMES:
        limit = limits.get(name)
        value = values.get(name, math.inf)
        shown[name] = {"value": value, "limit": limit}
        if limit is not None and not value <= limit:
            ok = False
    return ok, shown
