"""On the card (marker ``cuda``; skipped without one): a run of the
one-card cell through ``run.py``, and the control at the cell's own size,
which has to come out not correct.

    python -m pytest portbench/tests/test_card.py -m cuda
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.core import judge
from portbench.core.spec import load_cell

ROOT = Path(__file__).resolve().parents[2]
CELL = "bert-large.mlm.seq128"


@pytest.mark.cuda
def test_one_card_cell_runs_correct(card):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
         str(2**31 + 101), "--seconds", "3", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1


@pytest.mark.cuda
def test_control_at_the_cells_size_is_not_correct(card):
    seeds = [2**31 + 201, 2**31 + 202, 2**31 + 203]
    out = subprocess.run(
        [sys.executable, "portbench/calibrate.py", "--workload", CELL,
         "--control-seeds", ",".join(map(str, seeds))], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    records = [json.loads(l) for l in out.stdout.splitlines()
               if l.startswith('{"seed"')]
    assert [r["seed"] for r in records] == seeds
    limits = load_cell(CELL, ROOT).workload["limits"]
    for r in records:
        correct, _ = judge.verdict(r["control"], limits, 0)
        assert not correct, r
