"""The step's collective-sequence check: ``analysis/step_check.py``.

The counterpart of ``tests/test_analysis.py``'s jaxpr cases.  A 2-rank
gloo world (``tests/torch_port_workers.World``) records what its ranks
really send: the shipped factories' sequences are equal on both ranks
and agree with the planner, and they are the ones the in-process
simulation (torch's fake process group, in a fresh interpreter)
records for the same ranks.  A seeded rank-dependent fusion plan is
caught on simulated ranks, where the diverging wires never meet.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

import torch_port_workers as workers
from horovod_tpu_torch.analysis import step_check

pytestmark = pytest.mark.analysis

REPO = Path(__file__).resolve().parent.parent
N = 2


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = workers.World(N, str(tmp_path_factory.mktemp("gloo") / "store"))
    yield w
    w.close()


def test_shipped_factories_are_clean_on_a_live_world(world):
    results = world.run("step_checks", microbatches=2)
    assert results == [[], []], results


def test_live_recordings_match_across_ranks_and_the_simulation(world):
    live = world.run("step_cases", microbatches=2)
    assert live[0] == live[1]
    overlap = live[0]["make_train_step(microbatches=2, overlap)"]
    assert [e[0] for e in overlap] == [
        "reduce_scatter_tensor", "reduce_scatter_tensor",
        "all_gather_into_tensor", "all_reduce"]
    assert all(e[3] == N for e in overlap)
    code = ("import json\n"
            "from horovod_tpu_torch.analysis import step_check as sc\n"
            "cases = sc.per_rank(lambda: sc._record_cases(2), 2)\n"
            "print(json.dumps([{k: ([list(e) for e in v] if "
            "isinstance(v, list) else v) for k, v in c.items()} "
            "for c in cases]))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    simulated = json.loads(proc.stdout.strip().splitlines()[-1])
    assert simulated == live


def test_rank_dependent_fused_plan_is_caught():
    """On simulated ranks (a fresh interpreter with no world): the two
    wires never meet, so the check sees both sequences and names the
    divergence, where a live world would fail at the first mismatched
    rendezvous."""
    code = ("import json, sys\n"
            "sys.path.insert(0, 'tests')\n"
            "import torch_port_workers as w\n"
            "print(json.dumps(w.rank_dependent_plan()))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    fs = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(fs) == 1 and fs[0]["check"] == "step-rank-divergence"
    assert "reduce_scatter" in fs[0]["message"]


@pytest.mark.parametrize("microbatches, threshold, compression", [
    (3, 4096, "none"),
    (2, 8192, "int8"),
])
def test_overlap_wire_agrees_with_the_planner(world, microbatches,
                                              threshold, compression):
    results = world.run("overlap_recording", microbatches=microbatches,
                        threshold=threshold, compression=compression)
    assert results[0]["seq"] == results[1]["seq"]
    rec = results[0]
    assert rec["buckets"] > 1
    assert rec["counts"] == [microbatches * rec["buckets"], rec["buckets"]]
    seq = [tuple(e) for e in rec["seq"]]
    assert step_check.planner_findings(
        seq, microbatches=microbatches, n_buckets=rec["buckets"],
        compression=compression) == []
    # One reduce-scatter phase short of the plan is a finding.
    family = "all_to_all" if compression == "int8" else "reduce_scatter"
    cut = [e for e in seq if family not in e[0]] + \
        [e for e in seq if family in e[0]][:-(2 if compression == "int8"
                                             else 1)]
    fs = step_check.planner_findings(
        cut, microbatches=microbatches, n_buckets=rec["buckets"],
        compression=compression)
    assert len(fs) == 1 and "disagrees with the planner" in fs[0].message


def test_planner_rule_on_synthetic_sequences():
    rs = ("reduce_scatter_tensor", "float32", 10, 2)
    ag = ("all_gather_into_tensor", "float32", 10, 2)
    ar = ("all_reduce", "float32", 1, 2)
    ok = [rs, rs, rs, rs, ag, ag, ar]
    assert step_check.wire_counts(ok) == (4, 2)
    assert step_check.planner_findings(ok, microbatches=2,
                                       n_buckets=2) == []
    assert step_check.planner_findings(ok[1:], microbatches=2, n_buckets=2)
    assert step_check.planner_findings(ok, microbatches=2, n_buckets=1)
    a2a = ("all_to_all_single", "int8", 10, 2)
    int8 = [a2a] * 4 + [ag] * 2
    assert step_check.wire_counts(int8, "int8") == (2, 1)
    assert step_check.wire_counts(int8[1:], "int8") == (-1, 1)


def test_compare_sequences_names_the_first_difference():
    a = [("all_reduce", "float32", 4, 2), ("barrier", "", 0, 2)]
    b = [("all_reduce", "float32", 4, 2), ("all_reduce", "float32", 1, 2)]
    assert step_check.compare_sequences([a, a], path="p", what="w") == []
    fs = step_check.compare_sequences([a, b, a], path="p", what="w")
    assert len(fs) == 1 and "at call 1" in fs[0].message
    assert "rank 1" in fs[0].message and "barrier" in fs[0].message


def test_cli_step_check_is_clean_on_simulated_ranks(tmp_path):
    out = tmp_path / "step.json"
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.analysis", "--step",
         "--select", "step-rank-divergence", "--json", str(out)],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    payload = json.loads(out.read_text())
    assert payload["step"] is True and payload["findings"] == []
