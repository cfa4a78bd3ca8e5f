"""Whole runs of tiny cells on the CPU: the harness past its look for a
card, with the timed path sound and with each fault planted under it;
the control; a cell and a metric added as files alone; what a run may
import."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest

from portbench.core import judge, launch, session
from portbench.core.spec import load_cell
from portbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]


def _run(capfd, root, cell, chips, **kw):
    rc = launch.run(tiny.spec(root, cell, **kw), chips)
    out = capfd.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if out and out[-1].startswith("{") else None)


@pytest.mark.parametrize("cell,chips", [("tiny-gpt.lm", 1),
                                        ("tiny-bert.mlm", 1),
                                        ("tiny-gpt.lm2", 2)])
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_runs_correct(tiny_root, capfd, cell, chips, trace):
    rc, line = _run(capfd, tiny_root, cell, chips, trace=trace)
    assert rc == 0 and line["correct"] is True
    assert line["device"]["count"] == chips
    assert list(line)[-1] == "limits"
    c = load_cell(cell, tiny_root)
    if trace:
        # No card: only the host's metric has something to read.
        assert set(line["metrics"]) == {"host_enqueue_ms_per_step"}
        assert "breakdown" in line
    else:
        assert set(line["metrics"]) == {m["name"] for m in c.end_to_end}
        assert line["attempted"] >= 1 and line["failed"] == 0


@pytest.mark.parametrize("cell,chips,fault", [
    ("tiny-gpt.lm", 1, "unchanged_state"), ("tiny-gpt.lm", 1, "half_batch"),
    ("tiny-gpt.lm", 1, "altered_loss"),
    ("tiny-bert.mlm", 1, "unchanged_state"),
    ("tiny-bert.mlm", 1, "half_batch"), ("tiny-bert.mlm", 1, "altered_loss"),
    ("tiny-gpt.lm2", 2, "no_exchange")])
def test_fault_under_the_timed_path_is_not_correct(tiny_root, capfd, cell,
                                                   chips, fault):
    rc, line = _run(capfd, tiny_root, cell, chips, fault=fault)
    assert rc == 0 and line["correct"] is False


@pytest.mark.parametrize("cell", ["tiny-gpt.lm", "tiny-bert.mlm"])
def test_control_in_the_programs_place_is_not_correct(tiny_root, cell):
    import torch

    from portbench.core.feed import Pool
    from portbench.core.spec import family_module
    from portbench.reference import fp8

    c = load_cell(cell, tiny_root)
    dev = torch.device("cpu")
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        pool = Pool(c.traffic, family_module(c).vocab_size(c.config), seed,
                    c.chips, dev)
        ref = session.reference_readings(c, seed, c.chips, dev, pool)
        ctl = session.reference_readings(c, seed, c.chips, dev, pool,
                                         mm=fp8.matmul)
        correct, _ = judge.verdict(judge.readings(ctl, ref),
                                   c.workload["limits"], 0)
        assert not correct, seed


NEW_METRIC = '''"""A throwaway per-layer metric: the traced steps."""


def read(ctx):
    return float(ctx.traced_steps)
'''


def test_a_cell_and_a_metric_added_as_files_alone(tiny_root, capfd):
    base = tiny_root / "portbench"
    cfg = dict(tiny.CONFIGS["tiny-gpt"], n_layer=1, n_head=2)
    (base / "configs" / "one-layer.json").write_text(json.dumps(cfg))
    (base / "traffic" / "one-row.json").write_text(json.dumps(
        dict(tiny.TRAFFIC["tiny-lm"], batch_per_rank=1, seq_len=16)))
    (base / "workloads" / "one-layer.one-row.json").write_text(json.dumps(
        {"wire": {"compression": "bf16", "error_feedback": False},
         "checked_steps": 3, "timing_steps": 1, "trace_steps": 1,
         "reference_rows": 1,
         "limits": {"loss_gap": 0.01, "grad_gap": 0.05, "change_gap": 0.05,
                    "change_gap_worst": None}}))
    (base / "metrics" / "traced_steps_seen.py").write_text(NEW_METRIC)
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "one-layer.one-row",
                               "config": "one-layer", "traffic": "one-row",
                               "chips": 1, "why": "added as files"})
    bench["per_layer"].append({"name": "traced_steps_seen", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "host", "moves": "samples_per_s",
                               "workloads": ["one-layer.one-row"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, line = _run(capfd, tiny_root, "one-layer.one-row", 1, trace=True)
    assert rc == 0 and line["correct"] is True
    assert line["metrics"]["traced_steps_seen"]["value"] == 1.0
    # The other cells do not report it.
    assert "traced_steps_seen" not in {
        m["name"] for m in load_cell("tiny-gpt.lm", tiny_root).per_layer}


IMPORTS = """
import sys
sys.path.insert(0, {root!r})
from portbench.core import launch
from portbench.tests import tiny
rc = launch.run(tiny.spec({tiny_root!r}, "tiny-bert.mlm"), 1)
print("TOP", sorted({{m.split(".")[0] for m in sys.modules}}))
sys.exit(rc)
"""


def test_a_run_loads_no_jax(tiny_root):
    out = subprocess.run(
        [sys.executable, "-c", IMPORTS.format(root=str(ROOT),
                                              tiny_root=str(tiny_root))],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    top = eval(out.stdout.strip().splitlines()[-1][len("TOP "):])
    assert "horovod_tpu_torch" in top
    for name in ("jax", "jaxlib", "flax", "horovod_tpu"):
        assert name not in top


PLANT = """
import sys as _sys
import types as _types
_sys.modules.setdefault("jax", _types.ModuleType("jax"))
"""


@pytest.mark.parametrize("where", ["metric", "reference"])
def test_jax_loaded_after_the_window_fails_the_run(tiny_root, where):
    """A metric reader or the reference that loads JAX: the run exits 3
    and prints no result."""
    base = tiny_root / "portbench"
    if where == "metric":
        (base / "metrics" / "loads_jax.py").write_text(
            PLANT + "\n\ndef read(ctx):\n    return None\n")
        bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
        bench["per_layer"].append({
            "name": "loads_jax", "unit": "%", "better": "higher",
            "source": "host_clock", "layer": "host", "moves": "samples_per_s"})
        (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    else:
        ref = base / "reference" / "bert.py"
        ref.write_text(ref.read_text() + PLANT)
    code = IMPORTS.format(root=str(ROOT), tiny_root=str(tiny_root)).replace(
        '"tiny-bert.mlm")', '"tiny-bert.mlm", trace=True)')
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 3, out.stderr[-3000:]
    assert "['jax']" in out.stderr
    assert not any(l.startswith("{") for l in out.stdout.splitlines())


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "horovod_tpu_torch_x",
                        types.ModuleType("horovod_tpu_torch_x"))
    monkeypatch.setitem(sys.modules, "jaxfoo", types.ModuleType("jaxfoo"))
    assert session.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert session.forbidden_modules() == ["jax"]


def test_without_the_program_a_run_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "bert-large.mlm.seq128", "--seed", str(2**31 + 3), "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert not any(l.startswith("{") for l in out.stdout.splitlines())


def test_calibration_reads_the_witness(tiny_root, capfd):
    """``calibrate.py``'s readings on the CPU, the witness's with them:
    with Δ from the float32 O the witness is the reference to rounding."""
    spec = tiny.spec(tiny_root, "tiny-bert.mlm", mode="calibrate",
                     seeds=[2**31 + 21], control_seeds=[], faults=[],
                     fault_seeds=[], witness_seeds=[2**31 + 21])
    assert launch.run(spec, 1) == 0
    rec = json.loads(capfd.readouterr().out.strip().splitlines()[0])
    assert set(rec) >= {"program", "witness_bf16_o", "witness_f32_o"}
    assert rec["witness_f32_o"]["loss_gap"] < 1e-6
    assert rec["witness_f32_o"]["change_gap_worst"] < 1e-2
