"""The port's chaos soak (``scripts/torch_port_chaos_soak.py``), the
counterpart of ``scripts/chaos_soak.py``.

* ``--runs 1 --mode train --sanitize`` (the fastest drill) writes the
  reference's summary shape with 0 sanitizer findings.
* A chaos-marked test that writes a guarded field from a second thread
  without its lock, soaked under ``--sanitize``, yields a finding (the
  port's sanitizer's report) and a failed run that keeps its dumps.
* Every mode the script accepts has targets that hold chaos-marked tests
  reading ``HVD_TPU_CHAOS_STEP`` / ``_SEED``, the reference's modes all
  have one, and an unknown mode, or ``--mp``, is refused by name.
"""

import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "torch_port_chaos_soak.py")


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


soak = _load(SCRIPT, "torch_port_chaos_soak")
reference = _load(os.path.join(ROOT, "scripts", "chaos_soak.py"),
                  "reference_chaos_soak")


def test_clean_sanitized_run_writes_the_reference_summary(tmp_path):
    out = str(tmp_path / "soak.json")
    proc = subprocess.run(
        [sys.executable, SCRIPT, "--runs", "1", "--mode", "train",
         "--sanitize", "--master-seed", "3", "--out", out],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with open(out) as f:
        summary = json.load(f)
    assert set(summary) == {"target", "mode", "master_seed", "total",
                            "passed", "failed", "flight_root", "runs",
                            "sanitize", "sanitizer_findings_total"}
    assert summary["target"] == "tests/test_torch_port_faults.py"
    assert (summary["total"], summary["passed"], summary["failed"]) \
        == (1, 1, 0)
    assert summary["sanitizer_findings_total"] == 0
    run, = summary["runs"]
    assert set(run) == {"step", "seed", "rc", "passed", "duration_s",
                        "tail", "sanitizer_findings", "mode"}
    assert run["rc"] == 0 and run["sanitizer_findings"] == 0
    assert not os.path.exists(summary["flight_root"])   # nothing kept


_SEEDED = textwrap.dedent("""
    import threading

    import pytest

    from horovod_tpu_torch.analysis import sanitizer


    @pytest.mark.chaos
    def test_unguarded_write_from_a_second_thread():
        class Box:
            def __init__(self):
                self._lock = threading.Lock()
                self._items = []

        sanitizer.instrument_class(Box, {"_items": "_lock"},
                                   owner="seeded.Box")
        box = Box()
        box._items.append(0)

        def racy_writer():
            box._items = box._items + [1]   # no lock

        t = threading.Thread(target=racy_writer)
        t.start()
        t.join()
""")


def test_seeded_unguarded_write_is_a_finding_and_fails_the_run(tmp_path):
    target = tmp_path / "test_seeded_race.py"
    target.write_text(_SEEDED)
    flight = str(tmp_path / "flight")
    run = soak.run_once(str(target), step=1, seed=2, timeout_s=300,
                        flight_dir=flight, sanitize=True)
    assert run["rc"] == 0, run["tail"]        # soft mode: the test passes
    assert run["sanitizer_findings"] >= 1, run
    assert not run["passed"]
    wheres = {f.get("where") for f in run["sanitizer"]}
    assert "seeded.Box._items" in wheres, run["sanitizer"]
    assert os.path.join(flight, "sanitizer.json") in run["flight_dumps"]


def test_every_mode_has_chaos_targets():
    assert set(soak.MODES) == {m for m, _ in reference.TARGETS}
    for (mode, mp), target in soak.TARGETS.items():
        assert not mp
        for path in target.split():
            with open(os.path.join(ROOT, path)) as f:
                text = f.read()
            assert "pytest.mark.chaos" in text, (mode, path)
            assert "HVD_TPU_CHAOS_STEP" in text, (mode, path)


@pytest.mark.parametrize("argv,word", [
    (["--mode", "bogus"], "bogus"),
    (["--modes", "train,bogus"], "unknown mode(s) bogus"),
    (["--mp"], "--mode train has no --mp target"),
    (["--mp", "--modes", "qos,sim"], "--mode qos has no --mp target"),
])
def test_a_mode_without_a_target_is_refused(tmp_path, capsys, argv, word):
    with pytest.raises(SystemExit) as e:
        soak.main(argv + ["--runs", "0", "--out", str(tmp_path / "x.json")])
    assert e.value.code == 2
    assert word in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "x.json")


def test_merged_modes_summary_has_per_mode_tallies(tmp_path):
    out = str(tmp_path / "merged.json")
    assert soak.main(["--runs", "0", "--modes", "sim,qos,swap",
                      "--sanitize", "--out", out]) == 0
    with open(out) as f:
        summary = json.load(f)
    assert summary["mode"] == "sim,qos,swap"
    assert sorted(summary["per_mode"]) == ["qos", "sim", "swap"]
    assert summary["per_mode"]["qos"] == {
        "target": "tests/test_torch_port_serve_qos.py", "total": 0,
        "passed": 0, "failed": 0}
    assert summary["sanitizer_findings_total"] == 0
