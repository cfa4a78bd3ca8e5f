"""The port's backend probe and MFU table (``horovod_tpu_torch/utils/
backend_probe.py``, ``utils/mfu.py``) against the reference's.

Mirrors ``tests/test_backend_probe.py`` on the CPU: the subprocess
probe's success, failure and timeout, the bounded wait and its recovery,
``guarded_init``'s skip and exhaustion paths, the re-exec counter, the
failure line (its keys the reference's), the build directory's
resolution order (the port's counterpart of the compilation cache)
against a temporary directory, CUDA's and NCCL's unavailability
messages, the peak table's prefix rule on the GPU kinds, and the FLOP
count of one call.
"""

import json
import os

import pytest
import torch

from horovod_tpu.utils import backend_probe as jbp
from horovod_tpu.utils import mfu as jmfu

import horovod_tpu_torch as hvd
from horovod_tpu_torch.native import build as native_build
from horovod_tpu_torch.ops import _build as kernel_build
from horovod_tpu_torch.utils import backend_probe as bp
from horovod_tpu_torch.utils import mfu


@pytest.fixture
def cpu_session():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def test_probe_once_on_this_cpu_host():
    info = bp.probe_once(timeout_s=120.0)
    assert info["ok"] is True
    assert info["platform"] == "cpu" and info["device_kind"] == "cpu"
    assert info["n_devices"] >= 1 and info["elapsed_s"] >= 0


def test_probe_once_failure_classified(monkeypatch):
    monkeypatch.setattr(bp, "_PROBE_SRC", "import sys; sys.exit(3)")
    info = bp.probe_once(timeout_s=30.0)
    assert info == {"ok": False, "rc": 3, "elapsed_s": info["elapsed_s"],
                    "tail": ""}


def test_probe_once_timeout_classified(monkeypatch):
    monkeypatch.setattr(bp, "_PROBE_SRC", "import time; time.sleep(60)")
    info = bp.probe_once(timeout_s=1.0)
    assert info["ok"] is False and info["rc"] is None
    assert "hung" in info["tail"]


def test_wait_for_backend_bounded_and_logged(monkeypatch):
    monkeypatch.setattr(bp, "_PROBE_SRC", "import sys; sys.exit(1)")
    with pytest.raises(bp.BackendUnavailableError) as ei:
        bp.wait_for_backend(attempts=3, backoff_s=0.0, probe_timeout_s=10.0)
    assert [a["attempt"] for a in ei.value.attempts] == [1, 2, 3]


def test_wait_for_backend_recovers_midway(monkeypatch):
    calls = {"n": 0}

    def flaky(timeout_s):
        calls["n"] += 1
        if calls["n"] < 3:
            return {"ok": False, "rc": 1, "elapsed_s": 0.1, "tail": "boom"}
        return {"ok": True, "platform": "gpu",
                "device_kind": "NVIDIA H100 80GB HBM3", "n_devices": 1,
                "elapsed_s": 0.1}

    monkeypatch.setattr(bp, "probe_once", flaky)
    info = bp.wait_for_backend(attempts=5, backoff_s=0.0)
    assert info["ok"] and len(info["probe_attempts"]) == 2


def test_failure_line_has_the_references_keys(capsys):
    for mod in (bp, jbp):
        mod.emit_failure_line("m", "u", attempts=[{"attempt": 1}])
    port, ref = (json.loads(line) for line in
                 capsys.readouterr().out.strip().splitlines())
    assert set(port) == set(ref) == {"metric", "value", "unit", "error",
                                     "probe_attempts"}
    assert port["value"] == ref["value"] == 0.0
    assert port["probe_attempts"] == ref["probe_attempts"]
    assert port["error"] == "gpu_backend_unavailable"
    bp.emit_failure_line("resnet50_images_per_sec_per_chip",
                         "images/sec/chip", vs_baseline=0.0)
    assert json.loads(capsys.readouterr().out)["vs_baseline"] == 0.0


def test_guarded_init_skip_runs_bare_init(cpu_session, monkeypatch):
    """An initialised session: ``skip=True`` is a second, idempotent
    init that runs no probe."""
    monkeypatch.setattr(bp, "_PROBE_SRC", "import sys; sys.exit(1)")
    bp.guarded_init("m", "u", skip=True)
    assert hvd.is_initialized()


def test_guarded_init_probe_exhaustion_exits_with_line(monkeypatch, capsys):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setattr(bp, "_PROBE_SRC", "import sys; sys.exit(1)")
    with pytest.raises(SystemExit) as exc:
        bp.guarded_init("m", "u", attempts=2, backoff_s=0.0,
                        probe_timeout_s=10.0)
    assert exc.value.code == 0
    parsed = json.loads(capsys.readouterr().out.strip())
    assert parsed["error"] == "gpu_backend_unavailable"
    assert len(parsed["probe_attempts"]) == 2
    assert not hvd.is_initialized()


@pytest.mark.parametrize("hidden", ["", "-1"])
def test_guarded_init_no_visible_card_skips_probe_budget(cpu_session,
                                                         monkeypatch, hidden):
    """``CUDA_VISIBLE_DEVICES`` hiding every card (the reference's
    ``JAX_PLATFORMS=cpu``): no probe runs (its source is poisoned)."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", hidden)
    monkeypatch.setattr(bp, "_PROBE_SRC", "import sys; sys.exit(1)")
    bp.guarded_init("m", "u", attempts=2, backoff_s=0.0,
                    probe_timeout_s=10.0)
    assert hvd.is_initialized()


def test_probe_env_aliases(monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    seen = {}

    def spy(attempts, backoff_s, probe_timeout_s):
        seen.update(attempts=attempts, backoff_s=backoff_s,
                    probe_timeout_s=probe_timeout_s)
        raise bp.BackendUnavailableError([])

    monkeypatch.setattr(bp, "wait_for_backend", spy)
    monkeypatch.setenv("HVD_TPU_PROBE_RETRIES", "7")
    monkeypatch.setenv("HVD_TPU_PROBE_BACKOFF", "0.5")
    monkeypatch.setenv("HVD_TPU_PROBE_TIMEOUT_S", "bad")
    with pytest.raises(SystemExit):
        bp.guarded_init("m", "u")
    assert seen == {"attempts": 7, "backoff_s": 0.5,
                    "probe_timeout_s": 120.0}
    monkeypatch.setenv("HVD_TPU_PROBE_ATTEMPTS", "3")
    monkeypatch.setenv("HVD_TPU_PROBE_BACKOFF_S", "0.25")
    with pytest.raises(SystemExit):
        bp.guarded_init("m", "u")
    assert (seen["attempts"], seen["backoff_s"]) == (3, 0.25)


def test_exec_attempt_counter(monkeypatch):
    assert bp._EXEC_ATTEMPT_ENV == jbp._EXEC_ATTEMPT_ENV
    monkeypatch.delenv(bp._EXEC_ATTEMPT_ENV, raising=False)
    assert bp.exec_attempt() == 0
    monkeypatch.setenv(bp._EXEC_ATTEMPT_ENV, "2")
    assert bp.exec_attempt() == 2
    # The budget spent: returns instead of re-executing.
    assert bp.retry_via_exec(max_execs=2, backoff_s=0.0) is None
    monkeypatch.setenv(bp._EXEC_ATTEMPT_ENV, "x")
    assert bp.exec_attempt() == 0


def test_unavailable_card_messages():
    for text in ("CUDA error: no CUDA GPUs are available",
                 "Found no NVIDIA driver on your system",
                 "CUDA driver version is insufficient for CUDA runtime "
                 "version",
                 "CUDA error: CUDA-capable device(s) is/are busy or "
                 "unavailable",
                 "NCCL error in: ProcessGroupNCCL.cpp, unhandled system "
                 "error (run with NCCL_DEBUG=INFO for details)"):
        assert bp.is_backend_unavailable_error(RuntimeError(text)), text
    for exc in (RuntimeError("UNAVAILABLE: TPU backend setup/compile error"),
                ValueError("shape mismatch"),
                RuntimeError("CUDA out of memory")):
        assert not bp.is_backend_unavailable_error(exc)


class TestBuildDirectory:
    """``enable_compilation_cache``: where the kernels' and the native
    runtime's libraries are built, in the reference's order (the
    environment, ``default_dir``, the package's ``_build/``, a user
    cache), against temporary directories."""

    @pytest.fixture(autouse=True)
    def _restore(self, monkeypatch):
        monkeypatch.delenv("HOROVOD_COMPILE_CACHE", raising=False)
        monkeypatch.setattr(kernel_build, "BUILD_DIR", kernel_build.BUILD_DIR)
        monkeypatch.setattr(native_build, "BUILD_DIR", native_build.BUILD_DIR)

    @pytest.mark.parametrize("off", ["0", "off", "none", "", "false", "no"])
    def test_env_kill_switch(self, monkeypatch, off):
        before = kernel_build.BUILD_DIR
        monkeypatch.setenv("HVD_TPU_COMPILE_CACHE", off)
        assert bp.enable_compilation_cache() is None
        assert jbp.enable_compilation_cache() is None
        assert kernel_build.BUILD_DIR == before == kernel_build.PACKAGE_DIR \
            / "_build"

    def test_env_path_wins_and_is_created(self, monkeypatch, tmp_path):
        target = tmp_path / "cache" / "nested"
        monkeypatch.setenv("HVD_TPU_COMPILE_CACHE", str(target))
        assert bp.enable_compilation_cache(default_dir=str(tmp_path / "d")) \
            == str(target)
        assert target.is_dir()
        assert kernel_build.BUILD_DIR == native_build.BUILD_DIR == target
        assert kernel_build.library_path("matmul").parent == target
        assert native_build.library_path().parent == target
        # The sources stay the checkout's.
        assert kernel_build.CSRC_DIR == kernel_build.PACKAGE_DIR / "csrc"

    def test_default_dir_parameter(self, monkeypatch, tmp_path):
        monkeypatch.delenv("HVD_TPU_COMPILE_CACHE", raising=False)
        path = bp.enable_compilation_cache(default_dir=str(tmp_path / "c"))
        assert path == str(tmp_path / "c") and os.path.isdir(path)
        assert str(kernel_build.BUILD_DIR) == path

    def test_package_default_then_user_cache(self, monkeypatch, tmp_path):
        monkeypatch.delenv("HVD_TPU_COMPILE_CACHE", raising=False)
        assert bp.enable_compilation_cache() == \
            str(kernel_build.PACKAGE_DIR / "_build")
        real_makedirs = os.makedirs

        def picky(p, **kw):
            if p.endswith(os.path.join("horovod_tpu_torch", "_build")):
                raise OSError(13, "Permission denied")
            real_makedirs(p, **kw)

        monkeypatch.setenv("HOME", str(tmp_path))
        monkeypatch.setattr(bp.os, "makedirs", picky)
        path = bp.enable_compilation_cache()
        assert path == str(tmp_path / ".cache" / "horovod_tpu_torch" /
                           "build")
        assert os.path.isdir(path) and str(native_build.BUILD_DIR) == path

    def test_unwritable_path_degrades_to_none(self, monkeypatch, tmp_path):
        def deny(*a, **k):
            raise OSError(13, "Permission denied")

        before = kernel_build.BUILD_DIR
        monkeypatch.setenv("HVD_TPU_COMPILE_CACHE", str(tmp_path / "c"))
        monkeypatch.setattr(bp.os, "makedirs", deny)
        assert bp.enable_compilation_cache() is None
        assert kernel_build.BUILD_DIR == before


class Dev:
    def __init__(self, kind):
        self.device_kind = kind


def test_peak_table_prefix_rule_on_gpu_kinds(monkeypatch):
    monkeypatch.delenv("HVD_TPU_PEAK_TFLOPS", raising=False)
    info = mfu.peak_tflops_info
    assert info("NVIDIA H100 80GB HBM3") == (989.0, "device_kind_table")
    assert info(Dev("NVIDIA H100 80GB HBM3")) == (989.0, "device_kind_table")
    # The PCIe and NVL cards are other parts: never the SXM's 989.
    assert info("NVIDIA H100 PCIe") == (756.0, "device_kind_table")
    assert info("NVIDIA H100 NVL") == (835.0, "device_kind_table")
    assert info("NVIDIA H100 PCIe MIG 1g.10gb") == (
        756.0, "device_kind_prefix:NVIDIA H100 PCIe")
    assert info("NVIDIA H100 80GB HBM3 MIG 3g.40gb")[0] == 989.0
    for kind in ("NVIDIA A100-SXM4-80GB", "NVIDIA A100-SXM4-40GB",
                 "NVIDIA A100-PCIE-40GB", "NVIDIA A100 80GB PCIe"):
        assert info(kind) == (312.0, "device_kind_table")
    # Another family must not take a prefix's peak.
    for kind in ("NVIDIA H100", "NVIDIA H100 80GB HBM3e", "NVIDIA H1000"):
        assert info(kind) == (0.0, f"unknown_device_kind:{kind}")
    assert info(torch.device("cpu")) == (0.0, "unknown_device_kind:<none>")
    assert mfu.peak_tflops("NVIDIA H100 PCIe") == 756.0
    monkeypatch.setenv("HVD_TPU_PEAK_TFLOPS", "123.5")
    assert info("whatever") == (123.5, "env_override")


@pytest.mark.parametrize("flops", [None, 0, 1.0, 3.5e12, 2.0e15])
def test_estimate_compute_us_equals_the_references(monkeypatch, flops):
    monkeypatch.setenv("HVD_TPU_PEAK_TFLOPS", "989")
    assert mfu.estimate_compute_us(flops, "NVIDIA H100 80GB HBM3") == \
        jmfu.estimate_compute_us(flops, Dev("TPU v5e"))
    monkeypatch.delenv("HVD_TPU_PEAK_TFLOPS")
    assert mfu.estimate_compute_us(flops, "NVIDIA H100 80GB HBM3") == \
        (None if not flops else flops / 989e12 * 1e6)
    assert mfu.estimate_compute_us(flops, "unknown card") is None


def test_count_flops_of_a_linear():
    m, k, n = 8, 32, 16
    lin = torch.nn.Linear(k, n, bias=False)
    x = torch.randn(m, k)
    fn, flops = mfu.count_flops(lin, x)
    assert fn is lin and flops == 2 * m * n * k
    assert mfu.count_flops(lambda: None)[1] is None
