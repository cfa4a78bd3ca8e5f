"""The port's LSF / jsrun launch (``horovod_tpu_torch/runner/lsf.py``)
against the reference's (``horovod_tpu/runner/lsf.py``).

Mirrors ``tests/test_lsf.py``.  No LSF cluster exists here, so the
allocation parsing, the jsrun command and the CLI's dispatch run against
a scheduler-shaped environment; the allocation's hosts equal the
reference's on the same fixtures.  jsrun's ``-E`` carries torchrun's
rendezvous (the reference's carries the JAX coordination service's), and
the scheduler's rank contract is behavioural: ``init`` in child
processes that have no ``RANK`` takes ``PMIX_RANK``,
``OMPI_COMM_WORLD_RANK`` or ``SLURM_PROCID``, and without any raises.
"""

import json
import os
import subprocess
import sys

import pytest

from horovod_tpu.runner import lsf as jlsf

from horovod_tpu_torch.runner import launch, lsf
from horovod_tpu_torch.runner.common.network import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LSF_VARS = ("LSB_JOBID", "LSB_DJOB_HOSTFILE", "LSB_MCPU_HOSTS")


@pytest.fixture
def clean_lsf_env(monkeypatch):
    for var in LSF_VARS:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def _both_hosts():
    out = []
    for mod in (lsf, jlsf):
        try:
            out.append((dict(mod.lsf_hosts()), list(mod.lsf_hosts()),
                        mod.world_size()))
        except RuntimeError as e:
            out.append(("RuntimeError", str(e)))
    return out


class TestDetection:
    def test_not_in_lsf(self, clean_lsf_env):
        assert not lsf.in_lsf() and not jlsf.in_lsf()
        with pytest.raises(RuntimeError, match="LSF allocation"):
            lsf.lsf_hosts()

    @pytest.mark.parametrize("lines", [
        "batch01\nnode01\nnode01\nnode02\nnode02\n",
        "batch01\n",
        "batch\nnode02\nnode01\nnode02\n\n",
        "",
    ])
    def test_hostfile_equals_the_references(self, clean_lsf_env, tmp_path,
                                            lines):
        hf = tmp_path / "hostfile"
        hf.write_text(lines)
        clean_lsf_env.setenv("LSB_JOBID", "1234")
        clean_lsf_env.setenv("LSB_DJOB_HOSTFILE", str(hf))
        assert lsf.in_lsf()
        port, ref = _both_hosts()
        assert port == ref

    def test_hostfile_parsing_skips_batch_host(self, clean_lsf_env,
                                               tmp_path):
        hf = tmp_path / "hostfile"
        hf.write_text("batch01\nnode01\nnode01\nnode02\nnode02\n")
        clean_lsf_env.setenv("LSB_JOBID", "1234")
        clean_lsf_env.setenv("LSB_DJOB_HOSTFILE", str(hf))
        hosts = lsf.lsf_hosts()
        assert hosts == {"node01": 2, "node02": 2}
        assert list(hosts)[0] == "node01"   # rank 0's host: the first
        assert lsf.world_size() == 4

    @pytest.mark.parametrize("mcpu", [
        "batch01 1 nodeA 2 nodeB 4", "nodeA 4", "batch 1 nodeA 2 nodeA 3",
        "odd 1 count", "",
    ])
    def test_mcpu_hosts_equal_the_references(self, clean_lsf_env, mcpu):
        clean_lsf_env.setenv("LSB_JOBID", "1")
        clean_lsf_env.setenv("LSB_MCPU_HOSTS", mcpu)
        port, ref = _both_hosts()
        assert port == ref
        if mcpu == "batch01 1 nodeA 2 nodeB 4":
            assert port[0] == {"nodeA": 2, "nodeB": 4} and port[2] == 6
        if mcpu == "nodeA 4":
            assert port[0] == {"nodeA": 4}


class TestJsrunCommand:
    def test_command_shape(self):
        cmd = lsf.jsrun_command(["python", "train.py"], 4, "node01:29500")
        assert cmd[0].endswith("jsrun")
        assert cmd[1:3] == ["--np", "4"]
        assert cmd[3:9] == ["--tasks_per_rs", "1", "--cpu_per_rs", "1",
                            "--gpu_per_rs", "1"]
        exported = [cmd[i + 1] for i, a in enumerate(cmd) if a == "-E"]
        assert exported == ["MASTER_ADDR=node01", "MASTER_PORT=29500",
                            "WORLD_SIZE=4"]
        assert cmd[-2:] == ["python", "train.py"]
        assert lsf.DEFAULT_PORT == jlsf.DEFAULT_PORT == 29500


class TestRunLsf:
    def test_missing_jsrun_errors_cleanly(self, clean_lsf_env, tmp_path,
                                          monkeypatch):
        hf = tmp_path / "hostfile"
        hf.write_text("batch\nnode01\nnode01\n")
        clean_lsf_env.setenv("LSB_JOBID", "1")
        clean_lsf_env.setenv("LSB_DJOB_HOSTFILE", str(hf))
        monkeypatch.setattr("shutil.which", lambda name: None)
        assert lsf.run_lsf(["python", "x.py"]) == 2

    def test_dispatch_through_jsrun(self, clean_lsf_env, tmp_path,
                                    monkeypatch):
        hf = tmp_path / "hostfile"
        hf.write_text("batch\nnode01\nnode01\nnode02\n")
        clean_lsf_env.setenv("LSB_JOBID", "1")
        clean_lsf_env.setenv("LSB_DJOB_HOSTFILE", str(hf))
        monkeypatch.setattr("shutil.which", lambda name: "/usr/bin/jsrun")
        captured = {}

        def fake_call(cmd, env=None):
            captured.update(cmd=cmd, env=env)
            return 0

        monkeypatch.setattr(subprocess, "call", fake_call)
        assert lsf.run_lsf(["python", "train.py"],
                           env={"HOROVOD_LOG_LEVEL": "debug"}) == 0
        assert captured["cmd"][:3] == ["/usr/bin/jsrun", "--np", "3"]
        assert "MASTER_ADDR=node01" in captured["cmd"]
        assert "WORLD_SIZE=3" in captured["cmd"]
        assert captured["env"]["HOROVOD_LOG_LEVEL"] == "debug"
        assert "HOROVOD_LOG_LEVEL" not in os.environ

    def test_cli_routes_to_lsf(self, clean_lsf_env, tmp_path, monkeypatch):
        hf = tmp_path / "hostfile"
        hf.write_text("batch\nnode01\n")
        clean_lsf_env.setenv("LSB_JOBID", "1")
        clean_lsf_env.setenv("LSB_DJOB_HOSTFILE", str(hf))
        called = {}

        def fake_run_lsf(command, np_=None, env=None, verbose=False):
            called.update(command=command, np=np_, env=env)
            return 0

        monkeypatch.setattr(lsf, "run_lsf", fake_run_lsf)
        assert launch.main(["python", "train.py"]) == 0
        assert called["command"] == ["python", "train.py"]
        assert called["np"] is None   # -np unset: the whole allocation
        assert launch.main(["-np", "1", "--log-level", "info", "python",
                            "train.py"]) == 0
        assert called["np"] == 1      # an explicit -np 1 exactly
        assert called["env"] == {"HOROVOD_LOG_LEVEL": "info"}
        assert "HOROVOD_LOG_LEVEL" not in os.environ
        seen = {}
        monkeypatch.setattr(launch, "run",
                            lambda np_, command, **kw: seen.update(np=np_)
                            or 0)
        assert launch.main(["-H", "localhost:2", "x"]) == 0  # -H wins
        assert seen["np"] == 2 and called["command"] == ["python",
                                                          "train.py"]


RANK_PROBE = """
import json, sys
import horovod_tpu_torch as hvd
hvd.init(device="cpu")
print(json.dumps([hvd.rank(), hvd.size()]))
hvd.shutdown()
"""


def _child_env(extra: dict) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "PMIX_RANK",
                        "OMPI_COMM_WORLD_RANK", "SLURM_PROCID")}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p)
    env.update(extra)
    return env


class TestSchedulerRankEnv:
    def test_scheduler_ranks_form_the_world(self):
        """Three tasks without ``RANK``, as jsrun, mpirun and srun start
        them: each takes its rank from the scheduler's variable."""
        common = {"WORLD_SIZE": "3", "MASTER_ADDR": "127.0.0.1",
                  "MASTER_PORT": str(free_port("127.0.0.1"))}
        procs = [subprocess.Popen(
            [sys.executable, "-c", RANK_PROBE], stdout=subprocess.PIPE,
            text=True, env=_child_env({**common, var: str(r)}))
            for r, var in enumerate(("PMIX_RANK", "OMPI_COMM_WORLD_RANK",
                                     "SLURM_PROCID"))]
        try:
            outs = [p.communicate(timeout=120)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        assert [p.returncode for p in procs] == [0, 0, 0]
        assert [json.loads(o.strip().splitlines()[-1]) for o in outs] == \
            [[0, 3], [1, 3], [2, 3]]

    def test_no_rank_raises_naming_the_contract(self):
        res = subprocess.run(
            [sys.executable, "-c", RANK_PROBE], capture_output=True,
            text=True, timeout=120,
            env=_child_env({"WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1",
                            "MASTER_PORT": "1"}))
        assert res.returncode != 0
        assert "RuntimeError: WORLD_SIZE=2 but no per-task rank" in \
            res.stderr
        for var in ("RANK", "PMIX_RANK", "OMPI_COMM_WORLD_RANK",
                    "SLURM_PROCID"):
            assert var in res.stderr
