"""The port's multi-host launch (``horovod_tpu_torch/runner/remote.py``,
``task_agent.py``, ``common/service.py``) against the reference's.

Mirrors ``tests/test_runner_services.py::TestDriverTaskMesh``, the remote
cases of ``tests/test_runner.py`` and
``tests/multiproc/test_remote_launch_mp.py`` (which the reference marks
slow; here it runs at 2 x 2 slots on gloo): two task agents run as
processes on loopback standing in for two hosts, and everything but ssh
is the real protocol (HMAC registration, the pairwise probe, the
reserved rendezvous port, the ranks' environment, exit-code
supervision, the agents' shutdown).  The ranks get torchrun's variables
(the reference's are the JAX coordination service's), so the contract
cases check those.  Pure functions are held against the reference's on
the same inputs.
"""

import json
import os
import random
import subprocess
import sys
import textwrap
import time

import pytest

from horovod_tpu.config import Config as JConfig
from horovod_tpu.runner import remote as jremote
from horovod_tpu.runner import task_agent as jtask_agent
from horovod_tpu.utils.retry import jittered as jjittered

from horovod_tpu_torch.config import Config
from horovod_tpu_torch.runner import launch, remote, run, task_agent
from horovod_tpu_torch.runner.common import network, secret
from horovod_tpu_torch.runner.common.service import (
    AllTaskAddressesRequest, DistributedExitCodesRequest, DriverService,
    RegisterTaskRequest, RunCommandRequest, RunDistributedCommandRequest, TaskService,
    probe_full_mesh,
)
from horovod_tpu_torch.utils.retry import jittered

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREAMBLE = """\
import json, os, sys, time
import torch
import horovod_tpu_torch as hvd
"""


@pytest.fixture
def key():
    return secret.make_secret_key()


@pytest.fixture
def agents(monkeypatch):
    """``local_exec`` as the remote exec, recording every agent it
    starts; the test then checks none is left running."""
    started = []

    def recording_exec(host, argv, secret_hex, **ssh_opts):
        proc = remote.local_exec(host, argv, secret_hex, **ssh_opts)
        started.append(proc)
        return proc

    monkeypatch.setattr(remote, "ssh_exec", recording_exec)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    monkeypatch.delenv(secret.SECRET_ENV, raising=False)
    yield started
    assert started and all(p.poll() is not None for p in started)


def _worker(tmp_path, body: str, name: str = "worker.py") -> list:
    path = tmp_path / name
    path.write_text(PREAMBLE + textwrap.dedent(body))
    return [sys.executable, str(path)]


def _results(tmp_path, n: int) -> list:
    return [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(n)]


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


CONTRACT = """
e = os.environ
hvd.init(device="cpu")
r = hvd.rank()
out = hvd.allreduce(torch.full((1, 2), r + 1.0), op=hvd.Sum, name="x")
res = dict(rank=r, size=hvd.size(), sum=out.tolist(),
           local=[hvd.local_rank(), hvd.local_size()],
           cross=[hvd.cross_rank(), hvd.cross_size()],
           env={k: e.get(k) for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                "LOCAL_WORLD_SIZE", "GROUP_RANK", "GROUP_WORLD_SIZE",
                "MASTER_ADDR", "MASTER_PORT", "HVD_TPU_SECRET_KEY",
                "HVD_TPU_COORDINATOR_ADDR", "HVD_TPU_PROCESS_ID")})
hvd.shutdown()
open(os.path.join(sys.argv[1], f"rank{r}.json"), "w").write(json.dumps(res))
"""


# --- the driver/task mesh (test_runner_services.py::TestDriverTaskMesh) ------

class TestDriverTaskMesh:
    def test_registration_and_probe(self, key):
        driver = DriverService(num_tasks=2, key=key)
        tasks = [TaskService(i, key) for i in range(2)]
        try:
            dclient = network.BasicClient(
                "driver", [("127.0.0.1", driver.port)], key)
            for t in tasks:
                dclient.request(RegisterTaskRequest(
                    t.index, [("127.0.0.1", t.port)], "localhost",
                    coordinator_port=t.reserve_coordinator_port()))
            driver.wait_for_initial_registration(timeout_s=10)
            table = dclient.request(AllTaskAddressesRequest(0)).all_addresses
            assert set(table) == {0, 1}
            assert set(driver.task_coordinator_ports()) == {0, 1}
            assert driver.task_hostnames() == {0: "localhost",
                                               1: "localhost"}
            routes = probe_full_mesh(driver, key)
            assert set(routes) == {(0, 1), (1, 0)}
            assert routes[(1, 0)] == ("127.0.0.1", tasks[0].port)
        finally:
            driver.shutdown()
            for t in tasks:
                t.shutdown()

    def test_registration_timeout(self, key):
        driver = DriverService(num_tasks=2, key=key)
        try:
            with pytest.raises(TimeoutError, match=r"\[0, 1\]"):
                driver.wait_for_initial_registration(timeout_s=0.2)
        finally:
            driver.shutdown()

    def test_run_command_through_task_service(self, key, capfd):
        task = TaskService(0, key)
        try:
            client = network.BasicClient("task-0", [("127.0.0.1",
                                                      task.port)], key)
            client.request(RunCommandRequest(
                [sys.executable, "-c", "print('hello-from-task')"], None))
            assert task.wait_for_command(timeout_s=30) == 0
            assert "hello-from-task" in capfd.readouterr().out
        finally:
            task.shutdown()

    def test_rank_environment_and_network_interfaces(self, key, tmp_path):
        """A task stamps torchrun's variables for each of its ranks, the
        key it holds (never one from the request) and, with
        ``--network-interfaces``, the same interfaces for gloo and NCCL;
        the reserved port is released before the ranks start."""
        nic = next(n for n, ips in network.local_addresses().items()
                   if "127.0.0.1" in ips)
        task = TaskService(1, key, nics=[nic])
        port = task.reserve_coordinator_port()
        script = tmp_path / "env.py"
        script.write_text(
            "import json, os, socket, sys\n"
            "e = dict(os.environ)\n"
            "if e['LOCAL_RANK'] == '0':\n"
            "    socket.socket().bind(('0.0.0.0', int(e['MASTER_PORT'])))\n"
            "path = os.path.join(sys.argv[1], 'env%s.json' % e['RANK'])\n"
            "open(path, 'w').write(json.dumps(e))\n")
        try:
            assert [ip for ip, _ in task.addresses()] == \
                network.local_addresses()[nic]
            client = network.BasicClient("task-1", [("127.0.0.1",
                                                      task.port)], key)
            client.request(RunDistributedCommandRequest(
                [sys.executable, str(script), str(tmp_path)],
                {"HVD_TPU_SECRET_KEY": "not-this-one", "X_FWD": "1"},
                [4, 5], 6, f"10.1.2.3:{port}", group_world_size=3),
                idempotent=False, timeout=30.0)
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                codes = client.request(DistributedExitCodesRequest()).codes
                if all(c is not None for c in codes.values()):
                    break
                time.sleep(0.1)
            assert codes == {4: 0, 5: 0}
        finally:
            task.shutdown()
        for rank, local in ((4, "0"), (5, "1")):
            e = json.loads((tmp_path / f"env{rank}.json").read_text())
            assert {k: e[k] for k in (
                "RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                "GROUP_RANK", "GROUP_WORLD_SIZE", "MASTER_ADDR",
                "MASTER_PORT", "X_FWD")} == {
                "RANK": str(rank), "WORLD_SIZE": "6", "LOCAL_RANK": local,
                "LOCAL_WORLD_SIZE": "2", "GROUP_RANK": "1",
                "GROUP_WORLD_SIZE": "3", "MASTER_ADDR": "10.1.2.3",
                "MASTER_PORT": str(port), "X_FWD": "1"}
            assert e["HVD_TPU_SECRET_KEY"] == key.decode()
            assert e["GLOO_SOCKET_IFNAME"] == e["NCCL_SOCKET_IFNAME"] == nic


# --- remote_run with local_exec (multiproc/test_remote_launch_mp.py) ----------

class TestRemoteLaunch:
    def test_two_hosts_two_slots_each_form_one_world(self, tmp_path, agents):
        """2 agents x 2 slots: one world of 4 (the sum allreduce gives 10),
        host 0 owning ranks 0-1, torchrun's variables a rank, one
        coordinator and one key."""
        rc = remote.remote_run([("fake-host-a", 2), ("fake-host-b", 2)],
                               _worker(tmp_path, CONTRACT) + [str(tmp_path)],
                               start_timeout=60.0)
        assert rc == 0
        res = _results(tmp_path, 4)
        coords, keys = set(), set()
        for r, out in enumerate(res):
            e = out["env"]
            assert out["size"] == 4 and out["sum"] == [[10.0, 10.0]]
            assert out["local"] == [r % 2, 2] and out["cross"] == [r // 2, 2]
            assert (e["RANK"], e["WORLD_SIZE"], e["LOCAL_RANK"],
                    e["LOCAL_WORLD_SIZE"], e["GROUP_RANK"],
                    e["GROUP_WORLD_SIZE"]) == (str(r), "4", str(r % 2), "2",
                                               str(r // 2), "2")
            assert e["HVD_TPU_COORDINATOR_ADDR"] is None
            assert e["HVD_TPU_PROCESS_ID"] is None
            coords.add((e["MASTER_ADDR"], e["MASTER_PORT"]))
            keys.add(e["HVD_TPU_SECRET_KEY"])
        assert len(coords) == 1 and len(keys) == 1
        assert len(keys.pop()) == 44

    def test_np_caps_world_across_hosts(self, tmp_path, agents):
        """``np_=3`` over a:2,b:2: host b holds one rank
        (``LOCAL_WORLD_SIZE=1``), both hosts are groups, and ``init``
        takes the uneven layout."""
        rc = remote.remote_run([("fake-host-a", 2), ("fake-host-b", 2)],
                               _worker(tmp_path, CONTRACT) + [str(tmp_path)],
                               np_=3, start_timeout=60.0)
        assert rc == 0
        res = _results(tmp_path, 3)
        assert [o["sum"] for o in res] == [[[6.0, 6.0]]] * 3
        assert [o["local"] for o in res] == [[0, 2], [1, 2], [0, 1]]
        assert [o["cross"] for o in res] == [[0, 2], [0, 2], [1, 2]]
        assert [o["env"]["GROUP_WORLD_SIZE"] for o in res] == ["2"] * 3
        assert not (tmp_path / "rank3.json").exists()

    def test_np_over_total_slots_raises(self):
        for mod in (remote, jremote):
            with pytest.raises(ValueError, match="exceeds total slots"):
                mod.remote_run([("a", 1), ("b", 1)], ["x"], np_=3,
                               exec_fn=mod.local_exec)

    def test_failing_rank_kills_job_and_reports_rc(self, tmp_path, agents):
        cmd = _worker(tmp_path, """
        r = int(os.environ["RANK"])
        open(os.path.join(sys.argv[1], f"pid{r}"), "w").write(
            str(os.getpid()))
        if r == 2:
            time.sleep(1.0)
            sys.exit(7)
        time.sleep(60)   # the survivors must be ended, not waited for
        """) + [str(tmp_path)]
        t0 = time.monotonic()
        assert remote.remote_run([("fake-host-a", 2), ("fake-host-b", 2)],
                                 cmd, start_timeout=60.0) == 7
        assert time.monotonic() - t0 < 45
        pids = [int((tmp_path / f"pid{r}").read_text()) for r in range(4)]
        assert not any(_alive(p) for p in pids)

    def test_cli_routes_nonlocal_hosts_through_agents(self, tmp_path,
                                                      agents):
        """``-H fake-a:1,fake-b:1`` takes the remote route (ssh replaced
        by ``local_exec``); the launch's own key is not forwarded."""
        os.environ[secret.SECRET_ENV] = "launcher-key-not-forwarded"
        try:
            rc = launch.main(["-H", "fake-a:1,fake-b:1", "--"]
                             + _worker(tmp_path, CONTRACT)
                             + [str(tmp_path)])
        finally:
            del os.environ[secret.SECRET_ENV]
        assert rc == 0
        res = _results(tmp_path, 2)
        assert [o["cross"] for o in res] == [[0, 2], [1, 2]]
        assert res[0]["env"]["HVD_TPU_SECRET_KEY"] == \
            res[1]["env"]["HVD_TPU_SECRET_KEY"] != "launcher-key-not-forwarded"


GPT_STEP = """
import hashlib
hvd.init(device="cpu")
r = hvd.rank()
cfg = hvd.models.GPTConfig(vocab_size=128, n_layer=2, n_head=4, d_model=64,
                           d_ff=256, max_seq_len=32, attention="flash")
model = hvd.models.GPT(cfg, device="cpu", seed=0)
hvd.broadcast_parameters(model.state_dict(), root_rank=0)
opt = hvd.DistributedOptimizer(
    torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4),
    compression=hvd.Compression.int8, error_feedback=True)
step = hvd.make_train_step(hvd.models.lm_loss_fn(model), opt)
tokens = torch.randint(0, 128, (2, 33),
                       generator=torch.Generator().manual_seed(r))
losses = [float(step(model, (tokens[:, :-1], tokens[:, 1:])))
          for _ in range(2)]
h = hashlib.sha256()
for _, p in sorted(model.named_parameters()):
    h.update(p.detach().numpy().tobytes())
from horovod_tpu_torch.obs import metrics
tiers = sorted(dict(s["labels"])["tier"] for s in metrics.registry()
               .snapshot().get("hvd_tpu_fusion_traces_total", []))
res = dict(losses=[v.hex() for v in losses], params=h.hexdigest(),
           cross=[hvd.cross_rank(), hvd.cross_size()], tiers=tiers)
hvd.shutdown()
open(os.path.join(sys.argv[1], f"rank{r}.json"), "w").write(json.dumps(res))
"""


def test_launch_route_changes_no_number(tmp_path, agents):
    """A 2-layer GPT's DP step on the int8+EF wire under ``remote_run``
    (2 fake hosts x 1) equals the same step under the local ``run`` bit
    for bit: losses and parameters.  (The step itself is held against
    JAX's ``make_train_step`` by ``tests/test_torch_port_train.py``.)"""
    local_dir, remote_dir = tmp_path / "local", tmp_path / "remote"
    local_dir.mkdir()
    remote_dir.mkdir()
    cmd = _worker(tmp_path, GPT_STEP)
    assert run(2, cmd + [str(local_dir)], start_timeout=60.0) == 0
    assert remote.remote_run([("fake-host-a", 1), ("fake-host-b", 1)],
                             cmd + [str(remote_dir)],
                             start_timeout=60.0) == 0
    loc, rem = _results(local_dir, 2), _results(remote_dir, 2)
    assert [o["cross"] for o in loc] == [[0, 1], [0, 1]]
    assert [o["cross"] for o in rem] == [[0, 2], [1, 2]]
    for a, b in zip(loc, rem):
        assert (a["losses"], a["params"]) == (b["losses"], b["params"])
        assert a["tiers"] == b["tiers"] and a["tiers"]
    assert loc[0]["params"] == loc[1]["params"]


# --- the ssh exec, the flags, the agent's liveness --------------------------------

def test_ssh_argv_and_the_secret_on_stdin(monkeypatch):
    """``ssh_exec`` carries ``-p`` / ``-i`` and BatchMode; the secret goes
    on stdin, never on argv, as in the reference."""
    built = {}

    class FakeStdin:
        def write(self, text):
            built.setdefault("stdin", []).append(text)

        def flush(self):
            pass

        def close(self):
            built["closed"] = True

    class FakeProc:
        stdin = FakeStdin()

    for mod in (remote, jremote):
        built.clear()
        monkeypatch.setattr(
            mod.subprocess, "Popen",
            lambda cmd, **kw: built.update(cmd=cmd, kw=kw) or FakeProc())
        mod.ssh_exec("otherhost", ["agent", "--index", "0"], "c0ffee",
                     ssh_port=2222, ssh_identity_file="/id_rsa")
        cmd = built["cmd"]
        assert cmd[:5] == ["ssh", "-o", "BatchMode=yes", "-o",
                           "StrictHostKeyChecking=no"]
        assert cmd[cmd.index("-p") + 1] == "2222"
        assert cmd[cmd.index("-i") + 1] == "/id_rsa"
        assert cmd[-5:] == ["--", "otherhost", "agent", "--index", "0"]
        assert "c0ffee" not in " ".join(cmd)
        assert built["stdin"] == ["c0ffee\n"] and built["closed"]
        assert built["kw"]["stdin"] == subprocess.PIPE
    argv = remote._agent_argv(3, [("10.0.0.1", 5), ("127.0.0.1", 5)], 9.0,
                              nics=["eth1"])
    assert argv[1:3] == ["-m", "horovod_tpu_torch.runner.task_agent"]
    assert argv[3:] == jremote._agent_argv(
        3, [("10.0.0.1", 5), ("127.0.0.1", 5)], 9.0, nics=["eth1"])[3:]


def test_flags_and_forwarded_env_reach_remote_run(monkeypatch):
    """``--ssh-port``, ``--ssh-identity-file`` and ``--network-interfaces``
    reach ``remote_run`` as parameters; the environment forwarded is the
    framework's (``HOROVOD_``, ``HVD_TPU_``, ``NCCL_``, ``TORCH_``,
    ``PYTHONPATH``, ``PYTHONUNBUFFERED``) without the key, the rank
    contract or ``CUDA_VISIBLE_DEVICES``."""
    seen = {}
    monkeypatch.setattr(
        "horovod_tpu_torch.runner.remote.remote_run",
        lambda hosts, command, **kw: seen.update(kw) or 0)
    for var, value in (("NCCL_DEBUG", "INFO"), ("TORCH_SHOW_CPP", "1"),
                       ("HVD_TPU_RPC_RETRIES", "5"), ("RANK", "3"),
                       ("MASTER_ADDR", "x"), ("CUDA_VISIBLE_DEVICES", "1"),
                       ("PYTHONUNBUFFERED", "1"), ("JAX_PLATFORMS", "cpu"),
                       (secret.SECRET_ENV, "k")):
        monkeypatch.setenv(var, value)
    assert launch.main(["-H", "otherhost:1", "--ssh-port", "2222",
                        "--ssh-identity-file", "/id_rsa",
                        "--network-interfaces", "eth1,eth2",
                        "--log-level", "debug", "x"]) == 0
    assert (seen["ssh_port"], seen["ssh_identity_file"], seen["nics"]) == \
        (2222, "/id_rsa", ["eth1", "eth2"])
    env = seen["env"]
    assert env["NCCL_DEBUG"] == "INFO" and env["TORCH_SHOW_CPP"] == "1"
    assert env["HVD_TPU_RPC_RETRIES"] == "5"
    assert env["PYTHONUNBUFFERED"] == "1"
    assert env["HOROVOD_LOG_LEVEL"] == "debug"
    for gone in ("RANK", "MASTER_ADDR", "CUDA_VISIBLE_DEVICES",
                 "JAX_PLATFORMS", secret.SECRET_ENV):
        assert gone not in env


def test_agent_aborts_its_workers_when_the_driver_is_gone(tmp_path, key):
    """An agent whose driver stops answering aborts its running worker
    after ``HVD_TPU_AGENT_MAX_MISSED`` pings at
    ``HVD_TPU_AGENT_PING_INTERVAL`` and exits 1."""
    driver = DriverService(num_tasks=1, key=key)
    env = {**os.environ, "HVD_TPU_AGENT_PING_INTERVAL": "0.5",
           "HVD_TPU_AGENT_MAX_MISSED": "2",
           "PYTHONPATH": os.pathsep.join(
               p for p in (REPO, os.environ.get("PYTHONPATH")) if p)}
    proc = subprocess.Popen(
        remote._agent_argv(0, [("127.0.0.1", driver.port)], 60.0),
        stdin=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    proc.stdin.write(key.hex() + "\n")
    proc.stdin.close()
    pid_file = tmp_path / "pid"
    try:
        driver.wait_for_initial_registration(timeout_s=60)
        client = network.BasicClient(
            "task-0", driver.task_addresses()[0], key)
        client.request(RunDistributedCommandRequest(
            [sys.executable, "-c",
             f"import os, time; open({str(pid_file)!r}, 'w')"
             ".write(str(os.getpid())); time.sleep(120)"],
            {}, [0], 1, "127.0.0.1:1"), idempotent=False, timeout=30.0)
        deadline = time.monotonic() + 30
        while not pid_file.exists() and time.monotonic() < deadline:
            time.sleep(0.1)
        worker = int(pid_file.read_text())
    finally:
        driver.shutdown()
    try:
        assert proc.wait(timeout=30) == 1
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert "missed pings" in proc.stderr.read()
    assert not _alive(worker)


# --- pure functions against the reference's ------------------------------------

HOST_SPECS = ["a:2,b:4", "localhost", "host1", " a:1 , ,b:2", "x:0",
              ":3", "a:b", "a:1,:2", ""]


@pytest.mark.parametrize("spec", HOST_SPECS)
def test_parse_hosts_equals_the_references(spec):
    def outcome(fn):
        try:
            return fn(spec)
        except ValueError as e:
            return ("ValueError", str(e))

    assert outcome(remote.parse_hosts) == outcome(jremote.parse_hosts)
    assert launch.parse_hosts is remote.parse_hosts
    assert launch.is_local_host is remote.is_local_host


def test_is_local_host_and_parse_addresses_equal_the_references():
    import socket

    for host in ("localhost", "127.0.0.1", socket.gethostname(),
                 "fake-host-a", "127.0.0.2", ""):
        assert remote.is_local_host(host) == jremote.is_local_host(host)
    for spec in ("10.0.0.1:5", "10.0.0.1:5,127.0.0.1:6", "h:1,h2:2,h3:3",
                 "::1:7", "x", "h:", "h:p"):
        def outcome(mod):
            try:
                return mod.parse_addresses(spec)
            except ValueError as e:
                return ("ValueError", str(e))

        assert outcome(task_agent) == outcome(jtask_agent)


@pytest.mark.parametrize("env", [
    {}, {"HVD_TPU_AGENT_PING_INTERVAL": "2.5",
         "HVD_TPU_AGENT_MAX_MISSED": "7"},
    {"HOROVOD_AGENT_PING_INTERVAL": "0.5", "HVD_TPU_AGENT_MAX_MISSED": "1"},
])
def test_agent_knobs_equal_the_references(env, monkeypatch):
    for var in ("AGENT_PING_INTERVAL", "AGENT_MAX_MISSED"):
        for prefix in ("HOROVOD_", "HVD_TPU_"):
            monkeypatch.delenv(prefix + var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    port, ref = Config.from_env(), JConfig.from_env()
    assert (port.agent_ping_interval_seconds, port.agent_max_missed_pings) \
        == (ref.agent_ping_interval_seconds, ref.agent_max_missed_pings)


@pytest.mark.parametrize("index", [0, 1, 7])
def test_agent_ping_cadence_equals_the_references(index):
    """The agent's waits: ``jittered(interval, 0.25, Random(index))``,
    then the ramp after missed pings, the same sequence in both."""
    waits = {}
    for label, fn in (("port", jittered), ("ref", jjittered)):
        rng = random.Random(index)
        seq = [fn(15.0, 0.25, rng) for _ in range(8)]
        seq += [fn(min(15.0, 1.0 * 2 ** (m - 1)), 0.5, rng)
                for m in (1, 2, 3)]
        waits[label] = seq
    assert waits["port"] == waits["ref"]
    assert all(11.25 <= w <= 18.75 for w in waits["port"][:8])
