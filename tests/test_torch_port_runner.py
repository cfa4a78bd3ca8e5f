"""The port's launcher and control-plane RPC (``horovod_tpu_torch/
runner``) against the reference's (``horovod_tpu/runner``).

Mirrors ``tests/test_runner.py`` and ``tests/test_runner_services.py``'s
``TestSecret``, ``TestNetwork`` and ``TestSafeShellExec`` with real
subprocesses on loopback.  Parity: ``vars(parse_args(argv))`` equals the
reference's on the reference tests' argvs and config files; the ``rpc``
fault site fires at the same event index as the reference's.  The
launcher gives each worker torchrun's variables (the reference's are the
JAX coordination service's), so the env-contract cases check those; a
host list naming another host goes to ``remote.remote_run``
(``tests/test_torch_port_remote.py`` forms that world).
"""

import os
import subprocess
import sys
import threading
import time

import pytest

from horovod_tpu.runner import launch as jlaunch
from horovod_tpu.runner.common import network as jnetwork

from horovod_tpu_torch.runner import check_build_str, launch, parse_args, run
from horovod_tpu_torch.runner.common import network, secret
from horovod_tpu_torch.runner.common.safe_shell_exec import execute

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOB_VARS = ("HOROVOD_LOG_LEVEL", "HOROVOD_TIMELINE",
             "HOROVOD_TIMELINE_MARK_CYCLES", "HOROVOD_AUTOTUNE",
             "HOROVOD_AUTOTUNE_LOG", "HOROVOD_FUSION_THRESHOLD",
             "HOROVOD_CACHE_CAPACITY", "HOROVOD_CYCLE_TIME",
             "HOROVOD_HIERARCHICAL_ALLREDUCE", "HOROVOD_STALL_CHECK_DISABLE",
             "HOROVOD_STALL_CHECK_TIME_SECONDS",
             "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS")


@pytest.fixture(autouse=True)
def _clean_knobs(monkeypatch):
    for var in KNOB_VARS + (secret.SECRET_ENV,):
        monkeypatch.delenv(var, raising=False)


def _script(tmp_path, body: str, name: str = "w.py") -> str:
    path = tmp_path / name
    path.write_text("import os, sys\n" + body)
    return str(path)


# --- parse_args: the reference's, flag for flag --------------------------------

ARGVS = [
    ["-np", "4", "python", "train.py"],
    ["--check-build"],
    ["-np", "2", "--min-np", "1", "--max-np", "4",
     "--host-discovery-script", "./d.sh", "x"],
    ["-np", "2", "-H", "otherhost:8", "x"],
    ["-H", ":3", "x"],
    ["--hostfile", "/nonexistent", "x"],
    ["-H", "otherhost:1", "--ssh-port", "2222", "--ssh-identity-file",
     "/id_rsa", "--network-interfaces", "eth1,eth2", "x"],
    ["-np", "1", "--log-level", "DEBUG", "--", "python", "w.py"],
    ["-np", "2", "--timeline-filename", "/t.json", "--timeline-mark-cycles",
     "--autotune", "--autotune-log-file", "a.jsonl", "--", "python", "w.py"],
    ["-np", "1", "--fusion-threshold-mb", "32", "--cache-capacity", "128",
     "--hierarchical-allreduce", "--no-stall-check",
     "--stall-check-warning-time-seconds", "30", "--", "python", "w.py"],
    ["-np", "2", "--output-filename", "/logs", "--", "python", "w.py"],
    ["--reset-limit", "0", "--blacklist-after", "3", "--coordinator",
     "127.0.0.1:29500", "--start-timeout", "5", "--verbose",
     "--cycle-time-ms", "2.5", "--hierarchical-allgather",
     "--stall-check-shutdown-time-seconds", "90", "x", "--reset-limit", "9"],
    ["-np", "9", "-H", "localhost:4", "x"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_parse_args_equals_the_references(argv):
    assert vars(parse_args(list(argv))) == vars(jlaunch.parse_args(list(argv)))


def test_version_flag(capsys):
    from horovod_tpu_torch.version import __version__

    with pytest.raises(SystemExit) as exc:
        parse_args(["--version"])
    assert exc.value.code == 0
    assert __version__ in capsys.readouterr().out


def test_abbreviated_flags_rejected(capsys):
    for argv in (["--fusion", "32", "--", "true"], ["--time", "x", "y"]):
        with pytest.raises(SystemExit):
            parse_args(argv)
        with pytest.raises(SystemExit):
            jlaunch.parse_args(argv)
    capsys.readouterr()


CONFIGS = {
    "cfg": "fusion-threshold-mb: 16\nhierarchical-allreduce: true\n"
           "log_level: debug\n",
    "reset": "reset-limit: 5\n",
    "quoted": "hierarchical-allreduce: 'false'\n",
}
CONFIG_ERRORS = {
    "no-such-flag: 1\n": "unknown parameter",
    "fusion-threshold-mb: not-a-number\n": "bad value",
    "log-level: deubg\n": "must be one of",
    "hierarchical-allreduce: maybe\n": "bad value.*boolean",
    "help: true\n": "unknown parameter",
}


def test_config_file_equals_the_references(tmp_path):
    for name, text in CONFIGS.items():
        path = tmp_path / f"{name}.yaml"
        path.write_text(text)
        for argv in (["--config-file", str(path), "--", "true"],
                     ["--config-file", str(path), "--fusion-threshold-mb",
                      "64", "--reset-limit", "0", "--", "true"],
                     ["--config-file", str(path), "--", "prog",
                      "--reset-limit", "9"]):
            assert vars(parse_args(argv)) == vars(jlaunch.parse_args(argv))
    args = parse_args(["--config-file", str(tmp_path / "cfg.yaml"),
                       "--fusion-threshold-mb", "64", "--", "true"])
    assert args.fusion_threshold_mb == 64 and args.log_level == "debug"
    assert args.hierarchical_allreduce is True
    for text, match in CONFIG_ERRORS.items():
        path = tmp_path / "bad.yaml"
        path.write_text(text)
        for parse in (parse_args, jlaunch.parse_args):
            with pytest.raises(SystemExit, match=match):
                parse(["--config-file", str(path), "--", "true"])


def test_config_file_without_pyyaml_names_it(tmp_path, monkeypatch):
    cfg = tmp_path / "h.yaml"
    cfg.write_text("verbose: true\n")
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(SystemExit, match="pyyaml"):
        parse_args(["--config-file", str(cfg), "--", "true"])


# --- --check-build ------------------------------------------------------------

def test_check_build_reports_the_native_route():
    out = check_build_str()
    assert "horovod_tpu_torch v" in out and "torch.distributed" in out
    assert "[X] native runtime built (ABI 3" in out
    assert "route: native" in out
    for name in ("int8_kernels", "flash_attention", "fused_apply",
                 "matmul"):
        assert f"csrc/{name}.cu" in out
    assert "jax" not in out.lower()


def test_cli_check_build():
    res = subprocess.run([sys.executable, "-m", "horovod_tpu_torch.runner",
                          "--check-build"], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert res.returncode == 0, res.stderr
    assert "Native control plane" in res.stdout


# --- local runs ---------------------------------------------------------------

def test_single_process_success_and_failure():
    assert run(1, [sys.executable, "-c", "print('ok')"]) == 0
    assert run(1, [sys.executable, "-c", "raise SystemExit(3)"]) == 3


def test_env_contract(tmp_path):
    """Each worker gets torchrun's variables, one world, and the launch's
    secret; none of the reference's JAX coordination variables."""
    script = _script(tmp_path, (
        "e = os.environ\n"
        "r = int(e['RANK'])\n"
        "assert r in (0, 1) and e['LOCAL_RANK'] == str(r)\n"
        "assert e['WORLD_SIZE'] == e['LOCAL_WORLD_SIZE'] == '2'\n"
        "assert e['GROUP_RANK'] == '0' and e['GROUP_WORLD_SIZE'] == '1'\n"
        "assert e['MASTER_ADDR'] == '127.0.0.1'\n"
        "assert e['MASTER_PORT'] == '29517'\n"
        f"assert len(e['{secret.SECRET_ENV}']) == 44\n"
        "assert 'HVD_TPU_COORDINATOR_ADDR' not in e\n"
        "assert 'HVD_TPU_PROCESS_ID' not in e\n"
        f"open(os.path.join({str(tmp_path)!r}, 'key%d' % r), 'w')"
        f".write(e['{secret.SECRET_ENV}'])\n"))
    assert run(2, [sys.executable, script],
               coordinator="127.0.0.1:29517") == 0
    keys = {(tmp_path / f"key{r}").read_text() for r in (0, 1)}
    assert len(keys) == 1   # one key a launch


def test_peer_failure_kills_job(tmp_path):
    script = _script(tmp_path, (
        "import time\n"
        "if os.environ['RANK'] == '0':\n"
        "    sys.exit(7)\n"
        "time.sleep(60)\n"))
    t0 = time.monotonic()
    assert run(2, [sys.executable, script]) == 7
    assert time.monotonic() - t0 < 30


def test_start_timeout_fires_when_no_worker_inits(tmp_path):
    script = _script(tmp_path, "import time\ntime.sleep(300)\n")
    with pytest.raises(TimeoutError, match="failed to start"):
        run(2, [sys.executable, script], start_timeout=2.0)


def test_no_command_and_bad_hosts_error():
    assert launch.main(["-np", "2"]) == 2
    assert launch.main(["-H", ":3", "x"]) == 2
    assert launch.main(["-np", "9", "-H", "localhost:4", "x"]) == 2


def test_remote_hosts_route_to_agent_mesh(tmp_path, monkeypatch):
    """A host list naming another host goes through ``remote_run`` (the
    reference's ``test_runner.py::test_remote_hosts_route_to_agent_mesh``
    and its hostfile case); the world itself forms in
    ``tests/test_torch_port_remote.py``."""
    seen = {}

    def fake_remote_run(hosts, command, **kw):
        seen.update(hosts=hosts, command=command, np=kw.get("np_"))
        return 0

    monkeypatch.setattr("horovod_tpu_torch.runner.remote.remote_run",
                        fake_remote_run)
    assert launch.main(["-np", "2", "-H", "otherhost:8", "x"]) == 0
    assert seen == {"hosts": [("otherhost", 8)], "command": ["x"], "np": 2}
    hf = tmp_path / "hosts"
    hf.write_text("# cluster A\nnodeA slots=4\nnodeB:2\nnodeC\n")
    assert launch.main(["--hostfile", str(hf), "x"]) == 0
    assert seen["hosts"] == [("nodeA", 4), ("nodeB", 2), ("nodeC", 1)]
    assert seen["np"] is None


def test_hostfile_formats_and_local_slots(tmp_path, monkeypatch):
    hf = tmp_path / "hosts"
    hf.write_text("# cluster A\nnodeA slots=4\nnodeB:2\nnodeC\n")
    assert launch.parse_hostfile(str(hf)) == \
        jlaunch.parse_hostfile(str(hf)) == "nodeA:4,nodeB:2,nodeC:1"
    seen = {}
    monkeypatch.setattr(launch, "run",
                        lambda np_, command, **kw: seen.update(np=np_) or 0)
    hf.write_text("localhost slots=8\n")
    assert launch.main(["--hostfile", str(hf), "x"]) == 0
    assert seen["np"] == 8
    assert launch.main(["-H", "localhost:4", "x"]) == 0
    assert seen["np"] == 4
    assert launch.main(["-np", "2", "-H", "localhost:4", "x"]) == 0
    assert seen["np"] == 2


def test_hostfile_errors(tmp_path):
    assert launch.main(["--hostfile", "/nonexistent", "x"]) == 2
    for bad in ("nodeA slots=xyz", "nodeA 4", "localhost:abc"):
        hf = tmp_path / "bad"
        hf.write_text(bad + "\n")
        assert launch.main(["--hostfile", str(hf), "x"]) == 2, bad
    assert launch.main(["-H", "a:1", "--hostfile", str(hf), "x"]) == 2


def test_knob_flags_reach_workers_through_env_only(tmp_path):
    tl = tmp_path / "t.json"
    script = _script(tmp_path, (
        "e = os.environ\n"
        "want = {'HOROVOD_LOG_LEVEL': 'debug',\n"
        f"        'HOROVOD_TIMELINE': {str(tl)!r},\n"
        "        'HOROVOD_TIMELINE_MARK_CYCLES': '1',\n"
        "        'HOROVOD_AUTOTUNE': '1', 'HOROVOD_AUTOTUNE_LOG': 'a.jsonl',\n"
        "        'HOROVOD_FUSION_THRESHOLD': str(32 << 20),\n"
        "        'HOROVOD_CACHE_CAPACITY': '128',\n"
        "        'HOROVOD_CYCLE_TIME': '2.5',\n"
        "        'HOROVOD_HIERARCHICAL_ALLREDUCE': '1',\n"
        "        'HOROVOD_STALL_CHECK_DISABLE': '1',\n"
        "        'HOROVOD_STALL_CHECK_TIME_SECONDS': '30.0',\n"
        "        'HOROVOD_STALL_SHUTDOWN_TIME_SECONDS': '90.0'}\n"
        "sys.exit(0 if all(e.get(k) == v for k, v in want.items()) "
        "else 5)\n"))
    assert launch.main(
        ["-np", "2", "--log-level", "DEBUG", "--timeline-filename", str(tl),
         "--timeline-mark-cycles", "--autotune", "--autotune-log-file",
         "a.jsonl", "--fusion-threshold-mb", "32", "--cache-capacity",
         "128", "--cycle-time-ms", "2.5", "--hierarchical-allreduce",
         "--no-stall-check", "--stall-check-warning-time-seconds", "30",
         "--stall-check-shutdown-time-seconds", "90", "--",
         sys.executable, script]) == 0
    for var in KNOB_VARS:
        assert var not in os.environ   # the launcher's env is untouched


def test_config_file_reaches_workers(tmp_path):
    cfg = tmp_path / "h.yaml"
    cfg.write_text("fusion-threshold-mb: 16\nstall-check-warning-time-"
                   "seconds: 7\n")
    script = _script(tmp_path, (
        "ok = (os.environ.get('HOROVOD_FUSION_THRESHOLD') == str(16 << 20)\n"
        "      and os.environ.get('HOROVOD_STALL_CHECK_TIME_SECONDS')"
        " == '7.0')\n"
        "sys.exit(0 if ok else 5)\n"))
    assert launch.main(["--config-file", str(cfg), "--", sys.executable,
                        script]) == 0


def test_output_filename_writes_per_rank_files(tmp_path):
    outdir = tmp_path / "logs"
    script = _script(tmp_path, (
        "print('out-rank', os.environ['RANK'])\n"
        "print('err-rank', os.environ['RANK'], file=sys.stderr)\n"))
    assert launch.main(["-np", "2", "--output-filename", str(outdir), "--",
                        sys.executable, script]) == 0
    for rank in (0, 1):
        assert (outdir / f"rank.{rank}.stdout").read_text() == \
            f"out-rank {rank}\n"
        assert (outdir / f"rank.{rank}.stderr").read_text() == \
            f"err-rank {rank}\n"


def test_elastic_run_sizes_the_world_from_discovery(tmp_path):
    disc = _script(tmp_path, "print('localhost:2')\n", "discover.py")
    os.chmod(disc, 0o755)
    with open(disc) as f:
        body = f.read()
    with open(disc, "w") as f:
        f.write(f"#!{sys.executable}\n" + body)
    script = _script(tmp_path, "sys.exit(0 if os.environ['WORLD_SIZE'] "
                               "== '2' else 4)\n")
    assert launch.main(["-np", "2", "--min-np", "1", "--max-np", "2",
                        "--host-discovery-script", disc, "--",
                        sys.executable, script]) == 0


def test_two_process_allreduce_through_the_launcher(tmp_path):
    """Two real processes rendezvous from the launcher's variables over
    gloo, allreduce, and run the native host runtime."""
    script = _script(tmp_path, (
        "import torch\n"
        "import horovod_tpu_torch as hvd\n"
        "from horovod_tpu_torch.native import bindings\n"
        "hvd.init(device='cpu')\n"
        "assert hvd.size() == 2 and hvd.local_size() == 2\n"
        "assert hvd.cross_size() == 1\n"
        "x = torch.full((3, 4), hvd.rank() + 1.0)\n"
        "out = hvd.allreduce(x, op=hvd.Sum, name='x')\n"
        "assert torch.equal(out, torch.full((3, 4), 3.0)), out\n"
        "assert bindings.available() and hvd.timeline().native\n"
        "assert hvd.peek('cross_monitor')._thread.is_alive()\n"
        "hvd.shutdown()\n"
        "print('rank', os.environ['RANK'], 'ok')\n"))
    env = {"PYTHONPATH": os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p)}
    outdir = tmp_path / "out"
    rc = run(2, [sys.executable, script], env={
        **env, "HOROVOD_TIMELINE": str(tmp_path / "tl.json")},
        start_timeout=60.0, output_dir=str(outdir))
    logs = {r: (outdir / f"rank.{r}.stderr").read_text() for r in (0, 1)}
    assert rc == 0, logs
    for r in (0, 1):
        assert (outdir / f"rank.{r}.stdout").read_text() == f"rank {r} ok\n"
    assert (tmp_path / "tl.json").exists()
    assert (tmp_path / "tl.json.rank1").exists()


# --- secret, network, safe shell exec -----------------------------------------

@pytest.fixture
def key():
    return secret.make_secret_key()


class TestSecret:
    def test_distinct(self):
        assert secret.make_secret_key() != secret.make_secret_key()

    def test_env_roundtrip(self, key, monkeypatch):
        monkeypatch.setenv(secret.SECRET_ENV, key.decode())
        assert secret.secret_from_env() == key

    def test_env_missing(self):
        with pytest.raises(RuntimeError, match="not set"):
            secret.secret_from_env()


class TestNetwork:
    def test_local_addresses(self):
        addrs = network.local_addresses()
        assert any(ip.startswith("127.") for ips in addrs.values()
                   for ip in ips)
        assert set(network.routable_addresses()) >= \
            set(network.routable_addresses(include_loopback=False))

    def test_ping_and_answers_from_obs(self, key):
        svc = network.BasicService("svc", key)
        try:
            client = network.BasicClient("svc", [("127.0.0.1", svc.port)],
                                         key)
            resp = client.ping()
            assert resp.service_name == "svc" and resp.clock_us > 0
            m = client.request(network.MetricsRequest(fmt="prometheus"))
            assert "metrics" in m.snapshot and m.prometheus is not None
            t = client.request(network.TraceRequest())
            assert isinstance(t.spans, list) and t.pid == os.getpid()
            assert isinstance(client.request(object()),
                              network.AckResponse)
        finally:
            svc.shutdown()

    def test_bad_key_rejected(self, key):
        svc = network.BasicService("svc", key)
        try:
            with pytest.raises(ConnectionError):
                network.BasicClient("svc", [("127.0.0.1", svc.port)],
                                    b"wrong-key", probe_timeout=2.0)
        finally:
            svc.shutdown()

    def test_wrong_service_name_rejected(self, key):
        svc = network.BasicService("actual", key)
        try:
            with pytest.raises(ConnectionError):
                network.BasicClient("expected", [("127.0.0.1", svc.port)],
                                    key, probe_timeout=2.0)
        finally:
            svc.shutdown()

    def test_network_interfaces_filter_advertised_addresses(self,
                                                           monkeypatch):
        monkeypatch.setattr(
            network, "local_addresses",
            lambda: {"eth0": ["10.0.0.5"], "eth1": ["192.168.1.9"],
                     "lo": ["127.0.0.1"]})
        svc = network.BasicService("t", b"k" * 32, nics=["eth1"])
        try:
            ips = [ip for ip, _ in svc.addresses()]
            assert "192.168.1.9" in ips and "127.0.0.1" in ips
            assert "10.0.0.5" not in ips
        finally:
            svc.shutdown()
        bad = network.BasicService("t2", b"k" * 32, nics=["eth9"])
        try:
            with pytest.raises(ValueError, match="eth9"):
                bad.addresses()
        finally:
            bad.shutdown()

    def test_request_keywords_match_the_reference(self, key):
        """``request(req, *, idempotent=, timeout=)`` as the
        reference's.  ``idempotent=False`` is one attempt: under the
        ``rpc`` drop site it raises where the idempotent request retries,
        and a request whose response is lost reaches the service once,
        not once an attempt.  Both packages count the same."""
        from horovod_tpu import faults as jfaults
        from horovod_tpu.utils.retry import RetryPolicy as JRetryPolicy

        from horovod_tpu_torch import faults
        from horovod_tpu_torch.utils.retry import RetryPolicy

        got = {}
        for label, net, flt, policy in (
                ("port", network, faults, RetryPolicy),
                ("ref", jnetwork, jfaults, JRetryPolicy)):
            seen = []

            class Slow(net.BasicService):
                def _handle(self, req, client_address):
                    if isinstance(req, net.MetricsRequest):
                        seen.append(req.fmt)
                        time.sleep(0.5)
                    return super()._handle(req, client_address)

            svc = Slow("svc", key)
            try:
                client = net.BasicClient(
                    "svc", [("127.0.0.1", svc.port)], key,
                    retry_policy=policy(attempts=3, base_delay_s=0.001,
                                        max_delay_s=0.002))
                out = [type(client.request(net.PingRequest(),
                                           idempotent=False)).__name__,
                       type(client.request(net.PingRequest(),
                                           timeout=30.0)).__name__]
                with flt.inject("rpc:step=0,mode=drop"):
                    with pytest.raises(ConnectionError):
                        client.request(net.PingRequest(), idempotent=False)
                    out.append(len(flt.history()))
                with flt.inject("rpc:step=0,mode=drop"):
                    out.append(type(client.request(net.PingRequest())
                                    ).__name__)
                    out.append([tuple(h)[:3] for h in flt.history()])
                # The response lost (read timeout): one attempt reaches
                # the service once; the idempotent request, each try.
                with pytest.raises(OSError):
                    client.request(net.MetricsRequest("once"),
                                   idempotent=False, timeout=0.1)
                with pytest.raises(OSError):
                    client.request(net.MetricsRequest("retried"),
                                   timeout=0.1)
                time.sleep(0.6)
                out.append(list(seen))
            finally:
                svc.shutdown()
            got[label] = out
        assert got["port"] == got["ref"]
        assert got["port"][:3] == ["PingResponse", "PingResponse", 1]
        assert got["port"][-1] == ["once"] + ["retried"] * 3

    def test_any_name_and_no_probe(self, key):
        """``name=None`` takes whichever service answers and its
        name; ``probe=False`` uses the first address with no ping (the
        request is the probe) and refuses an empty list."""
        from horovod_tpu.utils.retry import RetryPolicy as JRetryPolicy

        from horovod_tpu_torch.utils.retry import RetryPolicy

        dead = ("127.0.0.1", network.free_port("127.0.0.1"))
        got = {}
        for label, net, policy in (("port", network, RetryPolicy),
                                   ("ref", jnetwork, JRetryPolicy)):
            svc = net.BasicService("actual", key)
            live = ("127.0.0.1", svc.port)
            try:
                anyone = net.BasicClient(None, [dead, live], key,
                                         probe_timeout=2.0)
                blind = net.BasicClient("actual", [dead, live], key,
                                        probe=False,
                                        retry_policy=policy(attempts=1))
                with pytest.raises(OSError):
                    blind.request(net.PingRequest())
                direct = net.BasicClient("whatever", [live], key,
                                         probe=False)
                with pytest.raises(ValueError, match="at least one"):
                    net.BasicClient("actual", [], key, probe=False)
                got[label] = (anyone.name, anyone.address == live,
                              blind.address == dead,
                              direct.ping().service_name)
            finally:
                svc.shutdown()
        assert got["port"] == got["ref"] == ("actual", True, True, "actual")

    def test_rpc_fault_fires_at_the_references_event_index(self, key):
        """The same exchanges under the same plan in both packages: the
        ``rpc`` site's firings (event index, mode, request type)."""
        from horovod_tpu import faults as jfaults
        from horovod_tpu.utils.retry import RetryPolicy as JRetryPolicy

        from horovod_tpu_torch import faults
        from horovod_tpu_torch.utils.retry import RetryPolicy

        spec = "rpc:p=0.5,seed=3,times=3,mode=drop"
        history = {}
        for label, net, flt, policy in (
                ("port", network, faults, RetryPolicy),
                ("ref", jnetwork, jfaults, JRetryPolicy)):
            svc = net.BasicService("svc", key)
            try:
                client = net.BasicClient(
                    "svc", [("127.0.0.1", svc.port)], key,
                    retry_policy=policy(attempts=4, base_delay_s=0.001,
                                        max_delay_s=0.002))
                with flt.inject(spec):
                    for req in (net.PingRequest(), net.MetricsRequest(),
                                net.TraceRequest(), net.PingRequest()):
                        client.request(req)
                    history[label] = [tuple(h) for h in flt.history()]
            finally:
                svc.shutdown()
        assert history["port"] == history["ref"]
        assert len(history["port"]) >= 1
        assert all(h[0] == "rpc" for h in history["port"])


class TestSafeShellExec:
    def test_exit_code(self):
        assert execute([sys.executable, "-c",
                        "import sys; sys.exit(3)"]) == 3

    def test_timeout_kills_group(self):
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            execute([sys.executable, "-c", "import time; time.sleep(60)"],
                    timeout_s=1.0)
        assert time.monotonic() - t0 < 30

    def test_cancellation_event(self):
        ev = threading.Event()
        threading.Timer(0.5, ev.set).start()
        rc = execute([sys.executable, "-c", "import time; time.sleep(60)"],
                     events=[ev])
        assert rc != 0
