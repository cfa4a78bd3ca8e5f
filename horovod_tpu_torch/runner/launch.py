"""The process launcher: ``python -m horovod_tpu_torch.runner -np N cmd``.

Counterpart of ``horovod_tpu/runner/launch.py`` (Horovod's
``horovodrun``): the same flags with the same defaults (abbreviations
refused), ``--hostfile`` in both of its formats, ``--config-file`` (a
flat YAML mapping; the command line wins) and ``--check-build``.

Each local worker gets the variables :func:`horovod_tpu_torch.init`
reads, torchrun's: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``GROUP_RANK``, ``GROUP_WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT`` (the reference's
``HVD_TPU_COORDINATOR_ADDR``/``_NUM_PROCESSES``/``_PROCESS_ID`` are the
JAX coordination service's), and the launch's HMAC key
(``HVD_TPU_SECRET_KEY``, :mod:`.common.secret`) for the control-plane
RPC.  The knob flags (``--timeline-filename``, the stall, autotune and
fusion knobs, ``--log-level`` ...) reach the workers through their
``env=``, never through this process's ``os.environ``.

:func:`run` kills the job at the first failure and honours
``--start-timeout`` (rank 0's rendezvous store must be up by then);
``--output-filename DIR`` writes ``DIR/rank.<r>.{stdout,stderr}``;
:func:`run_elastic` restarts the world over ``elastic/driver.py``.
A host list that names another host raises ``NotImplementedError``: the
multi-host launch (task agents, ssh, LSF) is not ported yet.
"""

from __future__ import annotations

import argparse
import os
import re
import signal
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

from .common.secret import SECRET_ENV, make_secret_key

MULTI_HOST = ("the multi-host launch (task agents, ssh, LSF: ROADMAP "
              "queue A item 3b) is not ported to horovod_tpu_torch yet; "
              "run one launcher a host with torchrun's variables")


def _free_port() -> int:
    from .common.network import free_port

    return free_port("127.0.0.1")


def is_local_host(host: str) -> bool:
    """This machine, for every launch path."""
    return host in ("localhost", "127.0.0.1", socket.gethostname())


def parse_hosts(spec: str) -> List[Tuple[str, int]]:
    """``"a:2,b:4"`` -> ``[("a", 2), ("b", 4)]`` (the reference's -H
    syntax; a bare host means one slot)."""
    out: List[Tuple[str, int]] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        host, _, slots = part.partition(":")
        if not host:
            raise ValueError(f"bad -H entry: {part!r}")
        out.append((host, int(slots) if slots else 1))
    return out


def parse_hostfile(path: str) -> str:
    """A hostfile as a ``-H`` spec: the reference horovodrun format
    (``host slots=N``, ``#`` comments) or ``host:N``; a bare host is one
    slot.  A malformed line raises naming its number."""
    entries = []
    with open(path) as f:
        for lineno, raw in enumerate(f, 1):
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            m = re.fullmatch(r"(\S+)\s+slots\s*=\s*(\d+)", line)
            if m:
                entries.append(f"{m.group(1)}:{int(m.group(2))}")
                continue
            m = re.fullmatch(r"([A-Za-z0-9._-]+)(?::(\d+))?", line)
            if m:
                entries.append(f"{m.group(1)}:{int(m.group(2) or 1)}")
                continue
            raise ValueError(f"line {lineno}: bad entry {raw.rstrip()!r} "
                             "(expected 'host slots=N' or 'host[:N]')")
    if not entries:
        raise ValueError("no host entries found")
    return ",".join(entries)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="horovodtpurun-torch",
        description="Launch a horovod_tpu_torch program (reference CLI: "
                    "horovodrun)",
        # No prefix matching: an abbreviated flag must be an error, since
        # the config file's command-line-wins scan matches full option
        # strings only.
        allow_abbrev=False,
    )
    parser.add_argument("-np", "--num-proc", type=int, default=None,
                        help="number of worker processes (default: 1)")
    parser.add_argument("-H", "--hosts", default=None,
                        help="host:slots[,host:slots...]; only this host's "
                             "names are launched here")
    parser.add_argument("--hostfile", default=None,
                        help="one host a line, 'host slots=N' or "
                             "'host:N'; excludes -H")
    parser.add_argument("--check-build", action="store_true",
                        help="print the feature matrix and exit")
    parser.add_argument("--min-np", type=int, default=None,
                        help="elastic: minimum world size")
    parser.add_argument("--max-np", type=int, default=None,
                        help="elastic: maximum world size")
    parser.add_argument("--host-discovery-script", default=None,
                        help="elastic: script printing host:slots a line")
    parser.add_argument("--reset-limit", type=int, default=0,
                        help="elastic: most world restarts (0 = no limit)")
    parser.add_argument("--blacklist-after", type=int, default=0,
                        help="elastic: blacklist a host after this many "
                             "failures (0 = never)")
    parser.add_argument("--output-filename", default=None,
                        help="write each worker's output to "
                             "<dir>/rank.<N>.{stdout,stderr}")
    parser.add_argument("--ssh-port", type=int, default=None,
                        help="ssh port of the multi-host launch")
    parser.add_argument("--ssh-identity-file", default=None,
                        help="ssh identity file of the multi-host launch")
    parser.add_argument("--network-interfaces", default=None,
                        help="comma-separated NICs the RPC services "
                             "advertise (default: all)")
    parser.add_argument("--coordinator", default=None,
                        help="MASTER_ADDR:MASTER_PORT of the rendezvous "
                             "(default: 127.0.0.1:<a free port>)")
    parser.add_argument("--start-timeout", type=float, default=120.0)
    parser.add_argument("--log-level", default=None, type=str.lower,
                        choices=["trace", "debug", "info", "warning",
                                 "error", "fatal"],
                        help="sets HOROVOD_LOG_LEVEL for every worker")
    parser.add_argument("--timeline-filename", default=None,
                        help="write a Chrome-trace timeline (sets "
                             "HOROVOD_TIMELINE); rank 0 writes this path, "
                             "rank r <path>.rank<r>")
    parser.add_argument("--timeline-mark-cycles", action="store_true",
                        help="mark cycles in the timeline (sets "
                             "HOROVOD_TIMELINE_MARK_CYCLES)")
    parser.add_argument("--autotune", action="store_true",
                        help="online autotuning in every worker (sets "
                             "HOROVOD_AUTOTUNE=1)")
    parser.add_argument("--autotune-log-file", default=None,
                        help="JSON lines of autotune samples (sets "
                             "HOROVOD_AUTOTUNE_LOG)")
    parser.add_argument("--fusion-threshold-mb", type=int, default=None,
                        help="fusion bucket size in MB (sets "
                             "HOROVOD_FUSION_THRESHOLD in bytes)")
    parser.add_argument("--cycle-time-ms", type=float, default=None,
                        help="sets HOROVOD_CYCLE_TIME, a no-op here "
                             "(workers warn)")
    parser.add_argument("--cache-capacity", type=int, default=None,
                        help="sets HOROVOD_CACHE_CAPACITY, a no-op here "
                             "(workers warn)")
    parser.add_argument("--hierarchical-allreduce", action="store_true",
                        help="two-level allreduce (sets "
                             "HOROVOD_HIERARCHICAL_ALLREDUCE=1)")
    parser.add_argument("--hierarchical-allgather", action="store_true",
                        help="sets HOROVOD_HIERARCHICAL_ALLGATHER, a no-op "
                             "here (workers warn)")
    parser.add_argument("--no-stall-check", action="store_true",
                        help="disable the stall inspectors (sets "
                             "HOROVOD_STALL_CHECK_DISABLE=1)")
    parser.add_argument("--stall-check-warning-time-seconds", type=float,
                        default=None,
                        help="sets HOROVOD_STALL_CHECK_TIME_SECONDS")
    parser.add_argument("--stall-check-shutdown-time-seconds", type=float,
                        default=None,
                        help="sets HOROVOD_STALL_SHUTDOWN_TIME_SECONDS")
    parser.add_argument("--config-file", default=None,
                        help="YAML mapping of long option names (with or "
                             "without dashes, '-' or '_') to values; the "
                             "command line wins")
    parser.add_argument("--verbose", action="store_true")
    from ..version import __version__

    parser.add_argument("--version", action="version",
                        version=f"horovod-tpu-torch {__version__}",
                        help="print the version and exit")
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="program and arguments (python train.py)")
    args = parser.parse_args(argv)
    if args.config_file:
        _apply_config_file(parser, args, argv)
    return args


_BOOL_WORDS = {"1": True, "true": True, "yes": True, "on": True,
               "0": False, "false": False, "no": False, "off": False,
               "": False}


def _apply_config_file(parser: argparse.ArgumentParser,
                       args: argparse.Namespace,
                       argv: Optional[List[str]]) -> None:
    """Fill parameters from ``--config-file``.  A flag given on the
    command line wins (found by scanning the launcher's own tokens; the
    command's are excluded); file values pass the command line's type
    and choices checks."""
    try:
        import yaml
    except ImportError:
        raise SystemExit(
            "--config-file requires pyyaml, which is not installed "
            "(`pip install pyyaml`)")

    with open(args.config_file) as f:
        data = yaml.safe_load(f) or {}
    if not isinstance(data, dict):
        raise SystemExit(f"--config-file {args.config_file}: expected a "
                         "flat YAML mapping, got "
                         f"{type(data).__name__}")
    tokens = sys.argv[1:] if argv is None else list(argv)
    tokens = tokens[:len(tokens) - len(args.command)]  # REMAINDER is the tail
    given = set()
    for act in parser._actions:
        for opt in act.option_strings:
            if opt in tokens or any(t.startswith(opt + "=") for t in tokens):
                given.add(act.dest)
    actions = {a.dest: a for a in parser._actions
               if a.default is not argparse.SUPPRESS}  # not -h/--help
    for key, value in data.items():
        dest = str(key).lstrip("-").replace("-", "_")
        if dest in ("config_file", "command") or dest not in actions:
            raise SystemExit(f"--config-file {args.config_file}: unknown "
                             f"parameter {key!r}")
        act = actions[dest]
        if isinstance(act, argparse._StoreTrueAction):
            if not isinstance(value, bool):
                try:
                    value = _BOOL_WORDS[str(value).strip().lower()]
                except KeyError:
                    raise SystemExit(
                        f"--config-file {args.config_file}: bad value "
                        f"{value!r} for boolean {key!r}")
        elif act.type is not None and value is not None:
            try:
                value = act.type(value)
            except (TypeError, ValueError):
                raise SystemExit(
                    f"--config-file {args.config_file}: bad value "
                    f"{value!r} for {key!r}")
        if act.choices is not None and value not in act.choices:
            raise SystemExit(
                f"--config-file {args.config_file}: {key!r} must be one "
                f"of {sorted(act.choices)}, got {value!r}")
        if dest not in given:  # the command line wins
            setattr(args, dest, value)


def worker_env(rank: int, np_: int, coordinator: str,
               base: Dict[str, str]) -> Dict[str, str]:
    """``base`` plus what rank ``rank`` of a local world of ``np_`` needs:
    torchrun's variables over the rendezvous at ``coordinator``
    (``host:port``)."""
    host, _, port = coordinator.rpartition(":")
    env = dict(base)
    env.update(RANK=str(rank), WORLD_SIZE=str(np_), LOCAL_RANK=str(rank),
               LOCAL_WORLD_SIZE=str(np_), GROUP_RANK="0",
               GROUP_WORLD_SIZE="1", MASTER_ADDR=host or "127.0.0.1",
               MASTER_PORT=port)
    return env


def _spawn_world(np_: int, command: List[str], coordinator: str,
                 env: Optional[Dict[str, str]], verbose: bool,
                 output_dir: Optional[str] = None,
                 output_append: bool = False) -> List[subprocess.Popen]:
    base_env = dict(os.environ)
    if env:
        base_env.update(env)
    if not base_env.get(SECRET_ENV):
        base_env[SECRET_ENV] = make_secret_key().decode()
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
    procs: List[subprocess.Popen] = []
    for rank in range(np_):
        child_env = worker_env(rank, np_, coordinator, base_env)
        if verbose:
            print(f"[horovodtpurun-torch] spawning rank {rank}: "
                  f"{' '.join(command)}", file=sys.stderr)
        if output_dir:
            # One file pair a rank, owned by this launch ("wb"); an
            # elastic restart within the launch appends.
            mode = "ab" if output_append else "wb"
            out = open(os.path.join(output_dir, f"rank.{rank}.stdout"), mode)
            err = open(os.path.join(output_dir, f"rank.{rank}.stderr"), mode)
            with out, err:
                procs.append(subprocess.Popen(command, env=child_env,
                                              stdout=out, stderr=err))
        else:
            procs.append(subprocess.Popen(command, env=child_env))
    return procs


def _terminate_all(procs: List[subprocess.Popen]) -> None:
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _none_started(coordinator: str) -> bool:
    """``--start-timeout``'s probe: rank 0's ``init`` binds the
    rendezvous store at ``MASTER_ADDR:MASTER_PORT``; if nothing listens
    there by the deadline, no worker reached ``init``."""
    host, _, port = coordinator.rpartition(":")
    try:
        with socket.create_connection((host or "127.0.0.1", int(port)),
                                      timeout=2.0):
            return False
    except OSError:
        return True


def run(np_: int, command: List[str], *, coordinator: Optional[str] = None,
        env: Optional[Dict[str, str]] = None,
        start_timeout: float = 120.0, verbose: bool = False,
        output_dir: Optional[str] = None) -> int:
    """Run ``np_`` local workers of one world; returns the first nonzero
    exit code (0 when all succeed).  The first failure terminates the
    others (the reference's gloo_run); a world whose rendezvous is not
    up after ``start_timeout`` seconds raises ``TimeoutError``."""
    if not command:
        raise ValueError("No command given")
    coordinator = coordinator or f"127.0.0.1:{_free_port()}"
    procs = _spawn_world(np_, command, coordinator, env, verbose,
                         output_dir=output_dir)
    exit_code = 0
    deadline = time.monotonic() + start_timeout
    started = np_ == 1   # nothing to wait for in a world of one
    last_probe = 0.0
    try:
        pending = set(range(np_))
        while pending:
            for i in list(pending):
                rc = procs[i].poll()
                if rc is not None:
                    pending.discard(i)
                    started = True
                    if rc != 0 and exit_code == 0:
                        exit_code = rc
                        for j in pending:   # the first failure ends the job
                            procs[j].terminate()
            if not pending:
                break
            time.sleep(0.1)
            now = time.monotonic()
            if not started and now > deadline and now - last_probe >= 2.0:
                last_probe = now
                if _none_started(coordinator):
                    raise TimeoutError("workers failed to start in time")
                started = True
    except KeyboardInterrupt:
        for p in procs:
            p.send_signal(signal.SIGINT)
        exit_code = 130
    finally:
        _terminate_all(procs)
    return exit_code


def run_elastic(command: List[str], *, min_np: int = 1,
                max_np: Optional[int] = None,
                discovery_script: Optional[str] = None,
                discovery=None,
                env: Optional[Dict[str, str]] = None,
                start_timeout: float = 120.0,
                poll_interval_s: float = 1.0,
                reset_limit: int = 0,
                blacklist_after: int = 0,
                verbose: bool = False,
                output_dir: Optional[str] = None) -> int:
    """Elastic supervision of local worlds (reference: ``horovodrun
    --host-discovery-script`` over the ``ElasticDriver``): poll
    discovery, run a world sized to the slots, and on a membership
    change or a worker failure tear it down and start it again at the
    new size (the workers recover through ``hvd.elastic``).  Returns 0
    when a world finishes on every worker; 1 after ``reset_limit``
    failed restarts (0 = no limit).  ``blacklist_after`` is off by
    default: a local supervisor cannot pin a failure on one host."""
    from ..elastic.driver import ElasticDriver, ScriptDiscovery

    if discovery is None:
        if not discovery_script:
            raise ValueError("need discovery_script or a discovery object")
        discovery = ScriptDiscovery(discovery_script)
    driver = ElasticDriver(
        discovery, poll_interval_s=poll_interval_s,
        blacklist_after=(blacklist_after if blacklist_after > 0
                         else (1 << 30)))
    try:
        driver.wait_for_available_slots(min_np, timeout_s=start_timeout)
    except TimeoutError as e:
        print(f"[horovodtpurun-torch] {e}", file=sys.stderr)
        return 1

    resets = 0
    while True:
        np_ = driver.world_size()
        if max_np is not None:
            np_ = min(np_, max_np)
        if np_ < min_np:
            print(f"[horovodtpurun-torch] only {np_} slots available "
                  f"(< --min-np {min_np}); waiting", file=sys.stderr)
            try:
                driver.wait_for_available_slots(min_np,
                                                timeout_s=start_timeout)
                continue
            except TimeoutError:
                return 1
        coordinator = f"127.0.0.1:{_free_port()}"
        if verbose:
            print(f"[horovodtpurun-torch] elastic world of {np_} starting",
                  file=sys.stderr)
        procs = _spawn_world(np_, command, coordinator, env, verbose,
                             output_dir=output_dir,
                             output_append=resets > 0)
        hosts_this_world = sorted(driver.hosts)
        try:
            while True:
                # Exit codes first: a finished world is not restarted by
                # a late membership change.
                rcs = [p.poll() for p in procs]
                if all(rc == 0 for rc in rcs):
                    for host in hosts_this_world:
                        driver.record_success(host)
                    return 0
                if any(rc is not None and rc != 0 for rc in rcs):
                    for host in hosts_this_world:
                        driver.record_failure(host)
                    _terminate_all(procs)
                    break
                try:
                    changed = driver.poll_once()
                except Exception as e:
                    # A flaky discovery script must not orphan the world.
                    print(f"[horovodtpurun-torch] discovery poll failed "
                          f"({e}); retrying", file=sys.stderr)
                    changed = False
                if changed:
                    if verbose:
                        print("[horovodtpurun-torch] membership changed; "
                              "restarting world", file=sys.stderr)
                    _terminate_all(procs)
                    break
                time.sleep(poll_interval_s)
        except BaseException:
            _terminate_all(procs)   # never leak a live world
            raise
        resets += 1
        if reset_limit and resets > reset_limit:
            print(f"[horovodtpurun-torch] reset limit ({reset_limit}) "
                  f"exceeded", file=sys.stderr)
            return 1


def _knob_env(args: argparse.Namespace) -> Dict[str, str]:
    """The knob flags as the workers' environment variables."""
    env = {}
    if args.log_level:
        env["HOROVOD_LOG_LEVEL"] = args.log_level
    if args.timeline_filename:
        env["HOROVOD_TIMELINE"] = args.timeline_filename
    if args.timeline_mark_cycles:
        env["HOROVOD_TIMELINE_MARK_CYCLES"] = "1"
    if args.autotune:
        env["HOROVOD_AUTOTUNE"] = "1"
    if args.autotune_log_file:
        env["HOROVOD_AUTOTUNE_LOG"] = args.autotune_log_file
    if args.fusion_threshold_mb is not None:
        env["HOROVOD_FUSION_THRESHOLD"] = str(
            args.fusion_threshold_mb * 1024 * 1024)
    if args.cycle_time_ms is not None:
        env["HOROVOD_CYCLE_TIME"] = str(args.cycle_time_ms)
    if args.cache_capacity is not None:
        env["HOROVOD_CACHE_CAPACITY"] = str(args.cache_capacity)
    if args.hierarchical_allreduce:
        env["HOROVOD_HIERARCHICAL_ALLREDUCE"] = "1"
    if args.hierarchical_allgather:
        env["HOROVOD_HIERARCHICAL_ALLGATHER"] = "1"
    if args.no_stall_check:
        env["HOROVOD_STALL_CHECK_DISABLE"] = "1"
    if args.stall_check_warning_time_seconds is not None:
        env["HOROVOD_STALL_CHECK_TIME_SECONDS"] = str(
            args.stall_check_warning_time_seconds)
    if args.stall_check_shutdown_time_seconds is not None:
        env["HOROVOD_STALL_SHUTDOWN_TIME_SECONDS"] = str(
            args.stall_check_shutdown_time_seconds)
    return env


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    if args.check_build:
        from .check_build import check_build_str

        print(check_build_str())
        return 0
    command = args.command
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        print("error: no command to run (usage: python -m "
              "horovod_tpu_torch.runner -np 4 python train.py)",
              file=sys.stderr)
        return 2
    # Through env=, never os.environ: a rejected invocation must not
    # change a programmatic caller's process.
    extra_env = _knob_env(args)
    if args.hostfile:
        if args.hosts:
            print("error: -H and --hostfile are mutually exclusive",
                  file=sys.stderr)
            return 2
        try:
            args.hosts = parse_hostfile(args.hostfile)
        except (OSError, ValueError) as e:
            print(f"error: --hostfile: {e}", file=sys.stderr)
            return 2
    num_proc = args.num_proc if args.num_proc is not None else 1
    if args.hosts:
        try:
            hosts = parse_hosts(args.hosts)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        remote = [h for h, _ in hosts if not is_local_host(h)]
        if remote:
            raise NotImplementedError(f"-H/--hostfile names {remote}: "
                                      f"{MULTI_HOST}")
        # Local slots are the world's size (`-H localhost:8` runs 8); an
        # explicit -np must fit them.
        total_slots = sum(s for _, s in hosts)
        if args.num_proc is None:
            num_proc = total_slots
        elif num_proc > total_slots:
            print(f"error: -np {num_proc} exceeds the {total_slots} "
                  f"slot(s) declared in -H/--hostfile", file=sys.stderr)
            return 2
    if args.min_np is not None and num_proc < args.min_np:
        print(f"error: -np {num_proc} < --min-np {args.min_np}",
              file=sys.stderr)
        return 2
    if args.host_discovery_script:
        # -np is the target size, bounded by --min-np/--max-np.
        return run_elastic(
            command, min_np=args.min_np or num_proc,
            max_np=args.max_np or num_proc,
            discovery_script=args.host_discovery_script,
            start_timeout=args.start_timeout,
            reset_limit=args.reset_limit,
            blacklist_after=args.blacklist_after,
            verbose=args.verbose,
            env=extra_env,
            output_dir=args.output_filename)
    return run(num_proc, command, coordinator=args.coordinator,
               env=extra_env, start_timeout=args.start_timeout,
               verbose=args.verbose, output_dir=args.output_filename)


if __name__ == "__main__":
    sys.exit(main())
