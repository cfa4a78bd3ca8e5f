"""The port's fault injection (``horovod_tpu_torch/faults.py``), its
spec grammar and knobs (``config.py``), the shared retry helper
(``utils/retry.py``) and the fault sites threaded through the ported
layers, against the reference's (``horovod_tpu/faults.py``,
``tests/test_faults.py``).

Parity cases feed the same specs and the same event sequences to both
packages: equal clauses and errors, equal firing indices and histories
under seeded plans, equal retry attempts and sleeps under a seeded
jitter, equal flight-dump ``fault_spec`` and ``fault_history``.  The
site cases run the port's layers in a world of one on the CPU: the armed
site raises ``HorovodInternalError`` and the disarmed path runs clean.
The ``dcn`` site needs two tiers and is held in
``tests/test_torch_port_topo.py``; the elastic recovery drill on two
ranks in ``tests/test_torch_port_elastic.py``.
"""

import dataclasses
import json
import random
import subprocess
import time

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import faults
from horovod_tpu_torch.config import Config, parse_fault_spec
from horovod_tpu_torch.elastic import HorovodInternalError
from horovod_tpu_torch.utils.retry import RetryPolicy, jittered, retry_call

from horovod_tpu import faults as jfaults
from horovod_tpu.config import Config as JConfig
from horovod_tpu.config import parse_fault_spec as jparse_fault_spec
from horovod_tpu.elastic import HorovodInternalError as JHorovodInternalError
from horovod_tpu.utils import retry as jretry


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    """Every test starts and ends with no armed plan, in both packages."""
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


@pytest.fixture
def session():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


# --- the grammar and the knobs ------------------------------------------------

SPECS = [
    "collective:step=40;discovery:flap=0.2,seed=7",
    "rpc:p=0.5,seed=3,times=2,mode=delay,delay_ms=250",
    "checkpoint:step=4,mode=corrupt;dcn:p=0.25,seed=9,mode=partition",
    "accumulate:step=2;fusion:step=0",
    "serve:step=3,mode=migrate-delay,delay_ms=5;swap:p=1.0,mode=stall",
    "qos:step=1,mode=invert;collect:p=0.5,mode=garbage;control:step=0,"
    "mode=convoy",
]
BAD = [
    "warp:step=1",                    # unknown site
    "collective:steps=1",             # unknown key
    "collective:step=x",              # unparseable value
    "collective:mode=raise",          # no trigger
    "rpc:step=1,mode=corrupt",        # mode of another site
    "discovery:flap=1.5",             # probability out of range
    "collective:step=1;collective:step=2",  # duplicate clause
    "collective:step",                # not key=value
    "control:step=1",                 # control needs a mode
]


@pytest.mark.parametrize("spec", SPECS)
def test_specs_parse_to_the_reference_clauses(spec):
    got = {k: dataclasses.asdict(v) for k, v in parse_fault_spec(spec).items()}
    ref = {k: dataclasses.asdict(v) for k, v in
           jparse_fault_spec(spec).items()}
    assert got == ref


@pytest.mark.parametrize("bad", BAD)
def test_malformed_specs_raise_the_reference_error(bad):
    with pytest.raises(ValueError) as port:
        parse_fault_spec(bad)
    with pytest.raises(ValueError) as ref:
        jparse_fault_spec(bad)
    assert str(port.value) == str(ref.value)


KNOBS = ("fault_spec", "elastic_timeout_seconds", "reset_limit",
         "reset_backoff_seconds", "reset_backoff_max_seconds",
         "blacklist_decay_seconds", "discovery_failure_threshold",
         "rpc_retries", "rpc_backoff_seconds", "checkpoint_digest",
         "ckpt_async", "ckpt_inflight")


@pytest.mark.parametrize("env", [
    {},
    {"HVD_TPU_FAULT_SPEC": "collective:step=3",
     "HOROVOD_ELASTIC_TIMEOUT": "12.5", "HOROVOD_ELASTIC_RESET_LIMIT": "4",
     "HVD_TPU_RESET_BACKOFF": "0.1", "HVD_TPU_RESET_BACKOFF_MAX": "2",
     "HVD_TPU_BLACKLIST_DECAY": "0", "HVD_TPU_DISCOVERY_FAILURES": "5",
     "HVD_TPU_RPC_RETRIES": "7", "HVD_TPU_RPC_BACKOFF": "0.05",
     "HVD_TPU_CHECKPOINT_DIGEST": "0", "HVD_TPU_CKPT_ASYNC": "false",
     "HVD_TPU_CKPT_INFLIGHT": "5"},
    {"HVD_TPU_FAULT_SPEC": "  "},
])
def test_knobs_parse_to_the_reference_values(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got, ref = Config.from_env(), JConfig.from_env()
    assert {k: getattr(got, k) for k in KNOBS} == \
        {k: getattr(ref, k) for k in KNOBS}


@pytest.mark.parametrize("env", [{"HVD_TPU_FAULT_SPEC": "nonsense:p=1"},
                                 {"HVD_TPU_CKPT_INFLIGHT": "0"},
                                 {"HVD_TPU_RPC_RETRIES": "x"}])
def test_malformed_knobs_fail_as_the_reference(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError):
        Config.from_env()
    with pytest.raises(ValueError):
        JConfig.from_env()


def test_malformed_spec_fails_at_init(monkeypatch):
    monkeypatch.setenv("HVD_TPU_FAULT_SPEC", "collective:steps=1")
    with pytest.raises(ValueError, match="unknown key"):
        hvd.init(device="cpu")
    assert not hvd.is_initialized()


# --- determinism: the same plan fires at the same events in both packages -----

def _drive_collective(pkg, error, spec, n=200):
    fired = []
    with pkg.inject(spec):
        for i in range(n):
            try:
                pkg.on_collective(f"op{i}")
            except error:
                fired.append(i)
        hist = pkg.history()
    return fired, hist


@pytest.mark.parametrize("spec", [
    "collective:p=0.1,seed=13,times=1000", "collective:p=0.1,seed=2,times=5",
    "collective:step=7", "collective:p=1.0,times=3,seed=0",
    "collective:step=150,p=0.02,seed=4"])
def test_seeded_plans_fire_at_the_reference_indices(spec):
    port = _drive_collective(faults, HorovodInternalError, spec)
    ref = _drive_collective(jfaults, JHorovodInternalError, spec)
    assert port == ref
    assert port == _drive_collective(faults, HorovodInternalError, spec)


def test_step_fires_exactly_once_at_index():
    fired, hist = _drive_collective(faults, HorovodInternalError,
                                    "collective:step=7")
    assert fired == [7]
    assert hist == [("collective", 7, "raise:op7")]


@pytest.mark.parametrize("spec", ["discovery:flap=0.5,seed=42",
                                  "discovery:flap=0.3,seed=1,times=4"])
def test_flap_sequences_equal_the_reference(spec):
    hosts = {f"h{i}": 2 for i in range(8)}

    def drive(pkg):
        seq = []
        with pkg.inject(spec):
            for _ in range(20):
                seq.append(sorted(pkg.on_discovery_hosts(dict(hosts))))
            return seq, pkg.history()

    assert drive(faults) == drive(jfaults)
    assert any(len(s) < 8 for s in drive(faults)[0])


@pytest.mark.parametrize("spec,steps", [
    ("checkpoint:step=4,mode=corrupt", [2, 4, 6, 4]),
    ("checkpoint:p=0.5,seed=3,mode=partial", list(range(12))),
    ("dcn:p=0.5,seed=42,times=3", None),
])
def test_other_sites_fire_at_the_reference_events(spec, steps):
    def drive(pkg, error):
        out = []
        with pkg.inject(spec):
            for i in range(12):
                if steps is not None:
                    out.append(pkg.on_checkpoint_save(steps[i % len(steps)]))
                    continue
                try:
                    pkg.on_dcn("xpod")
                    out.append(None)
                except error as e:
                    out.append(str(e))
            return out, pkg.history()

    assert drive(faults, HorovodInternalError) == \
        drive(jfaults, JHorovodInternalError)


def test_flight_dump_carries_the_reference_spec_and_history(tmp_path,
                                                           monkeypatch):
    """The dump written at a site's first firing names the armed spec and
    carries the firing history, as the reference's does."""
    from horovod_tpu.obs import flight as jflight
    from horovod_tpu_torch.obs import flight

    spec = "collective:step=3;fusion:step=1"
    docs = []
    for pkg, fl, error, tag in ((jfaults, jflight, JHorovodInternalError,
                                 "j"),
                                (faults, flight, HorovodInternalError, "t")):
        fl.reset_for_tests()
        fl.configure(enabled=True, directory=str(tmp_path / tag))
        with pkg.inject(spec):
            for i in range(5):
                for hook in (pkg.on_collective, pkg.on_fusion):
                    try:
                        hook(f"e{i}")
                    except error:
                        pass
            path = fl.dump("test")
        with open(path) as f:
            doc = json.load(f)
        docs.append((doc["fault_spec"], doc["fault_history"],
                     [e["kind"] for e in doc["events"]]))
        fl.reset_for_tests()
    assert docs[1] == docs[0]
    assert docs[1][0] == spec and len(docs[1][1]) == 2


# --- no-op when disarmed ----------------------------------------------------------

def test_hooks_are_noops():
    assert faults._active is None
    faults.on_collective("x")
    faults.on_fusion()
    faults.on_accumulate(0)
    faults.on_dcn("xpod")
    faults.on_rpc("y")
    assert faults.on_checkpoint_save(3) is None
    assert faults.on_discovery_hosts({"a": 1}) == {"a": 1}
    assert faults.on_serve_request() is None
    assert faults.on_serve_decode() is False
    assert faults.on_swap_pull() is None
    assert faults.on_qos_pick() is False
    assert faults.on_collect("r0") is None
    assert faults.on_control("spiral") is False
    assert faults.history() == []
    assert faults.active_spec() is None


def test_inject_restores_previous_plan():
    with faults.inject("collective:step=1000"):
        outer = faults.active_spec()
        with faults.inject("rpc:step=0"):
            assert faults.active_spec() == "rpc:step=0"
        assert faults.active_spec() == outer
    assert faults.active_spec() is None


def test_serve_swap_qos_collect_control_hooks_fire_as_the_reference():
    """The hooks whose callers are not ported yet: the same spec and event
    sequence give the same returns and history in both packages."""
    spec = ("serve:step=2,mode=kill;swap:step=1,mode=corrupt-shard;"
            "qos:step=0,mode=flood;collect:step=1,mode=garbage;"
            "control:step=2,mode=spiral")

    def drive(pkg):
        out = []
        with pkg.inject(spec):
            for _ in range(4):
                out.append((pkg.on_serve_request("r"), pkg.on_serve_decode(),
                            pkg.on_serve_evict(), pkg.on_serve_migrate(),
                            pkg.on_swap_pull(), pkg.on_swap_flip(),
                            pkg.on_swap_roll(), pkg.on_qos_pick(),
                            pkg.on_qos_admit(), pkg.on_collect("t"),
                            pkg.on_control("spiral"),
                            pkg.on_control("convoy")))
            return out, pkg.history()

    assert drive(faults) == drive(jfaults)


# --- the sites in the ported layers -----------------------------------------------

def test_collective_site_raises_at_its_dispatch(session):
    x = torch.ones(4)
    with faults.inject("collective:step=2"):
        hvd.allreduce(x)   # dispatch 0
        hvd.allreduce(x)   # dispatch 1
        with pytest.raises(HorovodInternalError, match="injected"):
            hvd.allreduce(x)  # dispatch 2 fires
        out = hvd.allreduce(x, op=hvd.Sum)   # one-shot: the retry runs
        assert faults.history() == [("collective", 2, "raise:allreduce")]
    assert torch.equal(out, x)


def test_collective_site_fires_with_the_metrics_off(session):
    from horovod_tpu_torch.obs import metrics

    was = metrics.enabled()
    metrics.configure(enabled=False)
    try:
        with faults.inject("collective:step=0"):
            with pytest.raises(HorovodInternalError):
                hvd.broadcast(torch.ones(2), root_rank=0)
    finally:
        metrics.configure(enabled=was)


def test_every_collective_entry_point_ticks_the_site(session):
    x = torch.ones(4)
    calls = [lambda: hvd.allreduce(x), lambda: hvd.grouped_allreduce([x]),
             lambda: hvd.allgather(x), lambda: hvd.broadcast(x, 0),
             lambda: hvd.alltoall(x), lambda: hvd.reducescatter(x),
             lambda: hvd.grouped_reducescatter([x])]
    with faults.inject("collective:p=1.0,seed=0,times=1000"):
        for call in calls:
            with pytest.raises(HorovodInternalError):
                call()
        assert len(faults.history()) == len(calls)
    for call in calls:
        call()


def test_elastic_run_recovers_from_injected_fault(session, monkeypatch):
    from horovod_tpu_torch.elastic import ObjectState, run
    from horovod_tpu_torch.elastic import state as state_mod

    sleeps = []
    monkeypatch.setattr(state_mod.time, "sleep", lambda s: sleeps.append(s))
    state = ObjectState(step=0, total=0.0)
    x = torch.ones(2)

    @run
    def train(state):
        while state.step < 4:
            out = hvd.allreduce(x, op=hvd.Sum, name="train_ar")
            state.total += float(out[0])
            state.step += 1
            state.commit()
        return state.total

    with faults.inject("collective:step=2"):
        total = train(state)
        assert [h[0] for h in faults.history()] == ["collective"]
    assert total == 4.0 * hvd.size()
    assert sleeps and all(s > 0 for s in sleeps)   # backoff happened
    assert hvd.is_initialized() and hvd.device() == torch.device("cpu")


def test_elastic_reinit_preserves_armed_plan(monkeypatch):
    """shutdown + init with the same env spec (the recovery path) keeps
    the live plan: counters and history span the process."""
    monkeypatch.setenv("HVD_TPU_FAULT_SPEC", "collective:step=1000")
    faults.configure("collective:step=1000")
    plan = faults._active
    faults.on_collective("tick")
    hvd.init(device="cpu")
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        assert faults._active is plan
        assert plan.site("collective").counter == 1
    finally:
        hvd.shutdown()


def test_fusion_site_fires_in_the_two_phase_apply(session):
    from horovod_tpu_torch.ops import fusion

    leaves = [torch.arange(6.0), torch.ones(3)]
    with faults.inject("fusion:step=0"):
        with pytest.raises(HorovodInternalError, match="fusion"):
            fusion.fused_two_phase_apply(leaves, op="average")
        assert faults.history() == [("fusion", 0, "raise:two_phase_apply")]
    out = fusion.fused_two_phase_apply(leaves, op="average")
    for a, b in zip(out, leaves):
        assert torch.equal(a, b)


def _mb_problem():
    x = np.random.RandomState(0).randn(64, 4).astype(np.float32)
    return x, x.sum(axis=1)


def _port_mb_step(microbatches=4):
    model = torch.nn.Linear(4, 1, bias=False)
    with torch.no_grad():
        model.weight.zero_()
    opt = torch.optim.SGD(model.parameters(), lr=0.1)

    def loss_fn(m, batch):
        x, y = batch
        return ((m(x)[:, 0] - y) ** 2).mean()

    x, y = _mb_problem()
    step = hvd.make_train_step(loss_fn, opt, microbatches=microbatches)
    return step, model, (torch.from_numpy(x), torch.from_numpy(y))


def test_accumulate_site_fires_at_the_build(session):
    step, model, batch = _port_mb_step()
    with faults.inject("accumulate:step=1"):
        with pytest.raises(HorovodInternalError, match="accumulate"):
            step(model, batch)
    step, model, batch = _port_mb_step()
    loss = step(model, batch)                   # disarmed: clean
    assert np.isfinite(float(loss))


@pytest.mark.parametrize("k", [1, 3, 5])
def test_accumulate_hits_the_reference_event_index(session, k):
    """``accumulate:step=k`` over two calls of a 4-microbatch step: the
    reference fires its 4 boundaries while the step is traced (once), the
    port at the build (the first call), so the same k fires at the same
    boundary of the first call, or (k >= 4) never, in both."""
    import jax.numpy as jnp
    import optax

    from horovod_tpu.optim import make_train_step as jmake_train_step

    def jloss(params, batch):
        x, y = batch
        return ((x @ params["w"] - y) ** 2).mean()

    x, y = _mb_problem()
    params = {"w": jnp.zeros((4,), jnp.float32)}
    tx = optax.sgd(0.1)
    jstep = jmake_train_step(jloss, tx, donate=False, microbatches=4)
    outcomes = []
    for pkg, error, run in (
            (jfaults, JHorovodInternalError,
             lambda: jstep(params, tx.init(params), (x, y))),
            (faults, HorovodInternalError, None)):
        if run is None:
            step, model, batch = _port_mb_step()
            run = lambda: step(model, batch)   # noqa: E731
        got = []
        with pkg.inject(f"accumulate:step={k}"):
            for _ in range(2):
                try:
                    run()
                    got.append("ran")
                except error:
                    got.append("raised")
            got.append(pkg.history())
        outcomes.append(got)
    assert outcomes[1] == outcomes[0]


@pytest.mark.parametrize("k", [1, 3, 5])
def test_accumulate_event_index_holds_with_the_metrics_off(session, k):
    """``HVD_TPU_METRICS=0`` leaves the build boundary in place: over two
    calls of a 4-microbatch step ``accumulate:step=k`` fires at the same
    boundary of the first call as with the metrics on, or never."""
    from horovod_tpu_torch.obs import metrics

    outcomes = []
    was = metrics.enabled()
    for on in (True, False):
        metrics.configure(enabled=on)
        try:
            step, model, batch = _port_mb_step()
            got = []
            with faults.inject(f"accumulate:step={k}"):
                for _ in range(2):
                    try:
                        step(model, batch)
                        got.append("ran")
                    except HorovodInternalError:
                        got.append("raised")
                got.append(faults.history())
        finally:
            metrics.configure(enabled=was)
        outcomes.append(got)
    assert outcomes[1] == outcomes[0]
    assert outcomes[0][:2] == (["raised", "ran"] if k < 4 else ["ran", "ran"])


def test_checkpoint_site_fires_in_both_tiers(tmp_path):
    from horovod_tpu_torch.checkpoint import Checkpointer
    from horovod_tpu_torch.ckpt import AsyncCheckpointer

    tree = {"w": np.arange(8.0, dtype=np.float32)}
    with faults.inject("checkpoint:step=2,mode=crash-before-rename"):
        ck = AsyncCheckpointer(str(tmp_path / "a"), async_save=False)
        ck.save(1, tree)
        with pytest.raises(HorovodInternalError, match="crash"):
            ck.save(2, tree)
        ck.close()
    with faults.inject("checkpoint:step=2,mode=corrupt"):
        with Checkpointer(str(tmp_path / "c"), async_save=False) as ck:
            ck.save(1, tree)
            ck.save(2, {"w": tree["w"] * 2})
            got = ck.restore()            # step 2 fails verification
        assert faults.history() == [("checkpoint", 2, "corrupt")]
    np.testing.assert_array_equal(np.asarray(got["w"]), tree["w"])
    with Checkpointer(str(tmp_path / "clean"), async_save=False) as ck:
        ck.save(2, tree)
        np.testing.assert_array_equal(np.asarray(ck.restore()["w"]),
                                      tree["w"])


class TestDiscoverySite:
    def _script_discovery(self, tmp_path, retries=1, backoff_s=0.0):
        from horovod_tpu_torch.elastic.driver import ScriptDiscovery

        script = tmp_path / "discover.sh"
        script.write_text("#!/bin/sh\necho hostA:2\necho hostB:2\n")
        script.chmod(0o755)
        return ScriptDiscovery(str(script), retries=retries,
                               backoff_s=backoff_s)

    def test_timeout_mode_raises_through_single_attempt(self, tmp_path):
        disc = self._script_discovery(tmp_path, retries=1)
        with faults.inject("discovery:step=0,mode=timeout"):
            with pytest.raises(subprocess.SubprocessError):
                disc.find_available_hosts_and_slots()

    def test_retry_helper_absorbs_one_shot_fault(self, tmp_path):
        disc = self._script_discovery(tmp_path, retries=3)
        with faults.inject("discovery:step=0,mode=error"):
            hosts = disc.find_available_hosts_and_slots()
        assert hosts == {"hostA": 2, "hostB": 2}

    def test_flap_drops_hosts_from_script(self, tmp_path):
        disc = self._script_discovery(tmp_path)
        with faults.inject("discovery:flap=1.0,seed=0"):
            assert disc.find_available_hosts_and_slots() == {}

    def test_flap_honors_times_cap(self, tmp_path):
        disc = self._script_discovery(tmp_path)
        with faults.inject("discovery:flap=1.0,seed=0,times=2"):
            assert disc.find_available_hosts_and_slots() == {}
            assert disc.find_available_hosts_and_slots() == {}
            # Budget exhausted: the host set comes back untouched.
            assert disc.find_available_hosts_and_slots() == \
                {"hostA": 2, "hostB": 2}



@pytest.mark.parametrize("seed", [0, 7, 123])
def test_retry_attempts_and_sleeps_equal_the_reference(seed):
    """The same flaky call under the same policy and a seeded jitter RNG:
    equal attempts, on_retry indices and sleeps in both packages."""
    def run(mod):
        calls, seen, slept = {"n": 0}, [], []

        def flaky():
            calls["n"] += 1
            if calls["n"] < 5:
                raise OSError(f"transient {calls['n']}")
            return calls["n"]

        out = mod.retry_call(
            flaky, policy=mod.RetryPolicy(attempts=6, base_delay_s=0.2,
                                          max_delay_s=1.0, jitter=0.5),
            retry_on=(OSError,), on_retry=lambda i, e: seen.append(i),
            sleep=slept.append, rng=random.Random(seed))
        return out, seen, slept

    assert run(__import__("horovod_tpu_torch.utils.retry",
                          fromlist=["retry_call"])) == run(jretry)
    rng_a, rng_b = random.Random(seed), random.Random(seed)
    assert [jittered(0.3 * i, 0.5, rng_a) for i in range(20)] == \
        [jretry.jittered(0.3 * i, 0.5, rng_b) for i in range(20)]


def test_retry_records_the_hook_and_the_flight_event():
    from horovod_tpu_torch.obs import flight

    flight.reset_for_tests()
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 2:
            raise OSError("x")
        return True

    retry_call(flaky, policy=RetryPolicy(attempts=3, base_delay_s=0.0),
               describe="probe", sleep=lambda s: None)
    events = [e for e in flight.events() if e["kind"] == "retry"]
    assert [(e["what"], e["attempt"]) for e in events] == [("probe", 1)]


class TestRetryHelper:
    def test_succeeds_after_transient_failures(self):
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise OSError("transient")
            return "ok"

        slept = []
        out = retry_call(flaky, policy=RetryPolicy(attempts=5,
                                                   base_delay_s=0.1),
                         retry_on=(OSError,), sleep=slept.append)
        assert out == "ok"
        assert calls["n"] == 3
        assert len(slept) == 2
        assert slept[1] > slept[0] * 0.5  # roughly exponential (jittered)

    def test_give_up_on_carves_out_deterministic_failures(self):
        calls = {"n": 0}

        def missing():
            calls["n"] += 1
            raise FileNotFoundError("gone")

        with pytest.raises(FileNotFoundError):
            retry_call(missing, policy=RetryPolicy(attempts=5,
                                                   base_delay_s=0.0),
                       retry_on=(OSError,), give_up_on=(FileNotFoundError,),
                       sleep=lambda s: None)
        assert calls["n"] == 1  # never retried

    def test_non_retryable_propagates_immediately(self):
        calls = {"n": 0}

        def bad():
            calls["n"] += 1
            raise ValueError("logic bug")

        with pytest.raises(ValueError):
            retry_call(bad, retry_on=(OSError,), sleep=lambda s: None)
        assert calls["n"] == 1

    def test_attempts_exhausted_reraises_last(self):
        calls = {"n": 0}

        def always():
            calls["n"] += 1
            raise OSError(f"fail {calls['n']}")

        with pytest.raises(OSError, match="fail 3"):
            retry_call(always, policy=RetryPolicy(attempts=3,
                                                  base_delay_s=0.0),
                       sleep=lambda s: None)
        assert calls["n"] == 3

    def test_deadline_bounds_wall_clock(self):
        def always():
            raise OSError("down")

        t0 = time.monotonic()
        with pytest.raises(OSError):
            retry_call(always,
                       policy=RetryPolicy(attempts=0, base_delay_s=0.01,
                                          max_delay_s=0.02, deadline_s=0.2))
        assert time.monotonic() - t0 < 2.0

    def test_unlimited_attempts_need_deadline_semantics(self):
        calls = {"n": 0}

        def eventually():
            calls["n"] += 1
            if calls["n"] < 10:
                raise OSError("x")
            return calls["n"]

        assert retry_call(eventually,
                          policy=RetryPolicy(attempts=0, base_delay_s=0.0),
                          sleep=lambda s: None) == 10

    def test_jitter_bounds(self):
        import random

        rng = random.Random(7)
        for _ in range(100):
            d = jittered(1.0, 0.5, rng)
            assert 0.5 <= d <= 1.5
        assert jittered(0.0) == 0.0
        assert jittered(2.0, 0.0) == 2.0

    def test_policy_delay_caps(self):
        p = RetryPolicy(base_delay_s=1.0, max_delay_s=4.0, jitter=0.0)
        assert [p.delay_s(i) for i in (1, 2, 3, 4)] == [1.0, 2.0, 4.0, 4.0]

    def test_on_retry_callback_sees_attempts(self):
        seen = []

        def flaky():
            if len(seen) < 2:
                raise OSError("x")
            return True

        retry_call(flaky, policy=RetryPolicy(attempts=5, base_delay_s=0.0),
                   on_retry=lambda i, e: seen.append(i),
                   sleep=lambda s: None)
        assert seen == [1, 2]
