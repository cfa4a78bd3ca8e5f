"""The port's elastic layer (``horovod_tpu_torch/elastic/``) against the
reference's (``horovod_tpu/elastic/``, ``tests/test_elastic.py``).

In-process (a world of one on the CPU): ``ObjectState``, ``TorchState``
commit and rollback, the ``run`` decorator, the discovery driver with
its blacklist decay and failure accounting, exception translation of
torch.distributed's failures, the reset backoff, and the sampler's index
streams and ``state_dict`` against the reference's.  On a 2-rank gloo
world (``tests/torch_port_workers.py``): the counterpart of
``tests/test_faults.py::TestChaosRecoverySingleController`` (the fault
fires once, two tries, the same sums, a re-init on the same device over
a new rendezvous), and ``TorchState.sync`` carrying rank 0's
error-feedback residual.
"""

import stat
import textwrap

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.elastic import (
    ElasticDriver, ElasticSampler, HorovodInternalError, ObjectState,
    ScriptDiscovery, TorchState, run,
)
from horovod_tpu_torch.elastic.driver import (
    FixedDiscovery, hosts_updated_interrupt_callback,
)
from horovod_tpu_torch.elastic.state import HostsUpdatedInterrupt

import torch_port_workers as workers

from horovod_tpu.elastic import ElasticSampler as JElasticSampler


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = workers.World(2, str(tmp_path_factory.mktemp("gloo") / "store"))
    yield w
    w.close()


@pytest.fixture
def session():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


class TestObjectState:
    def test_commit_restore(self):
        state = ObjectState(epoch=0, batch=0)
        state.epoch = 5
        state.commit()
        state.epoch = 9
        state.batch = 3
        state.restore()
        assert state.epoch == 5
        assert state.batch == 0

    def test_sync_single_process_is_identity(self, session):
        state = ObjectState(epoch=2)
        state.sync()
        assert state.epoch == 2


class TestTorchState:
    def test_module_and_optimizer_commit_restore(self):
        model = torch.nn.Linear(3, 2)
        opt = torch.optim.AdamW(model.parameters(), lr=0.1)
        state = TorchState(model=model, optimizer=opt, epoch=0)
        w0 = model.weight.detach().clone()
        model(torch.ones(1, 3)).sum().backward()
        opt.step()
        state.epoch = 4
        assert not torch.equal(model.weight, w0)
        state.restore()
        assert torch.equal(model.weight, w0)
        assert opt.state_dict()["state"] == {}
        assert state.epoch == 0

    def test_commit_updates_snapshot(self):
        model = torch.nn.Linear(2, 1, bias=False)
        state = TorchState(model=model)
        with torch.no_grad():
            model.weight.fill_(1.0)
        state.commit()
        with torch.no_grad():
            model.weight.fill_(9.0)
        state.restore()
        assert torch.equal(model.weight, torch.ones(1, 2))

    def test_bf16_module_restores_bitwise(self):
        model = torch.nn.Linear(4, 4).to(torch.bfloat16)
        state = TorchState(model=model)
        w0 = model.weight.detach().clone()
        with torch.no_grad():
            model.weight.mul_(3)
        state.restore()
        assert model.weight.dtype == torch.bfloat16
        assert torch.equal(model.weight, w0)


class TestRunDecorator:
    def test_retries_on_internal_error(self, session):
        state = ObjectState(step=0, completed=0)
        calls = {"n": 0}

        @run
        def train(state):
            calls["n"] += 1
            state.step += 1
            if calls["n"] < 3:
                raise HorovodInternalError("simulated collective failure")
            state.commit()
            return state.step

        assert train(state) == 1
        assert calls["n"] == 3

    def test_hosts_updated_interrupt_no_rollback(self, session):
        state = ObjectState(progress=0)
        calls = {"n": 0}

        @run
        def train(state):
            calls["n"] += 1
            state.progress += 10
            state.commit()
            if calls["n"] == 1:
                raise HostsUpdatedInterrupt("resize")
            return state.progress

        assert train(state) == 20
        assert calls["n"] == 2

    def test_reset_limit(self, session):
        cfg = hvd.config()
        object.__setattr__(cfg, "reset_limit", 2)
        try:
            state = ObjectState(x=0)

            @run
            def train(state):
                raise HorovodInternalError("always fails")

            with pytest.raises(RuntimeError, match="reset limit"):
                train(state)
        finally:
            object.__setattr__(hvd.config(), "reset_limit", 0)

    def test_reinit_keeps_device_and_backend(self, session):
        """A rollback re-inits on the session's own device and backend
        (``init()`` with no device would look for a card)."""
        seen = []
        state = ObjectState(step=0)

        @run
        def train(state):
            seen.append((str(hvd.device()), hvd.basics.backend()))
            if len(seen) == 1:
                raise HorovodInternalError("boom")
            return True

        assert train(state)
        assert seen == [("cpu", "gloo")] * 2


class TestElasticDriver:
    def test_fixed_discovery_delta_callbacks(self):
        disc = FixedDiscovery({"a": 4, "b": 4})
        driver = ElasticDriver(disc, poll_interval_s=0.01)
        events = []
        driver.register_hosts_updated_callback(
            lambda added, removed: events.append((sorted(added),
                                                  sorted(removed))))
        assert driver.poll_once()       # initial population
        assert driver.world_size() == 8
        disc.hosts["c"] = 4
        del disc.hosts["a"]
        assert driver.poll_once()
        assert events[-1] == (["c"], ["a"])
        assert driver.world_size() == 8

    def test_blacklist(self):
        disc = FixedDiscovery({"a": 1, "b": 1})
        driver = ElasticDriver(disc, blacklist_after=2)
        driver.poll_once()
        driver.record_failure("b")
        driver.record_failure("b")
        assert driver.blacklisted("b")
        driver.poll_once()
        assert driver.hosts == {"a": 1}

    def test_script_discovery(self, tmp_path):
        script = tmp_path / "discover.sh"
        script.write_text("#!/bin/sh\necho host1:4\necho host2:2\n")
        script.chmod(script.stat().st_mode | stat.S_IEXEC)
        disc = ScriptDiscovery(str(script))
        assert disc.find_available_hosts_and_slots() == {"host1": 4,
                                                         "host2": 2}

    def test_wait_for_available_slots_timeout(self):
        driver = ElasticDriver(FixedDiscovery({"a": 1}),
                               poll_interval_s=0.01)
        with pytest.raises(TimeoutError):
            driver.wait_for_available_slots(5, timeout_s=0.1)

    def test_interrupt_callback(self):
        on_update, check = hosts_updated_interrupt_callback()
        check()  # no-op before any update
        on_update({"new"}, set())
        with pytest.raises(HostsUpdatedInterrupt):
            check()
        check()  # flag cleared


class _FlakyDiscovery(FixedDiscovery):
    """Raises for the first ``fail_first`` polls, then serves hosts."""

    def __init__(self, hosts, fail_first=0, forever=False):
        super().__init__(hosts)
        self.fail_first = fail_first
        self.forever = forever
        self.calls = 0

    def find_available_hosts_and_slots(self):
        self.calls += 1
        if self.forever or self.calls <= self.fail_first:
            raise RuntimeError(f"discovery outage #{self.calls}")
        return super().find_available_hosts_and_slots()


class TestBlacklistDecay:
    def test_decay_gives_half_open_probation(self):
        driver = ElasticDriver(FixedDiscovery({"a": 1, "b": 1}),
                               blacklist_after=2, blacklist_decay_s=0.05)
        driver.record_failure("b")
        driver.record_failure("b")
        assert driver.blacklisted("b")
        import time

        time.sleep(0.06)
        assert not driver.blacklisted("b")       # decayed: eligible again
        driver.poll_once()
        assert driver.hosts == {"a": 1, "b": 1}  # back in membership
        driver.record_failure("b")               # half-open: ONE strike...
        assert driver.blacklisted("b")           # ...re-blacklists

    def test_zero_decay_is_permanent(self):
        driver = ElasticDriver(FixedDiscovery({"a": 1}),
                               blacklist_after=1, blacklist_decay_s=0.0)
        driver.record_failure("a")
        import time

        time.sleep(0.02)
        assert driver.blacklisted("a")

    def test_record_success_resets_strikes_and_blacklist(self):
        driver = ElasticDriver(FixedDiscovery({"a": 1}),
                               blacklist_after=2, blacklist_decay_s=600.0)
        driver.record_failure("a")
        driver.record_failure("a")
        assert driver.blacklisted("a")
        driver.record_success("a")
        assert not driver.blacklisted("a")
        driver.record_failure("a")               # full strike budget again
        assert not driver.blacklisted("a")
        driver.record_failure("a")
        assert driver.blacklisted("a")


class TestDiscoveryFailureAccounting:
    def test_sub_threshold_failures_hold_membership(self):
        disc = _FlakyDiscovery({"a": 2}, fail_first=0)
        driver = ElasticDriver(disc, failure_threshold=3)
        driver.poll_once()
        assert driver.world_size() == 2
        disc.forever = True
        assert driver.poll_once() is False       # failure 1: held
        assert driver.poll_once() is False       # failure 2: held
        assert driver.hosts == {"a": 2}

    def test_threshold_failures_mean_membership_loss(self):
        events = []
        disc = _FlakyDiscovery({"a": 2}, forever=False)
        driver = ElasticDriver(disc, failure_threshold=3)
        driver.register_hosts_updated_callback(
            lambda added, removed: events.append((sorted(added),
                                                  sorted(removed))))
        driver.poll_once()
        disc.forever = True
        driver.poll_once()
        driver.poll_once()
        assert driver.poll_once() is True        # 3rd consecutive: lost
        assert driver.hosts == {}
        assert events[-1] == ([], ["a"])
        # Recovery clears the streak and membership returns.
        disc.forever = False
        assert driver.poll_once() is True
        assert driver.hosts == {"a": 2}

    def test_wait_for_available_slots_survives_flaky_poll(self):
        disc = _FlakyDiscovery({"a": 4}, fail_first=2)
        driver = ElasticDriver(disc, poll_interval_s=0.01,
                               failure_threshold=5)
        hosts = driver.wait_for_available_slots(4, timeout_s=5.0)
        assert hosts == {"a": 4}

    def test_script_discovery_retries_flaky_script(self, tmp_path):
        # The script fails on its first invocation (no state file), then
        # succeeds — the retry helper must absorb that inside ONE
        # find_available_hosts_and_slots call.
        state = tmp_path / "ran_once"
        script = tmp_path / "discover.sh"
        script.write_text(textwrap.dedent(f"""\
            #!/bin/sh
            if [ ! -f {state} ]; then
              touch {state}
              exit 1
            fi
            echo host1:4
        """))
        script.chmod(script.stat().st_mode | stat.S_IEXEC)
        disc = ScriptDiscovery(str(script), retries=3, backoff_s=0.01)
        assert disc.find_available_hosts_and_slots() == {"host1": 4}


class _DistStoreError(RuntimeError):
    pass


# The default translator matches on the type name torch.distributed uses.
_DistStoreError.__name__ = "DistStoreError"


class TestExceptionTranslation:
    @pytest.mark.parametrize("exc", [
        RuntimeError("[../third_party/gloo/gloo/transport/tcp/pair.cc:534] "
                     "Connection closed by peer [127.0.0.1]:1234"),
        RuntimeError("NCCL error in: ProcessGroupNCCL.cpp:1970, remote "
                     "process exited or there was a network error, NCCL "
                     "version 2.21.5 ncclRemoteError"),
        RuntimeError("Connection reset by peer"),
        _DistStoreError("Socket Timeout"),
    ])
    def test_default_translates_torch_transport_failures(self, exc):
        from horovod_tpu_torch.elastic import translate_exception

        assert isinstance(translate_exception(exc), HorovodInternalError)

    def test_default_translates_the_dist_error_types(self):
        import torch.distributed as dist

        from horovod_tpu_torch.elastic import translate_exception

        for cls in ("DistBackendError", "DistNetworkError", "DistStoreError"):
            err_type = getattr(dist, cls, None)
            if err_type is None:
                err_type = type(cls, (RuntimeError,), {})
            exc = err_type("NCCL communicator was aborted: watchdog timeout")
            assert isinstance(translate_exception(exc),
                              HorovodInternalError), cls

    def test_default_passes_unrelated_errors(self):
        from horovod_tpu_torch.elastic import translate_exception

        assert translate_exception(ValueError("bad shape")) is None
        assert translate_exception(RuntimeError(
            "mat1 and mat2 shapes cannot be multiplied (2x3 and 4x5)")) \
            is None
        assert translate_exception(KeyError("Connection reset by peer")) \
            is None

    def test_run_recovers_from_translated_error(self, session, monkeypatch):
        from horovod_tpu_torch.elastic import state as state_mod

        monkeypatch.setattr(state_mod.time, "sleep", lambda s: None)
        state = ObjectState(step=0)
        calls = {"n": 0}

        @run
        def train(state):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("NCCL error: ncclSystemError: "
                                   "socket timed out")
            return "done"

        assert train(state) == "done"
        assert calls["n"] == 2

    def test_untranslated_error_propagates(self, session):
        state = ObjectState(step=0)

        @run
        def train(state):
            raise KeyError("app bug")

        with pytest.raises(KeyError):
            train(state)

    def test_registered_translator_wins(self, session, monkeypatch):
        from horovod_tpu_torch.elastic import (register_exception_translator,
                                               state as state_mod)

        monkeypatch.setattr(state_mod.time, "sleep", lambda s: None)

        class PreemptionNotice(Exception):
            pass

        def my_translator(e):
            if isinstance(e, PreemptionNotice):
                return HorovodInternalError(f"preempted: {e}")
            return None

        register_exception_translator(my_translator)
        try:
            state = ObjectState(step=0)
            calls = {"n": 0}

            @run
            def train(state):
                calls["n"] += 1
                if calls["n"] == 1:
                    raise PreemptionNotice("node reclaim in 30s")
                return calls["n"]

            assert train(state) == 2
        finally:
            state_mod._translators.remove(my_translator)


class TestResetBackoff:
    def test_backoff_grows_between_failed_resets(self, session, monkeypatch):
        from horovod_tpu_torch.elastic import state as state_mod

        sleeps = []
        monkeypatch.setattr(state_mod.time, "sleep",
                            lambda s: sleeps.append(s))
        monkeypatch.setenv("HVD_TPU_RESET_BACKOFF", "1.0")
        object.__setattr__(hvd.config(), "reset_backoff_seconds", 1.0)
        state = ObjectState(x=0)
        calls = {"n": 0}

        @run
        def train(state):
            calls["n"] += 1
            if calls["n"] <= 3:
                raise HorovodInternalError("boom")
            return True

        assert train(state) is True
        assert len(sleeps) == 3
        assert 0.5 <= sleeps[0] <= 1.5
        assert 1.0 <= sleeps[1] <= 3.0
        assert 2.0 <= sleeps[2] <= 6.0


# --- the sampler against the reference's ----------------------------------------

def _sampler_trace(cls, seed: int):
    """A seeded sequence of sampler operations: its index streams and
    state_dicts along the way."""
    rng = np.random.RandomState(seed)
    s = cls(num_samples=57, batch_size=3, shuffle=bool(seed % 2), seed=seed)
    out = []
    for op in rng.randint(0, 4, size=24):
        if op == 0:
            s.set_world(int(rng.randint(0, 2)), 2 + int(rng.randint(0, 2)))
        elif op == 1:
            s.set_epoch(int(rng.randint(0, 3)))
        elif op == 2 and len(s):
            batch = next(iter(s))
            s.record_batch(batch)
            out.append(batch.tolist())
        else:
            saved = s.state_dict()
            s = cls(num_samples=57, batch_size=3, shuffle=bool(seed % 2),
                    seed=seed)
            s.load_state_dict(saved)
        out.append([b.tolist() for b in s])
        out.append(s.state_dict())
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sampler_streams_and_state_equal_the_reference(seed):
    assert _sampler_trace(ElasticSampler, seed) == \
        _sampler_trace(JElasticSampler, seed)


class TestElasticSampler:
    def test_shards_and_resharding(self):
        s = ElasticSampler(num_samples=100, batch_size=5, shuffle=False)
        s.set_world(0, 2)
        batches = list(s)
        assert len(batches) == 10
        assert set(np.concatenate(batches)) == set(range(0, 100, 2))

    def test_no_replay_after_reshard(self):
        s = ElasticSampler(num_samples=20, batch_size=2, shuffle=False)
        s.set_world(0, 2)
        first = next(iter(s))
        s.record_batch(first)
        s2 = ElasticSampler(num_samples=20, batch_size=2, shuffle=False)
        s2.load_state_dict(s.state_dict())
        s2.set_world(0, 1)
        rest = np.concatenate(list(s2)) if len(s2) else np.array([])
        assert set(first).isdisjoint(set(rest))
        assert set(first) | set(rest) == set(range(20))


# --- two ranks --------------------------------------------------------------------

FAULT_STEP, TOTAL = 5, 8


def test_chaos_recovery_on_two_ranks(world, tmp_path):
    """``collective:step=5`` over an 8-step ``@elastic.run`` loop on two
    gloo ranks: it fires once on each rank at its 5th dispatch, the loop
    rolls back to the last commit, backs off, re-inits on the CPU over a
    new rendezvous generation, syncs and finishes, to the sums of an
    unfaulted run (the reference's single-controller drill)."""
    res = world.run("elastic_chaos", store=str(tmp_path / "store2"),
                    fault_step=FAULT_STEP, total=TOTAL)
    want = sum(2.0 * t for t in range(TOTAL))
    for r in res:
        assert r["fired"] == [("collective", FAULT_STEP, "raise:allreduce")]
        assert r["tries"] == 2
        step, accum = r["at_retry"]
        assert accum == sum(2.0 * t for t in range(step))
        assert r["accum"] == want
        np.testing.assert_array_equal(r["weight"],
                                      np.full((1, 2), float(TOTAL)))
        gen0, gen1 = r["generations"]
        assert gen1 == gen0 + 1
        assert (r["device"], r["backend"]) == ("cpu", "gloo")
        assert r["resets"] == 1
        assert len(r["sleeps"]) == 1 and r["sleeps"][0] > 0
        assert r["dump"]["reason"] == "horovod_internal_error"
        assert r["dump"]["fault_spec"] == f"collective:step={FAULT_STEP},seed=0"
        assert [tuple(h) for h in r["dump"]["fault_history"]] == r["fired"]


def test_sync_carries_rank0s_residual(world):
    """After ``TorchState.sync`` every rank holds rank 0's parameters,
    AdamW moments and error-feedback residual (ROADMAP queue C: the
    reference broadcasts its whole ``opt_state``)."""
    res = world.run("elastic_sync_residual", seed=3)
    assert any(not np.array_equal(res[0]["own"][k], res[1]["own"][k])
               for k in res[0]["own"])
    for r in res:
        assert r["step"] == 0
        for k, v in res[0]["own"].items():
            np.testing.assert_array_equal(r["residual"][k], v)
        for k, v in res[0]["params"].items():
            np.testing.assert_array_equal(r["params"][k], v)
        for a, b in zip(r["exp_avg"], res[0]["exp_avg"]):
            np.testing.assert_array_equal(a, b)
