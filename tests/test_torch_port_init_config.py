"""``init(config)`` and the package's top-level names against the
reference's (``horovod_tpu/basics.py:147``, ``horovod_tpu/__init__.py``).

The reference's ``init(config: Optional[Config] = None)`` takes an
explicit :class:`Config` in the place of the environment's; its own
tests pass one positionally (``tests/test_fusion.py:341``,
``test_autotune.py:200``, ``test_microbatch.py:165``,
``test_mesh_plan.py:380``), mirrored here in a world of one on the CPU.
The port's ``init(config=None, device=None, backend=None)`` keeps
``device`` and ``backend`` after it.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import horovod_tpu

import horovod_tpu_torch as hvd
from horovod_tpu_torch import faults
from horovod_tpu_torch.config import Config
from horovod_tpu_torch.optim.autotune import AutotunedTrainStep


@pytest.fixture
def fresh():
    hvd.shutdown()
    yield
    hvd.shutdown()
    faults.clear()


def _linear_problem(rows=8, seed=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(rows, 4).astype(np.float32))
    y = torch.from_numpy(rng.randn(rows, 1).astype(np.float32))
    w0 = torch.from_numpy(rng.randn(4, 1).astype(np.float32))
    return x, y, w0


def _one_step(**step_kw):
    """One SGD step of a linear least-squares model; its weights."""
    x, y, w0 = _linear_problem()
    model = torch.nn.Linear(4, 1, bias=False)
    with torch.no_grad():
        model.weight.copy_(w0.T)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    step = hvd.make_train_step(
        lambda m, b: ((m(b[0]) - b[1]) ** 2).mean(), opt, **step_kw)
    loss = step(model, (x, y))
    assert torch.isfinite(torch.as_tensor(loss))
    return model.weight.detach().clone()


def test_init_takes_a_config_positionally(fresh):
    hvd.init(Config(microbatches=3), device="cpu")
    assert hvd.config().microbatches == 3
    assert hvd.device() == torch.device("cpu")


def test_init_takes_a_config_by_keyword(fresh):
    hvd.init(config=Config(two_phase_allreduce=True, pipeline_depth=3),
             device="cpu", backend="gloo")
    cfg = hvd.config()
    assert cfg.two_phase_allreduce is True and cfg.pipeline_depth == 3


def test_given_config_wins_over_the_environment(fresh, monkeypatch):
    """As in the reference, the environment is not read at all when a
    config is given: a conflicting knob, even a malformed one, loses."""
    monkeypatch.setenv("HVD_TPU_MICROBATCHES", "5")
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "not-a-number")
    monkeypatch.setenv("HVD_TPU_MESH_AXIS_NAME", "env_axis")
    hvd.init(Config(microbatches=3, mesh_axis_name="cfg_axis"),
             device="cpu")
    assert hvd.config().microbatches == 3
    assert hvd.config().fusion_threshold == Config().fusion_threshold
    assert hvd.global_mesh().axis_name == "cfg_axis"
    hvd.shutdown()
    monkeypatch.delenv("HOROVOD_FUSION_THRESHOLD")
    hvd.init(device="cpu")
    assert hvd.config().microbatches == 5
    assert hvd.global_mesh().axis_name == "env_axis"


def test_given_config_arms_its_fault_plan(fresh, monkeypatch):
    monkeypatch.delenv("HVD_TPU_FAULT_SPEC", raising=False)
    hvd.init(Config(fault_spec="collective:step=0"), device="cpu")
    assert faults.active_spec() == "collective:step=0"
    with pytest.raises(ValueError):
        hvd.shutdown()
        hvd.init(Config(fault_spec="collective:bogus=1"), device="cpu")


def test_config_driven_two_phase_path(fresh):
    """tests/test_fusion.py:341: the two-phase knobs of an explicit
    config drive the step exactly as the explicit arguments do."""
    hvd.init(device="cpu")
    explicit = _one_step(two_phase=True, pipeline_depth=3)
    hvd.shutdown()
    hvd.init(Config(two_phase_allreduce=True, pipeline_depth=3,
                    cost_alpha_us=1e-6, cost_beta_gbps=1.0), device="cpu")
    assert torch.equal(_one_step(), explicit)


def test_config_driven_autotune(fresh, tmp_path):
    """tests/test_autotune.py:200: ``init(Config(autotune=True, ...))``
    makes the session's first train step the autotuned one."""
    log = tmp_path / "autotune.jsonl"
    hvd.init(Config(autotune=True, autotune_warmup_samples=1,
                    autotune_steps_per_sample=2, autotune_max_samples=3,
                    autotune_log=str(log)), device="cpu")
    pm = hvd.parameter_manager()
    assert pm is not None and not pm.frozen
    assert "fusion_threshold" in pm.knob_names
    model = torch.nn.Linear(4, 1, bias=False)
    step = hvd.make_train_step(
        lambda m, b: ((m(b[0]) - b[1]) ** 2).mean(),
        torch.optim.SGD(model.parameters(), lr=0.05))
    assert isinstance(step, AutotunedTrainStep)
    x, y, _ = _linear_problem(16)
    losses = [float(step(model, (x, y))) for _ in range(8)]
    assert losses[-1] < losses[0]


def test_config_driven_count_snaps_to_divisor(fresh):
    """tests/test_microbatch.py:165: ``Config(microbatches=3)`` over 8
    rows snaps to 2 microbatches, bit for bit the explicit count."""
    hvd.init(device="cpu")
    two = _one_step(microbatches=2)
    hvd.shutdown()
    hvd.init(Config(microbatches=3), device="cpu")
    assert torch.equal(_one_step(), two)


def test_config_driven_mesh_plan_with_autotune(fresh):
    """tests/test_mesh_plan.py:380: a config's ``mesh_plan`` and
    autotune settings are the session's (a world of one has a single
    layout, so no ``layout`` knob joins the search)."""
    hvd.init(Config(autotune=True, mesh_plan="data=1",
                    autotune_warmup_samples=1, autotune_steps_per_sample=2,
                    autotune_max_samples=4), device="cpu")
    assert hvd.mesh_plan().describe() == "data=1"
    pm = hvd.parameter_manager()
    assert pm is not None and "layout" not in pm.knob_names


# --- the top-level names (F12) ------------------------------------------------

# Names the reference exports that have no torch analogue, each with why.
NO_TORCH_ANALOGUE = {
    "DistributedOptimizerState": (
        "optax's state tuple of the reference's optimizer wrapper; the "
        "port's error-feedback residual, accumulator and call count ride "
        "the torch optimizer's state_dict (F9)"),
}


def _reference_exports():
    """Every name ``horovod_tpu/__init__.py`` binds: its imports and its
    lazy attributes (``_OPTIM_EXPORTS``, ``_LAZY_SUBMODULES``)."""
    import ast

    tree = ast.parse(open(horovod_tpu.__file__).read())
    names = set(horovod_tpu._OPTIM_EXPORTS) | set(
        horovod_tpu._LAZY_SUBMODULES)
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level == 1:
            names.update(a.asname or a.name for a in node.names)
    return names


def test_top_level_names_match_the_reference():
    assert hvd.__version__ == horovod_tpu.__version__
    from horovod_tpu_torch.plan import MeshPlan

    assert hvd.MeshPlan is MeshPlan
    names = _reference_exports()
    assert {"init", "MeshPlan", "__version__", "serve",
            "make_train_step"} <= names
    missing = sorted(n for n in names if not hasattr(hvd, n))
    assert missing == sorted(NO_TORCH_ANALOGUE), missing
    assert all(why for why in NO_TORCH_ANALOGUE.values())


# --- the knobs ----------------------------------------------------------------

# Reference fields and module names the port does not hold yet, each
# waiting for its ROADMAP queue A item (none left).
NOT_YET: dict = {}

# Reference pre-init knobs the port never reads, with the reason
# (horovod_tpu_torch/config.py says the same beside PRE_INIT_KNOBS).
PRE_INIT_LEFT_OUT = {
    "COORDINATOR_ADDR": "the JAX coordinator's address; torchrun's "
                        "MASTER_ADDR/MASTER_PORT take its place",
    "NUM_PROCESSES": "the JAX coordinator's world size; torchrun's "
                     "WORLD_SIZE takes its place",
    "USE_NATIVE_FFI": "gates the reference's XLA FFI registration; the "
                      "port has no FFI tier",
}


def test_config_fields_match_the_reference():
    ref = importlib.import_module("horovod_tpu.config")
    port = importlib.import_module("horovod_tpu_torch.config")
    ref_fields = {f.name: f.default for f in dataclasses.fields(ref.Config)}
    port_fields = {f.name: f.default
                   for f in dataclasses.fields(port.Config)}
    assert sorted(set(ref_fields) - set(port_fields)) == sorted(
        n for n in NOT_YET if not n.isupper())
    assert not set(port_fields) - set(ref_fields)
    for name in ("fleet_migrate_chunk", "fleet_scale_out_queue",
                 "fleet_scale_out_ttft_ms", "fleet_scale_in_idle_s",
                 "fleet_drain_deadline_s", "swap_poll_s", "swap_deadline_s",
                 "swap_max_concurrent", "swap_retries", "collect_period_s",
                 "collect_timeout_s", "collect_window", "collect_stale_s",
                 "slo_spec", "mesh_axis_name", "batch_d2d_memcopies"):
        assert port_fields[name] == ref_fields[name], name
    public = {n for n in dir(ref) if n.isupper() or n[0].isupper()
              or n.startswith("parse_")}
    assert sorted(n for n in public if not hasattr(port, n)) == sorted(
        n for n in NOT_YET if n.isupper())
    # PRE_INIT_KNOBS name by name: the reference's, in its order, less
    # the knobs the port never reads.
    assert [n for n in ref.PRE_INIT_KNOBS if n not in PRE_INIT_LEFT_OUT] \
        == list(port.PRE_INIT_KNOBS)
    assert set(PRE_INIT_LEFT_OUT) <= set(ref.PRE_INIT_KNOBS)
    assert all(PRE_INIT_LEFT_OUT.values())


@pytest.mark.parametrize("env", [
    {"HVD_TPU_FLEET_MIGRATE_CHUNK": "4096",
     "HVD_TPU_FLEET_SCALE_OUT_QUEUE": "2.5",
     "HVD_TPU_FLEET_SCALE_OUT_TTFT_MS": "750",
     "HVD_TPU_FLEET_SCALE_IN_IDLE_S": "12",
     "HVD_TPU_FLEET_DRAIN_DEADLINE_S": "9"},
    {"HVD_TPU_SWAP_POLL_S": "0.5", "HVD_TPU_SWAP_DEADLINE_S": "0",
     "HVD_TPU_SWAP_MAX_CONCURRENT": "3", "HVD_TPU_SWAP_RETRIES": "5"},
    {"HVD_TPU_COLLECT_PERIOD_S": "2", "HVD_TPU_COLLECT_TIMEOUT_S": "0.25",
     "HVD_TPU_COLLECT_WINDOW": "64", "HVD_TPU_COLLECT_STALE_S": "4",
     "HVD_TPU_SLO_SPEC": "a:signal=scrape_ok,target=0.9,window=60",
     "HVD_TPU_MESH_AXIS_NAME": "world",
     "HOROVOD_BATCH_D2D_MEMCOPIES": "0"},
    {"HVD_TPU_SWAP_RETRIES": "0"},
    {"HVD_TPU_FLEET_MIGRATE_CHUNK": "0"},
    {"HVD_TPU_COLLECT_WINDOW": "0"},
    {"HVD_TPU_SLO_SPEC": "a:signal=nope,target=1"},
])
def test_new_knobs_parse_as_the_reference(env, monkeypatch):
    """The fleet, swap, telemetry and no-op knobs: the same values, or
    the same refusal, from the same environment."""
    ref = importlib.import_module("horovod_tpu.config")
    port = importlib.import_module("horovod_tpu_torch.config")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    try:
        want = ref.Config.from_env()
    except ValueError:
        with pytest.raises(ValueError):
            port.Config.from_env()
        return
    got = port.Config.from_env()
    for name in (f.name for f in dataclasses.fields(got)):
        assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("spec", [
    "ttft:signal=ttft_p99_ms,target=500,burn=6;avail:signal=scrape_ok,"
    "target=0.9",
    "q:signal=queue_depth,target=8,budget=0.2,window=120,severity=ticket",
    "a:signal=scrape_ok,target=0.9,window=10,short=20",
    "a:signal=scrape_ok,target=0.9;a:signal=scrape_ok,target=0.5",
    "a:signal=scrape_ok",
    "a:signal=scrape_ok,target=x",
    "a:signal=scrape_ok,target=1,severity=sms",
    "a:signal=scrape_ok,target=1,budget=0",
    "a:signal=scrape_ok,target=1,colour=red",
    "nocolon", "",
])
def test_slo_grammar_matches_the_reference(spec):
    ref = importlib.import_module("horovod_tpu.config")
    port = importlib.import_module("horovod_tpu_torch.config")
    try:
        want = ref.parse_slo_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            port.parse_slo_spec(spec)
        assert str(got.value) == str(e)
        return
    got = port.parse_slo_spec(spec)
    assert ({k: dataclasses.asdict(v) for k, v in got.items()}
            == {k: dataclasses.asdict(v) for k, v in want.items()})
    assert port.SLO_SIGNALS == ref.SLO_SIGNALS
    assert port.SLO_SEVERITIES == ref.SLO_SEVERITIES
