"""The port's autotuner (``horovod_tpu_torch/optim/{parameter_manager,
autotune}.py``, the knobs in ``basics``/``config``) against the
reference's, mirroring ``tests/test_autotune.py``, ``tests/
test_mesh_plan.py::TestLayoutAutotune`` and ``tests/test_topo.py::
TestAutotuneTopoKnob``.

The Gaussian process, expected improvement and the manager are numpy on
both sides: fed the same scores, the port's manager proposes the
reference's points bit for bit.  The lattice snaps (nearest divisor,
nearest power of two) are held equal value for value.

``HOROVOD_AUTOTUNE=1`` end to end: in a world of one in this process
(the single-knob search, the live threshold seeding the manager, the
fusion-off start, the second step untuned, no layout knob without a
plan, the topology knob's lattice) and in one 4-rank gloo world
(``tests/torch_port_workers.py``: the hierarchical, two-phase,
microbatch/compressor and layout searches, the topology knob on a 2 × 2
spec): every applied point lies on its knob's lattice, the live config
holds the last applied point, the manager freezes, training goes on
through every rebuild, and every rank applies rank 0's decisions.
"""

import json
import math

import numpy as np
import pytest
import torch

from horovod_tpu import basics as jax_basics
from horovod_tpu.optim.parameter_manager import (
    ParameterManager as JaxParameterManager)

import horovod_tpu_torch as thvd
from horovod_tpu_torch import basics
from horovod_tpu_torch.config import Config
from horovod_tpu_torch.optim import (AutotunedTrainStep, GaussianProcess,
                                     ParameterManager, expected_improvement)
from horovod_tpu_torch.plan import layout_lattice

import torch_port_workers as workers
from test_mesh_plan import _toy_problem

N = 4
TUNE = {"HOROVOD_AUTOTUNE": "1", "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": "1",
        "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE": "2"}


def _problem():
    _, params, (x, y) = _toy_problem()
    return dict(w=np.array(params["w"]), b=np.array(params["b"]),
                x=np.array(x), y=np.array(y))


# --- the Gaussian process, expected improvement, the manager -----------------

class TestGaussianProcess:
    def test_interpolates_observations(self):
        gp = GaussianProcess(length_scale=1.0, noise=1e-8)
        x = np.array([[0.0], [1.0], [2.0]])
        y = np.array([0.0, 1.0, 0.0])
        gp.fit(x, y)
        mean, std = gp.predict(x)
        np.testing.assert_allclose(mean, y, atol=1e-3)
        assert (std < 0.05).all()

    def test_uncertainty_grows_away_from_data(self):
        gp = GaussianProcess()
        gp.fit(np.array([[0.0]]), np.array([1.0]))
        _, std_near = gp.predict(np.array([[0.1]]))
        _, std_far = gp.predict(np.array([[5.0]]))
        assert std_far > std_near

    def test_prior_before_fit(self):
        mean, std = GaussianProcess().predict(np.array([[3.0]]))
        assert mean[0] == 0.0 and std[0] > 0


class TestExpectedImprovement:
    def test_prefers_high_mean_when_std_equal(self):
        ei = expected_improvement(np.array([0.0, 1.0]),
                                  np.array([0.5, 0.5]), best=0.0)
        assert ei[1] > ei[0]

    def test_prefers_high_std_when_mean_equal(self):
        ei = expected_improvement(np.array([0.0, 0.0]),
                                  np.array([0.1, 1.0]), best=0.5)
        assert ei[1] > ei[0]


def _objective(vals):
    """Throughput peaked inside the box, separable over the knobs."""
    score = 100.0
    for k, v in sorted(vals.items()):
        peak = 24.0 if k == "fusion_threshold" else 1.0
        score -= (math.log2(v) - peak) ** 2
    return score


KNOB_SETS = {
    "threshold": {"fusion_threshold": (2 ** 20, 2 ** 28)},
    "joint": {"fusion_threshold": (2 ** 20, 2 ** 28),
              "hierarchical_inner_size": (1, 16)},
    "wide": {"fusion_threshold": (2 ** 20, 2 ** 28), "two_phase": (1, 2),
             "pipeline_depth": (1, 8), "microbatches": (1, 32),
             "overlap": (1, 2), "compressor": (1, 4)},
}


@pytest.mark.parametrize("knobs", list(KNOB_SETS))
def test_proposals_bitwise_equal_the_reference(knobs, tmp_path):
    """The same scores into both managers: every proposal, the frozen
    point and every logged sample bit for bit alike."""
    logs = [tmp_path / "ref.jsonl", tmp_path / "port.jsonl"]
    kwargs = dict(warmup_samples=1, steps_per_sample=1, max_samples=8)
    ref = JaxParameterManager(KNOB_SETS[knobs], log_path=str(logs[0]),
                              **kwargs)
    port = ParameterManager(KNOB_SETS[knobs], log_path=str(logs[1]),
                            **kwargs)
    while not ref.frozen:
        want = ref.record_window(_objective(ref.current_values()), 1.0)
        got = port.record_window(_objective(port.current_values()), 1.0)
        assert got == want
        assert port.current_values() == ref.current_values()
    assert port.frozen
    lines = [[{k: v for k, v in json.loads(line).items() if k != "ts"}
              for line in log.read_text().splitlines()] for log in logs]
    assert lines[1] == lines[0] and lines[1][-1]["note"] == "frozen"


class TestParameterManager:
    def _drive(self, pm, rounds=400):
        for _ in range(rounds):
            if pm.frozen:
                break
            pm.record(samples=_objective(pm.current_values()), seconds=1.0)

    def test_warmup_then_tunes_and_freezes(self, tmp_path):
        log = tmp_path / "autotune.jsonl"
        pm = ParameterManager({"fusion_threshold": (2 ** 20, 2 ** 28)},
                              warmup_samples=1, steps_per_sample=2,
                              max_samples=6, log_path=str(log))
        self._drive(pm)
        assert pm.frozen
        assert 2 ** 20 <= pm.current_values()["fusion_threshold"] <= 2 ** 28
        assert len(log.read_text().strip().splitlines()) >= 2

    def test_joint_2d_search_converges_and_freezes(self, tmp_path):
        log = tmp_path / "joint.jsonl"
        pm = ParameterManager(KNOB_SETS["joint"], warmup_samples=1,
                              steps_per_sample=1, max_samples=12,
                              log_path=str(log))
        self._drive(pm)
        assert pm.frozen
        lines = [json.loads(line) for line in
                 log.read_text().strip().splitlines()]
        assert all(set(line["knobs"]) == set(KNOB_SETS["joint"])
                   for line in lines)
        scores = [line["score"] for line in lines if line["note"] != "frozen"]
        assert lines[-1]["note"] == "frozen"
        assert lines[-1]["score"] == max(scores)

    def test_record_before_enough_steps_returns_none(self):
        pm = ParameterManager({"k": (1, 1024)}, steps_per_sample=5)
        for _ in range(4):
            assert pm.record(10, 1.0) is None

    def test_requires_knobs(self):
        with pytest.raises(ValueError):
            ParameterManager({})

    def test_frozen_ignores_records(self):
        pm = ParameterManager({"k": (1, 256)}, warmup_samples=0,
                              steps_per_sample=1, max_samples=2)
        pm.record(1, 1.0)
        pm.record(2, 1.0)
        assert pm.frozen and pm.record(3, 1.0) is None

    def test_record_window_equivalent_contract(self):
        pm = ParameterManager({"k": (1, 256)}, warmup_samples=1,
                              steps_per_sample=4, max_samples=3)
        assert pm.record_window(100, 1.0) is None       # warmup discard
        assert pm.record_window(100, 1.0) is not None   # proposal
        assert pm.record_window(100, 1.0) is not None
        assert pm.record_window(100, 1.0) is not None   # freeze
        assert pm.frozen and pm.record_window(100, 1.0) is None

    def test_close_idempotent(self, tmp_path):
        pm = ParameterManager({"k": (1, 256)},
                              log_path=str(tmp_path / "l.jsonl"))
        pm.close()
        pm.close()

    def test_out_of_bounds_seed_raises(self):
        with pytest.raises(ValueError, match="outside the search bounds"):
            ParameterManager({"fusion_threshold": (1 << 20, 1 << 28)},
                             initial={"fusion_threshold": 0})

    def test_mirror_adopts_peer_decision(self):
        pm = ParameterManager({"fusion_threshold": (1 << 20, 1 << 28)})
        pm.mirror({"fusion_threshold": float(1 << 22)}, frozen=False)
        assert pm.current_values()["fusion_threshold"] == float(1 << 22)
        assert not pm.frozen
        pm.mirror(None, frozen=True)
        assert pm.frozen


def test_lattice_snaps_match_the_reference():
    for size in (4, 8, 12):
        for v in range(0, 40):
            assert basics._nearest_divisor(v, size) == \
                jax_basics._nearest_divisor(v, size)
    for v in range(1, 100):
        assert basics._nearest_pow2(v) == jax_basics._nearest_pow2(v)
    assert basics._COMPRESSOR_LATTICE == jax_basics._COMPRESSOR_LATTICE
    assert basics._TOPO_LATTICE == jax_basics._TOPO_LATTICE
    assert basics._KERNEL_LATTICE == jax_basics._KERNEL_LATTICE


def test_env_knobs_parse(monkeypatch):
    monkeypatch.setenv("HOROVOD_AUTOTUNE", "1")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_LOG", "/tmp/at.jsonl")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_WARMUP_SAMPLES", "2")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE", "5")
    monkeypatch.setenv("HVD_TPU_AUTOTUNE_MAX_SAMPLES", "7")
    cfg = Config.from_env()
    assert cfg.autotune is True
    assert cfg.autotune_log == "/tmp/at.jsonl"
    assert (cfg.autotune_warmup_samples, cfg.autotune_steps_per_sample,
            cfg.autotune_max_samples) == (2, 5, 7)


# --- HOROVOD_AUTOTUNE=1 in a world of one ------------------------------------

@pytest.fixture
def solo():
    thvd.init(device="cpu")
    yield
    thvd.shutdown()


def test_knob_moves_and_freezes(solo, tmp_path):
    log = tmp_path / "autotune.jsonl"
    out = workers.autotune_steps({**TUNE, "HVD_TPU_AUTOTUNE_MAX_SAMPLES": "3",
                                  "HOROVOD_AUTOTUNE_LOG": str(log)}, 16,
                                 **_problem())
    assert out["tuned"] and out["knobs"] == ["fusion_threshold"]
    assert out["frozen"]
    assert out["applied"], "no autotune proposal was ever applied"
    assert out["config"]["fusion_threshold"] == out["applied"][-1]
    assert any(t != out["start"]["fusion_threshold"] for t in out["applied"])
    assert out["losses"][-1] < out["losses"][0]
    lines = [json.loads(line) for line in log.read_text().splitlines()]
    assert len(lines) >= 3 and lines[-1]["note"] == "frozen"


def test_manager_seeded_with_live_threshold(solo):
    out = workers.autotune_steps({**TUNE, "HOROVOD_FUSION_THRESHOLD":
                                  str(1 << 22)}, 0, **_problem())
    assert out["pm_start"]["fusion_threshold"] == float(1 << 22)


def test_fusion_off_plus_autotune_adopts_tuner_start(solo):
    out = workers.autotune_steps({**TUNE, "HOROVOD_FUSION_THRESHOLD": "0"},
                                 0, **_problem())
    live = out["start"]["fusion_threshold"]
    assert (1 << 20) <= live <= (1 << 28)
    assert live == int(out["pm_start"]["fusion_threshold"])


def test_second_train_step_runs_untuned(solo):
    out = workers.autotune_steps(TUNE, 0, second=True, **_problem())
    assert out["tuned"] and not out["second_tuned"]


def test_no_autotune_returns_the_plain_step(solo):
    step = thvd.make_train_step(lambda m, b: (m.w * b).sum(),
                                torch.optim.SGD([torch.nn.Parameter(
                                    torch.ones(2))], lr=0.1))
    assert not isinstance(step, AutotunedTrainStep)
    assert thvd.parameter_manager() is None


def test_no_layout_knob_without_plan(solo):
    out = workers.autotune_steps({**TUNE, "HVD_TPU_AUTOTUNE_MAX_SAMPLES":
                                  "2"}, 0, **_problem())
    assert "layout" not in out["knobs"]


def test_topo_knob_maps_lattice_to_config(solo):
    applied = basics._apply_autotuned_knobs({"topo_schedule": 3.2})
    assert applied["topo_schedule"] == 3
    assert thvd.config().topo_schedule == "hierarchical"
    basics._apply_autotuned_knobs({"topo_schedule": 1.0})
    assert thvd.config().topo_schedule == "flat"


def test_topo_knob_stays_out_on_a_flat_mesh(solo):
    out = workers.autotune_steps({**TUNE, "HVD_TPU_TOPO_SCHEDULE": "auto"},
                                 0, **_problem())
    assert "topo_schedule" not in out["knobs"]


# --- HOROVOD_AUTOTUNE=1 on four ranks ----------------------------------------

MAX3 = {**TUNE, "HVD_TPU_AUTOTUNE_MAX_SAMPLES": "3"}
MAX4 = {**TUNE, "HVD_TPU_AUTOTUNE_MAX_SAMPLES": "4"}
WORLD_RUNS = {
    "hierarchical": ({**MAX3, "HOROVOD_HIERARCHICAL_ALLREDUCE": "1"}, 16),
    "two_phase": ({**MAX4, "HVD_TPU_TWO_PHASE_ALLREDUCE": "1",
                   "HVD_TPU_COST_ALPHA_US": "0.001",
                   "HVD_TPU_COST_BETA_GBPS": "1"}, 20),
    "microbatch": ({**MAX4, "HVD_TPU_MICROBATCHES": "2",
                    "HVD_TPU_ERROR_FEEDBACK": "1"}, 24),
    "layout": ({**MAX4, "HVD_TPU_MESH_PLAN": f"data={N}"}, 20),
    "topo": ({**MAX3, "HVD_TPU_TOPO_SCHEDULE": "auto",
              "HVD_TPU_TOPO_SPEC": "2x2"}, 16),
}


@pytest.fixture(scope="module")
def world_runs(tmp_path_factory):
    world = workers.World(N, str(tmp_path_factory.mktemp("gloo") / "store"))
    try:
        for env, steps in WORLD_RUNS.values():
            world.submit("autotune_steps", env=env, steps=steps, **_problem())
        return {name: world.collect(name) for name in WORLD_RUNS}
    finally:
        world.close()


def _common(outs):
    """Every rank ran rank 0's decisions: the same applied points and the
    same live config; the manager froze, the step kept training."""
    first = outs[0]
    assert first["tuned"] and first["frozen"] and first["applied_knobs"]
    for o in outs[1:]:
        assert o["applied_knobs"] == first["applied_knobs"]
        assert o["config"] == first["config"]
        assert o["frozen"]
    for o in outs:
        assert all(math.isfinite(v) for v in o["losses"])
    last = first["applied_knobs"][-1]
    assert first["config"]["fusion_threshold"] == last["fusion_threshold"]
    return first, last


def test_joint_knobs_on_hierarchical_mesh(world_runs):
    first, last = _common(world_runs["hierarchical"])
    assert first["knobs"] == ["fusion_threshold", "hierarchical_inner_size"]
    assert N % first["start"]["hierarchical_inner_size"] == 0
    for knobs in first["applied_knobs"]:
        assert N % knobs["hierarchical_inner_size"] == 0
    assert (first["config"]["hierarchical_inner_size"]
            == last["hierarchical_inner_size"])


def test_two_phase_knobs_flip_at_the_rebuild(world_runs):
    first, last = _common(world_runs["two_phase"])
    assert first["knobs"] == ["fusion_threshold", "pipeline_depth",
                              "two_phase"]
    for knobs in first["applied_knobs"]:
        assert knobs["two_phase"] in (1, 2)
        assert 1 <= knobs["pipeline_depth"] <= 8
    assert first["config"]["two_phase_allreduce"] == (last["two_phase"] == 2)
    assert first["config"]["pipeline_depth"] == last["pipeline_depth"]


def test_microbatch_overlap_compressor_joint_search(world_runs):
    first, last = _common(world_runs["microbatch"])
    assert first["knobs"] == ["compressor", "fusion_threshold",
                              "microbatches", "overlap"]
    for knobs in first["applied_knobs"]:
        mb = knobs["microbatches"]
        assert mb >= 1 and (mb & (mb - 1)) == 0
        assert knobs["overlap"] in (1, 2)
        assert 1 <= knobs["compressor"] <= 4
    assert first["config"]["microbatches"] == last["microbatches"]
    assert first["config"]["overlap_reduce"] == (last["overlap"] == 2)
    assert first["config"]["compression"] == \
        basics._COMPRESSOR_LATTICE[last["compressor"] - 1]


def test_layout_flips_at_the_rebuild(world_runs):
    """``HVD_TPU_MESH_PLAN`` + autotune: the layout knob indexes the live
    layout first, then ``plan.layout_lattice``'s; the session plan is
    the last applied one."""
    first, last = _common(world_runs["layout"])
    assert "layout" in first["knobs"]
    lattice = layout_lattice(N)
    for knobs in first["applied_knobs"]:
        assert 1 <= knobs["layout"] <= len(lattice)
    final = lattice[last["layout"] - 1]
    assert first["config"]["mesh_plan"] == final
    assert first["plan"] == final


def test_topo_knob_joins_the_search_on_a_two_tier_mesh(world_runs):
    first, last = _common(world_runs["topo"])
    assert "topo_schedule" in first["knobs"]
    assert "topo_kernel" in first["knobs"]
    assert first["config"]["topo_schedule"] == \
        basics._TOPO_LATTICE[last["topo_schedule"] - 1]
