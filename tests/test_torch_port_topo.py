"""The PyTorch port's two-tier topology compiler (``horovod_tpu_torch/topo``)
against the JAX reference (``horovod_tpu/topo``), mirroring
``tests/test_topo.py``.

The mesh model, the cost model, the estimator and the schedule IR are
pure arithmetic, so the port's values equal the reference's exactly (the
IR field by field, the costs as floats).  Execution runs on one 4-rank
gloo world spawned for the module (``tests/torch_port_workers.py``),
declared 2 pods × 2 chips; the reference runs the same schedules inside a
``shard_map`` over the first four CPU devices with ``MeshTopology(2, 2)``
on the same seeded numpy rows, compiled at backend optimization level 0
(ROADMAP R1).  Tolerances: bit for bit on exact (small-integer) data on
the none/fp16/bf16 wires, bit for bit on the int8 wire (its SPMD tier,
any data), and ``rtol=1e-5, atol=1e-6`` on random f32 (the reference
test's), where gloo adds four contributions in another order than XLA.

Not mirrored, each waiting for the item of ROADMAP queue A that owns
it: ``TestNativeTwin`` (the native planner, item 9), the estimator's
gauges and the ``hvd_tpu_topo_*`` metrics (observability, item 10),
``TestAutotuneTopoKnob`` (item 7).  ``TestDcnFaultSite`` and
``TestChaosDcnRecovery`` are held by
``test_dcn_fault_site_fires_at_the_cross_pod_stage`` and
``test_dcn_fault_rolls_back_and_converges``.
"""

import contextlib
import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu._compat import shard_map
from horovod_tpu.config import parse_topo_spec as ref_parse_topo_spec
from horovod_tpu.ops import fusion as jf
from horovod_tpu.ops.compression import Compression as JaxCompression
from horovod_tpu.topo import costmodel as jc
from horovod_tpu.topo import schedule as js
from horovod_tpu.topo import simulate as jsim
from horovod_tpu.topo import topology as jt

import horovod_tpu_torch as thvd
from horovod_tpu_torch import basics as tb
from horovod_tpu_torch.config import Config, parse_topo_spec
from horovod_tpu_torch.topo import simulate
from horovod_tpu_torch.topo.costmodel import (OnlineEstimator, TierParams,
                                              TopoCostParams,
                                              default_params, flat_cost_us,
                                              hierarchical_cost_us,
                                              hierarchical_crossover_bytes,
                                              hierarchical_phase_costs_us,
                                              reset_estimator,
                                              tier_phase_cost_us)
from horovod_tpu_torch.topo.costmodel import estimator as process_estimator
from horovod_tpu_torch.topo.schedule import (ALGO_FLAT, ALGO_HIERARCHICAL,
                                             ALGO_TWO_PHASE,
                                             ScheduleCompiler, choose_algo,
                                             compile_bucket_schedule,
                                             maybe_compiler, record_plans)
from horovod_tpu_torch.topo.topology import (MeshTopology, config_topology,
                                             infer_topology,
                                             resolve_topology)

import torch_port_workers as workers

N = 4
PARAMS = TopoCostParams(ici=TierParams(alpha_us=10.0, beta_gbps=100.0),
                        dcn=TierParams(alpha_us=100.0, beta_gbps=10.0))
TOPO24 = MeshTopology(pods=2, chips_per_pod=4)
# (α, β) pairs a tier: at these, a 2×2 mesh keeps a 148-byte bucket
# flat, decomposes 424 bytes into two phases and makes 4000 bytes
# hierarchical.
MIXED = ((0.1, 10.0), (1.0, 1.0))
COMPS = ["none", "fp16", "bf16", "int8"]
ALGOS = [ALGO_FLAT, ALGO_TWO_PHASE, ALGO_HIERARCHICAL]


def _port_params(p):
    return TopoCostParams(ici=TierParams(*p[0]), dcn=TierParams(*p[1]))


def _ref_params(p):
    return jc.TopoCostParams(ici=jc.TierParams(*p[0]),
                             dcn=jc.TierParams(*p[1]))


PARAM_GRID = [
    ((10.0, 100.0), (100.0, 10.0)),
    ((10.0, 100.0), (5.0, 10.0)),       # hierarchy wins at every size
    ((10.0, 100.0), (100.0, 100.0)),    # never wins
    ((0.0, 50.0), (1.0, 5.0)),
    ((10.0, 10.0), (5.0, 100.0)),       # inverted tiers
    MIXED,
]
TOPOS = [(1, 4), (2, 2), (4, 2), (2, 4), (8, 1)]


@contextlib.contextmanager
def _config(**kw):
    """The port's live config with ``kw`` swapped in, for the block."""
    old = tb._session
    tb._session = dataclasses.replace(
        old, config=dataclasses.replace(old.config, **kw))
    try:
        yield tb._session.config
    finally:
        tb._session = old


@pytest.fixture
def solo():
    """The port in a world of one, in this process."""
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = workers.World(N, str(tmp_path_factory.mktemp("gloo") / "store"))
    yield w
    w.close()


def _ir(sched):
    """A schedule of either package as plain values, field by field."""
    return (sched.algo,
            tuple((s.op, s.tier, s.groups, s.payload_bytes)
                  for s in sched.steps),
            sched.nbytes, sched.est_cost_us,
            (sched.topo.pods, sched.topo.chips_per_pod), sched.kernel)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _same_on_every_rank(out):
    for r in range(1, len(out)):
        for a, b in zip(out[0], out[r]):
            if isinstance(a, dict):
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k])
            else:
                np.testing.assert_array_equal(a, b)
    return out[0]


# --- topology model ----------------------------------------------------------

class TestTopoSpec:
    @pytest.mark.parametrize("spec,want", [
        ("4x8", (4, 8)), ("2x4", (2, 4)), (" 2 x 4 ", (2, 4)),
        ("2X4", (2, 4)), ("1x8", (1, 8))])
    def test_parses(self, spec, want):
        assert parse_topo_spec(spec) == want == ref_parse_topo_spec(spec)

    @pytest.mark.parametrize("bad", [
        "", "8", "x8", "4x", "0x4", "4x0", "-1x4", "ax8", "4x8x2", "4*8"])
    def test_rejects_malformed(self, bad):
        with pytest.raises(ValueError, match="topo spec"):
            parse_topo_spec(bad)
        with pytest.raises(ValueError, match="topo spec"):
            ref_parse_topo_spec(bad)

    def test_from_env_roundtrip(self, monkeypatch):
        monkeypatch.setenv("HVD_TPU_TOPO_SPEC", "2x4")
        monkeypatch.setenv("HVD_TPU_TOPO_SCHEDULE", "hierarchical")
        monkeypatch.setenv("HVD_TPU_TOPO_KERNEL", "pallas")
        monkeypatch.setenv("HVD_TPU_TOPO_COST_FREEZE", "1")
        monkeypatch.setenv("HVD_TPU_TOPO_ALPHA_DCN_US", "55.5")
        monkeypatch.setenv("HVD_TPU_TOPO_BETA_DCN_GBPS", "2.5")
        monkeypatch.setenv("HOROVOD_HIERARCHICAL_ALLREDUCE", "1")
        monkeypatch.setenv("HVD_TPU_HIERARCHICAL_INNER", "2")
        cfg = Config.from_env()
        assert cfg.topo_spec == "2x4"
        assert cfg.topo_schedule == "hierarchical"
        assert cfg.topo_kernel == "pallas"
        assert cfg.topo_cost_freeze is True
        assert cfg.topo_alpha_dcn_us == 55.5
        assert cfg.topo_beta_dcn_gbps == 2.5
        assert cfg.hierarchical_allreduce is True
        assert cfg.hierarchical_inner_size == 2

    def test_from_env_defaults(self):
        cfg = Config.from_env()
        assert cfg.topo_spec is None
        assert cfg.topo_schedule == "off"
        assert cfg.topo_kernel == "spmd"
        assert cfg.topo_cost_freeze is False
        assert (cfg.hierarchical_allreduce, cfg.hierarchical_allgather,
                cfg.hierarchical_inner_size) == (False, False, 0)

    def test_from_env_rejects_malformed_spec(self, monkeypatch):
        """A typo'd topology fails at init, not silently flat."""
        monkeypatch.setenv("HVD_TPU_TOPO_SPEC", "4by8")
        with pytest.raises(ValueError, match="topo spec"):
            Config.from_env()

    @pytest.mark.parametrize("knob,bad", [("TOPO_SCHEDULE", "ring"),
                                          ("TOPO_KERNEL", "triton")])
    def test_from_env_rejects_unknown_choice(self, monkeypatch, knob, bad):
        monkeypatch.setenv(f"HVD_TPU_{knob}", bad)
        with pytest.raises(ValueError, match="unknown value"):
            Config.from_env()


class TestMeshTopology:
    def test_tier_groups_2x4(self):
        topo = MeshTopology(pods=2, chips_per_pod=4)
        assert topo.intra_pod_groups() == [[0, 1, 2, 3], [4, 5, 6, 7]]
        assert topo.cross_pod_groups() == [[0, 4], [1, 5], [2, 6], [3, 7]]

    @pytest.mark.parametrize("pods,chips", [(2, 4), (4, 2), (1, 8), (8, 1),
                                            (2, 2), (3, 5)])
    def test_groups_are_full_partitions_in_the_reference_order(self, pods,
                                                              chips):
        topo = MeshTopology(pods=pods, chips_per_pod=chips)
        ref = jt.MeshTopology(pods=pods, chips_per_pod=chips)
        assert topo.intra_pod_groups() == ref.intra_pod_groups()
        assert topo.cross_pod_groups() == ref.cross_pod_groups()
        for groups in (topo.intra_pod_groups(), topo.cross_pod_groups()):
            assert sorted(r for g in groups for r in g) \
                == list(range(topo.size))
        assert (topo.two_tier, topo.describe()) \
            == (ref.two_tier, ref.describe())

    def test_rank_coordinates(self):
        topo = MeshTopology(pods=2, chips_per_pod=4)
        assert [topo.pod_of(r) for r in range(8)] == [0] * 4 + [1] * 4
        assert [topo.chip_of(r) for r in range(8)] == [0, 1, 2, 3] * 2

    def test_two_tier_predicate(self):
        assert MeshTopology(2, 4).two_tier
        assert not MeshTopology(1, 8).two_tier
        assert not MeshTopology(8, 1).two_tier

    @pytest.mark.parametrize("pods,chips", [(0, 4), (4, 0), (-1, 2)])
    def test_rejects_degenerate_factors(self, pods, chips):
        with pytest.raises(ValueError, match=">= 1"):
            MeshTopology(pods=pods, chips_per_pod=chips)


class TestInferTopology:
    """``infer_topology(nodes)`` takes each rank's node, where the
    reference takes each device's slice (or process) index."""

    @pytest.mark.parametrize("nodes,want", [
        ([0, 0, 0, 0, 1, 1, 1, 1], (2, 4)),     # uniform contiguous runs
        ([0, 0, 1, 1, 2, 2, 3, 3], (4, 2)),
        ([0, 0, 0, 1, 1, 1, 1, 1], (1, 8)),     # irregular runs: flat
        ([0, 0, 1, 1, 0, 0, 1, 1], (1, 8)),     # a node reappears: flat
        (list(range(8)), (1, 8)),               # one rank a node: flat
        ([0], (1, 1)),
    ])
    def test_equals_reference(self, nodes, want):
        from types import SimpleNamespace

        got = infer_topology(nodes)
        ref = jt.infer_topology([SimpleNamespace(process_index=s)
                                 for s in nodes])
        assert (got.pods, got.chips_per_pod) == want \
            == (ref.pods, ref.chips_per_pod)

    def test_session_layout(self, world):
        """From the session: ``LOCAL_WORLD_SIZE=2`` on four ranks is two
        nodes of two (torchrun's node-major ranks); without it, one node;
        the tiers' process sets are registered once and found again; the
        tier groups have two ranks each; a world of several processes
        keeps the estimator's priors."""
        two = world.run("topo_world", env={"LOCAL_WORLD_SIZE": "2"})
        one = world.run("topo_world", env={"HVD_TPU_TOPO_SPEC": "2x2"})
        for r in range(N):
            assert two[r]["inferred"] == (2, 2) == two[r]["configured"]
            assert two[r]["sets"] == ([[0, 1], [2, 3]], [[0, 2], [1, 3]])
            assert two[r]["found"] and two[r]["prior_kept"]
            assert two[r]["group_sizes"] == (2, 2)
            assert one[r]["inferred"] == (1, 4)
            assert one[r]["configured"] == (2, 2)


class TestResolveTopology:
    def test_declared_spec_wins(self):
        topo = resolve_topology(8, "2x4")
        assert (topo.pods, topo.chips_per_pod) == (2, 4)

    def test_spec_must_factor_world(self):
        with pytest.raises(ValueError, match="8 slots"):
            resolve_topology(6, "2x4")

    def test_subworld_without_spec_stays_flat(self, solo):
        """Inference sees the whole world; a reduction of another width
        must not inherit its pods."""
        topo = resolve_topology(4)
        assert (topo.pods, topo.chips_per_pod) == (1, 4)

    def test_config_topology_bad_spec_falls_back_flat(self, solo, caplog,
                                                      monkeypatch):
        """A config-driven step runs flat on a spec that does not factor
        its width, with one warning however many steps resolve it."""
        from horovod_tpu_torch.topo import topology

        monkeypatch.setattr(topology, "_warned_specs", set())
        with _config(topo_spec="3x3"):  # 9 != 8
            with caplog.at_level(logging.WARNING):
                topo = config_topology(8)
                config_topology(8)
        assert (topo.pods, topo.chips_per_pod) == (1, 8)
        assert caplog.text.count("running flat") == 1


# --- cost model oracles ------------------------------------------------------

class TestCostModelOracles:
    @pytest.mark.parametrize("pods,chips", TOPOS)
    @pytest.mark.parametrize("p", PARAM_GRID)
    def test_costs_equal_reference(self, pods, chips, p):
        topo, rtopo = MeshTopology(pods, chips), jt.MeshTopology(pods, chips)
        params, rparams = _port_params(p), _ref_params(p)
        assert hierarchical_crossover_bytes(topo, params) \
            == jc.hierarchical_crossover_bytes(rtopo, rparams)
        for b in [0, 1, 989, 1 << 10, 1 << 20, 3 << 24, 1 << 30]:
            for n in (1, 2, 5):
                assert tier_phase_cost_us(b, n, params.dcn) \
                    == jc.tier_phase_cost_us(b, n, rparams.dcn)
            assert flat_cost_us(b, topo, params) \
                == jc.flat_cost_us(b, rtopo, rparams)
            assert hierarchical_cost_us(b, topo, params) \
                == jc.hierarchical_cost_us(b, rtopo, rparams)
            assert hierarchical_phase_costs_us(b, topo, params) \
                == jc.hierarchical_phase_costs_us(b, rtopo, rparams)

    def test_phase_cost_closed_form(self):
        got = tier_phase_cost_us(1e6, 4, TierParams(10.0, 100.0))
        assert got == pytest.approx(3 * (10.0 + 2.5))

    def test_phase_cost_single_participant_is_free(self):
        assert tier_phase_cost_us(1e9, 1, TierParams(10.0, 100.0)) == 0.0

    def test_flat_cost_single_pod(self):
        topo = MeshTopology(1, 8)
        want = 2.0 * tier_phase_cost_us(1e6, 8, PARAMS.ici)
        assert flat_cost_us(1e6, topo, PARAMS) == pytest.approx(want)

    def test_flat_cost_multi_pod_uses_dcn_bandwidth(self):
        b, n = 8e6, TOPO24.size
        want = 2.0 * (n - 1) * (10.0 + (b / n) / 1e4)
        assert flat_cost_us(b, TOPO24, PARAMS) == pytest.approx(want)

    def test_hierarchical_cost_is_sum_of_phases(self):
        b = 8e6
        want = (2.0 * tier_phase_cost_us(b, 4, PARAMS.ici)
                + 2.0 * tier_phase_cost_us(b / 4, 2, PARAMS.dcn))
        assert hierarchical_cost_us(b, TOPO24, PARAMS) \
            == pytest.approx(want)
        phases = hierarchical_phase_costs_us(b, TOPO24, PARAMS)
        assert phases["rs_intra"] + phases["xpod"] + phases["ag_intra"] \
            == pytest.approx(want)
        assert phases["rs_intra"] == phases["ag_intra"]

    def test_one_tier_mesh_has_no_hierarchy(self):
        topo = MeshTopology(1, 8)
        assert hierarchical_cost_us(1e6, topo, PARAMS) \
            == flat_cost_us(1e6, topo, PARAMS)
        assert hierarchical_crossover_bytes(topo, PARAMS) == 1 << 62

    def test_crossover_is_the_exact_decision_boundary(self):
        xb = hierarchical_crossover_bytes(TOPO24, PARAMS)
        assert 0 < xb < 1 << 62
        assert choose_algo(xb, TOPO24, PARAMS) == ALGO_HIERARCHICAL
        assert choose_algo(xb - 1, TOPO24, PARAMS) != ALGO_HIERARCHICAL
        assert hierarchical_cost_us(xb, TOPO24, PARAMS) \
            < flat_cost_us(xb, TOPO24, PARAMS)
        assert hierarchical_cost_us(xb - 1, TOPO24, PARAMS) \
            >= flat_cost_us(xb - 1, TOPO24, PARAMS)

    def test_tiny_bucket_stays_flat_huge_goes_hierarchical(self):
        assert choose_algo(1 << 10, TOPO24, PARAMS) == ALGO_FLAT
        assert choose_algo(64 << 20, TOPO24, PARAMS) == ALGO_HIERARCHICAL

    def test_crossover_zero_when_hierarchy_wins_on_latency(self):
        params = TopoCostParams(ici=TierParams(10.0, 100.0),
                                dcn=TierParams(5.0, 10.0))
        assert hierarchical_crossover_bytes(TOPO24, params) == 0
        assert choose_algo(1, TOPO24, params) == ALGO_HIERARCHICAL

    def test_crossover_unreachable_when_dcn_not_bottleneck(self):
        params = TopoCostParams(ici=TierParams(10.0, 100.0),
                                dcn=TierParams(100.0, 100.0))
        assert hierarchical_crossover_bytes(TOPO24, params) == 1 << 62
        assert choose_algo(1 << 30, TOPO24, params) != ALGO_HIERARCHICAL

    def test_crossover_declines_inverted_tiers(self):
        params = TopoCostParams(ici=TierParams(10.0, 10.0),
                                dcn=TierParams(5.0, 100.0))
        assert hierarchical_crossover_bytes(TOPO24, params) == 1 << 62
        assert choose_algo(1, TOPO24, params) == ALGO_HIERARCHICAL
        assert choose_algo(1 << 30, TOPO24, params) != ALGO_HIERARCHICAL

    def test_two_phase_on_single_pod_mesh(self):
        topo = MeshTopology(1, 8)
        assert choose_algo(16 << 20, topo, PARAMS) == ALGO_TWO_PHASE
        assert choose_algo(1 << 20, topo, PARAMS) == ALGO_FLAT

    def test_default_params_come_from_live_config(self, solo):
        with _config(cost_alpha_us=7.0, cost_beta_gbps=70.0,
                     topo_alpha_dcn_us=77.0, topo_beta_dcn_gbps=7.7):
            p = default_params()
        assert (p.ici.alpha_us, p.ici.beta_gbps) == (7.0, 70.0)
        assert (p.dcn.alpha_us, p.dcn.beta_gbps) == (77.0, 7.7)

    def test_default_params_before_init_equal_reference_fallback(self):
        """Uninitialised, both packages fall back to the flat defaults
        and ten times worse between pods."""
        p = default_params()
        assert (p.ici.alpha_us, p.ici.beta_gbps) == (10.0, 100.0)
        assert (p.dcn.alpha_us, p.dcn.beta_gbps) == (100.0, 10.0)


# --- schedule compiler -------------------------------------------------------

class TestScheduleCompiler:
    @pytest.mark.parametrize("pods,chips", TOPOS)
    @pytest.mark.parametrize("p", PARAM_GRID)
    def test_ir_equals_reference(self, pods, chips, p):
        """The IR of every swept size, forced algorithm and kernel equals
        the reference's ``compile_bucket_schedule``, field by field."""
        topo, rtopo = MeshTopology(pods, chips), jt.MeshTopology(pods, chips)
        params, rparams = _port_params(p), _ref_params(p)
        sizes = [0, 1, 148, 424, 1 << 10, 4000, 1 << 20, 1 << 26, 1 << 30]
        xb = hierarchical_crossover_bytes(topo, params)
        if 0 < xb < 1 << 62:
            sizes += [xb - 1, xb, xb + 1]
        for b in sizes:
            for force in (None, ALGO_FLAT, ALGO_TWO_PHASE,
                          ALGO_HIERARCHICAL):
                for kernel in ("spmd", "pallas"):
                    got = compile_bucket_schedule(b, topo, params,
                                                  force=force, kernel=kernel)
                    want = js.compile_bucket_schedule(
                        b, rtopo, rparams, force=force, kernel=kernel)
                    assert _ir(got) == _ir(want), (b, force, kernel)

    def test_hierarchical_ir_structure(self):
        b = 64 << 20
        sched = compile_bucket_schedule(b, TOPO24, PARAMS)
        assert sched.algo == ALGO_HIERARCHICAL
        assert [s.op for s in sched.steps] == ["rs", "ar", "ag"]
        assert [s.tier for s in sched.steps] == ["ici", "dcn", "ici"]
        intra = tuple(tuple(g) for g in TOPO24.intra_pod_groups())
        cross = tuple(tuple(g) for g in TOPO24.cross_pod_groups())
        assert sched.steps[0].groups == intra == sched.steps[2].groups
        assert sched.steps[1].groups == cross
        assert [s.payload_bytes for s in sched.steps] == [b, b // 4, b]
        assert sched.est_cost_us \
            == pytest.approx(hierarchical_cost_us(b, TOPO24, PARAMS))
        assert sched.tier_bytes() == {"ici": 2 * b, "dcn": b // 4}

    def test_flat_ir_structure(self):
        sched = compile_bucket_schedule(1 << 10, TOPO24, PARAMS)
        assert sched.algo == ALGO_FLAT and len(sched.steps) == 1
        assert sched.steps[0].tier == "dcn"
        assert sched.steps[0].groups is None
        one_pod = compile_bucket_schedule(1 << 10, MeshTopology(1, 8),
                                          PARAMS)
        assert one_pod.steps[0].tier == "ici"

    def test_two_phase_ir_structure(self):
        sched = compile_bucket_schedule(16 << 20, MeshTopology(1, 8),
                                        PARAMS)
        assert sched.algo == ALGO_TWO_PHASE
        assert [s.op for s in sched.steps] == ["rs", "ag"]

    def test_force_pins_algorithm(self):
        sched = compile_bucket_schedule(1 << 10, TOPO24, PARAMS,
                                        force=ALGO_HIERARCHICAL)
        assert sched.algo == ALGO_HIERARCHICAL

    def test_force_hierarchical_demotes_on_one_tier_mesh(self):
        sched = compile_bucket_schedule(64 << 20, MeshTopology(1, 8),
                                        PARAMS, force=ALGO_HIERARCHICAL)
        assert sched.algo == ALGO_FLAT

    def test_rejects_unknown_kernel(self):
        with pytest.raises(ValueError, match="kernel"):
            compile_bucket_schedule(1 << 10, TOPO24, PARAMS, kernel="cuda")

    @pytest.mark.parametrize("comp", COMPS)
    def test_hbm_materializations_equal_reference(self, comp):
        for kernel in ("spmd", "pallas"):
            for force in ALGOS:
                got = compile_bucket_schedule(64 << 20, TOPO24, PARAMS,
                                              force=force, kernel=kernel)
                want = js.compile_bucket_schedule(
                    64 << 20, jt.MeshTopology(2, 4), _ref_params(
                        ((10.0, 100.0), (100.0, 10.0))),
                    force=force, kernel=kernel)
                assert got.hbm_materializations(
                    getattr(thvd.Compression, comp)) \
                    == want.hbm_materializations(
                        getattr(JaxCompression, comp))

    def test_compiler_caches_by_payload(self):
        comp = ScheduleCompiler(TOPO24, PARAMS)
        assert comp.compile(1 << 20) is comp.compile(1 << 20)
        assert comp.compile(1 << 20) is not comp.compile(1 << 21)

    def test_schedule_is_rank_invariant(self, world):
        """Every rank compiles the same IR, the reference's."""
        sizes = [1, 1 << 10, 1 << 20, 64 << 20]
        out = world.run("topo_schedule_ir", nbytes=sizes, pods=2, chips=2)
        want = [dataclasses.astuple(js.compile_bucket_schedule(
            b, jt.MeshTopology(2, 2), _ref_params(PARAM_GRID[0])))
            for b in sizes]
        for r in range(N):
            assert out[r] == out[0]
        assert [tuple(ir) for ir in out[0]] == want

    def test_maybe_compiler_gating(self, solo):
        with _config(topo_schedule="off", topo_spec="2x4"):
            assert maybe_compiler(8) is None
        with _config(topo_schedule="auto", topo_spec="2x4"):
            assert maybe_compiler(8, groups=object()) is None
            assert maybe_compiler(1) is None
            comp = maybe_compiler(8)
        assert comp is not None
        assert (comp.topo.pods, comp.topo.chips_per_pod) == (2, 4)
        assert comp.force is None and comp.kernel == "spmd"
        with _config(topo_schedule="two_phase", topo_spec="2x4",
                     topo_kernel="pallas"):
            comp = maybe_compiler(8)
        assert (comp.force, comp.kernel) == (ALGO_TWO_PHASE, "pallas")

    def test_maybe_compiler_explicit_mode_pins(self, solo):
        with _config(topo_spec="2x4"):
            comp = maybe_compiler(8, mode="hierarchical")
        assert comp is not None and comp.force == ALGO_HIERARCHICAL

    def test_maybe_compiler_spec_world_mismatch_degrades_flat(self, solo):
        with _config(topo_schedule="auto", topo_spec="2x4"):
            comp = maybe_compiler(4)
        assert comp is not None and not comp.topo.two_tier
        assert comp.compile(64 << 20).algo != ALGO_HIERARCHICAL

    def test_explicit_schedule_with_groups_falls_back_flat(self, world):
        """A compiler handed to a process-set reduction runs the grouped
        flat wire, not a sum across the sets."""
        per_rank = [[np.full(64, float(r), np.float32)] for r in range(N)]
        out = world.run("topo_fused", op="sum", compression="none",
                        threshold=1 << 20, params=None,
                        force=ALGO_HIERARCHICAL, pods=2, chips=2,
                        sets=[[0, 1], [2, 3]],
                        per_rank=[{"leaves": per_rank[r]} for r in range(N)])
        for r in range(N):
            np.testing.assert_array_equal(out[r]["got"][0],
                                          np.full(64, 1.0 if r < 2 else 5.0))

    def test_explicit_schedule_width_mismatch_falls_back(self, world):
        per_rank = [[np.ones(64, np.float32)] for _ in range(N)]
        out = world.run("topo_fused", op="sum", compression="none",
                        threshold=1 << 20, params=None,
                        force=ALGO_HIERARCHICAL, pods=2, chips=4,
                        per_rank=[{"leaves": per_rank[r]} for r in range(N)])
        for r in range(N):
            np.testing.assert_array_equal(out[r]["got"][0], np.full(64, 4.0))


# --- online estimator --------------------------------------------------------

class TestOnlineEstimator:
    def _fresh(self, decay=0.5):
        est = OnlineEstimator(prior=PARAMS, decay=decay)
        est.freeze(False)
        return est

    def test_first_sample_sets_then_ewma(self):
        est = self._fresh()
        est.observe("dcn", nbytes=1e6, elapsed_us=1e3)
        assert est.params().dcn.beta_gbps == pytest.approx(1.0)
        est.observe("dcn", nbytes=3e6, elapsed_us=1e3)
        assert est.params().dcn.beta_gbps == pytest.approx(2.0)

    def test_equals_reference_on_the_same_samples(self):
        """The same sequence of samples gives the same floats."""
        est = self._fresh(decay=0.3)
        ref = jc.OnlineEstimator(prior=_ref_params(
            ((10.0, 100.0), (100.0, 10.0))), decay=0.3)
        ref.freeze(False)
        rng = np.random.RandomState(0)
        for _ in range(20):
            tier = ("ici", "dcn")[rng.randint(2)]
            b, us = float(rng.uniform(1e3, 1e8)), float(rng.uniform(1, 1e4))
            est.observe(tier, b, us)
            ref.observe(tier, b, us)
        est.observe_alpha("ici", 30.0, 3)
        ref.observe_alpha("ici", 30.0, 3)
        est.note_plan({"ici": 8e6, "dcn": 2e6})
        ref.note_plan({"ici": 8e6, "dcn": 2e6})
        est.refine_from_step(1e-3)
        ref.refine_from_step(1e-3)
        got, want = est.params(), ref.params()
        for tier in ("ici", "dcn"):
            assert dataclasses.astuple(got.tier(tier)) \
                == dataclasses.astuple(want.tier(tier))
        assert est.samples == ref.samples

    def test_converges_on_synthetic_pure_wire_signal(self):
        est = self._fresh(decay=0.3)
        est.observe("dcn", nbytes=1e6, elapsed_us=1e3)
        errors = []
        for _ in range(30):
            est.observe("dcn", nbytes=5e6, elapsed_us=1e3)
            errors.append(abs(est.params().dcn.beta_gbps - 5.0))
        assert errors[-1] < 1e-3
        assert all(b < a + 1e-12 for a, b in zip(errors, errors[1:]))

    def test_untouched_tier_keeps_prior(self):
        est = self._fresh()
        est.observe("dcn", nbytes=1e6, elapsed_us=1e3)
        p = est.params()
        assert p.ici == PARAMS.ici
        assert p.dcn.alpha_us == PARAMS.dcn.alpha_us

    def test_observe_alpha(self):
        est = self._fresh()
        est.observe_alpha("ici", elapsed_us=30.0, hops=3)
        assert est.params().ici.alpha_us == pytest.approx(10.0)

    def test_refine_from_step_uses_noted_plan(self):
        est = self._fresh()
        est.note_plan({"ici": 8e6, "dcn": 2e6})
        est.refine_from_step(1e-3)
        p = est.params()
        assert p.ici.beta_gbps == pytest.approx(8.0)
        assert p.dcn.beta_gbps == pytest.approx(2.0)

    def test_refine_without_plan_is_noop(self):
        est = self._fresh()
        est.refine_from_step(1e-3)
        assert est.samples == 0

    def test_freeze_stops_refinement(self):
        est = self._fresh()
        est.freeze()
        est.observe("dcn", nbytes=1e6, elapsed_us=1e3)
        assert est.samples == 0
        assert est.params().dcn == PARAMS.dcn

    def test_config_freeze_knob(self, solo):
        est = OnlineEstimator(prior=PARAMS)
        with _config(topo_cost_freeze=True):
            assert est.frozen()
            est.observe("dcn", nbytes=1e6, elapsed_us=1e3)
        assert est.samples == 0

    def test_effective_params_prior_until_every_tier_sampled(self):
        est = self._fresh()
        assert est.effective_params() is est.prior
        est.observe("dcn", nbytes=5e6, elapsed_us=1e3)
        assert est.effective_params() is est.prior
        est.observe("ici", nbytes=5e7, elapsed_us=1e3)
        eff = est.effective_params()   # one process: refined values flow
        assert eff.dcn.beta_gbps == pytest.approx(5.0)
        assert eff.ici.beta_gbps == pytest.approx(50.0)

    def test_process_estimator_singleton_and_reset(self):
        reset_estimator()
        try:
            assert process_estimator() is process_estimator()
        finally:
            reset_estimator()


class TestRecordPlans:
    """The estimator half of ``record_plans`` (the reference also
    publishes the record as metrics, which wait for the port's
    observability layer): the record's numbers, and the note the
    estimator refines from."""

    def test_records_tiers_algos_and_estimator_note(self):
        reset_estimator()
        try:
            b = 64 << 20
            hier = compile_bucket_schedule(b, TOPO24, PARAMS,
                                           force=ALGO_HIERARCHICAL)
            flat = compile_bucket_schedule(1 << 10, TOPO24, PARAMS,
                                           force=ALGO_FLAT)
            rec = record_plans([hier, flat], thvd.Compression.none, 4,
                               params=PARAMS)
            assert rec["algos"] == {"hierarchical": 1, "flat": 1}
            assert rec["kernels"] == {"spmd": 2}
            assert rec["tier_bytes"] == {"ici": 2 * b,
                                         "dcn": b // 4 + (1 << 10)}
            phase = hierarchical_phase_costs_us(b, TOPO24, PARAMS)
            assert rec["est_cost_us"] == {
                "ici": phase["rs_intra"] + phase["ag_intra"],
                "dcn": phase["xpod"] + flat.est_cost_us}
            est = process_estimator()
            est.freeze(False)
            est.refine_from_step(1e-3)
            assert est.samples == 2
        finally:
            reset_estimator()

    def test_compressed_wire_scales_bytes(self):
        reset_estimator()
        try:
            b = 1 << 20
            hier = compile_bucket_schedule(b, TOPO24, PARAMS,
                                           force=ALGO_HIERARCHICAL)
            rec = record_plans([hier], thvd.Compression.fp16, 4)
            assert rec["tier_bytes"]["dcn"] == (b // 4) // 2
            rec = record_plans([hier], thvd.Compression.int8, 4)
            assert rec["tier_bytes"]["dcn"] == (b // 4) // 4
            assert rec["hbm_materializations"] == 8
        finally:
            reset_estimator()

    def test_no_schedules_records_nothing(self):
        assert record_plans([], thvd.Compression.none, 4) == {}


# --- the simulated mesh and the equivalence oracle ---------------------------

def _int_stack(rng, elems=257, lo=-8, hi=9):
    """Small-integer f32 rows: every partial sum exact in every order."""
    return rng.integers(lo, hi, size=(N, elems)).astype(np.float32)


def _int8_grid_stack(rng, elems=256):
    """Rows constant on the ``127·2^k`` grid: the int8 wire is exact at
    every stage of every path."""
    k = rng.integers(0, 3, size=(N, 1)).astype(np.float32)
    return np.broadcast_to(127.0 * (2.0 ** k), (N, elems)) \
        .astype(np.float32).copy()


def _allreduce(stack, algo, **kw):
    return dict(kind="allreduce", stack=stack, algo=algo,
                **{"pods": 2, "chips": 2, **kw})


class TestSimulatedMesh:
    def test_world_of_one_and_nonfactoring(self, solo):
        assert simulate.simulated_mesh().topo.size == 1
        with pytest.raises(ValueError, match="factor"):
            simulate.simulated_mesh(3, 3)

    def test_rejects_wrong_stack_width(self, solo):
        sim = simulate.simulated_mesh(1, 1)
        with pytest.raises(ValueError, match="rows"):
            simulate.run_allreduce(sim, np.ones((4, 8), np.float32))

    def test_default_and_partial_factorings_on_the_world(self, world):
        out = world.run("topo_world", env={})
        for r in range(N):
            assert out[r]["simulated"] == (2, 2)        # the default
            assert out[r]["simulated_chips_1"] == (4, 1)

    def test_cost_oracle_rows_equal_reference(self):
        sizes = [1 << s for s in range(10, 27)]
        assert simulate.cost_oracle_rows(sizes, TOPO24, PARAMS) \
            == jsim.cost_oracle_rows(sizes, jt.MeshTopology(2, 4),
                                     _ref_params(((10.0, 100.0),
                                                  (100.0, 10.0))))


class TestEquivalenceOracle:
    """On the 2×2 world the hierarchical and two-phase schedules are bit
    for bit the flat allreduce on exact data, every wire."""

    def test_every_wire_on_exact_data(self, world):
        rng = np.random.default_rng(7)
        stack = _int_stack(rng)
        grid = _int8_grid_stack(np.random.default_rng(3))
        cases = []
        for comp in ("none", "fp16", "bf16"):
            for op in ("sum", "average"):
                cases += [_allreduce(stack, a, op=op, compression=comp)
                          for a in ALGOS]
        for op in ("sum", "average"):
            cases += [_allreduce(grid, a, op=op, compression="int8")
                      for a in ALGOS]
        res = _same_on_every_rank(world.run("topo_runs", cases=cases))
        for i in range(0, len(cases), 3):
            flat = res[i]
            data = cases[i]["stack"]
            want = data.sum(0) if cases[i]["op"] == "sum" else data.mean(0)
            np.testing.assert_array_equal(flat, np.broadcast_to(want,
                                                                flat.shape))
            for j in (1, 2):
                np.testing.assert_array_equal(_bits(res[i + j]),
                                              _bits(flat), str(cases[i + j]
                                                               ["algo"]))

    def test_int8_error_feedback_wire_exact_on_grid(self):
        """On the grid the EF residual is zero on every rank, so the EF
        wire is the int8 wire there (the equality above holds with it)."""
        from horovod_tpu_torch.ops.quantization import quant_dequant

        stack = _int8_grid_stack(np.random.default_rng(5))
        for row in stack:
            t = torch.from_numpy(row)
            assert torch.equal(t - quant_dequant(t), torch.zeros_like(t))

    def test_random_data_tolerance_and_roundtrip(self, world):
        rng = np.random.default_rng(0)
        stack = rng.standard_normal((N, 257)).astype(np.float32)
        ints = _int_stack(np.random.default_rng(17))
        grid = _int8_grid_stack(np.random.default_rng(19))
        res = _same_on_every_rank(world.run("topo_runs", cases=[
            _allreduce(stack, ALGO_FLAT), _allreduce(stack, ALGO_HIERARCHICAL),
            _allreduce(ints, ALGO_FLAT),
            dict(kind="roundtrip", stack=ints, pods=2, chips=2),
            _allreduce(grid, ALGO_FLAT, compression="int8"),
            dict(kind="roundtrip", stack=grid, pods=2, chips=2,
                 compression="int8"),
            _allreduce(ints, ALGO_HIERARCHICAL, pods=4, chips=1),
            _allreduce(ints, ALGO_HIERARCHICAL, pods=1, chips=4)]))
        np.testing.assert_allclose(res[1], res[0], rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(res[3]["full"], res[2])
        np.testing.assert_array_equal(res[5]["full"], res[4])
        np.testing.assert_array_equal(res[6], res[2])    # demoted: flat
        np.testing.assert_array_equal(res[7], res[2])


# --- execution against the reference ------------------------------------------

def _reference(fn, stack, n_out):
    """``fn(row)`` on each of the first four CPU devices in a shard_map,
    slot ``i`` on row ``i``; the ``n_out`` results stacked over slots.
    Compiled at backend optimization level 0 (ROADMAP R1)."""
    mesh = Mesh(np.array(jax.devices()[:N]), ("hvd",))

    def body(xb):
        return tuple(r[None] for r in fn(xb[0]))

    program = jax.jit(shard_map(body, mesh=mesh, in_specs=P("hvd"),
                                out_specs=tuple(P("hvd")
                                                for _ in range(n_out)),
                                check=False))
    x = jnp.asarray(stack)
    out = program.lower(x).compile(
        compiler_options={"xla_backend_optimization_level": 0})(x)
    return [np.asarray(o) for o in out]


REF_TOPO = jt.MeshTopology(2, 2)


def _ref_cases(stack, comps, ops):
    """The reference's execute_schedule for every (comp, algo, op), and
    its hierarchical reduce-scatter shard and round trip a comp."""
    elems = stack.shape[1]
    nbytes = elems * 4

    def fn(x):
        outs = []
        for comp in comps:
            jcomp = getattr(JaxCompression, comp)
            for op in ops:
                for algo in ALGOS:
                    sched = js.compile_bucket_schedule(
                        nbytes, REF_TOPO, _ref_params(MIXED), force=algo)
                    outs.append(js.execute_schedule(
                        x, sched, axis="hvd", op=op,
                        compression=jcomp).astype(x.dtype))
            sched = js.compile_bucket_schedule(nbytes, REF_TOPO,
                                               force=ALGO_HIERARCHICAL)
            pad = (-elems) % N
            xp = jnp.concatenate([x, jnp.zeros((pad,), x.dtype)])
            shard = js.hierarchical_reduce_scatter(
                xp, sched, axis="hvd", op="sum", compression=jcomp)
            full = js.hierarchical_all_gather(shard, sched, axis="hvd",
                                              compression=jcomp)
            outs += [shard, full[:elems]]
        return tuple(outs)

    n_out = len(comps) * (len(ops) * len(ALGOS) + 2)
    return _reference(fn, stack, n_out)


def _port_cases(world, stack, comps, ops):
    cases = []
    for comp in comps:
        for op in ops:
            cases += [_allreduce(stack, a, op=op, compression=comp,
                                 params=MIXED) for a in ALGOS]
        cases.append(dict(kind="roundtrip", stack=stack, pods=2, chips=2,
                          compression=comp))
    res = _same_on_every_rank(world.run("topo_runs", cases=cases))
    flat = []
    for r in res:
        flat += [r["shard"], r["full"]] if isinstance(r, dict) else [r]
    return flat


class TestExecutionAgainstReference:
    def test_exact_data_bitwise(self, world):
        """none/fp16/bf16 on small integers: every algorithm, both ops,
        and the hierarchical reduce-scatter's permuted shards, bit for
        bit the reference's."""
        comps = ["none", "fp16", "bf16"]
        stack = _int_stack(np.random.default_rng(23), elems=301)
        want = _ref_cases(stack, comps, ["sum", "average"])
        got = _port_cases(world, stack, comps, ["sum", "average"])
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape, i
            np.testing.assert_array_equal(_bits(g), _bits(w), str(i))

    def test_int8_bitwise_on_random_data(self, world):
        """The int8 wire on random data over decades of magnitude: the
        quantization of each tier's blocks (the tier's width sets the
        block) is the reference's SPMD tier, bit for bit, 5000 elements
        (whole and padded blocks) and 257."""
        rng = np.random.RandomState(29)
        for elems in (5000, 257):
            stack = (rng.randn(N, elems)
                     * 10.0 ** rng.uniform(-2, 1, (N, elems))
                     ).astype(np.float32)
            want = _ref_cases(stack, ["int8"], ["sum", "average"])
            got = _port_cases(world, stack, ["int8"], ["sum", "average"])
            for i, (g, w) in enumerate(zip(got, want)):
                assert g.shape == w.shape, i
                np.testing.assert_array_equal(_bits(g), _bits(w), str(i))

    def test_random_f32_tolerance(self, world):
        stack = np.random.default_rng(31).standard_normal(
            (N, 257)).astype(np.float32)
        want = _ref_cases(stack, ["none"], ["sum", "average"])
        got = _port_cases(world, stack, ["none"], ["sum", "average"])
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


SHAPES = [(37,), (1000,), (), (3, 5, 7)]


def _leaves(seed):
    rng = np.random.RandomState(seed)
    return [[(rng.randn(*s) * 10.0 ** rng.uniform(-2, 1, s)).astype(np.float32)
             for s in SHAPES] for _ in range(N)]


def _ref_leaves(fn, per_rank, n_out):
    """``fn(leaves)`` a slot in a shard_map over four devices."""
    mesh = Mesh(np.array(jax.devices()[:N]), ("hvd",))
    stacked = [jnp.asarray(np.stack([per_rank[r][i] for r in range(N)]))
               for i in range(len(per_rank[0]))]

    def body(*xs):
        return tuple(r[None] for r in fn([x[0] for x in xs]))

    program = jax.jit(shard_map(
        body, mesh=mesh, in_specs=tuple(P("hvd") for _ in stacked),
        out_specs=tuple(P("hvd") for _ in range(n_out)), check=False))
    out = program.lower(*stacked).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*stacked)
    return [np.asarray(o) for o in out]


class TestFusionAgainstReference:
    """``fused_two_phase_apply(schedule=)`` and the overlap wire's
    ``topo=`` against the reference's on the same leaves."""

    @pytest.mark.parametrize("comp,op", [("int8", "average"),
                                         ("int8", "sum"),
                                         ("none", "sum")])
    def test_fused_two_phase_with_schedule(self, world, comp, op):
        """A compiler whose per-bucket choice is flat (148 bytes),
        two-phase (424) and hierarchical (4000 bytes): the int8 wire bit
        for bit the reference's, the exact wire within f32 tolerance."""
        per_rank = _leaves(seed=41)
        out = world.run("topo_fused", op=op, compression=comp,
                        threshold=512, params=MIXED, force=None, pods=2,
                        chips=2,
                        per_rank=[{"leaves": per_rank[r]} for r in range(N)])
        assert out[0]["algos"] == [ALGO_FLAT, ALGO_HIERARCHICAL,
                                   ALGO_TWO_PHASE]
        compiler = js.ScheduleCompiler(REF_TOPO, _ref_params(MIXED))
        ref = _ref_leaves(lambda ls: jf.fused_two_phase_apply(
            ls, axis="hvd", op=op, groups=None,
            compression=getattr(JaxCompression, comp), threshold=512,
            pipeline_depth=2, alpha_us=10.0, beta_gbps=100.0,
            schedule=compiler), per_rank, len(SHAPES))
        for r in range(N):
            for got, want in zip(out[r]["got"], ref):
                assert got.shape == want[r].shape
                if comp == "int8":
                    np.testing.assert_array_equal(_bits(got), _bits(want[r]))
                else:
                    np.testing.assert_allclose(got, want[r], rtol=1e-5,
                                               atol=1e-6)

    @pytest.mark.parametrize("comp", ["int8", "none"])
    def test_overlap_wire_with_topo(self, world, comp):
        """Three microbatches through the overlap wire with a 2×2
        compiler that makes every bucket hierarchical: the permuted
        shards and the gathered result equal the reference's (int8 bit
        for bit), and the gathered result equals the flat overlap wire's
        on the exact wire within f32 tolerance."""
        mbs = [_leaves(seed=50 + i) for i in range(3)]
        out = world.run("topo_overlap", op="average", compression=comp,
                        threshold=256, params=PARAM_GRID[0],
                        force=ALGO_HIERARCHICAL,
                        per_rank=[{"microbatches": [m[r] for m in mbs]}
                                  for r in range(N)])
        assert all(out[0]["hierarchical"])
        jcomp = getattr(JaxCompression, comp)
        k = len(SHAPES)
        compiler = js.ScheduleCompiler(REF_TOPO, _ref_params(PARAM_GRID[0]),
                                       force=ALGO_HIERARCHICAL)

        def wire(flat):
            per_mb = [flat[i * k:(i + 1) * k] for i in range(len(mbs))]
            plan = jf.plan_overlap_buckets(per_mb[0], 256, world_size=N)
            acc = jf.zero_overlap_shards(plan)
            for leaves in per_mb:
                shards = jf.overlap_reduce_scatter(
                    leaves, plan, axis="hvd", op="average", groups=None,
                    compression=jcomp, topo=compiler)
                acc = tuple(a + s for a, s in zip(acc, shards))
            full = jf.overlap_all_gather(acc, plan, per_mb[0], axis="hvd",
                                         groups=None, compression=jcomp,
                                         topo=compiler)
            return tuple(full) + acc

        per_rank = [[v for m in mbs for v in m[r]] for r in range(N)]
        ref = _ref_leaves(wire, per_rank, k + len(out[0]["topo"]["shards"]))
        for r in range(N):
            got = out[r]["topo"]["full"] + out[r]["topo"]["shards"]
            for g, w in zip(got, ref):
                if comp == "int8":
                    np.testing.assert_array_equal(_bits(g), _bits(w[r]))
                else:
                    np.testing.assert_allclose(g, w[r], rtol=1e-5, atol=1e-6)
            if comp == "none":
                for g, f in zip(out[r]["topo"]["full"],
                                out[r]["flat"]["full"]):
                    np.testing.assert_allclose(g, f, rtol=1e-5, atol=1e-6)


# --- modeled-vs-chosen agreement ---------------------------------------------

class TestModeledVsChosenAgreement:
    def test_compiler_picks_hierarchical_exactly_where_model_wins(self):
        sizes = [1 << s for s in range(10, 27)]
        rows = simulate.cost_oracle_rows(sizes, TOPO24, PARAMS)
        for row in rows:
            model_says_hier = (row["modeled_hierarchical_us"]
                               < row["modeled_flat_us"])
            assert (row["chosen"] == ALGO_HIERARCHICAL) == model_says_hier
        chosen = [r["chosen"] for r in rows]
        assert ALGO_HIERARCHICAL in chosen
        assert chosen[0] != ALGO_HIERARCHICAL
        xb = hierarchical_crossover_bytes(TOPO24, PARAMS)
        for row in rows:
            assert (row["chosen"] == ALGO_HIERARCHICAL) \
                == (row["bytes"] >= xb)

    def test_hierarchical_modeled_busbw_beats_flat_above_crossover(self):
        xb = hierarchical_crossover_bytes(TOPO24, PARAMS)
        for b in (xb, 2 * xb, 16 * xb):
            assert b / hierarchical_cost_us(b, TOPO24, PARAMS) \
                > b / flat_cost_us(b, TOPO24, PARAMS)


# --- train-step integration --------------------------------------------------

def _data(n=64, d=5, seed=0):
    rng = np.random.RandomState(seed)
    w_true = rng.randn(d).astype(np.float32)
    x = rng.randn(n, d).astype(np.float32)
    y = x @ w_true + 0.01 * rng.randn(n).astype(np.float32)
    return x, y


HIER = {"HVD_TPU_TOPO_SPEC": "2x2", "HVD_TPU_TOPO_SCHEDULE": "hierarchical"}


def _assert_close(a, b, **tol):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(np.asarray(a[k], np.float64),
                                   np.asarray(b[k], np.float64), **tol)


class TestTrainStepIntegration:
    """``HVD_TPU_TOPO_SCHEDULE`` routes the step's gradient wire through
    the compiler: the result matches the flat wire's, and the
    hierarchical lowering engaged (its plan noted both tiers)."""

    def _run(self, world, env, **kw):
        x, y = _data()
        return world.run("topo_toy_steps", env=env, x=x, y=y, **kw)

    def test_hierarchical_step_matches_flat(self, world):
        flat = self._run(world, {}, optimizer="adam", lr=0.05, steps=3)
        hier = self._run(world, HIER, optimizer="adam", lr=0.05, steps=3)
        for r in range(N):
            _assert_close(flat[r]["params"], hier[r]["params"], rtol=2e-5,
                          atol=1e-6)
            _assert_close(flat[r]["state"], hier[r]["state"], rtol=2e-5,
                          atol=1e-6)
            assert (flat[r]["noted"], hier[r]["noted"]) == (0, 2)

    def test_auto_mode_runs_and_matches(self, world):
        flat = self._run(world, {}, optimizer="sgd", lr=0.1, steps=3)
        auto = self._run(world, {"HVD_TPU_TOPO_SPEC": "2x2",
                                 "HVD_TPU_TOPO_SCHEDULE": "auto"},
                         optimizer="sgd", lr=0.1, steps=3)
        for r in range(N):
            _assert_close(flat[r]["params"], auto[r]["params"], rtol=2e-5,
                          atol=1e-6)
            assert auto[r]["noted"] == 1   # a 24-byte bucket stays flat

    def test_overlap_microbatch_wire_hierarchical(self, world):
        flat = self._run(world, {}, optimizer="adam", lr=0.05, steps=3)
        hier = self._run(world, HIER, optimizer="adam", lr=0.05, steps=3,
                         microbatches=4, overlap=True)
        for r in range(N):
            _assert_close(flat[r]["params"], hier[r]["params"], rtol=2e-5,
                          atol=1e-6)
            assert hier[r]["noted"] == 2

    def test_int8_error_feedback_wire_hierarchical(self, world):
        exact = self._run(world, {}, optimizer="sgd", lr=0.1, steps=1)
        lossy = self._run(world, {**HIER, "HVD_TPU_ERROR_FEEDBACK": "1"},
                          optimizer="sgd", lr=0.1, steps=1, microbatches=4,
                          overlap=True, compression="int8", wrap=True)
        for r in range(N):
            _assert_close(exact[r]["params"], lossy[r]["params"], rtol=5e-2,
                          atol=5e-2)
            assert lossy[r]["noted"] == 2


# --- telemetry: the hvd_tpu_topo_* metrics and the stage spans ---------------

def _ref_stage_spans(numel, compression, kernel):
    """The reference's stage spans, recorded while its hierarchical
    ``execute_schedule`` and overlap halves are traced (the reference's
    spans fire at trace time), each under a root span, as
    ``workers._span_tree`` lays them out."""
    from horovod_tpu.obs import trace as jtrace

    mesh = Mesh(np.array(jax.devices()[:N]), ("hvd",))
    sched = js.compile_bucket_schedule(numel * 4, REF_TOPO,
                                       force=ALGO_HIERARCHICAL,
                                       kernel=kernel)
    comp = getattr(JaxCompression, compression)

    def allreduce(xb):
        return js.execute_schedule(xb[0], sched, axis="hvd", op="average",
                                   compression=comp)[None]

    def halves(xb):
        shard = js.hierarchical_reduce_scatter(xb[0], sched, axis="hvd",
                                               op="sum", compression=comp)
        return js.hierarchical_all_gather(shard, sched, axis="hvd",
                                          compression=comp)[None]

    jtrace.clear()
    x = jnp.zeros((N, numel), jnp.float32)
    for body in (allreduce, halves):
        with jtrace.span("hvd_tpu_step", root=True):
            jax.jit(shard_map(body, mesh=mesh, in_specs=P("hvd"),
                              out_specs=P("hvd"), check=False)).lower(x)
    spans = jtrace.snapshot()
    jtrace.clear()
    return workers._span_tree(spans)


@pytest.mark.parametrize("compression,kernel", [("int8", "spmd"),
                                                ("none", "pallas")])
def test_stage_spans_and_topo_metrics(world, compression, kernel):
    """Every step's root holds the three stage spans of its hierarchical
    bucket (the reference's fire once, at trace time, under the first
    step's root); the spans of one ``execute_schedule`` and of the
    overlap wire's halves equal the reference's (names, args, parents);
    the build records its plan once (3 steps: one hierarchical schedule,
    one ``two_phase`` fusion record), and the estimator fed by the steps
    publishes both tiers' β."""
    x, y = _data()
    numel = 1024
    out = world.run("topo_obs", x=x, y=y, steps=3, numel=numel,
                    compression=compression, kernel=kernel)
    want = _ref_stage_spans(numel, compression, kernel)
    stages = ["hvd_tpu_topo_rs_intra", "hvd_tpu_topo_xpod",
              "hvd_tpu_topo_ag_intra"]
    for r in range(N):
        o = out[r]
        assert [[name for name, _ in kids] for kids in o["per_step"]] == \
            [stages] * 3
        assert [[list(t) for t in o["schedule"]]] == \
            [[list(t) for t in want]]
        snap = o["snapshot"]

        def value(name, **labels):
            return [row["value"] for row in snap.get(name, [])
                    if row["labels"] == labels]

        assert value("hvd_tpu_topo_schedules_total",
                     algo=ALGO_HIERARCHICAL) == [1.0]
        assert value("hvd_tpu_topo_kernel_schedules_total",
                     kernel="spmd") == [1.0]
        assert value("hvd_tpu_fusion_traces_total", tier="two_phase") == \
            [1.0]
        for tier in ("ici", "dcn"):
            assert value("hvd_tpu_topo_wire_bytes_total", tier=tier)[0] > 0
            assert value("hvd_tpu_topo_cost_beta_gbps", tier=tier)[0] > 0


@pytest.mark.parametrize("comp", COMPS)
def test_record_plans_publishes_as_the_reference(monkeypatch, comp):
    """``record_plans`` of the same compiled schedules (every algorithm, at
    the MIXED point) publishes the reference's ``hvd_tpu_topo_*``
    families and values, and still returns its record."""
    from horovod_tpu.obs import metrics as jmetrics
    from horovod_tpu_torch.obs import metrics

    for mod in (jmetrics, metrics):
        monkeypatch.setattr(mod, "_default", mod.MetricsRegistry())
        monkeypatch.setattr(mod, "_enabled", True)
    topo = MeshTopology(2, 2)
    scheds = [compile_bucket_schedule(b, topo, _port_params(MIXED),
                                      force=algo)
              for algo in ALGOS for b in (4096, 1 << 20)]
    ref = [js.compile_bucket_schedule(b, REF_TOPO, _ref_params(MIXED),
                                      force=algo)
           for algo in ALGOS for b in (4096, 1 << 20)]
    record = record_plans(scheds, getattr(thvd.Compression, comp), 4,
                          params=_port_params(MIXED))
    js.record_plans(ref, getattr(JaxCompression, comp), 4,
                    params=_ref_params(MIXED))
    snap = metrics.registry().snapshot()
    assert snap == jmetrics.registry().snapshot()
    assert record["algos"] == {a: 2 for a in ALGOS}
    assert {row["labels"]["tier"]: row["value"]
            for row in snap["hvd_tpu_topo_wire_bytes_total"]} == \
        record["tier_bytes"]


def test_dcn_fault_site_fires_at_the_cross_pod_stage(world):
    """Mirrors ``TestDcnFaultSite``: the hierarchical schedule's cross-pod
    exchange trips ``dcn`` (partition names the unreachable pods), the
    overlap wire's ``xpod_rs`` stage too, the flat and two-phase wires
    never; a seeded plan fires at the same runs on every rank and on a
    second pass, as the reference's does; disarmed, the wire is exact."""
    stack = _int_stack(np.random.default_rng(23), elems=64)[:N]
    res = world.run("dcn_fault_site", stack=stack)
    for r in res:
        assert "unreachable" in r["hierarchical"]
        assert r["flat_history"] == []
        assert "xpod_rs" in r["roundtrip"]
        first, again = r["sequences"]
        assert first and first == again
        assert first == res[0]["sequences"][0]
        np.testing.assert_array_equal(
            r["clean"], np.broadcast_to(stack.sum(axis=0), stack.shape))


def test_dcn_fault_rolls_back_and_converges(world, tmp_path):
    """Mirrors ``TestChaosDcnRecovery``: ``dcn:step=5`` fails the
    cross-pod exchange of step 5 once; the ``@elastic.run`` loop rolls
    back to the step-5 commit, re-inits over a new rendezvous and
    converges to the flat total, every rank with two tries."""
    fault_step, total = 5, 8
    res = world.run("dcn_chaos", store=str(tmp_path / "store2"),
                    fault_step=fault_step, total=total)
    for r in res:
        assert len(r["fired"]) == 1 and r["fired"][0][1] == fault_step
        assert r["tries"] == 2
        assert r["at_retry"] == (fault_step,
                                 sum(N * t for t in range(fault_step)))
        assert r["accum"] == sum(N * t for t in range(total))
        np.testing.assert_array_equal(r["weight"],
                                      np.full((1, 2), float(total)))
