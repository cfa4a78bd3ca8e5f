"""The PyTorch port's hierarchical (two-level) allreduce and no-op knob
warnings, mirroring ``tests/test_hierarchical.py``'s three classes.

Reference: ``HOROVOD_HIERARCHICAL_ALLREDUCE`` (Horovod's NCCL
reduce-scatter inside the node, allreduce across nodes, all-gather
inside the node), ``horovod_tpu/ops/collectives.py:240-312``.  The
reference factors its 8-slot mesh 2 × 4; here a 4-rank gloo world
spawned for the module (``tests/torch_port_workers.py``) is factored
2 (outer) × 2 (inner) by ``HVD_TPU_HIERARCHICAL_INNER=2``.  Tolerances:
the reference test's ``rtol=1e-4, atol=1e-5`` against numpy on random
f32, bit for bit against the port's flat allreduce on integer-valued
data, exact on integer tensors.
"""

import logging

import numpy as np
import pytest

import torch_port_workers as workers

N = 4
INNER = {"HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
         "HVD_TPU_HIERARCHICAL_INNER": "2"}
THREE_STAGES = [("reduce_scatter_tensor", 2), ("all_reduce", 2),
                ("all_gather_into_tensor", 2)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = workers.World(N, str(tmp_path_factory.mktemp("gloo") / "store"))
    yield w
    w.close()


def _run(world, per_rank_cases, env=INNER, sets=None):
    return world.run("hier_allreduce", env=env, sets=sets,
                     per_rank=[{"cases": c} for c in per_rank_cases])


def _cases(x, **kw):
    """One case a rank: rank ``r`` reduces ``x[r]``."""
    return [[dict(x=x[r], **kw)] for r in range(N)]


class TestHierarchicalAllreduce:
    def test_sum_matches_flat(self, world):
        # 33 elements: the inner group's padding (33 % 2 != 0).
        x = np.random.RandomState(0).randn(N, 33).astype(np.float32)
        out = _run(world, _cases(x, op="sum"))
        for r in range(N):
            np.testing.assert_allclose(out[r][0]["r"], x.sum(axis=0),
                                       rtol=1e-4, atol=1e-5)
            assert out[r][0]["calls"] == THREE_STAGES

    def test_average_matches_flat(self, world):
        x = np.random.RandomState(1).randn(N, 16).astype(np.float32)
        out = _run(world, _cases(x, op="average"))
        for r in range(N):
            np.testing.assert_allclose(out[r][0]["r"], x.mean(axis=0),
                                       rtol=1e-4, atol=1e-5)

    def test_bitwise_flat_on_integer_valued_data(self, world):
        """Integer-valued f32 (every partial sum exact): Sum and Average
        bit for bit the flat allreduce, the one division at the end."""
        x = np.random.RandomState(2).randint(-50, 50, (N, 3, 7)) \
            .astype(np.float32)
        cases = [[dict(x=x[r], op=op) for op in ("sum", "average")]
                 for r in range(N)]
        hier = _run(world, cases)
        flat = _run(world, cases, env={})
        for r in range(N):
            for h, f in zip(hier[r], flat[r]):
                assert h["r"].shape == (3, 7)
                np.testing.assert_array_equal(
                    h["r"].view(np.uint32), f["r"].view(np.uint32))
                assert h["calls"] == THREE_STAGES
                assert f["calls"] == [("all_reduce", 4)]

    def test_integer_average(self, world):
        x = np.arange(N * 4, dtype=np.int32).reshape(N, 4)
        out = _run(world, _cases(x, op="average"))
        for r in range(N):
            np.testing.assert_array_equal(out[r][0]["r"],
                                          x.sum(axis=0) // N)
            assert out[r][0]["r"].dtype == np.int32

    def test_scale_factors(self, world):
        x = np.full((N, 5), 1.0, np.float32)
        out = _run(world, _cases(x, op="sum", prescale=2.0, postscale=0.5))
        for r in range(N):
            np.testing.assert_allclose(out[r][0]["r"], N * 1.0, rtol=1e-5)

    def test_process_sets_fall_back_to_flat(self, world):
        """A process set keeps the flat wire: ranks {0, 1, 3} sum over
        their own group in one allreduce; rank 2 runs alone in {2}."""
        x = np.random.RandomState(2).randn(N, 6).astype(np.float32)
        out = _run(world, _cases(x, op="sum", set=True),
                   sets=[[0, 1, 3], [2]])
        for r in (0, 1, 3):
            np.testing.assert_allclose(out[r][0]["r"], x[[0, 1, 3]].sum(0),
                                       rtol=1e-4, atol=1e-5)
            assert out[r][0]["calls"] == [("all_reduce", 3)]
        np.testing.assert_array_equal(out[2][0]["r"], x[2])

    def test_compressed_wire_stays_flat(self, world):
        """The two-level path is the exact wire's (the reference's too):
        a compressed allreduce keeps its own tier."""
        x = np.random.RandomState(3).randint(-9, 9, (N, 8)).astype(
            np.float32)
        out = _run(world, _cases(x, op="sum", compression="fp16"))
        for r in range(N):
            np.testing.assert_array_equal(out[r][0]["r"], x.sum(0))
            assert out[r][0]["calls"] == [("all_reduce", 4)]


class TestInnerResolution:
    def test_explicit_inner_wins(self, world):
        assert world.run("hier_inner", env=INNER) == [2] * N

    @pytest.mark.parametrize("inner", ["3", "4", "1"])
    def test_invalid_inner_disables(self, world, inner):
        """3 does not divide 4; 4 leaves no outer group; 1 no inner."""
        env = {"HVD_TPU_HIERARCHICAL_INNER": inner}
        assert world.run("hier_inner", env=env) == [0] * N

    def test_default_is_ranks_a_node(self, world):
        """Unset, the inner width is the ranks a node when there are
        several nodes (``LOCAL_WORLD_SIZE``), else 0."""
        assert world.run("hier_inner",
                         env={"LOCAL_WORLD_SIZE": "2"}) == [2] * N
        assert world.run("hier_inner", env={}) == [0] * N


class TestNoopKnobWarnings:
    def test_set_knobs_warn(self, monkeypatch, caplog):
        from horovod_tpu_torch.config import warn_noop_knobs

        monkeypatch.setenv("HOROVOD_HIERARCHICAL_ALLGATHER", "1")
        logger = logging.getLogger("test_noop_knobs")
        with caplog.at_level(logging.WARNING, logger="test_noop_knobs"):
            hit = warn_noop_knobs(logger)
        assert hit == ["HIERARCHICAL_ALLGATHER"]
        assert len([r for r in caplog.records if "no-op" in r.message]) == 1

    def test_unset_knobs_silent(self, monkeypatch):
        from horovod_tpu_torch.config import warn_noop_knobs

        for k in ("HOROVOD_HIERARCHICAL_ALLGATHER",
                  "HVD_TPU_HIERARCHICAL_ALLGATHER"):
            monkeypatch.delenv(k, raising=False)
        assert warn_noop_knobs(logging.getLogger("test_noop_knobs")) == []

    def test_init_warns(self, monkeypatch, caplog):
        import horovod_tpu_torch as thvd

        monkeypatch.setenv("HVD_TPU_HIERARCHICAL_ALLGATHER", "1")
        with caplog.at_level(logging.WARNING):
            thvd.init(device="cpu")
            try:
                assert thvd.config().hierarchical_allgather is True
            finally:
                thvd.shutdown()
        assert "HOROVOD_HIERARCHICAL_ALLGATHER is set but is a no-op" \
            in caplog.text
