"""The PyTorch port's α–β fusion planner, two-phase fusion and overlap
wire against the JAX reference (``horovod_tpu/ops/fusion.py``).

The planner is pure arithmetic on ints and floats, so its outputs must
equal the reference's exactly; the cases mirror ``tests/test_fusion.py``
(``TestPlanner``, ``TestCostModel``, ``TestPipelineOrder``,
``TestOverlapCostModel``, ``TestBucketSchedule``), without the native
planner's cases.  ``fused_two_phase_apply`` and the overlap wire run on
a 4-rank gloo world spawned once for the module
(``tests/torch_port_workers.py``): n = 2 on the sets {0, 1} and {2, 3}
at once, n = 4 on the global set; the reference runs here on the first
n devices of the CPU mesh.  The int8 wire is held bit for bit to the
reference's SPMD path; the exact and cast wires bit for bit at n = 2
and within ``tests/test_fusion.py``'s tolerances at n = 4, where gloo
adds four contributions in another order and precision than XLA.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu._compat import shard_map
from horovod_tpu.ops import fusion as jf
from horovod_tpu.ops.compression import Compression as JaxCompression

import horovod_tpu_torch as thvd
from horovod_tpu_torch.ops import fusion as tf

import torch_port_workers as workers

N = 4


def _sizes(seed, count=60, high=10 ** 7):
    return [int(v) for v in
            np.random.RandomState(seed).randint(0, high, size=count)]


# --- the planner: exact equality ------------------------------------------------

class TestPlanner:
    @pytest.mark.parametrize("sizes,threshold", [
        ([10, 10, 10], 100), ([60, 60, 60], 100), ([10, 90, 10, 90], 100),
        ([10, 500, 10], 100), ([], 100), ([0, 0], 100),
        ([40, 40, 30, 30], 100)])
    def test_edge_cases_equal_reference(self, sizes, threshold):
        assert tf.plan_buckets(sizes, threshold) \
            == tf.plan_buckets_py(sizes, threshold) \
            == jf.plan_buckets_py(sizes, threshold)

    @pytest.mark.parametrize("seed", range(4))
    def test_random_sizes_equal_reference(self, seed):
        sizes = _sizes(seed, high=200)
        assert tf.plan_buckets(sizes, 256) == jf.plan_buckets(sizes, 256)

    @pytest.mark.parametrize("comp", ["none", "fp16", "bf16", "int8"])
    @pytest.mark.parametrize("itemsize", [1, 2, 4])
    def test_wire_ratio_equals_reference(self, comp, itemsize):
        assert tf.wire_ratio(getattr(thvd.Compression, comp), itemsize) \
            == jf.wire_ratio(getattr(JaxCompression, comp), itemsize)
        assert tf.wire_ratio(None, itemsize) == jf.wire_ratio(None, itemsize)


KNOBS = [(2, 10.0, 100.0), (8, 1.0, 1.0), (64, 0.5, 400.0),
         (3, 0.33, 1.0), (1, 10.0, 100.0)]


class TestCostModel:
    @pytest.mark.parametrize("n,alpha,beta", KNOBS)
    def test_costs_and_crossover_equal_reference(self, n, alpha, beta):
        for nbytes in _sizes(n, count=20, high=1 << 30) + [0, 989, 990]:
            assert tf.phase_cost_us(nbytes, n, alpha, beta) \
                == jf.phase_cost_us(nbytes, n, alpha, beta)
            assert tf.allreduce_cost_us(nbytes, n, alpha, beta) \
                == jf.allreduce_cost_us(nbytes, n, alpha, beta)
        assert tf.two_phase_crossover_bytes(n, alpha, beta) \
            == jf.two_phase_crossover_bytes(n, alpha, beta)

    @pytest.mark.parametrize("n,alpha,beta", KNOBS)
    def test_flags_equal_reference(self, n, alpha, beta):
        payloads = _sizes(7, count=100, high=1 << 30) + [989, 990, 991]
        assert tf.plan_two_phase_flags(payloads, n, alpha, beta) \
            == jf.plan_two_phase_flags(payloads, n, alpha, beta)

    def test_crossover_is_alpha_beta_n(self):
        assert tf.two_phase_crossover_bytes(8, 10.0, 100.0) \
            == 8 * 10 * 100 * 1000
        assert tf.two_phase_crossover_bytes(1, 10.0, 100.0) > 1 << 60
        assert tf.plan_two_phase_flags([989, 990, 991], 3, 0.33, 1.0) \
            == [False, True, True]

    def test_schedule_cost_equals_reference(self):
        sizes = [64 << 20] * 4 + _sizes(3, count=12, high=1 << 27)
        for flags in ([True] * len(sizes), [False] * len(sizes),
                      [i % 3 == 0 for i in range(len(sizes))]):
            for n, alpha, beta in KNOBS:
                assert tf.estimate_schedule_cost_us(sizes, flags, n, alpha,
                                                    beta) \
                    == jf.estimate_schedule_cost_us(sizes, flags, n, alpha,
                                                    beta)
        serial = sum(tf.allreduce_cost_us(s, 8, 10.0, 100.0)
                     for s in sizes[:4])
        assert tf.estimate_schedule_cost_us(sizes[:4], [True] * 4, 8, 10.0,
                                            100.0) < serial


class TestPipelineOrder:
    @pytest.mark.parametrize("depth", [1, 2, 3, 4])
    @pytest.mark.parametrize("seed", range(3))
    def test_order_equals_reference(self, depth, seed):
        rng = np.random.RandomState(seed)
        flags = [bool(f) for f in rng.rand(9) > 0.3]
        assert tf.plan_pipeline_order(flags, depth) \
            == jf.plan_pipeline_order(flags, depth)
        priority = [float(p) for p in rng.randint(0, 5, size=9)]
        assert tf.plan_pipeline_order(flags, depth, priority) \
            == jf.plan_pipeline_order(flags, depth, priority)

    def test_depth_two_interleaves(self):
        assert tf.plan_pipeline_order([True, True, True], 2) == [
            ("rs", 0), ("rs", 1), ("ag", 0), ("rs", 2), ("ag", 1), ("ag", 2)]

    def test_inflight_bounded_by_depth(self):
        inflight = 0
        for kind, _ in tf.plan_pipeline_order([True] * 8, 3):
            inflight += {"rs": 1, "ag": -1, "ar": 0}[kind]
            assert inflight <= 3

    def test_priority_length_mismatch_raises(self):
        with pytest.raises(ValueError, match="priority"):
            tf.plan_pipeline_order([True, True], 2, priority=[1.0])


class TestOverlapCostModel:
    @pytest.mark.parametrize("n,alpha,beta", KNOBS)
    def test_priority_equals_reference(self, n, alpha, beta):
        for sizes in ([10, 1 << 26, 1 << 20], [64, 64, 64],
                      _sizes(n, count=30)):
            assert tf.plan_overlap_priority(sizes, n, alpha, beta) \
                == jf.plan_overlap_priority(sizes, n, alpha, beta)

    @pytest.mark.parametrize("n,mb,compute", [
        (8, 4, 1e12), (8, 4, 0.0), (1, 4, 1e9), (2, 3, 50.0), (4, 1, 10.0)])
    def test_hidden_fraction_equals_reference(self, n, mb, compute):
        sizes = _sizes(mb, count=25, high=1 << 26)
        kw = dict(world_size=n, microbatches=mb,
                  compute_us_per_microbatch=compute)
        assert tf.estimate_overlap_hidden_fraction(sizes, 1 << 24, **kw) \
            == jf.estimate_overlap_hidden_fraction(sizes, 1 << 24, **kw)

    def test_hidden_fraction_closed_form(self):
        est = tf.estimate_overlap_hidden_fraction(
            [1 << 26], 1 << 30, world_size=8, microbatches=4,
            compute_us_per_microbatch=1e12)
        assert est["hidden_frac"] == pytest.approx(3.0 / 5.0)

    @pytest.mark.parametrize("n", [1, 2, 8])
    def test_plan_overlap_buckets_equals_reference(self, n):
        shapes = [(37,), (100,), (3,), (5, 7), (), (300,)]
        dtypes = [np.float32, np.float32, np.float16, np.float32,
                  np.float32, np.float16]
        leaves = [np.zeros(s, d) for s, d in zip(shapes, dtypes)]
        ref = jf.plan_overlap_buckets(leaves, 512, world_size=n)
        got = tf.plan_overlap_buckets([torch.from_numpy(v) for v in leaves],
                                      512, world_size=n)
        for field in ("members", "cols", "payload", "pad", "shard_elems",
                      "order", "n"):
            assert getattr(got, field) == getattr(ref, field), field
        assert [str(d).split(".")[-1] for d in got.dtypes] \
            == [np.dtype(d).name for d in ref.dtypes]
        zeros = tf.zero_overlap_shards(got)
        assert [tuple(z.shape) for z in zeros] \
            == [(e,) for e in ref.shard_elems]


class TestBucketSchedule:
    @pytest.mark.parametrize("compute", [None, 1.0, 1e9])
    @pytest.mark.parametrize("two_phase", [True, False])
    @pytest.mark.parametrize("n", [1, 2, 8])
    def test_schedule_equals_reference(self, compute, two_phase, n):
        sizes = _sizes(n, count=40)
        kw = dict(world_size=n, alpha_us=1e-6 if compute else 10.0,
                  beta_gbps=1.0 if compute else 100.0,
                  two_phase=two_phase, pipeline_depth=3,
                  compute_us=compute)
        got = tf.plan_bucket_schedule(sizes, 1 << 24, **kw)
        ref = jf.plan_bucket_schedule(sizes, 1 << 24, **kw)
        assert dataclasses_tuple(got) == dataclasses_tuple(ref)

    def test_two_phase_off_is_all_allreduce(self):
        s = tf.plan_bucket_schedule([100, 200], 1 << 20, world_size=8,
                                    two_phase=False)
        assert s.two_phase == (False,)
        assert all(k == "ar" for k, _ in s.order)


def dataclasses_tuple(s):
    return (s.buckets, s.two_phase, s.order, s.est_cost_us, s.est_hidden_us)


# --- fused_two_phase_apply and the overlap wire on a gloo world -------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = workers.World(N, str(tmp_path_factory.mktemp("gloo") / "store"))
    yield w
    w.close()


SETS = {2: [[0, 1], [2, 3]], 4: [[0, 1, 2, 3]]}
DEPTHS = [1, 2, 3]
SHAPES = [(37,), (1000,), (), (3, 5, 7)]


def _leaves(seed):
    """Per-rank leaves as ``tests/test_fusion.py``'s tree: a multi-leaf
    bucket, a leaf the world does not divide, a scalar and a leaf that
    overflows a bucket; magnitudes over decades for the int8 wire."""
    rng = np.random.RandomState(seed)
    return [[(rng.randn(*s) * 10.0 ** rng.uniform(-2, 1, s)).astype(np.float32)
             for s in SHAPES] for _ in range(N)]


def _reference(fn, members, per_rank, n_out):
    """``fn(leaves)`` inside a shard_map over the first len(members)
    devices, each slot on its member's leaves; the ``n_out`` per-slot
    results.  Compiled at backend optimization level 0: at the default
    level LLVM contracts the dequantize-accumulate's multiply and add
    into one rounding and the reference's wire moves by an ulp (ROADMAP
    R1); level 0 gives the bits of the eager run that the port's other
    int8 parity tests use, in a fraction of its time."""
    n = len(members)
    mesh = Mesh(np.array(jax.devices()[:n]), ("hvd",))
    stacked = [jnp.asarray(np.stack([per_rank[r][i] for r in members]))
               for i in range(len(per_rank[members[0]]))]

    def body(*xs):
        return tuple(r[None] for r in fn([x[0] for x in xs]))

    program = jax.jit(shard_map(
        body, mesh=mesh, in_specs=tuple(P("hvd") for _ in stacked),
        out_specs=tuple(P("hvd") for _ in range(n_out)), check=False))
    out = program.lower(*stacked).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*stacked)
    return [np.asarray(o) for o in out]


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _hold(got, want, comp, n):
    """Bit for bit on the int8 wire and at n = 2; at n = 4 the exact and
    cast wires within ``tests/test_fusion.py``'s tolerances (gloo adds a
    half-precision wire's four contributions in half precision, one
    rounding an add, in its own order)."""
    if comp == "int8" or n == 2:
        np.testing.assert_array_equal(_bits(got), _bits(want))
    elif comp == "none":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-1)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("comp,op,threshold", [
    ("int8", "average", 512), ("int8", "sum", 512), ("int8", "average", 4),
    ("none", "sum", 512), ("fp16", "average", 512), ("bf16", "sum", 512)])
def test_two_phase_matches_reference(world, n, comp, op, threshold):
    """Every bucket decomposed (α = 1e-6 µs, β = 1 GB/s) at the
    reference test's 512-byte threshold, and at 4 bytes (a bucket a
    leaf, each with a padded tail): the port at pipeline depths 1, 2 and
    3 against the reference's ``fused_two_phase_apply``, and against its
    own single-phase fused allreduce (the same operations: bit for
    bit)."""
    per_rank = _leaves(seed=n)
    out = world.run("two_phase", op=op, compression=comp, depths=DEPTHS,
                    threshold=threshold, sets=SETS[n],
                    per_rank=[{"leaves": per_rank[r]} for r in range(N)])
    jcomp = getattr(JaxCompression, comp)
    for members in SETS[n]:
        ref = _reference(lambda ls: jf.fused_two_phase_apply(
            ls, axis="hvd", op=op, groups=None, compression=jcomp,
            threshold=threshold, pipeline_depth=2, alpha_us=1e-6,
            beta_gbps=1.0), members, per_rank, len(SHAPES))
        for slot, r in enumerate(members):
            for depth in DEPTHS:
                for got, want in zip(out[r][depth], ref):
                    _hold(got, want[slot], comp, n)
                    assert got.shape == want[slot].shape
            for got, two in zip(out[r]["one"], out[r][DEPTHS[0]]):
                np.testing.assert_array_equal(_bits(got), _bits(two))


def test_two_phase_latency_bound_buckets_stay_single(world):
    """At the default α–β the 64-byte buckets are under the crossover:
    every bucket is one allreduce, bit for bit the single-phase path."""
    per_rank = _leaves(seed=9)
    out = world.run("two_phase", op="average", compression="int8",
                    depths=[2], threshold=64, sets=SETS[4], alpha_us=10.0,
                    beta_gbps=100.0,
                    per_rank=[{"leaves": per_rank[r]} for r in range(N)])
    for r in range(N):
        for got, one in zip(out[r][2], out[r]["one"]):
            np.testing.assert_array_equal(_bits(got), _bits(one))


def test_schedule_is_not_ported():
    """``schedule=`` is taken, no longer refused: in a world of one a
    compiler for a 2×2 mesh is not consulted, and the leaves come back
    reduced over the one rank.  The topology compiler's own parity tests
    are ``tests/test_torch_port_topo.py``."""
    from horovod_tpu_torch.topo.schedule import ScheduleCompiler
    from horovod_tpu_torch.topo.topology import MeshTopology

    x = torch.arange(3.0)
    thvd.init(device="cpu")
    try:
        out = tf.fused_two_phase_apply(
            [x], op="sum", schedule=ScheduleCompiler(MeshTopology(2, 2),
                                                     force="hierarchical"))
    finally:
        thvd.shutdown()
    np.testing.assert_array_equal(out[0].numpy(), x.numpy())


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("comp", ["int8", "none", "bf16"])
def test_overlap_wire_matches_reference(world, n, comp):
    """Three microbatches' gradient leaves through the overlap wire
    (reduce-scatter a microbatch, shards added from zeros, one
    all-gather), against the reference's ``overlap_reduce_scatter`` /
    ``overlap_all_gather`` in the same order."""
    mbs = [_leaves(seed=20 + i) for i in range(3)]
    out = world.run("overlap_wire", op="average", compression=comp,
                    threshold=256, sets=SETS[n],
                    per_rank=[{"microbatches": [m[r] for m in mbs]}
                              for r in range(N)])
    jcomp = getattr(JaxCompression, comp)
    leaves_per_rank = {r: [v for m in mbs for v in m[r]] for r in range(N)}
    k = len(SHAPES)

    def wire(flat):
        per_mb = [flat[i * k:(i + 1) * k] for i in range(len(mbs))]
        plan = jf.plan_overlap_buckets(per_mb[0], 256, world_size=n)
        acc = jf.zero_overlap_shards(plan)
        for leaves in per_mb:
            shards = jf.overlap_reduce_scatter(
                leaves, plan, axis="hvd", op="average", groups=None,
                compression=jcomp)
            acc = tuple(a + s for a, s in zip(acc, shards))
        return jf.overlap_all_gather(acc, plan, per_mb[0], axis="hvd",
                                     groups=None, compression=jcomp)

    for members in SETS[n]:
        ref = _reference(wire, members, leaves_per_rank, len(SHAPES))
        for slot, r in enumerate(members):
            for got, want in zip(out[r]["full"], ref):
                assert got.shape == want[slot].shape
                _hold(got, want[slot], comp, n)
