"""The PyTorch port's Horovod collective API against the JAX reference:
the eager int8 allreduce (bit for bit with the reference's eager API),
integer Average, compression with order ops, process sets, and every
eager op with its async, grouped and in-place forms, over the sets
{0, 2} and {1, 3} at once and over the global set.

The port runs on a 4-rank gloo world spawned once for the module
(``tests/torch_port_workers.py``; its workers import no JAX), or in a
world of one in this process.  The reference runs here on the 8-slot
CPU mesh: port rank ``r`` is the reference's slot ``r``, and a port set
is the reference process set of the same ranks.  Ragged allgather and
alltoall exist in the reference only on its multi-process tier
(``hostops``), so they are held to a numpy oracle of that contract.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
from horovod_tpu import process_sets as jhvd_process_sets
from horovod_tpu.ops.compression import Compression as JaxCompression

import horovod_tpu_torch as thvd
import torch_port_workers as workers

N = 4
SLOTS = 8
PAIRS = [[0, 2], [1, 3]]
WHOLE = [[0, 1, 2, 3]]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = workers.World(N, str(tmp_path_factory.mktemp("gloo") / "store"))
    yield w
    w.close()


@pytest.fixture
def solo():
    """The port in a world of one, in this process."""
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _stack(per_rank, members):
    """The reference's per-slot stack: member ``r``'s row is rank ``r``'s
    input, every other slot zeros (the reference masks them out)."""
    first = np.asarray(per_rank[members[0]])
    stack = np.zeros((SLOTS,) + first.shape, first.dtype)
    for r in members:
        stack[r] = per_rank[r]
    return stack


class _RefSet:
    """The reference's process set of ``members`` (None: every slot) for
    the block: the registered one if another test of this process left
    it registered, else one registered for the block."""

    def __init__(self, members):
        self.members = members
        self.ps = self.added = None

    def __enter__(self):
        if len(self.members) < SLOTS:
            self.ps = jhvd_process_sets._table().find(self.members)
            if self.ps is None:
                self.ps = self.added = jhvd.add_process_set(
                    list(self.members))
        return self.ps

    def __exit__(self, *exc):
        if self.added is not None:
            jhvd.remove_process_set(self.added)


def _contributions(shape, seed):
    """Per-rank f32 inputs with magnitudes over decades and an all-zero
    stretch, so blocks get distinct scales and one block is zero."""
    rng = np.random.RandomState(seed)
    x = rng.randn(N, *shape) * 10.0 ** rng.uniform(-3, 1, (N,) + shape)
    x.reshape(N, -1)[:, :min(x[0].size, 700)] = 0.0
    return x.astype(np.float32)


# --- F1: the eager int8 allreduce -----------------------------------------------

def test_int8_allreduce_in_a_world_of_one_quantizes(solo):
    """At n = 1 the reference's eager int8 allreduce still quantizes
    (blocks of min(1024, numel)); the port's does the same, bit for
    bit, and so differs from its input."""
    x = np.random.RandomState(0).randn(3000).astype(np.float32)
    with _RefSet([0]) as ps:
        ref = np.asarray(jhvd.allreduce(
            _stack({0: x}, [0]), process_set=ps,
            compression=JaxCompression.int8))
        leaves = [x[:100], x[100:].reshape(20, 145)]
        ref_grouped = jhvd.grouped_allreduce(
            [_stack({0: v}, [0]) for v in leaves], process_set=ps,
            compression=JaxCompression.int8)
    out = thvd.allreduce(torch.from_numpy(x),
                         compression=thvd.Compression.int8).numpy()
    np.testing.assert_array_equal(_bits(out), _bits(ref))
    assert np.abs(out - x).max() > 1e-3
    grouped = thvd.grouped_allreduce([torch.from_numpy(v) for v in leaves],
                                     compression=thvd.Compression.int8)
    for got, want in zip(grouped, ref_grouped):
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("sets", [PAIRS, WHOLE], ids=["pairs", "whole"])
@pytest.mark.parametrize("op", ["sum", "average"])
@pytest.mark.parametrize("shape", [(3000,), (10001,), (33, 100)])
def test_int8_allreduce_matches_reference_eager(world, sets, op, shape):
    """2 and 4 members: each rank's tensor is quantized once in blocks
    of wire_block_size(numel, n) from element 0 and the n contributions
    summed in f32, as the reference's eager allreduce (and its grouped
    form, over the fused bucket) computes; held bit for bit."""
    x = _contributions(shape, seed=sum(shape) + len(sets[0]))
    leaves = [_contributions((300,), 5), _contributions((40, 37), 6),
              _contributions((17,), 7)]
    out = world.run("eager_int8", op=op, sets=sets,
                    per_rank=[{"x": x[r], "leaves": [v[r] for v in leaves]}
                              for r in range(N)])
    int8 = JaxCompression.int8
    for members in sets:
        with _RefSet(members) as ps:
            ref = np.asarray(jhvd.allreduce(_stack(x, members), op=op,
                                            process_set=ps, compression=int8))
            ref_grouped = [np.asarray(g) for g in jhvd.grouped_allreduce(
                [_stack(v, members) for v in leaves], op=op, process_set=ps,
                compression=int8)]
        for r in members:
            np.testing.assert_array_equal(_bits(out[r]["allreduce"]),
                                          _bits(ref))
            for got, want in zip(out[r]["grouped"], ref_grouped):
                np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("sets", [PAIRS, WHOLE], ids=["pairs", "whole"])
@pytest.mark.parametrize("op", ["sum", "average"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_int8_allreduce_half_precision_matches_reference(world, sets, op,
                                                         dtype):
    """bf16 and f16 inputs at 2 and 4 members: the reference rounds each
    contribution's dequantized values to the input dtype, sums them and
    divides in that dtype; the port's eager tier holds the same bits
    (F4), alone and grouped."""
    jdt = getattr(jnp, dtype)
    x = _contributions((3000,), seed=len(sets[0]) + 40)
    leaves = [_contributions((300,), 8), _contributions((40, 37), 9)]
    out = world.run("eager_int8", op=op, sets=sets, dtype=dtype,
                    per_rank=[{"x": x[r], "leaves": [v[r] for v in leaves]}
                              for r in range(N)])
    int8 = JaxCompression.int8

    def half(stack):
        return jnp.asarray(stack).astype(jdt)

    def f32(a):
        return np.asarray(jnp.asarray(a).astype(jnp.float32))

    for members in sets:
        with _RefSet(members) as ps:
            ref = f32(jhvd.allreduce(half(_stack(x, members)), op=op,
                                     process_set=ps, compression=int8))
            ref_grouped = [f32(g) for g in jhvd.grouped_allreduce(
                [half(_stack(v, members)) for v in leaves], op=op,
                process_set=ps, compression=int8)]
        for r in members:
            np.testing.assert_array_equal(_bits(out[r]["allreduce"]),
                                          _bits(ref))
            for got, want in zip(out[r]["grouped"], ref_grouped):
                np.testing.assert_array_equal(_bits(got), _bits(want))


# --- F3, process-set errors -----------------------------------------------------

@pytest.mark.parametrize("op", ["min", "max", "product", "adasum"])
def test_compression_with_order_ops_and_adasum_raises(solo, op):
    x = torch.ones(8)
    for comp in (thvd.Compression.fp16, thvd.Compression.bf16,
                 thvd.Compression.int8):
        with pytest.raises(ValueError, match="compression is not supported"):
            thvd.allreduce(x, op=op, compression=comp)
        with pytest.raises(ValueError, match="compression is not supported"):
            thvd.grouped_allreduce([x], op=op, compression=comp)
    thvd.allreduce(x, op=op)            # exact wire: fine


def test_process_set_errors(solo):
    with pytest.raises(ValueError, match="Duplicate"):
        thvd.ProcessSet([0, 0])
    with pytest.raises(ValueError, match="already exists"):
        thvd.add_process_set([0])
    with pytest.raises(ValueError, match="out of range"):
        thvd.add_process_set([0, 1])
    with pytest.raises(ValueError, match="global"):
        thvd.remove_process_set(thvd.global_process_set())
    with pytest.raises(ValueError, match="not registered"):
        thvd.remove_process_set(thvd.ProcessSet([0]))
    with pytest.raises(ValueError, match="not registered"):
        thvd.allreduce(torch.ones(2), process_set=thvd.ProcessSet([0]))
    ps = thvd.global_process_set()
    assert (ps.process_set_id, ps.ranks, ps.size(), ps.rank()) == (0, (0,), 1,
                                                                   0)
    assert ps.included() and ps == thvd.ProcessSet([0])


def test_feature_matrix_and_layout(solo):
    """The port's true values: this build has gloo, no MPI runtime of its
    own, and NCCL only with CUDA; one node without torchrun's env."""
    assert thvd.gloo_built() and thvd.gloo_enabled()
    assert not (thvd.mpi_enabled() or thvd.xla_built()
                or thvd.mpi_threads_supported())
    assert thvd.cuda_built() == (torch.version.cuda is not None)
    assert (thvd.nccl_built() > 0) == (torch.distributed.is_nccl_available()
                                      and torch.cuda.is_available())
    assert (thvd.cross_rank(), thvd.cross_size(), thvd.is_homogeneous()) == (
        0, 1, True)


# --- the eager API over sets ----------------------------------------------------

def _ragged(r):
    k = 2 * r + 3
    return (np.arange(k * 2, dtype=np.float32).reshape(k, 2) + 100 * r)


def _splits(r, n):
    k = 2 * r + 3
    return [(k * (j + 1)) // n - (k * j) // n for j in range(n)]


@pytest.fixture(scope="module", params=[PAIRS, WHOLE], ids=["pairs", "whole"])
def eager(world, request):
    """(sets, inputs, every rank's results of ``eager_ops``)."""
    sets = request.param
    rng = np.random.RandomState(len(sets))
    inputs = {
        "x": rng.randint(-5, 6, (N, 4, 3)).astype(np.float32),
        "y": rng.randint(-5, 6, (N, 8, 2)).astype(np.float32),
        "ints": rng.randint(-9, 10, (N, 5)).astype(np.int32),
    }
    member_of = {r: m for m in sets for r in m}
    out = world.run("eager_ops", sets=sets, per_rank=[
        {"x": inputs["x"][r], "y": inputs["y"][r], "ints": inputs["ints"][r],
         "ragged": _ragged(r), "splits": _splits(r, len(member_of[r]))}
        for r in range(N)])
    return sets, inputs, out


def _ref(fn, members, *args, **kwargs):
    with _RefSet(members) as ps:
        out = fn(*args, process_set=ps, **kwargs)
        return (np.asarray(out) if not isinstance(out, list)
                else [np.asarray(o) for o in out])


def test_allreduce_ops_match_reference(eager):
    sets, inp, out = eager
    x, ints = inp["x"], inp["ints"]
    for members in sets:
        stack = _stack(x, members)
        refs = {op: _ref(jhvd.allreduce, members, stack, op=op)
                for op in ("sum", "average", "min", "max", "product")}
        refs["scaled"] = _ref(jhvd.allreduce, members, stack, op="sum",
                              prescale_factor=0.5, postscale_factor=3.0)
        for comp in ("fp16", "bf16"):
            refs[comp] = _ref(jhvd.allreduce, members, stack,
                              compression=getattr(JaxCompression, comp))
        for r in members:
            for key, want in refs.items():
                np.testing.assert_array_equal(out[r][key], want, err_msg=key)
            np.testing.assert_array_equal(out[r]["async_sum"], refs["sum"])


def test_integer_average_floors_in_its_dtype(eager):
    """An int32 Average comes back int32, the sum floor-divided by n
    (the reference's ``r // n``), not a float quotient."""
    sets, inp, out = eager
    for members in sets:
        want = _ref(jhvd.allreduce, members, _stack(inp["ints"], members))
        total = inp["ints"][members].sum(0)
        np.testing.assert_array_equal(want, np.floor_divide(total,
                                                            len(members)))
        for r in members:
            assert out[r]["int_average"].dtype == np.int32
            np.testing.assert_array_equal(out[r]["int_average"], want)


def test_grouped_allreduce_matches_reference(eager):
    sets, inp, out = eager
    for members in sets:
        leaves = [_stack(inp[k], members) for k in ("x", "ints", "y")]
        want = _ref(jhvd.grouped_allreduce, members, leaves, op="sum")
        for r in members:
            for got, w in zip(out[r]["grouped"], want):
                assert got.dtype == w.dtype
                np.testing.assert_array_equal(got, w)
            for got, w in zip(out[r]["grouped_allreduce_async_"],
                              [want[0], want[2]]):
                np.testing.assert_array_equal(got, w)
            assert out[r]["grouped_inplace_is_input"]


def test_allgather_broadcast_alltoall_match_reference(eager):
    sets, inp, out = eager
    x = inp["x"]
    for members in sets:
        stack = _stack(x, members)
        gathered = _ref(jhvd.allgather, members, stack)
        bcast = _ref(jhvd.broadcast, members, stack, root_rank=members[-1])
        a2a = _ref(jhvd.alltoall, members, stack)
        for r in members:
            np.testing.assert_array_equal(out[r]["allgather"], gathered)
            np.testing.assert_array_equal(out[r]["broadcast"], bcast)
            np.testing.assert_array_equal(out[r]["alltoall"], a2a[r])
            same, value = out[r]["broadcast_async_"]
            assert same
            np.testing.assert_array_equal(value, bcast)


def test_reducescatter_matches_reference(eager):
    sets, inp, out = eager
    for members in sets:
        sx, sy = _stack(inp["x"], members), _stack(inp["y"], members)
        rs = _ref(jhvd.reducescatter, members, sx, op="sum")
        avg = _ref(jhvd.reducescatter, members, sx, op="average")
        grouped = _ref(jhvd.grouped_reducescatter, members, [sx, sy],
                       op="sum")
        grouped_avg = _ref(jhvd.grouped_reducescatter, members, [sx, sy],
                           op="average")
        for r in members:
            np.testing.assert_array_equal(out[r]["reducescatter"], rs[r])
            np.testing.assert_array_equal(out[r]["reducescatter_avg"], avg[r])
            for key, want in (("grouped_reducescatter", grouped),
                              ("grouped_reducescatter_avg", grouped_avg)):
                for got, w in zip(out[r][key], want):
                    np.testing.assert_array_equal(got, w[r], err_msg=key)


def test_ragged_allgather_and_alltoall(eager):
    """The multi-process contract of ``hostops.allgather_async`` and
    ``hostops.alltoall``: dim 0 differs by rank, splits are ragged (and
    may be 0), the received splits come back with the rows."""
    sets, inp, out = eager
    for members in sets:
        n = len(members)
        gathered = np.concatenate([_ragged(r) for r in members])
        for i, r in enumerate(members):
            np.testing.assert_array_equal(out[r]["ragged_allgather"],
                                          gathered)
            parts, received = [], []
            for s in members:
                sp = _splits(s, n)
                start = sum(sp[:i])
                parts.append(_ragged(s)[start:start + sp[i]])
                received.append(sp[i])
            got, got_splits = out[r]["ragged_alltoall"]
            np.testing.assert_array_equal(got, np.concatenate(parts))
            assert got_splits == received
            np.testing.assert_array_equal(out[r]["alltoall_async"], got)
            ga = out[r]["grouped_allgather"]
            np.testing.assert_array_equal(ga[0], np.concatenate(
                [inp["x"][m] for m in members]))
            np.testing.assert_array_equal(ga[1], gathered)


def test_async_inplace_sparse_and_objects(eager):
    sets, inp, out = eager
    for members in sets:
        total = inp["x"][members].sum(0)
        sparse = np.zeros(6, np.float32)
        sparse[members] = 1.0
        sparse[4] = 2.0 * len(members)
        for r in members:
            o = out[r]
            assert o["poll_after"] and isinstance(o["poll_before"], bool)
            same, value = o["allreduce_"]
            assert same
            np.testing.assert_array_equal(value, total)
            np.testing.assert_array_equal(o["sparse"], sparse)
            assert o["broadcast_object"] == {"from": members[-1]}
            assert o["allgather_object"] == [["rank", m] * (m + 1)
                                             for m in members]
            assert o["join"] == N - 1


def test_non_members_raise_and_ids_agree(eager):
    """A rank outside a set raises ValueError before entering any call
    (the members' collectives completed without it), in the eager API and
    in a DistributedOptimizer over the set, as does a broadcast whose
    root is outside the set; every rank numbers the sets alike."""
    sets, _, out = eager
    for r in range(N):
        errors = out[r]["errors"]
        assert len(errors) == (0 if sets == WHOLE else 5), errors
        assert all(("not a member" in e or "not in process set" in e)
                   for e in errors), errors
    ids = {tuple(o["members"]): o["ids"][0] for o in out}
    for o in out:
        assert o["ids"][0] == ids[tuple(o["members"])]
    if sets == WHOLE:
        assert set(ids.values()) == {0}
    else:
        assert len(set(ids.values())) == 2 and 0 not in ids.values()
