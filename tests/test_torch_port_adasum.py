"""The PyTorch port's Adasum against the JAX reference: the pairwise
rule's properties (``tests/test_adasum.py``), and the distance-doubling
allreduce at 2, 3 and 4 members against the reference's
``adasum_allreduce`` run through ``shard_map`` on the first ``n`` CPU
devices and against a float64 numpy tree, with the tolerances of
``tests/test_adasum.py`` (rtol 1e-4, atol 1e-5).  The port runs on a
4-rank gloo world spawned once for the module; its workers import no
JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu._compat import shard_map
from horovod_tpu.ops.adasum import _combine as jax_combine
from horovod_tpu.ops.adasum import adasum_allreduce as jax_adasum

from horovod_tpu_torch.ops.adasum import combine

import torch_port_workers as workers
from test_adasum import _adasum_tree_np

N = 4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = workers.World(N, str(tmp_path_factory.mktemp("gloo") / "store"))
    yield w
    w.close()


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


class TestCombineRule:
    def test_identical_inputs_average(self):
        a = _t(np.random.RandomState(0).randn(16))
        np.testing.assert_allclose(combine(a, a).numpy(), a.numpy(),
                                   rtol=1e-6)

    def test_orthogonal_inputs_add(self):
        a, b = _t([1.0, 0.0, 2.0, 0.0]), _t([0.0, 3.0, 0.0, 4.0])
        np.testing.assert_allclose(combine(a, b).numpy(), (a + b).numpy(),
                                   rtol=1e-6)

    def test_scale_invariance(self):
        rng = np.random.RandomState(1)
        a, b = _t(rng.randn(32)), _t(rng.randn(32))
        np.testing.assert_allclose(combine(a * 100.0, b * 100.0).numpy(),
                                   combine(a, b).numpy() * 100.0, rtol=1e-4)

    def test_symmetric_bit_for_bit(self):
        """Partners compute combine(a, b) and combine(b, a): the same bits,
        so every member of a set ends with the same result."""
        rng = np.random.RandomState(2)
        for shape in [(8,), (300, 7), (4097,)]:
            a, b = _t(rng.randn(*shape)), _t(rng.randn(*shape) * 1e-3)
            assert torch.equal(combine(a, b).view(torch.int32),
                               combine(b, a).view(torch.int32))

    def test_zero_input_passthrough(self):
        a, b = torch.zeros(4), _t([1.0, 2.0, 3.0, 4.0])
        np.testing.assert_allclose(combine(a, b).numpy(), b.numpy(),
                                   rtol=1e-6)

    def test_matches_reference_rule(self):
        rng = np.random.RandomState(3)
        a, b = rng.randn(3, 50).astype(np.float32), rng.randn(3, 50)
        b = b.astype(np.float32)
        np.testing.assert_allclose(
            combine(_t(a), _t(b)).numpy(),
            np.asarray(jax_combine(jnp.asarray(a), jnp.asarray(b))),
            rtol=1e-5, atol=1e-6)


# --- the allreduce over 2, 3 and 4 members ---------------------------------------

SETS = {2: [[0, 1], [2, 3]], 3: [[0, 1, 2]], 4: [[0, 1, 2, 3]]}


def _reference(rows):
    """The reference's adasum_allreduce over ``len(rows)`` devices: every
    member's result, ``[n, ...]``."""
    n = len(rows)
    mesh = Mesh(np.array(jax.devices()[:n]), ("hvd",))
    body = shard_map(lambda v: jax_adasum(v[0], axis="hvd")[None],
                     mesh=mesh, in_specs=P("hvd"), out_specs=P("hvd"),
                     check=False)
    return np.asarray(jax.jit(body)(jnp.asarray(rows)))


def _inputs(seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(N, 17).astype(np.float32),
            rng.randn(N, 3, 4).astype(np.float32),
            (rng.randn(N, 300) * rng.uniform(0.1, 10, (N, 1))).astype(
                np.float32)]


@pytest.fixture(scope="module", params=sorted(SETS))
def adasum_run(world, request):
    n = request.param
    xs = _inputs(n)
    out = world.run("adasum", sets=SETS[n],
                    per_rank=[{"xs": [x[r] for x in xs]} for r in range(N)])
    return n, xs, out


def test_matches_reference_and_numpy_tree(adasum_run):
    n, xs, out = adasum_run
    for members in SETS[n]:
        for i, x in enumerate(xs):
            rows = x[members]
            ref = _reference(rows)
            tree = _adasum_tree_np([r.ravel() for r in rows]).reshape(
                x.shape[1:])
            for j, r in enumerate(members):
                got = out[r][0][i]
                np.testing.assert_allclose(got, ref[j], rtol=1e-4, atol=1e-5)
                np.testing.assert_allclose(got, tree, rtol=1e-4, atol=1e-5)


def test_members_end_with_the_same_bits(adasum_run):
    n, xs, out = adasum_run
    for members in SETS[n]:
        for i in range(len(xs)):
            first = out[members[0]][0][i].view(np.uint32)
            for r in members[1:]:
                np.testing.assert_array_equal(out[r][0][i].view(np.uint32),
                                              first)
    outside = [r for r in range(N) if not any(r in m for m in SETS[n])]
    assert all(out[r] is None for r in outside)


def test_grouped_adasum_is_per_tensor(adasum_run):
    """The grouped form reduces tensor by tensor (no fusion), so each
    result is that tensor's own allreduce, bit for bit."""
    n, xs, out = adasum_run
    for members in SETS[n]:
        for r in members:
            single, grouped = out[r]
            for a, b in zip(single, grouped):
                np.testing.assert_array_equal(a.view(np.uint32),
                                              b.view(np.uint32))


def test_identical_rows_are_a_fixed_point(world):
    """adasum(a, …, a) = a through the pre-fold and post-scatter (n = 3)."""
    row = np.random.RandomState(43).randn(6).astype(np.float32)
    out = world.run("adasum", sets=SETS[3],
                    per_rank=[{"xs": [row]} for _ in range(N)])
    for r in SETS[3][0]:
        np.testing.assert_allclose(out[r][0][0], row, rtol=1e-5)
