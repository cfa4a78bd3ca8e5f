"""PyTorch port against the JAX reference: the fused collectives of
``horovod_tpu_torch/ops/fused_collectives.py`` (the int8 wire under the
Pallas tier's names, the all-gather + SGD/Adam apply, the unshard
matmul) on a 2-rank gloo world.

The JAX side runs on the first two devices of the CPU mesh, its Pallas
kernels in interpret mode.  On this host the port's kernel wrappers get
CPU tensors and run their plain versions; ``tests/test_torch_port_cuda.py``
and ``chip_smoke.py`` hold the CUDA kernels to those on a card.  The
tolerances are the reference's own (``tests/test_pallas_collectives.py``):
1e-6 for the apply epilogues, 1e-5 for the matmul, and bit for bit for
the wire, held to the SPMD reference ``ops/quantization.py`` (ROADMAP
C1).  ``world size 1`` cases run in this process, where no process group
exists.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu._compat import shard_map
from horovod_tpu.ops import pallas_collectives as jax_pc
from horovod_tpu.ops import quantization as jax_q

import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import fused_collectives as fc
from horovod_tpu_torch.ops import kernel_common as kc
from horovod_tpu_torch.ops import quantization as q8

import torch_port_workers as workers

N = 2
B1, B2, EPS = 0.9, 0.999, 1e-8


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = workers.World(N, str(tmp_path_factory.mktemp("gloo") / "store"))
    yield w
    w.close()


def _spmd(fn, *xs):
    """``fn`` on each of the two slots of the CPU mesh, inputs and
    output split over dim 0."""
    mesh = Mesh(np.array(jax.devices()[:N]), ("hvd",))
    body = shard_map(fn, mesh=mesh, in_specs=(P("hvd"),) * len(xs),
                     out_specs=P("hvd"), check=False)
    return np.asarray(body(*(jnp.asarray(x) for x in xs)))


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _apply_inputs(k, seed):
    rng = np.random.RandomState(seed)
    param = rng.randn(N * k).astype(np.float32)
    mu = (rng.randn(N * k) * 0.01).astype(np.float32)
    nu = (np.abs(rng.randn(N * k)) * 0.001).astype(np.float32)
    shards = rng.randn(N, k).astype(np.float32)
    return param, mu, nu, shards


# k = 300: the block is the whole shard; k = 1000 at blocks of 256 and
# k = 2500 at 1024: ragged last blocks, zero padded on the wire.
@pytest.mark.parametrize("k,block", [(300, 1024), (1000, 256), (2500, 1024)])
def test_allgather_apply_matches_jax(world, k, block):
    lr, step = 0.1, 3
    param, mu, nu, shards = _apply_inputs(k, seed=k)

    def jax_sgd(v):
        return jax_pc.fused_allgather_sgd_apply(
            param, v.reshape(-1), lr=lr, block_size=block,
            interpret=True)[None]

    def jax_adam(v):
        out = jax_pc.fused_allgather_adam_apply(
            param, mu, nu, v.reshape(-1), lr=lr, step=step, b1=B1, b2=B2,
            eps=EPS, block_size=block, interpret=True)
        return jnp.stack(out)[None]

    ref_sgd, ref_adam = _spmd(jax_sgd, shards), _spmd(jax_adam, shards)
    out = world.run("fused_apply", param=param, mu=mu, nu=nu, lr=lr,
                    step=step, block_size=block,
                    per_rank=[{"shard": shards[r]} for r in range(N)])
    for r in range(N):
        np.testing.assert_allclose(out[r]["sgd"], ref_sgd[r],
                                   atol=1e-6, rtol=1e-6)
        for got, ref in zip(out[r]["adam"], ref_adam[r]):
            np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)
    # Every rank gathers the same int8 gradient: the results agree bitwise.
    np.testing.assert_array_equal(_bits(out[0]["sgd"]), _bits(out[1]["sgd"]))
    for a, b in zip(out[0]["adam"], out[1]["adam"]):
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_allgather_apply_world_of_one():
    """n = 1: the reference's plain update of the whole leaf, no wire and
    no kernel."""
    rng = np.random.RandomState(11)
    param, mu, grad = (rng.randn(3, 40).astype(np.float32) for _ in range(3))
    nu = np.abs(mu) * 0.01
    kc.reset_launch_counts()
    t = [torch.from_numpy(a) for a in (param, mu, nu, grad)]
    sgd = fc.fused_allgather_sgd_apply(t[0], t[3], lr=0.05)
    adam = fc.fused_allgather_adam_apply(*t, lr=0.05, step=2)
    ref_sgd = jax_pc.fused_allgather_sgd_apply(param, grad, lr=0.05,
                                               groups=[[0]])
    ref_adam = jax_pc.fused_allgather_adam_apply(param, mu, nu, grad,
                                                 lr=0.05, step=2,
                                                 groups=[[0]])
    assert sgd.shape == param.shape
    np.testing.assert_allclose(sgd.numpy(), ref_sgd, atol=1e-6, rtol=1e-6)
    for got, ref in zip(adam, ref_adam):
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=1e-6)
    assert set(kc.launch_counts().values()) == {0}


def test_adam_apply_rejects_step_zero():
    z = torch.zeros(8)
    with pytest.raises(ValueError, match="step"):
        fc.fused_allgather_adam_apply(z, z, z, z, lr=0.1, step=0)


@pytest.mark.parametrize("m,k,nl", [(24, 96, 40), (130, 600, 72)])
def test_matmul_allgather_matches_jax(world, m, k, nl):
    """``x @ w_shard`` then the activation all-gather, rank-major
    columns; 600 spans two of the reference's K panels of 512, and 130
    and 72 are not multiples of any tile.  The weight has a layer's
    scale (variance 1/K), so the outputs are O(1) and 1e-5 holds the two
    frameworks' f32 sums, taken in other orders, to a few ulp."""
    rng = np.random.RandomState(m + k)
    x = rng.randn(m, k).astype(np.float32)
    w = (rng.randn(N, k, nl) / np.sqrt(k)).astype(np.float32)
    ref = _spmd(lambda wl: jax_pc.fused_matmul_allgather(
        jnp.asarray(x), wl.reshape(k, nl), interpret=True)[None], w)
    out = world.run("fused_matmul", x=x,
                    per_rank=[{"w_shard": w[r]} for r in range(N)])
    gathered = np.concatenate(list(w), axis=1)           # [K, N] rank-major
    for r in range(N):
        assert out[r].shape == (m, N * nl)
        np.testing.assert_allclose(out[r], ref[r], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out[r], x @ gathered, rtol=1e-5,
                                   atol=1e-5)


def test_matmul_world_of_one_and_bf16():
    """n = 1: the kernel's tile is the result, in x's dtype."""
    rng = np.random.RandomState(10)
    x = rng.randn(8, 16).astype(np.float32)
    w = rng.randn(16, 24).astype(np.float32)
    got = hvd.optim.unshard_matmul(torch.from_numpy(x), torch.from_numpy(w))
    ref = jax_pc.fused_matmul_allgather(jnp.asarray(x), jnp.asarray(w),
                                        groups=[[0]], interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = fc.fused_matmul_allgather(xb, torch.from_numpy(w))
    ref = jax_pc.fused_matmul_allgather(jnp.asarray(x, jnp.bfloat16),
                                        jnp.asarray(w), groups=[[0]],
                                        interpret=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=1e-2,
                               atol=1e-2)


def test_matmul_refuses_gradients_and_bad_shapes():
    x = torch.randn(4, 6, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        fc.fused_matmul_allgather(x, torch.randn(6, 3))
    with torch.no_grad():
        assert fc.fused_matmul_allgather(x, torch.randn(6, 3)).shape == (4, 3)
    with pytest.raises(ValueError, match=r"x \[M, K\]"):
        fc.fused_matmul_allgather(torch.randn(4, 6), torch.randn(5, 3))


@pytest.mark.parametrize("op", ["sum", "average"])
def test_fused_wire_names_match_spmd_reference(world, op):
    """The Pallas tier's names are the port's int8 wire, bit for bit
    the SPMD reference's (not the Pallas tier's: ROADMAP C1)."""
    assert fc.fused_quantize_reducescatter is q8.int8_reducescatter
    assert fc.fused_quantize_allgather is q8.int8_allgather
    assert fc.fused_allreduce is q8.int8_allreduce
    rng = np.random.RandomState(5)
    x = (rng.randn(N, N * 1500) * 10.0 ** rng.uniform(-2, 2, (N, 1)))
    x = x.astype(np.float32)
    shards = rng.randn(N, 700).astype(np.float32)
    rs = _spmd(lambda v: jax_q.int8_reducescatter(v[0], op=op)[None], x)
    ag = _spmd(lambda v: jax_q.int8_allgather(v[0])[None], shards)
    ar = _spmd(lambda v: jax_q.int8_allreduce(v[0], op=op)[None], x)
    out = world.run("fused_wire", op=op,
                    per_rank=[{"x": x[r], "shard": shards[r]}
                              for r in range(N)])
    for r in range(N):
        np.testing.assert_array_equal(_bits(out[r]["rs"]), _bits(rs[r]))
        np.testing.assert_array_equal(_bits(out[r]["ag"]), _bits(ag[r]))
        np.testing.assert_array_equal(_bits(out[r]["ar"]), _bits(ar[r]))
