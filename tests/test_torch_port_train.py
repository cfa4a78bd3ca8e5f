"""PyTorch port against the JAX reference on a 2-rank gloo world: the
int8 allreduce (bitwise), the collectives, the broadcasts, and GPT
data-parallel training steps under the exact and the int8+EF wires.

The gloo world is spawned once for the module; its workers
(``tests/torch_port_workers.py``) import no JAX.  The JAX reference runs
here, on the first two devices of the CPU mesh, and is handed to the
workers as numpy arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu._compat import shard_map
from horovod_tpu.models.transformer import GPT as JaxGPT
from horovod_tpu.models.transformer import GPTConfig as JaxGPTConfig
from horovod_tpu.models.transformer import lm_loss_fn as jax_lm_loss_fn
from horovod_tpu.ops.compression import Compression as JaxCompression
from horovod_tpu.ops.quantization import int8_allreduce as jax_int8_allreduce
from horovod_tpu.optim.distributed_optimizer import (
    DistributedOptimizer as JaxDistributedOptimizer,
    make_train_step as jax_make_train_step,
)

import torch_port_workers as workers

N = 2


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = workers.World(N, str(tmp_path_factory.mktemp("gloo") / "store"))
    yield w
    w.close()


def _mesh():
    return Mesh(np.array(jax.devices()[:N]), ("hvd",))


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _contributions(size, seed):
    """Per-rank vectors with magnitudes spread over decades and a zero
    stretch, so blocks get distinct scales and one all-zero block."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(N, size) * 10.0 ** rng.uniform(-3, 1, (N, size)))
    x[:, : min(size, 1024)] = 0.0
    return x.astype(np.float32)


class TestInt8AllreduceBitwise:
    @pytest.mark.parametrize("op", ["sum", "average"])
    @pytest.mark.parametrize("size", [4096, 10001, 300])
    def test_matches_jax_wire(self, world, size, op):
        # 10001 is odd (pad to the world), 300 makes the block smaller
        # than 1024 (wire_block_size), 4096 spans several whole blocks.
        x = _contributions(size, seed=size)
        body = shard_map(lambda v: jax_int8_allreduce(v[0], op=op)[None],
                         mesh=_mesh(), in_specs=P("hvd"), out_specs=P("hvd"),
                         check=False)
        ref = np.asarray(body(jnp.asarray(x)))
        out = world.run("int8_allreduce", op=op,
                        per_rank=[{"x": x[r]} for r in range(N)])
        for r in range(N):
            np.testing.assert_array_equal(_bits(out[r]), _bits(ref[r]))


class TestCollectives:
    def test_sync_collectives(self, world):
        xs = [np.arange(6, dtype=np.float32).reshape(3, 2) + 10 * r
              for r in range(N)]
        splits = [[1, 2], [2, 1]]
        out = world.run("collectives",
                        per_rank=[{"x": xs[r], "splits": splits[r]}
                                  for r in range(N)])
        total = xs[0] + xs[1]
        for r in range(N):
            o = out[r]
            assert (o["rank"], o["size"]) == (r, N)
            np.testing.assert_array_equal(o["sum"], total)
            np.testing.assert_array_equal(o["average"], total / N)
            np.testing.assert_array_equal(o["scaled"], total * 0.5 * 3.0)
            np.testing.assert_array_equal(o["bf16"], total / N)
            np.testing.assert_array_equal(o["max"], xs[1])
            np.testing.assert_array_equal(o["allgather"],
                                          np.concatenate(xs))
            np.testing.assert_array_equal(o["broadcast"], xs[1])
        np.testing.assert_array_equal(
            out[0]["alltoall"], np.concatenate([xs[0][:1], xs[1][:2]]))
        np.testing.assert_array_equal(
            out[1]["alltoall"], np.concatenate([xs[0][1:], xs[1][2:]]))

    def test_broadcast_parameters_and_optimizer_state(self, world):
        out = world.run("broadcast_state", seed=3)
        assert out[0].keys() == out[1].keys()
        for key in out[0]:
            np.testing.assert_array_equal(out[1][key], out[0][key])
        assert out[1]["lr"] == out[0]["lr"] == 1e-3

    def test_optimizer_state_only_on_the_root(self, world):
        """A root that resumed with AdamW state and a rank that starts
        fresh: the broadcast creates the missing entries first, so both
        ranks broadcast the same tensors, and every rank ends with the
        root's state (F6)."""
        out = world.run("root_only_state", timeout=60)
        assert set(out[0]) == set(out[1])
        assert {"0.step", "0.exp_avg", "0.exp_avg_sq"} <= set(out[0])
        for key in out[0]:
            np.testing.assert_array_equal(out[1][key], out[0][key])
        assert out[1]["lr"] == out[0]["lr"] == 1e-3


@pytest.mark.parametrize("wrap", [True, False],
                         ids=["distributed_optimizer", "make_train_step"])
def test_parameter_unused_on_one_rank(world, wrap):
    """Rank 1's forward never uses ``b``: its zero gradient still joins
    the fusion plan, so both ranks reduce the same buckets, the steps
    finish, and the replicas stay equal, ``b``'s reduced gradient
    non-zero on both (F5)."""
    out = world.run("unused_parameter", wrap=wrap, steps=2, timeout=60)
    for name, p in out[0]["params"].items():
        np.testing.assert_array_equal(out[1]["params"][name], p)
    for name, g in out[0]["grads"].items():
        np.testing.assert_array_equal(out[1]["grads"][name], g)
    assert np.abs(out[0]["grads"]["b.weight"]).max() > 0


# --- GPT train steps against JAX make_train_step ------------------------------

CFG = dict(vocab_size=256, n_layer=2, n_head=4, d_model=64, d_ff=256,
           max_seq_len=128)
T, GLOBAL_BATCH, STEPS = 128, 4, 3


def _start(attention):
    """(flax model, its initial params, the global batch's tokens)."""
    model = JaxGPT(JaxGPTConfig(**CFG, attention=attention,
                                dtype=jnp.float32))
    tokens = np.random.RandomState(7).randint(
        0, CFG["vocab_size"], (GLOBAL_BATCH, T + 1)).astype(np.int32)
    params = model.init(jax.random.PRNGKey(3),
                        jnp.asarray(tokens[:1, :-1]))["params"]
    return model, params, tokens


def _jax_train(attention, compression, error_feedback):
    model, params, tokens = _start(attention)
    params0 = jax.tree.map(lambda a: np.array(a, copy=True), params)
    tx = JaxDistributedOptimizer(optax.adamw(3e-4), compression=compression,
                                 error_feedback=error_feedback)
    step = jax_make_train_step(jax_lm_loss_fn(model), tx, mesh=_mesh(),
                               donate=False)
    opt_state = tx.init(params)
    batch = (jnp.asarray(tokens[:, :-1]), jnp.asarray(tokens[:, 1:]))
    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))
    final = {".".join(str(k.key) for k in path): np.asarray(leaf)
             for path, leaf in jax.tree_util.tree_leaves_with_path(params)}
    return params0, tokens, losses, final


@pytest.mark.parametrize("wire,attention", [("none", "full"),
                                            ("int8_ef", "flash")])
def test_gpt_train_steps_match_jax(world, wire, attention):
    """Three AdamW steps (optax.adamw(3e-4): weight decay 1e-4 on every
    leaf) from the same weights and batch.  The int8+EF case runs the
    whole slice: flash attention, the int8 wire and error feedback.

    Tolerances: the two frameworks sum the matmuls in other orders, so
    gradients differ by f32 rounding, and the losses agree to 1e-5 on
    the exact wire.  Adam's step-one update g / (|g| + 1e-8) is ~lr for
    almost every element whatever the rounding, so parameters agree to
    2e-6; an element whose gradient is near Adam's eps, or has cancelled
    down to rounding noise, can move by a fraction of lr instead.  So at
    most 0.1% of the parameters may differ by more than 2e-6, and none
    by more than 1e-4 (a third of one step).  On the int8 wire a value
    within that rounding of a half-way point between two quantization
    levels can round the other way in one framework: that element's
    update then differs by up to ~lr a step, and error feedback carries
    the difference on; there the losses are held to 1e-4 and no
    parameter may differ by more than 3 steps × lr."""
    compression = JaxCompression.int8 if wire == "int8_ef" else None
    params0, tokens, ref_losses, ref_params = _jax_train(
        attention, compression, wire == "int8_ef")
    out = world.run(
        "train_gpt", config={**CFG, "attention": attention, "dtype": "float32"},
        params=params0, tokens=tokens,
        compression="int8" if wire == "int8_ef" else "none",
        error_feedback=wire == "int8_ef", steps=STEPS)
    # Replicas agree bit for bit: the same reduced gradient everywhere.
    for name in out[0]["params"]:
        np.testing.assert_array_equal(out[1]["params"][name],
                                      out[0]["params"][name])
    assert out[0]["losses"] == out[1]["losses"]
    losses = np.asarray(out[0]["losses"])
    assert set(out[0]["params"]) == set(ref_params)
    diffs = np.concatenate([
        np.abs(out[0]["params"][n] - ref_params[n]).ravel()
        for n in ref_params])
    assert np.mean(diffs > 2e-6) <= 1e-3, np.mean(diffs > 2e-6)
    if wire == "none":
        np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=1e-5)
        assert diffs.max() <= 1e-4, diffs.max()
    else:
        np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=1e-4)
        assert diffs.max() <= STEPS * 3e-4, diffs.max()
    # The steps trained: the loss went down.
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("wire", ["none", "int8"])
def test_step_with_a_plain_optimizer_reduces_itself(world, wire):
    """Given a plain torch optimizer, make_train_step allreduces the
    gradients itself, on the same buckets in the same order as a
    DistributedOptimizer (without error feedback): the two runs agree
    bit for bit."""
    _, params, tokens = _start("full")
    run = dict(config={**CFG, "attention": "full", "dtype": "float32"},
               params=jax.tree.map(np.asarray, params), tokens=tokens,
               compression=wire, error_feedback=False, steps=2)
    wrapped = world.run("train_gpt", **run)
    plain = world.run("train_gpt", wrap=False, **run)
    for r in range(N):
        assert plain[r]["losses"] == wrapped[r]["losses"]
        for name, p in wrapped[r]["params"].items():
            np.testing.assert_array_equal(plain[r]["params"][name], p)


def test_distributed_optimizer_needs_parameter_names():
    """The fused buckets follow the parameters' names, so an optimizer
    with unnamed parameters refuses to reduce rather than pick another
    order."""
    import torch

    import horovod_tpu_torch as hvd

    p = torch.nn.Parameter(torch.ones(3))
    p.grad = torch.ones(3)
    opt = hvd.DistributedOptimizer(torch.optim.SGD([p], lr=0.1))
    with pytest.raises(ValueError, match="names"):
        opt.step()
    with pytest.raises(ValueError, match="no name"):
        hvd.DistributedOptimizer(torch.optim.SGD([p], lr=0.1),
                                 named_parameters=[])
