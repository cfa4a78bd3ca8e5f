"""PyTorch port against the JAX reference: the ZeRO-1 train step
(``horovod_tpu_torch/optim/zero.py``) on a 2-rank gloo world.

The JAX ``make_zero_train_step`` runs here on the first two devices of
the CPU mesh; the port's ranks (``tests/torch_port_workers.py``) import
no JAX.  Both sides start from the same numpy parameters and batches.
The optimizer state is not converted: it is compared through the
results it produces.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from horovod_tpu.models.transformer import GPT as JaxGPT
from horovod_tpu.models.transformer import GPTConfig as JaxGPTConfig
from horovod_tpu.models.transformer import lm_loss_fn as jax_lm_loss_fn
from horovod_tpu.ops.compression import Compression as JaxCompression
from horovod_tpu.optim.zero import make_zero_train_step as jax_zero_step

import horovod_tpu as jhvd
import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops.compression import Compression

import torch_port_workers as workers

N = 2
CFG = dict(vocab_size=256, n_layer=2, n_head=4, d_model=64, d_ff=256,
           max_seq_len=128)
T, GLOBAL_BATCH, STEPS = 128, 4, 3


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = workers.World(N, str(tmp_path_factory.mktemp("gloo") / "store"))
    yield w
    w.close()


def _mesh():
    return Mesh(np.array(jax.devices()[:N]), ("hvd",))


def _leaves(tree):
    return {".".join(str(k.key) for k in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _gpt_start():
    """(flax model, its initial params as numpy, the global tokens)."""
    model = JaxGPT(JaxGPTConfig(**CFG, attention="full", dtype=jnp.float32))
    tokens = np.random.RandomState(7).randint(
        0, CFG["vocab_size"], (GLOBAL_BATCH, T + 1)).astype(np.int32)
    params = model.init(jax.random.PRNGKey(3),
                        jnp.asarray(tokens[:1, :-1]))["params"]
    return model, jax.tree.map(np.asarray, params), tokens


def _jax_train(model, params, tokens, compression, error_feedback):
    init, step = jax_zero_step(jax_lm_loss_fn(model), optax.adamw(3e-4),
                               mesh=_mesh(), compression=compression,
                               error_feedback=error_feedback, donate=False)
    state = init(params)
    batch = (jnp.asarray(tokens[:, :-1]), jnp.asarray(tokens[:, 1:]))
    losses = []
    for _ in range(STEPS):
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
    return losses, _leaves(params)


@pytest.mark.parametrize("wire", ["none", "int8_ef"])
def test_gpt_zero_steps_match_jax(world, wire):
    """Three ZeRO AdamW steps (``optax.adamw(3e-4)``, weight decay 1e-4)
    from the same weights and batch.  The tolerances are those of the
    data-parallel step (``tests/test_torch_port_train.py``), for the same
    reasons: the frameworks sum in other orders, Adam's first updates are
    ~lr whatever the rounding, and on the int8 wire a value at a
    half-way point of the grid can round the other way in one framework,
    which error feedback carries on."""
    model, params, tokens = _gpt_start()
    int8 = wire == "int8_ef"
    ref_losses, ref_params = _jax_train(
        model, params, tokens, JaxCompression.int8 if int8 else None, int8)
    out = world.run(
        "train_gpt", config={**CFG, "attention": "full", "dtype": "float32"},
        params=params, tokens=tokens, compression="int8" if int8 else "none",
        error_feedback=int8, steps=STEPS, zero=True)
    # The parameter all-gather is exact: the replicas agree bit for bit.
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
    if int8:
        np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=1e-4)
        assert diffs.max() <= STEPS * 3e-4, diffs.max()
    else:
        np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=1e-5)
        assert diffs.max() <= 1e-4, diffs.max()
    assert losses[-1] < losses[0]


def test_zero_state_is_sharded_and_buckets_are_invisible(world):
    """Each rank's AdamW moments hold ``ceil(L / n)`` elements of every
    leaf of L.  On the exact wire the bucket plan does not change the
    result: a leaf per bucket (threshold 1 byte) gives the same bits as
    one bucket."""
    _, params, tokens = _gpt_start()
    run = dict(config={**CFG, "attention": "full", "dtype": "float32"},
               params=params, tokens=tokens, compression="none",
               error_feedback=False, steps=2, zero=True)
    one = world.run("train_gpt", **run)
    many = world.run("train_gpt", env={"HOROVOD_FUSION_THRESHOLD": "1"},
                     **run)
    sizes = {n: int(np.prod(v.shape)) for n, v in _leaves(params).items()}
    for r in range(N):
        assert one[r]["buckets"] == 1
        assert many[r]["buckets"] == len(sizes)
        shapes = one[r]["state_shapes"]
        assert set(shapes) == set(sizes)
        for name, size in sizes.items():
            want = (-(-size // N),)
            assert shapes[name] == {"exp_avg": want, "exp_avg_sq": want}, name
        assert many[r]["losses"] == one[r]["losses"]
        for name, p in one[r]["params"].items():
            np.testing.assert_array_equal(many[r]["params"][name], p)


def _mixed_problem():
    """``tests/test_zero.py``'s mixed tree: a bf16 leaf, an f32 leaf and
    a zero-size leaf (values made in f32, rounded to bf16 by each side)."""
    rng = np.random.RandomState(3)
    w16 = rng.randn(8, 4).astype(np.float32)
    w32 = rng.randn(8, 4).astype(np.float32)
    wt = rng.randn(8, 4).astype(np.float32)
    x = rng.randn(16, 8).astype(np.float32)
    return w16, w32, x, x @ wt


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_zero_size_and_mixed_dtype_leaves(world, compression):
    """Zero-size leaves pass through; bf16 and f32 leaves ride buckets of
    their own dtype and keep it.  Against the JAX step with
    ``optax.sgd(0.05)``: f32 leaves to 1e-5; the bf16 leaf to one bf16
    rounding (the port's SGD rounds ``p - lr g`` once, optax rounds the
    update to bf16 first)."""
    w16, w32, x, y = _mixed_problem()
    params = {"w16": jnp.asarray(w16, jnp.bfloat16),
              "w32": jnp.asarray(w32), "empty": jnp.zeros((0,), jnp.float32)}

    def loss_fn(p, batch):
        bx, by = batch
        pred = bx @ (p["w16"].astype(jnp.float32) + p["w32"])
        return jnp.mean((pred - by) ** 2) + jnp.sum(p["empty"])

    comp = JaxCompression.int8 if compression == "int8" else None
    init, step = jax_zero_step(loss_fn, optax.sgd(0.05), mesh=_mesh(),
                               compression=comp, error_feedback=False,
                               donate=False)
    state, ref, ref_losses = init(params), params, []
    for _ in range(2):
        ref, state, loss = step(ref, state, (jnp.asarray(x), jnp.asarray(y)))
        ref_losses.append(float(loss))
    out = world.run("zero_toy", problem="mixed", lr=0.05, steps=2,
                    compression=compression,
                    leaves={"w16": (w16, "bfloat16"), "w32": (w32, "float32"),
                            "empty": (np.zeros((0,), np.float32), "float32")},
                    data={"x": x, "y": y})
    for r in range(N):
        got = out[r]["params"]
        assert got["empty"][0].shape == (0,)
        assert got["w16"][1] == "torch.bfloat16"
        assert got["w32"][1] == "torch.float32"
        np.testing.assert_allclose(got["w32"][0], np.asarray(ref["w32"]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["w16"][0],
                                   np.asarray(ref["w16"], np.float32),
                                   rtol=2 ** -7, atol=0)
        np.testing.assert_allclose(out[r]["losses"], ref_losses, rtol=1e-3)
        assert out[r]["losses"][1] < out[r]["losses"][0]


def test_small_updates_survive_the_int8_wire(world):
    """``tests/test_zero.py``'s regression: only the gradient wire is
    quantized, the parameter all-gather is exact, so SGD at lr 1e-5 (an
    update far below the int8 grid of the weights, ~2.4e-3) still moves
    the weights."""
    rng = np.random.RandomState(3)
    d = 16
    x = rng.randn(32, d).astype(np.float32)
    y = rng.randn(32).astype(np.float32)
    w = (rng.randn(d, d) * 0.1).astype(np.float32)
    v = (rng.randn(d) * 0.1).astype(np.float32)
    out = world.run("zero_toy", problem="tanh", lr=1e-5, steps=10,
                    compression="int8",
                    leaves={"w": (w, "float32"), "v": (v, "float32")},
                    data={"x": x, "y": y})
    drift = np.abs(out[0]["params"]["w"][0] - w).max()
    assert 0 < drift < 1e-3, drift
    np.testing.assert_array_equal(out[1]["params"]["w"][0],
                                  out[0]["params"]["w"][0])


def test_reference_keywords_match_the_dp_oracle(world):
    """F7: ``make_train_step(distributed=, mesh=, axis_name=)`` and
    ``make_zero_train_step(has_aux=, mesh=, axis_name=)`` take the
    reference's keywords.  The port's two DP steps (a plain optimizer
    with ``distributed=True`` on an explicit mesh, and a
    ``DistributedOptimizer`` with ``distributed=False``) against the
    reference's DP oracle of ``tests/test_zero.py:51`` (4 steps of
    SGD(0.1, momentum 0.9)): losses within rtol 1e-5, parameters within
    rtol 1e-4 / atol 1e-5.  ZeRO with ``op=Sum`` and ``has_aux``
    (``tests/test_zero.py:93``): the reference stacks the slots' auxes,
    the port returns each rank's own, so rank ``r``'s aux is the
    reference's slot ``r`` (rtol 1e-6); the parameters within rtol 1e-5
    / atol 1e-6."""
    from test_zero import _toy_problem

    params, loss_fn, make_batch = _toy_problem()
    x, y = (np.asarray(a) for a in make_batch(8 * N))
    tx = optax.sgd(0.1, momentum=0.9)
    ref_step = jhvd.make_train_step(loss_fn, tx, mesh=_mesh(),
                                    axis_name="hvd", distributed=True,
                                    donate=False)
    rp, rs = params, tx.init(params)
    for _ in range(4):
        rp, rs, rloss = ref_step(rp, rs, (jnp.asarray(x), jnp.asarray(y)))

    def loss_aux(p, batch):
        loss = loss_fn(p, batch)
        return loss, {"loss_copy": loss}

    init, zstep = jax_zero_step(loss_aux, optax.sgd(0.01), mesh=_mesh(),
                                op=jhvd.Sum, has_aux=True, donate=False)
    zp, _, zloss, zaux = zstep(params, init(params),
                               (jnp.asarray(x), jnp.asarray(y)))
    out = world.run("keyword_steps", w=np.asarray(params["w"]), x=x, y=y,
                    steps=4)
    for r in range(N):
        for kind in ("dp", "dist_opt"):
            got = out[r][kind]
            np.testing.assert_allclose(got["losses"][-1], float(rloss),
                                       rtol=1e-5)
            for name in params:
                np.testing.assert_allclose(got["params"][name],
                                           np.asarray(rp[name]), rtol=1e-4,
                                           atol=1e-5, err_msg=kind + name)
        z = out[r]["zero"]
        np.testing.assert_allclose(z["aux"], float(zaux["loss_copy"][r]),
                                   rtol=1e-6)
        np.testing.assert_allclose(z["loss"], float(zloss), rtol=1e-6)
        for name in params:
            np.testing.assert_allclose(z["params"][name],
                                       np.asarray(zp[name]), rtol=1e-5,
                                       atol=1e-6, err_msg=name)


def test_fsdp_keeps_torch_weight_tying(world):
    """F8: an ``Embedding(8, 4)`` whose weight is also a ``Linear(4, 8)``'s,
    through ``make_fsdp_train_step`` on two ranks: every owner of the
    shared parameter sees the whole weight, and 3 Adam steps match the
    data-parallel step within ``tests/test_torch_port_fsdp.py``'s limits
    (losses rtol 1e-4, the weight rtol 2e-4 / atol 1e-6)."""
    rng = np.random.RandomState(5)
    emb = rng.randn(8, 4).astype(np.float32)
    tokens = rng.randint(0, 8, (4, 6)).astype(np.int64)
    targets = rng.randint(0, 8, (4, 6)).astype(np.int64)
    out = world.run("tied_fsdp", emb=emb, tokens=tokens, targets=targets,
                    steps=3)
    for r in range(N):
        dp, fsdp = out[r]["dp"], out[r]["fsdp"]
        np.testing.assert_allclose(fsdp["losses"], dp["losses"], rtol=1e-4)
        np.testing.assert_allclose(fsdp["weight"], dp["weight"], rtol=2e-4,
                                   atol=1e-6)
        assert fsdp["losses"][-1] < fsdp["losses"][0]


def test_zero_rejects_adasum():
    with pytest.raises(ValueError, match="Average/Sum"):
        hvd.make_zero_train_step(lambda m, b: 0, torch.optim.SGD,
                                 op="adasum")


def test_int8_reducescatter_wants_a_flat_input():
    with pytest.raises(ValueError, match="flat 1-D"):
        Compression.int8.spmd_reducescatter(torch.zeros(4, 2), op="sum")
    with pytest.raises(ValueError, match="sum/average"):
        Compression.int8.spmd_reducescatter(torch.zeros(8), op="max")
