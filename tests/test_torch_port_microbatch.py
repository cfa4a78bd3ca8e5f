"""The PyTorch port's microbatch step against the JAX reference:
``make_train_step(microbatches=, overlap=)`` on a 2-rank gloo world.

Mirrors ``tests/test_microbatch.py``'s ``TestMicrobatchEquivalence``:
overlapped and non-overlapped N-microbatch steps of the toy regression
match the single-batch step within rtol 2e-5 / atol 1e-6 (params and
optimizer state), through a plain optimizer (the step reduces, on the
overlap wire) and through ``DistributedOptimizer`` (it reduces once);
the bf16 and int8 overlap wires stay close to exact; an explicit count
that does not divide the batch raises and a config-driven one snaps
down.  ``TestBoundedRecompile`` counts jax retraces and has no
counterpart (ROADMAP R3).  Each case is also held to the reference's
``make_train_step`` on the first two devices of the CPU mesh, each rank
on its rows of the global batch; a narrow GPT takes microbatched steps
on the int8 wire at ``tests/test_torch_port_train.py``'s tolerances.

The gloo world is spawned once for the module
(``tests/torch_port_workers.py``; its workers import no JAX).
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
from horovod_tpu.optim.distributed_optimizer import (
    DistributedOptimizer as JaxDistributedOptimizer,
    make_train_step as jax_make_train_step,
)

from horovod_tpu_torch.optim.distributed_optimizer import (
    _resolve_microbatches, snap_microbatches)

import torch_port_workers as workers

N = 2
TOL = dict(rtol=2e-5, atol=1e-6)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = workers.World(N, str(tmp_path_factory.mktemp("gloo") / "store"))
    yield w
    w.close()


def _mesh():
    return Mesh(np.array(jax.devices()[:N]), ("hvd",))


def _data(n=64, d=5, seed=0):
    rng = np.random.RandomState(seed)
    w_true = rng.randn(d).astype(np.float32)
    x = rng.randn(n, d).astype(np.float32)
    y = x @ w_true + 0.01 * rng.randn(n).astype(np.float32)
    return x, y


def _jax_loss(params, batch):
    x, y = batch
    return jnp.mean((x @ params["w"] + params["b"] - y) ** 2)


def _jax_steps(tx, steps, wrap=False, **kw):
    """The reference's toy steps on two slots: (params, losses)."""
    x, y = _data()
    params = {"w": jnp.zeros((5,), jnp.float32),
              "b": jnp.zeros((), jnp.float32)}
    if wrap:
        tx = JaxDistributedOptimizer(tx)
    step = jax_make_train_step(_jax_loss, tx, mesh=_mesh(), donate=False,
                               **kw)
    state = tx.init(params)
    losses = []
    for _ in range(steps):
        params, state, loss = step(params, state, (x, y))
        losses.append(float(loss))
    return {k: np.asarray(v) for k, v in params.items()}, losses


def _toy(world, **kw):
    x, y = _data()
    return world.run("toy_steps", x=x, y=y, **kw)


def _close(a, b, **tol):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(np.asarray(a[k], np.float64),
                                   np.asarray(b[k], np.float64), **tol)


def _replicas_equal(out):
    for k in out[0]["params"]:
        np.testing.assert_array_equal(out[1]["params"][k],
                                      out[0]["params"][k])


class TestMicrobatchEquivalence:
    @pytest.mark.parametrize("overlap", [True, False])
    def test_matches_sequential_multi_step(self, world, overlap):
        seq = _toy(world, optimizer="adam", lr=0.05, steps=3)
        mbd = _toy(world, optimizer="adam", lr=0.05, steps=3,
                   microbatches=4, overlap=overlap)
        _replicas_equal(mbd)
        _close(seq[0]["params"], mbd[0]["params"], **TOL)
        _close(seq[0]["state"], mbd[0]["state"], **TOL)
        np.testing.assert_allclose(seq[0]["losses"][-1],
                                   mbd[0]["losses"][-1], rtol=1e-5)
        ref, ref_losses = _jax_steps(optax.adam(0.05), 3, microbatches=4,
                                     overlap=overlap)
        _close(mbd[0]["params"], ref, **TOL)
        np.testing.assert_allclose(mbd[0]["losses"], ref_losses, rtol=1e-5)

    def test_per_rank_microbatch_count_uses_full_split(self, world):
        # 32 rows a rank, 32 microbatches of one row each.
        seq = _toy(world, optimizer="sgd", lr=0.1, steps=1)
        mbd = _toy(world, optimizer="sgd", lr=0.1, steps=1, microbatches=32)
        _close(seq[0]["params"], mbd[0]["params"], **TOL)

    def test_with_distributed_optimizer(self, world):
        """DistributedOptimizer reduces: the microbatches accumulate
        locally and the optimizer reduces once."""
        seq = _toy(world, optimizer="sgd", lr=0.1, steps=2, wrap=True)
        mbd = _toy(world, optimizer="sgd", lr=0.1, steps=2, wrap=True,
                   microbatches=4)
        _replicas_equal(mbd)
        _close(seq[0]["params"], mbd[0]["params"], **TOL)
        ref, _ = _jax_steps(optax.sgd(0.1), 2, wrap=True, microbatches=4)
        _close(mbd[0]["params"], ref, **TOL)

    @pytest.mark.parametrize("comp", ["bf16", "int8"])
    def test_compressed_overlap_wire_close_to_exact(self, world, comp):
        exact = _toy(world, optimizer="sgd", lr=0.1, steps=1)
        lossy = _toy(world, optimizer="sgd", lr=0.1, steps=1,
                     microbatches=4, overlap=True, compression=comp)
        _replicas_equal(lossy)
        _close(exact[0]["params"], lossy[0]["params"], rtol=5e-2, atol=5e-2)
        ref, _ = _jax_steps(optax.sgd(0.1), 1, microbatches=4, overlap=True,
                            compression=getattr(JaxCompression, comp))
        _close(lossy[0]["params"], ref, rtol=5e-2, atol=5e-2)

    def test_explicit_nondivisor_raises(self, world):
        with pytest.raises(RuntimeError, match="does not divide"):
            _toy(world, optimizer="sgd", lr=0.1, steps=1, microbatches=3)

    def test_config_driven_count_snaps_to_divisor(self, world):
        # 32 rows a rank: HVD_TPU_MICROBATCHES=3 snaps to 2.
        snapped = _toy(world, optimizer="sgd", lr=0.1, steps=1,
                       env={"HVD_TPU_MICROBATCHES": "3"})
        two = _toy(world, optimizer="sgd", lr=0.1, steps=1, microbatches=2)
        seq = _toy(world, optimizer="sgd", lr=0.1, steps=1, microbatches=1)
        assert np.isfinite(snapped[0]["losses"][0])
        for k, v in two[0]["params"].items():
            np.testing.assert_array_equal(snapped[0]["params"][k], v)
        _close(seq[0]["params"], snapped[0]["params"], **TOL)

    def test_resolve_microbatches_contract(self):
        batch = (torch.zeros(12, 3),)
        assert _resolve_microbatches(4, batch) == 4
        assert _resolve_microbatches(1, batch) == 1
        assert _resolve_microbatches(None, batch) == 1
        with pytest.raises(ValueError, match="does not divide"):
            _resolve_microbatches(5, batch)
        with pytest.raises(ValueError, match="does not divide"):
            _resolve_microbatches(24, batch)
        assert [snap_microbatches(r, 12) for r in (1, 5, 7, 12, 40)] \
            == [1, 4, 6, 12, 12]


# --- a narrow GPT: microbatches on the int8 wire ----------------------------------

CFG = dict(vocab_size=256, n_layer=2, n_head=4, d_model=64, d_ff=256,
           max_seq_len=64, attention="flash")
T, GLOBAL_BATCH, STEPS = 64, 8, 3


def test_gpt_microbatch_int8_steps_match_jax(world):
    """Three AdamW steps of ``make_train_step(microbatches=2,
    compression=int8)`` with a plain optimizer, so the step reduces on
    the int8 overlap wire, against the reference's step; the tolerances
    of the int8 case of ``tests/test_torch_port_train.py``."""
    model = JaxGPT(JaxGPTConfig(**CFG, dtype=jnp.float32))
    tokens = np.random.RandomState(3).randint(
        0, CFG["vocab_size"], (GLOBAL_BATCH, T + 1)).astype(np.int32)
    params = model.init(jax.random.PRNGKey(1),
                        jnp.asarray(tokens[:1, :-1]))["params"]
    params0 = jax.tree.map(lambda a: np.array(a, copy=True), params)
    tx = optax.adamw(3e-4)
    step = jax_make_train_step(jax_lm_loss_fn(model), tx, mesh=_mesh(),
                               donate=False, microbatches=2,
                               compression=JaxCompression.int8)
    state = tx.init(params)
    batch = (jnp.asarray(tokens[:, :-1]), jnp.asarray(tokens[:, 1:]))
    ref_losses = []
    for _ in range(STEPS):
        params, state, loss = step(params, state, batch)
        ref_losses.append(float(loss))
    ref = {".".join(str(k.key) for k in path): np.asarray(leaf)
           for path, leaf in jax.tree_util.tree_leaves_with_path(params)}
    out = world.run("train_gpt", config={**CFG, "dtype": "float32"},
                    params=params0, tokens=tokens, compression="int8",
                    error_feedback=False, steps=STEPS, wrap=False,
                    microbatches=2)
    _replicas_equal(out)
    diffs = np.concatenate([np.abs(out[0]["params"][n] - ref[n]).ravel()
                            for n in ref])
    assert np.mean(diffs > 2e-6) <= 1e-3, np.mean(diffs > 2e-6)
    assert diffs.max() <= STEPS * 3e-4, diffs.max()
    losses = np.asarray(out[0]["losses"])
    np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=1e-4)
    assert losses[-1] < losses[0]
