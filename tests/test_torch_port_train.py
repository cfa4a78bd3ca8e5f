"""PyTorch port against the JAX reference on a 2-rank gloo world: the
int8 allreduce (bitwise), the collectives, the broadcasts, GPT
data-parallel training steps under the exact and the int8+EF wires,
and the model zoo's multi-rank cases: BatchNorm synchronised over the
ranks (forward, statistics and gradients against ``shard_map``), a
narrow ResNet's data-parallel steps on the exact, fp16 and int8+EF
wires, and BERT fine-tuning with tensor fusion on the fp16 wire.

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
from horovod_tpu.models.bert import BertConfig as JaxBertConfig
from horovod_tpu.models.bert import \
    BertForSequenceClassification as JaxBertClassifier
from horovod_tpu.models.resnet import BasicBlock as JaxBasicBlock
from horovod_tpu.models.resnet import ResNet as JaxResNet
from horovod_tpu.models.transformer import GPT as JaxGPT
from horovod_tpu.models.transformer import GPTConfig as JaxGPTConfig
from horovod_tpu.models.transformer import lm_loss_fn as jax_lm_loss_fn
from horovod_tpu.ops import fusion as jax_fusion
from horovod_tpu.ops.compression import Compression as JaxCompression
from horovod_tpu.ops.quantization import int8_allreduce as jax_int8_allreduce
from horovod_tpu.optim.distributed_optimizer import (
    DistributedOptimizer as JaxDistributedOptimizer,
    make_train_step as jax_make_train_step,
)

import torch_port_workers as workers
from test_torch_port_bert import _weights as bert_weights
from test_torch_port_resnet import _named, random_variables

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


# --- the model zoo on two ranks ---------------------------------------------------

SMALL_RESNET = dict(stage_sizes=(1, 1), num_classes=4, width=8)
ZOO_THRESHOLD = 16 * 1024       # bytes: several fusion buckets


def _small_resnet(seed, bn_axis_name=None):
    """(flax narrow ResNet, params, batch_stats, images [8, 16, 16, 3],
    labels): two stages of one BasicBlock, width 8; the stride-2 stage
    pads flax's SAME way."""
    model = JaxResNet(**SMALL_RESNET, block=JaxBasicBlock,
                      bn_axis_name=bn_axis_name)
    rng = np.random.RandomState(seed)
    x = rng.randn(8, 16, 16, 3).astype(np.float32)
    labels = rng.randint(0, 4, 8).astype(np.int32)
    params, stats = random_variables(model, x[:1], seed)
    return model, params, stats, x, labels


def _leaf_close(got, want, what, rel=1e-4):
    """Every leaf within ``rel`` of its largest |value|."""
    assert set(got) == set(want), what
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0,
                                   atol=rel * float(np.abs(w).max()),
                                   err_msg=f"{what} {name}")


def test_sync_batch_norm_matches_shard_map(world):
    """Every BatchNorm of a narrow ResNet synchronised over the two ranks
    (``bn_process_set`` = the global set; the reference's
    ``bn_axis_name`` under ``shard_map`` on two CPU devices), each rank
    on its 4 rows: the logits, the running statistics (the same on both
    ranks), and the gradients of each rank's loss with respect to its
    parameters and its input, which run through the other rank's loss
    by way of the averaged statistics.  Tolerances: f32; logits within
    5e-5 of their scale, statistics within 1e-5 relative and 1e-6
    absolute, every gradient leaf within 1e-4 of its largest |value|."""
    model, params, stats, x, labels = _small_resnet(11, bn_axis_name="hvd")

    def body(p, xs, ls):
        def local(p, xs):
            logits, mutated = model.apply({"params": p, "batch_stats": stats},
                                          xs, mutable=["batch_stats"])
            logp = jax.nn.log_softmax(logits)
            ll = jnp.take_along_axis(logp, ls[:, None], axis=-1)
            return -jnp.mean(ll), (logits, mutated["batch_stats"])

        (_, (logits, new_stats)), (gp, gx) = jax.value_and_grad(
            local, argnums=(0, 1), has_aux=True)(p, xs)
        lead = lambda t: jax.tree.map(lambda a: a[None], t)  # noqa: E731
        return logits, gx, lead(gp), lead(new_stats)

    logits, gx, gp, new_stats = jax.jit(shard_map(
        body, mesh=_mesh(), in_specs=(P(), P("hvd"), P("hvd")),
        out_specs=(P("hvd"),) * 4, check=False))(params, x, labels)
    out = world.run("sync_batch_norm",
                    config={k: v for k, v in SMALL_RESNET.items()},
                    params=params, batch_stats=stats, x=x, labels=labels)
    b = x.shape[0] // N
    gp, new_stats = _named(gp), _named(new_stats)
    logits, gx = np.asarray(logits), np.asarray(gx)
    for r in range(N):
        rows = slice(r * b, (r + 1) * b)
        np.testing.assert_allclose(
            out[r]["logits"], logits[rows], rtol=0,
            atol=5e-5 * max(1.0, float(np.abs(logits).max())))
        _leaf_close({"x": out[r]["x_grad"]}, {"x": gx[rows]}, "input grad")
        _leaf_close(out[r]["grads"], {n: g[r] for n, g in gp.items()},
                    f"rank {r} grad")
        for name, want in new_stats.items():
            np.testing.assert_allclose(out[r]["stats"][name], want[r],
                                       rtol=1e-5, atol=1e-6, err_msg=name)
    for name in new_stats:
        np.testing.assert_array_equal(out[0]["stats"][name],
                                      out[1]["stats"][name])


def _nest(flat):
    """A flat ``{dotted name: leaf}`` as the nested dict flax keeps."""
    tree = {}
    for name, leaf in flat.items():
        *path, last = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def _reference_wire(per_rank, names):
    """The reference's fused int8 allreduce (``fused_allreduce_pytree``,
    average, the zoo's fusion threshold) of each rank's gradient leaves
    under ``shard_map``, compiled at backend optimization level 0 (the
    eager bits, ROADMAP R1): ``{name: [rank results]}``."""
    stacked = [jnp.asarray(np.stack([per_rank[r][n] for r in range(N)]))
               for n in names]

    def body(*xs):
        tree = _nest({n: x[0] for n, x in zip(names, xs)})
        out = jax_fusion.fused_allreduce_pytree(
            tree, axis="hvd", op="average", threshold=ZOO_THRESHOLD,
            compression=JaxCompression.int8)
        return tuple(leaf[None] for leaf in jax.tree.leaves(out))

    program = jax.jit(shard_map(
        body, mesh=_mesh(), in_specs=tuple(P("hvd") for _ in stacked),
        out_specs=tuple(P("hvd") for _ in stacked), check=False))
    out = program.lower(*stacked).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*stacked)
    return {n: np.asarray(o) for n, o in zip(names, out)}


@pytest.mark.parametrize("wire", ["none", "fp16", "int8_ef"])
def test_resnet_train_steps_match_jax(world, wire):
    """Three data-parallel steps of a narrow ResNet (plain BatchNorm in
    train mode, each rank's own statistics) with ``bench.py``'s
    ``optax.sgd(0.1, momentum=0.9)`` (torch's SGD with momentum 0.9)
    inside a DistributedOptimizer, against the reference's
    ``make_train_step`` (``has_aux`` carrying its mutated statistics).

    The int8+EF wire is held bit for bit where the layouts allow: the
    port's step-1 reduced gradients equal the reference's fused int8
    allreduce of the port's own step-1 gradients (same buckets, blocks
    and scales).  Tolerances: the replicas bitwise equal; step 1's
    running statistics within 1e-5 relative and 1e-6 absolute.  On the
    exact wire the gradients agree to f32 rounding, so the losses
    within 1e-5 and each parameter leaf within 1e-5 of its largest
    |value|.  On the fp16 and int8 wires a gradient within rounding of a
    half-way point between two levels can round the other way in one
    framework, a step of one fp16 ulp or one int8 level (scale/127) ×
    lr, which momentum (and on int8 error feedback) carries on: the
    losses within 1e-4, each parameter leaf within 1e-3 (fp16) or 1e-2
    (int8) of its largest |value|."""
    model, params, stats, x, labels = _small_resnet(12)
    comp = {"none": None, "fp16": JaxCompression.fp16,
            "int8_ef": JaxCompression.int8}[wire]
    tx = JaxDistributedOptimizer(optax.sgd(0.1, momentum=0.9),
                                 compression=comp,
                                 error_feedback=wire == "int8_ef",
                                 fusion_threshold=ZOO_THRESHOLD)

    def loss_fn(p, batch):
        images, labs = batch
        logits, mutated = model.apply({"params": p, "batch_stats": stats},
                                      images, mutable=["batch_stats"])
        logp = jax.nn.log_softmax(logits)
        ll = jnp.take_along_axis(logp, labs[:, None], axis=-1)
        return -jnp.mean(ll), mutated["batch_stats"]

    step = jax_make_train_step(loss_fn, tx, mesh=_mesh(), donate=False,
                               has_aux=True)
    ref_params, opt_state = params, tx.init(params)
    ref_losses = []
    for i in range(STEPS):
        ref_params, opt_state, loss, aux = step(
            ref_params, opt_state, (jnp.asarray(x), jnp.asarray(labels)))
        ref_losses.append(float(loss))
        if i == 0:
            ref_stats = _named(aux)
    ref_params = _named(ref_params)
    out = world.run("train_resnet", config=dict(SMALL_RESNET), params=params,
                    batch_stats=stats, x=x, labels=labels,
                    compression="int8" if wire == "int8_ef" else wire,
                    error_feedback=wire == "int8_ef", steps=STEPS,
                    fusion_threshold=ZOO_THRESHOLD)
    for name in out[0]["params"]:
        np.testing.assert_array_equal(out[1]["params"][name],
                                      out[0]["params"][name])
    assert out[0]["losses"] == out[1]["losses"]
    for r in range(N):
        for name, want in ref_stats.items():
            np.testing.assert_allclose(out[r]["stats"][0][name], want[r],
                                       rtol=1e-5, atol=1e-6, err_msg=name)
    if wire == "int8_ef":
        names = list(_named(params))
        ref = _reference_wire([o["local"] for o in out], names)
        for r in range(N):
            for name in names:
                np.testing.assert_array_equal(
                    out[r]["reduced"][name].view(np.uint32),
                    ref[name][r].astype(np.float32).view(np.uint32),
                    err_msg=name)
    loss_tol, rel = {"none": (1e-5, 1e-5), "fp16": (1e-4, 1e-3),
                     "int8_ef": (1e-4, 1e-2)}[wire]
    np.testing.assert_allclose(out[0]["losses"], ref_losses, rtol=0,
                               atol=loss_tol)
    _leaf_close(out[0]["params"], ref_params, "params", rel=rel)
    assert out[0]["losses"][-1] < out[0]["losses"][0]


BERT_SMALL = dict(vocab_size=64, n_layer=2, n_head=2, d_model=32, d_ff=64,
                  max_seq_len=16, attention="flash")


def test_bert_finetune_fp16_fusion_matches_jax(world):
    """``benchmarks/bert_finetune_bench.py``'s step on a small BERT
    classifier (2 layers, d_model 32, seq 16, the flash route):
    AdamW (lr 1e-3, weight decay 1e-4, optax's default) in a
    DistributedOptimizer on the fp16 wire with tensor fusion over
    several buckets, 3 steps, against the reference's.  Tolerances, as
    for GPT's int8 case above: fp16 rounds each reduced gradient, and a
    value within rounding of a half-way point can round the other way in
    one framework; Adam's step-one update is ~lr whatever the rounding
    except where a gradient is near zero.  So the losses within 1e-4,
    at most 0.1% of the parameters off by more than 2e-6, none by more
    than 3 steps × lr; the replicas bitwise equal."""
    jcfg = JaxBertConfig(**BERT_SMALL, dtype=jnp.float32)
    jmodel = JaxBertClassifier(jcfg, num_classes=2)
    rng = np.random.RandomState(13)
    ids = rng.randint(0, BERT_SMALL["vocab_size"], (4, 16)).astype(np.int32)
    labels = rng.randint(0, 2, 4).astype(np.int32)
    params = bert_weights(jmodel, ids, 13)
    lr = 1e-3
    tx = JaxDistributedOptimizer(optax.adamw(lr),
                                 compression=JaxCompression.fp16,
                                 fusion_threshold=ZOO_THRESHOLD)

    def loss_fn(p, batch):
        b_ids, b_labels = batch
        logp = jax.nn.log_softmax(jmodel.apply({"params": p}, b_ids))
        ll = jnp.take_along_axis(logp, b_labels[:, None], axis=-1)
        return -jnp.mean(ll)

    step = jax_make_train_step(loss_fn, tx, mesh=_mesh(), donate=False)
    ref_params, opt_state, ref_losses = params, tx.init(params), []
    for _ in range(STEPS):
        ref_params, opt_state, loss = step(
            ref_params, opt_state, (jnp.asarray(ids), jnp.asarray(labels)))
        ref_losses.append(float(loss))
    ref_params = _named(ref_params)
    out = world.run("train_bert",
                    config={**BERT_SMALL, "dtype": "float32"},
                    params=jax.tree.map(np.asarray, params), ids=ids,
                    labels=labels, steps=STEPS, lr=lr,
                    fusion_threshold=ZOO_THRESHOLD)
    for name in out[0]["params"]:
        np.testing.assert_array_equal(out[1]["params"][name],
                                      out[0]["params"][name])
    np.testing.assert_allclose(out[0]["losses"], ref_losses, rtol=0,
                               atol=1e-4)
    diffs = np.concatenate([
        np.abs(out[0]["params"][n] - ref_params[n]).ravel()
        for n in ref_params])
    assert np.mean(diffs > 2e-6) <= 1e-3, np.mean(diffs > 2e-6)
    assert diffs.max() <= STEPS * lr, diffs.max()
