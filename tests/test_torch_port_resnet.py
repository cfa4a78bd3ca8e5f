"""The PyTorch port's ResNet family against the flax reference
(``horovod_tpu/models/resnet.py``): parameter names and flatten order,
``load_jax_params`` with ``batch_stats``, flax's SAME padding, and a
narrow ResNet-18 (width 8) and a one-block-a-stage Bottleneck net at
32×32 in float32: logits, the mutated ``batch_stats`` and every
gradient.  The weights come from a numpy seed (the reference's init is
never compiled; ``jax.eval_shape`` gives its tree).  BatchNorm
synchronised over two ranks is held to the reference under
``shard_map`` in ``tests/test_torch_port_train.py``, on that module's
two-rank world.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from horovod_tpu.models.resnet import (BottleneckBlock as JaxBottleneck,
                                       ResNet as JaxResNet)
from horovod_tpu.models.resnet import ResNet18 as JaxResNet18
from horovod_tpu.models.resnet import ResNet50 as JaxResNet50

from horovod_tpu_torch.models import ResNet18, ResNet50, load_jax_params
from horovod_tpu_torch.models.resnet import (BottleneckBlock, ResNet,
                                             conv_nhwc, same_pads)
from horovod_tpu_torch.ops.fusion import tree_flatten

torch.backends.cudnn.allow_tf32 = False


def _path(path):
    return ".".join(str(k.key) for k in path)


def _named(tree):
    return {_path(p): np.asarray(a)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def random_variables(model, x, seed):
    """A flax model's ``(params, batch_stats)`` as numpy trees of the
    reference's structure (``jax.eval_shape``: nothing is compiled),
    filled from a numpy seed: kernels of variance 1/fan_in, BatchNorm
    scales near 1 (none zero, so every layer gets a gradient), biases and
    running statistics near 0 and 1."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x)

    def fill(path, leaf):
        name, shape = str(path[-1].key), leaf.shape
        if name == "kernel":
            return (rng.randn(*shape) / np.sqrt(np.prod(shape[:-1])))\
                .astype(np.float32)
        if name in ("scale", "var"):
            return (1.0 + 0.2 * rng.rand(*shape)).astype(np.float32)
        return (0.1 * rng.randn(*shape)).astype(np.float32)

    filled = jax.tree_util.tree_map_with_path(fill, shapes)
    return filled["params"], filled.get("batch_stats")


def flax_step(model, params, stats, x, labels):
    """The reference's train-mode forward and gradient, jitted: (logits,
    mutated batch_stats, loss, grads)."""
    def loss(p):
        logits, mutated = model.apply({"params": p, "batch_stats": stats},
                                      x, mutable=["batch_stats"])
        logp = jax.nn.log_softmax(logits)
        ll = jnp.take_along_axis(logp, labels[:, None], axis=-1)
        return -jnp.mean(ll), (logits, mutated["batch_stats"])

    (value, (logits, new_stats)), grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(params)
    return np.asarray(logits), _named(new_stats), float(value), _named(grads)


NARROW = {
    "resnet18": (lambda: JaxResNet18(num_classes=10, width=8),
                 lambda: ResNet18(num_classes=10, width=8, device="cpu")),
    "bottleneck": (
        lambda: JaxResNet(stage_sizes=(1, 1, 1, 1), block=JaxBottleneck,
                          num_classes=6, width=8),
        lambda: ResNet(stage_sizes=(1, 1, 1, 1), block=BottleneckBlock,
                       num_classes=6, width=8, device="cpu")),
}


def _pair(kind, seed=0):
    jmodel, model = NARROW[kind][0](), NARROW[kind][1]()
    x = np.random.RandomState(seed).randn(8, 32, 32, 3).astype(np.float32)
    params, stats = random_variables(jmodel, x, seed)
    load_jax_params(model, params, stats)
    return jmodel, model, params, stats, x


@pytest.mark.parametrize("kind", ["resnet18", "resnet50"])
def test_names_and_flatten_order_match_flax(kind):
    """Every parameter and buffer under flax's name and shape, the
    parameters in the reference's flatten order (the fusion plan's)."""
    if kind == "resnet18":
        jmodel, model = JaxResNet18(num_classes=10), ResNet18(
            num_classes=10, device="cpu")
    else:
        jmodel = JaxResNet50(num_classes=1000, dtype=jnp.bfloat16)
        model = ResNet50(num_classes=1000, dtype=torch.bfloat16,
                         device="cpu")
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    flax_params = {_path(p): a.shape for p, a in
                   jax.tree_util.tree_leaves_with_path(shapes["params"])}
    names, leaves = tree_flatten(dict(model.named_parameters()))
    assert names == list(flax_params)
    assert [tuple(t.shape) for t in leaves] == list(flax_params.values())
    assert all(t.dtype == torch.float32 for t in leaves)
    stats = {_path(p): a.shape for p, a in
             jax.tree_util.tree_leaves_with_path(shapes["batch_stats"])}
    assert {n: tuple(b.shape) for n, b in model.named_buffers()} == stats


def test_load_jax_params_rejects_mismatched_trees():
    jmodel, model, params, stats, _ = _pair("resnet18")
    with pytest.raises(ValueError, match="extra"):
        load_jax_params(model, {**params, "extra": np.zeros(3, np.float32)})
    short = {k: v for k, v in stats.items() if k != "bn_init"}
    with pytest.raises(ValueError, match="missing"):
        load_jax_params(model, params, short)
    bad = jax.tree.map(lambda a: a, stats)
    bad["bn_init"]["mean"] = np.zeros(9, np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(model, params, bad)


@pytest.mark.parametrize("size,window", [(56, 3), (32, 3), (15, 3), (16, 1)])
def test_same_padding_matches_lax_at_stride_two(size, window):
    """flax's SAME pads a stride-2 3×3 conv on an even input (0, 1); the
    port's helper does, and equals ``lax.conv_general_dilated`` to f32
    rounding (atol 1e-5), while torch's symmetric ``padding=1`` shifts
    the window and does not."""
    rng = np.random.RandomState(size)
    x = rng.randn(2, size, size, 4).astype(np.float32)
    k = rng.randn(window, window, 4, 5).astype(np.float32)
    want = np.asarray(lax.conv_general_dilated(
        x, k, (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")))
    pads = tuple(same_pads(size, window, 2) for _ in range(2))
    assert pads[0] == lax.padtype_to_pads((size,), (window,), (2,),
                                          "SAME")[0]
    got = conv_nhwc(torch.from_numpy(x), torch.from_numpy(k), None, (2, 2),
                    pads, torch.float32)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    if size % 2 == 0 and window == 3:
        assert pads[0] == (0, 1)
        sym = torch.nn.functional.conv2d(
            torch.from_numpy(x).permute(0, 3, 1, 2),
            torch.from_numpy(k).permute(3, 2, 0, 1), stride=2, padding=1)
        assert sym.shape == got.permute(0, 3, 1, 2).shape
        assert np.abs(sym.permute(0, 2, 3, 1).numpy() - want).max() > 0.1


@pytest.mark.parametrize("kind", ["resnet18", "bottleneck"])
def test_train_forward_stats_and_grads_match_flax(kind):
    """A train-mode forward and backward from the same weights and
    batch.  Tolerances: float32 throughout, the frameworks' convolutions
    sum in other orders; logits and loss to 5e-5 of their scale (at
    least 1), the running
    statistics to 2e-6 (flax's momentum update, the biased variance),
    each gradient leaf to 1e-4 of its largest |value| (the rounding of
    sums over the batch and the image, amplified by BatchNorm's
    backward, which subtracts two such sums).  A batch of 8 keeps the
    last stage's statistics (1×1 spatial) from being ill-conditioned.
    Where two inputs of a max-pool window or a ReLU's input lie within
    rounding of a tie, the frameworks may route that gradient
    differently; these inputs hold no such tie."""
    jmodel, model, params, stats, x = _pair(kind)
    labels = np.random.RandomState(1).randint(0, 6, 8)
    logits, new_stats, loss, grads = flax_step(jmodel, params, stats, x,
                                               labels)
    out = model(torch.from_numpy(x))
    assert out.dtype == torch.float32
    limit = 5e-5 * max(1.0, float(np.abs(logits).max()))
    np.testing.assert_allclose(out.detach().numpy(), logits, atol=limit,
                               rtol=0)
    tl = -torch.log_softmax(out, -1).gather(
        -1, torch.from_numpy(labels)[:, None]).mean()
    tl.backward()
    assert abs(float(tl.detach()) - loss) <= 5e-5 * max(1.0, loss)
    for name, buf in model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), new_stats[name], atol=2e-6,
                                   rtol=0, err_msg=name)
    for name, p in model.named_parameters():
        limit = 1e-4 * float(np.abs(grads[name]).max())
        np.testing.assert_allclose(p.grad.numpy(), grads[name], atol=limit,
                                   rtol=0, err_msg=name)


def test_eval_mode_uses_running_statistics():
    """``train=False`` (flax's ``use_running_average``) normalises with
    the loaded running statistics and leaves them alone: the logits of
    the reference's eval apply, to 2e-5."""
    jmodel, model, params, stats, x = _pair("resnet18", seed=2)
    model.eval()
    ref = JaxResNet18(num_classes=10, width=8, train=False).apply(
        {"params": params, "batch_stats": stats}, x)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=0)
    for name, buf in model.named_buffers():
        np.testing.assert_array_equal(buf.numpy(), _named(stats)[name])


def test_bf16_activations_stay_close_to_f32():
    """``dtype=bfloat16`` (bench.py's) computes every layer in bf16 with
    f32 parameters, statistics and head.  A narrow net with random
    weights moves by up to ~13% of its logits' scale in bf16, in the
    reference as here, so the port's bf16 logits are held to the
    reference's bf16 logits (within 1e-2 of their scale, about one bf16
    ulp) and its gap to f32 to the reference's own gap plus that."""
    jmodel, model32, params, stats, x = _pair("resnet18", seed=3)
    model16 = ResNet18(num_classes=10, width=8, dtype=torch.bfloat16,
                       device="cpu")
    load_jax_params(model16, params, stats)
    variables = {"params": params, "batch_stats": stats}
    ref16, _ = JaxResNet18(num_classes=10, width=8, dtype=jnp.bfloat16)\
        .apply(variables, jnp.asarray(x, jnp.bfloat16),
               mutable=["batch_stats"])
    ref32, _ = jmodel.apply(variables, x, mutable=["batch_stats"])
    ref16, ref32 = np.asarray(ref16), np.asarray(ref32)
    with torch.no_grad():
        a = model16(torch.from_numpy(x).bfloat16())
        b = model32(torch.from_numpy(x))
    assert a.dtype == torch.float32
    a, b = a.numpy(), b.numpy()
    limit = 1e-2 * float(np.abs(ref32).max())
    assert np.abs(a - ref16).max() <= limit
    assert np.abs(a - b).max() <= np.abs(ref16 - ref32).max() + limit
