"""The PyTorch port's MLP, VGG-16 and Inception-V3 against the flax
reference (``horovod_tpu/models/{mlp,convnets}.py``) at the sizes of
``tests/test_models.py``: the MLP on flattened 28×28 inputs, VGG-16 at
32×32 with 7 classes, Inception-V3 at 75×75 with 5 classes, all in
float32.  Weights come from a numpy seed into the reference's tree
(``jax.eval_shape``), loaded with ``load_jax_params``; the forward and
every gradient are compared, Inception's in eval mode; its train mode
(batch and running statistics) cell by cell.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import MLP as JaxMLP
from horovod_tpu.models import InceptionV3 as JaxInceptionV3
from horovod_tpu.models import VGG16 as JaxVGG16

from horovod_tpu_torch.models import MLP, InceptionV3, VGG16, load_jax_params
from horovod_tpu_torch.ops.fusion import tree_flatten

from test_torch_port_resnet import _named, _path, random_variables

torch.backends.cudnn.allow_tf32 = False


def _case(kind):
    """(flax model, port model, input batch, classes)."""
    rng = np.random.RandomState(5)
    if kind == "mlp":
        x = rng.randn(4, 28 * 28).astype(np.float32)
        return JaxMLP(), MLP(device="cpu"), x, 10
    if kind == "vgg16":
        x = rng.randn(2, 32, 32, 3).astype(np.float32)
        return (JaxVGG16(num_classes=7, dtype=jnp.float32),
                VGG16(num_classes=7, dtype=torch.float32, image_size=32,
                      device="cpu"), x, 7)
    x = rng.randn(2, 75, 75, 3).astype(np.float32)
    return (JaxInceptionV3(num_classes=5, dtype=jnp.float32),
            InceptionV3(num_classes=5, dtype=torch.float32, device="cpu"),
            x, 5)


@pytest.mark.parametrize("kind", ["mlp", "vgg16", "inception3"])
def test_forward_and_grads_match_flax(kind):
    """Names, shapes and flatten order; then a forward and the gradient
    of a cross-entropy from the same weights, Inception's in eval mode
    (its train mode is held cell by cell below).  Tolerances: f32, the
    frameworks' products and convolutions sum in other orders; logits
    and loss within 5e-5 of their scale (at least 1), each gradient leaf
    within 1e-4 of its largest |value|."""
    jmodel, model, x, classes = _case(kind)
    params, stats = random_variables(jmodel, x, seed=6)
    names, _ = tree_flatten(dict(model.named_parameters()))
    assert names == list(_named(params))
    load_jax_params(model, params, stats)
    labels = np.random.RandomState(7).randint(0, classes, x.shape[0])
    extra = {} if stats is None else {"batch_stats": stats}
    kwargs = {"train": False} if kind == "inception3" else {}

    def loss(p):
        logits = jmodel.apply({"params": p, **extra}, x, **kwargs)
        logp = jax.nn.log_softmax(logits)
        ll = jnp.take_along_axis(logp, labels[:, None], axis=-1)
        return -jnp.mean(ll), logits

    (value, logits), grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(params)
    logits, grads = np.asarray(logits), _named(grads)

    out = model(torch.from_numpy(x), **kwargs)
    assert out.dtype == torch.float32 and out.shape == (x.shape[0], classes)
    limit = 5e-5 * max(1.0, float(np.abs(logits).max()))
    np.testing.assert_allclose(out.detach().numpy(), logits, atol=limit,
                               rtol=0)
    tl = -torch.log_softmax(out, -1).gather(
        -1, torch.from_numpy(labels)[:, None]).mean()
    tl.backward()
    assert abs(float(tl.detach()) - float(value)) <= 5e-5 * max(
        1.0, float(value))
    for name, p in model.named_parameters():
        g = grads[name]
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0,
                                   atol=1e-4 * float(np.abs(g).max()),
                                   err_msg=name)
        assert np.abs(g).max() > 0, name
    for name, buf in model.named_buffers():     # eval mode: untouched
        np.testing.assert_array_equal(buf.numpy(), _named(stats)[name])


def test_inception3_train_mode_cells_match_flax():
    """Inception in train mode (batch statistics, running statistics
    updated).  A random net's train-mode forward amplifies f32 rounding
    through its 94 BatchNorms (a whole forward's logits differ from the
    reference's by ~1e-3 of their scale at batch 8, the gap growing
    steadily from cell to cell), so each conv + BN + ReLU cell is held
    to the reference on the reference's own input: every cell's output
    is replaced by the reference's before the next cell reads it.  Each
    cell's output within 5e-5 of its scale, the logits likewise, every
    cell's running statistics within 1e-5 relative and 1e-6 absolute
    (E[x²] − E[x]² over up to 9248 values a channel)."""
    jmodel, model, _, _ = _case("inception3")
    x = np.random.RandomState(9).randn(8, 75, 75, 3).astype(np.float32)
    params, stats = random_variables(jmodel, x, seed=10)
    load_jax_params(model, params, stats)
    cells = {name for name, _ in model.named_children() if name != "logits"}
    logits, state = jax.jit(lambda v: jmodel.apply(
        v, x, mutable=["batch_stats", "intermediates"],
        capture_intermediates=lambda mdl, _: mdl.name in cells))(
        {"params": params, "batch_stats": stats})
    ref = {name: np.asarray(out["__call__"][0])
           for name, out in state["intermediates"].items()}
    assert set(ref) == cells
    errors = {}

    def hold(name):
        def hook(module, args, out):
            want = ref[name]
            errors[name] = (float(np.abs(out.detach().numpy() - want).max()),
                            float(np.abs(want).max()))
            return torch.from_numpy(np.array(want))
        return hook

    for name in cells:
        getattr(model, name).register_forward_hook(hold(name))
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    assert set(errors) == cells
    for name, (err, scale) in errors.items():
        assert err <= 5e-5 * max(1.0, scale), (name, err, scale)
    np.testing.assert_allclose(out, np.asarray(logits), rtol=0,
                               atol=5e-5 * max(1.0, np.abs(logits).max()))
    new_stats = _named(state["batch_stats"])
    for name, buf in model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), new_stats[name], atol=1e-6,
                                   rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("side", [32, 64, 96])
def test_vgg16_head_width_follows_the_image_side(side):
    """flax infers ``fc6``'s input width from the image; the port takes
    ``image_size`` and must build the same tree with no BatchNorm state
    (at 224 that is the 25088 × 4096 leaf, 102.8 M elements)."""
    shapes = jax.eval_shape(JaxVGG16(num_classes=3).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, side, side, 3), jnp.float32))
    assert "batch_stats" not in shapes
    model = VGG16(num_classes=3, image_size=side, device="cpu")
    want = {_path(p): a.shape for p, a in
            jax.tree_util.tree_leaves_with_path(shapes["params"])}
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == want
    assert not list(model.named_buffers())
