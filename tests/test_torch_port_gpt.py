"""The PyTorch port's GPT against the flax reference, after
``load_jax_params``: parameter names and flatten order, logits, loss and
gradients, with ``attention='full'`` and ``'flash'`` (the reference's
Pallas kernel in interpret mode).  Small and in float32: 2 layers,
d_model 64, 4 heads, vocab 256.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models.transformer import GPT as JaxGPT
from horovod_tpu.models.transformer import GPTConfig as JaxGPTConfig
from horovod_tpu.models.transformer import lm_loss_fn as jax_lm_loss_fn

from horovod_tpu_torch.models import GPT, GPTConfig, lm_loss_fn, load_jax_params
from horovod_tpu_torch.ops.fusion import tree_flatten

torch.backends.cuda.matmul.allow_tf32 = False
CFG = dict(vocab_size=256, n_layer=2, n_head=4, d_model=64, d_ff=256,
           max_seq_len=256)


def _path_name(path):
    return ".".join(str(k.key) for k in path)


def _pair(attention, t, seed=0):
    """(flax model, its params, port model loaded with them, tokens)."""
    jmodel = JaxGPT(JaxGPTConfig(**CFG, attention=attention,
                                 dtype=jnp.float32))
    tokens = np.random.RandomState(seed).randint(
        0, CFG["vocab_size"], (2, t + 1)).astype(np.int32)
    params = jmodel.init(jax.random.PRNGKey(seed),
                         jnp.asarray(tokens[:, :-1]))["params"]
    model = GPT(GPTConfig(**CFG, attention=attention, dtype=torch.float32),
                device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return jmodel, params, model, tokens


def test_names_and_flatten_order_match_flax():
    _, params, model, _ = _pair("full", 16)
    flax_order = [_path_name(p)
                  for p, _ in jax.tree_util.tree_leaves_with_path(params)]
    names, _ = tree_flatten(dict(model.named_parameters()))
    assert names == flax_order
    for name, p in model.named_parameters():
        leaf = params
        for key in name.split("."):
            leaf = leaf[key]
        assert tuple(p.shape) == leaf.shape, name


def test_load_jax_params_rejects_mismatched_trees():
    _, params, model, _ = _pair("full", 16)
    flat = jax.tree.map(np.asarray, params)
    flat["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="extra"):
        load_jax_params(model, flat)


@pytest.mark.parametrize("attention,t", [("full", 128), ("flash", 128),
                                         ("flash", 200)])
def test_logits_loss_and_grads_match_flax(attention, t):
    """Tolerances: float32 throughout; the frameworks sum the matmuls in
    other orders and the flash paths tile the softmax differently (200
    is padded to 256 in the reference and masked at the tile edge in the
    port), so values agree to a few ulp of their magnitude: logits and
    loss to 2e-5, gradients to 1e-5 absolute."""
    jmodel, params, model, tokens = _pair(attention, t, seed=t)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    logits_ref = np.asarray(jmodel.apply({"params": params}, inputs))
    loss_ref, grads_ref = jax.value_and_grad(jax_lm_loss_fn(jmodel))(
        params, (jnp.asarray(inputs), jnp.asarray(targets)))

    batch = (torch.from_numpy(inputs).long(), torch.from_numpy(targets).long())
    logits = model(batch[0])
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), logits_ref,
                               atol=2e-5, rtol=2e-5)
    loss = lm_loss_fn(model)(model, batch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref), atol=2e-5,
                               rtol=0)
    ref = {_path_name(p): np.asarray(g)
           for p, g in jax.tree_util.tree_leaves_with_path(grads_ref)}
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name], atol=1e-5,
                                   rtol=0, err_msg=name)


def test_bf16_activations_stay_close_to_f32():
    """The default config computes in bfloat16 with f32 parameters and an
    f32 head, as the reference: logits keep f32 dtype and stay within
    bf16's ~3 significant digits of the f32 model's."""
    _, params, model32, tokens = _pair("flash", 64, seed=3)
    model16 = GPT(GPTConfig(**CFG, attention="flash"), device="cpu")
    load_jax_params(model16, jax.tree.map(np.asarray, params))
    x = torch.from_numpy(tokens[:, :-1]).long()
    with torch.no_grad():
        a, b = model16(x), model32(x)
    assert a.dtype == torch.float32
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-2, rtol=5e-2)


def test_default_device_follows_init(monkeypatch):
    """With no ``device``, GPT builds on this rank's device once ``init``
    has run; before it, on the current CUDA device, and where there is no
    card it raises, naming ``device="cpu"``: it never falls back to the
    CPU on its own."""
    from horovod_tpu_torch import basics

    asked = []

    def rank_device():
        asked.append(True)
        return torch.device("cpu")

    monkeypatch.setattr(basics, "device", rank_device)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = GPTConfig(**{**CFG, "n_layer": 1})
    assert not basics.is_initialized()
    with pytest.raises(RuntimeError, match='device=.cpu.'):
        GPT(small)
    assert not asked
    explicit = GPT(small, device="cpu")
    assert all(p.device.type == "cpu" for p in explicit.parameters())
    monkeypatch.setattr(basics, "is_initialized", lambda: True)
    model = GPT(small)
    assert asked and all(p.device.type == "cpu" for p in model.parameters())
