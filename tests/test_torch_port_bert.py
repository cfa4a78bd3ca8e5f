"""The PyTorch port's BERT against the flax reference
(``horovod_tpu/models/bert.py``) on ``tests/test_models.py``'s tiny
configuration (vocab 64, 2 layers, 2 heads, d_model 16, d_ff 32, seq
16, float32): the classifier, the padding mask, the flash route against
the reference's Pallas kernel in interpret mode, the tied MLM decoder
and ``masked_lm_loss_fn`` dense and chunked, with and without the
attention mask.  Weights come from a numpy seed into the reference's
tree (``jax.eval_shape``), loaded with ``load_jax_params``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models.bert import BertConfig as JaxBertConfig
from horovod_tpu.models.bert import BertForMaskedLM as JaxMLM
from horovod_tpu.models.bert import \
    BertForSequenceClassification as JaxClassifier
from horovod_tpu.models.bert import masked_lm_loss_fn as jax_mlm_loss_fn

from horovod_tpu_torch.models import (BertConfig, BertForMaskedLM,
                                      BertForSequenceClassification,
                                      classification_loss_fn,
                                      load_jax_params, masked_lm_loss_fn)
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.ops.fusion import tree_flatten

from test_torch_port_resnet import _named

TINY = dict(vocab_size=64, n_layer=2, n_head=2, d_model=16, d_ff=32,
            max_seq_len=16)


def _configs(**kw):
    cfg = {**TINY, **kw}
    return (JaxBertConfig(**cfg, dtype=jnp.float32),
            BertConfig(**cfg, dtype=torch.float32))


def _weights(jmodel, ids, seed):
    """The reference's param tree from a numpy seed: kernels of variance
    1/fan_in, embeddings and biases small, LayerNorm scales near 1."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), ids)

    def fill(path, leaf):
        name, shape = str(path[-1].key), leaf.shape
        if name == "kernel":
            return (rng.randn(*shape) / np.sqrt(shape[0])).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.randn(*shape)).astype(np.float32)
        return (0.1 * rng.randn(*shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)["params"]


def _classifier(seed=0, t=8, **kw):
    jcfg, cfg = _configs(**kw)
    jmodel = JaxClassifier(jcfg, num_classes=3)
    model = BertForSequenceClassification(cfg, num_classes=3, device="cpu")
    ids = np.random.RandomState(seed).randint(0, TINY["vocab_size"],
                                              (2, t)).astype(np.int32)
    params = _weights(jmodel, ids, seed)
    load_jax_params(model, params)
    return jmodel, model, params, ids


def test_classifier_forward_and_grads_match_flax():
    """Names and flatten order (blocks ``bert.block_i``), the f32 logits
    and every gradient of the classification loss.  Tolerances: f32,
    the frameworks' products sum in other orders; logits and loss to
    1e-5, gradients to 1e-4 of each leaf's largest |value|."""
    jmodel, model, params, ids = _classifier()
    names, _ = tree_flatten(dict(model.named_parameters()))
    assert names == list(_named(params))
    labels = np.array([0, 2], np.int32)
    logits = np.asarray(jax.jit(jmodel.apply)({"params": params}, ids))

    def loss(p):
        logp = jax.nn.log_softmax(jmodel.apply({"params": p}, ids))
        return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], -1))

    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    batch = (torch.from_numpy(ids).long(), torch.from_numpy(labels).long())
    out = model(batch[0])
    assert out.dtype == torch.float32 and out.shape == (2, 3)
    np.testing.assert_allclose(out.detach().numpy(), logits, atol=1e-5,
                               rtol=0)
    tl = classification_loss_fn(model)(model, batch)
    tl.backward()
    assert abs(float(tl.detach()) - float(value)) <= 1e-5
    for name, g in _named(grads).items():
        p = dict(model.named_parameters())[name]
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0,
                                   atol=1e-4 * float(np.abs(g).max()),
                                   err_msg=name)


def test_padding_mask_blocks_padded_keys():
    """The [CLS] logits do not depend on the content of positions the
    attention mask drops, and equal the reference's masked logits
    (1e-5)."""
    jmodel, model, params, ids = _classifier(seed=1)
    mask = np.array([[1, 1, 1, 1, 1, 0, 0, 0], [1, 1, 1, 0, 0, 0, 0, 0]],
                    np.int32)
    other = ids.copy()
    other[mask == 0] = (other[mask == 0] + 7) % TINY["vocab_size"]
    ref = np.asarray(jmodel.apply({"params": params}, ids, None, mask))
    with torch.no_grad():
        a = model(torch.from_numpy(ids).long(), None, torch.from_numpy(mask))
        b = model(torch.from_numpy(other).long(), None,
                  torch.from_numpy(mask))
        unmasked = model(torch.from_numpy(other).long())
    np.testing.assert_allclose(a.numpy(), ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6, rtol=0)
    assert np.abs(unmasked.numpy() - a.numpy()).max() > 1e-3


@pytest.mark.parametrize("t,route", [(128, "flash"), (200, "full")])
def test_flash_route_matches_the_pallas_kernel(t, route):
    """``attention="flash"`` with no mask: T = 128 runs the port's flash
    attention (non-causal; on the CPU its plain version) against the
    reference's Pallas kernel in interpret mode; T = 200 (not a multiple
    of 128) takes ``full_attention`` on both sides.  d_model 32, 2
    heads; logits to 2e-5, gradients to 1e-4 of each leaf's largest
    |value| (the flash paths tile the softmax differently)."""
    jmodel, model, params, ids = _classifier(
        seed=t, t=t, attention="flash", max_seq_len=256, d_model=32)
    labels = np.array([1, 0], np.int32)

    def loss(p):
        logp = jax.nn.log_softmax(jmodel.apply({"params": p}, ids))
        return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], -1))

    logits = np.asarray(jax.jit(jmodel.apply)({"params": params}, ids))
    grads = _named(jax.jit(jax.grad(loss))(params))
    batch = (torch.from_numpy(ids).long(), torch.from_numpy(labels).long())
    calls = []
    plain = fa.flash_fwd_plain

    def counting(*args, **kwargs):
        calls.append(args[4])             # the causal flag
        return plain(*args, **kwargs)

    fa.flash_fwd_plain = counting
    try:
        out = model(batch[0])
        classification_loss_fn(model)(model, batch).backward()
    finally:
        fa.flash_fwd_plain = plain
    # Two forwards (the logits, then the loss), one call a layer each.
    assert calls == ([False] * 2 * TINY["n_layer"] if route == "flash"
                     else [])
    np.testing.assert_allclose(out.detach().numpy(), logits, atol=2e-5,
                               rtol=0)
    for name, p in model.named_parameters():
        g = grads[name]
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0,
                                   atol=1e-4 * float(np.abs(g).max()),
                                   err_msg=name)


def _mlm(seed=0, masked=False):
    jcfg, cfg = _configs()
    jmodel, model = JaxMLM(jcfg), BertForMaskedLM(cfg, device="cpu")
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, TINY["vocab_size"], (2, 12)).astype(np.int32)
    labels = rng.randint(0, TINY["vocab_size"], (2, 12)).astype(np.int32)
    label_mask = (rng.rand(2, 12) < 0.3).astype(np.float32)
    label_mask[:, 1] = 1.0
    params = _weights(jmodel, ids, seed)
    load_jax_params(model, params)
    batch = [ids, labels, label_mask]
    if masked:
        attention = np.ones((2, 12), np.int32)
        attention[0, 9:] = 0
        batch.insert(1, attention)
    return jmodel, model, params, tuple(batch)


def test_tied_decoder_matches_flax():
    """The MLM logits are ``h @ tok_embed.embedding.T + mlm_bias`` (no
    decoder matrix of their own): the reference's logits to 1e-5, and
    the embedding's gradient gathers the decoder's share (1e-4 of its
    largest |value|)."""
    jmodel, model, params, (ids, _, _) = _mlm(seed=2)
    assert "mlm_decoder" not in dict(model.named_parameters())
    ref = np.asarray(jmodel.apply({"params": params}, ids))
    grads = _named(jax.jit(jax.grad(
        lambda p: jmodel.apply({"params": p}, ids).sum() * 1e-2))(params))
    out = model(torch.from_numpy(ids).long())
    assert out.dtype == torch.float32 and out.shape == (2, 12, 64)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5, rtol=0)
    (out.sum() * 1e-2).backward()
    for name in ("bert.tok_embed.embedding", "mlm_bias"):
        g = grads[name]
        np.testing.assert_allclose(
            dict(model.named_parameters())[name].grad.numpy(), g, rtol=0,
            atol=1e-4 * float(np.abs(g).max()), err_msg=name)


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
def test_masked_lm_loss_dense_chunked_and_flax(masked):
    """``masked_lm_loss_fn`` dense and with ``vocab_chunk_size=5`` (the
    tied decoder chunked by ``ops/xent.py``) against the reference's
    dense loss: losses to 1e-5 (``tests/test_models.py``'s rtol 1e-5
    for dense against chunked), gradients to 2e-4 of each leaf's largest
    |value| plus 1e-6."""
    jmodel, model, params, batch = _mlm(seed=3, masked=masked)
    value, grads = jax.jit(jax.value_and_grad(jax_mlm_loss_fn(jmodel)))(
        params, tuple(jnp.asarray(b) for b in batch))
    grads = _named(grads)
    tbatch = tuple(torch.from_numpy(b).long() if b.dtype == np.int32
                   else torch.from_numpy(b) for b in batch)
    for chunk in (0, 5):
        model.zero_grad(set_to_none=True)
        loss = masked_lm_loss_fn(model, vocab_chunk_size=chunk)(model,
                                                                 tbatch)
        loss.backward()
        assert abs(float(loss.detach()) - float(value)) <= 1e-5 * max(
            1.0, float(value)), chunk
        for name, p in model.named_parameters():
            g = grads[name]
            got = (p.grad if p.grad is not None
                   else torch.zeros_like(p)).numpy()
            np.testing.assert_allclose(
                got, g, rtol=0, atol=2e-4 * float(np.abs(g).max()) + 1e-6,
                err_msg=f"{name} (chunk {chunk})")


def test_config_presets_match_the_reference():
    """``BertConfig.large()`` and ``.base()`` are the reference's."""
    for preset in ("large", "base"):
        ref = getattr(JaxBertConfig, preset)()
        got = getattr(BertConfig, preset)()
        for f in dataclasses.fields(got):
            if f.name not in ("dtype", "param_dtype"):
                assert getattr(got, f.name) == getattr(ref, f.name), f.name
