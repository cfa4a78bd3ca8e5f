"""The PyTorch port's chunked LM cross-entropy (``ops/xent.py``) and
``lm_loss_fn(vocab_chunk_size=)`` against the JAX reference's, on the
same numpy inputs; the cases and tolerances of ``tests/test_xent.py``
(losses rtol 1e-5, gradients rtol 1e-4 / atol 1e-6), each also held to
the port's own dense head.  Runs on the CPU in this process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import GPT as JaxGPT
from horovod_tpu.models import GPTConfig as JaxGPTConfig
from horovod_tpu.models.transformer import lm_loss_fn as jax_lm_loss_fn
from horovod_tpu.ops.xent import chunked_lm_xent as jax_xent

from horovod_tpu_torch.models import GPT, GPTConfig, lm_loss_fn
from horovod_tpu_torch.models.transformer import load_jax_params
from horovod_tpu_torch.ops.xent import chunked_lm_xent


def _inputs(seed, b, t, d, v):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, t, d).astype(np.float32),
            (rng.randn(d, v) * 0.1).astype(np.float32),
            rng.randint(0, v, (b, t)).astype(np.int64))


def _dense(h, w, t, mask=None):
    logp = torch.log_softmax((h.float() @ w).float(), dim=-1)
    ll = torch.gather(logp, -1, t[..., None])[..., 0]
    if mask is None:
        return -ll.mean()
    return -(ll * mask).sum() / mask.sum()


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("chunk", [1, 3, 8, 64, 1000])
def test_matches_reference_and_dense(chunk):
    h, w, t = _inputs(0, 2, 12, 16, 37)
    got = chunked_lm_xent(*_t(h, w, t), chunk_size=chunk)
    want = jax_xent(jnp.asarray(h), jnp.asarray(w), jnp.asarray(t),
                    chunk_size=chunk)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(got), float(_dense(*_t(h, w, t))),
                               rtol=1e-5)


def test_masked():
    h, w, t = _inputs(1, 2, 10, 8, 21)
    mask = (np.random.RandomState(1).rand(2, 10) > 0.3).astype(np.float32)
    got = chunked_lm_xent(*_t(h, w, t), chunk_size=4,
                          mask=torch.from_numpy(mask))
    want = jax_xent(jnp.asarray(h), jnp.asarray(w), jnp.asarray(t),
                    chunk_size=4, mask=jnp.asarray(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(
        float(got), float(_dense(*_t(h, w, t), torch.from_numpy(mask))),
        rtol=1e-5)


def test_gradients_match_reference_and_dense():
    h, w, t = _inputs(2, 2, 8, 8, 19)
    hh, ww = (torch.from_numpy(a).requires_grad_() for a in (h, w))
    chunked_lm_xent(hh, ww, torch.from_numpy(t), chunk_size=3).backward()
    gh, gw = jax.grad(lambda a, b: jax_xent(a, b, jnp.asarray(t),
                                            chunk_size=3), (0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    np.testing.assert_allclose(hh.grad.numpy(), np.asarray(gh), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(ww.grad.numpy(), np.asarray(gw), rtol=1e-4,
                               atol=1e-6)
    dh, dw = (torch.from_numpy(a).requires_grad_() for a in (h, w))
    _dense(dh, dw, torch.from_numpy(t)).backward()
    np.testing.assert_allclose(hh.grad.numpy(), dh.grad.numpy(), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(ww.grad.numpy(), dw.grad.numpy(), rtol=1e-4,
                               atol=1e-6)


def test_bias_path():
    h, w, t = _inputs(3, 1, 6, 4, 11)
    bias = (np.random.RandomState(3).randn(11) * 0.1).astype(np.float32)
    got = chunked_lm_xent(*_t(h, w, t), chunk_size=5,
                          bias=torch.from_numpy(bias))
    want = jax_xent(jnp.asarray(h), jnp.asarray(w), jnp.asarray(t),
                    chunk_size=5, bias=jnp.asarray(bias))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_bf16_activations_match_dense_head():
    """bf16 activations through the f32 default head: gradients as tight
    as the dense f32 head's (the bf16 activation's own gradient within
    its rounding)."""
    h, w, t = _inputs(5, 2, 8, 8, 23)
    hb = torch.from_numpy(h).to(torch.bfloat16)
    hh = hb.clone().requires_grad_()
    ww = torch.from_numpy(w).requires_grad_()
    chunked_lm_xent(hh, ww, torch.from_numpy(t), chunk_size=3).backward()
    dh = hb.clone().requires_grad_()
    dw = torch.from_numpy(w).requires_grad_()
    _dense(dh.float(), dw, torch.from_numpy(t)).backward()
    np.testing.assert_allclose(hh.grad.float().numpy(),
                               dh.grad.float().numpy(), rtol=1e-2,
                               atol=1e-6)
    np.testing.assert_allclose(ww.grad.numpy(), dw.grad.numpy(), rtol=1e-4,
                               atol=1e-6)
    gw = jax.grad(lambda b: jax_xent(jnp.asarray(h, jnp.bfloat16), b,
                                     jnp.asarray(t), chunk_size=3))(
        jnp.asarray(w))
    np.testing.assert_allclose(ww.grad.numpy(), np.asarray(gw), rtol=1e-4,
                               atol=1e-6)


def test_lm_loss_fn_chunked_equals_dense_through_model():
    """The narrow GPT of ``tests/test_xent.py``, loaded from the flax
    init: the chunked loss equals the reference's chunked loss and the
    port's dense one, gradients of every leaf included."""
    cfg = dict(vocab_size=64, n_layer=1, n_head=2, d_model=16, d_ff=32,
               max_seq_len=16)
    jmodel = JaxGPT(JaxGPTConfig(**cfg, dtype=jnp.float32))
    tokens = np.random.RandomState(4).randint(0, 64, (2, 9))
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.asarray(inputs, jnp.int32))["params"]
    batch = (jnp.asarray(inputs, jnp.int32), jnp.asarray(targets, jnp.int32))
    ref = jax_lm_loss_fn(jmodel, vocab_chunk_size=5)(params, batch)
    ref_grads = jax.grad(jax_lm_loss_fn(jmodel, vocab_chunk_size=5))(
        params, batch)
    ref_grads = {".".join(str(k.key) for k in path): np.asarray(leaf)
                 for path, leaf in jax.tree_util.tree_leaves_with_path(
                     ref_grads)}
    model = GPT(GPTConfig(**cfg, dtype=torch.float32), device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    tb = (torch.from_numpy(inputs), torch.from_numpy(targets))
    grads = {}
    losses = {}
    for chunk in (0, 5):
        model.zero_grad(set_to_none=True)
        loss = lm_loss_fn(model, vocab_chunk_size=chunk)(model, tb)
        loss.backward()
        losses[chunk] = float(loss.detach())
        grads[chunk] = {n: p.grad.numpy().copy()
                        for n, p in model.named_parameters()}
    np.testing.assert_allclose(losses[5], float(ref), rtol=1e-5)
    np.testing.assert_allclose(losses[5], losses[0], rtol=1e-5)
    assert set(grads[5]) == set(ref_grads)
    for name, g in grads[5].items():
        np.testing.assert_allclose(g, ref_grads[name], rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(g, grads[0][name], rtol=2e-4, atol=1e-6)


def test_return_hidden_is_the_head_input():
    cfg = GPTConfig(vocab_size=32, n_layer=1, n_head=2, d_model=16, d_ff=32,
                    max_seq_len=8, dtype=torch.float32)
    model = GPT(cfg, device="cpu")
    tokens = torch.randint(0, 32, (2, 8), generator=torch.Generator()
                           .manual_seed(0))
    with torch.no_grad():
        hidden = model(tokens, return_hidden=True)
        assert hidden.shape == (2, 8, 16)
        torch.testing.assert_close(model.lm_head(hidden), model(tokens),
                                   rtol=0, atol=0)
