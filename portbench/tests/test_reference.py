"""The plain reference against the port at a tiny size on the CPU: with
the port's activations in float32, the loss and every leaf's gradient
agree to float32 rounding; in bfloat16 (as the cells run) to bfloat16's.
The reference imports nothing of the port."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest
import torch

from portbench.core.feed import Pool
from portbench.core.spec import load_module
from portbench.core.weights import copy_weights, make_weights
from portbench.tests import tiny

BENCH = Path(__file__).resolve().parents[1]


def _port_model(family, config, dtype):
    import horovod_tpu_torch as hvd

    fam = load_module(BENCH / "models" / f"{family}.py", "model")
    s = fam.model_shape(config)
    if family == "gpt2":
        cfg = hvd.models.GPTConfig(
            vocab_size=s["vocab"], n_layer=s["n_layer"], n_head=s["n_head"],
            d_model=s["d_model"], d_ff=s["d_ff"],
            max_seq_len=config["n_positions"], attention="flash", dtype=dtype)
        model = hvd.models.GPT(cfg, device="cpu", seed=1)
        return fam, model, hvd.models.lm_loss_fn(model)
    cfg = hvd.models.BertConfig(
        vocab_size=s["vocab"], n_layer=s["n_layer"], n_head=s["n_head"],
        d_model=s["d_model"], d_ff=s["d_ff"],
        max_seq_len=config["max_position_embeddings"], attention="flash",
        dtype=dtype)
    model = hvd.models.BertForMaskedLM(cfg, device="cpu", seed=1)
    return fam, model, hvd.models.masked_lm_loss_fn(model)


@pytest.mark.parametrize("family,config,traffic", [
    ("gpt2", "tiny-gpt", "tiny-lm"), ("bert", "tiny-bert", "tiny-mlm")])
@pytest.mark.parametrize("dtype,loss_tol,grad_tol", [
    (torch.float32, 1e-5, 1e-4), (torch.bfloat16, 1e-2, 1e-1)])
def test_reference_against_port(family, config, traffic, dtype, loss_tol,
                                grad_tol):
    cfg, tr = tiny.CONFIGS[config], tiny.TRAFFIC[traffic]
    fam, model, loss_fn = _port_model(family, cfg, dtype)
    weights = make_weights(fam.leaf_specs(cfg), 5, "cpu")
    copy_weights(model, weights)
    batch = Pool(tr, cfg["vocab_size"], 5, 1, "cpu").batch(0, 0)
    loss = loss_fn(model, batch)
    loss.backward()
    ref = load_module(BENCH / "reference" / f"{family}.py", "reference")
    w = {n: t.clone().requires_grad_(True) for n, t in weights.items()}
    ref_loss = ref.loss(cfg, w, batch)
    ref_loss.backward()
    assert float(loss.detach()) == pytest.approx(float(ref_loss.detach()),
                                                 rel=loss_tol)
    for name, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        r = w[name].grad if w[name].grad is not None else torch.zeros_like(p)
        scale = max(float(r.norm()), 1e-6)
        assert float((g.float() - r).norm()) <= grad_tol * scale, name


def test_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                top = name.split(".")[0]
                assert top not in ("horovod_tpu_torch", "horovod_tpu", "jax"), \
                    (path.name, name)
                if top == "portbench":
                    assert name.startswith(("portbench.reference",
                                            "portbench.core.judge")), name


@pytest.mark.parametrize("causal", [False, True])
def test_witness_with_the_float32_o_is_plain_attention(causal):
    """``witness.py``'s backward with Δ from the float32 O gives plain
    attention's gradients to float32 rounding; from O rounded to
    bfloat16 it departs from them."""
    from portbench.reference.gpt2 import attention
    from portbench.reference.witness import attention as witness

    g = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn(2, 3, 16, 8, generator=g) for _ in range(4))
    grads = {}
    for name, attend in (("plain", attention), ("f32", witness(False)),
                         ("bf16", witness(True))):
        x = [t.clone().requires_grad_(True) for t in (q, k, v)]
        (attend(*x, torch.matmul, causal) * do).sum().backward()
        grads[name] = [t.grad for t in x]
    for a, b in zip(grads["plain"], grads["f32"]):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)
    assert float((grads["bf16"][0] - grads["plain"][0]).abs().max()) > 1e-4
