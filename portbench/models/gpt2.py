"""GPT-2 on the port: ``horovod_tpu_torch.models.GPT`` with flash
attention, bf16 activations and f32 parameters, and its next-token loss
(``lm_loss_fn``).  The weights are the benchmark's, copied in by name."""

from __future__ import annotations

from typing import List

import torch

from portbench.core.weights import LeafSpec, copy_weights, dense, layer_norm


def vocab_size(config: dict) -> int:
    return int(config["vocab_size"])


def model_shape(config: dict) -> dict:
    """The sizes the work counts read (``work/``)."""
    d, layers = int(config["n_embd"]), int(config["n_layer"])
    d_ff = int(config["assumed"]["n_inner"])
    v = vocab_size(config)
    per_layer = 3 * d * d + d * d + 2 * d * d_ff
    return dict(n_layer=layers, d_model=d, n_head=int(config["n_head"]),
                d_ff=d_ff, vocab=v, causal=True,
                matmul_params=layers * per_layer + d * v)


def leaf_specs(config: dict) -> List[LeafSpec]:
    """Every parameter of the port's GPT, by its name there."""
    s = model_shape(config)
    d, d_ff, v = s["d_model"], s["d_ff"], s["vocab"]
    std = float(config["initializer_range"])
    specs: List[LeafSpec] = [
        ("embed.embedding", (v, d), ("normal", std)),
        ("pos_embed", (int(config["n_positions"]), d), ("normal", std))]
    for i in range(s["n_layer"]):
        b = f"block_{i}"
        specs += layer_norm(f"{b}.ln1", d)
        specs += dense(f"{b}.attn.qkv.kernel", d, 3 * d)
        specs += dense(f"{b}.attn.out.kernel", d, d)
        specs += layer_norm(f"{b}.ln2", d)
        specs += dense(f"{b}.mlp.up.kernel", d, d_ff)
        specs += dense(f"{b}.mlp.down.kernel", d_ff, d)
    specs += layer_norm("ln_f", d)
    specs += dense("lm_head.kernel", d, v)
    return specs


def build(config: dict, weights: dict, device):
    """``(model, loss_fn)`` on ``device`` holding ``weights``."""
    import horovod_tpu_torch as hvd

    s = model_shape(config)
    cfg = hvd.models.GPTConfig(
        vocab_size=s["vocab"], n_layer=s["n_layer"], n_head=s["n_head"],
        d_model=s["d_model"], d_ff=s["d_ff"],
        max_seq_len=int(config["n_positions"]), attention="flash",
        dtype=torch.bfloat16, param_dtype=torch.float32)
    model = hvd.models.GPT(cfg, device=device, seed=0)
    copy_weights(model, weights)
    return model, hvd.models.lm_loss_fn(model)



def leaf_parts(config: dict) -> dict:
    """The fused q, k, v leaves, each compared as three
    (``core/judge.py::part_norms``)."""
    return {f"block_{i}.attn.qkv.{kind}": 3 for i in range(int(config["n_layer"]))
            for kind in ("kernel",)}
