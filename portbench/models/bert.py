"""BERT on the port: ``horovod_tpu_torch.models.BertForMaskedLM`` with
flash attention and no padding mask, bf16 activations and f32
parameters, and its masked-LM loss (``masked_lm_loss_fn``).  The weights
are the benchmark's, copied in by name."""

from __future__ import annotations

from typing import List

import torch

from portbench.core.weights import LeafSpec, copy_weights, dense, layer_norm


def vocab_size(config: dict) -> int:
    return int(config["vocab_size"])


def model_shape(config: dict) -> dict:
    """The sizes the work counts read (``work/``): the decoder is tied
    to the token embedding and counts as a ``[d, vocab]`` product."""
    d, layers = int(config["hidden_size"]), int(config["num_hidden_layers"])
    d_ff, v = int(config["intermediate_size"]), vocab_size(config)
    per_layer = 3 * d * d + d * d + 2 * d * d_ff
    return dict(n_layer=layers, d_model=d,
                n_head=int(config["num_attention_heads"]), d_ff=d_ff,
                vocab=v, causal=False,
                matmul_params=layers * per_layer + d * d + d * v)


def _dense_bias(name: str, d_in: int, d_out: int) -> List[LeafSpec]:
    return dense(f"{name}.kernel", d_in, d_out) + [
        (f"{name}.bias", (d_out,), ("zeros",))]


def leaf_specs(config: dict) -> List[LeafSpec]:
    """Every parameter of the port's ``BertForMaskedLM``, by its name."""
    s = model_shape(config)
    d, d_ff, v = s["d_model"], s["d_ff"], s["vocab"]
    std = float(config["initializer_range"])
    specs: List[LeafSpec] = [
        ("bert.tok_embed.embedding", (v, d), ("normal", std)),
        ("bert.seg_embed.embedding", (int(config["type_vocab_size"]), d),
         ("normal", std)),
        ("bert.pos_embed", (int(config["max_position_embeddings"]), d),
         ("normal", std))]
    specs += layer_norm("bert.ln_embed", d)
    for i in range(s["n_layer"]):
        b = f"bert.block_{i}"
        specs += _dense_bias(f"{b}.attn.qkv", d, 3 * d)
        specs += _dense_bias(f"{b}.attn.out", d, d)
        specs += layer_norm(f"{b}.ln1", d)
        specs += _dense_bias(f"{b}.ffn_up", d, d_ff)
        specs += _dense_bias(f"{b}.ffn_down", d_ff, d)
        specs += layer_norm(f"{b}.ln2", d)
    specs += _dense_bias("bert.pooler", d, d)
    specs += _dense_bias("mlm_transform", d, d)
    specs += layer_norm("mlm_ln", d)
    specs += [("mlm_bias", (v,), ("zeros",))]
    return specs


def build(config: dict, weights: dict, device):
    """``(model, loss_fn)`` on ``device`` holding ``weights``."""
    import horovod_tpu_torch as hvd

    s = model_shape(config)
    cfg = hvd.models.BertConfig(
        vocab_size=s["vocab"], n_layer=s["n_layer"], n_head=s["n_head"],
        d_model=s["d_model"], d_ff=s["d_ff"],
        max_seq_len=int(config["max_position_embeddings"]),
        type_vocab_size=int(config["type_vocab_size"]), attention="flash",
        dtype=torch.bfloat16, param_dtype=torch.float32)
    model = hvd.models.BertForMaskedLM(cfg, device=device, seed=0)
    copy_weights(model, weights)
    return model, hvd.models.masked_lm_loss_fn(model)


def leaf_parts(config: dict) -> dict:
    """The fused q, k, v leaves, each compared as three
    (``core/judge.py::part_norms``)."""
    return {f"bert.block_{i}.attn.qkv.{kind}": 3 for i in range(int(config["num_hidden_layers"]))
            for kind in ("kernel", "bias")}
