"""Operations and bytes from shapes, against counts made by hand."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from portbench.core.spec import load_module
from portbench.work import counts

BENCH = Path(__file__).resolve().parents[1]


def _config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def _shape(family, config):
    return load_module(BENCH / "models" / f"{family}.py", "model").model_shape(
        _config(config))


def test_gpt2_medium_model_flops():
    s = _shape("gpt2", "gpt2-medium")
    # 24 × (qkv 3·1024² + out 1024² + up and down 2·1024·4096) + head 1024·50257
    params = 24 * (3 * 1024 ** 2 + 1024 ** 2 + 2 * 1024 * 4096) + 1024 * 50257
    assert s["matmul_params"] == params == 353_453_056
    # 6 N tokens + causal attention 24 × 3 × 4 × 8 × 1024² × 1024 / 2
    want = 6 * params * 8192 + 24 * 3 * 4 * 8 * 1024 ** 2 * 1024 / 2
    assert counts.model_flops_per_step(s, 8, 1024) == pytest.approx(want)
    assert want == pytest.approx(18.609e12, rel=1e-4)


def test_bert_large_model_flops():
    s = _shape("bert", "bert-large")
    # 24 layers, the MLM transform 1024², the tied decoder 1024·30522
    params = 24 * (3 * 1024 ** 2 + 1024 ** 2 + 2 * 1024 * 4096) \
        + 1024 ** 2 + 1024 * 30522
    assert s["matmul_params"] == params
    want = 6 * params * 8192 + 24 * 3 * 4 * 64 * 128 ** 2 * 1024
    assert counts.model_flops_per_step(s, 64, 128) == pytest.approx(want)
    assert want == pytest.approx(16.74e12, rel=1e-3)


def test_flash_fwd_launch_at_the_cells_shapes():
    # GPT: [8·16, 1024, 64] causal.  Q, K, V, O bf16 and the f32 lse.
    w = counts.flash_fwd_launch(128, 1024, 1024, 64, causal=True)
    assert w["bytes"] == 4 * 128 * 1024 * 64 * 2 + 128 * 1024 * 4
    assert w["flops"] == 4 * 128 * 1024 * 1024 * 64 / 2
    peaks = counts.peaks_for("NVIDIA H100 80GB HBM3")
    # The kernel table's bound for this shape: 0.020189 ms, by bytes.
    assert counts.bound_s(w["flops"], w["bytes"], peaks) * 1e3 == \
        pytest.approx(0.020189000597014926)
    # BERT: [64·16, 128, 64] non-causal.
    w = counts.flash_fwd_launch(1024, 128, 128, 64, causal=False)
    assert w["bytes"] == 4 * 1024 * 128 * 64 * 2 + 1024 * 128 * 4
    assert w["flops"] == 4 * 1024 * 128 * 128 * 64


def test_int8_wire_bytes_by_hand():
    # Two leaves of 4096 and 1024 elements at n = 4: error feedback's
    # blocks are min(1024, ceil(e / 4)) = 1024 and 256.
    b = counts.int8_wire_bytes([4096, 1024], 4, error_feedback=True)
    ef_b2 = (4 * 4096 + 4096 + 4 * 4) + (4 * 1024 + 1024 + 4 * 4)
    ef_b4 = (4096 + 4 * 4 + 4 * 4096) + (1024 + 4 * 4 + 4 * 1024)
    g = 5120
    s = 4 * g / 1024
    rs_b2, b3 = 5 * g + s, g + s + g
    ag_b2, ag_b4 = (4 * g + g + s) / 4, g + s + 4 * g
    assert b["B2"] == pytest.approx(ef_b2 + rs_b2 + ag_b2)
    assert b["B3"] == pytest.approx(b3)
    assert b["B4"] == pytest.approx(ef_b4 + ag_b4)
    assert b["total"] == pytest.approx(b["B2"] + b["B3"] + b["B4"])
    # One rank, no error feedback: the wire is the identity.
    assert counts.int8_wire_bytes([4096], 1, False)["total"] == 0


def test_unknown_card_has_no_peaks():
    assert counts.peaks_for("cpu") is None


def test_masked_lm_traffic():
    import torch

    from portbench.core.feed import Pool

    t = json.loads((BENCH / "traffic" / "mlm.b128.t128.json").read_text())
    t = dict(t, batch_per_rank=64)
    ids, labels, mask = Pool(t, 30522, 2**31 + 5, 2, "cpu").batch(3, 1)
    assert ids.shape == labels.shape == mask.shape == (64, 128)
    assert (mask.sum(dim=1) == 19).all()            # round(0.15 × 126)
    assert (mask[:, 0] == 0).all() and (mask[:, -1] == 0).all()
    assert (labels[:, 0] == 101).all() and (labels[:, -1] == 102).all()
    assert torch.equal(ids[mask == 0], labels[mask == 0])
    masked = ids[mask == 1]
    assert 0.74 < float((masked == 103).float().mean()) < 0.86
    # The same seed gives the same batch; another rank other rows.
    again = Pool(t, 30522, 2**31 + 5, 2, "cpu").batch(3, 1)
    assert all(torch.equal(a, b) for a, b in zip((ids, labels, mask), again))
    assert not torch.equal(ids, Pool(t, 30522, 2**31 + 5, 2, "cpu").batch(3, 0)[0])
