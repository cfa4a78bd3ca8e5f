"""Rehearsals on the CPU of the precision decisions of the port's
tensor-core kernels, and the build hash that covers their shared header.

The CUDA kernels run only on a card; these tests emulate their arithmetic
in torch ops on the CPU and hold it to the limits that ``chip_smoke.py``
and ``tests/test_torch_port_cuda.py`` hold the kernels to on the card:

- B1 (``csrc/flash_attention.cu``, ``flash_fwd_wgmma``): f32 scores of
  bf16 q and k, the scale applied to the scores, an f32 denominator, and
  P rounded to bf16 before P·V.  Limits: O within 3e-2, lse within 1e-4,
  every row within 1e-2 of its largest |O|, against ``flash_fwd_plain``.
- B5 (``csrc/matmul.cu``): each f32 operand split into three bf16 pieces,
  the exact piece products with i + j <= 2 summed in f32 one 16-deep K
  step at a time.  Limit: the f64 rule, at most twice the plain version's
  error against an f64 product plus 1e-6 of the product's largest |value|.
"""

import shutil

import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.ops import matmul_kernel as mk

BN = 128          # B1's key tile at D = 64


def _bf16(a):
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


def emulate_b1(q3, k3, v3, scale, causal):
    """``flash_fwd_wgmma``'s arithmetic, key tile by key tile."""
    bh, t, d = q3.shape
    tk = k3.shape[1]
    q = q3.float()
    m = torch.full((bh, t), -float("inf"))
    den = torch.zeros((bh, t))
    acc = torch.zeros((bh, t, d))
    rows = torch.arange(t)[:, None]
    for k0 in range(0, tk, BN):
        kt, vt = k3[:, k0:k0 + BN].float(), v3[:, k0:k0 + BN].float()
        s = torch.matmul(q, kt.transpose(1, 2))          # raw f32 scores
        if causal:
            cols = k0 + torch.arange(kt.shape[1])[None]
            s = s.masked_fill(cols > rows, -float("inf"))
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp((m - m_new) * scale)
        p = torch.exp(s * scale - (m_new * scale)[..., None])
        den = den * corr + p.sum(-1)                      # f32 P
        p16 = p.to(torch.bfloat16).float()                # bf16 P for P·V
        acc = acc * corr[..., None] + torch.matmul(p16, vt)
        m = m_new
    return (acc / den[..., None]).to(q3.dtype), m * scale + torch.log(den)


def _b1_errors(o, lse, o_ref, lse_ref):
    diff = (o.float() - o_ref.float()).abs()
    row = (diff.amax(-1) / o_ref.float().abs().amax(-1)).max()
    return float(diff.max()), float((lse - lse_ref).abs().max()), float(row)


@pytest.mark.parametrize("peak", [1.0, 8.0])
def test_b1_bf16_arithmetic_holds_the_chip_limits(peak):
    """One GPT-medium head group (BH 2, T 1024, D 64, causal); ``peak``
    8 multiplies q, so the running max moves between key tiles."""
    rng = np.random.RandomState(3)
    q3, k3, v3 = (_bf16(rng.randn(2, 1024, 64)) for _ in range(3))
    q3 = (q3.float() * peak).to(torch.bfloat16)
    scale = 64 ** -0.5
    o, lse = emulate_b1(q3, k3, v3, scale, True)
    o_ref, lse_ref = fa.flash_fwd_plain(q3, k3, v3, scale, True)
    err_o, err_lse, err_row = _b1_errors(o, lse, o_ref, lse_ref)
    assert err_o <= 3e-2 and err_lse <= 1e-4 and err_row <= 1e-2, (
        err_o, err_lse, err_row)


def _pieces(t, n):
    """``t`` as ``n`` bf16-valued f32 pieces, each the bf16 rounding of
    what the earlier ones leave (a bf16 ``t`` is one exact piece)."""
    out, rest = [], t.float()
    for _ in range(n):
        p = rest.to(torch.bfloat16).float()
        out.append(p)
        rest = rest - p
    return out


def emulate_b5(x, w, w_pieces=3):
    """``matmul.cu``'s arithmetic: piece products with i + j <= 2,
    smallest first, summed from zero over each 16-deep K step, each
    step's partial added to the f32 sum."""
    xs = _pieces(x, 1 if x.dtype == torch.bfloat16 else 3)
    ws = _pieces(w, w_pieces)
    pairs = sorted(((i, j) for i in range(len(xs)) for j in range(len(ws))
                    if i + j <= 2), key=lambda ij: -(ij[0] + ij[1]))
    acc = torch.zeros((x.shape[0], w.shape[1]))
    for k0 in range(0, x.shape[1], 16):
        part = torch.zeros_like(acc)
        for i, j in pairs:
            part = part + torch.matmul(xs[i][:, k0:k0 + 16],
                                       ws[j][k0:k0 + 16])
        acc = acc + part
    return acc.to(x.dtype)


def _f64_rule(y, x, w):
    ref = x.double() @ w.double()
    err = float((y.double() - ref).abs().max())
    err_plain = float((mk.matmul_plain(x, w).double() - ref).abs().max())
    return err, err_plain, err <= 2 * err_plain + 1e-6 * float(
        ref.abs().max())


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_b5_split_product_holds_the_f64_rule(x_dtype):
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(256, 1024).astype(np.float32)).to(x_dtype)
    w = torch.from_numpy((rng.randn(1024, 256) / 32).astype(np.float32))
    err, err_plain, ok = _f64_rule(emulate_b5(x, w), x, w)
    assert ok, (err, err_plain)


def test_b5_rule_catches_a_lost_piece():
    """The f32-x check has teeth: with w's third piece dropped (16 of
    f32's 24 bits) the product falls outside the rule."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(256, 1024).astype(np.float32))
    w = torch.from_numpy((rng.randn(1024, 256) / 32).astype(np.float32))
    err, err_plain, ok = _f64_rule(emulate_b5(x, w, w_pieces=2), x, w)
    assert not ok, (err, err_plain)


def test_build_hash_covers_shared_headers(tmp_path, monkeypatch):
    """A changed ``csrc/*.cuh`` header gives every library a new path (so
    it is rebuilt), a changed source only its own; nothing is built."""
    original = {n: _build.library_path(n) for n in _build.SOURCES}
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    assert before == original
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "the kernels share a header"
    headers[0].write_bytes(headers[0].read_bytes() + b"\n// changed\n")
    after = {n: _build.library_path(n) for n in _build.SOURCES}
    assert all(after[n] != before[n] for n in _build.SOURCES)
    src = csrc / "matmul.cu"
    src.write_bytes(src.read_bytes() + b"\n")
    again = {n: _build.library_path(n) for n in _build.SOURCES}
    assert [n for n in _build.SOURCES if again[n] != after[n]] == ["matmul"]
