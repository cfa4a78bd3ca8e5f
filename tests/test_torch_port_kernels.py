"""PyTorch port, kernel by kernel, against the JAX reference.

On this host every kernel wrapper gets CPU tensors and so runs its plain
version: these tests hold that arithmetic to the reference (the int8
kernels bit for bit, flash attention within the tolerances of
``tests/test_pallas_attention.py``).  The Pallas kernels run in
interpret mode, as the JAX package's own tests run them.  The CUDA
kernels themselves are held to their plain versions on a card by
``tests/test_torch_port_cuda.py`` and ``chip_smoke.py``.

Inputs are made with numpy from a seed and fed to both packages.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu._compat import shard_map
from horovod_tpu.ops import pallas_attention as jax_pa
from horovod_tpu.ops import pallas_collectives as jax_pc
from horovod_tpu.ops import quantization as jax_q
from horovod_tpu.ops.compression import Compression as JaxCompression
from horovod_tpu.ops.fusion import plan_buckets_py as jax_plan_buckets_py
from jax.sharding import PartitionSpec as P

import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.ops import int8_kernels as ik
from horovod_tpu_torch.ops import kernel_common as kc
from horovod_tpu_torch.ops import quantization as q8
from horovod_tpu_torch.ops.compression import Compression
from horovod_tpu_torch.ops.fusion import plan_buckets_py

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _blocks(rows, b, seed):
    """Rows with magnitudes spread over decades, values sitting exactly
    on half-way points of the quantization grid, and one all-zero row."""
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, b) * 10.0 ** rng.uniform(-4, 2, (rows, 1))
    x = x.astype(np.float32)
    if rows > 2:
        x[1] = 0.0
        x[2, : min(b, 4)] = [127.0, 0.5, -2.5, 1.5][: min(b, 4)]
    return x


# --- int8 kernels: plain versions against the reference, bit for bit ---------

class TestQuantizeBlocks:
    @pytest.mark.parametrize("rows,b", [(9, 1024), (5, 33), (1, 1), (3, 7)])
    def test_bitwise_vs_reference(self, rows, b):
        x = _blocks(rows, b, seed=rows * 1000 + b)
        q, s = ik.quantize_blocks(torch.from_numpy(x))
        q_ref, s_ref = jax_q._quantize_blocks(jnp.asarray(x))
        q_pl, s_pl = jax_pc.quantize_blocks(jnp.asarray(x), interpret=True)
        for ref_q, ref_s in ((q_ref, s_ref), (q_pl, s_pl)):
            np.testing.assert_array_equal(q.numpy(), np.asarray(ref_q))
            np.testing.assert_array_equal(_bits(s.numpy()), _bits(ref_s))
        assert q.dtype == torch.int8 and s.dtype == torch.float32

    def test_non_finite_rows_vs_reference(self):
        """A NaN or an Inf in a row makes its scale non-finite and its
        payload 0, as in the reference, so the row dequantizes to NaN."""
        x = _blocks(4, 64, seed=3)
        x[0, 5], x[1, 7], x[2, 0] = np.nan, np.inf, -np.inf
        q, s = ik.quantize_blocks(torch.from_numpy(x))
        q_ref, s_ref = jax_q._quantize_blocks(jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
        np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
        assert np.isnan(s[0].item()) and np.isinf(s[1].item())
        out = ik.dequantize_blocks(q, s).numpy()
        assert np.isnan(out[:3]).all() and np.isfinite(out[3]).all()

    def test_cpu_tensor_takes_plain_version_without_launch(self):
        kc.reset_launch_counts()
        ik.quantize_blocks(torch.ones(2, 4))
        ik.dequantize_blocks(torch.ones(2, 4, dtype=torch.int8),
                             torch.ones(2))
        assert set(kc.launch_counts().values()) == {0}

    def test_other_devices_raise(self):
        with pytest.raises(ValueError, match="meta"):
            ik.quantize_blocks(torch.empty(2, 4, device="meta"))


class TestDequantizeBlocks:
    # b = 3, 15, 17 take the card's scalar route, 4 and 16 its vector
    # route: the reference both routes are held to on the card.
    @pytest.mark.parametrize("rows,b", [(9, 1024), (5, 33), (1, 1), (4, 3),
                                        (6, 4), (3, 15), (5, 16), (2, 17)])
    def test_bitwise_vs_reference(self, rows, b):
        x = _blocks(rows, b, seed=rows + b)
        q, s = jax_q._quantize_blocks(jnp.asarray(x))
        out = ik.dequantize_blocks(torch.from_numpy(np.array(q)),
                                   torch.from_numpy(np.array(s)))
        ref = np.asarray(q).astype(np.float32) * np.asarray(s)[:, None]
        ref_pl = jax_pc.dequantize_blocks(q, s, interpret=True)
        np.testing.assert_array_equal(_bits(out.numpy()), _bits(ref))
        np.testing.assert_array_equal(_bits(out.numpy()), _bits(ref_pl))


class TestDequantizeAccumulate:
    """B3 is held to the SPMD wire (``quantization.int8_reducescatter``):
    the reference's Pallas tier is up to 1 ulp off it under jax 0.9."""

    # Wire blocks of 1024 and 100 (the card's vector route), 1023, 15 and
    # 2 (its scalar route).
    @pytest.mark.parametrize("op", ["sum", "average"])
    @pytest.mark.parametrize("size", [8 * 3000, 8 * 100, 8 * 1023, 8 * 15,
                                      8 * 2])
    def test_bitwise_vs_int8_reducescatter(self, world_size, size, op):
        n = world_size
        rng = np.random.RandomState(size)
        x = (rng.randn(n, size) * 10.0 ** rng.uniform(-2, 2, (n, 1)))
        x = x.astype(np.float32)
        body = shard_map(lambda v: jax_q.int8_reducescatter(v[0], op=op)[None],
                         mesh=jax.make_mesh((n,), ("hvd",)),
                         in_specs=P("hvd"), out_specs=P("hvd"), check=False)
        ref = np.asarray(body(jnp.asarray(x)))            # [n, size / n]
        # The port's phases 1-2 with the all_to_all done by hand: rank r
        # receives chunk r of every contributor, in rank order.
        k = size // n
        b = q8.wire_block_size(size, n)
        pad = (-k) % b
        chunks = torch.nn.functional.pad(
            torch.from_numpy(x).reshape(n, n, k), (0, pad))
        m = (k + pad) // b
        q, s = ik.quantize_blocks(chunks.reshape(n * n * m, b))
        q, s = q.reshape(n, n, m, b), s.reshape(n, n, m)
        for r in range(n):
            shard = ik.dequantize_accumulate(q[:, r], s[:, r]).reshape(-1)
            shard = shard[:k]
            if op == "average":
                shard = shard / n
            np.testing.assert_array_equal(_bits(shard.numpy()),
                                          _bits(ref[r]))

    def test_zero_contributors(self):
        out = ik.dequantize_accumulate(torch.zeros(0, 2, 3, dtype=torch.int8),
                                       torch.zeros(0, 2))
        assert out.shape == (2, 3) and not out.any()


class TestDequantRoute:
    """The pure choice between the card's two dequantize kernels: vector
    (char4 loads, float4 stores) only when b % 4 == 0, q is 4-byte and
    out 16-byte aligned, and the output's groups of 4 number fewer than
    2**31."""

    @pytest.mark.parametrize("b,route", [(1, "scalar"), (2, "scalar"),
                                         (3, "scalar"), (4, "vector"),
                                         (15, "scalar"), (16, "vector"),
                                         (33, "scalar"), (1023, "scalar"),
                                         (1024, "vector")])
    def test_block_size(self, b, route):
        assert ik._dequant_route(b, 4096, 8192, 64 * b) == route

    @pytest.mark.parametrize("q_off,out_off,route", [
        (0, 0, "vector"), (4, 16, "vector"), (1, 0, "scalar"),
        (2, 0, "scalar"), (3, 0, "scalar"), (0, 4, "scalar"),
        (0, 8, "scalar"), (0, 12, "scalar"), (8, 32, "vector")])
    def test_pointer_offsets(self, q_off, out_off, route):
        assert ik._dequant_route(1024, 256 + q_off, 512 + out_off,
                                 1024) == route

    @pytest.mark.parametrize("out_numel,route", [
        (4 * (2 ** 31 - 1), "vector"), (4 * 2 ** 31, "scalar")])
    def test_group_count(self, out_numel, route):
        """The bound is on the output's groups, which the kernel divides
        in 32 bits, not on every contributor's."""
        assert ik._dequant_route(1024, 0, 0, out_numel) == route

    def test_view_inside_a_buffer(self):
        """``buf[k:]`` starts k bytes into its buffer: only k % 4 == 0
        keeps the vector route."""
        buf = torch.zeros(4096 + 16, dtype=torch.int8)
        out = torch.empty(4096)
        routes = [ik._dequant_route(16, buf[k:].data_ptr(), out.data_ptr(),
                                    4096) for k in range(4)]
        assert routes[1:] == ["scalar"] * 3
        assert routes[0] == ("vector" if buf.data_ptr() % 4 == 0
                             and out.data_ptr() % 16 == 0 else "scalar")

    # Kernel names as a device trace records them.
    _VEC4 = ("(anonymous namespace)::dequantize_rows_vec4(char4 const*, "
             "float const*, float4*, long, (anonymous namespace)::FastDiv)")
    _ROWS = ("(anonymous namespace)::dequantize_rows(signed char const*, "
             "float const*, float*, int)")
    _ACC4 = ("(anonymous namespace)::dequantize_accumulate_vec4(char4 "
             "const*, float const*, float4*, int, long, long, "
             "(anonymous namespace)::FastDiv)")
    _ACCR = ("(anonymous namespace)::dequantize_accumulate_rows(signed char "
             "const*, float const*, float*, int, long, int)")
    _QUANT = ("(anonymous namespace)::quantize_rows(float const*, signed "
              "char*, float*, int)")

    @pytest.mark.parametrize("wrapper,names,ran", [
        ("dequantize_blocks", [_VEC4], {"vector"}),
        ("dequantize_blocks", [_ROWS], {"scalar"}),
        ("dequantize_blocks", [_ROWS, _VEC4], {"vector", "scalar"}),
        ("dequantize_blocks", [_QUANT, _ACC4, _ACCR], set()),
        ("dequantize_accumulate", [_ACC4, _QUANT], {"vector"}),
        ("dequantize_accumulate", [_ACCR], {"scalar"}),
        ("dequantize_accumulate", [_VEC4, _ROWS], set())])
    def test_routes_run(self, wrapper, names, ran):
        """Which routes a device trace shows: a scalar kernel's name is a
        prefix of its vector kernel's, and B2's of B4's."""
        assert ik.routes_run(names, wrapper) == ran


class TestQuantDequant:
    @pytest.mark.parametrize("shape,block", [((64, 48), 1024), ((1000,), 256),
                                             ((7, 3), 1024), ((5,), 2)])
    def test_bitwise_vs_reference(self, shape, block):
        x = np.random.RandomState(sum(shape)).randn(*shape)
        x = x.astype(np.float32)
        out = q8.quant_dequant(torch.from_numpy(x), block_size=block)
        ref = jax_q.quant_dequant(jnp.asarray(x), block_size=block)
        assert tuple(out.shape) == shape
        np.testing.assert_array_equal(_bits(out.numpy()), _bits(ref))

    def test_local_error_bitwise_vs_reference(self):
        x = np.random.RandomState(5).randn(3000).astype(np.float32)
        for block in (None, 300):
            out = Compression.int8.local_error(torch.from_numpy(x),
                                               block_size=block)
            ref = JaxCompression.int8.local_error(jnp.asarray(x),
                                                  block_size=block)
            np.testing.assert_array_equal(_bits(out.numpy()), _bits(ref))

    @pytest.mark.parametrize("tier", ["fp16", "bf16", "none"])
    def test_cast_tier_local_error(self, tier):
        x = np.random.RandomState(6).randn(257).astype(np.float32)
        out = getattr(Compression, tier).local_error(torch.from_numpy(x))
        ref = getattr(JaxCompression, tier).local_error(jnp.asarray(x))
        np.testing.assert_array_equal(_bits(out.numpy()), _bits(ref))

    @pytest.mark.parametrize("elems,n", [(10, 1), (5000, 4), (3, 8),
                                         (10 ** 7, 2)])
    def test_wire_block_size(self, elems, n):
        assert q8.wire_block_size(elems, n) == jax_q.wire_block_size(elems, n)


# --- flash attention ----------------------------------------------------------

def _qkv(b=2, t=64, h=2, d=16, tk=None, seed=0):
    rng = np.random.RandomState(seed)
    tk = tk or t
    return (rng.randn(b, t, h, d).astype(np.float32),
            rng.randn(b, tk, h, d).astype(np.float32),
            rng.randn(b, tk, h, d).astype(np.float32))


def _port_with_grads(q, k, v, wo, wl, causal):
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    o, lse = fa.flash_attention_with_lse(tq, tk, tv, causal=causal)
    loss = (o * torch.from_numpy(wo)).sum() + (lse * torch.from_numpy(wl)).sum()
    loss.backward()
    return o.detach().numpy(), lse.detach().numpy(), \
        [t.grad.numpy() for t in (tq, tk, tv)]


def _jax_with_grads(q, k, v, wo, wl, causal):
    def loss(q, k, v):
        o, lse = jax_pa.flash_attention_with_lse(q, k, v, causal=causal,
                                                 interpret=True)
        return (o * wo).sum() + (lse * wl).sum(), (o, lse)

    (_, (o, lse)), grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    return np.asarray(o), np.asarray(lse), [np.asarray(g) for g in grads]


class TestFlashAttention:
    @pytest.mark.parametrize("causal", [False, True])
    def test_outputs_and_grads_vs_reference(self, causal):
        q, k, v = _qkv()
        rng = np.random.RandomState(1)
        wo = rng.randn(*q.shape).astype(np.float32)
        wl = rng.randn(q.shape[0], q.shape[2], q.shape[1]).astype(np.float32)
        o, lse, grads = _port_with_grads(q, k, v, wo, wl, causal)
        o_ref, lse_ref, grads_ref = _jax_with_grads(q, k, v, wo, wl, causal)
        assert lse.shape == (2, 2, 64)
        np.testing.assert_allclose(o, o_ref, atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(lse, lse_ref, atol=2e-5, rtol=2e-5)
        for g, g_ref in zip(grads, grads_ref):
            np.testing.assert_allclose(g, g_ref, atol=1e-4, rtol=1e-4)

    def test_cross_attention_lengths(self):
        q, k, v = _qkv(t=32, tk=64, seed=2)
        out = fa.flash_attention(*map(torch.from_numpy, (q, k, v)))
        ref = jax_pa.flash_attention(q, k, v, block_q=32, block_k=32,
                                     interpret=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   atol=2e-5, rtol=2e-5)

    @pytest.mark.parametrize("t", [24, 150])
    def test_padded_odd_lengths(self, t):
        q, k, v = _qkv(t=t, d=8, seed=t)
        out = fa.flash_attention_padded(*map(torch.from_numpy, (q, k, v)))
        ref = jax_pa.flash_attention_padded(q, k, v, interpret=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   atol=2e-5, rtol=2e-5)

    def test_causal_needs_equal_lengths(self):
        q, k, v = _qkv(t=32, tk=64)
        with pytest.raises(ValueError, match="Tq == Tk"):
            fa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("causal,tk,with_dlse", [
        (True, 40, False), (False, 40, True), (False, 72, True)])
    def test_flash_bwd_on_cpu_is_the_plain_version(self, dtype, causal, tk,
                                                   with_dlse):
        """CPU tensors take ``flash_bwd_plain`` bit for bit, ``dlse``
        included, and launch nothing."""
        q3, k3, v3, o3, lse, do3, dlse = _bwd_inputs(6, 40, tk, 16, causal,
                                                     dtype, with_dlse)
        kc.reset_launch_counts()
        got = fa.flash_bwd(q3, k3, v3, o3, lse, do3, 0.25, causal,
                           dlse=dlse)
        want = fa.flash_bwd_plain(q3, k3, v3, o3, lse, do3, scale=0.25,
                                  causal=causal, dlse=dlse)
        assert kc.launch_counts()["flash_bwd"] == 0
        for a, b in zip(got, want):
            assert a.dtype == dtype and torch.equal(a, b)

    @pytest.mark.parametrize("bh,t,tk,d,causal", [
        (8, 256, 256, 64, True), (32, 128, 128, 64, False),
        (8, 96, 160, 16, False), (6, 200, 200, 128, True)])
    @pytest.mark.parametrize("pieces,within", [(2, True), (1, False)])
    def test_split_contract(self, bh, t, tk, d, causal, pieces, within):
        """The card's backward in torch ops, P and dS entering each
        product as ``pieces`` bf16 values: as the hi/lo pair (2) it is
        within 1.25x of the plain bf16 version's own error against the
        f32 one (both round only dQ, dK and dV), rounded once (1) it is
        not: dS's rows sum to zero, and dQ, dK carry the rounding."""
        q3, k3, v3, o3, lse, do3, dlse = _bwd_inputs(
            bh, t, tk, d, causal, torch.bfloat16, True, seed=bh + t + d)
        scale = d ** -0.5
        f32 = [x.float() for x in (q3, k3, v3, o3)]
        ref = fa.flash_bwd_plain(*f32, lse, do3.float(), scale=scale,
                                 causal=causal, dlse=dlse)
        plain = fa.flash_bwd_plain(q3, k3, v3, o3, lse, do3, scale=scale,
                                   causal=causal, dlse=dlse)
        split = _split_bwd(q3, k3, v3, o3, lse, do3, scale, causal, dlse,
                           pieces)
        ratios = [_rel_err(a, r) / _rel_err(p, r)
                  for a, p, r in zip(split, plain, ref)]
        if within:
            assert max(ratios) <= 1.25, ratios
        else:
            assert max(ratios) > 1.25, ratios


def _bwd_inputs(bh, t, tk, d, causal, dtype, with_dlse, seed=0):
    """q, k, v, the forward's O and lse on them, a cotangent dO and,
    when asked, a lse cotangent, made with numpy from ``seed``."""
    rng = np.random.RandomState(seed)
    q3, k3, v3 = (torch.from_numpy(rng.randn(bh, n, d).astype(np.float32))
                  .to(dtype) for n in (t, tk, tk))
    o3, lse = fa.flash_fwd_plain(q3, k3, v3, d ** -0.5, causal)
    do3 = torch.from_numpy(rng.randn(bh, t, d).astype(np.float32)).to(dtype)
    dlse = (torch.from_numpy(rng.randn(bh, t).astype(np.float32))
            if with_dlse else None)
    return q3, k3, v3, o3, lse, do3, dlse


def _rel_err(a, ref):
    return ((a.double() - ref.double()).norm() / ref.double().norm()).item()


def _split_bwd(q3, k3, v3, o3, lse, do3, scale, causal, dlse, pieces):
    """``flash_bwd``'s arithmetic on the card, in torch ops: f32 S, P, dP
    and dS as the plain version computes them, then each product with P
    or dS as the sum of ``pieces`` bf16 parts (hi = bf16(x), lo =
    bf16(x - hi)); the gradients rounded to bf16 once."""
    def parts(x):
        hi = x.to(torch.bfloat16).float()
        return [hi, (x - hi).to(torch.bfloat16).float()][:pieces]

    qf, kf, vf, dof = (x.float() for x in (q3, k3, v3, do3))
    delta = (dof * o3.float()).sum(-1)
    if dlse is not None:
        delta = delta - dlse
    s = qf @ kf.transpose(1, 2) * scale
    if causal:
        keep = torch.ones(s.shape[1:], dtype=torch.bool).tril()
        s = torch.where(keep, s, fa.NEG_INF)
    p = torch.exp(s - lse[..., None])
    ds = p * (dof @ vf.transpose(1, 2) - delta[..., None]) * scale
    dq = sum(x @ kf for x in parts(ds))
    dk = sum(x.transpose(1, 2) @ qf for x in parts(ds))
    dv = sum(x.transpose(1, 2) @ dof for x in parts(p))
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


# --- fusion planner, dispatch, import hygiene ---------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_plan_buckets_matches_reference(seed):
    rng = np.random.RandomState(seed)
    sizes = [int(s) for s in rng.randint(1, 5000, rng.randint(1, 40))]
    for threshold in (1, 1024, 4096, 10 ** 6):
        assert plan_buckets_py(sizes, threshold) == \
            jax_plan_buckets_py(sizes, threshold)


def test_pad_dim_and_round_up():
    x = torch.arange(6.0).reshape(2, 3)
    padded, pad = kc.pad_dim(x, 4, axis=1)
    assert pad == 1 and padded.shape == (2, 4) and padded[:, 3].eq(0).all()
    assert kc.pad_dim(x, 2, axis=0) == (x, 0)
    assert kc.round_up(10, 8) == 16 and kc.round_up(0, 8) == 0


def test_import_loads_no_jax():
    """A fresh interpreter that imports the port loads no module of JAX,
    flax, optax or the JAX package."""
    code = ("import sys, horovod_tpu_torch\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax') or m == 'horovod_tpu' "
            "or m.startswith('horovod_tpu.')]\n"
            "print(len(bad), bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert out.startswith("0 "), out


def test_init_without_card_raises(monkeypatch):
    """``init()`` asks for the card: with no CUDA device it raises and
    does not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not hvd.is_initialized()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hvd.init()
    assert not hvd.is_initialized()
