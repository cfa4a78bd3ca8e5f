"""The PyTorch port's CUDA kernels against their plain versions, on a
card.  Every test here is marked ``cuda`` and skips where there is no
CUDA device.  The module imports no JAX, so it runs on a GPU host
without the reference installed; there, skip the suite's conftest
(which sets up the JAX mesh):

    python -m pytest --noconftest tests/test_torch_port_cuda.py -m cuda -q

TF32 is off: float32 matmuls in the plain versions run in full float32.
"""

import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import apply_kernels as ak
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.ops import fused_collectives as fc
from horovod_tpu_torch.ops import int8_kernels as ik
from horovod_tpu_torch.ops import kernel_common as kc
from horovod_tpu_torch.ops import matmul_kernel as mm
from horovod_tpu_torch.ops import quantization as q8

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _same_bits(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


@pytest.mark.parametrize("rows,b", [(300, 1024), (7, 33), (1, 1)])
def test_int8_kernels_bitwise(card, rows, b):
    rng = np.random.RandomState(rows + b)
    x = rng.randn(rows, b) * 10.0 ** rng.uniform(-4, 2, (rows, 1))
    x = torch.from_numpy(x.astype(np.float32)).to(card)
    x[0, : min(b, 3)] = torch.tensor([0.5, -2.5, 1.5][: min(b, 3)])
    kc.reset_launch_counts()
    q, s = ik.quantize_blocks(x)
    q_ref, s_ref = ik.quantize_blocks_plain(x)
    assert _same_bits(q, q_ref) and _same_bits(s, s_ref)
    out = ik.dequantize_blocks(q, s)
    assert _same_bits(out, ik.dequantize_blocks_plain(q, s))
    if rows % 3 == 0:
        qn, sn = q.reshape(3, rows // 3, b), s.reshape(3, rows // 3)
        acc = ik.dequantize_accumulate(qn, sn)
        assert _same_bits(acc, ik.dequantize_accumulate_plain(qn, sn))
    counts = kc.launch_counts()
    assert counts["quantize_blocks"] == counts["dequantize_blocks"] == 1


def test_int8_kernels_non_finite_rows(card):
    """NaN and Inf rows: the kernel carries NaN into the scale and stores
    a NaN payload as 0, as its plain version (and the reference) do."""
    x = torch.randn((6, 1024), generator=torch.Generator().manual_seed(2))
    x[0, 5], x[1, 700], x[2, 0] = float("nan"), float("inf"), -float("inf")
    x[3, 1000], x[3, 1] = float("nan"), float("inf")
    x = x.to(card)
    q, s = ik.quantize_blocks(x)
    q_ref, s_ref = ik.quantize_blocks_plain(x)
    assert _same_bits(q, q_ref)
    torch.testing.assert_close(s, s_ref, rtol=0, atol=0, equal_nan=True)
    assert s[[0, 3]].isnan().all() and s[[1, 2]].isinf().all()
    out = ik.dequantize_blocks(q, s)
    torch.testing.assert_close(out, ik.dequantize_blocks_plain(q, s),
                               rtol=0, atol=0, equal_nan=True)
    assert out[:4].isnan().all() and out[4:].isfinite().all()


def _payload(card, shape, seed, offset=0):
    """Random int8 payload of ``shape`` and f32 scales of its leading
    dims (the first three rows' scales NaN, +Inf and -Inf when there are
    more than three).  ``offset`` > 0 makes the payload a contiguous view
    that starts ``offset`` bytes into its buffer."""
    g = torch.Generator(device=card).manual_seed(seed)
    numel = int(np.prod(shape))
    buf = torch.randint(-127, 128, (offset + numel,), generator=g,
                        device=card, dtype=torch.int8)
    q = buf[offset:].view(shape)
    s = torch.rand(shape[:-1], generator=g, device=card) * 1e-2
    flat = s.view(-1)
    if flat.numel() > 3:
        flat[:3] = torch.tensor([float("nan"), float("inf"), -float("inf")])
    return q, s


def _route(q, out):
    return ik._dequant_route(q.shape[-1], q.data_ptr(), out.data_ptr(),
                             out.numel())


@pytest.mark.parametrize("rows,b,offset,route", [
    (300, 4, 0, "vector"), (1000, 16, 0, "vector"),
    (32000, 1024, 0, "vector"), (77, 1, 0, "scalar"),
    (301, 15, 0, "scalar"), (129, 33, 0, "scalar"),
    (129, 33, 3, "scalar"), (64, 1024, 1, "scalar")])
def test_dequantize_blocks_both_routes_bitwise(card, rows, b, offset, route):
    """B4 bit for bit against its plain version on the vector route (b a
    multiple of 4, aligned) and the scalar one (any other b, and a view
    starting inside its buffer), NaN and Inf scales included."""
    q, s = _payload(card, (rows, b), rows + b, offset)
    kc.reset_launch_counts()
    out = ik.dequantize_blocks(q, s)
    assert _route(q, out) == route
    assert _same_bits_or_nan(out, ik.dequantize_blocks_plain(q, s))
    assert kc.launch_counts()["dequantize_blocks"] == 1
    if rows > 3:
        assert out[0].isnan().all()
        nonzero = q[1:3] != 0
        assert out[1:3][nonzero].isinf().all()


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8, 9])
@pytest.mark.parametrize("m,b,offset,route", [
    (257, 4, 0, "vector"), (300, 1024, 0, "vector"), (129, 15, 0, "scalar"),
    (65, 33, 5, "scalar"), (40, 1024, 2, "scalar")])
def test_dequantize_accumulate_both_routes_bitwise(card, n, m, b, offset,
                                                   route):
    """B3 bit for bit against its plain version (rank order from 0.0f) on
    both routes, for contributor counts that take each chunk size of the
    vector kernel alone (1, 2, 4, 8) and mixed (3 = 2 + 1, 9 = 8 + 1),
    with NaN and Inf scales."""
    q, s = _payload(card, (n, m, b), 10 * n + b, offset)
    kc.reset_launch_counts()
    out = ik.dequantize_accumulate(q, s)
    assert _route(q, out) == route
    assert _same_bits_or_nan(out, ik.dequantize_accumulate_plain(q, s))
    assert kc.launch_counts()["dequantize_accumulate"] == 1


@pytest.mark.parametrize("wrapper,shape,offset,route", [
    ("dequantize_blocks", (1024, 1024), 0, "vector"),
    ("dequantize_blocks", (1024, 1023), 0, "scalar"),
    ("dequantize_blocks", (1024, 1024), 1, "scalar"),
    ("dequantize_accumulate", (2, 512, 1024), 0, "vector"),
    ("dequantize_accumulate", (8, 512, 1024), 0, "vector"),
    ("dequantize_accumulate", (2, 512, 1023), 0, "scalar")])
def test_int8_route_in_device_trace(card, wrapper, shape, offset, route):
    """Each shape runs the route it should, and only that one, as the
    profiler's device trace names the kernels."""
    q, s = _payload(card, shape, 7, offset)
    fn = getattr(ik, wrapper)
    out, names = _device_kernels(lambda: fn(q, s))
    assert _route(q, out) == route
    assert ik.routes_run(names, wrapper) == {route}, names


def test_quant_dequant_on_card_matches_cpu(card):
    x = torch.randn(5000, generator=torch.Generator().manual_seed(0))
    out = q8.quant_dequant(x.to(card), block_size=300)
    assert _same_bits(out.cpu(), q8.quant_dequant(x, block_size=300))


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("t,tk,d", [(200, 200, 64), (64, 96, 16),
                                    (130, 130, 128), (33, 33, 32)])
def test_flash_fwd_matches_plain_version(card, dtype, atol, t, tk, d):
    """Both kernels (bf16: tensor cores, f32: CUDA cores) on ragged
    lengths at every head dim.  Besides the absolute limits, each row of
    O within 1e-2 of its largest |O| (both sides round O to the input
    type, one bf16 ulp being 2**-7 of it)."""
    g = torch.Generator(device=card).manual_seed(t + d)
    q3 = torch.randn((6, t, d), generator=g, device=card).to(dtype)
    k3 = torch.randn((6, tk, d), generator=g, device=card).to(dtype)
    v3 = torch.randn((6, tk, d), generator=g, device=card).to(dtype)
    for causal in ((False, True) if t == tk else (False,)):
        o, lse = fa.flash_fwd(q3, k3, v3, d ** -0.5, causal)
        o_ref, lse_ref = fa.flash_fwd_plain(q3, k3, v3, d ** -0.5, causal)
        assert o.dtype == dtype and lse.shape == (6, t)
        assert (o.float() - o_ref.float()).abs().max().item() <= atol
        assert (lse - lse_ref).abs().max().item() <= 1e-4
        assert _row_relative(o, o_ref) <= 1e-2


def _row_relative(o, o_ref):
    diff = (o.float() - o_ref.float()).abs()
    return (diff.amax(-1) / o_ref.float().abs().amax(-1)).max().item()


@pytest.mark.parametrize("peak", [1.0, 8.0])
def test_flash_fwd_bf16_at_gpt_medium(card, peak):
    """The GPT step's shape (B*H 128, T 1024, D 64, causal, bf16) on the
    tensor-core kernel; ``peak`` 8 multiplies q, so the running max moves
    between key tiles and the rescale of O and the denominator shows."""
    g = torch.Generator(device=card).manual_seed(11)
    q3, k3, v3 = (torch.randn((128, 1024, 64), generator=g, device=card)
                  for _ in range(3))
    q3, k3, v3 = ((q3 * peak).bfloat16(), k3.bfloat16(), v3.bfloat16())
    (o, lse), names = _device_kernels(
        lambda: fa.flash_fwd(q3, k3, v3, 0.125, True))
    o_ref, lse_ref = fa.flash_fwd_plain(q3, k3, v3, 0.125, True)
    assert any("flash_fwd_wgmma" in n for n in names), names
    assert (o.float() - o_ref.float()).abs().max().item() <= 3e-2
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    assert _row_relative(o, o_ref) <= 1e-2


@pytest.mark.parametrize("peak", [1.0, 8.0])
def test_flash_fwd_bf16_non_causal_at_bert_large(card, peak):
    """BERT-Large's shape (B*H 32*16, T = Tk = 128, D 64, bf16,
    non-causal: the encoder's route) on the tensor-core kernel, held to
    the bf16 limits of the causal case on normal and peaky scores."""
    g = torch.Generator(device=card).manual_seed(12)
    q3, k3, v3 = (torch.randn((512, 128, 64), generator=g, device=card)
                  for _ in range(3))
    q3, k3, v3 = ((q3 * peak).bfloat16(), k3.bfloat16(), v3.bfloat16())
    kc.reset_launch_counts()
    (o, lse), names = _device_kernels(
        lambda: fa.flash_fwd(q3, k3, v3, 0.125, False))
    o_ref, lse_ref = fa.flash_fwd_plain(q3, k3, v3, 0.125, False)
    assert kc.launch_counts()["flash_fwd"] == 1
    assert any("flash_fwd_wgmma" in n for n in names), names
    assert (o.float() - o_ref.float()).abs().max().item() <= 3e-2
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    assert _row_relative(o, o_ref) <= 1e-2


def test_resnet18_step_on_the_int8_wire_launches_b2_b4(card):
    """One data-parallel step of a narrow bf16 ResNet-18 on the card in a
    world of one, SGD-momentum in a DistributedOptimizer on the int8
    wire with error feedback: the loss is finite, the parameters move,
    and the quantize (B2) and dequantize (B4) kernels launch."""
    import horovod_tpu_torch as hvd

    hvd.init()
    try:
        model = hvd.models.ResNet18(num_classes=10, width=16,
                                    dtype=torch.bfloat16, seed=1)
        g = torch.Generator(device=card).manual_seed(3)
        images = torch.randn((8, 32, 32, 3), generator=g, device=card)
        labels = torch.randint(0, 10, (8,), generator=g, device=card)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            compression=hvd.Compression.int8, error_feedback=True)

        def loss_fn(module, batch):
            logp = torch.log_softmax(module(batch[0].bfloat16()), -1)
            return -logp.gather(-1, batch[1][:, None]).mean()

        step = hvd.make_train_step(loss_fn, opt)
        before = model.head.kernel.detach().clone()
        kc.reset_launch_counts()
        loss = step(model, (images, labels))
        counts = kc.launch_counts()
    finally:
        hvd.shutdown()
    assert torch.isfinite(loss)
    assert not torch.equal(before, model.head.kernel.detach())
    assert counts["quantize_blocks"] > 0 and counts["dequantize_blocks"] > 0


def _device_kernels(fn):
    """(``fn()``, the CUDA kernels it launched, as the profiler's device
    trace names them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, [e.key for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA]


def test_flash_fwd_route_follows_dtype(card):
    """A bf16 CUDA tensor launches the tensor-core kernel, an f32 one the
    CUDA-core kernel, as the device trace names them; each counts one
    launch."""
    q3 = torch.randn((2, 70, 64), device=card)
    b3 = q3.bfloat16()
    kc.reset_launch_counts()
    _, names = _device_kernels(lambda: fa.flash_fwd(b3, b3, b3, 0.125, True))
    flash = [n for n in names if "flash_fwd" in n]
    assert flash and all("flash_fwd_wgmma" in n for n in flash), names
    _, names = _device_kernels(lambda: fa.flash_fwd(q3, q3, q3, 0.125, True))
    flash = [n for n in names if "flash_fwd" in n]
    assert flash and not any("wgmma" in n for n in flash), names
    assert kc.launch_counts()["flash_fwd"] == 2


def test_flash_attention_grads_on_card_match_cpu(card):
    rng = np.random.RandomState(0)
    qkv = [rng.randn(2, 80, 2, 32).astype(np.float32) for _ in range(3)]
    grads = []
    for dev in ("cpu", card):
        ts = [torch.tensor(a, device=dev, requires_grad=True) for a in qkv]
        o, lse = fa.flash_attention_with_lse(*ts, causal=True)
        (o.square().sum() + lse.sum()).backward()
        grads.append([t.grad.cpu() for t in ts])
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-4)


def _same_bits_or_nan(a, b):
    nan = a.isnan()
    return bool(torch.equal(nan, b.isnan())) and _same_bits(
        a.masked_fill(nan, 0), b.masked_fill(nan, 0))


@pytest.mark.parametrize("n,k,b", [(2, 300, 1024), (2, 1000, 256),
                                   (3, 2500, 1024), (4, 7, 3)])
def test_apply_kernels_bitwise(card, n, k, b):
    """B6 and B7 against their plain versions, bit for bit, on ragged
    shards (the wire's padded last block has no leaf element) and on a
    gradient row whose scale is NaN, which must turn its elements of p,
    mu and nu to NaN in both."""
    m = -(-k // b)
    g = torch.Generator(device=card).manual_seed(n * k + b)
    q = torch.randint(-127, 128, (n, m, b), generator=g, device=card,
                      dtype=torch.int8)
    s = torch.rand((n, m), generator=g, device=card) * 1e-2
    s[n - 1, m - 1] = float("nan")
    q[n - 1, m - 1] = 0
    p = torch.randn(n * k, generator=g, device=card)
    mu = torch.randn(n * k, generator=g, device=card) * 1e-2
    nu = torch.rand(n * k, generator=g, device=card) * 1e-4
    kc.reset_launch_counts()
    out = ak.sgd_apply(q, s, p, lr=0.1)
    assert _same_bits_or_nan(out, ak.sgd_apply_plain(q, s, p, lr=0.1))
    consts = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, bc1=1 - 0.9 ** 2,
                  bc2=1 - 0.999 ** 2)
    got = ak.adam_apply(q, s, p, mu, nu, **consts)
    ref = ak.adam_apply_plain(q, s, p, mu, nu, **consts)
    for a, r in zip(got, ref):
        assert _same_bits_or_nan(a, r)
    last = slice((n - 1) * k + (m - 1) * b, n * k)
    assert out[last].isnan().all() and out[: (n - 1) * k].isfinite().all()
    assert got[1][last].isnan().all() and got[2][last].isnan().all()
    counts = kc.launch_counts()
    assert counts["sgd_apply"] == counts["adam_apply"] == 1


@pytest.mark.parametrize("m,k,n,dtype", [
    (130, 600, 72, torch.float32), (100, 33, 129, torch.float32),
    (257, 4096, 130, torch.bfloat16), (1, 1, 1, torch.float32),
    (300, 1024, 520, torch.bfloat16), (8192, 1024, 4096, torch.bfloat16),
    (8192, 1024, 4096, torch.float32)])
def test_blocked_matmul_within_the_f64_rule(card, m, k, n, dtype):
    """B5 on ragged shapes and at ff1 ([8192, 1024] @ [1024, 4096]), held
    to an f64 product: its error may be at most twice the plain version's
    plus 1e-6 of the largest |value|.  With an f32 x the output keeps the
    sum's error, so a lost bf16 piece would show."""
    g = torch.Generator(device=card).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=g, device=card).to(dtype)
    w = torch.randn((k, n), generator=g, device=card) * k ** -0.5
    y = mm.blocked_matmul(x, w)
    ref = x.double() @ w.double()
    err = (y.double() - ref).abs().max().item()
    err_plain = (mm.matmul_plain(x, w).double() - ref).abs().max().item()
    assert y.dtype == dtype and y.shape == (m, n)
    assert err <= 2 * err_plain + 1e-6 * ref.abs().max().item()


def test_unshard_matmul_world_of_one_launches_b5(card):
    """n = 1: the kernel still launches and its tile is the result."""
    x = torch.randn((64, 48), device=card)
    w = torch.randn((48, 40), device=card)
    kc.reset_launch_counts()
    y = fc.fused_matmul_allgather(x, w)
    assert kc.launch_counts()["blocked_matmul"] == 1
    assert _same_bits(y, mm.blocked_matmul(x, w))


def test_blocked_matmul_refuses_gradients(card):
    x = torch.randn((8, 16), device=card, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        mm.blocked_matmul(x, torch.randn((16, 4), device=card))


def test_kernel_refuses_what_it_cannot_take(card):
    """A CUDA tensor launches the kernel or raises: no quiet fallback to
    the plain version."""
    q3 = torch.randn((2, 16, 24), device=card)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_fwd(q3, q3, q3, 1.0, False)
    with pytest.raises(ValueError, match="contiguous"):
        ik.quantize_blocks(torch.randn((8, 4), device=card).t())


def _eager_int8_plain(x, n=1):
    """The eager int8 tier's plain form at n = 1: the plain B2 over blocks
    of wire_block_size(numel, 1) from element 0, the plain B3 of the one
    contribution, divided by n."""
    flat = x.reshape(-1)
    b = q8.wire_block_size(flat.numel(), n)
    padded, pad = kc.pad_dim(flat, b)
    q, s = ik.quantize_blocks_plain(padded.reshape(-1, b))
    acc = ik.dequantize_accumulate_plain(q[None], s[None]).reshape(-1)
    return (acc[:flat.numel()] / n).reshape(x.shape)


@pytest.mark.parametrize("shape", [(3000,), (10001,), (33, 1024)])
def test_eager_int8_tier_world_of_one_bitwise(card, shape):
    """The eager int8 allreduce's tier with no process group (n = 1, as a
    world of one runs it) on ragged and whole blocks: B2 and B3 launch
    once each, and the result is its plain form's bits and the CPU's."""
    x = torch.randn(shape, generator=torch.Generator().manual_seed(len(shape)))
    kc.reset_launch_counts()
    out = q8.int8_stack_allreduce_async(x.to(card), op="average").wait()
    counts = kc.launch_counts()
    assert counts["quantize_blocks"] == counts["dequantize_accumulate"] == 1
    assert _same_bits(out, _eager_int8_plain(x.to(card)))
    assert _same_bits(out.cpu(),
                      q8.int8_stack_allreduce_async(x, op="average").wait())
    assert (out.cpu() - x).abs().max().item() > 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_eager_int8_tier_half_precision_world_of_one_bitwise(card, dtype):
    """The eager int8 tier on a bf16 or f16 tensor at n = 1: the
    contribution is dequantized by B4 (B3 does not run: its f32 sum
    would skip the rounding to the dtype that the reference applies
    before the sum), and the result is the CPU's bits."""
    x = torch.randn(3000, generator=torch.Generator().manual_seed(7))
    x = x.to(dtype)
    kc.reset_launch_counts()
    out = q8.int8_stack_allreduce_async(x.to(card), op="average").wait()
    counts = kc.launch_counts()
    assert counts["quantize_blocks"] == counts["dequantize_blocks"] == 1
    assert counts["dequantize_accumulate"] == 0
    assert out.dtype == dtype
    assert _same_bits(out.cpu(),
                      q8.int8_stack_allreduce_async(x, op="average").wait())


@pytest.mark.parametrize("shape", [(1, 256, 4, 64), (2, 256, 1, 64)])
def test_flash_attention_batch_or_heads_of_one_on_card(card, shape):
    """A batch of one or one head packs to a view unless copied; the
    kernel takes contiguous rows, so the wrapper must copy.  Forward and
    gradients against the CPU's plain version."""
    rng = np.random.RandomState(1)
    qkv = [rng.randn(*shape).astype(np.float32) for _ in range(3)]
    outs = []
    for dev in ("cpu", card):
        ts = [torch.tensor(a, device=dev).to(torch.bfloat16)
              .requires_grad_() for a in qkv]
        o, lse = fa.flash_attention_with_lse(*ts, causal=True)
        (o.float().square().sum() + lse.sum()).backward()
        outs.append([o.float().cpu(), lse.cpu()]
                    + [t.grad.float().cpu() for t in ts])
    for a, b in zip(*outs):
        torch.testing.assert_close(b, a, atol=3e-2, rtol=3e-2)


def test_snapshot_of_card_tensors_is_pinned_and_owned(card):
    """``take_snapshot`` of CUDA leaves (f32, bf16, int64) copies them
    into pinned host buffers on a side stream and waits before it
    returns: the arrays equal the card's bytes, the bf16 leaf is its
    ``V2`` view, writes to the live tensors after the return leave the
    snapshot as it was, and a released buffer set is reused."""
    from horovod_tpu_torch.ckpt import BufferPool, take_snapshot
    from horovod_tpu_torch.ckpt.snapshot import pytree_digest, to_tensor

    gen = torch.Generator(device=card).manual_seed(0)
    tree = {"w": torch.randn(512, 1024, generator=gen, device=card),
            "h": torch.randn(64, 33, generator=gen,
                             device=card).to(torch.bfloat16),
            "n": torch.arange(7, device=card)}
    want = {k: v.cpu() for k, v in tree.items()}
    pool = BufferPool(1)
    snap = take_snapshot(tree, step=3, pool=pool)
    for v in tree.values():
        v.zero_()
    got = snap.tree()
    assert snap._buffers["'w'"].is_pinned()
    assert got["h"].dtype.str == "|V2"
    for k, v in want.items():
        assert torch.equal(to_tensor(got[k], v.dtype), v)
    assert snap.digest() == pytree_digest(want)
    bufs = [leaf.array for leaf in snap.leaves]
    snap.release()
    again = take_snapshot(tree, pool=pool)
    assert all(np.shares_memory(a, b.array)
               for a, b in zip(bufs, again.leaves))
    assert not again.tree()["w"].any()
    again.release()
