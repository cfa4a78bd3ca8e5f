"""Flash attention: hand-written CUDA kernels forward and backward.

Counterpart of ``horovod_tpu/ops/pallas_attention.py``, with the same
contract: q/k/v ``[B, T, H, D]`` → ``[B, T, H, D]``, and the row
logsumexp as ``[B, H, T]`` float32.  The forward is kernel
:func:`flash_fwd` (``csrc/flash_attention.cu``, replacing
``_fwd_kernel``): bfloat16 inputs run on the tensor cores (wgmma, TMA),
float32 ones on the CUDA cores; what bounds each on the card is in the
note at the top of the CUDA source.  The backward is kernel
:func:`flash_bwd` (``csrc/flash_attention_bwd.cu``): bfloat16 on the
tensor cores, float32 on the CUDA cores; its plain version
:func:`flash_bwd_plain`, a port of the reference's ``_flash_bwd`` (plain
torch ops, chunked over key blocks, recomputing the probabilities from
the saved lse in float32, with the lse cotangent folded into Δ), runs
for CPU tensors.

The kernel masks its own ragged edge, so any sequence length runs
without padding; :func:`flash_attention_padded` keeps its name for the
causal self-attention entry the models call.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .kernel_common import (check_operand, kernel, on_card, raise_on_error,
                            stream_of)

NEG_INF = -1e30
BLOCK_K = 128          # key-block width of the plain versions
KERNEL_HEAD_DIMS = (16, 32, 64, 128)

_P = ctypes.c_void_p
_signatures = {
    "hvd_flash_fwd": [_P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_int, ctypes.c_int, _P],
}
_bwd_signatures = {
    "hvd_flash_bwd": [_P] * 11 + [ctypes.c_int] * 4
                     + [ctypes.c_float, ctypes.c_int, ctypes.c_int, _P],
}


def flash_fwd_plain(q3, k3, v3, scale: float, causal: bool,
                    block_k: int = BLOCK_K):
    """The forward's arithmetic in torch ops: ``_fwd_kernel``'s
    streaming softmax over key blocks, for all query rows at once.
    ``[BH, T, D]`` inputs → (O ``[BH, T, D]`` in the input type,
    lse ``[BH, T]`` f32)."""
    bh, t, d = q3.shape
    tk = k3.shape[1]
    q = q3.to(torch.float32) * scale
    m = torch.full((bh, t), NEG_INF, dtype=torch.float32, device=q3.device)
    num = torch.zeros((bh, t, d), dtype=torch.float32, device=q3.device)
    den = torch.zeros((bh, t), dtype=torch.float32, device=q3.device)
    qpos = torch.arange(t, device=q3.device)[:, None]
    for k0 in range(0, tk, block_k):
        k_blk = k3[:, k0:k0 + block_k].to(torch.float32)
        v_blk = v3[:, k0:k0 + block_k].to(torch.float32)
        s = torch.matmul(q, k_blk.transpose(1, 2))
        if causal:
            kpos = k0 + torch.arange(k_blk.shape[1], device=q3.device)[None]
            s = torch.where(qpos >= kpos, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        num = num * corr[..., None] + torch.matmul(p, v_blk)
        den = den * corr + p.sum(dim=-1)
        m = m_new
    o = (num / den[..., None]).to(q3.dtype)
    return o, m + torch.log(den)


def _kernel_operands(q3, k3, v3, **like_q):
    """q, k, v and the ``like_q`` tensors (named, shaped as q) as the
    kernels take them, or raise: contiguous CUDA tensors of one dtype,
    bfloat16 or float32, q ``[BH, T, D]``, k/v ``[BH, Tk, D]``, D in
    ``KERNEL_HEAD_DIMS``, BH within the grid's 65535 and some keys.  The
    kernels read through TMA and 16-byte loads, which want 16-byte aligned
    bases: an unaligned tensor is returned as a fresh copy, which is."""
    named = {"q": q3, "k": k3, "v": v3, **like_q}
    for name, t in named.items():
        check_operand(t, name, (torch.bfloat16, torch.float32), 3)
    if len({t.dtype for t in named.values()}) != 1:
        raise ValueError(f"{', '.join(named)} must share one dtype")
    bh, t, d = q3.shape
    if ((k3.shape[0], k3.shape[2]) != (bh, d) or v3.shape != k3.shape
            or any(x.shape != q3.shape for x in like_q.values())):
        raise ValueError("shapes " + " ".join(
            f"{name} {tuple(x.shape)}" for name, x in named.items())
            + " do not agree")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {KERNEL_HEAD_DIMS}")
    if bh > 65535:
        raise ValueError(f"batch*heads {bh} exceeds the grid's 65535")
    if k3.shape[1] == 0:
        raise ValueError("no keys")
    return [x if x.data_ptr() % 16 == 0 else x.clone()
            for x in named.values()]


@kernel
def flash_fwd(q3, k3, v3, scale: float, causal: bool):
    """Flash-attention forward on ``[BH, T, D]`` q and ``[BH, Tk, D]``
    k/v (bfloat16 or float32): O in the input type and lse f32.
    Its work: 4·BH·T·Tk·D FLOPs (about half when causal).  bfloat16
    launches the tensor-core kernel (``flash_fwd_wgmma``, the bf16
    limits), float32 the CUDA-core one (``flash_fwd``, the f32 limits)."""
    if not on_card(q3):
        return flash_fwd_plain(q3, k3, v3, scale, causal)
    q3, k3, v3 = _kernel_operands(q3, k3, v3)
    bh, t, d = q3.shape
    o = torch.empty_like(q3)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q3.device)
    lib = _build.load("flash_attention", _signatures)
    rc = lib.hvd_flash_fwd(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
                           o.data_ptr(), lse.data_ptr(), bh, t, k3.shape[1],
                           d, float(scale), int(bool(causal)),
                           int(q3.dtype == torch.bfloat16), stream_of(q3))
    raise_on_error(rc, "flash_fwd")
    flash_fwd.launches += 1
    return o, lse


def flash_bwd_plain(q3, k3, v3, o3, lse, do3, *, scale, causal,
                    block_k: int = BLOCK_K, dlse=None):
    """Chunked flash backward (recompute), float32 accumulation: a port
    of ``pallas_attention._flash_bwd``.  ``dlse`` folds into Δ, since
    ∂lse_i/∂s_ik = p_ik: dS = P·(dP − Δ + dlse)."""
    bh, t, d = q3.shape
    tk = k3.shape[1]
    qf = q3.to(torch.float32)
    dof = do3.to(torch.float32)
    delta = (dof * o3.to(torch.float32)).sum(dim=-1)        # [bh, t]
    if dlse is not None:
        delta = delta - dlse.to(torch.float32)
    dq = torch.zeros((bh, t, d), dtype=torch.float32, device=q3.device)
    dk = torch.empty((bh, tk, d), dtype=torch.float32, device=q3.device)
    dv = torch.empty((bh, tk, d), dtype=torch.float32, device=q3.device)
    qpos = torch.arange(t, device=q3.device)[:, None]
    for k0 in range(0, tk, block_k):
        k_blk = k3[:, k0:k0 + block_k].to(torch.float32)
        v_blk = v3[:, k0:k0 + block_k].to(torch.float32)
        s = torch.matmul(qf, k_blk.transpose(1, 2)) * scale
        if causal:
            kpos = k0 + torch.arange(k_blk.shape[1], device=q3.device)[None]
            s = torch.where(qpos >= kpos, s, NEG_INF)
        p = torch.exp(s - lse[..., None])                    # [bh, t, bk]
        dv[:, k0:k0 + block_k] = torch.matmul(p.transpose(1, 2), dof)
        dp = torch.matmul(dof, v_blk.transpose(1, 2))
        ds = p * (dp - delta[..., None]) * scale
        dk[:, k0:k0 + block_k] = torch.matmul(ds.transpose(1, 2), qf)
        dq = dq + torch.matmul(ds, k_blk)
    return dq.to(q3.dtype), dk.to(k3.dtype), dv.to(v3.dtype)


@kernel
def flash_bwd(q3, k3, v3, o3, lse, do3, scale: float, causal: bool,
              dlse=None):
    """Flash-attention backward: (dQ, dK, dV) in the input type from the
    forward's ``[BH, T, D]`` q, O and ``[BH, Tk, D]`` k/v, its lse
    ``[BH, T]`` f32, the cotangent ``do3`` and, where lse is used, its
    cotangent ``dlse``.  bfloat16 launches the tensor-core kernels
    (``flash_bwd_delta``, ``flash_bwd_dkdv``, ``flash_bwd_dq``), which
    carry P and dS as bf16 hi/lo pairs, so the gradients round only where
    the plain version rounds them; float32 the CUDA-core ones
    (``flash_bwd_f32_delta``, ``_dkdv``, ``_dq``), as the forward's f32
    route: the f32 limits are beyond bf16 tensor cores (the note at the
    top of ``csrc/flash_attention_bwd.cu``)."""
    if not on_card(q3):
        return flash_bwd_plain(q3, k3, v3, o3, lse, do3, scale=scale,
                               causal=causal, dlse=dlse)
    q3, k3, v3, o3, do3 = _kernel_operands(q3, k3, v3, o=o3, do=do3)
    bh, t, d = q3.shape
    tk = k3.shape[1]
    check_operand(lse, "lse", (torch.float32,), 2)
    if lse.shape != (bh, t) or (dlse is not None
                                and tuple(dlse.shape) != (bh, t)):
        raise ValueError(f"lse and dlse must be [{bh}, {t}]")
    if dlse is not None:
        dlse = dlse.to(torch.float32).contiguous()
    dq = torch.empty_like(q3)
    dk = torch.empty_like(k3)
    dv = torch.empty_like(v3)
    delta = torch.empty((bh, t), dtype=torch.float32, device=q3.device)
    lib = _build.load("flash_attention_bwd", _bwd_signatures)
    rc = lib.hvd_flash_bwd(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
                           o3.data_ptr(), lse.data_ptr(), do3.data_ptr(),
                           None if dlse is None else dlse.data_ptr(),
                           delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                           dv.data_ptr(), bh, t, tk, d, float(scale),
                           int(bool(causal)),
                           int(q3.dtype == torch.bfloat16), stream_of(q3))
    raise_on_error(rc, "flash_bwd")
    flash_bwd.launches += 1
    return dq, dk, dv


class _Flash3(torch.autograd.Function):
    """``[BH, T, D]`` flash attention with both outputs differentiable."""

    @staticmethod
    def forward(ctx, q3, k3, v3, scale, causal):
        o, lse = flash_fwd(q3, k3, v3, scale, causal)
        ctx.save_for_backward(q3, k3, v3, o, lse)
        ctx.scale, ctx.causal = scale, causal
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q3, k3, v3, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q3, k3, v3, o, lse, do.contiguous(),
                               ctx.scale, ctx.causal, dlse=dlse)
        return dq, dk, dv, None, None


def flash_attention_with_lse(q, k, v, *, causal: bool = False,
                             scale: Optional[float] = None):
    """Flash attention on ``[B, T, H, D]`` inputs that also returns the
    per-row logsumexp ``[B, H, T]`` (float32).  Differentiable in both
    outputs."""
    if q.dim() != 4:
        raise ValueError(f"expected [B, T, H, D] inputs, got {tuple(q.shape)}")
    b, t, h, d = q.shape
    tk = k.shape[1]
    if scale is None:
        scale = d ** -0.5
    if causal and t != tk:
        raise ValueError("causal flash attention requires Tq == Tk")

    def pack(x):
        # A batch of one (or one head) makes this reshape a view, not a
        # copy: the kernel takes contiguous rows only.
        return x.permute(0, 2, 1, 3).reshape(b * h, x.shape[1],
                                             d).contiguous()

    o3, lse3 = _Flash3.apply(pack(q), pack(k), pack(v), float(scale),
                             bool(causal))
    o = o3.reshape(b, h, t, d).permute(0, 2, 1, 3)
    return o, lse3.reshape(b, h, t)


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None):
    """Flash attention; the contract of
    :func:`horovod_tpu_torch.parallel.ring_attention.full_attention`:
    q/k/v ``[B, T, H, D]`` → ``[B, T, H, D]``, differentiable."""
    o, _ = flash_attention_with_lse(q, k, v, causal=causal, scale=scale)
    return o


def flash_attention_padded(q, k, v, *, scale: Optional[float] = None):
    """Causal self-attention for any sequence length.  The reference pads
    T up to its kernel's block; this kernel masks its own ragged edge, so
    nothing is padded."""
    if k.shape[1] != q.shape[1]:
        raise ValueError("flash_attention_padded is self-attention only")
    return flash_attention(q, k, v, causal=True, scale=scale)
