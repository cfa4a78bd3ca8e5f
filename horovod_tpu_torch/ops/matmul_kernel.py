"""The FSDP unshard epilogue's product: ``x [M, K] @ w [K, N]`` with
both operands upcast to f32, an f32 sum over K, and the result in x's
dtype.

Counterpart of ``horovod_tpu/ops/pallas_collectives.py``'s
``_matmul_kernel`` (launched by ``fused_matmul_allgather``).  The CUDA
source is ``csrc/matmul.cu``: the reference's f32 function on the bf16
tensor cores, each f32 operand split into three bf16 pieces by a
pre-pass and the exact piece products summed in f32.  The products bound
it; see the note at the top of the source.

The reference has no gradient through this product, so the wrapper
raises on an operand that requires one rather than return a tensor
silently cut from the graph.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .kernel_common import (check_operand, kernel, on_card, raise_on_error,
                            round_up, stream_of)

BLOCK_K = 512       # K panel of the plain version, the reference's block_k
DTYPES = (torch.float32, torch.bfloat16)

_P = ctypes.c_void_p
_signatures = {
    "hvd_matmul": [_P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, _P, _P, _P],
}


def _lib() -> ctypes.CDLL:
    return _build.load("matmul", _signatures)


def _check_shapes(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"expected x [M, K] @ w [K, N]; got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError("blocked_matmul has no gradient (nor has the "
                           "reference's); pass detached operands")


def _pieces(t: torch.Tensor, rows: int, cols: int):
    """Scratch for the kernel's bf16 pieces of operand ``t`` (three for
    f32, one for bf16), rows padded to a multiple of 8 elements, or None
    where TMA can read a bf16 ``t`` as it is (16-byte rows and base)."""
    if (t.dtype == torch.bfloat16 and cols % 8 == 0
            and t.data_ptr() % 16 == 0):
        return None
    pieces = 1 if t.dtype == torch.bfloat16 else 3
    return torch.empty(pieces * rows * round_up(cols, 8),
                       dtype=torch.bfloat16, device=t.device)


def matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The reference's order: f32 products of K panels of ``BLOCK_K``,
    summed into an f32 accumulator, cast to x's dtype at the end."""
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32,
                      device=x.device)
    for k0 in range(0, x.shape[1], BLOCK_K):
        acc = acc + torch.matmul(x[:, k0:k0 + BLOCK_K].to(torch.float32),
                                 w[k0:k0 + BLOCK_K].to(torch.float32))
    return acc.to(x.dtype)


@kernel
def blocked_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [M, K] @ w [K, N]`` (each f32 or bf16) → ``[M, N]`` in x's
    dtype, summed in f32: 2·M·N·K operations for each bf16 piece product
    on the tensor cores (3 with one f32 operand, 6 with two, 1 with
    none)."""
    _check_shapes(x, w)
    if not on_card(x):
        return matmul_plain(x, w)
    check_operand(x, "x", DTYPES, 2)
    check_operand(w, "w", DTYPES, 2)
    if w.device != x.device:
        raise ValueError(f"x on {x.device} but w on {w.device}")
    (m, k), n = x.shape, w.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m and n:
        # The scratch is released on return, before the kernel has run:
        # the caching allocator hands it only to work queued after the
        # kernel on this stream.
        xs = _pieces(x, m, k)
        ws = _pieces(w, k, n)
        rc = _lib().hvd_matmul(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                               m, n, k, int(x.dtype == torch.bfloat16),
                               int(w.dtype == torch.bfloat16),
                               xs.data_ptr() if xs is not None else None,
                               ws.data_ptr() if ws is not None else None,
                               stream_of(x))
        raise_on_error(rc, "blocked_matmul")
        blocked_matmul.launches += 1
    return y
