"""The int8 wire's kernels: blockwise quantize, dequantize, and
dequantize-accumulate over contributors.

Counterparts of ``horovod_tpu/ops/pallas_collectives.py``'s
``quantize_blocks`` (``_quant_kernel``), ``dequantize_blocks``
(``_dequant_kernel``) and the receive side of
``fused_quantize_reducescatter`` (``_dequant_accum_kernel``).  The CUDA
sources are ``csrc/int8_kernels.cu``.

Each function has three parts: a kernel wrapper (dispatching on the
tensor's device, :func:`.kernel_common.on_card`), a plain PyTorch
version of the same arithmetic (``*_plain``), and a launch count.  The
results are bitwise equal to the reference wire
(``horovod_tpu/ops/quantization.py``): the scale is
``max(absmax * f32(1/127), 1e-30)``, the payload is
``clip(round_half_even(x / scale), -127, 127)`` (NaN carried into the
scale, a NaN payload stored as 0), the dequantize is
``q * scale`` in f32, and contributions are summed one by one in rank
order, which is the only order that matches the reference's
``jnp.sum(axis=0)``.

All three kernels are bound by device memory (bytes, not operations);
see the note at the top of the CUDA source for what their design does
about it.  The dequantize and the dequantize-accumulate each have two
CUDA kernels, a vector route and a scalar one, chosen by
:func:`_dequant_route`; both give the same bits, and either counts one
launch.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .kernel_common import (check_operand, kernel, on_card, raise_on_error,
                            stream_of)

EPS = 1e-30
# float32(1/127), as quantization._INV127: the scale is an explicit
# multiply by this constant, never a division by 127.
INV127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()

_P = ctypes.c_void_p
_signatures = {
    "hvd_quantize_blocks": [_P, _P, _P, ctypes.c_int64, ctypes.c_int, _P],
    "hvd_dequantize_blocks": [_P, _P, _P, ctypes.c_int64, ctypes.c_int,
                              ctypes.c_int, _P],
    "hvd_dequantize_accumulate": [_P, _P, _P, ctypes.c_int, ctypes.c_int64,
                                  ctypes.c_int, ctypes.c_int, _P],
}
# The vector route's group index is divided as a 32-bit number.
_MAX_VECTOR_GROUPS = 2 ** 31
# The CUDA kernel behind each route of B4 and B3, as the profiler's device
# trace names it (each scalar name is a prefix of its vector name).
ROUTE_KERNELS = {
    "dequantize_blocks": {"vector": "dequantize_rows_vec4",
                          "scalar": "dequantize_rows"},
    "dequantize_accumulate": {"vector": "dequantize_accumulate_vec4",
                              "scalar": "dequantize_accumulate_rows"},
}


def _lib() -> ctypes.CDLL:
    return _build.load("int8_kernels", _signatures)


def _dequant_route(b: int, q_ptr: int, out_ptr: int, out_numel: int) -> str:
    """Which kernel dequantizes rows of ``b`` int8 at address ``q_ptr``
    into ``out_numel`` f32 at ``out_ptr``: ``"vector"`` (char4 loads,
    float4 stores) when a group of 4 never straddles two rows
    (``b % 4 == 0``), both pointers are aligned for those accesses and
    the output's groups of 4 number fewer than 2**31; otherwise
    ``"scalar"`` (one element a thread), which takes any ``b`` and any
    address.  The CUDA entry points trust this choice."""
    if (b % 4 == 0 and q_ptr % 4 == 0 and out_ptr % 16 == 0
            and out_numel // 4 < _MAX_VECTOR_GROUPS):
        return "vector"
    return "scalar"


def routes_run(kernel_names, wrapper: str) -> set:
    """The routes of ``wrapper`` (``"dequantize_blocks"`` or
    ``"dequantize_accumulate"``) whose CUDA kernels appear in
    ``kernel_names``, the names a profiler's device trace records."""
    vector = ROUTE_KERNELS[wrapper]["vector"]
    scalar = ROUTE_KERNELS[wrapper]["scalar"]
    ran = set()
    if any(vector in n for n in kernel_names):
        ran.add("vector")
    if any(scalar in n and vector not in n for n in kernel_names):
        ran.add("scalar")
    return ran


# --- plain versions -----------------------------------------------------------

def quantize_blocks_plain(blocks: torch.Tensor):
    # amax and clamp_min carry NaN into the scale, as the reference's
    # jnp.max and jnp.maximum; a NaN payload becomes 0, as XLA casts it.
    scale = torch.clamp_min(blocks.abs().amax(dim=-1) * INV127, EPS)
    q = torch.clamp(torch.round(blocks / scale[..., None]), -127, 127)
    return q.nan_to_num(nan=0.0).to(torch.int8), scale


def dequantize_blocks_plain(q: torch.Tensor, scales: torch.Tensor):
    return q.to(torch.float32) * scales[..., None]


def dequantize_accumulate_plain(q: torch.Tensor, scales: torch.Tensor):
    acc = torch.zeros(q.shape[1:], dtype=torch.float32, device=q.device)
    for c in range(q.shape[0]):           # rank order, one by one
        acc = acc + q[c].to(torch.float32) * scales[c][:, None]
    return acc


# --- kernel wrappers ----------------------------------------------------------

@kernel
def quantize_blocks(blocks: torch.Tensor):
    """``[rows, b]`` f32 → (int8 ``[rows, b]``, f32 scales ``[rows]``):
    symmetric per-row int8 quantization, the wire's phases 1 and 3 and
    the error-feedback roundtrip.  Bound by bytes (5 B an element)."""
    if not on_card(blocks):
        return quantize_blocks_plain(blocks)
    check_operand(blocks, "blocks", (torch.float32,), 2)
    rows, b = blocks.shape
    q = torch.empty((rows, b), dtype=torch.int8, device=blocks.device)
    s = torch.empty((rows,), dtype=torch.float32, device=blocks.device)
    if rows and b:
        rc = _lib().hvd_quantize_blocks(blocks.data_ptr(), q.data_ptr(),
                                        s.data_ptr(), rows, b,
                                        stream_of(blocks))
        raise_on_error(rc, "quantize_blocks")
        quantize_blocks.launches += 1
    return q, s


@kernel
def dequantize_blocks(q: torch.Tensor, scales: torch.Tensor):
    """int8 ``[rows, b]`` and f32 ``[rows]`` → f32 ``[rows, b]``
    (``q * scale``): the wire's phase 4 and the error-feedback
    roundtrip.  Bound by bytes (5 B an element)."""
    if not on_card(q):
        return dequantize_blocks_plain(q, scales)
    check_operand(q, "q", (torch.int8,), 2)
    check_operand(scales, "scales", (torch.float32,), 1)
    rows, b = q.shape
    if scales.shape[0] != rows:
        raise ValueError(f"{rows} rows but {scales.shape[0]} scales")
    out = torch.empty((rows, b), dtype=torch.float32, device=q.device)
    if rows and b:
        vector = _dequant_route(b, q.data_ptr(), out.data_ptr(),
                                out.numel()) == "vector"
        rc = _lib().hvd_dequantize_blocks(q.data_ptr(), scales.data_ptr(),
                                          out.data_ptr(), rows, b, vector,
                                          stream_of(q))
        raise_on_error(rc, "dequantize_blocks")
        dequantize_blocks.launches += 1
    return out


@kernel
def dequantize_accumulate(q: torch.Tensor, scales: torch.Tensor):
    """int8 ``[n, m, b]`` from ``n`` contributors with f32 scales
    ``[n, m]`` → their f32 sum ``[m, b]``: the receive side of the int8
    reduce-scatter (phase 2).  Bound by bytes (n + 4 B an output
    element)."""
    if not on_card(q):
        return dequantize_accumulate_plain(q, scales)
    check_operand(q, "q", (torch.int8,), 3)
    check_operand(scales, "scales", (torch.float32,), 2)
    n, m, b = q.shape
    if tuple(scales.shape) != (n, m):
        raise ValueError(f"scales {tuple(scales.shape)} for q {(n, m, b)}")
    out = torch.empty((m, b), dtype=torch.float32, device=q.device)
    if n and m and b:
        vector = _dequant_route(b, q.data_ptr(), out.data_ptr(),
                                out.numel()) == "vector"
        rc = _lib().hvd_dequantize_accumulate(q.data_ptr(), scales.data_ptr(),
                                              out.data_ptr(), n, m, b, vector,
                                              stream_of(q))
        raise_on_error(rc, "dequantize_accumulate")
        dequantize_accumulate.launches += 1
    elif not n:
        out.zero_()
    return out
