"""Shared plumbing for the port's hand-written CUDA kernels.

Counterpart of ``horovod_tpu/ops/pallas_common.py``.  Where the JAX tier
threads an ``interpret=`` flag, the port has one dispatch rule,
:func:`on_card`: a CUDA tensor launches the kernel, a CPU tensor takes
the kernel's plain PyTorch version, and any other device raises.  There
is no fallback from a kernel to its plain version.

Every kernel wrapper is registered with :func:`kernel`, which gives it a
plain integer ``launches`` count.  The wrapper adds one to it where it
launches its kernel and nowhere else, so a run can show that its main
path went through the kernels (``chip_smoke.py`` reads the counts).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

_KERNELS: List[Callable] = []


def round_up(value: int, multiple: int) -> int:
    """``value`` rounded up to a multiple of ``multiple``."""
    m = max(1, int(multiple))
    return -(-int(value) // m) * m


def pad_dim(x: torch.Tensor, multiple: int, axis: int = 0,
            ) -> Tuple[torch.Tensor, int]:
    """Zero-pad ``x`` along ``axis`` up to a multiple of ``multiple``;
    returns ``(padded, pad)`` so callers can slice the pad back off.
    Zero is the safe fill for every kernel here: it cannot raise a
    quantization block's absmax, and causal attention masks it."""
    axis = axis % x.ndim
    size = x.shape[axis]
    pad = round_up(size, multiple) - size
    if not pad:
        return x, 0
    # F.pad lists (left, right) pairs from the last dim backwards.
    widths = [0, 0] * (x.ndim - axis - 1) + [0, pad]
    return F.pad(x, widths), pad


def on_card(t: torch.Tensor) -> bool:
    """True when ``t`` lies on a CUDA device (launch the kernel), False
    on the CPU (take the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(
        f"no kernel or plain version for tensors on {t.device}; "
        "use a CUDA or a CPU tensor")


def kernel(fn: Callable) -> Callable:
    """Register ``fn`` as a kernel wrapper with a ``launches`` count."""
    fn.launches = 0
    _KERNELS.append(fn)
    return fn


def launch_counts() -> Dict[str, int]:
    """``{wrapper name: launches}`` for every registered kernel."""
    return {fn.__name__: fn.launches for fn in _KERNELS}


def reset_launch_counts() -> None:
    for fn in _KERNELS:
        fn.launches = 0


def check_operand(t: torch.Tensor, name: str, dtypes, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of one of
    ``dtypes`` with ``ndim`` dimensions: what a kernel takes."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def raise_on_error(rc: int, what: str) -> None:
    """A C entry point returns ``cudaGetLastError()``; non-zero means the
    launch was refused (bad configuration) or an earlier fault."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
