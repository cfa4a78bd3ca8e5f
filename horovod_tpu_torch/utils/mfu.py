"""MFU accounting for the benchmarks.

Counterpart of ``horovod_tpu/utils/mfu.py``: one place for (a) the
advertised dense bf16 peak of each card and (b) the FLOPs of one call,
so every benchmark reports ``mfu_pct`` the same way for the same card.

The peaks are NVIDIA's data-sheet dense bf16 rates (no sparsity), keyed
by ``torch.cuda.get_device_name``; a card whose power limit is below the
part's maximum runs slower than its peak, so report the limit beside
``mfu_pct``.
"""

from __future__ import annotations

import os
from typing import Any, Optional, Tuple

# Advertised dense bf16 peak TFLOP/s a card; HVD_TPU_PEAK_TFLOPS
# overrides it for an unlisted card.
PEAK_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.0,    # H100 SXM
    "NVIDIA H100 PCIe": 756.0,
    "NVIDIA H100 NVL": 835.0,
    "NVIDIA A100-SXM4-80GB": 312.0,
    "NVIDIA A100-SXM4-40GB": 312.0,
    "NVIDIA A100-PCIE-40GB": 312.0,
    "NVIDIA A100 80GB PCIe": 312.0,
}

_warned_unknown_kinds = set()


def _device_kind(device) -> str:
    """The card's name: a ``torch.device`` on CUDA asks
    ``torch.cuda.get_device_name``; a string is the name itself; any
    other object its ``device_kind`` (as the reference's devices)."""
    if isinstance(device, str):
        return device
    if getattr(device, "type", None) == "cuda":
        import torch

        return torch.cuda.get_device_name(device)
    return getattr(device, "device_kind", "") or ""


def peak_tflops(device) -> float:
    """The peak for ``device``, the override first; 0.0 when unknown
    (callers then leave ``mfu_pct`` out rather than report nonsense)."""
    return peak_tflops_info(device)[0]


def peak_tflops_info(device) -> Tuple[float, str]:
    """``(peak, source)``, source one of ``"env_override"``,
    ``"device_kind_table"``, ``"device_kind_prefix:<key>"`` (a kind with
    a suffix) or ``"unknown_device_kind:<kind>"`` (peak 0.0; callers
    leave ``mfu_pct`` out).  ``HVD_TPU_PEAK_TFLOPS`` beats every other
    source."""
    env = float(os.environ.get("HVD_TPU_PEAK_TFLOPS", 0) or 0)
    if env:
        return env, "env_override"
    kind = _device_kind(device)
    peak = PEAK_TFLOPS.get(kind, 0.0)
    if peak:
        return peak, "device_kind_table"
    # An unlisted kind with a suffix ("NVIDIA H100 80GB HBM3 MIG 1g.10gb")
    # takes the longest key it starts with, and only when the next
    # character is not alphanumeric: another family ("... HBM3e") must
    # not match.
    for known in sorted(PEAK_TFLOPS, key=len, reverse=True):
        if kind.startswith(known) and (len(kind) == len(known)
                                       or not kind[len(known)].isalnum()):
            return PEAK_TFLOPS[known], f"device_kind_prefix:{known}"
    # 0.0 drops mfu_pct from every artifact: say so, once a kind.
    if kind not in _warned_unknown_kinds:
        _warned_unknown_kinds.add(kind)
        from .logging import get_logger

        get_logger(__name__).warning(
            "unknown device kind %r: no PEAK_TFLOPS entry, so mfu_pct "
            "will be omitted from bench artifacts; set "
            "HVD_TPU_PEAK_TFLOPS=<peak dense-bf16 TFLOP/s> to supply one "
            "(known kinds: %s)",
            kind or "<none>", ", ".join(sorted(PEAK_TFLOPS)))
    return 0.0, f"unknown_device_kind:{kind or '<none>'}"


def estimate_compute_us(flops: Optional[float], device) -> Optional[float]:
    """The time ``flops`` take at the card's advertised dense bf16 peak,
    in µs: the compute term of the overlap cost model.  None when the
    peak is unknown or ``flops`` is missing (callers then use a measured
    time rather than a made-up estimate)."""
    if not flops:
        return None
    peak = peak_tflops(device)
    if not peak:
        return None
    return float(flops) / (peak * 1e12) * 1e6


def count_flops(fn, *args) -> Tuple[Any, Optional[float]]:
    """Run ``fn(*args)`` once under ``torch.utils.flop_counter.
    FlopCounterMode``; returns ``(fn, flops)``, the FLOPs of that call
    (None when the counter saw none).  The counterpart of the
    reference's ``aot_compile_with_flops``, with its own caveat: the
    counter sees aten's operators only, so the hand-written kernels,
    called through ctypes (flash attention's forward, the blocked
    matmul), are not counted.  The call runs for real (a train step
    steps), and its exceptions propagate."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return fn, (float(counter.get_total_flops()) or None)
