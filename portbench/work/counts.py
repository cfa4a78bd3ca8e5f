"""Operations and bytes, from shapes alone: the same whatever kernel or
library does the work.

- :func:`model_flops_per_step`: a rank's step as the model needs it:
  ``6 × matmul parameters × tokens`` for the forward and backward
  products, plus attention's ``QKᵀ`` and ``PV``, ``3 × 4·B·T²·d`` a
  layer, with a causal model's half counted once.  Recompute is not
  counted.
- :func:`flash_fwd_launch`: one launch of the flash forward (B1) on
  ``[BH, T, D]``: ``4·BH·T·Tk·D`` operations (half when causal); Q, K,
  V and O in bf16 and the f32 lse, each moved once.
- :func:`int8_wire_bytes`: a step's bytes in the int8 wire's kernels (B2
  quantize, B3 dequantize-accumulate, B4 dequantize) for gradient
  leaves of the given sizes over ``n`` ranks: error feedback's round trip
  of every leaf, then the reduce-scatter and the all-gather of the flat
  gradient, f32, int8 and one f32 scale a block each read or written
  once.  Pads (zeros to whole blocks and chunks, under 0.01%) are not
  counted.
- :func:`bound_s`: the least time the card could take, the larger of
  operations over the peak and bytes over the memory rate.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Sequence

WIRE_BLOCK = 1024           # the int8 wire's block (``quantization.py``)
PEAKS = Path(__file__).with_name("peaks.json")


def model_flops_per_step(shape: dict, batch: int, seq: int) -> float:
    tokens = batch * seq
    attn = 3 * 4 * batch * seq * seq * shape["d_model"] * shape["n_layer"]
    if shape["causal"]:
        attn /= 2
    return 6.0 * shape["matmul_params"] * tokens + attn


def flash_fwd_launch(bh: int, t: int, tk: int, d: int, causal: bool,
                     itemsize: int = 2) -> Dict[str, float]:
    flops = 4.0 * bh * t * tk * d * (0.5 if causal else 1.0)
    nbytes = itemsize * bh * d * (2 * t + 2 * tk) + 4.0 * bh * t
    return {"flops": flops, "bytes": nbytes}


def _block(elems_per_contributor: int, n: int) -> int:
    k = -(-int(elems_per_contributor) // max(1, n))
    return max(1, min(WIRE_BLOCK, k))


def int8_wire_bytes(leaf_numels: Sequence[int], n: int,
                    error_feedback: bool) -> Dict[str, float]:
    """``{"B2", "B3", "B4", "total"}`` bytes a step."""
    b2 = b3 = b4 = 0.0
    if error_feedback:
        for e in leaf_numels:
            scales = 4.0 * e / _block(e, n)
            b2 += 4 * e + e + scales          # f32 in, int8 and scales out
            b4 += e + scales + 4 * e          # int8 and scales in, f32 out
    g = float(sum(leaf_numels))
    if n > 1:
        s = 4.0 * g / WIRE_BLOCK
        b2 += 4 * g + g + s                   # reduce-scatter: every chunk
        b3 += g + s + 4 * g / n               # n contributions in, shard out
        b2 += 4 * g / n + g / n + s / n       # all-gather: the shard
        b4 += g + s + 4 * g                   # every shard out
    return {"B2": b2, "B3": b3, "B4": b4, "total": b2 + b3 + b4}


def peaks_for(device_name: str) -> Optional[dict]:
    """The card's peaks from ``peaks.json``, None for a card not there."""
    with open(PEAKS) as f:
        return json.load(f).get(device_name)


def bound_s(flops: float, nbytes: float, peaks: dict,
            flops_key: str = "bf16_flops") -> float:
    return max(flops / peaks[flops_key], nbytes / peaks["hbm_bytes_per_s"])
