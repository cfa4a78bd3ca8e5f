"""A model's weights, made on the device from the seed.

The benchmark makes the weights and hands the same ones to the port and
to the reference; neither makes its own.  A family lists its leaves as
``(name, shape, init)`` with ``init`` one of ``("normal", std)``,
``("ones",)`` and ``("zeros",)``; every normal leaf is a slice of one
draw of a standard normal, in one call, scaled in place.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

from .seeds import generator

LeafSpec = Tuple[str, Tuple[int, ...], tuple]


def make_weights(specs: Sequence[LeafSpec], seed: int, device,
                 dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` in ``dtype`` on ``device``, the same for the
    same ``seed`` and specs.  Normal leaves are views of one buffer."""
    normal = [(n, s, i) for n, s, i in specs if i[0] == "normal"]
    total = sum(math.prod(s) for _, s, _ in normal)
    flat = torch.randn(total, generator=generator(seed, "weights", device),
                       device=device, dtype=dtype)
    out: Dict[str, torch.Tensor] = {}
    offset = 0
    for name, shape, init in specs:
        kind = init[0]
        if kind == "normal":
            n = math.prod(shape)
            leaf = flat[offset:offset + n].view(shape)
            leaf.mul_(float(init[1]))
            offset += n
        elif kind == "ones":
            leaf = torch.ones(shape, device=device, dtype=dtype)
        elif kind == "zeros":
            leaf = torch.zeros(shape, device=device, dtype=dtype)
        else:
            raise ValueError(f"{name}: unknown init {init!r}")
        out[name] = leaf
    return out


def dense(name: str, d_in: int, d_out: int) -> List[LeafSpec]:
    """A kernel ``[in, out]`` of std ``d_in ** -0.5``."""
    return [(name, (d_in, d_out), ("normal", d_in ** -0.5))]


def layer_norm(prefix: str, d: int) -> List[LeafSpec]:
    return [(f"{prefix}.scale", (d,), ("ones",)),
            (f"{prefix}.bias", (d,), ("zeros",))]


def copy_weights(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into ``model``'s parameters; the names must be
    the same set."""
    own = dict(model.named_parameters())
    if set(own) != set(weights):
        raise ValueError(
            f"weights and model differ: missing {sorted(set(own) - set(weights))}"
            f", extra {sorted(set(weights) - set(own))}")
    with torch.no_grad():
        for name, p in own.items():
            p.copy_(weights[name])
