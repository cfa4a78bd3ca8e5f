"""Seeds for each purpose, drawn from the run's ``--seed``.

The driver's seeds go past 32 bits, so each purpose hashes the seed with
its own name instead of adding an offset that could collide.
"""

from __future__ import annotations

import hashlib

import torch


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for ``purpose``, the same for the same ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def generator(seed: int, purpose: str, device) -> torch.Generator:
    """A torch generator on ``device`` for ``purpose``."""
    return torch.Generator(device=device).manual_seed(sub_seed(seed, purpose))
