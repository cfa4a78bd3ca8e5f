"""Shared checkpoint error types (one home, no import cycles).

Counterpart of ``horovod_tpu/ckpt/errors.py``."""

from __future__ import annotations

__all__ = ["CheckpointCorruptionError"]


class CheckpointCorruptionError(RuntimeError):
    """No step restored AND verified (raised only after the fallback
    scan exhausted every retained step)."""
