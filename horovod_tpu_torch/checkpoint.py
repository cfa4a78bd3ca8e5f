"""Durable checkpoint/resume: the whole-tree tier's public API.

Counterpart of ``horovod_tpu/checkpoint.py``, a thin shim over
:mod:`horovod_tpu_torch.ckpt.compat` (``torch.save`` files with digest
sidecars and the fallback to an intact step).  New code should use
:class:`horovod_tpu_torch.ckpt.AsyncCheckpointer`: the sharded store with
per-step manifests, the step journal and the bounded async writer.
"""

from __future__ import annotations

from .ckpt.compat import (  # noqa: F401
    Checkpointer, CheckpointCorruptionError, _damage_step_dir,
    _digestable, _key_token, latest_step, pytree_digest, restore, save,
    should_save_on_this_host,
)

__all__ = [
    "Checkpointer", "CheckpointCorruptionError", "pytree_digest",
    "save", "restore", "latest_step", "should_save_on_this_host",
]
