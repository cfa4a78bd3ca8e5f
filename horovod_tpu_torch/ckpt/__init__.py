"""Async sharded durable state (counterpart of ``horovod_tpu/ckpt/``).

* :mod:`.snapshot` — snapshot-and-offload: a save costs the step loop
  ONE device→host copy into pooled (pinned, for CUDA tensors) host
  buffers; digests come from those buffers.
* :mod:`.store` + :mod:`.manifest` — per-step npz shard files with a
  JSON manifest (key path → shard file, owners, digest, bytes),
  committed by one atomic rename, in the reference's on-disk format.
* :mod:`.journal` — the fsync'd JSONL of per-step replay metadata.
* :mod:`.writer` + :mod:`.checkpointer` — the bounded background
  writer (``HVD_TPU_CKPT_ASYNC`` / ``HVD_TPU_CKPT_INFLIGHT``) and the
  :class:`AsyncCheckpointer` facade.

:mod:`.compat` is the whole-tree tier on ``torch.save``;
``horovod_tpu_torch.checkpoint`` re-exports it.
"""

from .checkpointer import AsyncCheckpointer, ResumeInfo  # noqa: F401
from .errors import CheckpointCorruptionError  # noqa: F401
from .journal import StepJournal  # noqa: F401
from .manifest import (  # noqa: F401
    Manifest, ManifestError, RestorePlan, assign_owners, diff_manifest,
    plan_restore, shard_filename,
)
from .snapshot import (  # noqa: F401
    BufferPool, Snapshot, is_snapshotable, pytree_digest, take_snapshot,
)
from .store import ShardStore  # noqa: F401
from .writer import AsyncWriter  # noqa: F401

__all__ = [
    "AsyncCheckpointer", "ResumeInfo", "CheckpointCorruptionError",
    "StepJournal", "Manifest", "ManifestError", "RestorePlan",
    "assign_owners", "diff_manifest", "plan_restore",
    "shard_filename", "BufferPool",
    "Snapshot", "is_snapshotable", "pytree_digest", "take_snapshot",
    "ShardStore", "AsyncWriter",
]
