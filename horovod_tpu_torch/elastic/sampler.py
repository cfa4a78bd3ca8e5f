"""ElasticSampler: shard an index space across a world size that can
change mid-epoch without repeating or dropping processed samples.

Reference: ``horovod/torch/elastic/sampler.py`` — a torch Sampler that
records processed indices into the elastic State and re-shards the
remainder over the new world size after a reset.  Same algorithm here,
framework-free (yields numpy index arrays for batches).

Counterpart of ``horovod_tpu/elastic/sampler.py``: the same index
streams and ``state_dict``.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np


class ElasticSampler:
    def __init__(self, num_samples: int, batch_size: int = 1,
                 shuffle: bool = True, seed: int = 0) -> None:
        self.num_samples = num_samples
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.processed_indices: List[int] = []
        self._world_size = 1
        self._rank = 0
        self.reset()

    # --- membership --------------------------------------------------------

    def set_world(self, rank: int, world_size: int) -> None:
        """Re-shard after a membership change (reference: called from
        ``State.on_reset``)."""
        self._rank = rank
        self._world_size = world_size
        self._reshard()

    def set_epoch(self, epoch: int) -> None:
        """New epoch: clear processed set, reshuffle (reference API)."""
        self.epoch = epoch
        self.processed_indices = []
        self.reset()

    def record_batch(self, indices) -> None:
        """Mark indices as processed (goes into the elastic State so a
        rollback replays only unprocessed data)."""
        self.processed_indices.extend(int(i) for i in np.asarray(indices))

    def load_state_dict(self, state: dict) -> None:
        self.epoch = state["epoch"]
        self.processed_indices = list(state["processed_indices"])
        self.reset()

    def state_dict(self) -> dict:
        return {"epoch": self.epoch,
                "processed_indices": list(self.processed_indices)}

    # --- iteration ---------------------------------------------------------

    def reset(self) -> None:
        order = np.arange(self.num_samples)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(order)
        processed = set(self.processed_indices)
        self._remaining = np.array(
            [i for i in order if i not in processed], dtype=np.int64)
        self._reshard()

    def _reshard(self) -> None:
        # Even shards: drop the tail remainder (reference behavior —
        # keeps every rank's step count identical, the SPMD invariant).
        n = len(self._remaining) // self._world_size * self._world_size
        self._shard = self._remaining[:n][self._rank::self._world_size]

    def __len__(self) -> int:
        return len(self._shard) // self.batch_size

    def __iter__(self) -> Iterator[np.ndarray]:
        for i in range(len(self)):
            yield self._shard[i * self.batch_size:(i + 1) * self.batch_size]
