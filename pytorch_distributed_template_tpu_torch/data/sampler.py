"""Deterministic sharded index sampling: a copy of the JAX package's
``data/sampler.py`` (``epoch_permutation``, ``ShardedSampler``) over
``torch.distributed`` ranks.

``DistributedSampler`` semantics: the index set is padded by duplication
(``np.resize``, cycling when the pad exceeds the set) up to a multiple of
the shard count, shard ``i`` takes positions ``i::num_shards`` of the
global order, and shuffling permutes globally from ``(seed, epoch)`` so
every shard sees the same permutation. ``pad_mask()`` marks which of a
shard's indices are real, so evaluation over the padded set stays exact.
The shard count and index default to the port's process group
(``parallel.dist``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def epoch_permutation(seed: int, epoch: int, n: int) -> np.ndarray:
    """The canonical per-epoch permutation: Philox keyed from
    ``SeedSequence((seed, epoch))``, so every process derives the same order
    from ``(seed, epoch)`` and different epochs draw independent streams.
    Byte-identical to the JAX package's."""
    rng = np.random.Generator(
        np.random.Philox(np.random.SeedSequence((seed, epoch)))
    )
    return rng.permutation(n)


class ShardedSampler:
    """One shard's indices of ``num_samples``, epoch by epoch.

    :param num_shards / shard_index: default to the process group's world
        size and rank (1 and 0 without a group).
    """

    def __init__(self, num_samples: int, num_shards: Optional[int] = None,
                 shard_index: Optional[int] = None, shuffle: bool = True,
                 seed: int = 0):
        from ..parallel import dist

        num_shards = dist.process_count() if num_shards is None \
            else num_shards
        shard_index = dist.process_index() if shard_index is None \
            else shard_index
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard_index {shard_index} out of range for "
                             f"{num_shards} shards")
        if num_samples <= 0:
            raise ValueError("num_samples must be positive")
        self.num_samples = num_samples
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        # ceil(n / shards) * shards, like DistributedSampler
        self.total_size = -(-num_samples // num_shards) * num_shards
        self.shard_size = self.total_size // num_shards

    def set_epoch(self, epoch: int) -> None:
        """Reseed the per-epoch permutation (DistributedSampler.set_epoch)."""
        self.epoch = epoch

    def _global_indices(self) -> np.ndarray:
        if self.shuffle:
            idx = epoch_permutation(self.seed, self.epoch, self.num_samples)
        else:
            idx = np.arange(self.num_samples)
        if self.total_size != self.num_samples:
            # duplicate-padding, cycling when the pad exceeds n (1 sample
            # over 3 shards repeats it twice)
            idx = np.resize(idx, self.total_size)
        return idx

    def indices(self) -> np.ndarray:
        """This shard's indices for the current epoch."""
        return self._global_indices()[self.shard_index::self.num_shards]

    def pad_mask(self) -> np.ndarray:
        """True where this shard's index is real data: the padding sits at
        global positions ``>= num_samples``."""
        positions = np.arange(self.shard_index, self.total_size,
                              self.num_shards)
        return positions < self.num_samples

    def state(self) -> dict:
        """The knobs that derive this shard's order (the order itself is a
        pure function of them)."""
        return {"num_samples": self.num_samples,
                "num_shards": self.num_shards,
                "shard_index": self.shard_index, "shuffle": self.shuffle,
                "seed": self.seed, "epoch": self.epoch}

    def __iter__(self):
        return iter(self.indices())

    def __len__(self) -> int:
        return self.shard_size
