"""The per-epoch sample order: a copy of the JAX package's
``data/sampler.py::epoch_permutation``.

The multi-process ``ShardedSampler`` (DistributedSampler semantics over
``torch.distributed`` ranks) is slice 4's (the training main path with
DP).
"""
from __future__ import annotations

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
