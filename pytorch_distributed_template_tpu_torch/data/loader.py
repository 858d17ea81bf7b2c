"""Batched loading of in-memory numpy arrays: the single-process part of
the JAX package's ``data/loader.py::ArrayDataLoader``.

Batches are dicts of numpy arrays (the trainer moves them to the device).
The order is ``epoch_permutation(seed, epoch, n)`` when shuffling, else
``0..n-1``; when ``drop_last`` is False the last batch is padded to the
static batch size by wraparound duplication and ``batch["mask"]`` marks
the real rows, so losses and metrics stay exact. Same indices, same
padding, same masks as the JAX loader.

Left to slice 5 (the training main path with DP): a sampler (the
multi-process ``ShardedSampler``), ``normalize`` (uint8 image datasets), the
native multithreaded gather and host->device prefetch.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

from .sampler import epoch_permutation


class ArrayDataLoader:
    """Iterate a dict of same-length numpy arrays in batches.

    :param arrays: e.g. ``{"tokens": [N, T]}``.
    :param batch_size: the batch size (static: the last batch is padded).
    :param shuffle: seeded reshuffle each epoch (:meth:`set_epoch`).
    :param drop_last: drop the trailing partial batch instead of padding.
    """

    def __init__(self, arrays: dict, batch_size: int, shuffle: bool = True,
                 drop_last: bool = False, seed: int = 0):
        if not arrays:
            raise ValueError("arrays must be a non-empty dict")
        lens = {k: len(v) for k, v in arrays.items()}
        if len(set(lens.values())) != 1:
            raise ValueError(f"all arrays must share the leading dim, got "
                             f"{lens}")
        self.arrays = arrays
        self.n_samples = next(iter(lens.values()))
        self.batch_size = int(batch_size)
        self.shuffle = bool(shuffle)
        self.drop_last = bool(drop_last)
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def epoch_indices(self) -> np.ndarray:
        if self.shuffle:
            return epoch_permutation(self.seed, self.epoch, self.n_samples)
        return np.arange(self.n_samples)

    def __iter__(self) -> Iterator[dict]:
        idx = self.epoch_indices()
        n = len(idx)
        end = (n // self.batch_size) * self.batch_size if self.drop_last \
            else n
        for start in range(0, end, self.batch_size):
            batch_idx = idx[start:min(start + self.batch_size, end)]
            mask = np.ones(len(batch_idx), dtype=bool)
            if len(batch_idx) < self.batch_size:
                # pad by wraparound (np.resize tiles cyclically); mask pads
                pad = self.batch_size - len(batch_idx)
                batch_idx = np.concatenate([batch_idx, np.resize(idx, pad)])
                mask = np.concatenate([mask, np.zeros(pad, dtype=bool)])
            batch = {k: v[batch_idx] for k, v in self.arrays.items()}
            batch["mask"] = mask
            yield batch

    def __len__(self) -> int:
        if self.drop_last:
            return self.n_samples // self.batch_size
        return -(-self.n_samples // self.batch_size)
