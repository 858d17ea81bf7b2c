"""Batched loading of in-memory numpy arrays and the host->device prefetch:
the port of the JAX package's ``data/loader.py`` (``ArrayDataLoader``,
``prefetch_to_device``).

Batches are dicts of numpy arrays. Without a sampler the order is
``epoch_permutation(seed, epoch, n)`` when shuffling, else ``0..n-1``; a
``ShardedSampler`` owns the order when given (``shuffle`` is then ignored,
as in the reference). When ``drop_last`` is False the last batch is padded
to the static batch size by wraparound duplication, and ``batch["mask"]``
marks the real rows: the sampler's pad mask and the batch's padding
combined. Same indices, same padding, same masks as the JAX loader. Each
batch passes the fault hook ``faults.on_loader_batch`` (``loader_raise``)
before its gather, as in the JAX loader, and the gather and the copy to
the device run in the spans ``data/host_gather`` and ``data/device_put``.

:func:`prefetch_to_device` moves batches to a CUDA device ahead of use:
pinned host copies, ``non_blocking`` transfers on a side stream, and the
consumer's stream made to wait for each batch's copies (an event per
batch) with ``record_stream`` keeping the memory alive until the consumer
is done with it; ``depth`` batches stay in flight. On the CPU it only wraps
the arrays as tensors.

Left to ROADMAP A17: ``normalize`` (uint8 image storage) and the native
multithreaded gather (``data/native/batcher.cpp``).
"""
from __future__ import annotations

import collections
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from ..observability.trace import span
from ..resilience import faults
from .sampler import ShardedSampler, epoch_permutation


class ArrayDataLoader:
    """Iterate a dict of same-length numpy arrays in batches.

    :param arrays: e.g. ``{"image": [N, H, W, C], "label": [N]}``.
    :param batch_size: the per-process batch size (static: the last batch
        is padded).
    :param shuffle: seeded reshuffle each epoch (:meth:`set_epoch`);
        ignored when ``sampler`` is given.
    :param sampler: a ``ShardedSampler`` that owns the index order.
    :param drop_last: drop the trailing partial batch instead of padding.
    """

    def __init__(self, arrays: dict, batch_size: int, shuffle: bool = True,
                 sampler: Optional[ShardedSampler] = None,
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
        self.sampler = sampler
        self.shuffle = bool(shuffle) and sampler is None
        self.drop_last = bool(drop_last)
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if self.sampler is not None:
            self.sampler.set_epoch(epoch)

    def epoch_indices(self):
        """``(indices, real)``: this process's order for the epoch and
        which of its entries are real samples."""
        if self.sampler is not None:
            return self.sampler.indices(), self.sampler.pad_mask()
        if self.shuffle:
            idx = epoch_permutation(self.seed, self.epoch, self.n_samples)
        else:
            idx = np.arange(self.n_samples)
        return idx, np.ones(len(idx), dtype=bool)

    def __iter__(self) -> Iterator[dict]:
        idx, real = self.epoch_indices()
        n = len(idx)
        end = (n // self.batch_size) * self.batch_size if self.drop_last \
            else n
        for bi, start in enumerate(range(0, end, self.batch_size)):
            faults.on_loader_batch(bi, loader=self)
            stop = min(start + self.batch_size, end)
            batch_idx, mask = idx[start:stop], real[start:stop]
            if len(batch_idx) < self.batch_size:
                # pad by wraparound (np.resize tiles cyclically); mask pads
                pad = self.batch_size - len(batch_idx)
                batch_idx = np.concatenate([batch_idx, np.resize(idx, pad)])
                mask = np.concatenate([mask, np.zeros(pad, dtype=bool)])
            with span("data/host_gather"):
                batch = {k: v[batch_idx] for k, v in self.arrays.items()}
            batch["mask"] = mask
            yield batch

    def __len__(self) -> int:
        n = len(self.sampler) if self.sampler is not None \
            else self.n_samples
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)


def to_tensors(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device`` (a blocking copy)."""
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


def prefetch_to_device(batches: Iterable[dict], device,
                       depth: int = 2) -> Iterator[dict]:
    """Yield ``batches`` as tensors on ``device``, keeping ``depth``
    batches' host->device copies in flight on a side CUDA stream. On a
    non-CUDA device each batch is converted when it is reached."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in batches:
            with span("data/device_put"):
                out = to_tensors(batch, device)
            yield out
        return
    copy_stream = torch.cuda.Stream(device)
    in_flight = collections.deque()

    def put(batch):
        with span("data/device_put"), torch.cuda.stream(copy_stream):
            out = {k: torch.from_numpy(np.ascontiguousarray(v))
                   .pin_memory().to(device, non_blocking=True)
                   for k, v in batch.items()}
            done = torch.cuda.Event()
            done.record(copy_stream)
        return out, done

    it = iter(batches)
    for batch in it:
        in_flight.append(put(batch))
        if len(in_flight) >= max(depth, 1):
            break
    while in_flight:
        out, done = in_flight.popleft()
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        for t in out.values():
            t.record_stream(consumer)
        nxt = next(it, None)
        if nxt is not None:
            in_flight.append(put(nxt))
        yield out
