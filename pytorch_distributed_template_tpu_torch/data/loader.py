"""Batched loading of in-memory numpy arrays and the host->device prefetch:
the port of the JAX package's ``data/loader.py`` (``ArrayDataLoader``,
``host_prefetch``, ``prefetch_to_device``).

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
Every array is gathered by the native multithreaded batcher
(``data/native``, numpy for what it cannot take). ``normalize`` (a uint8
image array) gives float32 ``(x / 255 - mean) / std`` batches through the
fused native gather, or, with ``on_device``, keeps them uint8 across the
copy and normalises on the device (:attr:`ArrayDataLoader.
device_transform`, which ``prefetch_to_device`` applies).

:func:`host_prefetch` assembles batches on a background thread, ``depth``
ahead of the consumer (the role of the reference's loader workers).

:func:`prefetch_to_device` moves batches to a CUDA device ahead of use:
pinned host copies, ``non_blocking`` transfers on a side stream, and the
consumer's stream made to wait for each batch's copies (an event per
batch) with ``record_stream`` keeping the memory alive until the consumer
is done with it; ``depth`` batches stay in flight. On the CPU it only wraps
the arrays as tensors.

:meth:`ArrayDataLoader.iter_batches` starts an epoch at a batch ordinal
without gathering the batches before it (step-accurate resume).

"""
from __future__ import annotations

import collections
import queue
import threading
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from ..observability.trace import span
from ..resilience import faults
from . import native
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
    :param normalize: ``{"key": "image", "mean": [...], "std": [...]}``
        for a uint8 array with a trailing channel dim; ``"on_device":
        true`` defers it past the copy (:attr:`device_transform`).
    """

    def __init__(self, arrays: dict, batch_size: int, shuffle: bool = True,
                 sampler: Optional[ShardedSampler] = None,
                 drop_last: bool = False, seed: int = 0,
                 normalize: Optional[dict] = None):
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
        self.normalize = dict(normalize) if normalize else None
        self._norm_on_device = False
        if self.normalize:
            if not ("mean" in self.normalize and "std" in self.normalize):
                raise ValueError("normalize needs 'mean' and 'std'")
            key = self.normalize.get("key", "image")
            if key not in arrays:
                raise ValueError(f"normalize key {key!r} not in arrays "
                                 f"{sorted(arrays)}")
            if arrays[key].dtype != np.uint8:
                raise ValueError(
                    f"normalize targets uint8 storage; array {key!r} is "
                    f"{arrays[key].dtype} — pre-normalized data should "
                    "drop the normalize option")
            self._norm_on_device = bool(self.normalize.get("on_device"))

    @property
    def device_transform(self):
        """With ``normalize.on_device``: ``batch -> batch`` with the image
        tensor made float32 ``(x / 255 - mean) / std`` on its device (a
        batch without the key passes unchanged); else None."""
        if not self._norm_on_device:
            return None
        key = self.normalize.get("key", "image")
        mean = torch.tensor(self.normalize["mean"], dtype=torch.float32)
        std = torch.tensor(self.normalize["std"], dtype=torch.float32)

        def transform(batch: dict) -> dict:
            if key not in batch:
                return batch
            x = batch[key]
            x = x.float() / 255.0
            return {**batch, key: (x - mean.to(x.device)) / std.to(x.device)}

        return transform

    def _gather(self, key: str, v, batch_idx) -> np.ndarray:
        """Rows ``batch_idx`` of ``v``: a virtual array with its own
        ``gather`` / ``gather_normalize`` (``data/sharded.py``) gathers
        itself, any other array through the native batcher."""
        if (self.normalize is not None and not self._norm_on_device
                and key == self.normalize.get("key", "image")):
            mean = np.asarray(self.normalize["mean"], np.float32)
            std = np.asarray(self.normalize["std"], np.float32)
            if hasattr(v, "gather_normalize"):
                return v.gather_normalize(batch_idx, mean, std)
            return native.gather_normalize_u8(v, batch_idx, mean, std)
        if hasattr(v, "gather"):
            return v.gather(batch_idx)
        return native.gather(v, batch_idx)

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
        return self.iter_batches()

    def iter_batches(self, start_batch: int = 0) -> Iterator[dict]:
        """The epoch's batches from batch ordinal ``start_batch`` on
        (a mid-epoch resume): the skipped batches are not gathered, and
        the order is a pure function of ``(seed, epoch)``, so the skip is
        exact. The ``loader_raise`` hook sees the epoch-absolute
        ordinal."""
        idx, real = self.epoch_indices()
        n = len(idx)
        end = (n // self.batch_size) * self.batch_size if self.drop_last \
            else n
        for bi, start in enumerate(range(0, end, self.batch_size)):
            if bi < start_batch:
                continue
            faults.on_loader_batch(bi, loader=self)
            stop = min(start + self.batch_size, end)
            batch_idx, mask = idx[start:stop], real[start:stop]
            if len(batch_idx) < self.batch_size:
                # pad by wraparound (np.resize tiles cyclically); mask pads
                pad = self.batch_size - len(batch_idx)
                batch_idx = np.concatenate([batch_idx, np.resize(idx, pad)])
                mask = np.concatenate([mask, np.zeros(pad, dtype=bool)])
            with span("data/host_gather"):
                batch = {k: self._gather(k, v, batch_idx)
                         for k, v in self.arrays.items()}
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


def host_prefetch(iterable: Iterable, depth: int = 2) -> Iterator:
    """``iterable``'s items assembled on a background thread, at most
    ``depth`` ahead of the consumer (a bounded queue). An exception in the
    thread is raised where the consumer reaches it; a consumer that stops
    early releases the thread and the buffered items."""
    q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    done = object()
    stop = threading.Event()

    def worker():
        try:
            for item in iterable:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        pass
                if stop.is_set():
                    return
            q.put(done)
        except BaseException as exc:  # noqa: BLE001 — to the consumer
            if not stop.is_set():
                q.put(exc)

    thread = threading.Thread(target=worker, daemon=True,
                              name="host-prefetch")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break


def prefetch_to_device(batches: Iterable[dict], device, depth: int = 2,
                       transform=None) -> Iterator[dict]:
    """Yield ``batches`` as tensors on ``device``, keeping ``depth``
    batches' host->device copies in flight on a side CUDA stream. On a
    non-CUDA device each batch is converted when it is reached.
    ``transform`` (a loader's ``device_transform``) runs on each batch
    once it is on the device."""
    device = torch.device(device)
    if transform is None:
        def transform(batch):
            return batch
    if device.type != "cuda":
        for batch in batches:
            with span("data/device_put"):
                out = to_tensors(batch, device)
            yield transform(out)
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
        yield transform(out)
