"""Out-of-core image datasets in uint8 mmap shards: the port of the JAX
package's ``data/sharded.py`` (``ShardedU8Array``, ``find_shards``,
``load_sharded_labels``, ``write_image_shards``, ``open_sharded_split``).

A dataset too large for host memory lives on disk as aligned ``.npy``
shards, each memory-mapped and never read whole::

    <data_dir>/<split>_images_0000.npy   uint8 [n_i, H, W, C]
    <data_dir>/<split>_labels_0000.npy   int32 [n_i]

The file names and formats are the JAX package's, so shards either
package writes load in the other. :class:`ShardedU8Array` presents a
shard set as one virtual ``[N, H, W, C]`` array: ``gather`` and
``gather_normalize`` group a batch's global indices by shard and copy the
rows out of the mapped pages with the port's native batcher
(``data/native``; the fused uint8 -> normalised float32 pass for the
latter), so the page cache is the working set. ``ArrayDataLoader`` calls
them for such an array. :func:`write_image_shards` streams samples into
shards, one shard's images buffered at a time.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

from . import native


class ShardedU8Array:
    """Read-only virtual concatenation of aligned uint8 ``.npy`` shards:
    ``len``, ``shape``, ``dtype``, row indexing, and batched ``gather`` /
    ``gather_normalize`` by global index."""

    def __init__(self, paths: Sequence[Path]):
        if not paths:
            raise ValueError("ShardedU8Array needs at least one shard")
        self.shards = [np.load(p, mmap_mode="r") for p in paths]
        base = self.shards[0]
        if base.dtype != np.uint8:
            raise ValueError(f"image shards must be uint8, got {base.dtype} "
                             f"({paths[0]})")
        for p, s in zip(paths, self.shards):
            if s.shape[1:] != base.shape[1:] or s.dtype != base.dtype:
                raise ValueError(f"shard {p} shape {s.shape}/{s.dtype} "
                                 f"mismatches {base.shape}/{base.dtype}")
        # offsets[i]: the first global index of shard i
        counts = np.asarray([len(s) for s in self.shards], np.int64)
        self.offsets = np.concatenate([[0], np.cumsum(counts)])
        self.shape = (int(self.offsets[-1]),) + base.shape[1:]
        self.dtype = base.dtype

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, key):
        """Row slicing and fancy indexing, materialised by ``gather``."""
        if isinstance(key, slice):
            return self.gather(np.arange(*key.indices(len(self))))
        if isinstance(key, (int, np.integer)):
            return self.gather(np.asarray([key]))[0]
        return self.gather(np.asarray(key))

    def _per_shard(self, idx: np.ndarray):
        """``(shard array, local indices, destination rows)`` groups."""
        idx = np.asarray(idx, np.int64)
        if len(idx) and idx.min() < 0:
            idx = np.where(idx < 0, idx + len(self), idx)
        if len(idx) and (idx.min() < 0 or idx.max() >= len(self)):
            raise IndexError("sharded gather index out of range")
        shard_of = np.searchsorted(self.offsets, idx, side="right") - 1
        for s in np.unique(shard_of):
            pos = np.nonzero(shard_of == s)[0]
            yield self.shards[s], idx[pos] - self.offsets[s], pos

    def gather(self, idx: np.ndarray) -> np.ndarray:
        out = np.empty((len(idx),) + self.shape[1:], self.dtype)
        for shard, local, pos in self._per_shard(idx):
            out[pos] = native.gather(shard, local)
        return out

    def gather_normalize(self, idx: np.ndarray, mean: np.ndarray,
                         std: np.ndarray) -> np.ndarray:
        out = np.empty((len(idx),) + self.shape[1:], np.float32)
        for shard, local, pos in self._per_shard(idx):
            out[pos] = native.gather_normalize_u8(shard, local, mean, std)
        return out


def find_shards(data_dir, split: str, kind: str = "images") -> list:
    """Sorted shard paths ``<split>_<kind>_<NNNN>.npy`` under
    ``data_dir``."""
    pat = re.compile(rf"{split}_{kind}_(\d+)\.npy$")
    hits = []
    for p in Path(data_dir).glob(f"{split}_{kind}_*.npy"):
        m = pat.search(p.name)
        if m:
            hits.append((int(m.group(1)), p))
    return [p for _, p in sorted(hits)]


def load_sharded_labels(paths: Sequence[Path]) -> np.ndarray:
    """The label shards concatenated, materialised as int32."""
    return np.concatenate(
        [np.asarray(np.load(p, mmap_mode="r"), np.int32) for p in paths])


def write_image_shards(samples: Iterable[Tuple[np.ndarray, int]],
                       out_dir, split: str = "train",
                       shard_size: int = 8192) -> int:
    """Stream ``(uint8 image, int label)`` samples into aligned shards of
    at most ``shard_size``; returns the number of samples written."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    buf_x: list = []
    buf_y: list = []
    shard = 0
    total = 0

    def flush():
        nonlocal shard, buf_x, buf_y
        if not buf_x:
            return
        np.save(out / f"{split}_images_{shard:04d}.npy",
                np.stack(buf_x).astype(np.uint8))
        np.save(out / f"{split}_labels_{shard:04d}.npy",
                np.asarray(buf_y, np.int32))
        shard += 1
        buf_x, buf_y = [], []

    for img, label in samples:
        buf_x.append(np.asarray(img, np.uint8))
        buf_y.append(int(label))
        total += 1
        if len(buf_x) >= shard_size:
            flush()
    flush()
    return total


def open_sharded_split(data_dir, training: bool
                       ) -> Optional[Tuple[ShardedU8Array, np.ndarray]]:
    """``(images, labels)`` of a split's shard set, or None when it has
    none; unpaired shards (a converter run cut short) raise."""
    split = "train" if training else "val"
    img_paths = find_shards(data_dir, split, "images")
    lbl_paths = find_shards(data_dir, split, "labels")
    if not img_paths and not lbl_paths:
        return None
    if len(img_paths) != len(lbl_paths):
        raise ValueError(
            f"sharded split {split} under {data_dir} is corrupt: "
            f"{len(img_paths)} image shards vs {len(lbl_paths)} label "
            "shards; run tools/make_image_shards.py again")
    images = ShardedU8Array(img_paths)
    labels = load_sharded_labels(lbl_paths)
    if len(images) != len(labels):
        raise ValueError(f"sharded split {split}: {len(images)} images vs "
                         f"{len(labels)} labels")
    return images, labels
