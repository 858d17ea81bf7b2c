"""Datasets and their loaders, registered in ``config.LOADERS``: the port
of the JAX package's ``data/datasets.py`` for the LM family
(``synthetic_lm``, ``SyntheticLMLoader``, ``ByteLMLoader``) and MNIST
(``_synthetic_image_classification``, ``synthetic_mnist``,
``_try_load_mnist``, ``MnistDataLoader``).

The arrays are byte-identical to the JAX package's (same numpy Philox
generators, same seeds, the same memory-mapped bytes). Real MNIST is read
from raw or gzipped idx files anywhere under ``data_dir``; nothing is
downloaded, so without them the loader falls back to the deterministic,
learnable synthetic set of the same shapes. Every loader shards over the
process group's ranks (a ``ShardedSampler``) when there is more than one
process. ``BpeLMLoader`` is registered so a config naming it fails with
the slice it waits for.
"""
from __future__ import annotations

import gzip
import logging
from pathlib import Path

import numpy as np

from ..config.registry import LOADERS
from ..parallel import dist
from .loader import ArrayDataLoader
from .sampler import ShardedSampler

_SLICE_BPE = ("BpeLMLoader (its tokenizer cache) is a later slice (the "
              "data layer)")
logger = logging.getLogger(__name__)


def _synthetic_image_classification(n: int, shape, num_classes: int,
                                    seed: int, noise: float = 0.3,
                                    split: int = 0):
    """Images = per-class smooth template + Gaussian noise; labels uniform.

    The class templates depend only on ``seed``; ``split`` (0 = train,
    1 = eval) offsets the sample stream, so train and validation draw
    disjoint samples from the same class distribution."""
    tmpl_rng = np.random.Generator(np.random.Philox(key=seed))
    rng = np.random.Generator(
        np.random.Philox(np.random.SeedSequence((seed, split + 1)))
    )
    templates = tmpl_rng.normal(0.0, 1.0, size=(num_classes, *shape)) \
        .astype(np.float32)
    # smooth the templates along the spatial axes so convs find structure
    for _ in range(2):
        templates = (
            templates
            + np.roll(templates, 1, axis=1)
            + np.roll(templates, -1, axis=1)
            + np.roll(templates, 1, axis=2)
            + np.roll(templates, -1, axis=2)
        ) / 5.0
    labels = rng.integers(0, num_classes, size=n).astype(np.int32)
    images = templates[labels] + noise * rng.normal(size=(n, *shape)) \
        .astype(np.float32)
    return images.astype(np.float32), labels


def synthetic_mnist(n: int = 4096, seed: int = 0, training: bool = True):
    images, labels = _synthetic_image_classification(
        n, (28, 28, 1), 10, seed=seed, split=0 if training else 1)
    return {"image": images, "label": labels}


def _try_load_mnist(data_dir: Path, training: bool):
    """Raw MNIST idx files (plain or ``.gz``) anywhere under ``data_dir``,
    normalised as the reference does (``(x / 255 - 0.1307) / 0.3081``), or
    None when they are absent."""
    names = (("train-images-idx3-ubyte", "train-labels-idx1-ubyte")
             if training else
             ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"))

    def find(stem):
        for cand in (list(data_dir.rglob(stem))
                     + list(data_dir.rglob(stem + ".gz"))):
            return cand
        return None

    img_f, lbl_f = find(names[0]), find(names[1])
    if img_f is None or lbl_f is None:
        return None

    def read(fp):
        op = gzip.open if fp.suffix == ".gz" else open
        with op(fp, "rb") as f:
            return f.read()

    images = np.frombuffer(read(img_f), dtype=np.uint8, offset=16) \
        .reshape(-1, 28, 28, 1)
    labels = np.frombuffer(read(lbl_f), dtype=np.uint8, offset=8) \
        .astype(np.int32)
    images = (images.astype(np.float32) / 255.0 - 0.1307) / 0.3081
    return {"image": images, "label": labels}


def _make_image_loader(dataset: dict, batch_size: int, shuffle: bool,
                       drop_last: bool = False, seed: int = 0):
    """An ``ArrayDataLoader``, sharded over the ranks by a
    ``ShardedSampler`` when there is more than one process."""
    sampler = None
    if dist.process_count() > 1:
        sampler = ShardedSampler(len(next(iter(dataset.values()))),
                                 shuffle=shuffle, seed=seed)
    return ArrayDataLoader(dataset, batch_size=batch_size, shuffle=shuffle,
                           sampler=sampler, drop_last=drop_last, seed=seed)


@LOADERS.register("MnistDataLoader")
def mnist_loader(data_dir: str = "data/", batch_size: int = 128,
                 shuffle: bool = True, num_workers: int = 0,
                 training: bool = True, synthetic_n: int = 4096,
                 seed: int = 0):
    """MNIST loader with the reference's signature; synthetic fallback."""
    del num_workers  # no worker pool: the arrays are memory-resident
    data = _try_load_mnist(Path(data_dir), training)
    if data is None:
        logger.warning(
            "MNIST files not found under %s and nothing is downloaded; "
            "using deterministic synthetic MNIST (n=%d). Provide raw idx "
            "files to train on real data.", data_dir, synthetic_n)
        data = synthetic_mnist(n=synthetic_n, seed=seed, training=training)
    return _make_image_loader(data, batch_size, shuffle, seed=seed)


def synthetic_lm(n: int = 2048, seq_len: int = 128, vocab_size: int = 50257,
                 seed: int = 0, training: bool = True):
    """Token sequences from a sparse bigram chain — learnable structure.

    The bigram table depends only on ``seed``; the sample stream is offset
    by split so train/val sequences differ but share the distribution."""
    tmpl_rng = np.random.Generator(np.random.Philox(key=seed))
    split = 0 if training else 1
    rng = np.random.Generator(
        np.random.Philox(np.random.SeedSequence((seed, split + 1)))
    )
    # each token deterministically prefers a few successors
    successors = tmpl_rng.integers(0, vocab_size, size=(vocab_size, 4))
    tokens = np.empty((n, seq_len), dtype=np.int32)
    tokens[:, 0] = rng.integers(0, vocab_size, size=n)
    choices = rng.integers(0, 4, size=(n, seq_len))
    noise = rng.random((n, seq_len)) < 0.1
    random_tok = rng.integers(0, vocab_size, size=(n, seq_len))
    for t in range(1, seq_len):
        nxt = successors[tokens[:, t - 1], choices[:, t]]
        tokens[:, t] = np.where(noise[:, t], random_tok[:, t], nxt)
    return {"tokens": tokens}


@LOADERS.register("SyntheticLMLoader")
def lm_loader(data_dir: str = "data/", batch_size: int = 8,
              shuffle: bool = True, num_workers: int = 0,
              training: bool = True, n: int = 2048, seq_len: int = 128,
              vocab_size: int = 50257, seed: int = 0):
    del data_dir, num_workers
    data = synthetic_lm(n=n, seq_len=seq_len, vocab_size=vocab_size,
                        seed=seed, training=training)
    return _make_image_loader(data, batch_size, shuffle, seed=seed)


@LOADERS.register("ByteLMLoader")
def byte_lm_loader(data_dir: str = "data/", batch_size: int = 8,
                   shuffle: bool = True, num_workers: int = 0,
                   training: bool = True, file: str = "input.txt",
                   seq_len: int = 256, val_fraction: float = 0.1,
                   seed: int = 0):
    """Byte-level LM over any local file (vocab 256).

    The file is memory-mapped as uint8 and split by ``val_fraction`` (the
    tail is the validation text), then cut into non-overlapping
    ``seq_len`` windows; the tokens stay uint8 (the embedding lookup
    widens them). When the file is absent it falls back to the synthetic
    bigram stream (vocab 256), as the JAX loader does."""
    del num_workers
    path = Path(data_dir) / file
    if not path.exists():
        logger.warning(
            "ByteLMLoader: %s not found; using synthetic byte-LM data.",
            path)
        data = synthetic_lm(n=2048, seq_len=seq_len, vocab_size=256,
                            seed=seed, training=training)
        return _make_image_loader(data, batch_size, shuffle, seed=seed)
    raw = np.memmap(path, dtype=np.uint8, mode="r")
    split = int(len(raw) * (1.0 - val_fraction))
    part = raw[:split] if training else raw[split:]
    n_chunks = len(part) // seq_len
    if n_chunks == 0:
        raise ValueError(
            f"ByteLMLoader: {path} too small for one {seq_len}-byte "
            f"{'train' if training else 'val'} sequence")
    tokens = part[: n_chunks * seq_len].reshape(n_chunks, seq_len)
    return _make_image_loader({"tokens": tokens}, batch_size, shuffle,
                              seed=seed)


@LOADERS.register("BpeLMLoader")
def bpe_lm_loader(**kwargs):
    raise NotImplementedError(_SLICE_BPE)
