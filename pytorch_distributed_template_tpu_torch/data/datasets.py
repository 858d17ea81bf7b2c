"""LM training datasets and their loaders, registered in
``config.LOADERS``: the port of the JAX package's ``data/datasets.py``
``synthetic_lm``, ``SyntheticLMLoader`` and ``ByteLMLoader``.

The token arrays are byte-identical to the JAX package's (same numpy
Philox generators, same seeds, the same memory-mapped bytes).
``BpeLMLoader`` is registered so a config naming it fails with the slice
it waits for.
"""
from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from ..config.registry import LOADERS
from .loader import ArrayDataLoader

_SLICE5 = "slice 5 (the training main path with DP)"
_SLICE_BPE = ("BpeLMLoader (its tokenizer cache) is a later slice (the "
              "data layer)")
logger = logging.getLogger(__name__)


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


def _single_process() -> None:
    import torch.distributed as tdist

    if tdist.is_available() and tdist.is_initialized() \
            and tdist.get_world_size() > 1:
        raise NotImplementedError(f"multi-process data sharding is "
                                  f"{_SLICE5}")


@LOADERS.register("SyntheticLMLoader")
def lm_loader(data_dir: str = "data/", batch_size: int = 8,
              shuffle: bool = True, num_workers: int = 0,
              training: bool = True, n: int = 2048, seq_len: int = 128,
              vocab_size: int = 50257, seed: int = 0):
    del data_dir, num_workers
    _single_process()
    data = synthetic_lm(n=n, seq_len=seq_len, vocab_size=vocab_size,
                        seed=seed, training=training)
    return ArrayDataLoader(data, batch_size=batch_size, shuffle=shuffle,
                           seed=seed)


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
    _single_process()
    path = Path(data_dir) / file
    if not path.exists():
        logger.warning(
            "ByteLMLoader: %s not found; using synthetic byte-LM data.",
            path)
        data = synthetic_lm(n=2048, seq_len=seq_len, vocab_size=256,
                            seed=seed, training=training)
        return ArrayDataLoader(data, batch_size=batch_size, shuffle=shuffle,
                               seed=seed)
    raw = np.memmap(path, dtype=np.uint8, mode="r")
    split = int(len(raw) * (1.0 - val_fraction))
    part = raw[:split] if training else raw[split:]
    n_chunks = len(part) // seq_len
    if n_chunks == 0:
        raise ValueError(
            f"ByteLMLoader: {path} too small for one {seq_len}-byte "
            f"{'train' if training else 'val'} sequence")
    tokens = part[: n_chunks * seq_len].reshape(n_chunks, seq_len)
    return ArrayDataLoader({"tokens": tokens}, batch_size=batch_size,
                           shuffle=shuffle, seed=seed)


@LOADERS.register("BpeLMLoader")
def bpe_lm_loader(**kwargs):
    raise NotImplementedError(_SLICE_BPE)
